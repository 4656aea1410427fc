"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA Hopper card and ``nvcc``; without a card they
skip (decided inside the fixture, never at import).  This file imports
neither ``jax`` nor the JAX package, so on the GPU machine it runs without
the repository's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.paged_attention import paged_decode_attention_cuda
from repro_torch.kernels import ops
from repro_torch.core.quantize import quantize_weight
from repro_torch.kernels.qrlora_bgmv import qrlora_bgmv_cuda, qrlora_bgmv_quant_cuda
from repro_torch.kernels.qrlora_matmul import qrlora_matmul_cuda, qrlora_matmul_quant_cuda
from repro_torch.kernels.ref import (
    paged_decode_attention_ref,
    qrlora_bgmv_quant_ref,
    qrlora_bgmv_ref,
    qrlora_matmul_quant_ref,
    qrlora_matmul_ref,
)

# |kernel − plain| ≤ atol + rtol·|plain|: float32 differs by summation order
# only; bfloat16 outputs may split by one bf16 ulp (2^-7 relative), and the
# plain paged version rounds probabilities to bf16 before P·V.
TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 2.0**-7)}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper card (compute capability 9.0)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    return bool(((got.float() - want.float()).abs() <= atol + rtol * want.float().abs()).all())


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N,r", [(1, 64, 32, 16), (37, 96, 80, 24), (130, 576, 192, 128)])
def test_bgmv_kernel_matches_plain(gen, x_dtype, M, K, N, r):
    """The QR factors are bfloat16 under either model dtype."""
    dev, n_slots = "cuda", 5
    x = torch.randn((M, K), generator=gen, device=dev).to(x_dtype)
    W = (torch.randn((K, N), generator=gen, device=dev) * K**-0.5).to(x_dtype)
    B = (torch.randn((K, r), generator=gen, device=dev) * K**-0.5).bfloat16()
    A = torch.randn((r, N), generator=gen, device=dev).bfloat16()
    lam = torch.randn((n_slots, r), generator=gen, device=dev)
    lam[0] = 0
    seg = torch.randint(0, n_slots, (M,), generator=gen, device=dev, dtype=torch.int32)
    before = qrlora_bgmv_cuda.launches
    y = qrlora_bgmv_cuda(x, W, B, A, lam, seg, scale=0.7)
    torch.cuda.synchronize()
    assert qrlora_bgmv_cuda.launches == before + 1
    assert y.dtype == x_dtype and y.shape == (M, N)
    assert _close(y, qrlora_bgmv_ref(x, W, B, A, lam, seg, 0.7), x_dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lengths", [(0, 1, 16, 17), (100, 33, 2, 64)])
def test_paged_kernel_matches_plain(gen, dtype, lengths):
    dev, H, KV, dh, bs, mb = "cuda", 9, 3, 64, 16, 8
    B, n_blocks = len(lengths), 1 + len(lengths) * mb
    q = torch.randn((B, H, dh), generator=gen, device=dev).to(dtype)
    kp = torch.randn((n_blocks, bs, KV, dh), generator=gen, device=dev).to(dtype)
    vp = torch.randn((n_blocks, bs, KV, dh), generator=gen, device=dev).to(dtype)
    kp[0] = vp[0] = 1e4  # trash block: must never contribute
    tbl = (torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1).to(torch.int32)
    tbl = tbl.reshape(B, mb).clone()
    for b, n in enumerate(lengths):
        tbl[b, -(-n // bs)::2] = 0
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    for width in (mb, 7):  # whole table, and a column slice of it
        t = tbl[:, :width]
        lens_w = torch.clamp(lens, max=width * bs)
        o = paged_decode_attention_cuda(q, kp, vp, t, lens_w)
        torch.cuda.synchronize()
        assert _close(o, paged_decode_attention_ref(q, kp, vp, t, lens_w), dtype)
        for b, n in enumerate(lengths):
            if n == 0:
                assert (o[b] == 0).all()


def test_serving_step_launches_both_kernels(gen):
    from repro_torch.configs import get_reduced
    from repro_torch.serving import EngineConfig, MultiTenantEngine, random_lambda

    cfg = get_reduced("smollm-135m")
    eng = MultiTenantEngine(cfg, EngineConfig(max_len=64))
    eng.add_tenant("a", random_lambda(gen, eng.params, 0.3))
    eng.submit("a", list(range(2, 20)), 4)
    kernels.reset_launch_counts()
    eng.run()
    counts = kernels.launch_counts()
    assert counts["qrlora_bgmv"] == 2 * cfg.n_layers * 4  # 1 prefill + 3 decode steps
    assert counts["paged_decode_attention"] == cfg.n_layers * 3


def _matmul_inputs(gen, M, K, N, r, x_dtype, rank=None):
    """Factor columns past the selected ``rank`` are zero, as
    ``qr_lora_init_single`` leaves them."""
    dev = "cuda"
    x = torch.randn((M, K), generator=gen, device=dev).to(x_dtype)
    W = (torch.randn((K, N), generator=gen, device=dev) * K**-0.5).to(x_dtype)
    B = torch.randn((K, r), generator=gen, device=dev) * K**-0.5
    A = torch.randn((r, N), generator=gen, device=dev)
    if rank is not None:
        B[:, rank:] = 0
        A[rank:] = 0
    lam = torch.randn((r,), generator=gen, device=dev) * 0.3
    return x, W, B.bfloat16(), A.bfloat16(), lam


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N,r", [(2048, 576, 576, 128), (37, 576, 192, 128),
                                     (1, 48, 16, 8), (130, 104, 72, 40)])
def test_qrlora_matmul_kernel_matches_plain(gen, x_dtype, M, K, N, r):
    """The training shapes (wq N=576, wv N=192, rank cap 128) and ragged
    ones; columns past the selected rank are zero."""
    args = _matmul_inputs(gen, M, K, N, r, x_dtype, rank=r // 2)
    before = qrlora_matmul_cuda.launches
    y = qrlora_matmul_cuda(*args, scale=0.7)
    torch.cuda.synchronize()
    assert qrlora_matmul_cuda.launches == before + 1
    assert y.dtype == x_dtype and y.shape == (M, N)
    assert _close(y, qrlora_matmul_ref(*args, 0.7), x_dtype)


# Gradients of the autograd.Function (kernel forward, hand-written backward)
# against torch.autograd through the plain formula: both backwards compute
# in fp32 from the same inputs, in another order (~1e-6 relative); dx is
# then rounded to x's dtype (one bf16 ulp).
GRAD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 2.0**-7)}


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N", [576, 192])
def test_qrlora_matmul_grads_match_autograd_of_plain(gen, x_dtype, N):
    x, W, B, A, lam = _matmul_inputs(gen, 2048, 576, N, 128, x_dtype, rank=50)
    cot = torch.randn((2048, N), generator=gen, device="cuda").to(x_dtype)
    outs = []
    for fn in (ops.qrlora_matmul, qrlora_matmul_ref):
        xx = x.clone().requires_grad_(True)
        ll = lam.clone().requires_grad_(True)
        y = fn(xx, W, B, A, ll, 0.7)
        (y.float() * cot.float()).sum().backward()
        outs.append((y.detach(), xx.grad, ll.grad))
    torch.cuda.synchronize()
    (y, dx, dlam), (y_ref, dx_ref, dlam_ref) = outs
    assert _close(y, y_ref, x_dtype)
    atol, rtol = GRAD_TOL[x_dtype]
    assert bool(((dx.float() - dx_ref.float()).abs() <= atol + rtol * dx_ref.float().abs()).all())
    scale = float(dlam_ref.abs().max())
    assert bool(((dlam - dlam_ref).abs() <= 1e-5 * scale).all())
    assert bool((dlam[50:] == 0).all())


def test_train_step_launches_the_matmul_kernel(gen):
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import init_train_state, make_train_step

    cfg = get_reduced("smollm-135m")
    model = build_model(cfg)
    state = init_train_state(model, gen)
    step = make_train_step(model, AdamWConfig(lr=1e-2))
    tokens = torch.randint(0, cfg.vocab_size, (4, 16), generator=gen, device="cuda")
    kernels.reset_launch_counts()
    state, met = step(state, {"tokens": tokens})
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"qrlora_bgmv": 0, "paged_decode_attention": 0,
                                       "qrlora_matmul": 2 * cfg.n_layers,
                                       "qrlora_bgmv_quant": 0, "qrlora_matmul_quant": 0}
    assert torch.isfinite(met["loss"])


# ---------------------------------------------------------------------------
# the quantized base: int8 / fp8-e4m3 q with per-column scales
# ---------------------------------------------------------------------------
# Widening q to bf16 or fp32 is exact and so are the products, so kernel and
# plain version differ by summation order only: the TOL above.


def _quantized(W, base_dtype):
    qW = quantize_weight(W.float(), base_dtype)
    return qW["q"], qW["scale"]


@pytest.mark.parametrize("base_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N,r", [(4, 576, 576, 128), (64, 576, 192, 128), (37, 96, 80, 24)])
def test_bgmv_quant_kernel_matches_plain(gen, base_dtype, x_dtype, M, K, N, r):
    dev, n_slots = "cuda", 8
    x = torch.randn((M, K), generator=gen, device=dev).to(x_dtype)
    q, ws = _quantized(torch.randn((K, N), generator=gen, device=dev) * K**-0.5, base_dtype)
    B = (torch.randn((K, r), generator=gen, device=dev) * K**-0.5).bfloat16()
    A = torch.randn((r, N), generator=gen, device=dev).bfloat16()
    lam = torch.randn((n_slots, r), generator=gen, device=dev)
    lam[0] = 0
    seg = torch.arange(M, device=dev, dtype=torch.int32) % n_slots  # every slot, 0 included
    before = qrlora_bgmv_quant_cuda.launches
    y = qrlora_bgmv_quant_cuda(x, q, ws, B, A, lam, seg, scale=0.7)
    torch.cuda.synchronize()
    assert qrlora_bgmv_quant_cuda.launches == before + 1
    assert y.dtype == x_dtype and y.shape == (M, N)
    assert _close(y, qrlora_bgmv_quant_ref(x, q, ws, B, A, lam, seg, 0.7), x_dtype)


@pytest.mark.parametrize("base_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N,r", [(2048, 576, 576, 128), (37, 576, 192, 128),
                                     (130, 112, 80, 40)])
def test_qrlora_matmul_quant_kernel_matches_plain(gen, base_dtype, x_dtype, M, K, N, r):
    x, W, B, A, lam = _matmul_inputs(gen, M, K, N, r, x_dtype, rank=r // 2)
    q, ws = _quantized(W, base_dtype)
    before = qrlora_matmul_quant_cuda.launches
    y = qrlora_matmul_quant_cuda(x, q, ws, B, A, lam, scale=0.7)
    torch.cuda.synchronize()
    assert qrlora_matmul_quant_cuda.launches == before + 1
    assert y.dtype == x_dtype and y.shape == (M, N)
    assert _close(y, qrlora_matmul_quant_ref(x, q, ws, B, A, lam, 0.7), x_dtype)


def test_quantized_serve_and_forward_launch_the_quantized_kernels(gen):
    from repro_torch.configs import get_reduced
    from repro_torch.serving import EngineConfig, MultiTenantEngine, random_lambda

    cfg = get_reduced("smollm-135m")
    eng = MultiTenantEngine(cfg, EngineConfig(max_len=64, base_dtype="int8"))
    lam = random_lambda(gen, eng.params, 0.3)
    eng.add_tenant("a", lam)
    eng.submit("a", list(range(2, 20)), 4)
    kernels.reset_launch_counts()
    eng.run()
    counts = kernels.launch_counts()
    assert counts["qrlora_bgmv_quant"] == 2 * cfg.n_layers * 4  # 1 prefill + 3 decode steps
    assert counts["qrlora_bgmv"] == 0
    view = {**eng.params, "groups": {**eng.params["groups"], "adapters": {
        mod: {p: {**leaf, "lam": lam[mod][p]} for p, leaf in projs.items()}
        for mod, projs in eng.params["groups"]["adapters"].items()}}}
    kernels.reset_launch_counts()
    with torch.no_grad():
        eng.model.apply(view, torch.arange(2, 20, device="cuda")[None])
    counts = kernels.launch_counts()
    assert counts["qrlora_matmul_quant"] == 2 * cfg.n_layers and counts["qrlora_matmul"] == 0
