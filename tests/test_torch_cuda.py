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
from repro_torch.kernels.qrlora_bgmv import qrlora_bgmv_cuda
from repro_torch.kernels.ref import paged_decode_attention_ref, qrlora_bgmv_ref

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
