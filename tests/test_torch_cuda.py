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
from repro_torch.benchmarks.common import err_over_bound
from repro_torch.benchmarks.kernel_bench import TOL as BENCH_TOL, abs_v_attention, abs_v_paged
from repro_torch.kernels.decode_attention import decode_attention_chunk, decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.paged_attention import paged_decode_attention_cuda, paged_decode_plan
from repro_torch.kernels import ops
from repro_torch.core.quantize import FP8_DTYPE, quantize_weight
from repro_torch.kernels.qrlora_bgmv import (
    qrlora_bgmv_cuda,
    qrlora_bgmv_quant_cuda,
    qrlora_bgmv_rows_cuda,
)
from repro_torch.kernels.qrlora_matmul import qrlora_matmul_cuda, qrlora_matmul_quant_cuda
from repro_torch.kernels.ref import (
    decode_attention_ref,
    flash_attention_ref,
    paged_decode_attention_ref,
    paged_decode_attention_split_ref,
    qrlora_bgmv_quant_ref,
    qrlora_bgmv_ref,
    qrlora_bgmv_rows_ref,
    qrlora_matmul_quant_ref,
    qrlora_matmul_ref,
)

# |kernel − plain| ≤ atol + rtol·|plain| (+ ptol·P·|v| for attention), each
# kernel's limit from the one table chip_smoke.py reads too
# (kernel_bench.TOL): float32 differs by summation order only; bfloat16
# outputs may split by one bf16 ulp (2^-7 relative), and the plain attention
# versions round probabilities to bf16 before P·V.


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper card (compute capability 9.0)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, kind):
    atol, rtol, _ = BENCH_TOL[kind][got.dtype]
    return bool(((got.float() - want.float()).abs() <= atol + rtol * want.float().abs()).all())


# decode (M = 4 lanes) and prefill buckets (16-64 rows) at smollm-135m's wq
# (N = 576) and wv (N = 192), M = 1, 37 and 256 beside them, and shapes no
# vector width divides (K, N and r ragged: element-wise staging)
BGMV_SHAPES = [(M, 576, 576, 128) for M in (1, 4, 16, 64, 256)] + [
    (4, 576, 192, 128), (37, 576, 192, 128), (1, 64, 32, 16), (37, 96, 80, 24),
    (130, 576, 192, 128), (5, 100, 50, 20), (33, 1500, 72, 256)]


def _bgmv_operands(gen, x_dtype, M, K, N, r, n_slots=5):
    dev = "cuda"
    x = torch.randn((M, K), generator=gen, device=dev).to(x_dtype)
    W = (torch.randn((K, N), generator=gen, device=dev) * K**-0.5).to(x_dtype)
    B = (torch.randn((K, r), generator=gen, device=dev) * K**-0.5).bfloat16()
    A = torch.randn((r, N), generator=gen, device=dev).bfloat16()
    lam = torch.randn((n_slots, r), generator=gen, device=dev)
    lam[0] = 0
    seg = torch.randint(0, n_slots, (M,), generator=gen, device=dev, dtype=torch.int32)
    return x, W, B, A, lam, seg


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N,r", BGMV_SHAPES)
def test_bgmv_kernel_matches_plain(gen, x_dtype, M, K, N, r):
    """The QR factors are bfloat16 under either model dtype.  The last row's
    slot lies outside the table: a zero adapter term (the plain version
    reads a zero row appended to the table).  A second call is bitwise the
    first."""
    x, W, B, A, lam, seg = _bgmv_operands(gen, x_dtype, M, K, N, r)
    seg[-1] = lam.shape[0]
    before = qrlora_bgmv_cuda.launches
    y = qrlora_bgmv_cuda(x, W, B, A, lam, seg, scale=0.7)
    again = qrlora_bgmv_cuda(x, W, B, A, lam, seg, scale=0.7)
    torch.cuda.synchronize()
    assert qrlora_bgmv_cuda.launches == before + 2
    assert y.dtype == x_dtype and y.shape == (M, N)
    padded = torch.cat([lam, torch.zeros_like(lam[:1])])
    assert _close(y, qrlora_bgmv_ref(x, W, B, A, padded, seg, 0.7), "qrlora_bgmv")
    assert _close(y[-1:], (x[-1:].float() @ W.float()).to(x_dtype), "qrlora_bgmv")
    assert torch.equal(y, again)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,N", [(4, 576), (4, 192), (64, 576)])
def test_bgmv_kernel_bitwise_under_graph_replay(gen, x_dtype, M, N):
    """A captured call replayed is bitwise the eager call: every sum has a
    fixed order (no atomics)."""
    x, W, B, A, lam, seg = _bgmv_operands(gen, x_dtype, M, 576, N, 128)
    fn = lambda: qrlora_bgmv_cuda(x, W, B, A, lam, seg, 0.7)
    eager = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_bgmv_plan_spreads_decode_over_the_card(gen, x_dtype):
    """A decode launch (4 lanes) splits K over a cluster of 8 CTAs for each
    32-column tile: 144 CTAs at wq (N = 576), 48 at wv (N = 192); a 64-row
    prefill bucket takes two row tiles of 32.  Each rank takes 72 of the
    576 K rows and sums 16 of the 128 rank columns of P."""
    from repro_torch.kernels.qrlora_bgmv import qrlora_bgmv_plan

    wq, wv = (qrlora_bgmv_plan(4, 576, N, 128, x_dtype) for N in (576, 192))
    assert (wq["cluster"], wq["ctas"], wv["ctas"]) == (8, 144, 48)
    assert wq["grid"] == (144, 1) and (wq["k_slice"], wq["p_cols"]) == (72, 16)
    assert qrlora_bgmv_plan(64, 576, 576, 128, x_dtype)["grid"] == (144, 2)
    assert wq["smem"] <= 48 * 1024  # decode needs no opt-in to large shared memory


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
    tol = BENCH_TOL["paged_decode_attention"][dtype]
    for width in (mb, 7):  # whole table, and a column slice of it
        t = tbl[:, :width]
        lens_w = torch.clamp(lens, max=width * bs)
        o = paged_decode_attention_cuda(q, kp, vp, t, lens_w)
        torch.cuda.synchronize()
        want = paged_decode_attention_ref(q, kp, vp, t, lens_w)
        pv = abs_v_paged(q, kp, vp, t, lens_w)
        assert err_over_bound(o, want, tol, pv) <= 1
        for b, n in enumerate(lengths):
            if n == 0:
                assert (o[b] == 0).all()
    # planted: the longest lane's last block dropped (its length cut to the
    # block before) must be rejected by the same limit
    longest = max(range(B), key=lambda b: lengths[b])
    cut = lens.clone()
    cut[longest] = (lengths[longest] - 1) // bs * bs
    o = paged_decode_attention_cuda(q, kp, vp, tbl, cut)
    torch.cuda.synchronize()
    assert err_over_bound(o, paged_decode_attention_ref(q, kp, vp, tbl, lens), tol,
                          abs_v_paged(q, kp, vp, tbl, lens)) > 1


def _paged_operands(gen, dtype, lengths, H=9, KV=3, dh=64, bs=16, mb=8):
    """q, pools with trash block 0 at 1e4, a table whose columns past each
    length alternate trash and the lane's own (stale) blocks, lengths."""
    dev, B = "cuda", len(lengths)
    n_blocks = 1 + B * mb
    q = torch.randn((B, H, dh), generator=gen, device=dev).to(dtype)
    kp = torch.randn((n_blocks, bs, KV, dh), generator=gen, device=dev).to(dtype)
    vp = torch.randn((n_blocks, bs, KV, dh), generator=gen, device=dev).to(dtype)
    kp[0] = vp[0] = 1e4
    tbl = (torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1).to(torch.int32)
    tbl = tbl.reshape(B, mb).clone()
    for b, n in enumerate(lengths):
        tbl[b, -(-n // bs)::2] = 0
    return q, kp, vp, tbl, torch.tensor(lengths, dtype=torch.int32, device=dev)


def _paged_over(o, q, kp, vp, tbl, lens):
    tol = BENCH_TOL["paged_decode_attention"][o.dtype]
    return err_over_bound(o, paged_decode_attention_ref(q, kp, vp, tbl, lens), tol,
                          abs_v_paged(q, kp, vp, tbl, lens))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lengths", [(0, 1, 16, 17), (100, 33, 2, 128)])
def test_paged_kernel_head_dim_16_rep_1(gen, dtype, lengths):
    """The reduced smollm-135m config's attention (3 heads over 3, dh 16):
    one query head a kv head, a 256-position chunk in bf16."""
    args = _paged_operands(gen, dtype, lengths, H=3, KV=3, dh=16)
    o = paged_decode_attention_cuda(*args)
    torch.cuda.synchronize()
    assert _paged_over(o, *args) <= 1
    assert all((o[b] == 0).all() for b, n in enumerate(lengths) if n == 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("entry", ["negative", "past_the_pool"])
def test_paged_kernel_out_of_range_entry_reads_nothing(gen, dtype, entry):
    """An entry outside [0, n_blocks) inside the length contributes
    nothing: the result is the plain version over the table with that
    column removed and the length cut by one block."""
    q, kp, vp, tbl, lens = _paged_operands(gen, dtype, (100, 70, 40, 64))
    col = 1
    bad = tbl.clone()
    bad[:, col] = -3 if entry == "negative" else kp.shape[0] + 5
    o = paged_decode_attention_cuda(q, kp, vp, bad, lens)
    torch.cuda.synchronize()
    cut = torch.cat([tbl[:, :col], tbl[:, col + 1:], tbl[:, :1]], dim=1).contiguous()
    assert _paged_over(o, q, kp, vp, cut, lens - 16) <= 1
    assert bool(torch.isfinite(o).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lengths", [(1000, 0, 513, 64), (1024, 1, 999, 257)])
def test_paged_kernel_long_table(gen, dtype, lengths):
    """A 64-column table (1024 positions: 16 chunks in bf16, 32 in float32,
    over a cluster of 8, each rank folding 2 or 4 chunks), whole and as a
    48-column slice."""
    q, kp, vp, tbl, lens = _paged_operands(gen, dtype, lengths, mb=64)
    for width in (64, 48):
        t = tbl[:, :width]
        lw = torch.clamp(lens, max=width * 16)
        o = paged_decode_attention_cuda(q, kp, vp, t, lw)
        torch.cuda.synchronize()
        assert _paged_over(o, q, kp, vp, t, lw) <= 1
        assert all((o[b] == 0).all() for b, n in enumerate(lengths) if n == 0)


def test_paged_kernel_matches_its_split_mirror(gen):
    """The kernel against ``ref.paged_decode_attention_split_ref`` cut as
    the kernel's own plan cuts the table, in float32: equal up to the
    rounding of another summation order (1e-6 + 1e-6·|mirror|, as the CPU
    tests hold the mirror to the references)."""
    q, kp, vp, tbl, lens = _paged_operands(gen, torch.float32, (1000, 300, 64, 17), mb=64)
    plan = paged_decode_plan(4, 9, 3, 64, 16, 64, torch.float32)
    o = paged_decode_attention_cuda(q, kp, vp, tbl, lens)
    mirror = paged_decode_attention_split_ref(q, kp, vp, tbl, lens, plan["chunk"],
                                              ranks=plan["cluster"])
    torch.cuda.synchronize()
    assert bool(((o - mirror).abs() <= 1e-6 + 1e-6 * mirror.abs()).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mb", [4, 64])
def test_paged_kernel_bitwise_again_and_under_graph_replay(gen, dtype, mb):
    """A second call gives the same bits; a captured call replayed after new
    lengths are written into the device tensor gives the bits of an eager
    call at those lengths (no host read, no atomics)."""
    q, kp, vp, tbl, lens = _paged_operands(gen, dtype, (64, 48, 33, 17), mb=mb)
    first = paged_decode_attention_cuda(q, kp, vp, tbl, lens)
    again = paged_decode_attention_cuda(q, kp, vp, tbl, lens)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        paged_decode_attention_cuda(q, kp, vp, tbl, lens)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = paged_decode_attention_cuda(q, kp, vp, tbl, lens)
    width = mb * 16
    for new in ((1, 0, width, 40), (width, width - 1, 17, 0), (64, 48, 33, 17)):
        lens.copy_(torch.tensor(new, dtype=torch.int32))
        graph.replay()
        eager = paged_decode_attention_cuda(q, kp, vp, tbl, lens)
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        assert _paged_over(out, q, kp, vp, tbl, lens) <= 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_plan_follows_the_table_not_the_length(gen, dtype):
    """The serving shape (a 4-column slice of 16-position blocks) is one
    chunk in bf16: no cluster, 12 CTAs; a 64-column table is a cluster of 8
    ranks folding 2 (bf16) or 4 (float32) chunks each.  The plan takes no
    length: the kernel reads the lengths on the card."""
    serve = paged_decode_plan(4, 9, 3, 64, 16, 4, dtype)
    long = paged_decode_plan(4, 9, 3, 64, 16, 64, dtype)
    chunk = 64 if dtype == torch.bfloat16 else 32
    assert serve["chunk"] == long["chunk"] == chunk
    assert serve["cluster"] == 64 // chunk and serve["grid"] == (64 // chunk, 3, 4)
    assert long["cluster"] == 8 and long["grid"] == (8, 3, 4)
    assert long["chunks"] == 1024 // chunk and long["chunks_per_rank"] == 1024 // chunk // 8
    assert paged_decode_plan(4, 3, 3, 16, 16, 4, dtype)["grid"] == (1, 3, 4)  # dh 16, rep 1
    assert paged_decode_plan(2, 16, 2, 128, 16, 8, dtype)["grid"][1] == 4  # rep 8: 2 groups


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


# (M, K, N, r): the training shapes (wq N=576, wv N=192, rank cap 128); the
# 64-row scoring forward and M = 1, whose few output tiles split K over a
# cluster; the kernel bench's fused adapter; ragged shapes, and K = 208,
# whose last K step is partial and whose steps do not divide evenly over
# the cluster's ranks.
MATMUL_SHAPES = [(2048, 576, 576, 128), (37, 576, 192, 128), (1, 48, 16, 8), (130, 104, 72, 40),
                 (64, 576, 576, 128), (64, 576, 192, 128), (1, 576, 576, 128),
                 (512, 768, 768, 160), (64, 208, 192, 24)]


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N,r", MATMUL_SHAPES)
def test_qrlora_matmul_kernel_matches_plain(gen, x_dtype, M, K, N, r):
    """Columns past the selected rank are zero."""
    args = _matmul_inputs(gen, M, K, N, r, x_dtype, rank=r // 2)
    before = qrlora_matmul_cuda.launches
    y = qrlora_matmul_cuda(*args, scale=0.7)
    torch.cuda.synchronize()
    assert qrlora_matmul_cuda.launches == before + 1
    assert y.dtype == x_dtype and y.shape == (M, N)
    assert _close(y, qrlora_matmul_ref(*args, 0.7), "qrlora_matmul")


# Gradients of the autograd.Function (kernel forward, hand-written backward)
# against torch.autograd through the plain formula: both backwards compute
# in fp32 from the same inputs, in another order (~1e-6 relative); dx is
# then rounded to x's dtype (one bf16 ulp): kernel_bench.TOL["qrlora_matmul_dx"].


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
    assert _close(y, y_ref, "qrlora_matmul")
    atol, rtol, _ = BENCH_TOL["qrlora_matmul_dx"][x_dtype]
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
    assert kernels.launch_counts() == {**{n: 0 for n in kernels.KERNEL_WRAPPERS},
                                       "qrlora_matmul": 2 * cfg.n_layers}
    assert torch.isfinite(met["loss"])


# the encoder's adapted projections on the float32 route: batch 16 × seq 128
# rows, 768 and a ragged 100; K = N = 768; QR-LoRA's rank cap 256 and LoRA's 2
@pytest.mark.parametrize("M", [2048, 768, 100])
@pytest.mark.parametrize("r", [256, 2])
def test_qrlora_matmul_float32_route_at_the_encoder_shapes(gen, M, r):
    args = _matmul_inputs(gen, M, 768, 768, r, torch.float32, rank=r)
    y, y2 = qrlora_matmul_cuda(*args, scale=0.7), qrlora_matmul_cuda(*args, scale=0.7)
    torch.cuda.synchronize()
    assert torch.equal(y, y2)
    assert _close(y, qrlora_matmul_ref(*args, 0.7), "qrlora_matmul")


@pytest.mark.parametrize("M,r", [(2048, 2), (768, 256)])
def test_qrlora_matmul_factor_grads_match_autograd_of_plain(gen, M, r):
    """LoRA through the kernel: dx (fp32) and the bf16 factors' dB and dA
    (each side's fp32 sum rounded once: the bf16 limit) against autograd
    through the plain formula."""
    x, W, B, A, _ = _matmul_inputs(gen, M, 768, 768, r, torch.float32, rank=r)
    lam = torch.ones((r,), device="cuda")
    cot = torch.randn((M, 768), generator=gen, device="cuda")
    outs = []
    for fn in (ops.qrlora_matmul, qrlora_matmul_ref):
        xx, BB, AA = (t.clone().requires_grad_(True) for t in (x, B, A))
        (fn(xx, W, BB, AA, lam, 0.7) * cot).sum().backward()
        outs.append((xx.grad, BB.grad, AA.grad))
    torch.cuda.synchronize()
    (dx, dB, dA), (dx_ref, dB_ref, dA_ref) = outs
    assert _close(dx, dx_ref, "qrlora_matmul_dx")
    assert dB.dtype == dA.dtype == torch.bfloat16
    assert _close(dB, dB_ref, "qrlora_matmul_dx") and _close(dA, dA_ref, "qrlora_matmul_dx")


def test_qr_pivoted_is_one_cuda_graph(gen):
    """No host read in the pivoted QR: captured whole (a sync would raise),
    its replay is bitwise the eager call and its permutation the CPU's."""
    from repro_torch.core.pivoted_qr import qr_pivoted

    W = torch.randn((256, 192), generator=gen, device="cuda")
    eager = qr_pivoted(W)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        qr_pivoted(W)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = qr_pivoted(W)
    for t in out:
        t.fill_(-1)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, eager))
    assert torch.equal(out.perm.cpu(), qr_pivoted(W.cpu()).perm)


@pytest.mark.parametrize("mode", ["qr_lora", "lora", "svd_lora", "ft"])
def test_glue_run_launches_the_matmul_kernel(gen, mode):
    """The GLUE runner on the reduced encoder: every forward of the adapter
    phase and of eval runs the one-λ kernel once a layer (the stacked wq),
    in every adapter mode; ft none."""
    from repro_torch.benchlib import run_glue_method
    from repro_torch.configs import get_reduced

    kernels.reset_launch_counts()
    r = run_glue_method("mrpc", mode, train_steps=2, warmup_steps=1, eval_batches=1, batch=8,
                        seq=32)
    torch.cuda.synchronize()
    n = get_reduced("roberta_base").n_layers * 3 if mode != "ft" else 0
    assert kernels.launch_counts() == {**{k: 0 for k in kernels.KERNEL_WRAPPERS},
                                       "qrlora_matmul": n}
    assert all(torch.isfinite(torch.tensor(r["losses"])))


# ---------------------------------------------------------------------------
# the quantized base: int8 / fp8-e4m3 q with per-column scales
# ---------------------------------------------------------------------------
# Widening q to bf16 or fp32 is exact and so are the products, so kernel and
# plain version differ by summation order only: the TOL above.


def _quantized(W, base_dtype):
    qW = quantize_weight(W.float(), base_dtype)
    return qW["q"], qW["scale"]


# decode, prefill buckets and M = 1, 37, 256 at wq and wv; N = 200 and 50
# (no 16-byte row of q: element-wise staging), ragged K and r, and a K
# past the old two-pass route's cap (12 staged rounds a rank)
BGMV_QUANT_SHAPES = [(M, 576, 576, 128) for M in (1, 4, 16, 37, 64, 256)] + [
    (4, 576, 192, 128), (64, 576, 192, 128), (37, 576, 200, 128), (37, 96, 80, 24),
    (5, 100, 50, 20), (4, 12288, 192, 128)]


def _bgmv_quant_operands(gen, base_dtype, x_dtype, M, K, N, r, n_slots=8):
    dev = "cuda"
    x = torch.randn((M, K), generator=gen, device=dev).to(x_dtype)
    q, ws = _quantized(torch.randn((K, N), generator=gen, device=dev) * K**-0.5, base_dtype)
    B = (torch.randn((K, r), generator=gen, device=dev) * K**-0.5).bfloat16()
    A = torch.randn((r, N), generator=gen, device=dev).bfloat16()
    lam = torch.randn((n_slots, r), generator=gen, device=dev)
    lam[0] = 0
    seg = torch.arange(M, device=dev, dtype=torch.int32) % n_slots  # every slot, 0 included
    return x, q, ws, B, A, lam, seg


@pytest.mark.parametrize("base_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N,r", BGMV_QUANT_SHAPES)
def test_bgmv_quant_kernel_matches_plain(gen, base_dtype, x_dtype, M, K, N, r):
    """One launch a call, within the limit of the plain version; the last
    row's slot outside the table gives the dequantized base projection
    alone; a second call is bitwise the first."""
    x, q, ws, B, A, lam, seg = _bgmv_quant_operands(gen, base_dtype, x_dtype, M, K, N, r)
    seg[-1] = lam.shape[0]
    before = qrlora_bgmv_quant_cuda.launches
    y = qrlora_bgmv_quant_cuda(x, q, ws, B, A, lam, seg, scale=0.7)
    again = qrlora_bgmv_quant_cuda(x, q, ws, B, A, lam, seg, scale=0.7)
    torch.cuda.synchronize()
    assert qrlora_bgmv_quant_cuda.launches == before + 2
    assert y.dtype == x_dtype and y.shape == (M, N)
    padded = torch.cat([lam, torch.zeros_like(lam[:1])])
    assert _close(y, qrlora_bgmv_quant_ref(x, q, ws, B, A, padded, seg, 0.7), "qrlora_bgmv_quant")
    base_row = ((x[-1:].float() @ q.float()) * ws).to(x_dtype)
    assert _close(y[-1:], base_row, "qrlora_bgmv_quant")
    assert torch.equal(y, again)


@pytest.mark.parametrize("route", ["quant", "rows"])
@pytest.mark.parametrize("base_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,N", [(4, 576), (4, 192), (64, 576)])
def test_bgmv_quant_routes_bitwise_under_graph_replay(gen, route, base_dtype, x_dtype, M, N):
    """Both q routes (#5 and the rows kernel on a q): a second call and a
    captured call replayed are bitwise the eager call."""
    x, q, ws, B, A, lam, seg = _bgmv_quant_operands(gen, base_dtype, x_dtype, M, 576, N, 128)
    rows = lam[seg.long()]
    if route == "quant":
        fn = lambda: qrlora_bgmv_quant_cuda(x, q, ws, B, A, lam, seg, 0.7)
    else:
        fn = lambda: qrlora_bgmv_rows_cuda(x, q, ws, B, A, rows, 0.7)
    eager, again = fn(), fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(again, eager) and torch.equal(out, eager)


@pytest.mark.parametrize("base_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_bgmv_plan_q_route_spreads_decode_over_the_card(gen, base_dtype, x_dtype):
    """A q launch splits as the W-in-x's-dtype one: 144 CTAs at wq decode,
    48 at wv, 72 K rows and 16 rank columns a rank; its shared memory holds
    q's tile at a byte an element (bf16 x: beside the bf16 tile it is
    widened into) and fits 48 KB at decode."""
    from repro_torch.kernels.qrlora_bgmv import qrlora_bgmv_plan

    w_dtype = torch.int8 if base_dtype == "int8" else FP8_DTYPE
    wq, wv = (qrlora_bgmv_plan(4, 576, N, 128, x_dtype, w_dtype) for N in (576, 192))
    assert (wq["cluster"], wq["ctas"], wv["ctas"]) == (8, 144, 48)
    assert wq["grid"] == (144, 1) and (wq["k_slice"], wq["p_cols"]) == (72, 16)
    assert qrlora_bgmv_plan(64, 576, 576, 128, x_dtype, w_dtype)["grid"] == (144, 2)
    # bf16 x stages q raw (80 K rows × 32 bytes) beside the bf16 tile it is
    # widened into; float32 x reads q raw where an fp32 W tile lies (72 × 32
    # × 3 bytes fewer); both hold the rank's 4 w_scale values (16 bytes)
    raw = 80 * 32 if x_dtype == torch.bfloat16 else -72 * 32 * 3
    assert wq["smem"] == qrlora_bgmv_plan(4, 576, 576, 128, x_dtype)["smem"] + raw + 16
    assert wq["smem"] <= 48 * 1024


@pytest.mark.parametrize("base_dtype", ["int8", "fp8"])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N,r", [(2048, 576, 576, 128), (37, 576, 192, 128),
                                     (130, 112, 80, 40), (64, 576, 576, 128),
                                     (64, 576, 192, 128), (1, 576, 576, 128), (64, 208, 192, 24)])
def test_qrlora_matmul_quant_kernel_matches_plain(gen, base_dtype, x_dtype, M, K, N, r):
    x, W, B, A, lam = _matmul_inputs(gen, M, K, N, r, x_dtype, rank=r // 2)
    q, ws = _quantized(W, base_dtype)
    before = qrlora_matmul_quant_cuda.launches
    y = qrlora_matmul_quant_cuda(x, q, ws, B, A, lam, scale=0.7)
    torch.cuda.synchronize()
    assert qrlora_matmul_quant_cuda.launches == before + 1
    assert y.dtype == x_dtype and y.shape == (M, N)
    assert _close(y, qrlora_matmul_quant_ref(x, q, ws, B, A, lam, 0.7), "qrlora_matmul_quant")


def _graph_call(fn):
    """fn's output captured in a CUDA graph and replayed once."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("base", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("M,N", [(2048, 576), (64, 576), (64, 192), (37, 192)])
def test_qrlora_matmul_kernels_bitwise_across_calls_and_graph_replay(gen, base, M, N):
    """No atomics and fixed orders (a split K is summed in rank order): two
    calls give the same bits, and so does a replay of a captured call (the
    main pass is a programmatic dependent of the P pass under capture too).
    One launch is counted per call."""
    x, W, B, A, lam = _matmul_inputs(gen, M, 576, N, 128, torch.bfloat16, rank=100)
    if base == "bf16":
        fn, wrapper = (lambda: qrlora_matmul_cuda(x, W, B, A, lam, 0.7)), qrlora_matmul_cuda
        ref = qrlora_matmul_ref(x, W, B, A, lam, 0.7)
    else:
        q, ws = _quantized(W, base)
        fn = lambda: qrlora_matmul_quant_cuda(x, q, ws, B, A, lam, 0.7)
        wrapper = qrlora_matmul_quant_cuda
        ref = qrlora_matmul_quant_ref(x, q, ws, B, A, lam, 0.7)
    before = wrapper.launches
    y1, y2 = fn(), fn()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert torch.equal(y1, y2)
    assert torch.equal(_graph_call(fn), y1)
    assert _close(y1, ref, "qrlora_matmul" if base == "bf16" else "qrlora_matmul_quant")


def test_qrlora_matmul_plan_splits_only_few_tiles(gen):
    """The 64-row forward's 9 (wq) or 3 (wv) output tiles split K over a
    cluster, x·W ranks before P ranks; the training shapes do not.  The
    ranks' steps, as the kernel computes them, take every K step once: the
    x·W steps on the first ``ranks_x`` ranks, the P steps on the rest."""
    from repro_torch.kernels.qrlora_matmul import qrlora_matmul_plan

    for M, K, N, r in ((64, 576, 576, 128), (64, 576, 192, 128), (64, 208, 192, 24),
                       (1, 576, 576, 128), (2048, 576, 576, 128), (2048, 576, 192, 128)):
        plan = qrlora_matmul_plan(M, K, N, r)
        nkx, nkr = -(-K // 64), -(-r // 64)
        if M == 2048:
            assert plan["cluster"] == 1 and plan["steps"] == (tuple(range(nkx + 2 * nkr)),)
            continue
        assert 1 < plan["cluster"] <= 8 and 1 <= plan["ranks_x"] < plan["cluster"], plan
        x_ranks, p_ranks = plan["steps"][:plan["ranks_x"]], plan["steps"][plan["ranks_x"]:]
        assert sorted(g for s in x_ranks for g in s) == list(range(nkx)), plan
        assert sorted(g for s in p_ranks for g in s) == list(range(nkx, nkx + 2 * nkr)), plan
    assert qrlora_matmul_plan(64, 576, 576, 0)["p_cluster"] == 0


def test_qrlora_matmul_kernels_on_a_second_card(gen):
    """A launch on one card, then on another: the kernels' shared-memory
    attribute is set for each card it launches on."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second card")
    for dev in ("cuda:0", "cuda:1"):
        with torch.cuda.device(dev):
            g = torch.Generator(device=dev).manual_seed(1)
            x, W, B, A, lam = _matmul_inputs(g, 64, 576, 576, 128, torch.bfloat16)
            y = qrlora_matmul_cuda(x, W, B, A, lam, 0.7)
            assert _close(y, qrlora_matmul_ref(x, W, B, A, lam, 0.7), "qrlora_matmul")
            qW = quantize_weight(W.float(), "int8")
            y = qrlora_matmul_quant_cuda(x, qW["q"], qW["scale"], B, A, lam, 0.7)
            assert _close(y, qrlora_matmul_quant_ref(x, qW["q"], qW["scale"], B, A, lam, 0.7),
                          "qrlora_matmul_quant")


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


# ---------------------------------------------------------------------------
# the rows kernel: pre-gathered λ rows of the sharded serve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w_kind", ["x", "int8", "fp8"])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,K,N,r", [(M, 576, 576, 128) for M in (1, 4, 16, 64, 256)]
                         + [(37, 576, 192, 128), (64, 576, 192, 128), (37, 96, 80, 24),
                            (5, 100, 50, 20)])
def test_bgmv_rows_kernel_matches_plain_and_bgmv(gen, w_kind, x_dtype, M, K, N, r):
    """W in x's dtype (no w_scale) or int8/fp8 q: within the limit of its
    plain version; with rows = Λ[seg] bitwise the BGMV kernel (or its
    quantized twin); one λ row sent to slot 0 is rejected by the limit."""
    dev, n_slots = "cuda", 8
    x = torch.randn((M, K), generator=gen, device=dev).to(x_dtype)
    W = (torch.randn((K, N), generator=gen, device=dev) * K**-0.5).to(x_dtype)
    B = (torch.randn((K, r), generator=gen, device=dev) * K**-0.5).bfloat16()
    A = torch.randn((r, N), generator=gen, device=dev).bfloat16()
    lam = torch.randn((n_slots, r), generator=gen, device=dev)
    lam[0] = 0
    seg = (torch.arange(M, device=dev, dtype=torch.int32) + 1) % n_slots  # row 0 off slot 0
    if w_kind == "x":
        ws = None
        twin = qrlora_bgmv_cuda(x, W, B, A, lam, seg, scale=0.7)
    else:
        W, ws = _quantized(W.float(), w_kind)
        twin = qrlora_bgmv_quant_cuda(x, W, ws, B, A, lam, seg, scale=0.7)
    rows = lam[seg.long()]
    before = qrlora_bgmv_rows_cuda.launches
    y = qrlora_bgmv_rows_cuda(x, W, ws, B, A, rows, scale=0.7)
    torch.cuda.synchronize()
    assert qrlora_bgmv_rows_cuda.launches == before + 1
    assert y.dtype == x_dtype and y.shape == (M, N)
    want = qrlora_bgmv_rows_ref(x, W, ws, B, A, rows, 0.7)
    assert _close(y, want, "qrlora_bgmv_rows")
    assert torch.equal(y, twin)
    planted = rows.clone()
    planted[0] = lam[0]
    assert not _close(qrlora_bgmv_rows_cuda(x, W, ws, B, A, planted, scale=0.7), want,
                      "qrlora_bgmv_rows")


def test_sharded_serve_launches_the_rows_kernel(gen, tmp_path):
    """shard_lam in a NCCL world of one: every adapted projection goes
    through the rows kernel, none through the BGMV kernel."""
    import torch.distributed as dist

    from repro_torch.configs import get_reduced
    from repro_torch.serving import EngineConfig, MultiTenantEngine, random_lambda

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        cfg = get_reduced("smollm-135m")
        eng = MultiTenantEngine(cfg, EngineConfig(max_len=64, shard_lam=True, shard_ba=True))
        eng.add_tenant("a", random_lambda(gen, eng.params, 0.3))
        eng.submit("a", list(range(2, 20)), 4)
        kernels.reset_launch_counts()
        eng.run()
        counts = kernels.launch_counts()
    finally:
        dist.destroy_process_group()
    assert counts["qrlora_bgmv_rows"] == 2 * cfg.n_layers * 4  # 1 prefill + 3 decode steps
    assert counts["qrlora_bgmv"] == counts["qrlora_bgmv_quant"] == 0


# ---------------------------------------------------------------------------
# flash and dense decode attention (the kernel bench's path)
# ---------------------------------------------------------------------------
# Both sides take fp32 scores and an fp32 softmax.  The plain versions round
# the normalised probabilities to the value dtype before P·V (the
# reference's order); the flash kernel rounds its unnormalised ones in bf16,
# the decode kernel keeps them in fp32.  Both are held to the kernel bench's
# limits, whose bf16 term for that rounding scales with P·|v|.


def _attention_close(kind, got, want, q, k, v, arg):
    return err_over_bound(got, want, BENCH_TOL[kind][got.dtype], abs_v_attention(q, k, v, arg)) <= 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,dh", [
    (2, 128, 128, 4, 2, 64), (1, 256, 256, 8, 8, 32), (2, 96, 96, 6, 3, 16),  # the reference's
    (2, 200, 200, 9, 3, 64),  # smollm-135m's heads, a ragged last query tile
    (1, 64, 130, 4, 2, 128), (1, 130, 64, 4, 2, 32),  # Sq ≠ Sk
    # many KV tiles through the cp.async ring, ragged edges, every head dim
    (1, 333, 333, 9, 3, 128), (1, 100, 600, 4, 2, 16), (1, 600, 100, 4, 2, 32),
    (2, 520, 520, 9, 3, 64), (1, 600, 600, 4, 2, 32),  # from 8 tiles on: two warp groups
])
def test_flash_kernel_matches_plain(gen, dtype, causal, B, Sq, Sk, H, KV, dh):
    dev = "cuda"
    q = (torch.randn((B, Sq, H, dh), generator=gen, device=dev) * 0.5).to(dtype)
    k = (torch.randn((B, Sk, KV, dh), generator=gen, device=dev) * 0.5).to(dtype)
    v = (torch.randn((B, Sk, KV, dh), generator=gen, device=dev) * 0.5).to(dtype)
    before = flash_attention_cuda.launches
    o = flash_attention_cuda(q, k, v, causal)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    assert o.dtype == dtype and o.shape == (B, Sq, H, dh) and torch.isfinite(o).all()
    assert _attention_close("flash_attention", o, flash_attention_ref(q, k, v, causal=causal),
                            q, k, v, causal)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pad", [0, 1], ids=["aligned_strides", "odd_strides"])
def test_flash_kernel_reads_strided_layouts(gen, dtype, pad):
    """Views in the model layout: q from a (B,H,S,dh) tensor, k and v as
    slices of one packed (B,S,2·KV,dh+pad) buffer (odd strides: no 16-byte
    copies)."""
    dev, B, S, H, KV, dh = "cuda", 2, 100, 6, 2, 32
    q = (torch.randn((B, H, S, dh), generator=gen, device=dev) * 0.5).to(dtype).transpose(1, 2)
    kv = (torch.randn((B, S, 2 * KV, dh + pad), generator=gen, device=dev) * 0.5).to(dtype)
    k, v = kv[:, :, :KV, :dh], kv[:, :, KV:, :dh]
    o = flash_attention_cuda(q, k, v, True)
    torch.cuda.synchronize()
    assert _attention_close("flash_attention", o, flash_attention_ref(q, k, v, causal=True),
                            q, k, v, True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("as_tensor", [False, True], ids=["int_length", "device_length"])
@pytest.mark.parametrize("B,S,H,KV,dh,L", [
    (2, 256, 4, 2, 64, 100), (1, 512, 8, 8, 32, 512), (3, 128, 6, 3, 16, 1),
    (2, 128, 4, 4, 32, 127),  # the reference's
    (4, 2048, 9, 3, 64, 1000), (2, 64, 8, 2, 128, 33), (2, 64, 9, 3, 64, 0),
    # both sides of the split kernel's 64-position chunk edges (bf16, dh 64),
    # the last position and the whole cache
    *[(4, 2048, 9, 3, 64, L) for L in (63, 64, 65, 2047, 2048)],
    (2, 256, 16, 2, 64, 200),  # a GQA group of 8: two blocks of 4 heads a chunk
])
def test_decode_kernel_matches_plain(gen, dtype, as_tensor, B, S, H, KV, dh, L):
    dev = "cuda"
    q = (torch.randn((B, H, dh), generator=gen, device=dev) * 0.5).to(dtype)
    kc = (torch.randn((B, S, KV, dh), generator=gen, device=dev) * 0.5).to(dtype)
    vc = (torch.randn((B, S, KV, dh), generator=gen, device=dev) * 0.5).to(dtype)
    kc[:, L:] = vc[:, L:] = 1e4  # past the length: must never contribute
    length = torch.tensor(L, dtype=torch.int32, device=dev) if as_tensor else L
    before = decode_attention_cuda.launches
    o = decode_attention_cuda(q, kc, vc, length)
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches == before + 1
    assert o.dtype == dtype and o.shape == (B, H, dh) and torch.isfinite(o).all()
    assert _attention_close("decode_attention", o, decode_attention_ref(q, kc, vc, length),
                            q, kc, vc, length)
    if L == 0:
        assert (o == 0).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_graph_replays_follow_the_device_length(gen, dtype):
    """One call captured in a CUDA graph, replayed after new values are
    written into the length tensor: both launches read it on the card, so
    each replay matches the plain version at the new length."""
    dev, B, S, H, KV, dh = "cuda", 4, 2048, 9, 3, 64
    q = (torch.randn((B, H, dh), generator=gen, device=dev) * 0.5).to(dtype)
    kc = (torch.randn((B, S, KV, dh), generator=gen, device=dev) * 0.5).to(dtype)
    vc = (torch.randn((B, S, KV, dh), generator=gen, device=dev) * 0.5).to(dtype)
    length = torch.tensor(1000, dtype=torch.int32, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_attention_cuda(q, kc, vc, length)  # warm-up: builds and loads the library
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention_cuda(q, kc, vc, length)
    for L in (1000, 37, 0, 2048):
        length.fill_(L)
        graph.replay()
        torch.cuda.synchronize()
        assert _attention_close("decode_attention", out, decode_attention_ref(q, kc, vc, L),
                                q, kc, vc, L), L
        if L == 0:
            assert (out == 0).all()


def test_decode_check_rejects_a_dropped_chunk(gen):
    """Planted fault: a merge that loses the last valid chunk.  The kernel
    at the length cut back to the start of that chunk computes exactly it;
    held against the plain version at the full length, it is over the
    bf16 limit."""
    dev, B, S, H, KV, dh, L = "cuda", 4, 2048, 9, 3, 64, 1000
    q = (torch.randn((B, H, dh), generator=gen, device=dev) * 0.5).bfloat16()
    kc = (torch.randn((B, S, KV, dh), generator=gen, device=dev) * 0.5).bfloat16()
    vc = (torch.randn((B, S, KV, dh), generator=gen, device=dev) * 0.5).bfloat16()
    chunk = decode_attention_chunk(dh, torch.bfloat16)
    dropped = decode_attention_cuda(q, kc, vc, (L - 1) // chunk * chunk)
    torch.cuda.synchronize()
    assert not _attention_close("decode_attention", dropped, decode_attention_ref(q, kc, vc, L),
                                q, kc, vc, L)


def test_attention_ops_launch_the_kernels(gen):
    """The model-layout wrappers go through the kernels on the card, the
    (B,1,H,dh) decode query included."""
    dev = "cuda"
    q = torch.randn((2, 64, 9, 64), generator=gen, device=dev).bfloat16()
    k = torch.randn((2, 64, 3, 64), generator=gen, device=dev).bfloat16()
    kernels.reset_launch_counts()
    o = ops.flash_attention(q, k, k, causal=True, bq=128, bk=128)
    od = ops.decode_attention(q[:, :1], k, k, torch.tensor(40, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    assert o.shape == q.shape and od.shape == (2, 1, 9, 64)
    assert kernels.launch_counts() == {**{n: 0 for n in kernels.KERNEL_WRAPPERS},
                                       "flash_attention": 1, "decode_attention": 1}
