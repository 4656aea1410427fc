"""Batched multi-λ QR-LoRA matmul (BGMV): the Hopper kernel and its wrapper.

    y[m] = x[m]·W + ((x[m]·B) * Λ[seg[m]]) · A · scale

Every tenant of a layer shares the frozen pivoted-QR factors (B, A); tenants
differ only in their λ row of the packed table Λ (n_slots, r), slot 0 being
the base model (λ ≡ 0).  One launch serves a heterogeneous batch.

Replaces ``repro/kernels/qrlora_bgmv.py::qrlora_bgmv_kernel``.  The CUDA
source is ``csrc/qrlora_bgmv.cu``: one launch of thread-block clusters, each
cluster a 32-column tile of y whose 8 CTAs split K, take their partial x·W
and x·B in fp32 (bf16 on the tensor cores, float32 on the CUDA cores), and
sum them in rank order through distributed shared memory; λ multiplies the
summed x·B, and P·A is split over the ranks the same way, so P never
reaches device memory.  At decode the work is bound by reading W, B and A
once (≈ 0.97 MB for the 576×576 ``wq`` in bf16, ≈ 0.29 µs at 3.35 TB/s); a
call's time is its chain of latencies (PERF.md has its times).
:func:`qrlora_bgmv_plan` gives the split of a launch.

The quantized base (:func:`qrlora_bgmv_quant_cuda`, replacing
``qrlora_bgmv_quant_kernel``) is the same launch over an int8 or fp8-e4m3 q
(K, N), staged one byte an element and widened in the CTA (exactly), with a
per-column ``w_scale`` (N,) multiplying the rank-order x·q sum, rounded in
fp32, before the adapter term is added:

    y[m] = (x[m]·q)·w_scale + ((x[m]·B) * Λ[seg[m]]) · A · scale

Sharded λ tables (the serve's ``shard_lam``): each rank of a
``torch.distributed`` group holds n_slots / world rows of every table.
:func:`qrlora_bgmv_fused_sharded` gathers a batch's rows from the local
shard (out-of-shard slots as exact zeros, :func:`local_lam_rows`),
all-reduces the (M, r) fp32 rows — one owned row plus zeros, so bitwise the
replicated ``Λ[seg]`` — and feeds them to the rows kernel
(:func:`qrlora_bgmv_rows_cuda`, replacing ``qrlora_bgmv_rows_kernel``),
which reads ``rows[m]`` where the BGMV kernel reads ``Λ[seg[m]]``:

    y[m] = x[m]·W + ((x[m]·B) * rows[m]) · A · scale        (W in x's dtype)
    y[m] = (x[m]·q)·w_scale + ((x[m]·B) * rows[m]) · A · scale

It is the BGMV kernel's own code, so with rows = Λ[seg] its result is
bitwise the BGMV kernel's (on a q, the quantized kernel's).  The all-reduce
comes before the kernel: summing partial products after ``(x·B)·λ·A`` would
reassociate the float sum and lose bit-identity with the replicated engine.
:func:`ba_gather_sharded` reassembles rank-dim shards of B and A
(``shard_ba``) by an exact all-gather.  Collectives run on the group's
backend (gloo for CPU tensors, NCCL for CUDA tensors).

CPU tensors take the plain versions (:func:`repro_torch.kernels.ref.
qrlora_bgmv_ref`, :func:`~repro_torch.kernels.ref.qrlora_bgmv_quant_ref`,
:func:`~repro_torch.kernels.ref.qrlora_bgmv_rows_ref`); CUDA tensors launch
the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

from repro_torch.core.quantize import FP8_DTYPE
from repro_torch.kernels import _build
from repro_torch.kernels.ref import qrlora_bgmv_quant_ref, qrlora_bgmv_ref, qrlora_bgmv_rows_ref

_DTYPES = (torch.float32, torch.bfloat16)
#: the C interface's code of a quantized W's type (0: W in x's dtype)
_W_KIND = {torch.int8: 1, FP8_DTYPE: 2}
#: quantized-weight dtypes the kernels take
Q_DTYPES = tuple(_W_KIND)
#: largest rank r the kernels serve
MAX_RANK = 256
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("qrlora_bgmv")
        lib.qrlora_bgmv_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float]
            + [ctypes.c_int, ctypes.c_void_p]
        )
        lib.qrlora_bgmv_launch.restype = ctypes.c_int
        lib.qrlora_bgmv_quant_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float]
            + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        lib.qrlora_bgmv_quant_launch.restype = ctypes.c_int
        lib.qrlora_bgmv_rows_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float]
            + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        lib.qrlora_bgmv_rows_launch.restype = ctypes.c_int
        lib.qrlora_bgmv_plan.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.qrlora_bgmv_plan.restype = None
        lib.qrlora_bgmv_error_string.argtypes = [ctypes.c_int]
        lib.qrlora_bgmv_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name, t, dtypes, shape, device, kernel="qrlora_bgmv"):
    if t.device != device:
        raise ValueError(f"{kernel}: {name} on {t.device}, x on {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{kernel}: {name} dtype {t.dtype} not in {dtypes}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{kernel}: {name} shape {tuple(t.shape)} != {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def qrlora_bgmv_cuda(x, W, B, A, lam_table, seg, scale: float = 1.0) -> torch.Tensor:
    """Launch the BGMV kernel on CUDA tensors: x (M,K) and W (K,N) in one of
    float32/bfloat16, the QR factors B (K,r) and A (r,N) in bfloat16 (as
    ``init_adapters`` makes them), Λ (n_slots,r) float32, seg (M,) int32.  Returns (M,N) in x's dtype.  Adds one to
    ``qrlora_bgmv_cuda.launches`` per launch."""
    M, K = x.shape
    N, r, n_slots = W.shape[1], B.shape[1], lam_table.shape[0]
    dev = x.device
    _check("x", x, _DTYPES, (M, K), dev)
    _check("W", W, (x.dtype,), (K, N), dev)
    _check("B", B, (torch.bfloat16,), (K, r), dev)
    _check("A", A, (torch.bfloat16,), (r, N), dev)
    _check("lam_table", lam_table, (torch.float32,), (n_slots, r), dev)
    _check("seg", seg, (torch.int32,), (M,), dev)
    if r > MAX_RANK:
        raise ValueError(f"qrlora_bgmv: rank r={r} exceeds {MAX_RANK}")
    lib = _library()
    y = torch.empty((M, N), dtype=x.dtype, device=dev)
    err = lib.qrlora_bgmv_launch(
        x.data_ptr(), W.data_ptr(), B.data_ptr(), A.data_ptr(), lam_table.data_ptr(),
        seg.data_ptr(), y.data_ptr(), M, K, N, r, n_slots, float(scale),
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(
            f"qrlora_bgmv launch failed: {lib.qrlora_bgmv_error_string(err).decode()}"
        )
    qrlora_bgmv_cuda.launches += 1
    return y


qrlora_bgmv_cuda.launches = 0


def qrlora_bgmv_plan(M: int, K: int, N: int, r: int, dtype=torch.bfloat16,
                     w_dtype=None) -> dict:
    """How the one-launch kernel (x in ``dtype``; W in x's dtype, or an
    int8/fp8 q where ``w_dtype`` names one) splits an (M, K) × (K, N)
    product of rank r, in the numbers the kernel uses: ``cluster`` (CTAs
    splitting K), ``grid`` (column tiles × cluster, row tiles), ``ctas``,
    ``k_slice`` (K rows a rank takes), ``p_cols`` (rank columns of P a rank
    sums) and ``smem`` (dynamic shared memory of a CTA, bytes).  Loads the
    library (builds it if needed)."""
    plan = (ctypes.c_int * 7)()
    _library().qrlora_bgmv_plan(M, K, N, r, int(dtype == torch.bfloat16),
                                _W_KIND.get(w_dtype, 0), plan)
    return {"cluster": plan[0], "grid": (plan[1], plan[2]), "ctas": plan[3],
            "k_slice": plan[4], "p_cols": plan[5], "smem": plan[6]}


def qrlora_bgmv(x, W, B, A, lam_table, seg, scale: float = 1.0) -> torch.Tensor:
    """2-D BGMV: the plain version for CPU tensors, the kernel for CUDA
    tensors (no fallback between the two)."""
    if x.device.type == "cpu":
        return qrlora_bgmv_ref(x, W, B, A, lam_table, seg, scale)
    if x.device.type == "cuda":
        return qrlora_bgmv_cuda(x, W, B, A, lam_table, seg, scale)
    raise NotImplementedError(f"qrlora_bgmv: no kernel for device {x.device}")


def qrlora_bgmv_quant_cuda(x, q, w_scale, B, A, lam_table, seg, scale: float = 1.0) -> torch.Tensor:
    """Launch the quantized-base BGMV kernel on CUDA tensors: x (M,K) in
    float32/bfloat16, q (K,N) int8 or float8_e4m3fn, w_scale (N,) float32,
    B (K,r) and A (r,N) bfloat16, Λ (n_slots,r) float32, seg (M,) int32; all
    contiguous.  Returns (M,N) in x's dtype.  Adds one to
    ``qrlora_bgmv_quant_cuda.launches`` per launch."""
    M, K = x.shape
    N, r, n_slots = q.shape[1], B.shape[1], lam_table.shape[0]
    dev, name = x.device, "qrlora_bgmv_quant"
    for arg, t, dtypes, shape in (
        ("x", x, _DTYPES, (M, K)),
        ("q", q, Q_DTYPES, (K, N)),
        ("w_scale", w_scale, (torch.float32,), (N,)),
        ("B", B, (torch.bfloat16,), (K, r)),
        ("A", A, (torch.bfloat16,), (r, N)),
        ("lam_table", lam_table, (torch.float32,), (n_slots, r)),
        ("seg", seg, (torch.int32,), (M,)),
    ):
        _check(arg, t, dtypes, shape, dev, kernel=name)
    if r > MAX_RANK:
        raise ValueError(f"{name}: rank r={r} exceeds {MAX_RANK}")
    lib = _library()
    y = torch.empty((M, N), dtype=x.dtype, device=dev)
    err = lib.qrlora_bgmv_quant_launch(
        x.data_ptr(), q.data_ptr(), w_scale.data_ptr(), B.data_ptr(), A.data_ptr(),
        lam_table.data_ptr(), seg.data_ptr(), y.data_ptr(), M, K, N, r, n_slots,
        float(scale), int(x.dtype == torch.bfloat16), int(q.dtype != torch.int8),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{name} launch failed: {lib.qrlora_bgmv_error_string(err).decode()}")
    qrlora_bgmv_quant_cuda.launches += 1
    return y


qrlora_bgmv_quant_cuda.launches = 0


def qrlora_bgmv_quant(x, q, w_scale, B, A, lam_table, seg, scale: float = 1.0) -> torch.Tensor:
    """2-D quantized-base BGMV: the plain version for CPU tensors, the
    kernel for CUDA tensors (no fallback between the two)."""
    if x.device.type == "cpu":
        return qrlora_bgmv_quant_ref(x, q, w_scale, B, A, lam_table, seg, scale)
    if x.device.type == "cuda":
        return qrlora_bgmv_quant_cuda(x, q, w_scale, B, A, lam_table, seg, scale)
    raise NotImplementedError(f"qrlora_bgmv_quant: no kernel for device {x.device}")


def qrlora_bgmv_rows_cuda(x, W, w_scale, B, A, lam_rows, scale: float = 1.0) -> torch.Tensor:
    """Launch the rows kernel on CUDA tensors: x (M,K) float32/bfloat16, W
    (K,N) in x's dtype with ``w_scale`` None, or int8/float8_e4m3fn q with
    w_scale (N,) float32; B (K,r) and A (r,N) bfloat16, lam_rows (M,r)
    float32; all contiguous.  Returns (M,N) in x's dtype.  Adds one to
    ``qrlora_bgmv_rows_cuda.launches`` per launch."""
    M, K = x.shape
    N, r = W.shape[1], B.shape[1]
    dev, name = x.device, "qrlora_bgmv_rows"
    for arg, t, dtypes, shape in (
        ("x", x, _DTYPES, (M, K)),
        ("W", W, (x.dtype, *Q_DTYPES), (K, N)),
        ("B", B, (torch.bfloat16,), (K, r)),
        ("A", A, (torch.bfloat16,), (r, N)),
        ("lam_rows", lam_rows, (torch.float32,), (M, r)),
    ):
        _check(arg, t, dtypes, shape, dev, kernel=name)
    quant = W.dtype in Q_DTYPES
    if w_scale is not None:
        _check("w_scale", w_scale, (torch.float32,), (N,), dev, kernel=name)
    if quant != (w_scale is not None):
        raise ValueError(f"{name}: w_scale goes with an int8/fp8 q and only with one")
    if r > MAX_RANK:
        raise ValueError(f"{name}: rank r={r} exceeds {MAX_RANK}")
    lib = _library()
    y = torch.empty((M, N), dtype=x.dtype, device=dev)
    err = lib.qrlora_bgmv_rows_launch(
        x.data_ptr(), W.data_ptr(), w_scale.data_ptr() if quant else None, B.data_ptr(),
        A.data_ptr(), lam_rows.data_ptr(), y.data_ptr(), M, K, N, r, float(scale),
        int(x.dtype == torch.bfloat16), _W_KIND.get(W.dtype, 0),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{name} launch failed: {lib.qrlora_bgmv_error_string(err).decode()}")
    qrlora_bgmv_rows_cuda.launches += 1
    return y


qrlora_bgmv_rows_cuda.launches = 0


def qrlora_bgmv_rows(x, W, w_scale, B, A, lam_rows, scale: float = 1.0) -> torch.Tensor:
    """2-D BGMV over pre-gathered λ rows: the plain version for CPU tensors,
    the kernel for CUDA tensors (no fallback between the two)."""
    if x.device.type == "cpu":
        return qrlora_bgmv_rows_ref(x, W, w_scale, B, A, lam_rows, scale)
    if x.device.type == "cuda":
        return qrlora_bgmv_rows_cuda(x, W, w_scale, B, A, lam_rows, scale)
    raise NotImplementedError(f"qrlora_bgmv_rows: no kernel for device {x.device}")


# ---------------------------------------------------------------------------
# collectives of the sharded serve
# ---------------------------------------------------------------------------

#: collective → calls issued by this process (reset with
#: :func:`reset_collective_counts`), so a run can show what it exchanged
COLLECTIVES = {"all_reduce": 0, "all_gather": 0}


def reset_collective_counts() -> None:
    for name in COLLECTIVES:
        COLLECTIVES[name] = 0


def local_lam_rows(tab_local, seg, rank: int) -> torch.Tensor:
    """This rank's contribution to a batch's λ rows: ``tab_local`` holds the
    global slots ``rank·n_local … rank·n_local + n_local − 1``; a row whose
    slot lives here gets its λ, every other row exact zeros (the reference's
    masked, clipped ``take``)."""
    n_local = tab_local.shape[0]
    local = seg.long() - rank * n_local
    idx = local.clamp(0, n_local - 1)  # == local exactly where the slot lives here
    return torch.where((idx == local)[:, None], tab_local[idx], 0.0)


def lam_gather_sharded(tab_local, seg, group) -> torch.Tensor:
    """A batch's λ rows (M, r) fp32 from slot tables sharded over ``group``:
    the local masked gather, then an all-reduce.  Every slot lives on one
    rank, so each sum is one row plus exact zeros: bitwise ``Λ[seg]`` of the
    replicated table."""
    rows = local_lam_rows(tab_local, seg, dist.get_rank(group)).float().contiguous()
    dist.all_reduce(rows, op=dist.ReduceOp.SUM, group=group)
    COLLECTIVES["all_reduce"] += 1
    return rows


def _all_gather_cat(t, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    COLLECTIVES["all_gather"] += 1
    return torch.cat(parts, dim=dim)


def ba_gather_sharded(B, A, group):
    """The shared QR factors whole again from rank-dim shards (B (..., K,
    r/world), A (..., r/world, N) on each rank of ``group``): an all-gather
    and a concatenation in rank order, no arithmetic, so every contraction
    downstream is bitwise the replicated engine's."""
    return _all_gather_cat(B, B.ndim - 1, group), _all_gather_cat(A, A.ndim - 2, group)


def qrlora_bgmv_fused_sharded(x, W, B, A, tab_local, seg, *, group, scale: float = 1.0,
                              w_scale=None) -> torch.Tensor:
    """Sharded-λ BGMV: :func:`lam_gather_sharded` on this rank's slot
    shard, then the rows kernel (plain version for CPU tensors).  x (M,K),
    W (K,N) in x's dtype (``w_scale`` None) or int8/fp8 q with ``w_scale``
    (N,), B and A whole (replicated, or gathered first), seg (M,) global
    slot ids."""
    rows = lam_gather_sharded(tab_local, seg, group)
    return qrlora_bgmv_rows(x, W, w_scale, B, A, rows, scale)
