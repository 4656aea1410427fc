"""One-λ QR-LoRA matmul: the Hopper kernel and its wrapper.

    y = x·W + ((x·B) * λ) · A · scale

The forward of the trainable adapted projection: B and A are the frozen
pivoted-QR factors of W, λ (r,) the trained coefficients; ΔW is never
formed.

Replaces ``repro/kernels/qrlora_matmul.py::qrlora_matmul_kernel``.  The CUDA
source is ``csrc/qrlora_matmul.cu``.  For bf16 x everything runs on the
tensor cores: a P pass writes ``P' = scale · λ ⊙ (x·B)`` split into two
bf16 halves (P_hi = bf16(P'), P_lo = bf16(P' − P_hi); exact products
against the bf16 A, ≈ 16 bits of P' kept), and the main pass is one K loop
of depth K + 2r over ``[x | P_hi | P_lo]`` against ``[W ; A ; A]``: wgmma
from shared memory, tiles brought by TMA into an mbarrier ring, the fp32
accumulator in registers until y is written in x's dtype.  The main pass is
launched as a programmatic dependent of the P pass and waits for P only
before its first P step; where the output tiles are too few to fill the
card (a 64-row forward) it splits K over a thread-block cluster and sums
the ranks' partial tiles in rank order.  Tiles are 64 × 64;
:func:`qrlora_matmul_plan` says how a shape's K loop is split.  At the training shapes (M = 2048, K = 576, N = 576,
r = 128) the bound is ≈ 2.0 µs of bf16 tensor-core operations; at 64 rows
only latency bounds it.  float32 x keeps a CUDA-core route (fp32 P, fp32
epilogue).  PERF.md has the kernel's times.

The quantized base (:func:`qrlora_matmul_quant_cuda`, replacing
``qrlora_matmul_quant_kernel``) runs the same main pass over int8 or
fp8-e4m3 q (K, N) instead of W, widened to bf16 (exactly) by a warpgroup
of its own one stage ahead of the products, and multiplies the full x·q sum
by a per-column ``w_scale`` (N,), rounded in fp32, before any adapter
product is added:

    y = (x·q)·w_scale + ((x·B) * λ) · A · scale

It is forward only, as the reference's: training keeps the bf16 base.

CPU tensors take the plain versions (:func:`repro_torch.kernels.ref.
qrlora_matmul_ref`, :func:`~repro_torch.kernels.ref.qrlora_matmul_quant_ref`);
CUDA tensors launch the kernel or raise.  The backward of the bf16/float32
kernel lives in :mod:`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.qrlora_bgmv import Q_DTYPES, _check
from repro_torch.kernels.ref import qrlora_matmul_quant_ref, qrlora_matmul_ref

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_CLUSTER = 8  # the most CTAs the kernel splits a K loop over
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("qrlora_matmul")
        lib.qrlora_matmul_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float]
            + [ctypes.c_int, ctypes.c_void_p]
        )
        lib.qrlora_matmul_launch.restype = ctypes.c_int
        lib.qrlora_matmul_quant_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float]
            + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        lib.qrlora_matmul_quant_launch.restype = ctypes.c_int
        lib.qrlora_matmul_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.qrlora_matmul_plan.restype = None
        lib.qrlora_matmul_error_string.argtypes = [ctypes.c_int]
        lib.qrlora_matmul_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def qrlora_matmul_cuda(x, W, B, A, lam, scale: float = 1.0) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: x (M,K) and W (K,N) in one of
    float32/bfloat16, the QR factors B (K,r) and A (r,N) in bfloat16 (as
    ``init_adapters`` makes them), λ (r,) float32; all contiguous, and for
    bfloat16 x with K, N, r multiples of 8 and x, W, B, A 16-byte aligned
    (TMA reads them).
    Returns (M,N) in x's dtype.  Adds one to ``qrlora_matmul_cuda.launches``
    per launch."""
    M, K = x.shape
    N, r = W.shape[1], B.shape[1]
    dev = x.device
    for name, t, dtypes, shape in (
        ("x", x, _DTYPES, (M, K)),
        ("W", W, (x.dtype,), (K, N)),
        ("B", B, (torch.bfloat16,), (K, r)),
        ("A", A, (torch.bfloat16,), (r, N)),
        ("lam", lam, (torch.float32,), (r,)),
    ):
        _check(name, t, dtypes, shape, dev, kernel="qrlora_matmul")
    if x.dtype == torch.bfloat16:  # TMA: 16-byte row strides and bases
        if K % 8 or N % 8 or r % 8:
            raise ValueError(f"qrlora_matmul: bf16 needs K, N, r multiples of 8, got {K}, {N}, {r}")
        if any(t.data_ptr() % 16 for t in (x, W, B, A)):
            raise ValueError("qrlora_matmul: bf16 x, W, B, A must be 16-byte aligned")
    lib = _library()
    # fp32 P for float32 x; P_hi then P_lo, bf16 (M, r) each, for bfloat16 x
    P = torch.empty((M, r), dtype=torch.float32, device=dev)
    y = torch.empty((M, N), dtype=x.dtype, device=dev)
    err = lib.qrlora_matmul_launch(
        x.data_ptr(), W.data_ptr(), B.data_ptr(), A.data_ptr(), lam.data_ptr(),
        P.data_ptr(), y.data_ptr(), M, K, N, r, float(scale),
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(
            f"qrlora_matmul launch failed: {lib.qrlora_matmul_error_string(err).decode()}"
        )
    qrlora_matmul_cuda.launches += 1
    return y


qrlora_matmul_cuda.launches = 0


def qrlora_matmul_plan(M: int, K: int, N: int, r: int) -> dict:
    """How the bf16 route splits the K loop of an (M, K) × (K, N) product
    of rank r on the current card (both one-λ kernels), as the kernel
    computes it: ``cluster`` CTAs share each main-pass tile (1: no split),
    of which ``ranks_x`` take x·W steps and the rest P steps;
    ``p_cluster`` is the P pass's split (0 for r = 0); ``steps[c]`` the K
    steps that rank c of the main pass runs.  Step g is x·W over K-columns
    ``[64·g, 64·g + 64)`` for ``g < ⌈K/64⌉``, then P_hi's and P_lo's steps
    over rank columns ``[64·j, 64·j + 64)``."""
    plan = (ctypes.c_int * (3 + 3 * _MAX_CLUSTER))()
    _library().qrlora_matmul_plan(M, K, N, r, ctypes.addressof(plan))
    steps = tuple(tuple(range(plan[3 + 3 * c], plan[5 + 3 * c], plan[4 + 3 * c]))
                  for c in range(plan[0]))
    return {"cluster": plan[0], "ranks_x": plan[1], "p_cluster": plan[2], "steps": steps}


def qrlora_matmul(x, W, B, A, lam, scale: float = 1.0) -> torch.Tensor:
    """2-D one-λ adapter matmul: the plain version for CPU tensors, the
    kernel for CUDA tensors (no fallback between the two)."""
    if x.device.type == "cpu":
        return qrlora_matmul_ref(x, W, B, A, lam, scale)
    if x.device.type == "cuda":
        return qrlora_matmul_cuda(x, W, B, A, lam, scale)
    raise NotImplementedError(f"qrlora_matmul: no kernel for device {x.device}")


def qrlora_matmul_quant_cuda(x, q, w_scale, B, A, lam, scale: float = 1.0) -> torch.Tensor:
    """Launch the quantized-base one-λ kernel on CUDA tensors: x (M,K) in
    float32/bfloat16, q (K,N) int8 or float8_e4m3fn, w_scale (N,) float32,
    B (K,r) and A (r,N) bfloat16, λ (r,) float32; all contiguous, and for
    bfloat16 x with K and N multiples of 16, r a multiple of 8, and x, q,
    B, A 16-byte aligned (TMA reads them).  Returns (M,N) in x's dtype.  Adds one to
    ``qrlora_matmul_quant_cuda.launches`` per launch."""
    M, K = x.shape
    N, r = q.shape[1], B.shape[1]
    dev, name = x.device, "qrlora_matmul_quant"
    for arg, t, dtypes, shape in (
        ("x", x, _DTYPES, (M, K)),
        ("q", q, Q_DTYPES, (K, N)),
        ("w_scale", w_scale, (torch.float32,), (N,)),
        ("B", B, (torch.bfloat16,), (K, r)),
        ("A", A, (torch.bfloat16,), (r, N)),
        ("lam", lam, (torch.float32,), (r,)),
    ):
        _check(arg, t, dtypes, shape, dev, kernel=name)
    if x.dtype == torch.bfloat16:  # TMA boxes: 16-byte rows of q, 16-byte aligned bases
        if K % 16 or N % 16 or r % 8:
            raise ValueError(
                f"{name}: bf16 needs K, N multiples of 16 and r of 8, got {K}, {N}, {r}"
            )
        if any(t.data_ptr() % 16 for t in (x, q, B, A)):
            raise ValueError(f"{name}: bf16 x, q, B, A must be 16-byte aligned")
    lib = _library()
    P = torch.empty((M, r), dtype=torch.float32, device=dev)
    y = torch.empty((M, N), dtype=x.dtype, device=dev)
    err = lib.qrlora_matmul_quant_launch(
        x.data_ptr(), q.data_ptr(), w_scale.data_ptr(), B.data_ptr(), A.data_ptr(),
        lam.data_ptr(), P.data_ptr(), y.data_ptr(), M, K, N, r, float(scale),
        int(x.dtype == torch.bfloat16), int(q.dtype != torch.int8),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{name} launch failed: {lib.qrlora_matmul_error_string(err).decode()}")
    qrlora_matmul_quant_cuda.launches += 1
    return y


qrlora_matmul_quant_cuda.launches = 0


def qrlora_matmul_quant(x, q, w_scale, B, A, lam, scale: float = 1.0) -> torch.Tensor:
    """2-D quantized-base one-λ matmul: the plain version for CPU tensors,
    the kernel for CUDA tensors (no fallback between the two)."""
    if x.device.type == "cpu":
        return qrlora_matmul_quant_ref(x, q, w_scale, B, A, lam, scale)
    if x.device.type == "cuda":
        return qrlora_matmul_quant_cuda(x, q, w_scale, B, A, lam, scale)
    raise NotImplementedError(f"qrlora_matmul_quant: no kernel for device {x.device}")
