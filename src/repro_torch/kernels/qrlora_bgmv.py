"""Batched multi-λ QR-LoRA matmul (BGMV): the Hopper kernel and its wrapper.

    y[m] = x[m]·W + ((x[m]·B) * Λ[seg[m]]) · A · scale

Every tenant of a layer shares the frozen pivoted-QR factors (B, A); tenants
differ only in their λ row of the packed table Λ (n_slots, r), slot 0 being
the base model (λ ≡ 0).  One launch serves a heterogeneous batch.

Replaces ``repro/kernels/qrlora_bgmv.py::qrlora_bgmv_kernel``.  The CUDA
source is ``csrc/qrlora_bgmv.cu``: a first pass writes
``P = (x·B) ⊙ Λ[seg]`` (M, r) in fp32 with λ rows loaded by index, and the
main pass computes x·W in shared-memory tiles and adds ``P·A`` in its
epilogue, accumulating in fp32 and writing x's dtype.  At decode the work is
bound by reading W once (0.66 MB for the 576×576 ``wq`` in bf16, ≈ 0.2 µs
at 3.35 TB/s); this version is a plain tiled kernel on the CUDA cores, far
from that bound (PERF.md has its times).

The quantized base (:func:`qrlora_bgmv_quant_cuda`, replacing
``qrlora_bgmv_quant_kernel``) is the same kernel with W as int8 or fp8-e4m3
q (K, N), widened as it is staged, and a per-column ``w_scale`` (N,)
multiplying the x·q sum before the adapter term is added:

    y[m] = (x[m]·q)·w_scale + ((x[m]·B) * Λ[seg[m]]) · A · scale

CPU tensors take the plain versions (:func:`repro_torch.kernels.ref.
qrlora_bgmv_ref`, :func:`~repro_torch.kernels.ref.qrlora_bgmv_quant_ref`);
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantize import FP8_DTYPE
from repro_torch.kernels import _build
from repro_torch.kernels.ref import qrlora_bgmv_quant_ref, qrlora_bgmv_ref

_DTYPES = (torch.float32, torch.bfloat16)
#: quantized-weight dtypes the kernels take
Q_DTYPES = (torch.int8, FP8_DTYPE)
_MAX_K = 11776  # pass 1 stages one row of x (fp32) beside 1 KB of partial sums in 48 KB
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("qrlora_bgmv")
        lib.qrlora_bgmv_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float]
            + [ctypes.c_int, ctypes.c_void_p]
        )
        lib.qrlora_bgmv_launch.restype = ctypes.c_int
        lib.qrlora_bgmv_quant_launch.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float]
            + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        lib.qrlora_bgmv_quant_launch.restype = ctypes.c_int
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
    if K > _MAX_K:
        raise ValueError(f"qrlora_bgmv: K={K} exceeds {_MAX_K}")
    lib = _library()
    P = torch.empty((M, r), dtype=torch.float32, device=dev)
    y = torch.empty((M, N), dtype=x.dtype, device=dev)
    err = lib.qrlora_bgmv_launch(
        x.data_ptr(), W.data_ptr(), B.data_ptr(), A.data_ptr(), lam_table.data_ptr(),
        seg.data_ptr(), P.data_ptr(), y.data_ptr(), M, K, N, r, n_slots, float(scale),
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(
            f"qrlora_bgmv launch failed: {lib.qrlora_bgmv_error_string(err).decode()}"
        )
    qrlora_bgmv_cuda.launches += 1
    return y


qrlora_bgmv_cuda.launches = 0


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
    if K > _MAX_K:
        raise ValueError(f"{name}: K={K} exceeds {_MAX_K}")
    lib = _library()
    P = torch.empty((M, r), dtype=torch.float32, device=dev)
    y = torch.empty((M, N), dtype=x.dtype, device=dev)
    err = lib.qrlora_bgmv_quant_launch(
        x.data_ptr(), q.data_ptr(), w_scale.data_ptr(), B.data_ptr(), A.data_ptr(),
        lam_table.data_ptr(), seg.data_ptr(), P.data_ptr(), y.data_ptr(), M, K, N, r, n_slots,
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
