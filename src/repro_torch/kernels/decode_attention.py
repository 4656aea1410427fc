"""Dense decode attention: the Hopper kernel and its wrapper.

One query per batch row attends, GQA, over a dense (B,S,KV,dh) cache whose
first ``length`` positions are valid; one length is shared by the whole
batch, and a length of 0 gives zeros.

Replaces ``repro/kernels/decode_attention.py::decode_attention_kernel``.
The CUDA source is ``csrc/decode_attention.cu``: one block per (batch row,
kv head) covers the GQA group of query heads and streams the valid prefix
through shared memory with an online softmax in fp32; positions past the
length are never read.  The work is bound by reading the valid K/V rows
once; PERF.md has the kernel's times beside that bound.

The length is a Python int or an int32 tensor of one element on the card,
which the kernel reads from memory: the host never waits for it, so a call
can be captured in a CUDA graph.

CPU tensors take the plain version (:func:`repro_torch.kernels.ref.
decode_attention_ref`); CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention_ref

_DTYPES = (torch.float32, torch.bfloat16)
_THREADS, _MAX_OUT, _BT = 128, 4, 32  # csrc/decode_attention.cu: THREADS, MAX_OUT, BT
_MAX_SMEM = 48 * 1024
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("decode_attention")
        lib.decode_attention_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] + [ctypes.c_int] * 5
            + [ctypes.c_float] + [ctypes.c_int] + [ctypes.c_void_p]
        )
        lib.decode_attention_launch.restype = ctypes.c_int
        lib.decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def decode_attention_cuda(q, k_cache, v_cache, length) -> torch.Tensor:
    """Launch the decode kernel on CUDA tensors: q (B,H,dh) and caches
    (B,S,KV,dh), contiguous, in one of float32/bfloat16; ``length`` a Python
    int or a one-element int32 tensor on q's device (clamped to [0, S]).
    Returns (B,H,dh) in q's dtype.  Adds one to
    ``decode_attention_cuda.launches`` per launch."""
    dev = q.device
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != dev:
            raise ValueError(f"decode_attention: {name} on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention: q/cache dtypes {q.dtype}/{k_cache.dtype}/"
                        f"{v_cache.dtype}; need one of {_DTYPES} for all three")
    if q.ndim != 3 or k_cache.ndim != 4 or tuple(v_cache.shape) != tuple(k_cache.shape):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, caches {tuple(k_cache.shape)}/"
                         f"{tuple(v_cache.shape)}; need (B,H,dh) and (B,S,KV,dh)")
    B, H, dh = q.shape
    _, S, KV, _ = k_cache.shape
    if k_cache.shape[0] != B or k_cache.shape[3] != dh or H % KV:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} vs caches {tuple(k_cache.shape)}")
    if not (q.is_contiguous() and k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("decode_attention: q and caches must be contiguous")
    rep = H // KV
    smem = 4 * (rep * dh + _BT * (dh + 1) + _BT * dh + rep * _BT + 3 * rep)
    if rep * dh > _THREADS * _MAX_OUT or smem > _MAX_SMEM:
        raise ValueError(f"decode_attention: group {rep}×{dh} too large")
    if isinstance(length, torch.Tensor):
        if length.device != dev or length.dtype != torch.int32 or length.numel() != 1:
            raise TypeError(f"decode_attention: a tensor length must be one int32 on {dev}, "
                            f"got {length.dtype} {tuple(length.shape)} on {length.device}")
        len_ptr, len_value = length.data_ptr(), 0
    else:
        len_ptr, len_value = None, min(max(int(length), 0), S)
    lib = _library()
    out = torch.empty_like(q)
    err = lib.decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), len_ptr, len_value,
        out.data_ptr(), B, S, H, KV, dh, float(dh**-0.5), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(
            f"decode_attention launch failed: {lib.decode_attention_error_string(err).decode()}"
        )
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0


def decode_attention(q, k_cache, v_cache, length) -> torch.Tensor:
    """Dense decode attention on (B,H,dh) queries: the plain version for CPU
    tensors, the kernel for CUDA tensors (no fallback between the two)."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, length)
    if q.device.type == "cuda":
        return decode_attention_cuda(q, k_cache, v_cache, length)
    raise NotImplementedError(f"decode_attention: no kernel for device {q.device}")
