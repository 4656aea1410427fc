"""Dense decode attention: the Hopper kernel and its wrapper.

One query per batch row attends, GQA, over a dense (B,S,KV,dh) cache whose
first ``length`` positions are valid; one length is shared by the whole
batch, and a length of 0 gives zeros.

Replaces ``repro/kernels/decode_attention.py::decode_attention_kernel``.
The work is bound by reading the valid K/V rows once (≈ 0.9 µs at 4 rows ×
length 1000 × 3 kv heads × dh 64 in bf16, at the H100 SXM data sheet's
3.35 TB/s), so the kernel has to spread that read over the card: the CUDA
source (``csrc/decode_attention.cu``) splits the cache into fixed chunks
(:func:`decode_attention_chunk` positions; 64 in bf16 at dh 64), one block
per (chunk, kv head, batch row) reading its chunk once for the GQA group
in 16-byte loads and writing the chunk's fp32 softmax state (max, sum,
accumulator) to a workspace; a second launch merges the valid chunks.
Positions past the length are never read.  PERF.md has the kernel's times
beside its bound.

The length is a Python int or an int32 tensor of one element on the card,
which both launches read from memory: the number of chunks follows S, not
the length, so the host never waits for it and a call can be captured in
a CUDA graph and replayed after the length tensor changes.

CPU tensors take the plain version (:func:`repro_torch.kernels.ref.
decode_attention_ref`); CUDA tensors launch the kernel or raise.
:func:`repro_torch.kernels.ref.decode_attention_split_ref` mirrors the
split-and-merge arithmetic for the CPU tests.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention_ref

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 128)  # csrc/decode_attention.cu instantiations
_MAX_SMEM = 48 * 1024
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("decode_attention")
        lib.decode_attention_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
            + [ctypes.c_float] + [ctypes.c_int] + [ctypes.c_void_p]
        )
        lib.decode_attention_launch.restype = ctypes.c_int
        lib.decode_attention_chunk.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.decode_attention_chunk.restype = ctypes.c_int
        lib.decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def decode_attention_chunk(dh: int, dtype) -> int:
    """Cache positions one split block of the kernel covers at head dim
    ``dh`` in ``dtype`` (16 KB of K and V: 64 in bf16 at dh 64)."""
    return _library().decode_attention_chunk(dh, int(dtype == torch.bfloat16))


def decode_attention_cuda(q, k_cache, v_cache, length) -> torch.Tensor:
    """Launch the decode kernels on CUDA tensors: q (B,H,dh) and caches
    (B,S,KV,dh), contiguous and 16-byte aligned, in one of float32/bfloat16,
    dh ∈ :data:`HEAD_DIMS`; ``length`` a Python int or a one-element int32
    tensor on q's device (clamped to [0, S]).  Returns (B,H,dh) in q's
    dtype.  Adds one to ``decode_attention_cuda.launches`` per call (the
    split and the combine launch together)."""
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
    if dh not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {dh} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("decode_attention: q and caches must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_cache, v_cache)):
        raise ValueError("decode_attention: q and caches must start on a 16-byte boundary")
    if isinstance(length, torch.Tensor):
        if length.device != dev or length.dtype != torch.int32 or length.numel() != 1:
            raise TypeError(f"decode_attention: a tensor length must be one int32 on {dev}, "
                            f"got {length.dtype} {tuple(length.shape)} on {length.device}")
        len_ptr, len_value = length.data_ptr(), 0
    else:
        len_ptr, len_value = None, min(max(int(length), 0), S)
    lib = _library()
    n_split = -(-S // decode_attention_chunk(dh, q.dtype))
    if 8 * n_split > _MAX_SMEM:  # the combine holds each chunk's (weight, sum) in shared memory
        raise ValueError(f"decode_attention: a cache of {S} positions is {n_split} chunks, "
                         f"over {_MAX_SMEM // 8}")
    out = torch.empty_like(q)
    ws_acc = torch.empty((B, H, n_split, dh), dtype=torch.float32, device=dev)
    ws_ml = torch.empty((B, H, n_split, 2), dtype=torch.float32, device=dev)
    err = lib.decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), len_ptr, len_value,
        out.data_ptr(), ws_acc.data_ptr(), ws_ml.data_ptr(), B, S, H, KV, dh, float(dh**-0.5),
        int(q.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream,
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
