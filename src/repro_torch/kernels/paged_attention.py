"""Paged decode attention: the Hopper kernel and its wrapper.

One query per lane attends, GQA, over the KV pool blocks its block-table
row names, masked by the lane's length; a lane of length 0 gives zeros.

Replaces ``repro/kernels/paged_attention.py::paged_decode_attention_kernel``.
The work is bound by reading the valid K/V rows once, so the CUDA source
(``csrc/paged_attention.cu``) reads them as the dense decode kernel does
(``csrc/decode_chunk.cuh``): chunks of :func:`paged_decode_plan`'s
``chunk`` positions (64 in bf16 at dh 64), each position's row found
through the table, in 16-byte loads issued before the first product, the
GQA group read once for up to 4 query heads, an fp32 softmax state per
chunk.  One launch: a cluster of up to 8 CTAs per (kv head, lane) splits
the table's chunks (rank r takes chunks r, r + 8, …, folding them in
order) and merges the ranks' states in rank order through distributed
shared memory.  The cluster follows the table's column count, never the
length: every CTA reads its lane's length and table entries on the card,
so a call never waits on the host and replays in a CUDA graph after the
lengths change.  Positions past the length and their table entries are
never read (stale entries and trash block 0 cannot contribute); an entry
outside ``[0, n_blocks)`` reads nothing and its positions contribute
nothing.  PERF.md has the kernel's times beside its bound.

CPU tensors take the plain version (:func:`repro_torch.kernels.ref.
paged_decode_attention_ref`); CUDA tensors launch the kernel or raise.
:func:`repro_torch.kernels.ref.paged_decode_attention_split_ref` mirrors the
chunk-and-merge arithmetic for the CPU tests.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_decode_attention_ref

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 128)  # csrc/paged_attention.cu instantiations
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("paged_attention")
        lib.paged_decode_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float]
            + [ctypes.c_int, ctypes.c_void_p]
        )
        lib.paged_decode_launch.restype = ctypes.c_int
        lib.paged_decode_plan.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
        lib.paged_decode_plan.restype = ctypes.c_int
        lib.paged_decode_error_string.argtypes = [ctypes.c_int]
        lib.paged_decode_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def paged_decode_plan(B: int, H: int, KV: int, dh: int, bs: int, max_blocks: int,
                      dtype) -> dict:
    """How the kernel splits a call, from its own numbers: ``chunk``
    positions a chunk, ``chunks`` of the table (⌈max_blocks·bs / chunk⌉),
    ``cluster`` CTAs a cluster (min(chunks, 8); a rank folds ⌈chunks /
    cluster⌉ chunks at most: ``chunks_per_rank``), and the ``grid``.  The
    lengths do not enter."""
    lib = _library()
    plan = (ctypes.c_int * 4)()
    err = lib.paged_decode_plan(H, KV, dh, bs, max_blocks, int(dtype == torch.bfloat16), plan)
    if err:
        raise ValueError(f"paged_decode_plan: {lib.paged_decode_error_string(err).decode()}")
    chunk, cs, grid_y, chunks = plan
    return {"chunk": chunk, "chunks": chunks, "cluster": cs, "grid": (cs, grid_y, B),
            "chunks_per_rank": -(-chunks // cs)}


def paged_decode_attention_cuda(q, k_pool, v_pool, block_tbl, lengths) -> torch.Tensor:
    """Launch the paged decode kernel on CUDA tensors: q (B,H,dh) and pools
    (n_blocks, bs, KV, dh), contiguous and 16-byte aligned, in one of
    float32/bfloat16, dh ∈ :data:`HEAD_DIMS`; block_tbl (B, max_blocks)
    int32 with unit column stride (a column slice of a wider table is fine);
    lengths (B,) int32 (clamped to [0, max_blocks·bs] on the card).  Returns
    (B,H,dh) in q's dtype.  Adds one to
    ``paged_decode_attention_cuda.launches`` per launch."""
    B, H, dh = q.shape
    n_blocks, bs, KV, _ = k_pool.shape
    max_blocks = block_tbl.shape[1]
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool), ("block_tbl", block_tbl),
                    ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"paged_decode_attention: {name} on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(
            f"paged_decode_attention: q/k/v dtypes {q.dtype}/{k_pool.dtype}/"
            f"{v_pool.dtype}; need one of {_DTYPES} for all three"
        )
    if tuple(v_pool.shape) != tuple(k_pool.shape) or k_pool.shape[3] != dh or H % KV:
        raise ValueError(
            f"paged_decode_attention: q {tuple(q.shape)} vs pools {tuple(k_pool.shape)}"
            f"/{tuple(v_pool.shape)}"
        )
    if block_tbl.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_decode_attention: block_tbl and lengths must be int32")
    if block_tbl.shape[0] != B or tuple(lengths.shape) != (B,):
        raise ValueError("paged_decode_attention: block_tbl/lengths batch != q batch")
    if not (q.is_contiguous() and k_pool.is_contiguous() and v_pool.is_contiguous()
            and lengths.is_contiguous() and block_tbl.stride(1) == 1):
        raise ValueError("paged_decode_attention: q, pools, lengths contiguous; "
                         "block_tbl rows with unit stride")
    if dh not in HEAD_DIMS:
        raise ValueError(f"paged_decode_attention: head dim {dh} not in {HEAD_DIMS}")
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("paged_decode_attention: q and pools must start on a 16-byte boundary")
    lib = _library()
    out = torch.empty_like(q)
    err = lib.paged_decode_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_tbl.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, H, KV, dh, bs, n_blocks, max_blocks,
        block_tbl.stride(0), float(dh**-0.5), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err:
        raise RuntimeError(
            f"paged_decode_attention launch failed: "
            f"{lib.paged_decode_error_string(err).decode()}"
        )
    paged_decode_attention_cuda.launches += 1
    return out


paged_decode_attention_cuda.launches = 0


def paged_decode_attention(q, k_pool, v_pool, block_tbl, lengths) -> torch.Tensor:
    """Paged decode attention on (B,H,dh) queries: the plain version for CPU
    tensors, the kernel for CUDA tensors (no fallback between the two)."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, block_tbl, lengths)
    if q.device.type == "cuda":
        return paged_decode_attention_cuda(q, k_pool, v_pool, block_tbl, lengths)
    raise NotImplementedError(f"paged_decode_attention: no kernel for device {q.device}")
