"""Plain PyTorch versions of the port's kernels (mirroring
``repro/kernels/ref.py``): the ground truth the CUDA kernels are held to on
the card, and the path the kernel wrappers take for CPU tensors."""
from __future__ import annotations

import torch


def qrlora_matmul_ref(x, W, B, A, lam, scale: float = 1.0):
    """One-λ adapter matmul: ``y = x·W + ((x·B) * λ)·A·scale``.

    x (M,K); W (K,N); B (K,r); A (r,N); λ (r,).  Products and sums in fp32,
    result in x's dtype.
    """
    xf = x.float()
    y = xf @ W.float()
    low = ((xf @ B.float()) * lam.float()) @ A.float()
    return (y + low * scale).to(x.dtype)


def qrlora_bgmv_ref(x, W, B, A, lam_table, seg, scale: float = 1.0):
    """Batched multi-λ adapter matmul: ``y_m = x_m·W + ((x_m·B) * Λ[seg_m])·A``.

    x (M,K); W (K,N); B (K,r); A (r,N); Λ (n_slots,r) fp32; seg (M,) int —
    per-row adapter-slot ids (slot 0 is the all-zero base-model tenant).
    Products and sums in fp32, result in x's dtype.
    """
    lam_rows = lam_table[seg.long()].float()  # (M, r)
    xf = x.float()
    y = xf @ W.float()
    low = ((xf @ B.float()) * lam_rows) @ A.float()
    return (y + low * scale).to(x.dtype)


def qrlora_matmul_quant_ref(x, q, w_scale, B, A, lam, scale: float = 1.0):
    """Quantized-base one-λ matmul: ``y = (x·q)·w_scale + ((x·B)·λ)·A·scale``.

    q (K,N) int8/float8_e4m3fn; w_scale (N,) fp32 per output channel.  The
    dequant multiply comes after the contraction and is rounded in fp32
    before the adapter term is added (multiply, then add: the order the
    reference pins with ``optimization_barrier``; eager PyTorch never fuses
    the two into one FMA).  Result in x's dtype.
    """
    xf = x.float()
    y = (xf @ q.float()) * w_scale.float()
    low = ((xf @ B.float()) * lam.float()) @ A.float()
    return (y + low * scale).to(x.dtype)


def qrlora_matmul_split_ref(x, W, w_scale, B, A, lam, scale: float = 1.0, *,
                            lo_half: bool = True, skip_steps=()):
    """The bf16 one-λ kernels' arithmetic in plain PyTorch, for the tests
    and the card's checks (never the main path).

    ``P' = (x·B) · (scale·λ)`` in fp32 is split into ``P_hi = bf16(P')`` and
    ``P_lo = bf16(P' − P_hi)``; then one fp32 K loop of 64-deep steps runs
    over ``[x | P_hi | P_lo]`` against ``[W ; A ; A]``: step g < ⌈K/64⌉ is
    x·W over K-columns ``[64·g, 64·g + 64)``, the next ⌈r/64⌉ are P_hi·A
    over rank columns, the last ⌈r/64⌉ P_lo·A.  For a quantized
    base (W is int8/fp8 q and ``w_scale`` (N,) fp32; None otherwise) the
    full x·q sum is multiplied by w_scale, rounded in fp32, before the
    first P step.  ``lo_half=False`` leaves P_lo out (a single bf16 P');
    ``skip_steps`` leaves those steps out (what a kernel that drops them
    would give).  Result in x's dtype.
    """
    step = 64  # the kernel's K step (TK)
    xf, Wf, Af = x.float(), W.float(), A.float()
    K, r = x.shape[1], B.shape[1]
    nkx, nkr = -(-K // step), -(-r // step)
    p = (xf @ B.float()) * (scale * lam.float())
    hi = p.bfloat16()
    halves = (hi, (p - hi.float()).bfloat16()) if lo_half else (hi,)
    y = torch.zeros((x.shape[0], W.shape[1]), dtype=torch.float32, device=x.device)
    for g in range(nkx):
        if g not in skip_steps:
            y = y + xf[:, g * step:(g + 1) * step] @ Wf[g * step:(g + 1) * step]
    if w_scale is not None:
        y = y * w_scale.float()
    for h, half in enumerate(halves):
        for c in range(nkr):
            if nkx + h * nkr + c not in skip_steps:
                cols = slice(c * step, (c + 1) * step)
                y = y + half[:, cols].float() @ Af[cols]
    return y.to(x.dtype)


def qrlora_bgmv_quant_ref(x, q, w_scale, B, A, lam_table, seg, scale: float = 1.0):
    """Quantized-base batched multi-λ matmul:
    ``y_m = (x_m·q)·w_scale + ((x_m·B) * Λ[seg_m])·A·scale``, with the
    epilogue of :func:`qrlora_matmul_quant_ref`."""
    lam_rows = lam_table[seg.long()].float()  # (M, r)
    xf = x.float()
    y = (xf @ q.float()) * w_scale.float()
    low = ((xf @ B.float()) * lam_rows) @ A.float()
    return (y + low * scale).to(x.dtype)


def qrlora_bgmv_rows_ref(x, W, w_scale, B, A, lam_rows, scale: float = 1.0):
    """Batched adapter matmul over pre-gathered λ rows:
    ``y_m = (x_m·W)·w_scale + ((x_m·B) * lam_rows_m)·A·scale``.

    :func:`qrlora_bgmv_quant_ref` term for term with ``Λ[seg]`` replaced by
    ``lam_rows (M, r)`` fp32 (the sharded serve's all-reduced rows).  W is in
    x's dtype with ``w_scale`` None (then this is :func:`qrlora_bgmv_ref` bit
    for bit; an all-ones ``w_scale`` gives the same bits, ×1.0 being exact),
    or int8/float8_e4m3fn q with its per-output-channel ``w_scale (N,)``.
    Result in x's dtype.
    """
    xf = x.float()
    y = xf @ W.float()
    if w_scale is not None:
        y = y * w_scale.float()
    low = ((xf @ B.float()) * lam_rows.float()) @ A.float()
    return (y + low * scale).to(x.dtype)


def qrlora_bgmv_split_ref(x, W, B, A, lam_rows, scale: float = 1.0, *, w_scale=None,
                          ranks: int = 8, skip_ranks=()):
    """The one-launch BGMV kernel's arithmetic in plain PyTorch, for the
    tests and the card's checks (never the main path); W in x's dtype with
    ``w_scale`` None, or an int8/fp8 q with its per-column ``w_scale`` (N,);
    ``lam_rows`` (M, r) the λ row of each row of x (``Λ[seg]``).

    K is cut into ``ranks`` slices of ⌈K/ranks⌉ rows rounded up to 8 (the
    cluster's CTAs); each slice's x·W and x·B are taken in fp32 (a q widened
    exactly) and the slices summed in rank order; on a q the sum is then
    multiplied by ``w_scale``, rounded in fp32.  λ multiplies the summed
    x·B, giving P; the rank columns are cut into ``ranks`` slices of
    ⌈r/ranks⌉ rounded up to 4, each slice's P·A taken in fp32 and the slices
    summed in rank order.  ``y = Σx·W + (ΣP·A)·scale``, the product rounded
    first, in x's dtype.  ``skip_ranks`` leaves those ranks' partials out
    (what a kernel that drops a cluster rank would give).
    """
    xf, Wf, Bf, Af = x.float(), W.float(), B.float(), A.float()
    K, r = x.shape[1], B.shape[1]
    def share(n, step):  # ⌈n / ranks⌉ rounded up to a multiple of step
        return max(step, -(-n // (ranks * step)) * step)

    ks, js = share(K, 8), share(r, 4)
    xw = torch.zeros((x.shape[0], W.shape[1]), dtype=torch.float32, device=x.device)
    xb = torch.zeros((x.shape[0], r), dtype=torch.float32, device=x.device)
    for c in range(ranks):
        if c not in skip_ranks:
            k = slice(c * ks, (c + 1) * ks)
            xw = xw + xf[:, k] @ Wf[k]
            xb = xb + xf[:, k] @ Bf[k]
    if w_scale is not None:
        xw = xw * w_scale.float()
    p = xb * lam_rows.float()
    pa = torch.zeros_like(xw)
    for c in range(ranks):
        if c not in skip_ranks:
            j = slice(c * js, (c + 1) * js)
            pa = pa + p[:, j] @ Af[j]
    return (xw + pa * scale).to(x.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """Attention over a sequence in the model layout: q (B,Sq,H,dh); k, v
    (B,Sk,KV,dh) → (B,Sq,H,dh).  Query head h reads kv head h // (H/KV);
    scores in fp32 scaled by dh^-0.5; the causal mask is top-left
    (``kpos <= qpos``, also when Sq ≠ Sk); probabilities are cast to v's
    dtype before P·V."""
    B, Sq, H, dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * dh**-0.5
    if causal:
        kpos, qpos = torch.arange(Sk, device=q.device), torch.arange(Sq, device=q.device)
        s = s.masked_fill(~(kpos[None, :] <= qpos[:, None])[None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, length):
    """One query per batch row over a dense cache: q (B,H,dh); caches
    (B,S,KV,dh); ``length`` (an int or a one-element tensor) valid leading
    positions, shared by the batch → (B,H,dh).  A length of 0 gives zeros
    (the kernel's convention; the JAX reference gives NaN there)."""
    B, H, dh = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    rep = H // KV
    k = k_cache.repeat_interleave(rep, dim=2)
    v = v_cache.repeat_interleave(rep, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) * dh**-0.5
    if isinstance(length, torch.Tensor):
        length = length.reshape(())
    valid = torch.arange(S, device=q.device) < length
    s = s.masked_fill(~valid[None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhk,bkhd->bhd", p.float(), v.float())
    o = torch.where(valid.any(), o, torch.zeros_like(o))
    return o.to(q.dtype)


def decode_attention_split_ref(q, k_cache, v_cache, length, chunk: int):
    """The decode kernel's split-and-merge arithmetic in plain PyTorch, for
    the tests: each ``chunk`` of valid positions keeps its fp32 max m, sum
    l and unnormalised accumulator Σ e^{s−m}·v (probabilities unrounded);
    the merge rescales each by e^{m−M} under the global max M and divides
    the summed accumulators by the summed sums.  Arguments and result as
    :func:`decode_attention_ref`; a length of 0 gives zeros."""
    B, H, dh = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    rep = H // KV
    length = min(max(int(length), 0), S)
    if length == 0:
        return torch.zeros_like(q)
    qf = q.float()
    parts = []
    for t0 in range(0, length, chunk):
        k = k_cache[:, t0:min(t0 + chunk, length)].float().repeat_interleave(rep, dim=2)
        v = v_cache[:, t0:min(t0 + chunk, length)].float().repeat_interleave(rep, dim=2)
        s = torch.einsum("bhd,bkhd->bhk", qf, k) * dh**-0.5
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        parts.append((m, p.sum(dim=-1), torch.einsum("bhk,bkhd->bhd", p, v)))
    M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    w = [torch.exp(m - M) for m, _, _ in parts]
    l = sum(wi * li for wi, (_, li, _) in zip(w, parts))
    o = sum(wi[..., None] * acc for wi, (_, _, acc) in zip(w, parts))
    return (o / l[..., None]).to(q.dtype)


def paged_decode_attention_ref(q, k_pool, v_pool, block_tbl, lengths):
    """Paged decode attention via a plain block-table gather.

    q (B,H,dh); pools (n_blocks, bs, KV, dh); block_tbl (B, max_blocks)
    int pool indices; lengths (B,) int valid positions per lane → (B,H,dh).
    Logical position ``t`` of lane ``b`` lives at
    ``pool[block_tbl[b, t // bs], t % bs]``.  A lane of length 0 gives zeros
    (the kernel's convention; the JAX reference gives NaN there).
    """
    B, H, dh = q.shape
    _, bs, KV, _ = k_pool.shape
    width = block_tbl.shape[1] * bs
    tbl = block_tbl.long()
    rep = H // KV
    # grouped: each KV head's rep query heads against it, as the dense
    # cache's attend groups them (no repeated K/V)
    k = k_pool[tbl].reshape(B, width, KV, dh)
    v = v_pool[tbl].reshape(B, width, KV, dh)
    qg = q.reshape(B, KV, rep, dh)
    s = torch.einsum("bgrd,bkgd->bgrk", qg.float(), k.float()) * dh**-0.5
    valid = torch.arange(width, device=q.device)[None, :] < lengths[:, None]
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bgrk,bkgd->bgrd", p.float(), v.float()).reshape(B, H, dh)
    o = torch.where((lengths > 0)[:, None, None], o, torch.zeros_like(o))
    return o.to(q.dtype)


def paged_decode_attention_split_ref(q, k_pool, v_pool, block_tbl, lengths, chunk: int, *,
                                     ranks: int = 8, skip_ranks=()):
    """The paged decode kernel's chunk-and-merge arithmetic in plain
    PyTorch, for the tests and the card's checks (never the main path).

    Arguments as :func:`paged_decode_attention_ref`.  A lane's positions
    (its length clamped to the table's ``max_blocks·bs``) go through its
    table row; a position whose entry lies outside ``[0, n_blocks)`` scores
    −∞.  The table's ⌈max_blocks·bs / chunk⌉ chunks are dealt to ``cs =
    min(chunks, ranks)`` ranks, rank r taking chunks r, r + cs, …; a rank
    folds its chunks below the length in order into an fp32 state (max m,
    sum l, unnormalised Σ e^{s−m}·v, rescaled by e^{m_old − m_new} when a
    chunk raises the max), so with at most ``ranks`` chunks each state is one
    chunk's own.  The ranks' states are merged in rank order under the
    global max M (weights e^{m−M}) and the summed accumulator divided by the
    summed l; a lane with nothing valid gives zeros.  ``skip_ranks`` leaves
    those ranks' states out of the merge (what a kernel that drops a
    split's partial would give).  Result in q's dtype.
    """
    B, H, dh = q.shape
    n_blocks, bs, KV, _ = k_pool.shape
    width = block_tbl.shape[1] * bs
    n_chunks = -(-width // chunk)
    cs = max(1, min(n_chunks, ranks))
    rep = H // KV
    k_rows, v_rows = k_pool.reshape(-1, KV, dh), v_pool.reshape(-1, KV, dh)
    out = torch.zeros((B, H, dh), dtype=torch.float32, device=q.device)
    neg = torch.tensor(float("-inf"), device=q.device)
    for b in range(B):
        L = min(max(int(lengths[b]), 0), width)
        pos = torch.arange(L, device=q.device)
        blk = block_tbl[b, pos // bs].long()
        ok = (blk >= 0) & (blk < n_blocks)
        rows = torch.where(ok, blk, 0) * bs + pos % bs
        k = k_rows[rows].float().repeat_interleave(rep, dim=1)  # (L, H, dh)
        v = v_rows[rows].float().repeat_interleave(rep, dim=1)
        s = torch.einsum("hd,thd->ht", q[b].float(), k) * dh**-0.5
        s = torch.where(ok[None, :], s, neg)
        states = []
        for r in range(cs):
            m = torch.full((H,), float("-inf"), device=q.device)
            l = torch.zeros((H,), device=q.device)
            acc = torch.zeros((H, dh), device=q.device)
            for t0 in range(r * chunk, L, cs * chunk):
                sc, vc = s[:, t0:t0 + chunk], v[t0:t0 + chunk]
                M = torch.maximum(m, sc.amax(dim=-1))
                c = torch.where(m == M, torch.ones_like(m), torch.exp(m - M))
                p = torch.where(sc == neg, torch.zeros_like(sc), torch.exp(sc - M[:, None]))
                l = l * c + p.sum(dim=-1)
                acc = acc * c[:, None] + torch.einsum("ht,thd->hd", p, vc)
                m = M
            if r not in skip_ranks:
                states.append((m, l, acc))
        if not states:
            continue
        M = torch.stack([m for m, _, _ in states]).amax(dim=0)
        Mf = torch.where(M == neg, torch.zeros_like(M), M)
        w = [torch.where(m == neg, torch.zeros_like(m), torch.exp(m - Mf)) for m, _, _ in states]
        l = sum(wi * li for wi, (_, li, _) in zip(w, states))
        o = sum(wi[:, None] * acc for wi, (_, _, acc) in zip(w, states))
        out[b] = torch.where(l[:, None] > 0, o / torch.where(l > 0, l, 1.0)[:, None], 0.0)
    return out.to(q.dtype)
