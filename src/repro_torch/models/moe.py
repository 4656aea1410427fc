"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``: its
single-device branch, and its ``shard_map`` branch on a runtime mesh).

Token-choice top-k routing with capacity-bounded, sort-based dispatch, step
for step as the reference:

  1. router logits, softmax and top-k in float32 (ties to the lower expert
     index, as ``jax.lax.top_k`` breaks them), the top-k renormalised;
  2. a stable sort of the T·k token copies by expert, each copy's position
     inside its expert's buffer of C rows; copies past C drop;
  3. the gather into dense ``(E, C, d)`` buffers over all E experts (a
     zero row for an empty slot) and batched gate/up/down matmuls whose
     outputs stay float32;
  4. the combine back to token order, weighted by the renormalised gates,
     and the Switch load-balancing aux loss ``E·Σ_e frac_e·mean_p_e``.

C is ``min(max(8, ⌈cf·T·k/E⌉), T·k)`` over the T rows of the call, so a
token's output depends on the batch it rides in once copies drop.  On a
mesh (:func:`_sharded_moe`) the rows of a call are the data shard's, so
the data split changes which copies drop, and each model rank runs its
f-slice of every expert (the partial outputs summed over "model").

The reference's combine is a scatter-add; here each token gathers its k
weighted slots (a zero row for a dropped copy) and sums them in ``j``
order, so the result is the same on every run (no float atomics) and
differs from the reference only in float32 summation order.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import normal, stacked_normal
from repro_torch.sharding import collectives as coll
from repro_torch.sharding import rules as shrules


def init_moe_params(gen: torch.Generator, cfg: ModelConfig, n: int, dtype) -> Dict:
    """``n`` layers of router and experts: the router ``(n, d, E)`` stays
    float32 whatever ``dtype`` (the reference's ``moe.py:42-44``); the
    expert stacks ``(n, E, d, f)`` / ``(n, E, f, d)`` are in ``dtype``,
    drawn layer by layer."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "w_router": normal(gen, (n, d, E), d**-0.5, torch.float32),
        "we_gate": stacked_normal(gen, (n, E, d, f), d**-0.5, dtype),
        "we_up": stacked_normal(gen, (n, E, d, f), d**-0.5, dtype),
        "we_down": stacked_normal(gen, (n, E, f, d), f**-0.5, dtype),
    }


def capacity(cfg: ModelConfig, T: int) -> int:
    """Each expert's buffer rows for a call over ``T`` token rows (the
    reference's formula, ``moe.py:127-128``)."""
    k, E = cfg.experts_per_token, cfg.n_experts
    C = max(8, int(cfg.capacity_factor * T * k / E + 0.999))
    return min(C, T * k)


class Routing(NamedTuple):
    probs: torch.Tensor  # (T, E) float32
    gates: torch.Tensor  # (T, k) float32, renormalised over the top-k
    experts: torch.Tensor  # (T, k) int64, the top-k expert of each token
    counts: torch.Tensor  # (E,) copies routed to each expert, dropped included
    copy_slot: torch.Tensor  # (T·k,) slot e·C + p of copy t·k+j; E·C when dropped
    slot_copy: torch.Tensor  # (E·C,) the copy in each slot; T·k when empty


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest in descending order, equal values
    to the lower index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def route(x: torch.Tensor, wr: torch.Tensor, k: int, C: int) -> Routing:
    """Steps 1-2 of the module docstring for ``x`` (T, d) and the router
    ``wr`` (d, E)."""
    T, E = x.shape[0], wr.shape[-1]
    dev = x.device
    probs = torch.softmax(x.float() @ wr.float(), dim=-1)
    gates, experts = _top_k(probs, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    flat_e = experts.reshape(-1)  # copy t·k+j belongs to token t
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # (not bincount: on the card it reads its max back to the host)
    counts = torch.zeros(E, dtype=flat_e.dtype, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    n = T * k
    pos = torch.arange(n, device=dev) - starts[sorted_e]
    slot_sorted = torch.where(pos < C, sorted_e * C + pos, E * C)
    copy_slot = torch.empty_like(slot_sorted)
    copy_slot[order] = slot_sorted  # order is a permutation: no two writes meet
    # slot e·C + p holds the copy at sorted position starts[e] + p, if any
    p = torch.arange(C, device=dev)
    filled = p[None, :] < counts[:, None]
    src = torch.clamp(starts[:, None] + p[None, :], max=n - 1)
    slot_copy = torch.where(filled, order[src], n).reshape(-1)
    return Routing(probs, gates, experts, counts, copy_slot, slot_copy)


class _BmmF32(torch.autograd.Function):
    """``a @ b`` of two bf16 batches with a float32 output (cuBLAS's own
    float32 accumulator, ``aten::bmm.dtype``); the backward as JAX
    transposes ``preferred_element_type=float32``: the float32 cotangent
    against the other operand in float32, cast to the operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.bmm(g, b.float().mT).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = torch.bmm(a.float().mT, g).to(b.dtype)
        return da, db


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's ``einsum(..., preferred_element_type=float32)``:
    float32 products of ``a`` and ``b`` (same dtype).  The CPU build has no
    ``aten::bmm.dtype``, so there a bf16 pair is upcast first."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return _BmmF32.apply(a, b)
    return torch.bmm(a.float(), b.float())


def combine(y_slots: torch.Tensor, copy_slot: torch.Tensor, T: int, k: int) -> torch.Tensor:
    """Token order from the weighted slot rows ``y_slots`` (E·C, d) float32:
    token t sums the rows of its copies t·k+0 … t·k+k-1 in ``j`` order, a
    dropped copy reading the zero row past the last slot."""
    padded = torch.cat([y_slots, y_slots.new_zeros((1, y_slots.shape[1]))])
    rows = padded[copy_slot].reshape(T, k, -1)
    y = rows[:, 0]
    for j in range(1, k):
        y = y + rows[:, j]
    return y


def _moe_partial(x, wr, wg, wu, wd, *, k: int, capacity: int, enter=None):
    """``x`` (T, d), router ``wr`` (d, E), experts ``wg``/``wu`` (E, d, f)
    and ``wd`` (E, f, d), or one model rank's f-slices of them → ``(y (T, d)
    float32, aux)``: steps 1-4 over these experts (a slice's part of y).
    ``enter`` (the model-split region's entry, identity forward) takes the
    token rows the expert matmuls read and each slot's gate."""
    T, d = x.shape
    E, C = wr.shape[-1], capacity
    r = route(x, wr, k, C)
    n = T * k
    live = r.slot_copy < n
    token_of_slot = torch.where(live, r.slot_copy // k, T)  # T → the zero row
    gate_of_slot = torch.where(live, r.gates.reshape(-1)[torch.clamp(r.slot_copy, max=n - 1)],
                               0.0)
    xe = x
    if enter is not None:
        xe, gate_of_slot = enter(x), enter(gate_of_slot)
    x_pad = torch.cat([xe, xe.new_zeros((1, d))])
    gathered = x_pad[token_of_slot].reshape(E, C, d)
    h = F.silu(_bmm_f32(gathered, wg)) * _bmm_f32(gathered, wu)
    y_part = _bmm_f32(h.to(x.dtype), wd)  # (E, C, d) float32
    y = combine(y_part.reshape(E * C, d) * gate_of_slot[:, None], r.copy_slot, T, k)
    # load-balancing aux loss (Switch): E · Σ_e frac_tokens_e · mean_prob_e
    frac = r.counts.float() / T / k
    aux = E * torch.sum(frac * r.probs.mean(dim=0))
    return y, aux


def _local_moe(x, wr, wg, wu, wd, *, k: int, capacity: int):
    """``x`` (T, d), router ``wr`` (d, E), experts ``wg``/``wu`` (E, d, f)
    and ``wd`` (E, f, d) → ``(y (T, d) in x's dtype, aux)``."""
    y, aux = _moe_partial(x, wr, wg, wu, wd, k=k, capacity=capacity)
    return y.to(x.dtype), aux


def moe_ffn(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) → (y (B, S, d), aux loss scalar).

    With no mesh installed, the reference's single-device branch
    (``moe.py:121-136``) over the B·S rows of the call.  Under a runtime
    mesh, its ``shard_map`` branch (:func:`_sharded_moe`).  Under a mesh
    description (the dry-run's :class:`~repro_torch.launch.mesh.MeshSpec`)
    with the batch mapped, the same branch's work in one program
    (:func:`data_split_moe`); with the batch unmapped (weight-stationary
    decode), the single-device branch, as the reference takes it then."""
    mesh = shrules.get_mesh()
    if hasattr(mesh, "group"):
        return _sharded_moe(p, x, cfg, mesh, shrules._rules())
    if mesh is not None and shrules._rules().get("batch") is not None:
        n = math.prod(mesh.shape[a] for a in shrules.dp_axes())
        return data_split_moe(p, x, cfg, n, shrules.batch_splits(x.shape[0]))
    B, S, d = x.shape
    T = B * S
    y, aux = _local_moe(
        x.reshape(T, d), p["w_router"], p["we_gate"], p["we_up"], p["we_down"],
        k=cfg.experts_per_token, capacity=capacity(cfg, T),
    )
    return y.reshape(B, S, d), aux


def _sharded_moe(p: Dict, x: torch.Tensor, cfg: ModelConfig, mesh, rules):
    """The reference's ``shard_map`` branch (``moe.py:138-197``) on this
    rank: ``x`` holds the rank's rows of the batch when it splits over the
    data axes (:func:`~repro_torch.sharding.rules.data_shard`), else every
    row, and ``p`` its expert blocks (:func:`~repro_torch.sharding.rules.
    mesh_specs`).  The dispatch is local to the rows held, with C over them;
    each model rank runs its f-slice of every expert, the partial outputs
    summed over "model" in float32 before the cast; under ``fsdp`` the
    stacks arrive split on d over the data axes and are all-gathered here;
    the aux is the mean over the data axes, then over "model".  With the
    batch unmapped (``replicate_batch``) every rank runs every row and the
    aux is its own, as the reference's single-device branch on a mesh."""
    B, S, d = x.shape
    k, E, f = cfg.experts_per_token, cfg.n_experts, cfg.d_ff
    dp = tuple(rules.get("dp_axes") or ())
    model_ax = rules.get("model_axis")
    fsdp_axes = tuple(rules.get("fsdp") or ())
    batch_mapped = rules.get("batch") is not None
    batch_shardable = batch_mapped and bool(dp) and shrules.rows_split()
    T = B * S
    C = capacity(cfg, T)
    f_ok = model_ax is not None and f % mesh.shape[model_ax] == 0
    d_ok = bool(fsdp_axes) and all(d % mesh.shape[a] == 0 for a in fsdp_axes)
    d_here = d // math.prod(mesh.shape[a] for a in fsdp_axes) if d_ok else d
    f_here = f // mesh.shape[model_ax] if f_ok else f
    wr, wg, wu, wd = p["w_router"], p["we_gate"], p["we_up"], p["we_down"]
    if (tuple(wg.shape), tuple(wu.shape), tuple(wd.shape)) != (
            (E, d_here, f_here), (E, d_here, f_here), (E, f_here, d_here)):
        raise ValueError(
            f"the expert stacks on this rank are {tuple(wg.shape)}/{tuple(wd.shape)}; the rules "
            f"place ({E}, {d_here}, {f_here})/({E}, {f_here}, {d_here}) here: cut them with "
            f"shrules.local_blocks(tree, shrules.mesh_specs(tree)) under the same rules")
    if d_ok:
        wg = coll.all_gather(wg, fsdp_axes, 1)
        wu = coll.all_gather(wu, fsdp_axes, 1)
        wd = coll.all_gather(wd, fsdp_axes, 2)
    enter = (lambda t: coll.enter(t, model_ax)) if f_ok else None
    y, aux = _moe_partial(x.reshape(T, d), wr, wg, wu, wd, k=k, capacity=C, enter=enter)
    if f_ok:
        y = coll.psum_out(y, model_ax)
    if batch_mapped:
        axes = dp if batch_shardable else ()
        aux = coll.pmean(aux, axes) if axes else aux
        if not batch_shardable and dp:
            aux = coll.pmean(aux, dp)
        if model_ax is not None:
            aux = coll.pmean(aux, model_ax)
    return y.to(x.dtype).reshape(B, S, d), aux


def data_split_moe(p: Dict, x: torch.Tensor, cfg: ModelConfig, n: int, split: bool):
    """The work of the sharded branch over ``n`` data shards in one program
    (every expert whole).  ``split``: x (B, S, d) cut into ``n`` contiguous
    blocks of rows, each dispatched with its own capacity, the outputs
    concatenated; else every shard runs every row (the output is the
    first's).  The aux is the shards' mean.  The dry-run's trace of a
    mesh's moe layers (so it counts each shard's capacity, which the floor
    of 8 inflates at decode), and the data split a check holds against the
    mesh's."""
    B, S, d = x.shape
    k = cfg.experts_per_token
    rows = (x.reshape(n, B // n * S, d) if split
            else x.reshape(1, B * S, d).expand(n, -1, -1))
    ys, auxes = zip(*(_local_moe(r, p["w_router"], p["we_gate"], p["we_up"], p["we_down"], k=k,
                                 capacity=capacity(cfg, r.shape[0])) for r in rows))
    y = torch.cat(ys) if split else ys[0]
    return y.reshape(B, S, d), torch.stack(auxes).mean()
