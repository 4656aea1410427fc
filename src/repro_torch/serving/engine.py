"""Multi-tenant serving engine of the dense, audio and moe decoders (port
of ``repro/serving/engine.py``), paged and oracle-dense layouts.

Every dispatch sends the reference's rows — a prefill's whole padded
bucket, a decode step's every lane (idle ones too), a chunk's rows, a
verify's ``lanes·(k+1)`` — so a moe layer's capacity, and with it which
copies drop, is the JAX engine's.

One decode loop serves many QR-LoRA tenants:

* :class:`~repro_torch.serving.lam_store.LamStore` packs each tenant's λ
  into per-projection slot tables, installed into a parameter view.
* :class:`~repro_torch.serving.scheduler.ContinuousBatchScheduler` keeps a
  FIFO queue over fixed decode lanes; the per-lane slot ids are the
  ``seg_ids`` of the batched multi-λ kernel, so tenants share every step.
* The KV cache is a global block pool plus per-lane block tables
  (``serving/paging.py``).  Admission allocates the prompt's
  ``ceil(P / block_size)`` blocks and prefills block-aligned, scattering the
  prompt's K/V straight into them; decode grows a lane by one block when it
  crosses a block boundary.  When the pool runs dry cache-only prefix blocks
  are evicted first, then the youngest lane is preempted to the queue front
  (its blocks freed, its tokens re-derived on re-admission), so the oldest
  lane always finishes.

The reference's production posture (``EngineConfig.serving()``) adds three
features of the paged layout:

* **Prefix sharing** (``share_prefix``): a :class:`PrefixCache` files every
  prompt's full blocks under its family key (the tenant's λ digest and the
  prefill bucket); a later prompt of the same family adopts the cached
  leading blocks (refcounts, no recompute of their K/V where the prefill is
  chunked), and a lane about to write into a shared block forks a private
  copy first (copy-on-write).
* **The admission watermark** (``watermark``): admission keeps that many
  blocks free as decode-growth headroom.
* **Chunked prefill** (``prefill_chunk``): a long prompt (or one with a
  cached prefix) is admitted dark — blocks allocated, table row still trash
  — and its prefill runs ``prefill_chunk`` tokens a step, each chunk
  attending back through the pool, while the resident lanes keep decoding.

The oracle-dense layout (``EngineConfig.oracle_dense()``, or ``auto`` with
``quantum``) gives each lane its own ``(max_len, KV, dh)`` K/V region with
per-lane offsets: admission prefills a fresh 1-lane cache and splices it
into the lane (LaneState ``restore_lane``); there is no pool, no prefix cache
and no chunking.  ``quantum=N`` adds time-slice fairness there: a lane that
has decoded N tokens while requests queue is snapshot-preempted — its lane
state staged to host memory — to the back of the queue, and re-admission
restores the snapshot with no prefill and no emit, so the sliced serve is
bitwise the unsliced one.

Admission prefill pads prompts to power-of-two buckets (floored at the
block size when paged) with the true length masking the tail, and the decode attend is
bounded by the decoding lanes' planned final lengths, bucketed to powers of
two — the reference's padding, so both engines compute the same numbers.

The λ-store's host cold tier (``EngineConfig.cold_slots``, optionally
backed by an mmap file at ``cold_path``) holds tenants beyond the hot
slots: hot pressure spills the least-recently-used unpinned tenant's λ to
the host, and admission promotes a cold tenant back into a hot slot on
demand (:meth:`MultiTenantEngine._make_gate`), deferring, with telemetry's
``cause="cold_promote"``, while every hot slot is pinned by an active lane.
Pinning is two-level there: a queued request only protects its tenant's
residency; the gate takes the hot-slot pin that its lane holds until
retirement, preemption or cancel.  Promotions and spills are slot writes
that make the host wait for nothing (``serving/lam_store.py``).

A quantized frozen base (``EngineConfig.base_dtype`` "int8"/"fp8", or the
model config's) replaces every adapted projection's W with its int8/fp8
``{"q", "scale"}`` dict at construction; the engine's projections then go
through the quantized BGMV kernel.

Sharding (``EngineConfig.shard_lam`` / ``shard_ba``) runs one engine on
every rank of the default ``torch.distributed`` process group — scheduler,
paging and model replicated and deterministic, so every rank issues the same
collectives in the same order.  ``shard_lam`` keeps n_slots / world slots of
every λ table on each rank (``lam_slots``); ``shard_ba`` keeps r / world of
each QR factor's rank dim (``qr_rank``).  The forward runs under those
rules (:mod:`repro_torch.sharding.rules`), where the adapted projections
all-gather the factors and all-reduce the batch's λ rows before the rows
kernel — bitwise the replicated engine.  The group's backend must suit the
device: NCCL for ``cuda``, gloo for ``cpu``.

The request API (``repro/serving/engine.py``'s): ``stream()`` yields each
token once as a :class:`TokenEvent` (a token re-derived after a preemption
is not delivered twice); ``step()`` is ``step_finish(step_begin())``, where
``step_begin`` admits, advances chunked prefills, grows lanes and launches
the decode step without waiting for it (its inputs go up through pinned
host buffers) and ``step_finish`` waits for the logits and emits, so a
caller running several engines can launch every engine's step before it
waits for any; ``cancel`` withdraws a queued or active request; ``add_tenants``
registers a cohort in one write; ``export_prefix``/``import_prefix`` ship
prefix-cache blocks and ``export_request_state``/``inject_prefilled`` a
committed prefill between engines as host numpy payloads in the pool
layout ``(n_layers, n, block_size, KV, dh)`` (float32 for a float32 pool,
so a payload crosses between this engine and the reference's unchanged;
bfloat16 pools ship widened to float32, exactly).

Telemetry (``EngineConfig.telemetry``, on by default as in the reference)
records the reference's serving metrics and request spans through
:mod:`repro_torch.obs` at the reference's sites: host bookkeeping only, no
device work and no sync.  Its ``dispatch`` phase is the host time spent
launching the decode step and ``sync`` the time then spent waiting for
the card; neither is device time.

Speculative decoding (``EngineConfig.speculate_k=K``) replaces the decode
step: each step drafts K greedy tokens per lane with the drafter view (the
base model — slot 0, no adapter term — or, with ``draft_lam_rank=r``, each
slot's λ cut to its top-r |λ|), scores every lane's (K+1)-token window in
one batched forward under the full multi-λ view, accepts each lane's
longest prefix that matches greedy and commits it: the emitted tokens are
the plain engine's, up to K+1 a step.  The reference drafts through a
throwaway copy of its functional cache; this engine's caches are written
in place, so the draft decodes through a view of the same pools and tables
with private copies of the offsets, and each lane's draft writes are capped
at the window the verify rewrites (past it they go to trash block 0, or are
dropped on the dense layout): a draft never writes a shared block, another
lane's rows or the engine's offsets, and no pool is copied.  The window cap
(:meth:`MultiTenantEngine._spec_window_cap`) is host bookkeeping, computed
before the draft.  The commit advances the offsets in place by each lane's
accepted length; rejected rows stay masked (``kpos <= idx``) until a later
step overwrites them, and paged blocks grown past the accepted frontier go
back to the pool.

The engine is greedy and host-driven: ``step()`` = admit + advance chunked
prefills + grow + one decode step (or a draft-and-verify pair) over the
committed lanes; ``run()`` loops until queue and lanes drain.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core import adapter_api
from repro_torch.core.quantize import quantize_base_params
from repro_torch.device import resolve_device
from repro_torch.kernels.qrlora_bgmv import ba_gather_sharded
from repro_torch.models import build_model
from repro_torch.models.lane_state import extract_lane, reset_lane, restore_lane
from repro_torch.models.transformer import torch_dtype
from repro_torch.obs import Telemetry
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.lam_store import LamStore, extract_lambda
from repro_torch.serving.paging import BlockAllocator, PoolExhausted, PrefixCache
from repro_torch.serving.scheduler import ContinuousBatchScheduler, Request
from repro_torch.sharding.rules import axis_rules, default_group, rank_divides, shard_factors

_MIN_PREFILL_BUCKET = 8


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One decoded token, surfaced as it happens (``MultiTenantEngine.stream``)."""

    uid: int
    tenant: str
    lane: int
    token: int
    index: int  # position of this token in the request's generation
    done: bool  # True on the request's final token (retirement)


def _bucket_len(n: int, max_len: int, floor: int = _MIN_PREFILL_BUCKET) -> int:
    """Smallest power-of-two ≥ n (floor ``floor``), clamped to max_len — the
    padded prompt length admission prefill runs at.  The paged engine raises
    the floor to ``block_size`` so every bucket is block-aligned."""
    b = floor
    while b < n:
        b *= 2
    return min(b, max_len)


class MultiTenantEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        config: Optional[EngineConfig] = None,
        *,
        params=None,
        device=None,
    ):
        config = config or EngineConfig()
        if cfg.is_encoder or cfg.family == "vlm":
            raise NotImplementedError(
                f"continuous batching needs a token decode path (family "
                f"{cfg.family!r}: vlm lanes would need per-lane image "
                "embeds, encoders don't decode)"
            )
        if cfg.adapter.mode != "qr_lora":
            raise ValueError("multi-λ serving is defined for qr_lora adapters")
        # speculation rewinds rejected drafts, which only KV state allows
        config.validate_speculation(cfg.family)
        self.layout = config.resolved_layout(cfg.family)
        self.paged = paged = self.layout == "paged"
        self.cfg = cfg
        self.config = config
        self.device = resolve_device(device)
        self.model = build_model(cfg, self.device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(config.seed)
            params = self.model.init(gen)
        # Quantized frozen base: the engine knob wins over the model config
        # (serving decides the deployment dtype); "bf16" is a no-op, and so
        # is passing a tree that is already quantized.
        self.base_dtype = config.base_dtype if config.base_dtype != "bf16" else cfg.base_dtype
        params = quantize_base_params(params, self.base_dtype)
        # sharding: the default process group carries the opted-in logical
        # axes; B/A are cut to this rank's share of their rank dim here
        self._group, self._rules = None, {}
        if config.shard_lam or config.shard_ba:
            self._group = default_group()
            backend = dist.get_backend(self._group)
            want = "nccl" if self.device.type == "cuda" else "gloo"
            if backend != want:
                raise ValueError(f"shard_lam/shard_ba on {self.device.type} need a {want!r} "
                                 f"process group, not {backend!r}")
            world, rank = dist.get_world_size(self._group), dist.get_rank(self._group)
            if config.shard_lam:
                self._rules["lam_slots"] = "model"
            if config.shard_ba and rank_divides(params, world):
                self._rules["qr_rank"] = "model"
                params = shard_factors(params, rank, world)
        self.params = params
        # telemetry rides on the engine from construction: its handles are
        # no-op stubs when disabled, so every site below runs unconditionally
        self.telemetry = Telemetry(enabled=config.telemetry)
        tel = self.telemetry
        # deferrals are counted once per episode (uid), not per step, for a
        # full pool and for a cold tenant alike
        self._deferred_pool_uids: set = set()
        self._deferred_uids: set = set()
        self._defer_cold = tel.defers.labels(cause="cold_promote")
        # the λ-store's host cold tier: evicted tenants spill to host rows and
        # admission promotes them back on demand (``_make_gate``)
        self._cold_tier = config.cold_slots > 0
        self.lam_store = LamStore.from_params(
            params, n_slots=config.n_slots, cold_slots=config.cold_slots,
            cold_path=config.cold_path, group=self._group if config.shard_lam else None)
        self.lam_store.attach_metrics(tel.registry)
        self.scheduler = ContinuousBatchScheduler(config.n_lanes)
        self.n_lanes, self.max_len = config.n_lanes, config.max_len
        self.collect_logits = config.collect_logits
        self.dtype = torch_dtype(cfg.dtype)
        self.block_size = bs = config.block_size
        self.quantum = config.quantum
        self.slice_preemptions = 0  # quantum snapshot-preemptions
        self.speculate_k = config.speculate_k
        self.draft_lam_rank = config.draft_lam_rank
        self.spec_steps = 0  # speculative engine steps executed
        self.drafted_tokens = 0  # draft tokens proposed across all lanes
        self.accepted_drafts = 0  # drafted tokens the verify pass accepted
        self._draft_view_cache = None  # (λ-store slot writes, truncated-λ drafter view)
        self.allocator, self.prefix_cache, self.watermark = None, None, 0
        if paged:
            if self.max_len % bs:
                raise ValueError(f"max_len={self.max_len} must be a multiple of "
                                 f"block_size={bs}")
            self.max_blocks = self.max_len // bs
            n_blocks = config.n_blocks
            if n_blocks is None:
                n_blocks = 1 + self.n_lanes * self.max_blocks  # dense-equivalent
            self.allocator = BlockAllocator(n_blocks, bs, metrics=tel.registry)
            if not 0 <= config.watermark < self.allocator.capacity:
                raise ValueError(f"watermark={config.watermark} must be in "
                                 f"[0, capacity={self.allocator.capacity})")
            self.watermark = config.watermark
            self.prefix_cache = (PrefixCache(self.allocator, metrics=tel.registry)
                                 if config.share_prefix else None)
        # a tenant LRU pressure drops takes its prefix-cache family with it
        self.lam_store.on_drop = lambda tenant, dg: self._drop_stale_family(dg)
        self.prefill_chunk = config.prefill_chunk
        # paged buckets are floored at block_size: block-aligned shapes
        self._prefill_floor = max(_MIN_PREFILL_BUCKET, bs) if paged else _MIN_PREFILL_BUCKET
        self._lane_blocks: Dict[int, List[int]] = {}
        # uid → prefix blocks pinned (incref'd) at gate approval, consumed by
        # the admission of the same round
        self._gate_matches: Dict[int, List[int]] = {}
        # uid → in-flight chunked-prefill progress (_begin_chunked_prefill)
        self._prefilling: Dict[int, Dict[str, Any]] = {}
        # uid → shipped-prefill payload awaiting admission (inject_prefilled)
        self._imports: Dict[int, Dict[str, Any]] = {}
        self.events: List[TokenEvent] = []  # tokens delivered by the last step()
        self._admit_seq = 0
        self.preemptions = 0
        self.cow_forks = 0
        self.chunked_admissions = 0
        self.chunk_dispatches = 0
        self.steps = 0
        self.decoded_tokens = 0
        self.prefill_buckets: set = set()  # padded prompt lengths prefilled
        # path → the distinct shapes it was dispatched at: prefill buckets of
        # dense, paged monolithic and (non-final) chunked prefills, decode
        # attend bounds — what the reference compiles a variant of each for
        self._dispatch_shapes: Dict[str, set] = {
            "prefill": set(), "decode": set(), "prefill_paged": set(), "prefill_chunk": set()}
        if self.speculate_k:
            self._dispatch_shapes.update(draft=set(), verify=set())
        # the decode step's inputs reach the card through pinned host buffers
        # and asynchronous copies, so step_begin does not wait for them; one
        # buffer each is enough, as step_finish syncs before the next step
        self._pinned: Dict[str, torch.Tensor] = {}
        if self.device.type == "cuda":
            self._pinned = {
                "tok": torch.zeros((self.n_lanes, 1), dtype=torch.int32, pin_memory=True),
                "seg": torch.zeros((self.n_lanes,), dtype=torch.int32, pin_memory=True),
            }
            if self.speculate_k:  # the window, its caps and the accepted advances
                self._pinned.update(
                    win=torch.zeros((self.n_lanes, self.speculate_k + 1), dtype=torch.int32,
                                    pin_memory=True),
                    nv=torch.zeros((self.n_lanes,), dtype=torch.int32, pin_memory=True),
                    adv=torch.zeros((self.n_lanes,), dtype=torch.int32, pin_memory=True))
        if paged:
            self.cache = self.model.init_decode_state(
                self.n_lanes, self.max_len, self.dtype, paged=True, block_size=bs,
                n_blocks=n_blocks,
            )
            lane0 = self.model.init_decode_state(
                1, self.max_len, self.dtype, paged=True, block_size=bs, n_blocks=2)
        else:
            self.cache = self.model.init_decode_state(
                self.n_lanes, self.max_len, self.dtype, per_lane=True)
            lane0 = self.model.init_decode_state(1, self.max_len, self.dtype, per_lane=True)
        # LaneState protocol: the lane axes drive admission splice (dense),
        # time-slice snapshot and restore, and the reset of retirement and
        # preemption to this snapshot (offsets zeroed, table row → trash
        # block 0)
        self._axes = self.model.lane_axes(paged=paged)
        self._init_snap = extract_lane(lane0, self._axes, 0)

        # engine-level callback metrics, sampled only at snapshot() time
        reg = tel.registry
        reg.callback("serve_queue_depth", lambda: len(self.scheduler.queue),
                     help="requests waiting for a decode lane")
        reg.callback("serve_active_lanes",
                     lambda: sum(r is not None for r in self.scheduler.lanes),
                     help="decode lanes currently occupied")
        reg.callback("serve_lane_capacity", lambda: self.n_lanes,
                     help="fixed decode-lane count")
        reg.callback("serve_steps_total", lambda: self.steps, kind="counter",
                     help="engine decode steps executed")
        reg.callback("serve_decoded_tokens_total",
                     lambda: self.decoded_tokens, kind="counter",
                     help="tokens decoded, incl. preemption re-derivation "
                          "(serve_tokens_total is the delivered subset)")
        reg.callback("serve_prefill_buckets",
                     lambda: len(self.prefill_buckets),
                     help="distinct padded prompt lengths prefilled "
                          "(= prefill compilations under bucketing)")
        for name, shapes in self._dispatch_shapes.items():
            reg.callback(f"serve_jit_compiles_{name}", lambda shapes=shapes: len(shapes),
                         kind="counter",
                         help=f"distinct shapes the {name} step was dispatched at (this "
                              "engine compiles nothing; the reference compiles one "
                              "variant per shape)")

    # -- tenants ------------------------------------------------------------

    def add_tenant(self, tenant: str, lam_tree) -> int:
        """Register or hot-swap a tenant's λ checkpoint; returns its hot
        slot, or ``COLD_SLOT`` when it landed in the host cold tier.  A
        hot-swap that retires the tenant's old λ digest drops that family's
        prefix-cache entries."""
        old = self.lam_store.digest(tenant) if tenant in self.lam_store else None
        slot = self.lam_store.register(tenant, lam_tree)
        self._drop_stale_family(old)
        return slot

    def add_tenants(self, lams: Dict[str, Any]) -> Dict[str, int]:
        """Batch :meth:`add_tenant`: the cohort's new tenants land in one
        write per λ table (``LamStore.register_many``); tenant → hot slot or
        ``COLD_SLOT``."""
        olds = {t: self.lam_store.digest(t) if t in self.lam_store else None for t in lams}
        slots = self.lam_store.register_many(lams)
        for old in olds.values():
            self._drop_stale_family(old)
        return slots

    def remove_tenant(self, tenant: str) -> None:
        """Drop a tenant (no queued or active request may reference it) and
        reclaim its prefix-cache family."""
        old = self.lam_store.digest(tenant)
        self.lam_store.evict(tenant)
        self._drop_stale_family(old)

    def _drop_stale_family(self, old_digest: Optional[bytes]) -> None:
        """Prefix-cache entries keyed on a λ digest no resident tenant
        carries can never match again: free them now, not at LRU time."""
        if old_digest is None or self.prefix_cache is None:
            return
        if self.lam_store.digest_refcount(old_digest) == 0:
            self.prefix_cache.drop_family(old_digest)

    def _params_view(self):
        return self.lam_store.install(self.params)

    def _draft_params_view(self):
        """Drafter parameter view.  Base drafter (``draft_lam_rank=None``):
        the adapters stripped — exactly the λ ≡ 0 slot-0 tenant, with the
        adapter term skipped (no BGMV launch) rather than multiplied by
        zeros.  Truncated-λ drafter (``draft_lam_rank=r``): each slot row
        keeps its top-r |λ| coefficients.  Memoized on the λ-store's slot-write
        count (slot writes invalidate it)."""
        view = self._params_view()
        if self.draft_lam_rank is None:
            return {**view, "groups": {**view["groups"], "adapters": {}}}
        ver = self.lam_store.slot_writes
        if self._draft_view_cache is not None and self._draft_view_cache[0] == ver:
            return self._draft_view_cache[1]
        r = self.draft_lam_rank

        def trunc(leaf):
            lam = leaf["lam"]
            if lam.shape[-1] <= r:
                return leaf
            mag = lam.abs()
            thr = torch.sort(mag, dim=-1).values[..., -r][..., None]
            return {**leaf, "lam": torch.where(mag >= thr, lam, torch.zeros_like(lam))}

        adapters = {mod: {proj: trunc(leaf) for proj, leaf in projs.items()}
                    for mod, projs in view["groups"]["adapters"].items()}
        dview = {**view, "groups": {**view["groups"], "adapters": adapters}}
        self._draft_view_cache = (ver, dview)
        return dview

    def _rules_ctx(self):
        """The sharding rules every forward runs under (none unsharded)."""
        return axis_rules(self._group, self._rules)

    def gathered_params(self):
        """The engine's params with every QR factor whole: under ``shard_ba``
        an all-gather of each (every rank must call it, as for a forward),
        otherwise ``self.params`` itself.  The merged-weight reference and
        anything else that reads B/A outside a forward needs this."""
        if "qr_rank" not in self._rules:
            return self.params

        def whole(leaf):
            B, A = ba_gather_sharded(leaf["B"], leaf["A"], self._group)
            return {**leaf, "B": B, "A": A}

        groups = dict(self.params["groups"])
        groups["adapters"] = {mod: {proj: whole(leaf) for proj, leaf in projs.items()}
                              for mod, projs in groups["adapters"].items()}
        return {**self.params, "groups": groups}

    # -- requests -----------------------------------------------------------

    def submit(self, tenant: str, prompt, max_new_tokens: int) -> Request:
        if tenant not in self.lam_store:
            raise KeyError(f"unknown tenant {tenant!r} — add_tenant() first")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt({prompt.size}) + gen({max_new_tokens}) exceeds max_len={self.max_len}"
            )
        if self.paged:
            # feasibility only — blocks are acquired lazily, but a request whose
            # worst-case footprint exceeds the pool could never run to completion
            worst = self.allocator.blocks_for(prompt.size + max_new_tokens)
            if worst > self.allocator.capacity:
                raise ValueError(
                    f"request needs {worst} blocks but the pool only has "
                    f"{self.allocator.capacity} — it could never be admitted"
                )
        if self._cold_tier:
            # two-level pinning: submission only protects (the tenant stays
            # in the store but may spill to the cold tier while queued); the
            # hot-slot pin is taken at admission, when a lane holds it
            self.lam_store.protect(tenant)
        else:
            # a queued request keeps its tenant's slot resident until it finishes
            self.lam_store.pin(tenant)
        req = self.scheduler.submit(tenant, prompt, max_new_tokens)
        self.telemetry.on_submit(req)
        return req

    def cancel(self, req: Request) -> None:
        """Withdraw a request.  A queued one leaves the queue; an active one
        frees its lane's blocks and the lane resets (tokens already
        delivered stay on the request; a dense lane is left as it is, the
        next admission overwriting all of it)."""
        if req.lane >= 0:
            self._prefilling.pop(req.uid, None)
            self._imports.pop(req.uid, None)
            lane = req.lane
            self.scheduler.finish(req)
            self._release_tenant(req)
            if self.paged:
                for b in self._lane_blocks.pop(lane):
                    self.allocator.decref(b)
                reset_lane(self.cache, self._axes, lane, self._init_snap)
            return
        try:
            self.scheduler.queue.remove(req)
        except ValueError:
            return  # already finished, or never submitted here
        self._imports.pop(req.uid, None)
        if self._cold_tier:
            self.lam_store.unprotect(req.tenant)
        else:
            self.lam_store.unpin(req.tenant)

    def _release_tenant(self, req: Request) -> None:
        """A request leaves its lane for good (retired or cancelled): its
        hot-slot pin goes, and in cold-tier mode its residency protect."""
        self.lam_store.unpin(req.tenant)
        if self._cold_tier:
            self.lam_store.unprotect(req.tenant)

    # -- handoff between engines ----------------------------------------------

    def _host_blocks(self, blocks: List[int]):
        """K/V of pool blocks ``blocks`` as host arrays (n_layers, n,
        block_size, KV, dh), float32 for a bfloat16 pool (exact)."""
        a = self.cache["layers"]["attn"]
        ids = torch.tensor(blocks, dtype=torch.long, device=self.device)

        def host(pool):
            t = pool[:, ids]
            return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

        return host(a["k"]), host(a["v"])

    def export_prefix(self, tenant: str, prompt) -> Optional[Dict[str, Any]]:
        """The resident prefix-cache blocks of ``(tenant, prompt)`` as a
        host payload another engine can :meth:`import_prefix`: full blocks
        only (the partial tail is never cached).  None when nothing is
        cached here."""
        if self.prefix_cache is None or tenant not in self.lam_store:
            return None
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        blocks = self.prefix_cache.match(self._family_key(tenant, prompt.size), prompt)
        if not blocks:
            return None
        k, v = self._host_blocks(blocks)
        return {"block_size": self.block_size, "n_blocks": len(blocks),
                "tokens": prompt[: len(blocks) * self.block_size].copy(), "k": k, "v": v}

    def import_prefix(self, tenant: str, prompt, payload) -> int:
        """Adopt another engine's exported prefix blocks into this pool and
        prefix cache: only the blocks past the local match are written;
        cache entries are evicted LRU-first to make room.  Returns the blocks
        adopted (0: nothing new or no room, and the request then prefills
        here as usual)."""
        if self.prefix_cache is None or payload is None:
            return 0
        if payload["block_size"] != self.block_size:
            raise ValueError("the other engine's block geometry differs")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        fam = self._family_key(tenant, prompt.size)
        local = self.prefix_cache.match(fam, prompt)
        n = payload["n_blocks"]
        take = n - len(local)
        if take <= 0:
            return 0
        while not self.allocator.can_alloc(take) and len(self.prefix_cache):
            self.prefix_cache.evict_one()
        if not self.allocator.can_alloc(take):
            return 0
        new_ids = self.allocator.alloc(take)
        self._write_imported_blocks(new_ids, payload, skip=len(local))
        self.prefix_cache.insert(fam, prompt[: n * self.block_size], local + new_ids)
        for b in new_ids:
            self.allocator.decref(b)  # the cache now holds the only reference
        return take

    def _write_imported_blocks(self, new_ids: List[int], payload, *, skip: int) -> None:
        """Write payload blocks ``skip:`` into the pool blocks ``new_ids``."""
        if not new_ids:
            return
        a = self.cache["layers"]["attn"]
        ids = torch.tensor(new_ids, dtype=torch.long, device=self.device)
        end = skip + len(new_ids)
        for name in ("k", "v"):
            # a copy: torch wants a writable array, and a payload may be read-only
            rows = torch.from_numpy(np.array(payload[name][:, skip:end]))
            a[name][:, ids] = rows.to(self.device, a[name].dtype)

    def export_request_state(self, req: Request) -> Dict[str, Any]:
        """The handoff payload of an active request whose prefill has
        committed (first token emitted): its prompt's K/V blocks, the first
        token's logits row and the prompt — what another engine needs to
        put the request in a lane without recompute
        (:meth:`inject_prefilled`).  The caller then cancels it here."""
        if not self.paged:
            raise ValueError("export_request_state needs a paged layout")
        if req.lane < 0 or not req.tokens or req.uid in self._prefilling:
            raise ValueError("request has no committed prefill to export")
        nb = self.allocator.blocks_for(req.prompt.size)
        blocks = self._lane_blocks[req.lane][:nb]
        k, v = self._host_blocks(blocks)
        return {"block_size": self.block_size, "prompt": req.prompt.copy(),
                "n_blocks": len(blocks), "k": k, "v": v,
                "logits": req.logits[0] if req.logits else None, "token": req.tokens[0]}

    def inject_prefilled(self, tenant: str, prompt, max_new_tokens: int,
                         payload: Dict[str, Any]) -> Request:
        """Submit a request whose prefill already ran on another engine:
        admission writes the shipped blocks into a lane
        (:meth:`_adopt_prefilled`) instead of running the prompt forward."""
        if not self.paged:
            raise ValueError("inject_prefilled needs a paged layout")
        if payload["block_size"] != self.block_size:
            raise ValueError("the prefill engine's block geometry differs")
        req = self.submit(tenant, prompt, max_new_tokens)
        self._imports[req.uid] = payload
        return req

    def _adopt_prefilled(self, req: Request, payload) -> np.ndarray:
        """Admission of a shipped prefill: adopt the prefix blocks the gate
        pinned, write the other shipped blocks into fresh ones, commit the
        lane's table row and offsets and file the full blocks in the prefix
        cache.  No prompt forward runs; returns the first token's logits
        row."""
        P, bs = req.prompt.size, self.block_size
        cached = self._gate_matches.pop(req.uid, [])
        new_ids = self.allocator.alloc(self.allocator.blocks_for(P) - len(cached))
        blocks = cached + new_ids
        self._lane_blocks[req.lane] = blocks
        req.admit_seq = self._admit_seq
        self._admit_seq += 1
        self._write_imported_blocks(new_ids, payload, skip=len(cached))
        self.model.commit_paged_prefill(self.cache, None, req.lane,
                                        self._ids(blocks, self.max_blocks), P)
        if self.prefix_cache is not None:
            self.prefix_cache.insert(self._family(req), req.prompt, blocks)
            self.telemetry.prefix_hits.inc(len(cached))
            self.telemetry.prefix_misses.inc(P // bs - len(cached))
        row = payload["logits"]
        if row is None:
            if self.collect_logits:
                raise ValueError(
                    "this engine collects logits but the prefill payload carries none — "
                    "run the prefill engine with collect_logits=True")
            # token-only handoff: a one-hot row whose argmax is the token
            row = np.zeros((self.cfg.vocab_size,), np.float32)
            row[payload["token"]] = 1.0
        return np.asarray(row, np.float32)

    # -- paged block accounting ---------------------------------------------

    def _family_key(self, tenant: str, prompt_len: int) -> bytes:
        """Prefix-cache family key: the tenant's λ digest plus the prefill
        bucket.  Two prefills share K/V blocks only when they ran the same
        adapter at the same padded shape, which keeps shared-prefix output
        bitwise the unshared engine's."""
        Pb = _bucket_len(prompt_len, self.max_len, self._prefill_floor)
        return self.lam_store.digest(tenant) + Pb.to_bytes(4, "little")

    def _family(self, req: Request) -> bytes:
        return self._family_key(req.tenant, req.prompt.size)

    def _admission_gate(self):
        """Pool gate for ``scheduler.admit``.  Approving a request reserves
        its uncached prompt blocks for this round and keeps ``watermark``
        blocks free; it also pins (increfs) the request's matched prefix
        blocks at once, so a later request's gate evicting cache entries in
        the same round cannot take them.  When the FIFO head starves while
        the prefix cache holds blocks, the cache is evicted LRU-first until
        the head fits or the cache is empty."""
        reserved = [0]

        def gate(req: Request) -> bool:
            while True:
                cached: List[int] = []
                if self.prefix_cache is not None:
                    cached = self.prefix_cache.match(self._family(req), req.prompt)
                need = self.allocator.blocks_for(req.prompt.size) - len(cached)
                if self.allocator.n_free - reserved[0] >= need + self.watermark:
                    for b in cached:
                        self.allocator.incref(b)
                    if self.prefix_cache is not None:
                        self.prefix_cache.hits += len(cached)
                        self.prefix_cache.misses += (
                            req.prompt.size // self.block_size - len(cached))
                    self._gate_matches[req.uid] = cached
                    reserved[0] += need
                    self._deferred_pool_uids.discard(req.uid)
                    return True
                if self.prefix_cache is None or not len(self.prefix_cache):
                    if req.uid not in self._deferred_pool_uids:
                        self._deferred_pool_uids.add(req.uid)
                        self.telemetry.on_defer(req, "pool_full")
                    return False
                self.prefix_cache.evict_one()

        return gate

    def _make_gate(self):
        """Compose the admission gates: promote-on-demand for cold tenants
        (deferring, as a full pool defers, when every hot slot is pinned by
        an active lane) and the paged pool gate.  In cold-tier mode approval
        also takes the hot-slot pin the lane holds until retirement or
        preemption."""
        paged_gate = self._admission_gate() if self.paged else None
        if not self._cold_tier:
            return paged_gate
        store = self.lam_store

        def gate(req: Request) -> bool:
            if not store.is_hot(req.tenant) and store.promote(req.tenant) is None:
                if req.uid not in self._deferred_uids:
                    self._deferred_uids.add(req.uid)
                    self.telemetry.on_defer(req, "cold_promote")
                return False
            self._deferred_uids.discard(req.uid)
            store.pin(req.tenant)
            if paged_gate is not None and not paged_gate(req):
                store.unpin(req.tenant)
                return False
            return True

        return gate

    def _reclaim_one_block(self, req: Request) -> Optional[int]:
        """One block for ``req``'s decode growth: scavenge cache-only prefix
        blocks first, then preempt the youngest lane while the pool is empty
        (possibly ``req`` itself, then None)."""
        while not self.allocator.can_alloc(1):
            if self.prefix_cache is not None and len(self.prefix_cache):
                self.prefix_cache.evict_one()
                continue
            active = self.scheduler.active()
            if not active:  # unreachable: req is active when growing
                raise PoolExhausted("no active lane to preempt")
            victim = max(active, key=lambda r: r.admit_seq)
            self._preempt(victim)
            if victim is req:
                return None
        return self.allocator.alloc(1)[0]

    def _preempt(self, victim: Request) -> None:
        """Block-pressure preemption: free the lane's blocks, reset the lane
        and send the request to the queue front.  A victim mid chunked
        prefill drops its progress (its lane was never committed) and
        restarts on re-admission."""
        lane = victim.lane
        self.telemetry.on_preempt(victim, "block_pressure")
        self._prefilling.pop(victim.uid, None)
        for b in self._lane_blocks.pop(lane):
            self.allocator.decref(b)
        reset_lane(self.cache, self._axes, lane, self._init_snap)
        if self._cold_tier:
            self.lam_store.unpin(victim.tenant)  # re-pinned at re-admission
        self.scheduler.preempt(victim)
        self.preemptions += 1

    def _preempt_quantum(self, req: Request) -> None:
        """Time-slice preemption: snapshot the lane and re-queue the request
        at the back with its tokens and logits; re-admission restores the
        snapshot, with no recompute.  The snapshot (the lane's whole
        ``(max_len, KV, dh)`` K/V region and offsets) is staged to host
        memory, so a deep queue of sliced requests pins no device copies;
        the copy completes before this returns, so the admission that takes
        the lane next cannot overwrite it first."""
        self.telemetry.on_preempt(req, "quantum")
        req.snapshot = extract_lane(self.cache, self._axes, req.lane, host=True)
        if self._cold_tier:
            self.lam_store.unpin(req.tenant)  # re-pinned at re-admission
        self.scheduler.preempt(req, to_back=True, keep_progress=True)
        self.slice_preemptions += 1

    def _fork_block(self, lane: int, slot: int, src: int, dst: int) -> None:
        """Copy-on-write: copy pool block ``src`` to ``dst`` on every layer
        and repoint the lane's table entry at the private copy."""
        a = self.cache["layers"]["attn"]
        a["k"][:, dst] = a["k"][:, src]
        a["v"][:, dst] = a["v"][:, src]
        a["block_tbl"][:, lane, slot] = dst

    def _grow_lanes(self, window: int = 1) -> None:
        """Lazy growth, oldest lane first: every decoding lane gets the blocks
        its next ``window`` writes land in (its table entries repointed),
        and a lane whose write block is shared forks a private copy first.
        A speculative engine grows k+1 positions of headroom at once; only
        the write block is ever forked (acceptance always reaches it, so the
        plain engine forks it too): a shared block deeper in the window
        caps that lane's window at its boundary instead
        (:meth:`_spec_window_cap`), so a rollback never undoes a fork."""
        bs = self.block_size
        tbl = self.cache["layers"]["attn"]["block_tbl"]
        for req in sorted(self.scheduler.active(), key=lambda r: r.admit_seq):
            if req.lane < 0:  # preempted by an older lane's growth this pass
                continue
            if req.uid in self._prefilling:  # not decoding yet: no growth
                continue
            write_pos = req.prompt.size + len(req.tokens) - 1
            span = max(min(window, req.max_new_tokens - len(req.tokens)), 1)
            first_blk = write_pos // bs
            blocks = self._lane_blocks[req.lane]
            for blk_idx in range(first_blk, (write_pos + span - 1) // bs + 1):
                if blk_idx >= len(blocks):
                    bid = self._reclaim_one_block(req)
                    if bid is None:  # req itself was the preemption victim
                        break
                    blocks.append(bid)
                    tbl[:, req.lane, blk_idx] = bid
                elif self.allocator.is_shared(blocks[blk_idx]):
                    if blk_idx != first_blk:
                        break  # a shared block deeper in the window: the window caps here
                    # never write into a block another owner reads
                    src = blocks[blk_idx]
                    if self.allocator.can_alloc(1):
                        dst = self.allocator.fork(src)
                    else:
                        dst = self._reclaim_one_block(req)
                        if dst is None:
                            break
                        self.allocator.decref(src)  # the lane's ref moves to the copy
                    blocks[blk_idx] = dst
                    self._fork_block(req.lane, blk_idx, src, dst)
                    self.cow_forks += 1
                    self.telemetry.on_cow_fork(req, src, dst)

    # -- speculative decoding -------------------------------------------------

    def _spec_window_cap(self, req: Request) -> int:
        """Largest verify window (the free token plus drafts) this lane can
        take this step: bounded by its remaining generation budget and,
        paged, by the blocks it owns — growth stops at the first shared
        block past the write block and may come up short under pool
        pressure.  Host bookkeeping only, so the draft knows its write
        limit before it runs."""
        nv = min(self.speculate_k + 1, req.max_new_tokens - len(req.tokens))
        if not self.paged:
            return max(nv, 1)
        bs = self.block_size
        write_pos = req.prompt.size + len(req.tokens) - 1
        blocks = self._lane_blocks[req.lane]
        limit_blk = len(blocks)
        for i in range(write_pos // bs + 1, len(blocks)):
            if self.allocator.is_shared(blocks[i]):
                limit_blk = i
                break
        return max(1, min(nv, limit_blk * bs - write_pos))

    def _draft_cache(self, nv: torch.Tensor) -> Dict[str, Any]:
        """The cache a draft decodes through: the engine's K/V (pools and
        block tables, or dense regions) with private copies of the offsets,
        so the engine's own advance only in the commit, and each lane's
        writes capped below ``idx + nv`` (``write_limit``), the window the
        verify rewrites."""
        a = self.cache["layers"]["attn"]
        idx = a["idx"].clone()
        return {"pos": self.cache["pos"].clone(),
                "layers": {"attn": {**a, "idx": idx, "write_limit": idx + nv}}}

    def _dispatch_draft(self, tok: np.ndarray, n_valid: np.ndarray, ab: Optional[int]):
        """Upload the step's inputs and launch the k draft decodes with the
        drafter view, each taking the previous one's greedy token, without
        waiting.  Returns the draft tokens (B, k) int32 on the device and the
        uploaded seg ids and window caps, which the verify reuses."""
        seg = self._upload("seg", self.scheduler.batch_composition())
        nv = self._upload("nv", n_valid)
        t = self._upload("tok", tok)
        dview, dcache = self._draft_params_view(), self._draft_cache(nv)
        self._dispatch_shapes["draft"].add(ab)
        drafts = []
        with self._rules_ctx():
            for _ in range(self.speculate_k):
                logits, dcache = self.model.decode_step(dview, dcache, t, seg_ids=seg,
                                                        attend_blocks=ab)
                t = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
                drafts.append(t)
        return torch.cat(drafts, dim=1), seg, nv

    def _dispatch_verify(self, window: np.ndarray, seg: torch.Tensor, nv: torch.Tensor,
                         ab: Optional[int]) -> torch.Tensor:
        """Launch the verify of every lane's window under the full multi-λ
        view, without waiting: returns its logits (B, k+1, V) on the device.
        The engine's offsets stay where they are."""
        self._dispatch_shapes["verify"].add(ab)
        with self._rules_ctx():
            logits, self.cache = self.model.verify_step(
                self._params_view(), self.cache, self._upload("win", window), seg_ids=seg,
                n_valid=nv, attend_blocks=ab)
        return logits

    def _accept(self, decoding: List[Request], window: np.ndarray, greedy: np.ndarray,
                n_valid: np.ndarray) -> np.ndarray:
        """Each lane's accepted advance: its window's longest prefix that
        matches greedy (``window[0]``, the lane's own last token, always)."""
        adv = np.zeros((self.n_lanes,), np.int32)
        for req in decoding:
            lane, nv = req.lane, int(n_valid[req.lane])
            a = 1
            while a < nv and window[lane, a] == greedy[lane, a - 1]:
                a += 1
            adv[lane] = a
        return adv

    def _commit_window(self, decoding: List[Request], adv: np.ndarray) -> None:
        """Advance each lane's offsets in place by its accepted length (no
        offset is read on the host) and, paged, roll back the blocks past
        the accepted frontier.  Window rows past it stay masked (attends
        read ``kpos <= idx``) until a later step overwrites them."""
        advd = self._upload("adv", adv)
        self.cache["pos"] += advd
        self.cache["layers"]["attn"]["idx"] += advd
        if self.paged:
            self._rollback_window_blocks(decoding, adv)

    def _rollback_window_blocks(self, decoding: List[Request], adv: np.ndarray) -> None:
        """Release window blocks past each lane's accepted frontier: the
        pre-grown headroom a short acceptance did not reach.  Those are
        private blocks (growth forks only the write block, and every step
        restores the blocks-cover-the-KV invariant), so a decref and a
        table entry repointed at trash block 0 restore the plain engine's
        refcounts; no fork is undone."""
        bs = self.block_size
        tbl = self.cache["layers"]["attn"]["block_tbl"]
        for req in decoding:
            lane = req.lane
            # before the emit, len(tokens) is the pre-step count: this is the
            # lane's write offset after the commit
            idx_new = req.prompt.size + len(req.tokens) - 1 + int(adv[lane])
            keep = (idx_new - 1) // bs + 1  # the plain engine's coverage after the step
            blocks = self._lane_blocks[lane]
            while len(blocks) > keep:
                tbl[:, lane, len(blocks) - 1] = 0
                self.allocator.decref(blocks.pop())

    def _step_speculative(self, decoding: List[Request], finished: List[Request]) -> None:
        """One speculative step: draft k tokens a lane, verify every lane's
        window, accept each lane's longest greedy-matching prefix, commit
        the offsets and roll back the paged blocks past the accepted
        frontier, then emit.  Greedy decoding is deterministic, so prefix
        equality is exact acceptance: the emitted tokens are the plain
        engine's, up to k+1 a step.  Two host syncs: the draft tokens (the
        verify's input) and the verify logits."""
        tel = self.telemetry
        on = tel.enabled
        k = self.speculate_k
        tok = np.zeros((self.n_lanes, 1), np.int32)
        n_valid = np.zeros((self.n_lanes,), np.int32)
        for req in decoding:
            tok[req.lane, 0] = req.tokens[-1]
            n_valid[req.lane] = self._spec_window_cap(req)
        ab = self._attend_blocks(decoding) if self.paged else None
        t_disp = tel.now() if on else 0.0
        drafts, seg, nv = self._dispatch_draft(tok, n_valid, ab)
        drafts = drafts.cpu().numpy()  # host sync: the drafts are the verify's input
        if on:
            tel.on_spec_phase("draft", t_disp, tel.now())
        window = np.empty((self.n_lanes, k + 1), np.int32)
        window[:, 0] = tok[:, 0]
        window[:, 1:] = drafts
        t_ver = tel.now() if on else 0.0
        logits_np = self._dispatch_verify(window, seg, nv, ab).float().cpu().numpy()  # host sync
        t_sync = tel.now() if on else 0.0
        if on:
            tel.on_spec_phase("verify", t_ver, t_sync)
        # greedy as _emit takes it, so the accepted rows emit the window's own tokens
        adv = self._accept(decoding, window, logits_np.argmax(axis=-1), n_valid)
        self._commit_window(decoding, adv)
        self.steps += 1
        self.spec_steps += 1
        drafted = k * len(decoding)
        accepted = int(adv.sum()) - len(decoding)
        self.drafted_tokens += drafted
        self.accepted_drafts += accepted
        tel.on_speculate(drafted, accepted, drafted - accepted)
        for req in decoding:
            lane, a = req.lane, int(adv[req.lane])
            req.slice_steps += a  # quantum accounting in accepted tokens
            for j in range(a):
                self._emit(req, logits_np[lane, j], finished)
            if on:
                tel.on_decode_lane(req, t_disp, t_sync, req.tokens[-1])
        if on:
            tel.phase("emit", tel.now() - t_sync)

    @property
    def acceptance_rate(self) -> float:
        """Fraction of drafted tokens the verify pass accepted (0.0 before
        any speculative step has run)."""
        if not self.drafted_tokens:
            return 0.0
        return self.accepted_drafts / self.drafted_tokens

    # -- the serving loop ---------------------------------------------------

    def _admit(self, finished: List[Request]) -> None:
        tel = self.telemetry
        for req in self.scheduler.admit(self._make_gate()):
            tel.on_admit(req, restored=req.snapshot is not None)
            # pinned since submit, or by the gate in cold-tier mode; the
            # tables a promotion wrote are the ones the view holds (in place)
            req.slot = self.lam_store.lookup(req.tenant)
            req.slice_steps = 0
            if req.snapshot is not None:
                # time-sliced re-admission: the snapshot goes back into the
                # (possibly different) lane; no prefill, no emit — decode
                # resumes from the last generated token
                restore_lane(self.cache, self._axes, req.lane, req.snapshot)
                req.snapshot = None
                continue
            # prompt-length bucketing: pad to a power of two; the true length
            # masks the tail
            P = req.prompt.size
            Pb = _bucket_len(P, self.max_len, self._prefill_floor)
            padded = np.zeros((Pb,), np.int32)
            padded[:P] = req.prompt
            t0 = tel.now() if tel.enabled else 0.0
            if not self.paged:
                self.prefill_buckets.add(Pb)
                self._emit_prefill(req, self._admit_dense(req, padded), t0, finished)
                continue
            payload = self._imports.pop(req.uid, None)
            if payload is not None:
                # a shipped prefill: write its blocks in, no prompt forward
                row = self._adopt_prefilled(req, payload)
                if tel.enabled:
                    tel.on_prefill(req, t0, tel.now())
                self._emit(req, row, finished)
                continue
            self.prefill_buckets.add(Pb)
            C = self.prefill_chunk
            if C is not None and Pb > C and (P > 2 * C or self._gate_matches.get(req.uid)):
                # a long prompt streams through the following steps' chunk
                # budget; a short one (≤ 2 chunks of work) prefills in one
                # pass, unless a cached prefix lets the chunks skip its blocks
                self._begin_chunked_prefill(req, padded, t0)
                continue
            self._emit_prefill(req, self._admit_paged(req, padded), t0, finished)

    def _emit_prefill(self, req: Request, logits: torch.Tensor, t0: float,
                      finished: List[Request]) -> None:
        """Emit a monolithic prefill's first token, timed once the logits
        are on the host: the wait is part of the prefill the lane paid for."""
        row = logits[0].float().cpu().numpy()
        if self.telemetry.enabled:
            self.telemetry.on_prefill(req, t0, self.telemetry.now())
        self._emit(req, row, finished)

    def _admit_dense(self, req: Request, padded: np.ndarray) -> torch.Tensor:
        """Dense admission: prefill a fresh 1-lane per-lane cache (the whole
        bucket written from position 0, the offsets set to the true length)
        and splice it into the request's lane."""
        dev = self.device
        lane_cache = self.model.init_decode_state(1, self.max_len, self.dtype, per_lane=True)
        with self._rules_ctx():
            logits, lane_cache = self.model.prefill(
                self._params_view(), lane_cache, torch.from_numpy(padded).to(dev)[None, :],
                seg_ids=torch.full((1,), req.slot, dtype=torch.int32, device=dev),
                length=torch.full((1,), req.prompt.size, dtype=torch.int32, device=dev),
            )
        restore_lane(self.cache, self._axes, req.lane, lane_cache)
        self._dispatch_shapes["prefill"].add(len(padded))
        return logits

    def _adopt_blocks(self, req: Request) -> int:
        """The prompt's blocks: the prefix blocks its gate pinned (extended
        by a re-match when an earlier admission of this round filed more of
        the same prefix) followed by fresh ones for the rest.  Records them
        as the lane's and stamps the admission order; returns the number of
        cached blocks at the front."""
        P, bs = req.prompt.size, self.block_size
        cached = self._gate_matches.pop(req.uid, [])
        if self.prefix_cache is not None and len(cached) < P // bs:
            # only extend the gate's base (it never allocates more than the
            # gate reserved), and only when the fresh chain agrees with it
            fresh = self.prefix_cache.match(self._family(req), req.prompt)
            if len(fresh) > len(cached) and fresh[: len(cached)] == cached:
                for b in fresh[len(cached):]:
                    self.allocator.incref(b)
                self.prefix_cache.hits += len(fresh) - len(cached)
                self.prefix_cache.misses -= len(fresh) - len(cached)
                cached = fresh
        new_ids = self.allocator.alloc(self.allocator.blocks_for(P) - len(cached))
        self._lane_blocks[req.lane] = cached + new_ids
        req.admit_seq = self._admit_seq
        self._admit_seq += 1
        return len(cached)

    def _ids(self, blocks: List[int], width: int, skip: int = 0) -> torch.Tensor:
        """A block-id row of ``width`` entries on the device: ``blocks`` from
        entry ``skip`` on, trash block 0 elsewhere."""
        row = np.zeros((width,), np.int32)
        row[skip: len(blocks)] = blocks[skip:]
        return torch.from_numpy(row).to(self.device)

    def _admit_paged(self, req: Request, padded: np.ndarray) -> torch.Tensor:
        """Adopt the shared prefix blocks, allocate private blocks for the
        rest of the prompt (generation blocks come lazily) and prefill
        block-aligned: the prompt's K/V scatter into its blocks through a
        1-lane view whose write row sends cached blocks and bucket padding
        to trash block 0, then the lane's table row and offsets are
        committed and the prompt's full blocks filed for reuse."""
        P, bs, dev = req.prompt.size, self.block_size, self.device
        n_cached = self._adopt_blocks(req)
        blocks = self._lane_blocks[req.lane]
        pview = self.model.paged_prefill_view(
            self.cache, self._ids(blocks, -(-len(padded) // bs), skip=n_cached))
        with self._rules_ctx():
            logits, filled = self.model.prefill(
                self._params_view(), pview, torch.from_numpy(padded).to(dev)[None, :],
                seg_ids=torch.full((1,), req.slot, dtype=torch.int32, device=dev),
                length=torch.full((1,), P, dtype=torch.int32, device=dev),
            )
        self.model.commit_paged_prefill(
            self.cache, filled, req.lane, self._ids(blocks, self.max_blocks), P)
        self._dispatch_shapes["prefill_paged"].add(len(padded))
        if self.prefix_cache is not None:
            # the partial tail block, still receiving decode writes, is never cached
            self.prefix_cache.insert(self._family(req), req.prompt, blocks)
            self.telemetry.prefix_hits.inc(n_cached)
            self.telemetry.prefix_misses.inc(P // bs - n_cached)
        return logits

    # -- chunked prefill ----------------------------------------------------

    def _begin_chunked_prefill(self, req: Request, padded: np.ndarray, t0: float) -> None:
        """Chunked admission: adopt and allocate the prompt's blocks as
        :meth:`_admit_paged` does, but run no prefill yet.  The lane stays
        dark (table row trash, offsets zero) until the final chunk commits,
        so decode steps between chunks neither read nor clobber the
        half-filled prompt; the lane's own interim decode writes land in the
        trash block and its outputs are discarded."""
        P, bs, C = req.prompt.size, self.block_size, self.prefill_chunk
        n_cached = self._adopt_blocks(req)
        self.chunked_admissions += 1
        blocks = self._lane_blocks[req.lane]
        Pb = len(padded)
        # chunk starts may overhang the bucket (the cached-prefix skip is
        # block-aligned, not chunk-aligned): pad the tokens and the write row
        # by one chunk so overhang positions write trash like any padding
        tokens = np.zeros((Pb + C,), np.int32)
        tokens[:P] = req.prompt
        skip = n_cached * bs
        # a fully cached prompt: one pass over its last C positions just to
        # surface the logits row
        starts = [max(P - C, 0)] if skip >= P else list(range(skip, P, C))
        req.prefill_pos = starts[0]
        dev = self.device
        self._prefilling[req.uid] = {
            "req": req, "tokens": tokens, "starts": starts, "next": 0, "t0": t0,
            "cached": n_cached,
            "seg": torch.full((1,), req.slot, dtype=torch.int32, device=dev),
            "length": torch.full((1,), P, dtype=torch.int32, device=dev),
            "write_ids": self._ids(blocks, -(-(Pb + C) // bs), skip=n_cached),
            # chunks attend through the lane's blocks, cached ones included,
            # at the monolithic bucket's width
            "read_ids": self._ids(blocks, -(-Pb // bs)),
            "table_row": self._ids(blocks, self.max_blocks),
        }

    def _run_prefill_chunks(self, finished: List[Request]) -> None:
        """Advance in-flight chunked prefills, FIFO by admission, spending at
        most ``prefill_chunk`` prompt tokens a step (and always at least one
        chunk, so prefill cannot starve)."""
        tel = self.telemetry
        C = self.prefill_chunk
        budget = C
        for st in sorted(self._prefilling.values(), key=lambda s: s["req"].admit_seq):
            while budget > 0 and st["next"] < len(st["starts"]):
                budget -= C
                req = st["req"]
                start = st["starts"][st["next"]]
                last = st["next"] + 1 == len(st["starts"])
                t0 = tel.now() if tel.enabled else 0.0
                toks = torch.from_numpy(st["tokens"][start: start + C]).to(self.device)[None, :]
                pview = self.model.paged_prefill_view(self.cache, st["write_ids"],
                                                      st["read_ids"])
                with self._rules_ctx():
                    logits, filled = self.model.prefill(
                        self._params_view(), pview, toks, seg_ids=st["seg"],
                        length=st["length"], start=start)
                st["next"] += 1
                req.prefill_chunks += 1
                self.chunk_dispatches += 1
                req.prefill_pos = -1 if last else st["starts"][st["next"]]
                if last:
                    self.model.commit_paged_prefill(self.cache, filled, req.lane,
                                                    st["table_row"], req.prompt.size)
                    row = logits[0].float().cpu().numpy()  # host sync: the chunks ran
                else:
                    self._dispatch_shapes["prefill_chunk"].add(st["read_ids"].numel()
                                                               * self.block_size)
                if tel.enabled:
                    # a non-final chunk's span is its launch time only: a sync
                    # per chunk would serialize the very overlap chunking is
                    # for; the final chunk's sync fences them all
                    tel.on_prefill_chunk(req, t0, tel.now(), start, C)
                if last:
                    self._finish_chunked(st, req, row, finished)

    def _finish_chunked(self, st, req: Request, row: np.ndarray, finished: List[Request]) -> None:
        """Final chunk committed: file the prompt in the prefix cache (its
        blocks only now hold its K/V) and emit the first token."""
        del self._prefilling[req.uid]
        tel = self.telemetry
        if self.prefix_cache is not None:
            self.prefix_cache.insert(self._family(req), req.prompt,
                                     self._lane_blocks[req.lane])
            tel.prefix_hits.inc(st["cached"])
            tel.prefix_misses.inc(req.prompt.size // self.block_size - st["cached"])
        if tel.enabled:
            tel.on_prefill(req, st["t0"], tel.now())
        self._emit(req, row, finished)

    def _emit(self, req: Request, logits_row: np.ndarray, finished: List[Request]) -> None:
        tok = int(logits_row.argmax())
        req.tokens.append(tok)
        if self.collect_logits:
            req.logits.append(logits_row)
        self.decoded_tokens += 1
        # delivery is exactly once: a preempted request re-derives its
        # cleared tokens bit for bit, and indexes already delivered are not
        # delivered again
        if len(req.tokens) > req.delivered:
            req.delivered = len(req.tokens)
            self.telemetry.on_token(req)
            self.events.append(TokenEvent(uid=req.uid, tenant=req.tenant, lane=req.lane,
                                          token=tok, index=len(req.tokens) - 1,
                                          done=req.done))
        if req.done:
            self.telemetry.on_retire(req)
            lane = req.lane
            self.scheduler.finish(req)
            self._release_tenant(req)
            if self.paged:
                for b in self._lane_blocks.pop(lane):
                    self.allocator.decref(b)
                # repoint the lane's table row at the trash block so its freed
                # blocks can be reallocated without the idle lane writing into
                # them; dense lanes skip it — admission overwrites every
                # per-lane leaf, so a reset would copy a lane for nothing
                reset_lane(self.cache, self._axes, lane, self._init_snap)
            finished.append(req)

    def _attend_blocks(self, decoding: List[Request]) -> int:
        """Attend bound: the decoding lanes' block high-water mark from each
        lane's *planned* final length (prompt + generation budget), bucketed
        to a power of two — fixed for a request's lifetime, as in the
        reference (masked tail columns contribute nothing)."""
        hw = max(-(-(r.prompt.size + r.max_new_tokens) // self.block_size) for r in decoding)
        ab = 1
        while ab < hw:
            ab *= 2
        return min(ab, self.max_blocks)

    def _upload(self, name: str, arr: np.ndarray) -> torch.Tensor:
        """``arr`` on the engine's device without a host sync: on the card
        through the pinned buffer ``name`` and an asynchronous copy, on the
        CPU the array itself."""
        if not self._pinned:
            return torch.from_numpy(arr)
        buf = self._pinned[name]
        buf.numpy()[...] = arr
        return buf.to(self.device, non_blocking=True)

    def _dispatch_decode(self, decoding: List[Request]) -> torch.Tensor:
        """Launch one decode step over the committed lanes and return its
        logits (B, V) on the device, without waiting for them."""
        tok = np.zeros((self.n_lanes, 1), np.int32)
        for req in decoding:
            tok[req.lane, 0] = req.tokens[-1]
        ab = self._attend_blocks(decoding) if self.paged else None
        self._dispatch_shapes["decode"].add(ab)
        seg = self._upload("seg", self.scheduler.batch_composition())
        with self._rules_ctx():
            logits, self.cache = self.model.decode_step(
                self._params_view(), self.cache, self._upload("tok", tok),
                seg_ids=seg, attend_blocks=ab,
            )
        return logits

    def step_begin(self) -> Dict[str, Any]:
        """First half of :meth:`step`: quantum time-slicing, admission, the
        chunked-prefill advance, lane growth and the decode *launch* —
        everything up to the host sync on the decode logits.  Returns the pending handle for
        :meth:`step_finish`.  A caller running several engines launches
        every engine's step before it waits for any, so their device work
        overlaps.  A speculative step syncs inside (the draft feeds the
        verify), so it completes here and returns a finished handle."""
        finished: List[Request] = []
        self.events = []
        tel = self.telemetry
        t = tel.now() if tel.enabled else 0.0

        def phase(name: str) -> None:
            """Observe the host time since the last phase ended."""
            nonlocal t
            if tel.enabled:
                now = tel.now()
                tel.phase(name, now - t)
                t = now

        sched = self.scheduler
        if self.quantum is not None and sched.queue:
            # preempt only as many over-quantum lanes as waiters the free
            # lanes cannot absorb (counted before the victims re-queue), most
            # overdue first: any more would churn lanes through snapshot and
            # restore that admission could have filled for free
            need = len(sched.queue) - len(sched.free_lanes())
            if need > 0:
                over = [r for r in sched.active() if r.slice_steps >= self.quantum]
                over.sort(key=lambda r: (-r.slice_steps, r.lane))
                for req in over[:need]:
                    self._preempt_quantum(req)
            phase("quantum")
        self._admit(finished)
        phase("admit")
        if self._prefilling:
            self._run_prefill_chunks(finished)
            phase("prefill_chunk")
        if self.paged:
            self._grow_lanes(self.speculate_k + 1)
            phase("grow")
        # lanes mid chunked prefill ride the step as masked rows: their
        # writes hit the trash block, their logits are discarded
        decoding = [r for r in self.scheduler.active() if r.uid not in self._prefilling]
        if not decoding:
            return {"finished": finished, "decoding": None}
        if self.speculate_k:
            # draft feeds verify through the host, so the step completes here
            # and step_finish gets a finished handle
            self._step_speculative(decoding, finished)
            return {"finished": finished, "decoding": None}
        t_disp = t
        logits = self._dispatch_decode(decoding)
        phase("dispatch")
        return {"finished": finished, "decoding": decoding, "logits": logits,
                "t_disp": t_disp, "t": t}

    def step_finish(self, pending: Dict[str, Any]) -> List[Request]:
        """Second half of :meth:`step`: wait for the launched decode's
        logits and emit each decoding lane's token.  Call exactly once per
        :meth:`step_begin`."""
        finished = pending["finished"]
        decoding = pending["decoding"]
        if decoding is None:
            return finished
        tel = self.telemetry
        on = tel.enabled
        logits_np = pending["logits"].float().cpu().numpy()  # host sync: the step ran
        t_sync = 0.0
        if on:
            t_sync = tel.now()
            tel.phase("sync", t_sync - pending["t"])
        self.steps += 1
        for req in decoding:
            req.slice_steps += 1
            self._emit(req, logits_np[req.lane], finished)
            if on:
                tel.on_decode_lane(req, pending["t_disp"], t_sync, req.tokens[-1])
        if on:
            tel.phase("emit", tel.now() - t_sync)
        return finished

    def step(self) -> List[Request]:
        """Time-slice over-quantum lanes (when work queues), admit waiting
        requests, advance chunked prefills under the token
        budget, grow (or CoW-fork) lanes crossing block boundaries, run one
        shared decode step over the committed lanes (a draft-and-verify pair
        with ``speculate_k``: up to k+1 tokens a lane); returns the requests
        that finished this step.  The tokens it delivered are in
        ``self.events``.  Exactly ``step_finish(step_begin())``."""
        return self.step_finish(self.step_begin())

    def run(self) -> Dict[int, Request]:
        """Drain the queue; returns uid → finished request."""
        out: Dict[int, Request] = {}
        while self.scheduler.has_work:
            for req in self.step():
                out[req.uid] = req
        return out

    def stream(self) -> Iterator[TokenEvent]:
        """Drain the queue, yielding every token as it decodes: the
        streaming counterpart of :meth:`run` (same schedule, same tokens;
        ``event.done`` marks a request's final token)."""
        while self.scheduler.has_work:
            self.step()
            yield from self.events

    # -- accounting ---------------------------------------------------------

    def kv_cache_bytes(self) -> int:
        """Device bytes held by the decode KV cache (pools and block tables,
        or the dense regions; offsets)."""
        return sum(t.numel() * t.element_size()
                   for t in (self.cache["pos"], *self.cache["layers"]["attn"].values()))

    def blocks_in_use(self) -> int:
        """Blocks out of the free list (held by lanes or the prefix cache)."""
        return self.allocator.n_in_use

    def release_prefix_cache(self) -> int:
        """Drop every prefix-cache entry; returns the blocks freed (entries
        still held by active lanes free nothing)."""
        if self.prefix_cache is None:
            return 0
        return self.prefix_cache.clear()

    @property
    def deferred_promotions(self) -> int:
        """Admissions deferred on a cold tenant, counted once per deferral
        episode: ``serve_deferrals_total{cause="cold_promote"}`` (reads 0
        when telemetry is disabled; the episode dedup runs regardless)."""
        return int(self._defer_cold.value)

    @property
    def prefill_compilations(self) -> int:
        """Distinct padded prompt lengths prefilled so far: the reference's
        prefill compilations for the same traffic."""
        return len(self.prefill_buckets)

    def metrics(self) -> Dict[str, Any]:
        """JSON-able snapshot of every serving metric (``repro_torch.obs``):
        latency histograms (TTFT, TBT, E2E, queue wait, step phases),
        request, preemption, deferral and prefix-cache counters, and the
        sampled occupancy callbacks.  ``{}`` when telemetry is off."""
        return self.telemetry.snapshot()


# ---------------------------------------------------------------------------
# Per-tenant merged-weight reference (correctness oracle for the engine)
# ---------------------------------------------------------------------------


def merge_tenant_params(params, cfg: ModelConfig, lam_tree):
    """Single-tenant params with λ folded into the weights and adapters
    stripped — the classic one-adapter deployment.  Quantized projections
    are dequantized first (to the factors' dtype), so the reference shares
    the engine's quantization."""
    scale = adapter_api.adapter_scale(cfg.adapter)
    groups = dict(params["groups"])
    for mod, projs in groups.get("adapters", {}).items():
        mod_params = dict(groups[mod])
        for proj, leaf in projs.items():
            lam = torch.as_tensor(lam_tree[mod][proj], device=leaf["B"].device)
            adp = {"B": leaf["B"], "A": leaf["A"], "lam": lam}
            mod_params[proj] = adapter_api.merge_adapter(mod_params[proj], adp, scale)
        groups[mod] = mod_params
    groups["adapters"] = {}
    return {**params, "groups": groups}


def reference_decode(cfg: ModelConfig, params, lam_tree, prompt, n_tokens: int, max_len: int):
    """Greedy decode of one prompt through merged weights and the lock-step
    dense cache (no adapters on the runtime path, no kernels); returns
    (tokens list, logits (n_tokens, V) float32 numpy)."""
    dev = params["embed"].device
    model = build_model(cfg, dev)
    merged = merge_tenant_params(params, cfg, lam_tree)
    cache = model.init_decode_state(1, max_len, torch_dtype(cfg.dtype))
    prompt = torch.as_tensor(np.asarray(prompt, np.int32), device=dev)
    logits, cache = model.prefill(merged, cache, prompt[None, :])
    rows = [logits[0].float().cpu().numpy()]
    toks = [int(rows[0].argmax())]
    for _ in range(n_tokens - 1):
        tok = torch.tensor([[toks[-1]]], dtype=torch.int32, device=dev)
        logits, cache = model.decode_step(merged, cache, tok)
        rows.append(logits[0].float().cpu().numpy())
        toks.append(int(rows[-1].argmax()))
    return toks, np.stack(rows)


def base_lambda(params):
    """The base model's λ tree (all zeros) — tenant-shaped."""
    return {
        mod: {proj: torch.zeros_like(lam) for proj, lam in projs.items()}
        for mod, projs in extract_lambda(params).items()
    }
