"""Multi-tenant serving engine, paged dense path (port of
``repro/serving/engine.py``).

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

Admission prefill pads prompts to power-of-two buckets (floored at the
block size) with the true length masking the tail, and the decode attend is
bounded by the decoding lanes' planned final lengths, bucketed to powers of
two — the reference's padding, so both engines compute the same numbers.

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

The engine is greedy and host-driven: ``step()`` = admit + advance chunked
prefills + grow + one decode step over the committed lanes; ``run()`` loops
until queue and lanes drain.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core import adapter_api
from repro_torch.core.quantize import quantize_base_params
from repro_torch.device import resolve_device
from repro_torch.kernels.qrlora_bgmv import ba_gather_sharded
from repro_torch.models import build_model
from repro_torch.models.lane_state import extract_lane, reset_lane
from repro_torch.models.transformer import torch_dtype
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.lam_store import LamStore, extract_lambda
from repro_torch.serving.paging import BlockAllocator, PoolExhausted, PrefixCache
from repro_torch.serving.scheduler import ContinuousBatchScheduler, Request
from repro_torch.sharding.rules import axis_rules, default_group, rank_divides, shard_factors

_MIN_PREFILL_BUCKET = 8


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
        if cfg.adapter.mode != "qr_lora":
            raise ValueError("multi-λ serving is defined for qr_lora adapters")
        self.layout = config.resolved_layout(cfg.family)
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
        self.lam_store = LamStore.from_params(
            params, n_slots=config.n_slots, group=self._group if config.shard_lam else None)
        self.scheduler = ContinuousBatchScheduler(config.n_lanes)
        self.n_lanes, self.max_len = config.n_lanes, config.max_len
        self.collect_logits = config.collect_logits
        self.dtype = torch_dtype(cfg.dtype)
        self.block_size = bs = config.block_size
        if self.max_len % bs:
            raise ValueError(f"max_len={self.max_len} must be a multiple of block_size={bs}")
        self.max_blocks = self.max_len // bs
        n_blocks = config.n_blocks
        if n_blocks is None:
            n_blocks = 1 + self.n_lanes * self.max_blocks  # dense-equivalent
        self.allocator = BlockAllocator(n_blocks, bs)
        if not 0 <= config.watermark < self.allocator.capacity:
            raise ValueError(f"watermark={config.watermark} must be in "
                             f"[0, capacity={self.allocator.capacity})")
        self.watermark = config.watermark
        self.prefix_cache = PrefixCache(self.allocator) if config.share_prefix else None
        # a tenant LRU pressure drops takes its prefix-cache family with it
        self.lam_store.on_drop = lambda tenant, dg: self._drop_stale_family(dg)
        self.prefill_chunk = config.prefill_chunk
        # paged buckets are floored at block_size: block-aligned shapes
        self._prefill_floor = max(_MIN_PREFILL_BUCKET, bs)
        self._lane_blocks: Dict[int, List[int]] = {}
        # uid → prefix blocks pinned (incref'd) at gate approval, consumed by
        # the admission of the same round
        self._gate_matches: Dict[int, List[int]] = {}
        # uid → in-flight chunked-prefill progress (_begin_chunked_prefill)
        self._prefilling: Dict[int, Dict[str, Any]] = {}
        self._admit_seq = 0
        self.preemptions = 0
        self.cow_forks = 0
        self.chunked_admissions = 0
        self.chunk_dispatches = 0
        self.steps = 0
        self.decoded_tokens = 0
        self.prefill_buckets: set = set()  # padded prompt lengths prefilled
        self.cache = self.model.init_decode_state(
            self.n_lanes, self.max_len, self.dtype, paged=True, block_size=bs,
            n_blocks=n_blocks,
        )
        # LaneState protocol: retirement and preemption reset a lane to this
        # snapshot (offsets zeroed, table row → trash block 0)
        self._axes = self.model.lane_axes()
        lane0 = self.model.init_decode_state(
            1, self.max_len, self.dtype, paged=True, block_size=bs, n_blocks=2
        )
        self._init_snap = extract_lane(lane0, self._axes, 0)

    # -- tenants ------------------------------------------------------------

    def add_tenant(self, tenant: str, lam_tree) -> int:
        """Register or hot-swap a tenant's λ checkpoint; returns its slot.  A
        hot-swap that retires the tenant's old λ digest drops that family's
        prefix-cache entries."""
        old = self.lam_store.digest(tenant) if tenant in self.lam_store else None
        slot = self.lam_store.register(tenant, lam_tree)
        self._drop_stale_family(old)
        return slot

    def _drop_stale_family(self, old_digest: Optional[bytes]) -> None:
        """Prefix-cache entries keyed on a λ digest no resident tenant
        carries can never match again: free them now, not at LRU time."""
        if old_digest is None or self.prefix_cache is None:
            return
        if self.lam_store.digest_refcount(old_digest) == 0:
            self.prefix_cache.drop_family(old_digest)

    def _params_view(self):
        return self.lam_store.install(self.params)

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
        # feasibility only — blocks are acquired lazily, but a request whose
        # worst-case footprint exceeds the pool could never run to completion
        worst = self.allocator.blocks_for(prompt.size + max_new_tokens)
        if worst > self.allocator.capacity:
            raise ValueError(
                f"request needs {worst} blocks but the pool only has "
                f"{self.allocator.capacity} — it could never be admitted"
            )
        # a queued request keeps its tenant's slot resident until it finishes
        self.lam_store.pin(tenant)
        return self.scheduler.submit(tenant, prompt, max_new_tokens)

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
                    return True
                if self.prefix_cache is None or not len(self.prefix_cache):
                    return False
                self.prefix_cache.evict_one()

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
        self._prefilling.pop(victim.uid, None)
        for b in self._lane_blocks.pop(lane):
            self.allocator.decref(b)
        reset_lane(self.cache, self._axes, lane, self._init_snap)
        self.scheduler.preempt(victim)
        self.preemptions += 1

    def _fork_block(self, lane: int, slot: int, src: int, dst: int) -> None:
        """Copy-on-write: copy pool block ``src`` to ``dst`` on every layer
        and repoint the lane's table entry at the private copy."""
        a = self.cache["layers"]["attn"]
        a["k"][:, dst] = a["k"][:, src]
        a["v"][:, dst] = a["v"][:, src]
        a["block_tbl"][:, lane, slot] = dst

    def _grow_lanes(self) -> None:
        """Lazy growth, oldest lane first: a decoding lane whose next write
        crosses into a new block gets one (its table entry repointed), and
        one whose write block is shared forks a private copy first."""
        bs = self.block_size
        tbl = self.cache["layers"]["attn"]["block_tbl"]
        for req in sorted(self.scheduler.active(), key=lambda r: r.admit_seq):
            if req.lane < 0:  # preempted by an older lane's growth this pass
                continue
            if req.uid in self._prefilling:  # not decoding yet: no growth
                continue
            blk_idx = (req.prompt.size + len(req.tokens) - 1) // bs
            blocks = self._lane_blocks[req.lane]
            if blk_idx >= len(blocks):
                bid = self._reclaim_one_block(req)
                if bid is None:  # req itself was the preemption victim
                    continue
                blocks.append(bid)
                tbl[:, req.lane, blk_idx] = bid
            elif self.allocator.is_shared(blocks[blk_idx]):
                # never write into a block another owner reads
                src = blocks[blk_idx]
                if self.allocator.can_alloc(1):
                    dst = self.allocator.fork(src)
                else:
                    dst = self._reclaim_one_block(req)
                    if dst is None:
                        continue
                    self.allocator.decref(src)  # the lane's ref moves to the copy
                blocks[blk_idx] = dst
                self._fork_block(req.lane, blk_idx, src, dst)
                self.cow_forks += 1

    # -- the serving loop ---------------------------------------------------

    def _admit(self, finished: List[Request]) -> None:
        for req in self.scheduler.admit(self._admission_gate()):
            req.slot = self.lam_store.lookup(req.tenant)  # pinned since submit
            # prompt-length bucketing: pad to a power of two; the true length
            # masks the tail
            P = req.prompt.size
            Pb = _bucket_len(P, self.max_len, self._prefill_floor)
            padded = np.zeros((Pb,), np.int32)
            padded[:P] = req.prompt
            self.prefill_buckets.add(Pb)
            C = self.prefill_chunk
            if C is not None and Pb > C and (P > 2 * C or self._gate_matches.get(req.uid)):
                # a long prompt streams through the following steps' chunk
                # budget; a short one (≤ 2 chunks of work) prefills in one
                # pass, unless a cached prefix lets the chunks skip its blocks
                self._begin_chunked_prefill(req, padded)
                continue
            logits = self._admit_paged(req, padded)
            self._emit(req, logits[0].float().cpu().numpy(), finished)

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
        if self.prefix_cache is not None:
            # the partial tail block, still receiving decode writes, is never cached
            self.prefix_cache.insert(self._family(req), req.prompt, blocks)
        return logits

    # -- chunked prefill ----------------------------------------------------

    def _begin_chunked_prefill(self, req: Request, padded: np.ndarray) -> None:
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
            "req": req, "tokens": tokens, "starts": starts, "next": 0,
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
        C = self.prefill_chunk
        budget = C
        for st in sorted(self._prefilling.values(), key=lambda s: s["req"].admit_seq):
            while budget > 0 and st["next"] < len(st["starts"]):
                budget -= C
                req = st["req"]
                start = st["starts"][st["next"]]
                last = st["next"] + 1 == len(st["starts"])
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
                    self._finish_chunked(req, logits[0].float().cpu().numpy(), finished)

    def _finish_chunked(self, req: Request, row: np.ndarray, finished: List[Request]) -> None:
        """Final chunk committed: file the prompt in the prefix cache (its
        blocks only now hold its K/V) and emit the first token."""
        del self._prefilling[req.uid]
        if self.prefix_cache is not None:
            self.prefix_cache.insert(self._family(req), req.prompt,
                                     self._lane_blocks[req.lane])
        self._emit(req, row, finished)

    def _emit(self, req: Request, logits_row: np.ndarray, finished: List[Request]) -> None:
        req.tokens.append(int(logits_row.argmax()))
        if self.collect_logits:
            req.logits.append(logits_row)
        self.decoded_tokens += 1
        if req.done:
            lane = req.lane
            self.scheduler.finish(req)
            self.lam_store.unpin(req.tenant)
            for b in self._lane_blocks.pop(lane):
                self.allocator.decref(b)
            # repoint the lane's table row at the trash block so its freed
            # blocks can be reallocated without the idle lane writing into them
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

    def step(self) -> List[Request]:
        """Admit waiting requests, advance chunked prefills under the token
        budget, grow (or CoW-fork) lanes crossing block boundaries, run one
        shared decode step over the committed lanes; returns the requests
        that finished this step."""
        finished: List[Request] = []
        self._admit(finished)
        if self._prefilling:
            self._run_prefill_chunks(finished)
        self._grow_lanes()
        # lanes mid chunked prefill ride the step as masked rows: their
        # writes hit the trash block, their logits are discarded
        decoding = [r for r in self.scheduler.active() if r.uid not in self._prefilling]
        if not decoding:
            return finished
        tok = np.zeros((self.n_lanes, 1), np.int32)
        for req in decoding:
            tok[req.lane, 0] = req.tokens[-1]
        dev = self.device
        seg = torch.from_numpy(self.scheduler.batch_composition()).to(dev)
        with self._rules_ctx():
            logits, self.cache = self.model.decode_step(
                self._params_view(), self.cache, torch.from_numpy(tok).to(dev),
                seg_ids=seg, attend_blocks=self._attend_blocks(decoding),
            )
        logits_np = logits.float().cpu().numpy()  # host sync: the step ran
        self.steps += 1
        for req in decoding:
            self._emit(req, logits_np[req.lane], finished)
        return finished

    def run(self) -> Dict[int, Request]:
        """Drain the queue; returns uid → finished request."""
        out: Dict[int, Request] = {}
        while self.scheduler.has_work:
            for req in self.step():
                out[req.uid] = req
        return out

    # -- accounting ---------------------------------------------------------

    def kv_cache_bytes(self) -> int:
        """Device bytes held by the decode KV cache (pools, block tables,
        offsets)."""
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
