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
  crosses a block boundary.  When the pool runs dry the youngest lane is
  preempted to the queue front (its blocks freed, its tokens re-derived on
  re-admission), so the oldest lane always finishes.

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

The engine is greedy and host-driven: ``step()`` = admit + grow + one
decode step; ``run()`` loops until queue and lanes drain.
"""
from __future__ import annotations

from typing import Dict, List, Optional

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
from repro_torch.serving.paging import BlockAllocator, PoolExhausted
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
        # paged buckets are floored at block_size: block-aligned shapes
        self._prefill_floor = max(_MIN_PREFILL_BUCKET, bs)
        self._lane_blocks: Dict[int, List[int]] = {}
        self._admit_seq = 0
        self.preemptions = 0
        self.steps = 0
        self.decoded_tokens = 0
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
        """Register or hot-swap a tenant's λ checkpoint; returns its slot."""
        return self.lam_store.register(tenant, lam_tree)

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

    def _admission_gate(self):
        """Pool gate for ``scheduler.admit``: approving a request reserves
        its prompt blocks for this admission round."""
        reserved = [0]

        def gate(req: Request) -> bool:
            need = self.allocator.blocks_for(req.prompt.size)
            if self.allocator.n_free - reserved[0] >= need:
                reserved[0] += need
                return True
            return False

        return gate

    def _reclaim_one_block(self, req: Request) -> Optional[int]:
        """One block for ``req``'s decode growth, preempting the youngest
        lane while the pool is empty (possibly ``req`` itself, then None)."""
        while not self.allocator.can_alloc(1):
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
        and send the request to the queue front."""
        lane = victim.lane
        for b in self._lane_blocks.pop(lane):
            self.allocator.decref(b)
        reset_lane(self.cache, self._axes, lane, self._init_snap)
        self.scheduler.preempt(victim)
        self.preemptions += 1

    def _grow_lanes(self) -> None:
        """Lazy growth, oldest lane first: a lane whose next decode write
        crosses into a new block gets one (its table entry repointed)."""
        bs = self.block_size
        tbl = self.cache["layers"]["attn"]["block_tbl"]
        for req in sorted(self.scheduler.active(), key=lambda r: r.admit_seq):
            if req.lane < 0:  # preempted by an older lane's growth this pass
                continue
            blk_idx = (req.prompt.size + len(req.tokens) - 1) // bs
            blocks = self._lane_blocks[req.lane]
            if blk_idx < len(blocks):
                continue
            bid = self._reclaim_one_block(req)
            if bid is None:  # req itself was the preemption victim
                continue
            blocks.append(bid)
            tbl[:, req.lane, blk_idx] = bid

    # -- the serving loop ---------------------------------------------------

    def _admit(self, finished: List[Request]) -> None:
        for req in self.scheduler.admit(self._admission_gate()):
            view = self._params_view()
            req.slot = self.lam_store.lookup(req.tenant)  # pinned since submit
            # prompt-length bucketing: pad to a power of two; the true length
            # masks the tail
            P = req.prompt.size
            Pb = _bucket_len(P, self.max_len, self._prefill_floor)
            padded = np.zeros((Pb,), np.int32)
            padded[:P] = req.prompt
            logits = self._admit_paged(req, view, padded)
            self._emit(req, logits[0].float().cpu().numpy(), finished)

    def _admit_paged(self, req: Request, view, padded: np.ndarray) -> torch.Tensor:
        """Allocate the prompt's blocks (generation blocks come lazily) and
        prefill block-aligned: the prompt's K/V scatter into them through a
        1-lane view whose write row sends bucket padding to trash block 0,
        then the lane's table row and offsets are committed."""
        P, bs, dev = req.prompt.size, self.block_size, self.device
        blocks = self.allocator.alloc(self.allocator.blocks_for(P))
        self._lane_blocks[req.lane] = blocks
        req.admit_seq = self._admit_seq
        self._admit_seq += 1
        write_ids = np.zeros((-(-len(padded) // bs),), np.int32)
        write_ids[: len(blocks)] = blocks
        table_row = np.zeros((self.max_blocks,), np.int32)
        table_row[: len(blocks)] = blocks
        pview = self.model.paged_prefill_view(self.cache, torch.from_numpy(write_ids).to(dev))
        seg = torch.full((1,), req.slot, dtype=torch.int32, device=dev)
        length = torch.full((1,), P, dtype=torch.int32, device=dev)
        with self._rules_ctx():
            logits, filled = self.model.prefill(
                view, pview, torch.from_numpy(padded).to(dev)[None, :], seg_ids=seg,
                length=length,
            )
        self.model.commit_paged_prefill(
            self.cache, filled, req.lane, torch.from_numpy(table_row).to(dev), P
        )
        return logits

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
        """Admit waiting requests, grow lanes crossing block boundaries, run
        one shared decode step over the active lanes; returns the requests
        that finished this step."""
        finished: List[Request] = []
        self._admit(finished)
        self._grow_lanes()
        decoding = self.scheduler.active()
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
