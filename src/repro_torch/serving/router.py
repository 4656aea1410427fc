"""Adapter-locality router over N engine replicas (port of
``repro/serving/router.py``).

Scaling QR-LoRA serving past one engine is a *placement* problem: replica
state is dominated by the frozen base (shared, see
:func:`~repro_torch.serving.replica.build_replicas`) and by what is *warm* — the
hot λ tier and the prefix cache.  Both are keyed by the tenant's λ digest,
so the router places every request by consistent hash of that digest:

* the same adapter family always lands on the same replica, keeping its λ
  row hot and its prompt-prefix K/V blocks cached there;
* adding/removing a replica remaps only ~1/N of the digest space (standard
  consistent-hashing argument, ``DEFAULT_VNODES`` virtual nodes per replica smooth
  the split);
* placement needs no global state — any front-end computes the same ring.

Three refinements on top of the pure hash:

**Load-aware spillover.**  A hot family must not saturate its home replica
while siblings idle.  When the primary's load (queued + active) exceeds the
least-loaded live replica's by more than ``spill_threshold``, the request
spills to the least-loaded replica instead.  Spilled requests still find
their prefix via cross-replica import (below), so the spill costs one
block-ship, not a full re-prefill.

**Cross-replica prefix sharing.**  Before a request is submitted, the
router asks its target replica how much of the prompt it already holds; if
a live sibling holds more, the sibling's full-block K/V is shipped over the
transport seam and spliced into the target's pool + prefix cache
(``engine.export_prefix`` → ``engine.import_prefix``).  Imports are an
optimization, never a correctness dependency — no room / no match simply
means a local prefill.

**Prefill/decode disaggregation** (``disaggregate=True``).  Long-prompt
admission and steady-state decode fight for the same step budget; a
disaggregated layout gives each its own replicas.  Prefill-role replicas
run (chunked) prefill to the first committed token, then the router exports
the prompt's K/V blocks + first-token logits, cancels the prefill-side
request, ships the payload, and injects it into a decode replica
(``engine.export_request_state`` → ``engine.inject_prefilled``) — the
decode replica splices the blocks into a lane with **zero** prompt
recompute, and its output is bit-identical to a monolithic engine because
the logits row it first emits is the very row the prefill replica computed.

Failure handling: :meth:`Router.kill_replica` removes a replica from the
ring and re-places its unfinished requests on survivors (greedy decode
re-derives the same tokens; prefixes re-import from surviving siblings
where cached).

The router drives replicas with the engine's split step
(``step_begin``/``step_finish``): every replica's decode is launched before
any is waited for, so the replicas' device work overlaps instead of
serializing on host round-trips.  Replicas on one card share its default
stream; each engine's pinned upload buffers are its own, so one replica's
launch never overwrites another's pending inputs.
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracing import Tracer
from repro_torch.serving.lam_store import lam_digest
from repro_torch.serving.replica import (
    EngineReplica, LocalTransport, Transport, payload_nbytes,
)

#: Tracer process id for router-level spans (engines own pids 0/1).
PID_ROUTER = 2

#: Virtual ring nodes per replica: smooths the digest-space split so two
#: replicas get ~half each instead of whatever two raw hash points carve.
DEFAULT_VNODES = 32

#: Prefill-side generation budget under disaggregation.  The exported
#: request must survive its first emitted token (export needs a live lane),
#: and the commit step itself decodes once more before the router sees it —
#: three tokens of headroom keeps the lane alive through export without
#: meaningfully decoding on the prefill replica.
_PREFILL_BUDGET = 3


class RoutedRequest:
    """A request as the router tracks it: stable router-level identity over
    a rebindable engine-level request (rebound on disaggregation handoff
    and on replica-failure re-placement)."""

    __slots__ = (
        "uid", "tenant", "prompt", "max_new_tokens",
        "replica", "engine_req", "phase", "placements", "finished",
    )

    def __init__(self, uid: int, tenant: str, prompt: np.ndarray,
                 max_new_tokens: int):
        self.uid = uid
        self.tenant = tenant
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.replica: Optional[EngineReplica] = None
        self.engine_req = None
        #: "prefill" while parked on a prefill replica awaiting export,
        #: "decode" once bound to the replica that will finish it
        self.phase = "decode"
        self.placements = 0  # bindings over the lifetime (1 = never moved)
        self.finished = False

    @property
    def tokens(self) -> List[int]:
        return self.engine_req.tokens if self.engine_req is not None else []

    @property
    def done(self) -> bool:
        return self.finished

    def __repr__(self) -> str:
        where = self.replica.name if self.replica else "?"
        return (
            f"RoutedRequest(uid={self.uid}, tenant={self.tenant!r}, "
            f"on={where}, phase={self.phase}, tokens={len(self.tokens)})"
        )


class Router:
    """Front-end over a replica set: digest placement, spillover, prefix
    import, disaggregated prefill, failover.  See module docstring."""

    def __init__(
        self,
        replicas: Sequence[EngineReplica],
        *,
        disaggregate: bool = False,
        spill_threshold: Optional[int] = None,
        transport: Optional[Transport] = None,
        telemetry: bool = True,
    ):
        if not replicas:
            raise ValueError("a router needs at least one replica")
        self.replicas = list(replicas)
        self.disaggregate = disaggregate
        if disaggregate:
            if not any(r.role == "prefill" for r in self.replicas):
                # default disaggregated layout: replica 0 prefills, rest decode
                if len(self.replicas) < 2:
                    raise ValueError(
                        "disaggregation needs >= 2 replicas (one to prefill, "
                        "one to decode)"
                    )
                self.replicas[0].role = "prefill"
                for r in self.replicas[1:]:
                    if r.role == "both":
                        r.role = "decode"
            if not any(r.role in ("both", "decode") for r in self.replicas):
                raise ValueError("disaggregation left no decode-capable replica")
        # spillover trips when the primary is one full batch ahead of the
        # least-loaded sibling — below that, locality is worth the queueing
        self.spill_threshold = (
            spill_threshold if spill_threshold is not None
            else self.replicas[0].engine.n_lanes
        )
        self.transport = transport if transport is not None else LocalTransport()
        # -- tenant catalog: the router is the λ source of truth; replicas
        # are registered lazily at placement time (batch API)
        self._lams: Dict[str, Any] = {}
        self._digests: Dict[str, bytes] = {}
        self._next_uid = 0
        self._requests: Dict[int, RoutedRequest] = {}
        # (replica_id, engine uid) → routed, rebound on every (re)placement
        self._by_engine: Dict[Tuple[int, int], RoutedRequest] = {}
        self._awaiting_prefill: List[RoutedRequest] = []
        # -- observability
        self.registry = MetricsRegistry(enabled=telemetry)
        self.tracer = Tracer() if telemetry else None
        if self.tracer is not None:
            self.tracer._process_name(PID_ROUTER, "router")
        reg = self.registry
        self._m_requests = reg.counter(
            "router_requests_total", "requests accepted by the router")
        self._m_place = reg.counter(
            "router_placements_total",
            "request→replica bindings by outcome",
            labels=("outcome",))  # primary | spill | failover | handoff
        self._m_imports = reg.counter(
            "router_prefix_imports_total",
            "cross-replica prefix imports that adopted blocks")
        self._m_xfer = reg.counter(
            "router_transfer_bytes_total",
            "bytes shipped between replicas", labels=("kind",))
        self._m_load = reg.gauge(
            "router_replica_load", "queued + active per replica",
            labels=("replica",))
        self._ring = self._build_ring()

    # -- placement -----------------------------------------------------------

    def _live(self, *roles: str) -> List[EngineReplica]:
        roles = roles or ("both", "decode")
        return [r for r in self.replicas if r.alive and r.role in roles]

    def _build_ring(self) -> List[Tuple[int, EngineReplica]]:
        """Hash ring over the live decode-capable replicas."""
        ring = []
        for rep in self._live():
            for v in range(DEFAULT_VNODES):
                h = hashlib.sha1(f"{rep.name}:{v}".encode()).digest()
                ring.append((int.from_bytes(h[:8], "big"), rep))
        ring.sort(key=lambda p: p[0])
        return ring

    def digest(self, tenant: str) -> bytes:
        return self._digests[tenant]

    def _ring_owner(self, dg: bytes) -> EngineReplica:
        point = int.from_bytes(hashlib.sha1(dg).digest()[:8], "big")
        ring = self._ring
        lo, hi = 0, len(ring)
        while lo < hi:
            mid = (lo + hi) // 2
            if ring[mid][0] < point:
                lo = mid + 1
            else:
                hi = mid
        return ring[lo % len(ring)][1]

    def owner_of(self, dg: bytes) -> EngineReplica:
        """Consistent-hash owner of a λ digest — placement preview without
        a registered tenant (benches pick family seeds with it)."""
        return self._ring_owner(dg)

    def place(self, tenant: str) -> Tuple[EngineReplica, str]:
        """Primary = consistent-hash owner of the tenant's λ digest;
        spill to the least-loaded live replica when the primary is
        ``spill_threshold`` deeper than it."""
        primary = self._ring_owner(self._digests[tenant])
        candidates = self._live()
        least = min(candidates, key=lambda r: (r.load(), r.replica_id))
        if (primary.load() - least.load() > self.spill_threshold
                and least is not primary):
            return least, "spill"
        return primary, "primary"

    def _ensure_resident(self, rep: EngineReplica,
                         tenants: Sequence[str]) -> None:
        """Register missing tenants on ``rep`` (λ shipped from the router's
        catalog) via the store's batch path — one packed-table write per
        call, which is what makes placement-time registration and peer
        promotion affordable during admission spikes."""
        missing = {
            t: self._lams[t] for t in tenants
            if t not in rep.engine.lam_store
        }
        if missing:
            rep.engine.add_tenants(missing)

    # -- tenant catalog ------------------------------------------------------

    def add_tenant(self, tenant: str, lam_tree) -> bytes:
        """File a tenant's λ with the router (no replica touched yet);
        returns the λ digest placement will hash."""
        self._lams[tenant] = lam_tree
        self._digests[tenant] = lam_digest(lam_tree)
        return self._digests[tenant]

    def add_tenants(self, lams: Dict[str, Any]) -> Dict[str, bytes]:
        return {t: self.add_tenant(t, tree) for t, tree in lams.items()}

    # -- cross-replica prefix sharing ---------------------------------------

    def _import_prefix(self, target: EngineReplica, tenant: str,
                       prompt: np.ndarray) -> int:
        """Ship the longest sibling-held prefix into ``target``'s cache
        when it beats the local match; returns blocks adopted."""
        eng = target.engine
        if eng.prefix_cache is None:
            return 0
        local = len(eng.prefix_cache.match(
            eng._family_key(tenant, prompt.size), prompt))
        full = prompt.size // eng.block_size
        if local >= full:
            return 0
        best, src = None, None
        for sib in self.replicas:
            if sib is target or not sib.alive:
                continue
            got = sib.engine.export_prefix(tenant, prompt)
            if got is not None and got["n_blocks"] > (
                    best["n_blocks"] if best else local):
                best, src = got, sib
        if best is None:
            return 0
        t0 = self.tracer.now() if self.tracer else 0.0
        payload = self.transport.ship(best, src, target, "prefix")
        adopted = eng.import_prefix(tenant, prompt, payload)
        if adopted:
            self._m_imports.inc()
            self._m_xfer.labels(kind="prefix").inc(payload_nbytes(payload))
            if self.tracer:
                self.tracer.complete(
                    "ship_prefix", PID_ROUTER, target.replica_id,
                    t0, self.tracer.now() - t0,
                    args={"from": src.name, "to": target.name,
                          "blocks": adopted},
                )
        return adopted

    # -- submission ----------------------------------------------------------

    def submit(self, tenant: str, prompt, max_new_tokens: int) -> RoutedRequest:
        if tenant not in self._lams:
            raise KeyError(f"unknown tenant {tenant!r} — add_tenant() first")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        routed = RoutedRequest(self._next_uid, tenant, prompt, max_new_tokens)
        self._next_uid += 1
        self._requests[routed.uid] = routed
        self._m_requests.inc()
        if self.disaggregate and self._disagg_eligible(prompt, max_new_tokens):
            self._submit_prefill(routed)
        else:
            rep, outcome = self.place(tenant)
            self._bind(routed, rep, outcome)
        return routed

    def _disagg_eligible(self, prompt: np.ndarray, max_new_tokens: int) -> bool:
        """Prefill replicas export paged blocks, so only a paged prefill
        replica takes the prompt, and the export needs a few tokens of
        prefill-side lane headroom."""
        prefills = self._live("prefill")
        if not prefills:
            return False
        eng = prefills[0].engine
        return eng.paged and prompt.size + _PREFILL_BUDGET <= eng.max_len

    def _submit_prefill(self, routed: RoutedRequest) -> None:
        prefills = self._live("prefill")
        rep = min(prefills, key=lambda r: (r.load(), r.replica_id))
        self._ensure_resident(rep, [routed.tenant])
        self._import_prefix(rep, routed.tenant, routed.prompt)
        routed.phase = "prefill"
        routed.replica = rep
        routed.engine_req = rep.engine.submit(
            routed.tenant, routed.prompt, _PREFILL_BUDGET)
        routed.placements += 1
        self._by_engine[(rep.replica_id, routed.engine_req.uid)] = routed
        self._awaiting_prefill.append(routed)
        self._m_place.labels(outcome="primary").inc()

    def _bind(self, routed: RoutedRequest, rep: EngineReplica,
              outcome: str) -> None:
        """Place ``routed`` on ``rep`` as a plain (prefill-local) request."""
        self._ensure_resident(rep, [routed.tenant])
        self._import_prefix(rep, routed.tenant, routed.prompt)
        routed.phase = "decode"
        routed.replica = rep
        routed.engine_req = rep.engine.submit(
            routed.tenant, routed.prompt, routed.max_new_tokens)
        routed.placements += 1
        self._by_engine[(rep.replica_id, routed.engine_req.uid)] = routed
        self._m_place.labels(outcome=outcome).inc()

    # -- disaggregation pump -------------------------------------------------

    def _pump_prefill(self) -> None:
        """Move committed prefills off their prefill replicas: export the
        prompt's blocks + first-token logits, cancel the prefill-side
        request, ship, inject into a decode replica."""
        still: List[RoutedRequest] = []
        for routed in self._awaiting_prefill:
            src = routed.replica
            er = routed.engine_req
            if not src.alive:
                continue  # kill_replica already re-placed it
            if not er.tokens or er.uid in src.engine._prefilling:
                still.append(routed)
                continue
            t0 = self.tracer.now() if self.tracer else 0.0
            payload = src.engine.export_request_state(er)
            src.engine.cancel(er)
            self._by_engine.pop((src.replica_id, er.uid), None)
            dst, _ = self.place(routed.tenant)
            shipped = self.transport.ship(payload, src, dst, "prefill")
            self._m_xfer.labels(kind="prefill").inc(payload_nbytes(shipped))
            self._ensure_resident(dst, [routed.tenant])
            routed.phase = "decode"
            routed.replica = dst
            routed.engine_req = dst.engine.inject_prefilled(
                routed.tenant, routed.prompt, routed.max_new_tokens, shipped)
            routed.placements += 1
            self._by_engine[(dst.replica_id, routed.engine_req.uid)] = routed
            self._m_place.labels(outcome="handoff").inc()
            if self.tracer:
                self.tracer.complete(
                    "ship_prefill", PID_ROUTER, dst.replica_id,
                    t0, self.tracer.now() - t0,
                    args={"from": src.name, "to": dst.name,
                          "blocks": payload["n_blocks"]},
                )
        self._awaiting_prefill = still

    # -- failure handling ----------------------------------------------------

    def kill_replica(self, replica_id: int) -> int:
        """Take a replica out of service and re-place its unfinished
        requests on survivors.  Greedy decode re-derives the same tokens on
        the new replica; cached prefixes re-import from surviving siblings.
        Returns the number of requests re-placed."""
        dead = self.replicas[replica_id]
        if not dead.alive:
            return 0
        dead.alive = False
        self._ring = self._build_ring()
        if not self._ring:
            raise RuntimeError("kill_replica left no decode-capable replica")
        orphans = [
            routed for (rid, _), routed in list(self._by_engine.items())
            if rid == replica_id and not routed.finished
        ]
        for routed in orphans:
            self._by_engine.pop((replica_id, routed.engine_req.uid), None)
        self._awaiting_prefill = [
            r for r in self._awaiting_prefill if r.replica is not dead
        ]
        for routed in orphans:
            rep, _ = self.place(routed.tenant)
            self._bind(routed, rep, "failover")
        return len(orphans)

    # -- stepping ------------------------------------------------------------

    def step(self) -> List[RoutedRequest]:
        """One step across the replica set: dispatch every live replica's
        decode (``step_begin``), then sync + emit (``step_finish``), then
        pump disaggregation handoffs.  Returns routed requests that
        finished this step."""
        pendings = []
        for rep in self.replicas:
            if rep.alive and rep.engine.scheduler.has_work:
                pendings.append((rep, rep.engine.step_begin()))
        done: List[RoutedRequest] = []
        for rep, pending in pendings:
            for er in rep.engine.step_finish(pending):
                routed = self._by_engine.pop((rep.replica_id, er.uid), None)
                if routed is None or routed.phase != "decode":
                    # prefill-side completion (tiny budget ran out before
                    # the pump exported): fall back to a full re-place
                    if routed is not None:
                        self._awaiting_prefill = [
                            r for r in self._awaiting_prefill if r is not routed
                        ]
                        rep2, outcome = self.place(routed.tenant)
                        self._bind(routed, rep2, outcome)
                    continue
                routed.finished = True
                done.append(routed)
        if self.disaggregate and self._awaiting_prefill:
            self._pump_prefill()
        for rep in self.replicas:
            self._m_load.labels(replica=rep.name).set(
                rep.load() if rep.alive else 0)
        return done

    def run(self) -> Dict[int, RoutedRequest]:
        """Drain every replica; returns router uid → finished request."""
        while any(not r.finished for r in self._requests.values()):
            self.step()
            if not any(rep.has_work() for rep in self.replicas) and (
                    not self._awaiting_prefill):
                # nothing left anywhere — any unfinished request is a bug
                break
        return {u: r for u, r in self._requests.items() if r.finished}

    # -- observability -------------------------------------------------------

    def placement_hit_rate(self) -> float:
        """Fraction of bindings that landed on the digest-primary replica
        (spill/failover/handoff are the misses locality pays for)."""
        snap = self.registry.snapshot()
        fam = snap.get("router_placements_total")
        if not fam:
            return 0.0
        total = hit = 0
        for s in fam["series"]:
            total += s["value"]
            if s["labels"].get("outcome") == "primary":
                hit += s["value"]
        return hit / total if total else 0.0

    def metrics(self) -> Dict[str, Any]:
        """Router counters + transport meter + every replica's snapshot,
        replica-labeled."""
        return {
            "router": self.registry.snapshot(),
            "transport": self.transport.stats(),
            "replicas": {
                rep.name: {
                    "role": rep.role,
                    "alive": rep.alive,
                    "load": rep.load() if rep.alive else 0,
                    "metrics": rep.engine.metrics(),
                }
                for rep in self.replicas
            },
        }
