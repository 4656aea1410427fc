"""The moe family through the serving engine: the port's
``MultiTenantEngine`` beside the JAX package's on the same reduced
moonshot-v1-16b-a3b weights, tenants and traffic (the default config; a
capacity that drops copies; ``EngineConfig.serving()`` with chunked
prefill; ``speculate_k=2``).  The trainer's side is
``test_torch_moe_train.py``.

Every dispatch sends the reference's rows (a prefill's padded bucket, every
decode lane, a chunk, a verify window), so the engines drop the same copies
and give identical streams and schedules.  Bound: logits within 1e-4
(``test_torch_serving.py``'s engine bar)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import build_model as jax_build
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import MultiTenantEngine as JEngine
from repro_torch.configs import get_reduced
from repro_torch.interop import params_from_jax
from repro_torch.models import moe
from repro_torch.serving import EngineConfig, MultiTenantEngine

ARCH = "moonshot-v1-16b-a3b"
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _threads_and_jax_caches():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


_WEIGHTS = {}


def _weights():
    """Reduced float32 JAX params as numpy leaves and three tenants' λ."""
    if not _WEIGHTS:
        jcfg = jax_reduced(ARCH).replace(dtype="float32")
        npj = jax.tree_util.tree_map(np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(3)))
        rng = np.random.default_rng(5)
        shape = npj["groups"]["adapters"]["attn"]["wq"]["lam"].shape
        lams = {f"t{i}": {"attn": {p: (rng.standard_normal(shape) * 0.3).astype(np.float32)
                                   for p in ("wq", "wv")}} for i in range(3)}
        _WEIGHTS.update(npj=npj, lams=lams)
    return _WEIGHTS["npj"], _WEIGHTS["lams"]


def _traffic(long: bool = False, n: int = 6):
    """``n`` requests over three tenants: prompts of 5-30 tokens (buckets 8,
    16 and 32), or with ``long`` two of 40 and 45 that stream in chunks."""
    rng = np.random.default_rng(7)
    lens = ([5, 30, 12, 21, 9, 27] if not long else [5, 40, 12, 45, 9, 27])[:n]
    return [(f"t{i % 3}", rng.integers(2, 256, size=P).astype(np.int32),
             int(rng.integers(4, 9))) for i, P in enumerate(lens)]


def _count_drops(calls):
    """Wrap ``moe.route``: each call appends (rows, copies dropped)."""
    real = moe.route

    def counting(x, wr, k, C):
        r = real(x, wr, k, C)
        calls.append((x.shape[0], int((r.copy_slot == wr.shape[-1] * C).sum())))
        return r

    return counting


def _serve_both(conf, traffic, cf=None, preset=False, monkeypatch=None):
    """Both engines under the EngineConfig fields ``conf`` (``preset``:
    ``EngineConfig.serving(**conf)``), capacity factor ``cf`` on both
    configs: each engine, its requests in submission order, its per-step
    schedule; the port's route calls as (rows, dropped)."""
    npj, lams = _weights()
    over = {} if cf is None else {"capacity_factor": cf}
    jcfg = jax_reduced(ARCH).replace(dtype="float32", **over)
    cfg = get_reduced(ARCH).replace(dtype="float32", **over)
    if preset:
        jconf, tconf = JEngineConfig.serving(telemetry=False, **conf), EngineConfig.serving(**conf)
    else:
        jconf, tconf = JEngineConfig(**conf), EngineConfig(**conf)
    jeng = JEngine(jcfg, jconf, params=jax.tree_util.tree_map(jnp.asarray, npj))
    teng = MultiTenantEngine(cfg, tconf, params=params_from_jax(npj, device="cpu"), device="cpu")
    calls = []
    monkeypatch.setattr(moe, "route", _count_drops(calls))
    out = []
    for eng, to_lam in ((jeng, lambda t: jax.tree_util.tree_map(jnp.asarray, t)),
                        (teng, lambda t: t)):
        for t, lam in lams.items():
            eng.add_tenant(t, to_lam(lam))
        reqs = [eng.submit(t, p, n) for t, p, n in traffic]
        sched = []
        while eng.scheduler.has_work:
            eng.step()
            sched.append([(e.uid, e.lane, e.token, e.index) for e in eng.events])
        out.append((eng, reqs, sched))
    return out, calls


def _assert_same(out, label):
    (jeng, jreqs, jsched), (teng, treqs, tsched) = out
    assert tsched == jsched
    assert teng.steps == jeng.steps and teng.decoded_tokens == jeng.decoded_tokens
    worst = 0.0
    for jr, tr in zip(jreqs, treqs):
        assert tr.tokens == jr.tokens
        d = float(np.abs(np.stack(tr.logits) - np.stack(jr.logits)).max())
        worst = max(worst, d)
    print(f"[parity] {ARCH} engine {label} vs JAX engine: logits max|Δ| {worst:.2e}")
    assert worst < LOGIT_TOL
    if teng.paged:
        assert teng.allocator.n_free == jeng.allocator.n_free


BASE = dict(n_lanes=3, n_slots=4, max_len=64, collect_logits=True, block_size=8)


def test_default_config_matches_the_jax_engine(monkeypatch):
    out, calls = _serve_both(BASE, _traffic(), monkeypatch=monkeypatch)
    assert out[1][0].layout == out[0][0].layout == "paged"
    _assert_same(out, "default")
    # every prefill routed its whole bucket; every decode step its 3 lanes
    rows = {T for T, _ in calls}
    assert {8, 16, 32} <= rows and 3 in rows
    assert all(d == 0 for _, d in calls)  # the reduced config is drop-free


def test_a_dropping_capacity_drops_the_same_copies(monkeypatch):
    """cf 1.0 (C = max(8, ⌈T·2/8⌉) = 8 up to T = 32): a 32-row bucket's 64
    copies over 8 experts overflow some buffers.  Identical streams mean
    both engines kept and dropped the same copies (a copy dropped on one
    side only moves that token's output by a whole expert's share)."""
    out, calls = _serve_both(BASE, _traffic(n=4), cf=1.0, monkeypatch=monkeypatch)
    dropped = sum(d for _, d in calls)
    print(f"[parity] {ARCH} cf 1.0: {dropped} copies dropped over {len(calls)} routed calls")
    assert dropped > 0 and any(d for T, d in calls if T == 32)
    _assert_same(out, "cf 1.0")


def test_serving_preset_with_chunks_matches_the_jax_engine(monkeypatch):
    conf = dict(n_lanes=3, n_slots=4, max_len=64, collect_logits=True, block_size=8)
    out, calls = _serve_both(conf, _traffic(True), preset=True, monkeypatch=monkeypatch)
    (jeng, _, _), (teng, _, _) = out
    assert teng.chunk_dispatches > 0  # the 40- and 45-token prompts in chunks of 16 rows
    _assert_same(out, "serving()")


def test_speculative_engine_matches_the_jax_engine(monkeypatch):
    conf = dict(BASE, speculate_k=2)
    out, calls = _serve_both(conf, _traffic(n=4), monkeypatch=monkeypatch)
    (jeng, _, _), (teng, _, _) = out
    for name in ("spec_steps", "drafted_tokens", "accepted_drafts"):
        assert getattr(teng, name) == getattr(jeng, name), name
    assert 3 * 3 in {T for T, _ in calls}  # the verify: 3 lanes × (k + 1) rows
    _assert_same(out, "speculate_k=2")
