"""The ssm family (reduced xlstm-125m, float32, CPU) through the serving
engine: the port's ``MultiTenantEngine`` beside the JAX package's on
``tests/test_serving.py``'s ``FAMILY_SPECS`` (identical streams and
schedules, logits within 1e-4), the reference's xlstm quantum tests as
written (``tests/test_serving.py:379``, ``:476``; ``tests/test_obs.py:264``;
port against port, bitwise), and ``chip_smoke.py``'s xlstm rig with its
three planted faults at the reduced config.  The hybrid's engine tests are
``test_torch_recurrent_engine.py``'s."""
import jax
import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.serving import BASE_TENANT, EngineConfig, MultiTenantEngine, random_lambda
from test_torch_recurrent_engine import XLSTM, check_engines_on_family_specs


@pytest.fixture(scope="module", autouse=True)
def _threads_and_jax_caches():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def test_engines_match_on_family_specs():
    """The xlstm case of ``tests/test_serving.py:299-313``: no KV cache, the
    dense layout, both engines on the same weights, tenants and traffic."""
    check_engines_on_family_specs("xlstm")


def test_quantum_round_robin_is_bit_identical():
    """``tests/test_serving.py:379``: an xlstm lane time-sliced out
    snapshots its LaneState and restores it on re-admission; every request's
    tokens and logits are the unsliced engine's, bitwise."""
    cfg = get_reduced(XLSTM).replace(dtype="float32")

    def run(quantum):
        eng = MultiTenantEngine(cfg, EngineConfig(n_lanes=1, n_slots=3, max_len=48,
                                                  collect_logits=True, quantum=quantum),
                                device="cpu")
        eng.add_tenant("t1", random_lambda(torch.Generator().manual_seed(1), eng.params, 0.3))
        rng = np.random.default_rng(0)
        subs = [eng.submit(BASE_TENANT, rng.integers(2, cfg.vocab_size, size=7).astype(np.int32), 9),
                eng.submit("t1", rng.integers(2, cfg.vocab_size, size=5).astype(np.int32), 9)]
        eng.run()
        return eng, subs

    eng_plain, plain = run(None)
    eng_q, sliced = run(3)
    assert eng_q.slice_preemptions >= 2 and eng_plain.slice_preemptions == 0
    for rp, rq in zip(plain, sliced):
        assert rq.preemptions >= 1
        assert rp.tokens == rq.tokens
        np.testing.assert_array_equal(np.stack(rp.logits), np.stack(rq.logits))


def test_quantum_preempts_at_most_one_lane_per_waiter():
    """``tests/test_serving.py:476``: one waiter snapshot-preempts only the
    most overdue xlstm lane."""
    cfg = get_reduced(XLSTM).replace(dtype="float32")
    eng = MultiTenantEngine(cfg, EngineConfig(n_lanes=2, n_slots=2, max_len=32, quantum=2),
                            device="cpu")
    rng = np.random.default_rng(1)
    for _ in range(3):  # 2 lanes + 1 waiter
        eng.submit(BASE_TENANT, rng.integers(2, cfg.vocab_size, size=5).astype(np.int32), 8)
    while eng.slice_preemptions == 0 and eng.scheduler.has_work:
        before_active = len(eng.scheduler.active())
        eng.step()
    assert eng.slice_preemptions == 1, "both lanes churned for one waiter"
    assert before_active == 2
    eng.run()


def test_quantum_preemption_recorded_per_requeue():
    """``tests/test_obs.py:264`` as written: the quantum counter, one
    preempt mark a requeue, and a restored request re-admitted without a
    second prefill."""
    cfg = get_reduced(XLSTM).replace(dtype="float32")
    eng = MultiTenantEngine(cfg, EngineConfig(n_lanes=1, n_slots=2, max_len=48, quantum=3),
                            device="cpu")
    rng = np.random.default_rng(0)
    r1 = eng.submit(BASE_TENANT, rng.integers(2, cfg.vocab_size, size=7).astype(np.int32), 9)
    r2 = eng.submit(BASE_TENANT, rng.integers(2, cfg.vocab_size, size=5).astype(np.int32), 9)
    eng.run()
    assert eng.slice_preemptions >= 2
    by_cause = {s["labels"]["cause"]: s["value"]
                for s in eng.metrics()["serve_preemptions_total"]["series"]}
    assert by_cause["quantum"] == float(eng.slice_preemptions)
    marks = r1.trace.names().count("preempt") + r2.trace.names().count("preempt")
    assert marks == eng.slice_preemptions
    for r in (r1, r2):
        if r.preemptions:
            assert r.trace.names().count("admit") == r.preemptions + 1
            assert r.trace.names().count("prefill") == 1


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_chip_smoke_xlstm_faults_are_rejected(monkeypatch):
    """``chip_smoke.py``'s xlstm rig at the reduced config on the CPU: the
    float32 serve of its 4 tenants (prompts in buckets 32 and 64) passes its
    check against the merged-weight reference, and each planted fault (decode
    seg sent to slot 0, the mLSTM v adapter dropped, the bucket padding left
    in the recurrent state) is rejected."""
    from repro_torch.serving import engine as engine_mod

    cs = _chip_smoke()
    monkeypatch.setattr(engine_mod, "resolve_device", lambda d=None: torch.device("cpu"))
    cfg = get_reduced(XLSTM).replace(dtype="float32")
    eng = MultiTenantEngine(cfg, EngineConfig(), device="cpu")
    lams = {f"tenant{i}": random_lambda(torch.Generator().manual_seed(100 + i), eng.params, 0.3)
            for i in range(len(cs.XLSTM_PROMPTS))}
    engine, lams, done, _ = cs.recurrent_serve(cfg, 0, cs.XLSTM_PROMPTS, 8, params=eng.params,
                                               lams=lams)
    assert engine.layout == "oracle_dense" and sorted(engine.prefill_buckets) == [32, 64]
    rows = cs.verify(cfg, engine, lams, done, 8)
    assert all(r["tokens_match"] and r["max_abs_dlogits"] < cs.FP32_LOGIT_TOL for r in rows)
    faults = cs.xlstm_faults(cfg, engine, lams, done)
    assert set(faults) == {"decode_seg_to_slot0", "v_adapter_dropped", "padding_unmasked"}
    for name, row in faults.items():
        assert not row["ok"], (name, row)
