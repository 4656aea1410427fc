"""The port's serving bench (``python -m repro_torch.benchmarks.run --only
serve_multitenant``) on the CPU at the smoke scale, in process: the eleven
sub-benches' rows under the reference's names and in its order, each speed
ordering the reference asserts carried as a ``held`` reading with both
sides' numbers, the correctness bounds it keeps hard (and a planted fault
that one of them rejects), every kernel row within its stated tolerance,
and the refusal of a sub-bench's name as a bench.  On the CPU the kernel
wrappers run their plain versions, so the errors read 0 and every time is a
CPU time."""
import contextlib
import io
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.benchmarks import common, run, serve_multitenant
from repro_torch.serving import MultiTenantEngine

ROOT = Path(__file__).resolve().parents[1]

ROWS = {
    "adapter_churn": [f"churn:{op}" for op in ("register", "promote", "evict")],
    "bgmv_overhead": ["bgmv_vs_single"],
    "engine_throughput": [f"engine:tenants={n}" for n in (1, 4, 8)],
    "recurrent_families": [f"engine:family={f}" for f in ("ssm", "hybrid")],
    "chunked_prefill": ["chunked_prefill:off", "chunked_prefill:on"],
    "speculative": [f"speculative:k={k}" for k in (0, 2, 4)] + ["speculative:saving"],
    "telemetry_overhead": ["engine:telemetry=off", "engine:telemetry=on"],
    "decode_phases": [f"phase:{p}" for p in ("kv_gather", "attend", "bgmv", "dequant")],
    "paged_vs_dense": ["kv_cache:dense", "kv_cache:paged", "kv_cache:paged_saving"],
    "prefix_sharing": [f"prefix_share:{m}" for m in ("unshared", "shared", "saving")],
    "quantized": ["kv_cache:paged_bf16", "kv_cache:paged_int8", "kv_cache:paged_quant_saving"],
}

# the reference's speed assertions, each now a reading: row → its fields
HELD = {
    "chunked_prefill:on": ("held_stall", "held_step", "off_stall_us", "off_step_us"),
    "speculative:saving": ("held", "k0_us_tok", "k4_us_tok"),
    "engine:telemetry=on": ("held", "off_s", "on_s"),
    "prefix_share:saving": ("held", "shared_us", "unshared_us"),
    "kv_cache:paged_quant_saving": ("held", "bf16_s", "int8_s"),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Torch's CPU ops on two threads in this module (see
    ``test_torch_kernel_bench.py``: larger OpenMP teams stall every small
    op of an eager loop under the suite's parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        errors = run.main(argv)
    return errors, buf.getvalue().splitlines()


def _fields(derived: str) -> dict:
    return dict(kv.split("=", 1) for kv in derived.split(";") if "=" in kv)


@pytest.fixture(scope="module")
def bench():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_BENCH_SCALE", "smoke")
        errors, lines = _run(["--only", "serve_multitenant", "--device", "cpu"])
    rows = [ln.split(",", 2) for ln in lines if ln.startswith("serve_multitenant:")]
    return {"errors": errors, "lines": lines,
            "rows": {name.removeprefix("serve_multitenant:"): (float(us), _fields(d))
                     for name, us, d in rows},
            "order": [name.removeprefix("serve_multitenant:") for name, _, _ in rows]}


def test_the_nine_sub_benches_run_in_the_reference_order(bench):
    assert list(serve_multitenant.BENCHES) == list(ROWS)
    assert bench["order"] == [name for names in ROWS.values() for name in names]
    assert "# all benchmarks complete" in bench["lines"]


def _reference_templates():
    """The row names ``benchmarks/serve_multitenant.py`` emits, as regular
    expressions (each ``{…}`` of its f-strings matches one field)."""
    source = (ROOT / "benchmarks" / "serve_multitenant.py").read_text()
    return [re.compile(re.sub(r"\\\{[^}]*\\\}", "[^:]+", re.escape(t)) + "$")
            for t in re.findall(r'emit\(\s*f?"serve_multitenant:([^"]*)"', source)]


@pytest.mark.parametrize("sub", list(ROWS))
def test_each_sub_bench_emits_the_reference_rows(bench, sub):
    """Each row's name is one the reference emits, and carries a time."""
    templates = _reference_templates()
    for name in ROWS[sub]:
        assert any(t.match(name) for t in templates), name
        us, _ = bench["rows"][name]
        assert us >= 0.0 and us == us


def test_every_reference_row_of_the_nine_is_emitted(bench):
    for t in _reference_templates():
        assert any(t.match(name) for name in bench["order"]), t.pattern


@pytest.mark.parametrize("row", list(HELD))
def test_speed_assertions_are_readings_with_both_sides(bench, row):
    _, fields = bench["rows"][row]
    for key in HELD[row]:
        assert key in fields, (row, fields)
        if key.startswith("held"):
            assert fields[key] in ("True", "False")
        else:
            assert float(fields[key]) > 0.0


def test_kernel_rows_are_within_tolerance(bench):
    names = {"serve_multitenant:bgmv_vs_single", "serve_multitenant:bgmv_vs_single:single",
             "serve_multitenant:phase:attend", "serve_multitenant:phase:bgmv",
             "serve_multitenant:phase:dequant"}
    assert names <= set(bench["errors"])
    assert all(bench["errors"][n]["ok"] for n in names)


def test_the_hard_bounds_hold(bench):
    rows = bench["rows"]
    _, saving = rows["kv_cache:paged_saving"]
    assert int(saving["paged_bytes"]) < int(saving["dense_bytes"])
    _, share = rows["prefix_share:saving"]
    assert int(share["shared_peak"]) < int(share["unshared_peak"])
    _, spec = rows["speculative:k=4"]
    assert float(spec["acceptance"]) == 1.0  # base-tenant traffic: the drafter is the target
    _, reg = rows["churn:register"]
    assert int(reg["tenants"]) == 2000 and int(reg["spills"]) == 2000 - int(reg["hot"])
    assert int(reg["cold_bytes"]) == int(reg["spills"]) * int(reg["bytes_per_tenant"])


def test_a_paged_footprint_not_below_dense_fails_the_bench(monkeypatch):
    monkeypatch.setattr(MultiTenantEngine, "kv_cache_bytes", lambda self: 1000)
    with contextlib.redirect_stdout(io.StringIO()), \
            pytest.raises(AssertionError, match="not below dense"):
        serve_multitenant.bench_paged_vs_dense(torch.device("cpu"))


def test_one_sub_bench_runs_alone():
    common.reset()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_multitenant.bench_decode_phases(torch.device("cpu"))
    rows = [ln.split(",", 1)[0] for ln in buf.getvalue().splitlines()
            if ln.startswith("serve_multitenant:")]
    assert rows == [f"serve_multitenant:{n}" for n in ROWS["decode_phases"]]
    assert all(common.errors()[row]["ok"] for row in rows if row in common.errors())


def test_an_unknown_sub_bench_raises(bench):
    """``run.py`` names whole benches; a sub-bench's name is refused as
    unknown, the recurrent families' too (the port lacks none of the
    reference's: they run inside ``serve_multitenant``, an xlstm and a jamba
    hybrid row, each with its decode cache's bytes)."""
    with pytest.raises(ValueError, match="unknown bench"):
        run.main(["--only", "serve_multitenant:churn", "--device", "cpu"])
    assert run.NOT_PORTED == {}
    with pytest.raises(ValueError, match="unknown bench"):
        run.main(["--only", "serve_multitenant:recurrent_families", "--device", "cpu"])
    for fam in ("ssm", "hybrid"):
        us, fields = bench["rows"][f"engine:family={fam}"]
        assert us > 0.0 and int(fields["state_bytes"]) > 0 and int(fields["tok_s"]) >= 0
    assert "pool_peak" in bench["rows"]["engine:family=hybrid"][1]


def test_adapter_churn_spill_promote_is_bitwise(monkeypatch):
    """The churn bench's spill → promote bit-identity assertion is hard: a
    promotion that lands a row scaled by (1 + 2⁻²⁰) fails the bench."""
    from repro_torch.serving import LamStore

    sound = LamStore._write_slots

    def perturbed(self, slots, rows_list):
        return sound(self, slots, [{k: v * np.float32(1 + 2**-20) for k, v in r.items()}
                                   for r in rows_list])

    monkeypatch.setattr(LamStore, "_write_slots", perturbed)
    with contextlib.redirect_stdout(io.StringIO()), \
            pytest.raises(AssertionError, match="not bit-identical"):
        serve_multitenant.bench_adapter_churn(torch.device("cpu"))
