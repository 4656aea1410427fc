"""The port's kernel bench (``python -m repro_torch.benchmarks.run --only
kernel``) on the CPU, in process: the reference bench's row names in its
order, every kernel-vs-plain row within its stated tolerance, the
``--json-out`` file, the refusal of sub-benches that are not ported yet or
of a missing card, and the exit code when a row is over tolerance.  On the CPU
the wrappers run the plain versions; the card run is ``chip_smoke.py``'s."""
import contextlib
import io
import json
import types
from pathlib import Path

import pytest
import torch

from repro_torch.benchmarks import common, kernel_bench, run

ROOT = Path(__file__).resolve().parents[1]

SMOLLM_ROWS = [
    f"kernel:{kind}:smollm-135m:{shape}:{dt}"
    for dt in ("bfloat16", "float32")
    for kind, shape in (("flash_attention", "B=8:S=256"), ("flash_attention", "B=1:S=2048"),
                        ("decode_attention", "B=4:S=2048:L=1000"))
]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Torch's CPU ops on two threads in this module: under the suite's
    parallel workers, larger OpenMP teams oversubscribe the cores and every
    small op of an eager loop stalls (a run of the GLUE pipeline took 60 s
    on 8 threads beside five busy processes, 19 s on 2)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    out = tmp_path_factory.mktemp("bench") / "kernel.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        errors = run.main(["--only", "kernel", "--device", "cpu", "--json-out", str(out)])
    lines = buf.getvalue().splitlines()
    rows = [ln.split(",", 2) for ln in lines if ln.startswith("kernel:")]
    return {"errors": errors, "rows": rows, "lines": lines, "json": json.loads(out.read_text())}


def _reference_row_names(monkeypatch):
    """The names the reference bench emits, in order: its four functions run
    with ``timed`` stubbed and its kernel calls answered by its own oracles
    (the names do not depend on either)."""
    monkeypatch.syspath_prepend(str(ROOT))
    import benchmarks.kernel_bench as jbench

    jref = jbench.ref
    names = []
    monkeypatch.setattr(jbench, "emit", lambda name, us, derived: names.append(name))
    monkeypatch.setattr(jbench, "timed", lambda fn, *a, n=3: (None, 1.0))
    monkeypatch.setattr(jbench, "ops", types.SimpleNamespace(
        flash_attention=lambda q, k, v, causal, bq, bk: jref.flash_attention_ref(q, k, v),
        decode_attention=lambda q, kc, vc, length, bk: jref.decode_attention_ref(q, kc, vc, length),
        qrlora_matmul=lambda x, W, B, A, lam, s: jref.qrlora_matmul_ref(x, W, B, A, lam, s)))
    jbench.main()
    return names


def test_row_names_are_the_reference_benchs(bench, monkeypatch):
    names = [r[0] for r in bench["rows"]]
    ref_names = _reference_row_names(monkeypatch)
    assert len(ref_names) == 6
    assert names == ref_names + SMOLLM_ROWS
    assert "name,us_per_call,derived" in bench["lines"]
    assert "# device: cpu" in bench["lines"]


def test_every_error_row_is_within_tolerance(bench):
    names = [r[0] for r in bench["rows"]]
    compared = [n for n in names if not n.startswith("kernel:pivoted_qr")]
    assert sorted(bench["errors"]) == sorted(compared)
    assert all(e["ok"] for e in bench["errors"].values()), bench["errors"]
    for name, us, derived in bench["rows"]:
        assert float(us) > 0
        if name in bench["errors"]:
            assert "ok=1" in derived.split(";")
    assert bench["lines"][-1] == "# all benchmarks complete"


def test_qr_vs_svd_rows_report_the_ratio(bench):
    for name, us, derived in bench["rows"][:2]:
        fields = dict(kv.split("=") for kv in derived.split(";"))
        assert float(fields["ratio"]) == pytest.approx(float(fields["svd_us"]) / float(us),
                                                       rel=0.01, abs=0.01)


def test_json_out_holds_every_row(bench):
    assert bench["json"]["device"] == "cpu"
    times = bench["json"]["us_per_call"]
    assert sorted(times) == sorted(r[0] for r in bench["rows"])
    assert all(times[name] == round(float(us), 1) for name, us, _ in bench["rows"])


# the reference serving bench's sub-benches the port refuses, and the item
# that ports what each needs
_REFUSED = {"serve_multitenant:recurrent_families": "12b"}


@pytest.mark.parametrize("name", sorted(_REFUSED))
def test_unported_bench_raises_naming_its_roadmap_item(name):
    assert set(run.NOT_PORTED) == set(_REFUSED)
    with pytest.raises(NotImplementedError, match=rf"ROADMAP Queue 1 item {_REFUSED[name]}\)"):
        run.main(["--only", f"kernel,{name}", "--device", "cpu"])


def test_adapter_churn_runs_at_the_smoke_scale(monkeypatch):
    """The serving bench's adapter-churn sub-bench, once refused with item
    13, runs through the cold tier: its three rows, every tenant beyond the
    64 hot slots spilled to the host, its spill → promote bitwise."""
    from repro_torch.benchmarks import serve_multitenant

    monkeypatch.setenv("REPRO_BENCH_SCALE", "smoke")
    common.reset()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_multitenant.bench_adapter_churn(torch.device("cpu"))
    rows = [ln.split(",", 2) for ln in buf.getvalue().splitlines()
            if ln.startswith("serve_multitenant:churn:")]
    assert [r[0] for r in rows] == [f"serve_multitenant:churn:{op}"
                                    for op in ("register", "promote", "evict")]
    fields = dict(kv.split("=", 1) for kv in rows[0][2].split(";"))
    assert int(fields["hot"]) == 63 and int(fields["spills"]) == int(fields["tenants"]) - 63


def test_unknown_bench_and_missing_card_raise(monkeypatch):
    with pytest.raises(ValueError, match="unknown bench"):
        run.main(["--only", "kernels", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA requested"):
        run.main(["--only", "kernel"])  # the default device is the card


def test_row_over_tolerance_exits_nonzero(monkeypatch):
    """A planted fault in a kernel path (output 1% off) fails the run."""
    real = kernel_bench.ops.flash_attention

    def small_bench(device):
        gen = torch.Generator(device=device).manual_seed(0)
        monkeypatch.setattr(kernel_bench.ops, "flash_attention",
                            lambda *a, **kw: real(*a, **kw) * 1.01)
        kernel_bench._flash_row(gen, "kernel:flash_attention:fault", 1, 32, 4, 2, 16,
                                torch.float32, device)

    monkeypatch.setattr(kernel_bench, "main", small_bench)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit) as exit_info:
        run.main(["--only", "kernel", "--device", "cpu"])
    assert exit_info.value.code == 1
    assert "# OVER TOLERANCE: ['kernel:flash_attention:fault']" in buf.getvalue()
    assert not common.errors()["kernel:flash_attention:fault"]["ok"]


def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports only the standard library at
    the top), for the faults it plants."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("kind", ["flash_attention", "decode_attention",
                                  "paged_decode_attention"])
def test_bf16_attention_limits_hold_a_sound_variant_and_reject_a_dropped_tile(kind):
    """At smollm-135m's heads, late in a long sequence where |o| is small:
    the plain version with unrounded probabilities (the decode kernels'
    numerics) is within the bench's bf16 limit, and the plain version with
    one tile of keys left out of the last query rows is not — for flash,
    the KV tile that ``chip_smoke.py`` plants on the card's output; for
    decode, the last 32 positions before the length (half of one of the
    split kernel's 64-position chunks); for paged decode, the last block
    (16 positions) of the longest lane."""
    from repro_torch.kernels import ref

    gen = torch.Generator().manual_seed(3)
    H, KV, dh = 9, 3, 64
    if kind == "paged_decode_attention":
        bs, width = 16, 64
        pool = (1 + 4 * width, bs, KV, dh)
        q, kp, vp = ((torch.randn(s, generator=gen) * 0.5).bfloat16()
                     for s in ((4, H, dh), pool, pool))
        tbl = (torch.randperm(4 * width, generator=gen) + 1).to(torch.int32).reshape(4, width)
        lens = torch.tensor([1008, 700, 300, 17], dtype=torch.int32)
        plain = ref.paged_decode_attention_ref(q, kp, vp, tbl, lens)
        unrounded = ref.paged_decode_attention_ref(q.float(), kp.float(), vp.float(), tbl, lens)
        faulty = ref.paged_decode_attention_ref(q.float(), kp.float(), vp.float(), tbl,
                                                lens - torch.tensor([bs, 0, 0, 0]).int())
        pv = kernel_bench.abs_v_paged(q, kp, vp, tbl, lens)
    elif kind == "flash_attention":
        S = 1024
        q, k, v = ((torch.randn(s, generator=gen) * 0.5).bfloat16()
                   for s in ((1, S, H, dh), (1, S, KV, dh), (1, S, KV, dh)))
        arg, plain = True, ref.flash_attention_ref(q, k, v, causal=True)
        unrounded = ref.flash_attention_ref(q.float(), k.float(), v.float(), causal=True)
        faulty = unrounded + _chip_smoke()._dropped_tile_delta(q, k, v)
        pv = kernel_bench.abs_v_attention(q, k, v, arg)
    else:
        L = 1000
        q, k, v = ((torch.randn(s, generator=gen) * 0.5).bfloat16()
                   for s in ((4, H, dh), (4, 2048, KV, dh), (4, 2048, KV, dh)))
        arg, plain = L, ref.decode_attention_ref(q, k, v, L)
        unrounded = ref.decode_attention_ref(q.float(), k.float(), v.float(), L)
        faulty = ref.decode_attention_ref(q.float(), k.float(), v.float(), L - 32)
        pv = kernel_bench.abs_v_attention(q, k, v, arg)
    tol = kernel_bench.TOL[kind][torch.bfloat16]
    assert common.err_over_bound(unrounded.bfloat16(), plain, tol, pv) <= 1.0
    assert common.err_over_bound(faulty.bfloat16(), plain, tol, pv) > 1.0
