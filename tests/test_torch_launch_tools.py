"""The port's roofline, dry-run, hillclimb and report against the JAX
reference's.

* ``model_flops_for`` equals the reference's at every arch × shape (an
  analytic count: exact).
* ``from_terms`` on the same terms: each time term is the reference's
  scaled by the ratio of the two hardware models' constants (relative
  1e-12: one float division each), the bottleneck, useful ratio and
  roofline fraction follow from them; the collective term of a trace with
  no collectives is None and the bottleneck is chosen between the other two.
* The affine probe over 1 and 2 layer groups equals a direct count at G
  groups, exactly (integer FLOPs and bytes), on reduced dense, moe, ssm and
  hybrid configs.
* ``run_cell`` on reduced configs returns OK for each shape kind with the
  reference's record keys, the compiler's fields None; a failing trace is a
  FAIL record and the CLI's exit 1; ``--both-meshes`` traces each cell once.
* ``hillclimb.parse_val`` equals the reference's; ``report.render`` gives the
  reference's text character for character.

The reference's ``dryrun``/``hillclimb`` modules set ``XLA_FLAGS`` (512
host devices) when imported, which would change every later JAX test in
the worker, so their ``parse_val`` is compiled from the source alone.
"""
import ast
import json
from pathlib import Path

import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import all_archs as j_all_archs
from repro.configs import get_config as jax_config
from repro.launch import report as j_report
from repro.launch import roofline as JRL
from repro_torch.configs import SHAPES, ShapeConfig, get_config, get_reduced
from repro_torch.launch import dryrun, hillclimb, report
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import MeshSpec, make_production_mesh

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-12

# the reference's record keys (repro/launch/dryrun.py:119-158, hillclimb.py:49-62)
RECORD_KEYS = {"arch", "shape", "mesh", "status", "lower_s", "compile_s", "memory", "probe",
               "roofline"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
               "peak_per_device_gb"}
ROOFLINE_KEYS = {"flops_per_device", "hbm_bytes_per_device", "coll_bytes_per_device",
                 "coll_by_kind", "compute_s", "memory_s", "collective_s", "bottleneck",
                 "model_flops", "useful_ratio", "roofline_fraction"}
HILLCLIMB_KEYS = {"arch", "shape", "overrides", "peak_gb", "compute_s", "memory_s",
                  "collective_s", "bottleneck", "useful", "roofline_frac", "coll_by_kind",
                  "probe", "temp_gb", "arg_gb"}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def reduced_grid(monkeypatch):
    """The dry-run and hillclimb on reduced configs (full-width cells)."""
    monkeypatch.setattr(dryrun, "get_config", get_reduced)
    monkeypatch.setattr(hillclimb, "get_config", get_reduced)


def _reference_function(path: str, name: str):
    """A top-level function of a reference module, compiled from its source
    without importing the module."""
    tree = ast.parse((ROOT / path).read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)
    ns = {}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"), ns)
    return ns[name]


def test_hardware_model_is_the_h100s():
    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.NVLINK_BW) == (989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("arch", j_all_archs())
def test_model_flops_match_the_reference(arch):
    for name in SHAPES:
        assert RL.model_flops_for(get_config(arch), SHAPES[name]) == JRL.model_flops_for(
            jax_config(arch), J_SHAPES[name]), name


TERMS = [  # (flops, hbm bytes, collective bytes by kind, model flops, chips)
    (3.1e15, 2.0e12, {"all-reduce": 4e9, "all-gather": 1e9}, 2.2e17, 256),
    (1.0e12, 9.0e12, {"all-gather": 7e8}, 8.0e13, 512),
    (5.0e13, 1.0e10, {"all-to-all": 6e12}, 1.0e15, 256),
]


@pytest.mark.parametrize("flops,hbm,coll,mf,chips", TERMS)
def test_from_terms_scales_the_reference_by_the_constants(flops, hbm, coll, mf, chips):
    got = RL.from_terms(flops, hbm, coll, model_flops=mf, chips=chips)
    want = JRL.from_terms(flops, hbm, coll, model_flops=mf, chips=chips)
    assert got.compute_s == pytest.approx(want.compute_s * JRL.PEAK_FLOPS / RL.PEAK_FLOPS, rel=REL)
    assert got.memory_s == pytest.approx(want.memory_s * JRL.HBM_BW / RL.HBM_BW, rel=REL)
    assert got.collective_s == pytest.approx(
        want.collective_s * JRL.ICI_BW / RL.NVLINK_BW, rel=REL)
    terms = {"compute": got.compute_s, "memory": got.memory_s, "collective": got.collective_s}
    assert got.bottleneck == max(terms, key=terms.get)
    assert (got.flops, got.hbm_bytes, got.coll_bytes, got.coll_by_kind) == (
        want.flops, want.hbm_bytes, want.coll_bytes, want.coll_by_kind)
    assert got.useful_ratio == want.useful_ratio
    assert got.roofline_fraction == pytest.approx(
        mf / (chips * RL.PEAK_FLOPS) / max(terms.values()), rel=REL)


@pytest.mark.parametrize("flops,hbm,coll,mf,chips", TERMS)
def test_a_trace_without_collectives_leaves_the_term_none(flops, hbm, coll, mf, chips):
    got = RL.from_terms(flops, hbm, None, model_flops=mf, chips=chips)
    assert got.collective_s is None and got.coll_bytes is None and got.coll_by_kind is None
    terms = {"compute": flops / RL.PEAK_FLOPS, "memory": hbm / RL.HBM_BW}
    assert got.bottleneck == max(terms, key=terms.get)
    assert got.roofline_s == max(terms.values())


def test_count_costs_counts_a_matmul_and_its_bytes():
    """One (m, k) × (k, n) product on meta tensors: 2mkn FLOPs, and its
    operands' and result's bytes; a view adds none."""
    a = torch.empty((64, 32), dtype=torch.bfloat16, device="meta")
    b = torch.empty((32, 16), dtype=torch.float32, device="meta")
    flops, moved = RL.count_costs(lambda x, y: (x.float() @ y).t(), a, b)
    assert flops == 2 * 64 * 32 * 16
    # the cast reads 64·32 bf16 and writes them in float32; the product
    # reads both float32 operands and writes 64·16 float32
    assert moved == 64 * 32 * (2 + 4) + (64 * 32 + 32 * 16 + 64 * 16) * 4


# (arch, overrides giving 3 groups; the hybrid's groups cut to 4 layers:
# Mamba, Mamba+moe, attention, Mamba+moe)
PROBED = [("smollm_135m", dict(n_layers=3)), ("moonshot_v1_16b_a3b", dict(n_layers=3)),
          ("xlstm_125m", dict(n_layers=6)),
          ("jamba_1_5_large_398b", dict(n_layers=12, hybrid_period=4, hybrid_attn_index=2))]
PROBE_SHAPES = [ShapeConfig("train_s", 8, 2, "train"), ShapeConfig("prefill_s", 8, 2, "prefill"),
                ShapeConfig("decode_s", 8, 2, "decode")]


@pytest.mark.parametrize("arch,overrides", PROBED, ids=[a for a, _ in PROBED])
def test_affine_probe_equals_a_direct_count(arch, overrides):
    """1 and 2 groups extrapolated to 3 against the 3 groups traced whole
    (every layer adapted, so every group repeats the same ops), on a 2×2
    mesh (the moe layers' dispatch split over its 2 data shards)."""
    cfg = get_reduced(arch)
    cfg = cfg.replace(adapter=cfg.adapter.replace(layers="all"), **overrides)
    mesh = MeshSpec((2, 2), ("data", "model"))
    for shape in PROBE_SHAPES:
        flops, hbm, _ = dryrun._probe_costs(cfg, shape, mesh)
        assert (flops, hbm) == dryrun._trace_cell(cfg.replace(microbatches=1), shape,
                                                  mesh), shape.name
        assert flops > 0 and hbm > 0


@pytest.mark.parametrize("decode_weight_stationary", [False, True])
def test_moe_trace_counts_each_data_shards_dispatch(decode_weight_stationary):
    """A moe cell traces the sharded branch's work: at decode (the full
    config's capacity factor 1.25), each of 4 data shards dispatches its 8
    lanes into C = 8 slots an expert (the floor of 8 pads ⌈2.5⌉), more
    than one dispatch over the 32 lanes (a 1×8 mesh, one data shard: C =
    10); the same as the single-device dispatch with the batch replicated
    (weight-stationary decode)."""
    cfg = get_reduced("moonshot_v1_16b_a3b").replace(
        n_layers=1, capacity_factor=1.25, decode_weight_stationary=decode_weight_stationary)
    shape = ShapeConfig("decode_s", 64, 32, "decode")
    split = dryrun._trace_cell(cfg, shape, MeshSpec((4, 2), ("data", "model")))
    whole = dryrun._trace_cell(cfg, shape, MeshSpec((1, 8), ("data", "model")))
    assert (split[0] > whole[0]) != decode_weight_stationary, (split, whole)
    assert (split == whole) == decode_weight_stationary


def _check_ok_record(rec, arch, shape, mesh, probe):
    assert set(rec) == RECORD_KEYS and rec["status"] == "OK", rec
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["probe"]) == (arch, shape, mesh, probe)
    assert set(rec["memory"]) == MEMORY_KEYS and set(rec["roofline"]) == ROOFLINE_KEYS
    assert rec["compile_s"] is None
    for k in ("output_bytes", "temp_bytes", "alias_bytes", "peak_per_device_gb"):
        assert rec["memory"][k] is None, k
    for k in ("coll_bytes_per_device", "coll_by_kind", "collective_s"):
        assert rec["roofline"][k] is None, k
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["roofline"]["bottleneck"] in ("compute", "memory")


@pytest.mark.parametrize("arch", ["smollm_135m", "moonshot_v1_16b_a3b"])
def test_run_cell_records_each_shape_kind(arch, reduced_grid):
    multi = {"16x16": False, "2x16x16": True}
    for mesh, mp in multi.items():
        probe = dryrun.PROBE_MOE if arch.startswith("moonshot") else dryrun.PROBE
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            rec = dryrun.run_cell(arch, shape, mp, verbose=False)
            _check_ok_record(rec, arch, shape, mesh, probe)
            cfg = get_reduced(arch)
            rl = rec["roofline"]
            assert rl["model_flops"] == RL.model_flops_for(cfg, SHAPES[shape])
            flops, hbm, _ = dryrun._probe_costs(
                cfg, SHAPES[shape], dryrun.trace_mesh(cfg, make_production_mesh(multi_pod=mp)))
            n = 512 if mp else 256
            assert (rl["flops_per_device"], rl["hbm_bytes_per_device"]) == (flops / n, hbm / n)
        assert dryrun.run_cell(arch, "long_500k", mp, verbose=False) == {
            "arch": arch, "shape": "long_500k", "mesh": mesh, "status": "SKIP(full-attn)"}


def test_a_failing_trace_is_a_fail_record_and_exit_1(reduced_grid, monkeypatch, tmp_path):
    def broken(cfg, shape, mesh):
        raise RuntimeError("planted")

    monkeypatch.setattr(dryrun, "_trace_cell", broken)
    dryrun._probe_costs.cache_clear()
    try:
        rec = dryrun.run_cell("qwen2_0_5b", "decode_32k", False, verbose=False)
        assert rec["status"] == "FAIL" and rec["error"] == "RuntimeError: planted"
        assert "planted" in rec["traceback"]
        assert dryrun.main(["--arch", "qwen2_0_5b", "--shape", "decode_32k"]) == 1
    finally:
        dryrun._probe_costs.cache_clear()


def test_cli_traces_each_cell_once_over_both_meshes(reduced_grid, monkeypatch, tmp_path):
    traced = []
    sound = dryrun._trace_cell
    monkeypatch.setattr(dryrun, "_trace_cell",
                        lambda cfg, shape, mesh: traced.append((cfg.name, shape.name))
                        or sound(cfg, shape, mesh))
    dryrun._probe_costs.cache_clear()
    try:
        out = tmp_path / "dry.json"
        assert dryrun.main(["--arch", "qwen2_0_5b,smollm_135m", "--shape",
                            "decode_32k,long_500k", "--both-meshes", "--out", str(out)]) == 0
    finally:
        dryrun._probe_costs.cache_clear()
    recs = json.loads(out.read_text())
    assert [(r["arch"], r["shape"], r["mesh"], r["status"]) for r in recs] == [
        (a, s, m, "OK" if s == "decode_32k" else "SKIP(full-attn)")
        for m in ("16x16", "2x16x16") for a in ("qwen2_0_5b", "smollm_135m")
        for s in ("decode_32k", "long_500k")]
    assert sorted(traced) == sorted([("qwen2-0.5b", "decode_32k")] * 2
                                    + [("smollm-135m", "decode_32k")] * 2)


def test_parse_val_matches_the_reference():
    ref = _reference_function("src/repro/launch/hillclimb.py", "parse_val")
    for v in ("True", "False", "true", "0", "-3", "16", "1.5", "1e-3", "nan", "inf", "x",
              "dp_only", "", "3.0", "0x10", " 7"):
        got, want = hillclimb.parse_val(v), ref(v)
        assert got == want or (got != got and want != want), v
        assert type(got) is type(want), v


def test_hillclimb_run_keeps_the_reference_keys(reduced_grid, capsys):
    rec = hillclimb.run("smollm_135m", "decode_32k", {"dp_only": True})
    assert set(rec) == HILLCLIMB_KEYS and rec["overrides"] == {"dp_only": True}
    assert all(rec[k] is None for k in ("peak_gb", "collective_s", "coll_by_kind", "temp_gb"))
    assert json.loads(capsys.readouterr().out) == rec
    with pytest.raises(ValueError, match="scan_layers"):
        hillclimb.run("smollm_135m", "decode_32k", {"scan_layers": False})


def test_report_renders_the_reference_text(reduced_grid, tmp_path):
    """OK records of the port with the fields a compiler gives set to
    numbers, a FAIL and a SKIP: the reference's renderer gives the same
    text; with the None fields left, each renders as —."""
    recs = [dryrun.run_cell("smollm_135m", s, mp, verbose=False)
            for mp in (False, True) for s in ("train_4k", "decode_32k", "long_500k")]
    recs.append({"arch": "qwen3_14b", "shape": "train_4k", "mesh": "16x16", "status": "FAIL",
                 "error": "RuntimeError: x", "traceback": "..."})
    raw = tmp_path / "raw.json"
    raw.write_text(json.dumps(recs))
    for i, r in enumerate(recs):
        if r["status"] == "OK":
            r["memory"]["peak_per_device_gb"] = round(0.123 * (i + 1), 3)
            r["roofline"]["collective_s"] = 0.0004 * (i + 1)
    filled = tmp_path / "filled.json"
    filled.write_text(json.dumps(recs))
    assert report.render(str(filled)) == j_report.render(str(filled))
    text = report.render(str(raw))
    ok_rows = [ln for ln in text.splitlines() if "| OK |" in ln]
    assert len(ok_rows) == 4 and all(ln.split("|")[5] == " — " and ln.split("|")[8] == " — "
                                     for ln in ok_rows)
    for b in (0, 1, 2**20, 2**28 - 1, 2**28, 5 * 2**30):
        assert report.fmt_bytes(b) == j_report.fmt_bytes(b)
