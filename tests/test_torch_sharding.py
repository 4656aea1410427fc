"""The sharded multi-tenant serve of the PyTorch port on the CPU: the rows
plain version against the reference's rows kernel (interpret mode), the
masked local λ gather, the fused sharded path in a gloo world of one against
the reference's one-device mesh, the engine in 2- and 4-rank gloo process
groups (subprocesses) bitwise against the replicated port engine, and the
sharded ``serve_multi`` entry point.  The rows kernel itself is held against
its plain version on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""
import datetime
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_reduced as jax_reduced
from repro.core.quantize import FP8_SUPPORTED as J_FP8, quantize_weight as j_quantize_weight
from repro.kernels.qrlora_bgmv import qrlora_bgmv_fused_sharded as j_fused_sharded
from repro.kernels.qrlora_bgmv import qrlora_bgmv_rows_kernel as j_rows_kernel
from repro.models import build_model as jax_build
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import MultiTenantEngine as JEngine
from repro_torch import kernels
from repro_torch.configs import get_reduced
from repro_torch.interop import params_from_jax, shard_ba_params
from repro_torch.kernels import ops
from repro_torch.kernels import qrlora_bgmv as tbgmv
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve_multi
from repro_torch.serving import BASE_TENANT, EngineConfig, MultiTenantEngine
from repro_torch.sharding import rules

ROOT = Path(__file__).resolve().parents[1]

# rows plain version vs the reference's rows kernel in interpret mode:
# float32 sums the same exact products in another order (≤ 1e-5 absolute);
# bfloat16 outputs are bit-equal, as the BGMV plain version's are.
F32_ATOL = 1e-5
# sharded port engine vs the sharded JAX engine (float32, 3 layers, fused
# multi-λ formula against XLA's): measured ~5e-6; tokens exact.
LOGIT_TOL = 1e-4
QUANTS = ["int8"] + (["fp8"] if J_FP8 else [])
M, K, N, R, SLOTS = 8, 48, 24, 16, 5


def _operands(seed, x_dtype, w_kind):
    """numpy-seeded operands in both frameworks: x and W in ``x_dtype``
    (``w_kind`` "plain") or W quantized per column by the reference
    ("int8"/"fp8"), bf16 factors, a λ table with slot 0 zero, per-row seg
    ids over every slot.  Returns (jax tuple, torch tuple), each
    ``(x, W, ws, B, A, table, seg)``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    W = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    B = (rng.standard_normal((K, R)) / np.sqrt(K)).astype(np.float32)
    A = rng.standard_normal((R, N)).astype(np.float32)
    tab = (rng.standard_normal((SLOTS, R)) * 0.3).astype(np.float32)
    tab[0] = 0.0
    seg = (np.arange(M) % SLOTS).astype(np.int32)
    jdt = jnp.bfloat16 if x_dtype == "bfloat16" else jnp.float32
    jx = jnp.asarray(x, jdt)
    if w_kind == "plain":
        jW, jws = jnp.asarray(W, jdt), jnp.ones((N,), jnp.float32)
    else:
        qW = j_quantize_weight(jnp.asarray(W), w_kind)
        jW, jws = qW["q"], qW["scale"]
    jops = (jx, jW, jws, jnp.asarray(B, jnp.bfloat16), jnp.asarray(A, jnp.bfloat16),
            jnp.asarray(tab), jnp.asarray(seg))
    tops = tuple(params_from_jax({"a": np.asarray(a)}, device="cpu")["a"] for a in jops)
    return jops, tops


@pytest.mark.parametrize("w_kind", ["plain"] + QUANTS)
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_rows_plain_matches_jax_rows_kernel(x_dtype, w_kind):
    (jx, jW, jws, jB, jA, jtab, jseg), (x, W, ws, B, A, tab, seg) = _operands(
        7, x_dtype, w_kind)
    rows = jnp.take(jtab, jseg, axis=0)
    want = np.asarray(j_rows_kernel(jx, jW, jws, jB, jA, rows, scale=0.5, interpret=True),
                      np.float32)
    got = tbgmv.qrlora_bgmv_rows(x, W, ws, B, A, tab[seg.long()], scale=0.5)
    assert got.dtype == x.dtype and got.shape == (M, N)
    err = np.abs(got.float().numpy() - want).max()
    print(f"[parity] bgmv rows plain {x_dtype} W={w_kind}: max|Δ| {err:.2e}")
    if x_dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        assert err <= F32_ATOL


@pytest.mark.parametrize("w_kind", ["plain"] + QUANTS)
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_rows_plain_equals_bgmv_plain_with_gathered_rows(x_dtype, w_kind):
    """With rows = Λ[seg] the rows plain version is bitwise the BGMV plain
    version (unquantized: all-ones w_scale, ×1.0 is exact) or its quantized
    twin; one row sent to slot 0 must differ."""
    _, (x, W, ws, B, A, tab, seg) = _operands(11, x_dtype, w_kind)
    rows = tab[seg.long()]
    got = tref.qrlora_bgmv_rows_ref(x, W, ws, B, A, rows, 0.7)
    if w_kind == "plain":
        want = tref.qrlora_bgmv_ref(x, W, B, A, tab, seg, 0.7)
    else:
        want = tref.qrlora_bgmv_quant_ref(x, W, ws, B, A, tab, seg, 0.7)
    assert torch.equal(got, want)
    planted = rows.clone()
    planted[3] = tab[0]  # row 3 (slot 3) sent to the base slot
    assert not torch.equal(tref.qrlora_bgmv_rows_ref(x, W, ws, B, A, planted, 0.7), want)


def test_rows_wrapper_validates_and_never_falls_back():
    """Bad dtypes, shapes and layouts are refused before any library is
    loaded; a tensor neither on the CPU nor on a card is refused; the CPU
    path launches nothing."""
    _, (x, W, ws, B, A, tab, seg) = _operands(2, "float32", "plain")
    rows = tab[seg.long()]
    kernels.reset_launch_counts()
    tbgmv.qrlora_bgmv_rows(x, W, ws, B, A, rows)
    assert all(v == 0 for v in kernels.launch_counts().values())
    for bad, exc in (
        ((x, W.bfloat16(), ws, B, A, rows), TypeError),  # W neither x's dtype nor q
        ((x, W, ws.double(), B, A, rows), TypeError),  # w_scale must be fp32
        ((x, W, ws, B.float(), A, rows), TypeError),  # the QR factors are bf16
        ((x, W, ws, B, A, rows.bfloat16()), TypeError),  # λ rows are fp32
        ((x, W, ws, B, A, rows[:4]), ValueError),  # one λ row per row of x
        ((x, W.t().contiguous().t(), ws, B, A, rows), ValueError),  # not contiguous
    ):
        with pytest.raises(exc):
            tbgmv.qrlora_bgmv_rows_cuda(*bad)
    with pytest.raises(NotImplementedError):
        tbgmv.qrlora_bgmv_rows(*(t.to("meta") for t in (x, W, ws, B, A, rows)))
    assert tbgmv.qrlora_bgmv_rows_cuda.launches == 0


def test_rows_wrapper_takes_w_scale_with_a_q_only():
    """W in x's dtype takes no w_scale (its route has no dequant step); an
    int8/fp8 q needs its w_scale.  Either mismatch is
    refused before any library is loaded."""
    _, (x, W, ws, B, A, tab, seg) = _operands(2, "float32", "plain")
    _, (_, q, qws, _, _, _, _) = _operands(2, "float32", "int8")
    rows = tab[seg.long()]
    for bad in ((x, W, ws, B, A, rows), (x, q, None, B, A, rows)):
        with pytest.raises(ValueError, match="w_scale"):
            tbgmv.qrlora_bgmv_rows_cuda(*bad)
    assert tbgmv.qrlora_bgmv_rows_cuda.launches == 0


# ---------------------------------------------------------------------------
# the masked local gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world,n_slots", [(2, 3), (4, 7)], ids=["world2", "world4"])
def test_local_rows_sum_to_the_table_rows(world, n_slots):
    """Each rank holds n_padded / world consecutive slots (3 → 4 at world 2,
    7 → 8 at world 4); the sum over ranks of the masked local gathers is
    bitwise ``table[seg]``, for seg ids on every shard and slot 0.  Dropping
    the rank offset must break it."""
    padded = -(-n_slots // world) * world
    rng = np.random.default_rng(world)
    tab = torch.from_numpy((rng.standard_normal((padded, R)) * 0.3).astype(np.float32))
    tab[0] = 0.0
    tab[n_slots:] = 0.0  # padding slots hold the base model
    seg = torch.tensor([0, *range(n_slots), n_slots - 1, 1, 0], dtype=torch.int32)
    shards = tab.chunk(world)
    got = sum(tbgmv.local_lam_rows(shards[i], seg, i) for i in range(world))
    assert torch.equal(got, tab[seg.long()])
    dropped = sum(tbgmv.local_lam_rows(shards[i], seg, 0) for i in range(world))
    assert not torch.equal(dropped, tab[seg.long()])


# ---------------------------------------------------------------------------
# the fused path in a world of one, against the reference on a 1-device mesh
# ---------------------------------------------------------------------------


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of one rank through a file store under
    ``tmp_path``, destroyed after the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    yield dist.group.WORLD
    dist.destroy_process_group()


@pytest.mark.parametrize("base", ["bf16", "int8"])
def test_fused_sharded_matches_jax_on_one_device(world_of_one, base):
    from jax.sharding import Mesh

    w_kind = "plain" if base == "bf16" else base
    (jx, jW, jws, jB, jA, jtab, jseg), (x, W, ws, B, A, tab, seg) = _operands(
        5, "bfloat16", w_kind)
    mesh = Mesh(np.array(jax.devices()[:1]), ("model",))
    want = np.asarray(j_fused_sharded(
        jx, jW, jB, jA, jtab, jseg, mesh=mesh, axis="model", scale=0.5,
        w_scale=None if base == "bf16" else jws, interpret=True), np.float32)
    tbgmv.reset_collective_counts()
    got = ops.qrlora_bgmv_sharded(x, W, B, A, tab, seg, group=world_of_one, scale=0.5,
                                  w_scale=None if base == "bf16" else ws)
    assert tbgmv.COLLECTIVES == {"all_reduce": 1, "all_gather": 0}
    np.testing.assert_array_equal(got.float().numpy(), want)
    # per-sequence seg of a (batch, S, K) input: every token takes its sequence's slot
    x3 = x.reshape(2, 4, K)
    y3 = ops.qrlora_bgmv_sharded(x3, W, B, A, tab, seg[:2], group=world_of_one, scale=0.5,
                                 w_scale=None if base == "bf16" else ws)
    assert torch.equal(y3.reshape(M, N), tref.qrlora_bgmv_rows_ref(
        x, W, ws, B, A, tab[seg[:2].long().repeat_interleave(4)], 0.5))


def test_ba_gather_world_of_one_is_exact(world_of_one):
    _, (_, _, _, B, A, _, _) = _operands(3, "float32", "plain")
    B2, A2 = tbgmv.ba_gather_sharded(B[None], A[None], world_of_one)
    assert torch.equal(B2[0], B) and torch.equal(A2[0], A)


@pytest.fixture(scope="module")
def jax_params():
    """Reduced float32 smollm-135m params initialised by the reference, and
    the same tree crossed into the port."""
    jp = jax_build(jax_reduced("smollm-135m").replace(dtype="float32")).init(
        jax.random.PRNGKey(5))
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def test_sharded_engine_matches_jax_sharded_engine(world_of_one, jax_params):
    """The slice as a whole: the port's engine with shard_lam and shard_ba
    in a world of one against the reference's engine with both on a
    1-device mesh, on the same params (crossed from JAX), λ and requests."""
    jcfg = jax_reduced("smollm-135m").replace(dtype="float32")
    cfg = get_reduced("smollm-135m").replace(dtype="float32")
    jp, tp = jax_params
    rng = np.random.default_rng(1)
    lam_shape = np.asarray(jp["groups"]["adapters"]["attn"]["wq"]["lam"]).shape
    lams = {f"t{i}": {"attn": {p: (rng.standard_normal(lam_shape) * 0.3).astype(np.float32)
                               for p in ("wq", "wv")}} for i in (1, 2)}
    reqs = [(BASE_TENANT, 6, 4), ("t1", 9, 5), ("t2", 7, 3)]
    prompts = [rng.integers(2, 256, size=P).astype(np.int32) for _, P, _ in reqs]
    common = dict(n_lanes=2, n_slots=4, max_len=32, collect_logits=True,
                  shard_lam=True, shard_ba=True)
    jeng = JEngine(jcfg, JEngineConfig(telemetry=False, **common), params=jp)
    teng = MultiTenantEngine(cfg, EngineConfig(**common), params=tp, device="cpu")
    for t, lam in lams.items():
        jeng.add_tenant(t, jax.tree_util.tree_map(jnp.asarray, lam))
        teng.add_tenant(t, lam)
    jsubs = [jeng.submit(t, p, g) for (t, _, g), p in zip(reqs, prompts)]
    kernels.reset_launch_counts()
    tsubs = [teng.submit(t, p, g) for (t, _, g), p in zip(reqs, prompts)]
    jeng.run()
    teng.run()
    worst = 0.0
    for js, ts in zip(jsubs, tsubs):
        assert js.tokens == ts.tokens
        worst = max(worst, float(np.abs(np.stack(js.logits) - np.stack(ts.logits)).max()))
    print(f"[parity] sharded engine vs JAX sharded engine: max|Δlogits| {worst:.2e}")
    assert worst <= LOGIT_TOL
    assert all(v == 0 for v in kernels.launch_counts().values())  # CPU: plain versions
    jax.clear_caches()


# ---------------------------------------------------------------------------
# the engine in 2- and 4-rank gloo process groups
# ---------------------------------------------------------------------------

# One rank of a gloo group: the reference test's traffic (float32 reduced
# smollm-135m, 2 lanes, 4 slots, tenants t1 and t2) through the sharded
# engine under each config, the local shard shapes asserted on every rank.
# With FAULT, rank 1 drops the rank offset of its local λ gather in one more
# run.  Only then, with the engines released and the group destroyed, does
# rank 0 run the replicated engine alone and write, per config, whether
# tokens and logits are bitwise equal: no rank waits in a collective while
# another works alone.
_RANK_SCRIPT = textwrap.dedent(
    """
    import datetime, gc, json, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, store, out, fault, timeout = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                               sys.argv[4], sys.argv[5] == "1",
                                               float(sys.argv[6]))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout))
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import qrlora_bgmv as tbgmv
    from repro_torch.serving import BASE_TENANT, EngineConfig, MultiTenantEngine

    cfg = get_reduced("smollm-135m").replace(dtype="float32")
    N_SLOTS, CAP = 4, cfg.adapter.rank_cap

    def run(**kw):
        eng = MultiTenantEngine(cfg, EngineConfig(n_lanes=2, n_slots=N_SLOTS, max_len=32,
                                                  collect_logits=True, **kw), device="cpu")
        lam_rng = np.random.default_rng(0)
        for i in (1, 2):
            eng.add_tenant(f"t{i}", {"attn": {p: (lam_rng.standard_normal(
                (cfg.n_layers, CAP)) * 0.3).astype(np.float32) for p in ("wq", "wv")}})
        rng = np.random.default_rng(3)
        subs = [eng.submit(t, rng.integers(2, cfg.vocab_size, size=P).astype(np.int32), G)
                for t, P, G in [(BASE_TENANT, 6, 4), ("t1", 9, 5), ("t2", 7, 3)]]
        eng.run()
        return eng, subs

    def shapes(eng, kw):
        tab = eng.lam_store._tables[("attn", "wq")]
        B = eng.params["groups"]["adapters"]["attn"]["wq"]["B"]
        A = eng.params["groups"]["adapters"]["attn"]["wq"]["A"]
        want_slots = N_SLOTS // world if kw.get("shard_lam") else N_SLOTS
        want_r = CAP // world if kw.get("shard_ba") else CAP
        return (tab.shape[-2] == want_slots and B.shape[-1] == want_r
                and A.shape[-2] == want_r and eng.lam_store.n_slots == N_SLOTS)

    def same(a, b):
        return all(x.tokens == y.tokens and np.array_equal(np.stack(x.logits),
                                                           np.stack(y.logits))
                   for x, y in zip(a, b))

    results, served = {}, {}
    configs = {"shard_lam": {"shard_lam": True}, "shard_ba": {"shard_ba": True},
               "both": {"shard_lam": True, "shard_ba": True}}
    for name, kw in configs.items():
        tbgmv.reset_collective_counts()
        eng, served[name] = run(**kw)
        assert shapes(eng, kw), (name, rank)
        results[name] = {"collectives": dict(tbgmv.COLLECTIVES),
                         "forwards": eng.steps + len(served[name])}
    if fault:
        sound = tbgmv.local_lam_rows
        if rank == 1:
            tbgmv.local_lam_rows = lambda tab, seg, r: sound(tab, seg, 0)
        served["fault"] = run(shard_lam=True)[1]
        results["fault"] = {}
        tbgmv.local_lam_rows = sound
    # the engines hold the group: let them go first, or the group's gloo
    # threads are torn down only at interpreter exit, which may abort
    del eng
    gc.collect()
    dist.destroy_process_group()
    if rank == 0:
        ref = run()[1]
        for name, subs in served.items():
            results[name]["equal"] = same(ref, subs)
        with open(out, "w") as f:
            json.dump(results, f)
    """
)


# A group run's wall-clock limit, and the gloo timeout of each collective
# (and of the rendezvous) inside it: under a loaded host a rank may wait
# long for a slower peer, but a hung collective still reports itself before
# the run is killed.
GROUP_LIMIT_S = 300
GLOO_TIMEOUT_S = 240


def _run_group(world: int, tmp: Path, fault: bool) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = tmp / "results.json"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_SCRIPT, str(r), str(world), str(tmp / "store"), str(out),
         "1" if fault else "0", str(GLOO_TIMEOUT_S)], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=GROUP_LIMIT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [f"rank {r} of {world} (exit {p.returncode}):\n{log}"
           for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode != 0]
    assert not bad, "\n".join(bad)
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """world → rank 0's results, each group run once (world 2 with the
    planted fault)."""
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = _run_group(world, tmp_path_factory.mktemp(f"world{world}"),
                                      fault=world == 2)
        return cache[world]

    return get


@pytest.mark.parametrize("config", ["shard_lam", "shard_ba", "both"])
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_engine_bit_identical_to_replicated(groups, world, config):
    """Rank 0's tokens and logits equal the replicated engine's bitwise; every
    rank asserted its table slice (n_slots / world slots) and its factor
    shards (r / world) in the subprocess.  Per adapted projection a forward
    issues one all-reduce under shard_lam and two all-gathers under
    shard_ba."""
    res = groups(world)[config]
    assert res["equal"], res
    n_proj = 2 * get_reduced("smollm-135m").n_layers  # wq and wv of every layer
    lam, ba = config in ("shard_lam", "both"), config in ("shard_ba", "both")
    want = {"all_reduce": n_proj * lam, "all_gather": 2 * n_proj * ba}
    assert res["collectives"] == {k: v * res["forwards"] for k, v in want.items()}


def test_sharded_engine_dropped_rank_offset_breaks_equality(groups):
    """The planted fault — rank 1 gathers its local rows without its rank
    offset — must make rank 0's serve differ from the replicated one."""
    assert groups(2)["fault"]["equal"] is False


# ---------------------------------------------------------------------------
# the engine's configuration and the entry point
# ---------------------------------------------------------------------------


def test_sharded_engine_needs_a_process_group():
    cfg = get_reduced("smollm-135m")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        MultiTenantEngine(cfg, EngineConfig(shard_lam=True), device="cpu")


def test_shard_ba_params_cuts_the_rank_dim(jax_params):
    tp = jax_params[1]
    parts = [shard_ba_params(tp, r, 2) for r in range(2)]
    for mod, projs in tp["groups"]["adapters"].items():
        for proj, leaf in projs.items():
            Bs = [p["groups"]["adapters"][mod][proj]["B"] for p in parts]
            As = [p["groups"]["adapters"][mod][proj]["A"] for p in parts]
            assert torch.equal(torch.cat(Bs, -1), leaf["B"])
            assert torch.equal(torch.cat(As, -2), leaf["A"])
            assert parts[0]["groups"]["adapters"][mod][proj]["lam"] is leaf["lam"]
    assert parts[0]["embed"] is tp["embed"]
    # a world that does not divide the rank cap leaves the factors whole
    assert not rules.rank_divides(tp, 3)
    leaf = shard_ba_params(tp, 1, 3)["groups"]["adapters"]["attn"]["wq"]
    assert leaf["B"] is tp["groups"]["adapters"]["attn"]["wq"]["B"]


def test_axis_rules_scope():
    assert rules.lam_slot_group() is None and rules.qr_rank_group() is None
    g = object()
    with rules.axis_rules(g, {"lam_slots": "model"}):
        assert rules.lam_slot_group() is g and rules.qr_rank_group() is None
        with rules.axis_rules(None, {"qr_rank": "model"}):
            assert rules.lam_slot_group() is None and rules.qr_rank_group() is None
        assert rules.lam_slot_group() is g
    assert rules.get_group() is None


def test_serve_multi_sharded_world_of_one_self_verifies(capsys):
    done = serve_multi.main(["--reduced", "--device", "cpu", "--shard-lam", "--shard-ba",
                             "--tenants", "3", "--lanes", "2", "--gen-len", "4",
                             "--prompt-len", "7", "--max-len", "32"])
    out = capsys.readouterr().out
    assert len(done) == 3 and "all 3 tenants match merged-weight refs" in out
    assert "λ tables sharded over 1 rank(s)" in out and "rank-sharded over 1 rank(s)" in out
    assert not dist.is_initialized()  # the group it started is gone
