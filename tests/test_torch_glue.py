"""The paper's GLUE pipeline in the PyTorch port against the JAX reference
(reduced roberta-base, float32, CPU): the synthetic GLUE data and metrics,
``run_glue_method`` in every adapter mode, ports of ``tests/test_system.py``,
the train launcher's ``--peft lora|svd_lora|ft`` against the JAX trainer,
and one paper-table bench at ``REPRO_BENCH_SCALE=smoke``.

Both runners start from the same backbone (the JAX params crossed with
``repro_torch.interop``), and LoRA's random A is the reference's own (its
draw crossed in for the port's ``lora_init_stacked``): the RNG streams
differ.  Bounds: the runner's final loss within ``LOSS_ATOL`` = 1e-5 of the
reference's (≤ 1.1e-6 read after 5 warm-up and 5 adapter steps; float32
sums in another order through Adam), trainable counts exact; the trainer's
per-step losses within ``TRAIN_LOSS_ATOL``.
"""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import table2_mrpc as j_table2
from repro.benchlib import run_glue_method as j_run_glue
from repro.configs import get_reduced as jax_reduced
from repro.core import lora as jlora
from repro.data import GLUE_TASKS as J_GLUE_TASKS
from repro.data import lm_batches as j_lm_batches
from repro.data import make_task as j_make_task
from repro.data import metrics as jmetrics
from repro.models import build_model as jax_build
from repro.optim import AdamWConfig as JAdamWConfig
from repro.training import init_train_state as j_init_state
from repro.training import make_train_step as j_make_step
from repro_torch.benchlib import run_glue_method
from repro_torch.benchmarks import common, run
from repro_torch.core import adapter_api as tadp
from repro_torch.data import GLUE_TASKS, make_task, synthetic
from repro_torch.data import metrics as tmetrics
from repro_torch.interop import params_from_jax
from repro_torch.launch import train as train_launch
from repro_torch.optim import AdamWConfig
from repro_torch.training import init_train_state, make_train_step

LOSS_ATOL = 1e-5
# per-step |Δloss| of the trainer over 4 steps, by mode: lora and svd_lora as
# QR-LoRA's (test_torch_training.py); ft updates every weight, where Adam
# turns float32 rounding in near-zero gradients into whole lr-sized steps,
# and the gap doubles each step (9.5e-7, 2.4e-6, 1.1e-5, 2.6e-5 read)
TRAIN_LOSS_ATOL = {"lora": 2e-5, "svd_lora": 2e-5, "ft": 1e-4}
MODES = ("qr_lora", "lora", "svd_lora", "ft", "none")
SMALL = dict(train_steps=5, warmup_steps=5, eval_batches=2, batch=8, seq=32)


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


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("task", sorted(J_GLUE_TASKS))
def test_glue_examples_and_batch_order_match_jax(task):
    """The same seed gives the same examples, labels and batch order: the
    first two shuffled train batches, a limited stream's third epoch and the
    first eval batch."""
    assert dataclasses.astuple(GLUE_TASKS[task]) == dataclasses.astuple(J_GLUE_TASKS[task])
    got, want = make_task(task, vocab=300, seq=40, seed=3), j_make_task(task, vocab=300, seq=40,
                                                                       seed=3)
    np.testing.assert_array_equal(got.topic_tokens, want.topic_tokens)
    for args in (("train", 8), ("eval", 8)):
        for g, w in zip(list(zip(range(2), got.batches(*args)))[:2],
                        list(zip(range(2), want.batches(*args)))[:2]):
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(g[1][k], w[1][k])
    g = list(got.batches("train", 4, epochs=3, limit=12))
    w = list(want.batches("train", 4, epochs=3, limit=12))
    assert len(g) == len(w) == 9
    for a, b in zip(g, w):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["labels"], b["labels"])


@pytest.mark.parametrize("metric", ["accuracy", "f1", "matthews", "pearson"])
def test_metrics_equal_jax(metric):
    rng = np.random.default_rng(0)
    for n in (1, 7, 64):
        if metric == "pearson":
            pred, label = rng.standard_normal(n), rng.standard_normal(n)
        else:
            pred, label = rng.integers(0, 2, n), rng.integers(0, 2, n)
        assert tmetrics.compute(metric, pred, label) == jmetrics.compute(metric, pred, label)
    zeros = np.zeros(5, int)
    assert tmetrics.compute(metric, zeros, zeros) == jmetrics.compute(metric, zeros, zeros)


def _jax_backbone(task, seed=0):
    cfg = jax_reduced("roberta_base").replace(n_classes=max(J_GLUE_TASKS[task].n_classes, 1))
    return _np(jax_build(cfg).init(jax.random.PRNGKey(seed), with_adapters=False))


@pytest.fixture
def jax_lora_draws(monkeypatch):
    """The port's LoRA init draws A as the reference's runner does (key
    ``fold_in(fold_in(fold_in(PRNGKey(seed), 1), hash("attn")), i)`` for the
    i-th projection in name order), crossed into torch."""
    calls = []

    def draw(gen, W, mask, acfg, dtype=torch.bfloat16):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 1),
                                 hash("attn") % (2**31))
        key = jax.random.fold_in(key, len(calls))
        calls.append(W.shape)
        jacfg = jax_reduced("roberta_base").adapter.replace(mode="lora", rank=acfg.rank)
        adp = jlora.lora_init_stacked(key, jnp.asarray(W.detach().numpy()), mask, jacfg,
                                      jnp.bfloat16)
        return params_from_jax(_np(adp), device="cpu")

    monkeypatch.setattr(tadp, "lora_init_stacked", draw)
    return calls


@pytest.mark.parametrize("mode", MODES)
def test_run_glue_method_matches_jax(mode, jax_lora_draws):
    """The whole pipeline (warm-up FT, adapters on the warmed-up weights,
    the adapter phase under cosine, eval) on mrpc from the same backbone:
    trainable count exact, final loss within ``LOSS_ATOL``, the same eval
    metric."""
    want = j_run_glue("mrpc", mode, seed=0, **SMALL)
    got = run_glue_method("mrpc", mode, seed=0, device="cpu",
                          init_params=params_from_jax(_jax_backbone("mrpc"), device="cpu"), **SMALL)
    print(f"[parity] glue mrpc {mode}: final loss {got['final_loss']:.7f} vs "
          f"{want['final_loss']:.7f}, metric {got['metric']:.4f} vs {want['metric']:.4f}")
    assert got["trainable"] == want["trainable"]
    assert abs(got["final_loss"] - want["final_loss"]) <= LOSS_ATOL
    assert got["metric"] == want["metric"] and got["accuracy"] == want["accuracy"]
    assert {k: got[k] for k in ("task", "mode", "metric_name")} == {
        k: want[k] for k in ("task", "mode", "metric_name")}
    assert len(got["losses"]) == len(got["warmup_losses"]) == 5
    assert got["losses"][-1] == got["final_loss"]
    assert bool(jax_lora_draws) == (mode == "lora")


def test_run_glue_method_regression_task_matches_jax():
    """stsb: one output, a squared-error loss and Pearson correlation."""
    kw = dict(SMALL, train_steps=3, warmup_steps=2)
    want = j_run_glue("stsb", "qr_lora", seed=0, **kw)
    got = run_glue_method("stsb", "qr_lora", seed=0, device="cpu",
                          init_params=params_from_jax(_jax_backbone("stsb"), device="cpu"), **kw)
    assert got["metric_name"] == "pearson" and got["trainable"] == want["trainable"]
    assert abs(got["final_loss"] - want["final_loss"]) <= LOSS_ATOL * max(1.0, want["final_loss"])
    assert abs(got["metric"] - want["metric"]) <= 1e-4


@pytest.mark.slow
def test_qr_lora_end_to_end_learns(monkeypatch):
    """Port of ``test_system.py::test_qr_lora_end_to_end_learns``, from the
    reference test's backbone (JAX ``PRNGKey(0)``).  Its data is seeded by
    ``hash("sst2")``, which changes with each process's ``PYTHONHASHSEED``,
    and at this scale about 1 draw in 20 does not learn in either package
    (ROADMAP Queue 3); the task-name hash is pinned to its CRC-32 here so
    that the run is the same in every process."""
    monkeypatch.setattr(synthetic, "hash", lambda name: zlib.crc32(name.encode()), raising=False)
    res = run_glue_method(
        "sst2", "qr_lora", seed=0, train_steps=80, warmup_steps=50,
        eval_batches=8, batch=16, seq=32, device="cpu",
        init_params=params_from_jax(_jax_backbone("sst2"), device="cpu"),
    )
    assert res["metric"] > 0.55, res  # beats chance on a binary task
    assert res["trainable"] < 5000


def test_param_count_ordering_matches_paper():
    """Port of ``test_system.py::test_param_count_ordering_matches_paper``:
    FT ≫ LoRA > QR-LoRA, at reduced scale."""
    counts = {}
    for mode in ("ft", "lora", "qr_lora"):
        r = run_glue_method(
            "mrpc", mode, seed=0, train_steps=2, warmup_steps=2,
            eval_batches=1, batch=8, seq=32, device="cpu",
        )
        counts[mode] = r["trainable"]
    assert counts["qr_lora"] < counts["lora"] < counts["ft"]
    assert counts["ft"] / counts["qr_lora"] > 100


@pytest.mark.parametrize("peft", ["lora", "svd_lora", "ft"])
def test_train_launcher_peft_matches_jax_trainer(peft, capsys):
    """``launch/train.py --peft`` on reduced smollm-135m (float32): the
    launcher's own step, optimizer and data against the JAX trainer for 4
    steps from the same params (LoRA's B made nonzero so that A trains from
    the first step), and the launcher run to its end printing the
    reference launcher's trainable count."""
    jcfg = jax_reduced("smollm-135m").replace(dtype="float32")
    jcfg = jcfg.replace(adapter=jcfg.adapter.replace(mode=peft))
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    if peft == "lora":
        rng = np.random.default_rng(1)
        jp = _np(jp)
        for leaf in jp["groups"]["adapters"]["attn"].values():
            leaf["B"] = jnp.asarray(rng.standard_normal(leaf["B"].shape) * 0.05, jnp.bfloat16)
        jp = jax.tree_util.tree_map(jnp.asarray, jp)
    steps, lr = 4, 3e-3
    jopt = JAdamWConfig(lr=lr, schedule=lambda s: lr)
    jstate = j_init_state(jm, jax.random.PRNGKey(0), params=jp)
    jstep = jax.jit(j_make_step(jm, jopt))
    tm = train_launch.build("smollm-135m", True, "cpu", "float32", peft=peft)
    state = init_train_state(tm, params=params_from_jax(_np(jp), device="cpu"))
    step = make_train_step(tm, AdamWConfig(lr=lr, schedule=lambda s: lr))
    data = train_launch.batches(tm.cfg, 4, 16, 0, "cpu")
    jdata = j_lm_batches(jcfg.vocab_size, 4, 16, seed=0)
    for _ in range(steps):
        jb = next(jdata)
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(jb["tokens"][:, :16])})
        state, met = step(state, next(data))
        print(f"[parity] train --peft {peft}: loss {float(met['loss']):.6f} |Δ| "
              f"{abs(float(met['loss']) - float(jmet['loss'])):.2e}")
        assert abs(float(met["loss"]) - float(jmet["loss"])) <= TRAIN_LOSS_ATOL[peft]
    n_train = tm.count_trainable({"groups": state["trainable"]["groups"]})
    assert n_train == jm.count_trainable({"groups": jstate["trainable"]["groups"]})
    _, hist = train_launch.main(["--reduced", "--device", "cpu", "--peft", peft, "--steps", "2",
                                 "--batch", "2", "--seq", "8", "--log-every", "1"])
    out = capsys.readouterr().out
    assert f"peft={peft}" in out and f"trainable params: {n_train}" in out
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)


def test_table_bench_runs_at_smoke_scale(monkeypatch, capsys):
    """``repro_torch.benchmarks.run --only table2_mrpc`` at
    ``REPRO_BENCH_SCALE=smoke`` on the CPU: the reference's row names, in
    its order, with finite metrics and the reference runner's trainable
    counts for the same configs."""
    monkeypatch.setenv("REPRO_BENCH_SCALE", "smoke")
    assert common.kw() == dict(reduced=True, train_steps=10, warmup_steps=5, eval_batches=2,
                               batch=8, seq=32)
    run.main(["--only", "table2_mrpc", "--device", "cpu"])
    rows = [r.split(",", 2) for r in common.rows()]
    names = [f"table2_mrpc:{m}:tau={kw.get('tau', '-')}:{'+'.join(kw.get('targets', ('all',)))}"
             f":{kw.get('layers', '-')}" for m, kw in j_table2.CONFIGS]
    assert [r[0] for r in rows] == names
    for (name, us, derived), (mode, kw) in zip(rows, j_table2.CONFIGS):
        fields = dict(kv.split("=") for kv in derived.split(";"))
        assert float(us) > 0 and 0.0 <= float(fields["f1"]) <= 1.0
        if mode != "ft":  # counts are the reference runner's (ft: ≈ 350k, checked above)
            want = j_run_glue("mrpc", mode, seed=0, train_steps=0, warmup_steps=0,
                              eval_batches=1, batch=8, seq=32, **kw)["trainable"]
            assert int(fields["trainable"]) == want, name
    assert "# all benchmarks complete" in capsys.readouterr().out
