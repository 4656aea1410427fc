"""The port's fault-tolerant train loop (``repro_torch.runtime``) against
the reference's ``repro.runtime``: the four cases of
``tests/test_fault_tolerance.py`` on the quadratic; on reduced smollm-135m
(float32) through the train launcher's functions, a crashed run and a
preempted run resumed by a new runner end bitwise the uninterrupted run
(λ and Adam's m and v), and the same crash through the port's runner and
through ``repro.runtime.TrainLoopRunner`` over ``repro``'s train step ends
within the trainer's parity bound; the launcher's batches from any start;
``launch.train.main`` resumed from its checkpoint directory bitwise a
straight run."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_reduced as jax_reduced
from repro.data import lm_batches as j_lm_batches
from repro.models import build_model as jax_build
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import make_schedule as j_make_schedule
from repro.runtime import TrainLoopRunner as JTrainLoopRunner
from repro.training import init_train_state as j_init_state
from repro.training import make_train_step as j_make_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_reduced
from repro_torch.interop import params_from_jax
from repro_torch.launch import train as train_launch
from repro_torch.models import build_model
from repro_torch.runtime import StragglerMonitor, TrainLoopRunner
from repro_torch.training import init_train_state
from repro_torch.tree import tree_leaves

# the same 6 steps with a crash at step 3, through the two packages' runners
# from the same params: float32 λ within this bound.  The trainer's parity
# over 30 steps is loss ≤ 1.4e-6, λ ≤ 8e-8 (tests/test_torch_training.py);
# read 8.6e-9 here; the bound leaves > 100× for summation order.
RUNNER_LAM_ATOL = 1e-6
STEPS, SAVE_EVERY, CRASH_AT, PREEMPT_AT, BATCH, SEQ, LR = 6, 2, 3, 4, 2, 16, 3e-3


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Torch's CPU ops on two threads in this module (the suite's parallel
    workers oversubscribe larger OpenMP teams)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _quiet(*_):
    pass


# ---------------------------------------------------------------------------
# tests/test_fault_tolerance.py, on the port
# ---------------------------------------------------------------------------


def _quadratic_setup(tmp_path):
    state = {"w": torch.tensor([4.0, -4.0]), "step_marker": torch.tensor(0)}

    def step_fn(state, batch):
        w = state["w"] - 0.05 * 2 * state["w"]
        return {"w": w, "step_marker": state["step_marker"] + 1}, {"loss": torch.sum(w**2)}

    def make_batches(start):
        def gen():
            i = start
            while True:
                yield {"i": i}
                i += 1

        return gen()

    ckpt = CheckpointManager(str(tmp_path), keep=2)
    return state, step_fn, make_batches, ckpt


def test_runner_completes_and_saves(tmp_path):
    state, step_fn, mb, ckpt = _quadratic_setup(tmp_path)
    runner = TrainLoopRunner(step_fn, mb, ckpt, save_every=10, log_every=100, log_fn=_quiet)
    final, step, _ = runner.run(state, 25)
    assert step == 25
    assert ckpt.latest_step() == 25
    assert float(torch.sum(final["w"] ** 2)) < float(torch.sum(state["w"] ** 2))


def test_crash_recovery_resumes_from_checkpoint(tmp_path):
    state, step_fn, mb, ckpt = _quadratic_setup(tmp_path)
    crashed = {"done": False}

    def injector(step):
        if step == 17 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("simulated node failure")

    runner = TrainLoopRunner(step_fn, mb, ckpt, save_every=5, log_every=100,
                             failure_injector=injector, log_fn=_quiet)
    final, step, _ = runner.run(state, 30)
    assert step == 30
    assert runner.restarts == 1
    # replay determinism: the same result as an uninterrupted run, bitwise
    state2, step_fn2, mb2, ckpt2 = _quadratic_setup(tmp_path / "clean")
    runner2 = TrainLoopRunner(step_fn2, mb2, ckpt2, save_every=5, log_every=100, log_fn=_quiet)
    final2, _, _ = runner2.run(state2, 30)
    assert torch.equal(final["w"], final2["w"])
    assert int(final["step_marker"]) == int(final2["step_marker"]) == 30


def test_preemption_checkpoints_and_exits(tmp_path):
    state, step_fn, mb, ckpt = _quadratic_setup(tmp_path)
    runner = TrainLoopRunner(step_fn, mb, ckpt, save_every=1000, log_every=1000, log_fn=_quiet)

    def injector(step):
        if step == 12:
            runner._preempted = True  # what the SIGTERM handler does

    runner.failure_injector = injector
    _, step, _ = runner.run(state, 100)
    assert step == 12
    assert ckpt.latest_step() == 12


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(k=3.0, warmup=3)
    for i in range(20):
        assert not mon.observe(i, 0.10 + 0.001 * (i % 3))
    assert mon.observe(20, 1.0)  # 10× step time → straggler
    assert len(mon.events) == 1


# ---------------------------------------------------------------------------
# reduced smollm-135m through the launcher's functions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    """Reduced smollm-135m float32 params from one JAX init, numpy leaves."""
    jcfg = jax_reduced("smollm-135m").replace(dtype="float32")
    return jcfg, jax.tree_util.tree_map(np.asarray, jax_build(jcfg).init(jax.random.PRNGKey(0)))


def _port_run(weights, root, crash_at=None, preempt_at=None, total=STEPS):
    """The port's runner over the launcher's step (``make_step``: AdamW under
    the launcher's cosine schedule) and batches, from λ = 0."""
    _, npj = weights
    model = build_model(get_reduced("smollm-135m").replace(dtype="float32"), "cpu")
    crashed = []

    def inject(step):
        if step == crash_at and not crashed:
            crashed.append(step)
            raise RuntimeError("simulated node failure")
        if step == preempt_at:
            runner._preempted = True

    runner = TrainLoopRunner(
        train_launch.make_step(model, LR, STEPS),
        lambda start: train_launch.batches(model.cfg, BATCH, SEQ, 0, "cpu", start),
        CheckpointManager(str(root), keep=3), save_every=SAVE_EVERY, log_every=1,
        failure_injector=inject, log_fn=_quiet)
    state, step, hist = runner.run(init_train_state(model, params=params_from_jax(npj, "cpu")),
                                   total)
    return runner, state, step, hist


def _leaves(state):
    return (tree_leaves(state["trainable"]) + tree_leaves(state["opt"]["m"])
            + tree_leaves(state["opt"]["v"]))


def _bitwise(a, b):
    assert a["opt"]["step"] == b["opt"]["step"]
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x.detach(), y.detach())


@pytest.fixture(scope="module")
def straight(weights, tmp_path_factory):
    return _port_run(weights, tmp_path_factory.mktemp("straight"))


def test_crash_recovery_is_bitwise_the_uninterrupted_run(weights, straight, tmp_path):
    runner, state, step, hist = _port_run(weights, tmp_path, crash_at=CRASH_AT)
    assert step == STEPS and runner.restarts == 1
    _bitwise(state, straight[1])
    # the replayed steps log again: steps 1-3 from the first try, 3-6 after
    assert [h["step"] for h in hist] == [1, 2, 3, 3, 4, 5, 6]
    assert [h["loss"] for h in hist[3:]] == [h["loss"] for h in straight[3][2:]]
    assert all(p.requires_grad for p in tree_leaves(state["trainable"]))


def test_preempted_run_resumes_bitwise(weights, straight, tmp_path):
    runner, _, step, _ = _port_run(weights, tmp_path, preempt_at=PREEMPT_AT)
    assert step == PREEMPT_AT and runner.ckpt.latest_step() == PREEMPT_AT
    runner, state, step, _ = _port_run(weights, tmp_path)  # a new process's runner
    assert step == STEPS and runner.restarts == 0
    _bitwise(state, straight[1])


def test_port_runner_against_the_reference_runner(weights, straight, tmp_path):
    """The same crash through ``repro.runtime.TrainLoopRunner`` over the
    reference's jitted train step and ``lm_batches``, from the same params:
    λ within RUNNER_LAM_ATOL of the port's runner's."""
    jcfg, npj = weights
    jm = jax_build(jcfg)
    jckpt = JCheckpointManager(str(tmp_path), keep=3)
    opt = JAdamWConfig(lr=LR, schedule=j_make_schedule(
        "cosine", LR, warmup_steps=max(10, STEPS // 20), total_steps=STEPS))
    crashed = []

    def inject(step):
        if step == CRASH_AT and not crashed:
            crashed.append(step)
            # the reference's runner looks for the newest checkpoint without
            # waiting for an async save still writing; wait here so the
            # replay starts from the save the port's runner restores
            jckpt.wait()
            raise RuntimeError("simulated node failure")

    def make_batches(start):
        it = j_lm_batches(jcfg.vocab_size, BATCH, SEQ, seed=0, start_step=start)
        return ({"tokens": jnp.asarray(b["tokens"][:, :SEQ])} for b in it)

    jrunner = JTrainLoopRunner(jax.jit(j_make_step(jm, opt)), make_batches, jckpt,
                               save_every=SAVE_EVERY, log_every=100, failure_injector=inject,
                               log_fn=_quiet)
    jstate, jstep, _ = jrunner.run(j_init_state(jm, None, params=jax.tree_util.tree_map(
        jnp.asarray, npj)), STEPS)
    runner, state, step, _ = _port_run(weights, tmp_path / "port", crash_at=CRASH_AT)
    assert jstep == step == STEPS and jrunner.restarts == runner.restarts == 1
    assert int(jstate["opt"]["step"]) == state["opt"]["step"] == STEPS
    want = jstate["trainable"]["groups"]["adapters"]["attn"]
    got = state["trainable"]["groups"]["adapters"]["attn"]
    worst = max(float(np.abs(np.asarray(want[p]["lam"]) - got[p]["lam"].detach().numpy()).max())
                for p in ("wq", "wv"))
    print(f"[parity] runner with a crash at step {CRASH_AT}: λ max|Δ| {worst:.2e}")
    assert worst <= RUNNER_LAM_ATOL


@pytest.mark.parametrize("arch", ["smollm-135m", "musicgen-medium", "llama-3.2-vision-11b"])
def test_batches_from_any_start_are_the_straight_streams(arch):
    """Batch s of ``batches(start_step=s')`` for s' ≤ s is the straight
    stream's batch s: the tokens, and the audio frames and vlm images that
    one generator draws across the stream."""
    cfg = get_reduced(arch)
    straight_run = [b for _, b in zip(range(5), train_launch.batches(cfg, 2, 8, 3, "cpu"))]
    for start in (1, 3):
        for got, want in zip(train_launch.batches(cfg, 2, 8, 3, "cpu", start),
                             straight_run[start:]):
            assert got.keys() == want.keys()
            for k in got:
                assert torch.equal(got[k], want[k]), (arch, start, k)


def test_launcher_resumes_bitwise_a_straight_run(tmp_path):
    """``main`` for 4 steps, then for 8 in the same ``--ckpt-dir``: the second
    run restores step 4 and ends with λ bitwise a straight 8-step run's (all
    8 steps lie in the schedule's 10 warm-up steps, whatever ``--steps``)."""
    argv = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "8", "--log-every", "0",
            "--save-every", "2"]
    _, first = train_launch.main([*argv, "--steps", "4", "--ckpt-dir", str(tmp_path / "run")])
    state, rest = train_launch.main([*argv, "--steps", "8", "--ckpt-dir", str(tmp_path / "run")])
    whole, hist = train_launch.main([*argv, "--steps", "8", "--ckpt-dir",
                                     str(tmp_path / "straight")])
    assert (len(first), len(rest), len(hist)) == (4, 4, 8)
    assert [h["loss"] for h in first + rest] == [h["loss"] for h in hist]
    _bitwise(state, whole)
