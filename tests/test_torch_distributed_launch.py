"""The port's training mesh against the reference's: the train launcher
and the elastic reshard (the harness is ``test_torch_distributed.py``'s).

* ``launch.train --arch mixtral-8x22b --reduced --model-parallel 2`` (in
  float32) on 4 ranks against ``repro.launch.train`` on 4 virtual devices
  (both a 2×2 mesh), from the reference's initial state (the port's run
  restores it from a step-0 checkpoint in the reference's format): each
  step's loss within 1e-5; rank 0 writes the final checkpoint, the global
  tree in the reference's format, which the reference restores.
* the reshard (``tests/test_distributed.py:62-75``): reduced mixtral's
  QR-LoRA params placed on a 2×2 fsdp mesh, checkpointed (rank 0 writes the
  gathered tree) and restored on a 4×1 mesh: every rank's blocks are its
  cut of the original leaves, and gathered back they are the original
  leaves bitwise.
"""
import pytest
from test_torch_distributed import (
    JAX_PRELUDE,
    LOSS_ATOL,
    RANK_EPILOGUE,
    RANK_PRELUDE,
    max_err,
    run_world,
)

BATCH, SEQ, STEPS = 4, 16, 3

_JAX = JAX_PRELUDE + f'''
from repro.checkpoint import CheckpointManager
from repro.configs import get_reduced
from repro.launch import train as launch_train
from repro.models import build_model
from repro.training import init_train_state

cfg = get_reduced("mixtral_8x22b").replace(dtype="float32")
model = build_model(cfg)
# the launcher's initial state, as repro.launch.train makes it
params = model.init(jax.random.PRNGKey(0))
state = init_train_state(model, None, params=params)
CheckpointManager(f"{{tmp}}/port_ckpt").save(0, state)
save(f"{{tmp}}/inputs.npz", {{"params": params}})

real = launch_train.get_reduced
launch_train.get_reduced = lambda arch: real(arch).replace(dtype="float32")
hist = launch_train.main(["--arch", "mixtral-8x22b", "--reduced", "--model-parallel", "2",
                          "--steps", "{STEPS}", "--batch", "{BATCH}", "--seq", "{SEQ}",
                          "--log-every", "1", "--ckpt-dir", f"{{tmp}}/jax_ckpt"])
ref = {{"launch": {{"loss": np.asarray([h["loss"] for h in hist])}}}}
# the port's last checkpoint, restored by the reference
while not os.path.exists(f"{{tmp}}/port_done"):
    __import__("time").sleep(0.05)
ckpt = CheckpointManager(f"{{tmp}}/port_ckpt")
restored, meta = ckpt.restore(state)
ref["port_ckpt"] = {{"step": np.asarray(meta["step"]), "trainable": restored["trainable"],
                    "frozen": restored["frozen"]}}
save(f"{{tmp}}/ref.npz", ref)
'''

_RANKS = RANK_PRELUDE + f'''
from repro_torch.checkpoint import MeshCheckpointManager
from repro_torch.checkpoint.reshard import reshard_to_mesh
from repro_torch.launch import train as launch_train

wait_for(f"{{tmp}}/inputs.npz")
params = params_from_jax(load(f"{{tmp}}/inputs.npz")["params"], "cpu")

# the reshard: 2×2 fsdp → checkpoint → 4×1
mesh = make_mesh((2, 2), ("data", "model"))
placed = reshard_to_mesh(params, "cpu", mesh=mesh, fsdp=True)
with shrules.axis_rules(mesh, fsdp=True):
    MeshCheckpointManager(f"{{tmp}}/reshard", shrules.mesh_specs(params)).save(1, placed)
mesh2 = make_mesh((4, 1), ("data", "model"))
with shrules.axis_rules(mesh2, fsdp=True):
    specs2 = shrules.mesh_specs(params)
    restored, meta = MeshCheckpointManager(f"{{tmp}}/reshard", specs2).restore(params)
    want = shrules.local_blocks(params, specs2)
    blocks = [np.array_equal(a, b) for a, b in zip(flatten(tree_map(n, restored)).values(),
                                                    flatten(tree_map(n, want)).values())]
    whole = coll.gather_blocks(restored, specs2)
results["reshard"] = {{
    "blocks_equal": np.bool_(all(blocks)),
    "cut": np.asarray([placed["groups"]["moe"]["we_gate"].shape[-2:],
                       restored["groups"]["moe"]["we_gate"].shape[-2:]]),
    "whole_equal": np.bool_(meta["step"] == 1 and all(
        np.array_equal(a, b) for a, b in zip(flatten(tree_map(n, whole)).values(),
                                              flatten(tree_map(n, params)).values())))}}

# the launcher, from the reference's initial state
wait_for(f"{{tmp}}/port_ckpt/step_0/manifest.json")
real = launch_train.get_reduced
launch_train.get_reduced = lambda arch: real(arch).replace(dtype="float32")
_, hist = launch_train.main(["--arch", "mixtral-8x22b", "--reduced", "--model-parallel", "2",
                             "--steps", "{STEPS}", "--batch", "{BATCH}", "--seq", "{SEQ}",
                             "--log-every", "0", "--device", "cpu",
                             "--ckpt-dir", f"{{tmp}}/port_ckpt"])
results["launch"] = {{"loss": np.asarray([h["loss"] for h in hist])}}
dist.barrier()
if rank == 0:
    open(f"{{tmp}}/port_done", "w").close()
''' + RANK_EPILOGUE


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    return run_world(_JAX, _RANKS, tmp_path_factory.mktemp("mesh_launch"))


def test_launcher_on_the_mesh_matches_the_reference_launcher(readings):
    ref, ranks = readings
    want = ref["launch"]["loss"]
    assert want.shape == (STEPS,)
    for r, got in enumerate(ranks):
        assert got["launch"]["loss"].shape == want.shape, r
        assert max_err(got["launch"]["loss"], want) <= LOSS_ATOL, (r, got["launch"]["loss"], want)


def test_launcher_checkpoint_is_the_global_tree_the_reference_restores(readings):
    """Rank 0 wrote step 3 as the whole tree: the reference restores it, its
    expert stacks whole, its λ moved from the initial 0."""
    ref, _ = readings
    ck = ref["port_ckpt"]
    assert int(ck["step"]) == STEPS
    assert ck["frozen"]["groups"]["moe"]["we_gate"].shape[-2:] == (64, 64)
    lam = ck["trainable"]["groups"]["adapters"]["attn"]["wq"]["lam"]
    assert abs(lam).max() > 0


def test_checkpoint_on_one_mesh_restores_on_another(readings):
    _, ranks = readings
    for got in ranks:
        rs = got["reshard"]
        # d 64 over 2 data ranks, f 64 over 2 model ranks; then d over 4
        assert rs["cut"].tolist() == [[32, 32], [16, 64]], rs["cut"]
        assert bool(rs["blocks_equal"]) and bool(rs["whole_equal"])
