"""The port's examples (``examples/*_torch.py``) on the CPU against the
reference's examples on the same arguments.

Both sides run float32 (the reduced configs' bf16 would let two
frameworks' greedy streams part at near-ties) from the same weights: the
reference's own draws (``PRNGKey(0)`` for the model, its λ draws in
serve_multi_tenant) crossed into the port with ``repro_torch.interop``;
the two packages' RNG streams differ.  Bounds:

* quickstart: the trainable count exact; its 30 losses within 1e-5 of the
  reference's (float32 through Adam: ``test_torch_training.py`` reads
  1.5e-6 on the same run);
* serve_lm: the same tokens;
* train_lm (3 steps, temporary ``--ckpt-dir``): the same steps, losses
  within 1e-5; its default checkpoint directory is not the reference's.

serve_multi_tenant and glue_comparison are held in
``test_torch_examples_serve.py`` and ``test_torch_examples_glue.py``
(each file stays well inside its time budget alone).
"""
import importlib.util
import os
import re
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.launch.serve as j_serve
import repro.launch.train as j_train
from repro.configs import get_reduced as jax_reduced
from repro.models import build_model as jax_build
from repro_torch.configs import get_reduced
from repro_torch.interop import params_from_jax
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models.model_zoo import Model

ROOT = Path(__file__).resolve().parents[1]
LOSS_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def example(name: str):
    """``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_f32(name, **kw):
    return jax_reduced(name, **kw).replace(dtype="float32")


def port_f32(name, **kw):
    return get_reduced(name, **kw).replace(dtype="float32")


@pytest.fixture(scope="module")
def smollm_f32():
    """The reference examples' weights: reduced smollm-135m in float32 from
    ``PRNGKey(0)``, crossed into the port."""
    jp = jax_build(jax_f32("smollm-135m")).init(jax.random.PRNGKey(0))
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def recording(make_train_step, losses: list):
    """``make_train_step`` whose (jitted) steps report each step's loss to
    ``losses`` through a host callback."""
    def make(model, opt_cfg):
        step = make_train_step(model, opt_cfg)

        def recorded(state, batch):
            new, metrics = step(state, batch)
            jax.debug.callback(lambda loss: losses.append(float(loss)), metrics["loss"])
            return new, metrics

        return recorded

    return make


def run_reference(monkeypatch, mod, argv=()):
    """A reference example's ``main()``, which reads ``sys.argv``."""
    monkeypatch.setattr(sys, "argv", [mod.__file__, *argv])
    return mod.main()


def crossed_init(monkeypatch, params):
    """The port's ``Model.init`` returning ``params`` (the reference's draw)."""
    monkeypatch.setattr(Model, "init", lambda self, gen, with_adapters=True: params)


def test_quickstart_matches_the_reference(monkeypatch, capsys, smollm_f32):
    ref = example("quickstart")
    want = []
    monkeypatch.setattr(ref, "get_reduced", jax_f32)
    monkeypatch.setattr(ref, "make_train_step", recording(ref.make_train_step, want))
    run_reference(monkeypatch, ref)
    want_n = int(re.search(r"trainable λ parameters: (\d+)", capsys.readouterr().out).group(1))

    port = example("quickstart_torch")
    sound_init = port.init_train_state
    monkeypatch.setattr(port, "get_reduced", port_f32)
    monkeypatch.setattr(port, "init_train_state",
                        lambda model, gen: sound_init(model, params=smollm_f32))
    n, got = port.main(["--device", "cpu"])
    assert n == want_n
    assert len(got) == len(want) == 30
    assert max(abs(a - b) for a, b in zip(got, want)) <= LOSS_ATOL
    assert "done — λ moved, backbone untouched." in capsys.readouterr().out


def test_serve_lm_matches_the_reference(monkeypatch, smollm_f32):
    ref, want = example("serve_lm"), []
    sound = ref.serve_main
    monkeypatch.setattr(j_serve, "get_reduced", jax_f32)
    monkeypatch.setattr(ref, "serve_main", lambda argv: want.append(sound(argv)))
    run_reference(monkeypatch, ref)

    monkeypatch.setattr(t_serve, "get_reduced", port_f32)
    crossed_init(monkeypatch, smollm_f32)
    got = example("serve_lm_torch").main(["--device", "cpu"])
    assert got.shape == (4, 24)
    np.testing.assert_array_equal(got, want[0])


def test_train_lm_matches_the_reference(monkeypatch, tmp_path, smollm_f32):
    ref, want = example("train_lm"), []
    monkeypatch.setattr(j_train, "get_reduced", jax_f32)
    monkeypatch.setattr(j_train, "make_train_step", recording(j_train.make_train_step, want))
    run_reference(monkeypatch, ref, ["--steps", "3", "--ckpt-dir", str(tmp_path / "ref")])

    sound_init = t_train.init_train_state
    monkeypatch.setattr(t_train, "get_reduced", port_f32)
    monkeypatch.setattr(t_train, "init_train_state",
                        lambda model, gen: sound_init(model, params=smollm_f32))
    _, hist = example("train_lm_torch").main(
        ["--device", "cpu", "--steps", "3", "--ckpt-dir", str(tmp_path / "port")])
    assert len(hist) == len(want) == 3
    assert max(abs(h["loss"] - w) for h, w in zip(hist, want)) <= LOSS_ATOL


def test_train_lm_default_ckpt_dir_is_not_the_references():
    """The launcher restores whatever it finds in its checkpoint directory,
    so a port run must never default to the reference's."""
    port, ref = example("train_lm_torch"), example("train_lm")
    assert port.DEFAULT_CKPT_DIR == os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")
    src = (ROOT / "examples" / "train_lm.py").read_text()
    ref_default = re.search(r'"--ckpt-dir", default="([^"]+)"', src).group(1)
    assert ref_default == "/tmp/repro_train_lm" and port.DEFAULT_CKPT_DIR != ref_default
    assert ref.__name__ != port.__name__
