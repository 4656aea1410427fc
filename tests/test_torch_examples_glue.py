"""``examples/glue_comparison_torch.py`` on the CPU against
``examples/glue_comparison.py`` on the same arguments (``--tasks mrpc
--steps 2``: the table's five methods after the examples' 30 warm-up
steps), from the same backbone (the reference runner's draw, crossed into
the port) and LoRA's A drawn as the reference's runner draws it.

The reference's five runs compile for ≈ 40 s on this CPU, so each case
runs one row of the table for real on both sides and hands the example the
others' rows as stubs: rows 0-1 here, rows 2-3 in
``test_torch_examples_glue_b.py`` and row 4 in ``test_torch_examples_glue_c.py``
(each file well inside its time budget alone).

Bounds: the row's trainable-parameter count exact, and its metric within
1e-4 of the reference's (both read the same eval batches; the float32
training sums in another order through Adam: ``test_torch_glue.py`` reads
final losses within 1.1e-6 on this pipeline)."""
import copy
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_examples import example

from repro.configs import get_reduced as jax_reduced
from repro.core import lora as jlora
from repro.data import GLUE_TASKS as J_GLUE_TASKS
from repro.models import build_model as jax_build
from repro_torch.core import adapter_api as tadp
from repro_torch.interop import params_from_jax

METRIC_ATOL = 1e-4
ARGV = ["--tasks", "mrpc", "--steps", "2"]
N_ROWS = 5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


@functools.lru_cache(maxsize=None)
def _jax_backbone(task, seed=0):
    cfg = jax_reduced("roberta_base").replace(n_classes=max(J_GLUE_TASKS[task].n_classes, 1))
    params = jax_build(cfg).init(jax.random.PRNGKey(seed), with_adapters=False)
    return params_from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")


def check_row(row: int, monkeypatch):
    """Row ``row`` of both examples' tables, run for real on both sides."""
    ref, want = example("glue_comparison"), []
    sound = ref.run_glue_method
    calls = [0]

    def ref_run(task, mode, **kw):
        calls[0] += 1
        if calls[0] - 1 != row:
            return {"task": task, "mode": mode, "metric": float("nan"), "trainable": -1}
        want.append(sound(task, mode, **kw))
        return want[-1]

    monkeypatch.setattr(ref, "run_glue_method", ref_run)
    monkeypatch.setattr(sys, "argv", [ref.__file__, *ARGV])
    ref.main()

    def lora_draw(gen, W, mask, acfg, dtype=torch.bfloat16):
        """The reference runner's LoRA A (its i-th projection's key), crossed."""
        key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 1),
                                 hash("attn") % (2**31))
        key = jax.random.fold_in(key, lora_draw.calls)
        lora_draw.calls += 1
        jacfg = jax_reduced("roberta_base").adapter.replace(mode="lora", rank=acfg.rank)
        adp = jlora.lora_init_stacked(key, jnp.asarray(W.detach().numpy()), mask, jacfg,
                                      jnp.bfloat16)
        return params_from_jax(jax.tree_util.tree_map(np.asarray, adp), device="cpu")

    lora_draw.calls = 0
    monkeypatch.setattr(tadp, "lora_init_stacked", lora_draw)
    port = example("glue_comparison_torch")
    sound_port, port_calls = port.run_glue_method, [0]

    def port_run(task, mode, **kw):
        port_calls[0] += 1
        if port_calls[0] - 1 != row:
            return {"task": task, "mode": mode, "metric": float("nan"), "trainable": -1}
        return sound_port(task, mode, init_params=copy.deepcopy(_jax_backbone(task)), **kw)

    monkeypatch.setattr(port, "run_glue_method", port_run)
    rows = port.main([*ARGV, "--device", "cpu"])
    assert len(rows) == N_ROWS and calls[0] == port_calls[0] == N_ROWS and len(want) == 1
    assert lora_draw.calls == (1 if want[0]["mode"] == "lora" else 0)  # LoRA's wq
    name, task, metric, trainable = rows[row]
    assert task == want[0]["task"] == "mrpc", name
    assert trainable == want[0]["trainable"], name
    assert abs(metric - want[0]["metric"]) <= METRIC_ATOL, (name, metric, want[0]["metric"])


@pytest.mark.parametrize("row", [0, 1], ids=["qr_lora_wq_wv", "qr_lora_wq"])
def test_glue_comparison_row_matches_the_reference(row, monkeypatch):
    check_row(row, monkeypatch)
