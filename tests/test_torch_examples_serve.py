"""``examples/serve_multi_tenant_torch.py`` on the CPU against
``examples/serve_multi_tenant.py`` on the same arguments (2 tenants, 4
tokens each: below the reference's defaults, for time), float32, from the
reference's weights and λ draws crossed into the port: the same tokens for
every request, and the port's self-verify against the merged-weight
references passes (its launcher exits otherwise).  Helpers and bounds as in
``test_torch_examples.py``."""
import jax
import numpy as np
import pytest
import torch
from test_torch_examples import crossed_init, example, run_reference, smollm_f32  # noqa: F401

import repro.launch.serve_multi as j_serve_multi
from repro_torch.interop import params_from_jax
from repro_torch.launch import serve_multi as t_serve_multi

ARGV = ["--tenants", "2", "--gen-len", "4"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def test_serve_multi_tenant_matches_the_reference(monkeypatch, smollm_f32):
    """The reference's engine draws its weights from ``PRNGKey(0)`` (the
    fixture's) and each tenant's λ from its own key: the port serves the
    same λ, verifies every tenant, and streams the reference's tokens."""
    ref, want, lams = example("serve_multi_tenant"), [], []
    sound_main, sound_lambda = ref.serve_multi_main, j_serve_multi.random_lambda
    monkeypatch.setattr(j_serve_multi, "random_lambda",
                        lambda *a, **k: lams.append(sound_lambda(*a, **k)) or lams[-1])
    monkeypatch.setattr(ref, "serve_multi_main", lambda argv: want.append(sound_main(argv)))
    run_reference(monkeypatch, ref, ARGV)
    crossed = [params_from_jax(jax.tree_util.tree_map(np.asarray, lam), device="cpu")
               for lam in lams]

    crossed_init(monkeypatch, smollm_f32)
    monkeypatch.setattr(t_serve_multi, "random_lambda", lambda *a, **k: crossed.pop(0))
    got = example("serve_multi_tenant_torch").main(["--device", "cpu", *ARGV])
    assert not crossed and len(lams) == 1
    key = lambda done: sorted((r.tenant, r.prompt.tobytes(), list(map(int, r.tokens)))
                              for r in done.values())
    assert len(got) == 2 and key(got) == key(want[0])
