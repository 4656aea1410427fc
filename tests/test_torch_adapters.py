"""QR-LoRA init and the adapter API of the PyTorch port against the JAX
reference (reduced smollm-135m, float32, CPU).  Params are initialised in
JAX and crossed over with ``repro_torch.interop``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.core import adapter_api as jadp
from repro.core.qr_lora import qr_lora_init_single as j_init_single
from repro.kernels import ref as jref
from repro.models import build_model as jax_build
from repro_torch.configs import get_reduced
from repro_torch.core import adapter_api as tadp
from repro_torch.core.qr_lora import qr_lora_init_single, qr_lora_init_stacked
from repro_torch.interop import params_from_jax
from repro_torch.models import build_model

# float32 matmuls of a few dozen terms, summed in another order: ~1e-6
ATOL = 1e-5


@pytest.fixture(scope="module")
def jax_params():
    cfg = jax_reduced("smollm-135m").replace(dtype="float32")
    return cfg, jax_build(cfg).init(jax.random.PRNGKey(0))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_qr_lora_init_single_matches_jax():
    W = np.random.default_rng(0).standard_normal((48, 24)).astype(np.float32)
    acfg = get_reduced("smollm-135m").adapter
    jacfg = jax_reduced("smollm-135m").adapter
    got, r = qr_lora_init_single(torch.from_numpy(W), acfg, dtype=torch.float32)
    want, jr = j_init_single(jnp.asarray(W), jacfg, dtype=jnp.float32)
    assert r == jr
    for k in ("B", "A", "lam"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL)


def test_qr_lora_factors_of_the_model_match_jax(jax_params):
    """Factors computed by the port from the JAX weights equal the JAX
    model's own adapters: same ranks, bf16 factors within one bf16 ulp."""
    jcfg, jp = jax_params
    cfg = get_reduced("smollm-135m").replace(dtype="float32")
    p = params_from_jax(_np_tree(jp), device="cpu")
    attn = p["groups"]["attn"]
    for proj in ("wq", "wv"):
        got = qr_lora_init_stacked(attn[proj], (False, True, True), cfg.adapter)
        want = p["groups"]["adapters"]["attn"][proj]
        assert torch.equal(got["ranks"], want["ranks"])
        for k in ("B", "A"):
            assert got[k].dtype == want[k].dtype == torch.bfloat16
            np.testing.assert_allclose(
                got[k].float().numpy(), want[k].float().numpy(), rtol=2**-7, atol=1e-6
            )
        assert torch.equal(got["lam"], want["lam"])


def test_model_init_adapter_tree_has_reference_structure(jax_params):
    _, jp = jax_params
    cfg = get_reduced("smollm-135m").replace(dtype="float32")
    p = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    ref = params_from_jax(_np_tree(jp), device="cpu")

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        return (tuple(t.shape), t.dtype)

    assert shapes(p) == shapes(ref)
    ranks = p["groups"]["adapters"]["attn"]["wq"]["ranks"]
    assert ranks[0] == 0 and (ranks[1:] > 0).all()  # "last2" of 3 layers


def test_count_trainable_matches_jax(jax_params):
    jcfg, jp = jax_params
    cfg = get_reduced("smollm-135m").replace(dtype="float32")
    p = params_from_jax(_np_tree(jp), device="cpu")
    assert build_model(cfg, "cpu").count_trainable(p) == jax_build(jcfg).count_trainable(jp)


def _adapter_inputs(dtype, lead=(5,), K=24, N=16, r=8, n_slots=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*lead, K)).astype(np.float32)
    W = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    B = (rng.standard_normal((K, r)) / np.sqrt(K)).astype(np.float32)
    A = rng.standard_normal((r, N)).astype(np.float32)
    lam = (rng.standard_normal((n_slots, r)) * 0.3).astype(np.float32)
    lam[0] = 0.0
    seg = rng.integers(0, n_slots, size=lead[0]).astype(np.int32)
    return x, W, B, A, lam, seg


@pytest.mark.parametrize("lead", [(5,), (3, 4)], ids=["per_row", "per_sequence"])
def test_adapted_matmul_seg_matches_jax(lead):
    x, W, B, A, lam, seg = _adapter_inputs(np.float32, lead=lead)
    t = [torch.from_numpy(a) for a in (x, W, B, A, lam, seg)]
    got = tadp.adapted_matmul(t[0], t[1], {"B": t[2], "A": t[3], "lam": t[4], "seg": t[5]})
    j = [jnp.asarray(a) for a in (x, W, B, A, lam, seg)]
    want = jadp.adapted_matmul(j[0], j[1], {"B": j[2], "A": j[3], "lam": j[4], "seg": j[5]},
                               kernel="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # and the reference oracle of the BGMV kernel, on flattened rows
    rows = np.repeat(seg, x.size // x.shape[-1] // seg.size)
    oracle = jref.qrlora_bgmv_ref(j[0].reshape(-1, x.shape[-1]), j[1], j[2], j[3], j[4],
                                  jnp.asarray(rows))
    np.testing.assert_allclose(got.numpy().reshape(oracle.shape), np.asarray(oracle), atol=ATOL)


def test_adapted_matmul_single_lambda_and_merge_match_jax():
    x, W, B, A, lam, _ = _adapter_inputs(np.float32, lead=(6,))
    t = {k: torch.from_numpy(v) for k, v in dict(B=B, A=A, lam=lam[1]).items()}
    j = {k: jnp.asarray(v) for k, v in dict(B=B, A=A, lam=lam[1]).items()}
    got = tadp.adapted_matmul(torch.from_numpy(x), torch.from_numpy(W), t)
    want = jadp.adapted_matmul(jnp.asarray(x), jnp.asarray(W), j, kernel="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    merged = tadp.merge_adapter(torch.from_numpy(W), t)
    np.testing.assert_allclose(merged.numpy(), np.asarray(jadp.merge_adapter(jnp.asarray(W), j)),
                               atol=ATOL)
    # the merged weight computes what the adapter path does
    np.testing.assert_allclose((torch.from_numpy(x) @ merged).numpy(), got.numpy(), atol=ATOL)
    assert tadp.adapted_matmul(torch.from_numpy(x), torch.from_numpy(W), None).shape == (6, 16)


def test_layer_selection_mask_matches_jax():
    for sel in ("all", "last1", "last3", (0, 2)):
        assert tadp.layer_selection_mask(sel, 4) == jadp.layer_selection_mask(sel, 4)
