"""The RoBERTa-style encoder of the PyTorch port against the JAX reference
(reduced roberta-base, float32, CPU): the config, LayerNorm, the params
tree, adapters attached in every mode (the svd path's subtracted weights
included), the trainable mask with the task head, the parameter counts, and
the task logits with a padding mask.  Params are initialised in JAX and
crossed over with ``repro_torch.interop``.

Bounds: float32 products of ≤ 128 terms summed in another order through 4
post-LN layers (≈ 1e-6 read); ``ATOL`` = 1e-5.  bf16 QR factors computed on
both sides from the same weights: within one bf16 ulp (2⁻⁷ relative).  SVD
factors as in ``test_torch_lora.py``: B·A and the subtracted weights within
1e-5 of the largest |entry| (their signs are free)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.models import build_model as jax_build
from repro.models.encoder import encoder_apply as j_encoder_apply
from repro.models.layers import layer_norm as j_layer_norm
from repro_torch.configs import get_config, get_reduced
from repro_torch.interop import params_from_jax
from repro_torch.models import build_model
from repro_torch.models.encoder import encoder_apply
from repro_torch.models.layers import layer_norm

ATOL = 1e-5
SVD_RTOL = 1e-5
MODES = ("qr_lora", "lora", "svd_lora", "ft", "none")


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


def _cfgs(mode, n_classes=3):
    """The reduced encoder in ``mode`` (wq and wv adapted in the last 2 of 4
    layers), in both packages."""
    out = []
    for reduced in (get_reduced, jax_reduced):
        cfg = reduced("roberta_base")
        out.append(cfg.replace(n_classes=n_classes, adapter=cfg.adapter.replace(
            mode=mode, targets=("wq", "wv"), layers="last2")))
    return out


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _shapes(t):
    if isinstance(t, dict):
        return {k: _shapes(v) for k, v in t.items()}
    return tuple(t.shape), str(t.dtype).split(".")[-1]


@pytest.mark.parametrize("which", ["config", "reduced"])
def test_roberta_config_matches_jax(which):
    """``get_config("roberta_base")`` (the runner's name) and ``-base`` alike;
    every field the port keeps equals the reference's."""
    got = (get_config if which == "config" else get_reduced)("roberta_base")
    assert got == (get_config if which == "config" else get_reduced)("roberta-base")
    want = (jax_config if which == "config" else jax_reduced)("roberta_base")
    for f in got.__dataclass_fields__:
        if f == "adapter":
            for a in got.adapter.__dataclass_fields__:
                assert getattr(got.adapter, a) == getattr(want.adapter, a), a
        else:
            assert getattr(got, f) == getattr(want, f), f
    if which == "config":
        assert (got.n_layers, got.d_model, got.n_heads, got.d_ff, got.vocab_size, got.dtype) == (
            12, 768, 12, 3072, 50265, "float32")


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 7, 64)) * 3 + 1).astype(np.float32)
    s, b = rng.standard_normal(64).astype(np.float32), rng.standard_normal(64).astype(np.float32)
    got = layer_norm(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b), 1e-5)
    want = j_layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.fixture(scope="module")
def jax_backbones():
    """The JAX backbone (no adapters), one per n_classes."""
    return {n: _np(jax_build(_cfgs("ft", n)[1]).init(jax.random.PRNGKey(0), with_adapters=False))
            for n in (1, 3)}


@pytest.mark.parametrize("mode", MODES)
def test_model_init_tree_has_reference_structure(mode):
    cfg, jcfg = _cfgs(mode)
    got = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    want = _np(jax_build(jcfg).init(jax.random.PRNGKey(0)))
    assert _shapes(got) == _shapes(params_from_jax(want, device="cpu"))


@pytest.mark.parametrize("mode", ["qr_lora", "lora", "svd_lora"])
def test_attach_adapters_matches_jax(mode, jax_backbones):
    """The port's ``attach_adapters`` on the crossed JAX backbone against the
    reference's on the same weights: QR factors and ranks, LoRA's structure,
    SVD-LoRA's B·A and the subtracted wq/wv written back; untouched weights
    stay the same tensors."""
    cfg, jcfg = _cfgs(mode)
    jp = jax_backbones[3]
    got = build_model(cfg, "cpu").attach_adapters(torch.Generator().manual_seed(1),
                                                  params_from_jax(jp, device="cpu"))
    want = params_from_jax(_np(jax_build(jcfg).attach_adapters(
        jax.random.PRNGKey(1), jax.tree_util.tree_map(jnp.asarray, jp))), device="cpu")
    assert _shapes(got) == _shapes(want)
    for proj in ("wq", "wv"):
        g, w = got["groups"]["adapters"]["attn"][proj], want["groups"]["adapters"]["attn"][proj]
        assert torch.equal(g["ranks"], w["ranks"]) and torch.equal(g["lam"], w["lam"])
        if mode == "qr_lora":
            for k in ("B", "A"):
                np.testing.assert_allclose(g[k].float().numpy(), w[k].float().numpy(),
                                           rtol=2**-7, atol=1e-6)
        elif mode == "svd_lora":
            ba, wba = (g["B"].float() @ g["A"].float()), (w["B"].float() @ w["A"].float())
            np.testing.assert_allclose(ba.numpy(), wba.numpy(),
                                       atol=2**-7 * float(wba.abs().max()))
            wg, ww = got["groups"]["attn"][proj], want["groups"]["attn"][proj]
            np.testing.assert_allclose(wg.numpy(), ww.numpy(),
                                       atol=SVD_RTOL * float(ww.abs().max()))
            assert not torch.equal(wg, params_from_jax(jp, device="cpu")["groups"]["attn"][proj])
        else:
            assert not g["B"].any() and not g["A"][:2].any() and g["A"][2:].any()
    for proj in ("wk", "wo"):
        assert torch.equal(got["groups"]["attn"][proj], want["groups"]["attn"][proj])


@pytest.mark.parametrize("mode", MODES)
def test_trainable_mask_and_counts_match_jax(mode):
    """The encoder trains its task head (cls_w, cls_b, pooler) beside the
    adapters outside ft; the mask equals the reference's leaf for leaf and
    both counts (without and with the head) equal its numbers."""
    cfg, jcfg = _cfgs(mode)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, "cpu")
    p = params_from_jax(_np(jp), device="cpu")
    assert tm.trainable_mask(p) == jax.tree_util.tree_map(bool, jm.trainable_mask(jp))
    for head in (False, True):
        assert tm.count_trainable(p, include_head=head) == jm.count_trainable(jp, include_head=head)
    if mode != "ft":
        assert tm.trainable_mask(p)["cls_w"] and tm.trainable_mask(p)["pooler"]


@pytest.mark.parametrize("n_classes", [3, 1], ids=["classes", "regression"])
@pytest.mark.parametrize("mode", MODES)
def test_encoder_logits_match_jax(mode, n_classes, jax_backbones):
    """Task outputs against the reference's ``encoder_apply`` with a padding
    mask (the second row's last 5 keys masked), the adapters made to matter:
    a random λ (qr_lora), a random B (lora); svd_lora's factors are nonzero
    from their init.  The adapted projections run the one-λ matmul's plain
    version here (its kernel on the card)."""
    cfg, jcfg = _cfgs(mode, n_classes)
    jm = jax_build(jcfg)
    jp = jax_backbones[n_classes]
    if mode not in ("ft", "none"):
        jp = _np(jm.attach_adapters(jax.random.PRNGKey(1), jax.tree_util.tree_map(jnp.asarray, jp)))
        rng = np.random.default_rng(2)
        for leaf in jp["groups"]["adapters"]["attn"].values():
            if mode == "qr_lora":
                leaf["lam"] = (rng.standard_normal(leaf["lam"].shape) * 0.5).astype(np.float32)
            if mode == "lora":
                leaf["B"] = jnp.asarray(rng.standard_normal(leaf["B"].shape) * 0.1, jnp.bfloat16)
            leaf["lam"] = leaf["lam"] * (leaf["ranks"] > 0)[:, None]
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), bool)
    mask[1, 7:] = False
    want = np.asarray(j_encoder_apply(jax.tree_util.tree_map(jnp.asarray, jp), jcfg,
                                      jnp.asarray(tokens), jnp.asarray(mask)))
    tp = params_from_jax(jp, device="cpu")
    got = encoder_apply(tp, cfg, torch.from_numpy(tokens), torch.from_numpy(mask))
    print(f"[parity] encoder {mode} n_classes={n_classes}: max|Δ| "
          f"{np.abs(got.numpy() - want).max():.2e} at max|out| {np.abs(want).max():.2f}")
    assert got.shape == (2, n_classes) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    # the model's forward is the same function; the unmasked call differs
    out, aux = build_model(cfg, "cpu").apply(tp, torch.from_numpy(tokens), train=True,
                                            attn_mask=torch.from_numpy(mask))
    assert torch.equal(out, got) and float(aux) == 0.0
    assert not torch.equal(encoder_apply(tp, cfg, torch.from_numpy(tokens)), got)
