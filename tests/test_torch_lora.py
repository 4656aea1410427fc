"""LoRA, SVD-LoRA and full fine-tuning in the adapter API of the PyTorch port
against the JAX reference (float32, CPU): ports of ``tests/test_adapters.py``
(baselines preserve the init, trainability masks and gradients, parameter
counting) over every mode, the baselines' init against
``repro/core/lora.py``, and the one-λ autograd rule's dx, dλ, dB and dA
against ``jax.grad`` of the reference's XLA formula.

Bounds: float32 products of ≤ 64 terms summed in another order (≈ 1e-6);
``ATOL`` = 1e-5 as in the port's other float32 tests.  SVD factors are
defined up to sign, so B·A, σ and the subtracted W are compared, not B or A
alone; two float32 LAPACK SVDs (torch's and numpy's) agree to a few float32
ulps of the largest entry (1.6e-5 read on entries up to ≈ 4), so those are
held to ``SVD_RTOL`` = 1e-5 of the largest |entry|.  The RNG streams
differ, so LoRA's random A is compared by structure (shape, dtype, masked
rows, scale); parity runs cross JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import AdapterConfig as JAdapterConfig
from repro.configs.base import ModelConfig as JModelConfig
from repro.core import adapter_api as jadp
from repro.core import lora as jlora
from repro.core import qr_lora as jqr
from repro_torch.configs.base import AdapterConfig, ModelConfig
from repro_torch.core import adapter_api as tadp
from repro_torch.core import lora as tlora
from repro_torch.core.qr_lora import qr_lora_delta
from repro_torch.kernels import ops
from repro_torch.tree import tree_leaves, tree_map

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


def _cfgs(mode="qr_lora", **kw):
    """The reference test's config, in both packages."""
    a = dict(mode=mode, targets=("wq",), layers="last4", tau=0.5, rank_cap=16)
    a.update(kw)
    dims = dict(name="t", family="dense", n_layers=6, d_model=32, n_heads=4, n_kv_heads=4,
                d_ff=64, vocab_size=100)
    return (ModelConfig(**dims, adapter=AdapterConfig(**a)),
            JModelConfig(**dims, adapter=JAdapterConfig(**a)))


@pytest.fixture(scope="module")
def stacked_weight():
    """The reference test's weight, (6, 32, 32) with a decaying spectrum."""
    key = jax.random.PRNGKey(0)
    return np.asarray(jax.random.normal(key, (6, 32, 32)) * jnp.linspace(1, 0.05, 32)[None, None, :])


def _x(n=3, d=32, seed=1):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _slice(adp, l):
    return {k: v[l] for k, v in adp.items() if k != "ranks"}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, dtype=np.float32 if np.asarray(tree).dtype != np.int32
                                     else np.int32))


def _model_tree(W, adp):
    """The reference test's tree layout (adapters beside the weight)."""
    return {"layers": {"wq": W, "adapters": {"wq": adp}}}


@pytest.mark.parametrize("mode", ["lora", "svd_lora"])
def test_baselines_preserve_init(mode, stacked_weight):
    """Port of ``test_adapters.py::test_baselines_preserve_init``: at init the
    adapted projection of the (possibly subtracted) weight equals x·W0."""
    cfg, _ = _cfgs(mode=mode, layers="all", rank=2, svd_k=1, alpha=2.0)
    W = torch.from_numpy(stacked_weight)
    adps, new_w = tadp.init_adapters(torch.Generator().manual_seed(0), cfg, {"wq": W},
                                     torch.float32)
    x = torch.from_numpy(_x())
    sc = tadp.adapter_scale(cfg.adapter)
    got = tadp.adapted_matmul(x, new_w["wq"][2], _slice(adps["wq"], 2), scale=sc)
    np.testing.assert_allclose(got.numpy(), (x @ W[2]).numpy(), atol=2e-5)


@pytest.mark.parametrize("subtract", [True, False])
def test_svd_lora_init_matches_jax(subtract, stacked_weight):
    """B·A of every layer, the subtracted W, λ and ranks against the
    reference's ``svd_lora_init_stacked`` (k = 2 of rank 3: σ₁, σ₂ and the
    zero-padded third column)."""
    cfg, jcfg = _cfgs(mode="svd_lora", layers="last4", rank=3, svd_k=2, alpha=6.0,
                      svd_subtract_init=subtract)
    mask = tadp.layer_selection_mask("last4", 6)
    got, W_new = tlora.svd_lora_init_stacked(torch.from_numpy(stacked_weight), mask,
                                             cfg.adapter, torch.float32)
    want, jW_new = jlora.svd_lora_init_stacked(jnp.asarray(stacked_weight), mask, jcfg.adapter,
                                               jnp.float32)
    ba, jba = (got["B"] @ got["A"]).numpy(), np.asarray(want["B"] @ want["A"])
    print(f"[parity] svd_lora B·A max|Δ| {np.abs(ba - jba).max():.2e}, subtracted W "
          f"{np.abs(W_new.numpy() - np.asarray(jW_new)).max():.2e}")
    np.testing.assert_allclose(ba, jba, atol=SVD_RTOL * np.abs(jba).max())
    # W − (α/r)·B·A: the B·A bound times α/r = 2
    np.testing.assert_allclose(W_new.numpy(), np.asarray(jW_new),
                               atol=2 * SVD_RTOL * np.abs(jba).max())
    # σ: the columns of B (and rows of A) have norm √σ
    jsig = np.linalg.norm(np.asarray(want["B"]), axis=1)
    np.testing.assert_allclose(got["B"].norm(dim=1).numpy(), jsig, atol=SVD_RTOL * jsig.max())
    np.testing.assert_array_equal(got["lam"].numpy(), np.asarray(want["lam"]))
    np.testing.assert_array_equal(got["ranks"].numpy(), np.asarray(want["ranks"]))
    if not subtract:
        assert torch.equal(W_new, torch.from_numpy(stacked_weight))


def test_svd_lora_subtracts_from_the_float32_factors(stacked_weight):
    """bf16 factors (the model's default), W subtracted with the float32
    factors before they are cast (``repro/core/lora.py:63-64``)."""
    cfg, jcfg = _cfgs(mode="svd_lora", layers="all", rank=2, svd_k=1)
    mask = (True,) * 6
    got, W_new = tlora.svd_lora_init_stacked(torch.from_numpy(stacked_weight), mask,
                                             cfg.adapter)
    want, jW_new = jlora.svd_lora_init_stacked(jnp.asarray(stacked_weight), mask, jcfg.adapter)
    assert got["B"].dtype == got["A"].dtype == torch.bfloat16
    np.testing.assert_allclose(W_new.numpy(), np.asarray(jW_new),
                               atol=SVD_RTOL * np.abs(stacked_weight).max())
    np.testing.assert_allclose((got["B"].float() @ got["A"].float()).numpy(),
                               np.asarray(want["B"].astype(jnp.float32) @ want["A"].astype(jnp.float32)),
                               atol=2**-7)


def test_lora_init_has_the_reference_structure(stacked_weight):
    cfg, jcfg = _cfgs(mode="lora", layers="last4", rank=4)
    mask = tadp.layer_selection_mask("last4", 6)
    got = tlora.lora_init_stacked(torch.Generator().manual_seed(3),
                                  torch.from_numpy(stacked_weight), mask, cfg.adapter)
    want = jlora.lora_init_stacked(jax.random.PRNGKey(3), jnp.asarray(stacked_weight), mask,
                                   jcfg.adapter)
    for k in ("B", "A", "lam", "ranks"):
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[1] == str(want[k].dtype)
    assert not got["B"].any() and not got["A"][:2].any()
    np.testing.assert_array_equal(got["lam"].numpy(), np.asarray(want["lam"]))
    np.testing.assert_array_equal(got["ranks"].numpy(), np.asarray(want["ranks"]))
    # N(0, 1/r): 4 layers × 4 × 32 draws, std 0.5 within 10%
    assert abs(float(got["A"][2:].float().std()) - 0.5) < 0.05


@pytest.mark.parametrize("mode", MODES)
def test_adapter_scale_matches_jax(mode):
    cfg, jcfg = _cfgs(mode=mode, rank=4, alpha=3.0)
    assert tadp.adapter_scale(cfg.adapter) == jadp.adapter_scale(jcfg.adapter)


def _jax_adapters(mode, W, cfg):
    """The reference's adapters for the test weight, as numpy (LoRA's B made
    nonzero so that every factor carries a gradient)."""
    adps, new_w = jadp.init_adapters(jax.random.PRNGKey(0), cfg, {"wq": jnp.asarray(W)},
                                     jnp.float32)
    adps = jax.tree_util.tree_map(np.asarray, adps)
    if mode == "lora":
        adps["wq"]["B"] = np.random.default_rng(4).standard_normal(
            adps["wq"]["B"].shape).astype(np.float32) * 0.1
    if mode == "qr_lora":
        adps["wq"]["lam"] = np.random.default_rng(5).standard_normal(
            adps["wq"]["lam"].shape).astype(np.float32)
    return adps, np.asarray(new_w["wq"])


@pytest.mark.parametrize("mode", MODES)
def test_trainable_mask_and_grads(mode, stacked_weight):
    """Port of ``test_adapters.py::test_trainable_mask_and_grads`` over every
    mode: the mask equals the reference's leaf for leaf, and the gradients of
    the trainable leaves through the port's adapted matmul (the one-λ autograd
    rule) equal ``jax.grad`` through the reference's; in qr_lora they exist
    exactly on the selected ranks of the adapted layers."""
    cfg, jcfg = _cfgs(mode=mode, rank=2)
    adps, W = _jax_adapters(mode, stacked_weight, jcfg)
    jparams = _model_tree(jnp.asarray(W), jax.tree_util.tree_map(jnp.asarray, adps.get("wq", {})))
    params = _model_tree(torch.from_numpy(W), _to_torch(adps.get("wq", {})))
    jmask = jadp.trainable_mask(jparams, jcfg)
    mask = tadp.trainable_mask(params, cfg)
    assert mask == jax.tree_util.tree_map(bool, jmask)
    jt, jf = jadp.partition(jparams, jmask)
    t, f = tadp.partition(params, mask)
    assert tadp.merge(t, f)["layers"]["wq"] is params["layers"]["wq"]
    x = _x()
    sc = jadp.adapter_scale(jcfg.adapter)

    def jloss(t):
        p = jadp.merge(t, jf)
        adp = p["layers"]["adapters"].get("wq")
        sl = {k: v[5] for k, v in adp.items() if k != "ranks"} if adp else None
        return jnp.sum(jadp.adapted_matmul(jnp.asarray(x), p["layers"]["wq"][5], sl, scale=sc) ** 2)

    t = tree_map(lambda leaf: leaf.clone().requires_grad_(True), t)
    p = tadp.merge(t, f)
    adp = p["layers"]["adapters"].get("wq")
    sl = {k: v[5] for k, v in adp.items() if k != "ranks"} if adp else None
    loss = (tadp.adapted_matmul(torch.from_numpy(x), p["layers"]["wq"][5], sl, scale=sc) ** 2).sum()
    if tree_leaves(t):  # mode "none" trains nothing
        loss.backward()
    jg = jax.grad(jloss)(jt)
    got = [leaf.grad for leaf in tree_leaves(t)]
    want = [np.asarray(g) for g in jax.tree_util.tree_leaves(jg)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL * max(1.0, float(np.abs(w).max())))
    if mode == "qr_lora":
        lam_g = t["layers"]["adapters"]["wq"]["lam"].grad
        ranks = adps["wq"]["ranks"]
        assert int((lam_g[5] != 0).sum()) == ranks[5]
        assert bool((lam_g[0] == 0).all())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("layout", ["beside", "model"])
def test_param_counting_matches_jax(mode, layout, stacked_weight):
    """Port of ``test_adapters.py::test_param_counting_matches_ranks`` over
    every mode: the port's count is the reference's in the test's layout
    (where qr_lora counts the selected ranks) and in a model's
    ``groups/adapters/<module>/<proj>`` layout (where it counts padded λ)."""
    cfg, jcfg = _cfgs(mode=mode)
    adps, W = _jax_adapters(mode, stacked_weight, jcfg)
    if layout == "beside":
        jtree = _model_tree(W, adps.get("wq", {}))
    else:
        jtree = {"embed": np.zeros((10, 32), np.float32),
                 "groups": {"attn": {"wq": W}, "adapters": {"attn": adps} if adps else {}}}
    want = jadp.count_trainable_params(jax.tree_util.tree_map(jnp.asarray, jtree), jcfg)
    got = tadp.count_trainable_params(_to_torch(jtree), cfg)
    assert got == want
    if mode == "qr_lora" and layout == "beside":
        assert got == int(adps["wq"]["ranks"].sum())
    assert tadp.count_params(_to_torch(jtree)) == jadp.count_params(jtree)


def test_qr_lora_delta_matches_jax(stacked_weight):
    _, jcfg = _cfgs(rank_cap=8, layers="all")
    adps, _ = _jax_adapters("qr_lora", stacked_weight, jcfg)
    want = jqr.qr_lora_delta(jax.tree_util.tree_map(jnp.asarray, adps["wq"]), scale=0.5)
    got = qr_lora_delta(_to_torch(adps["wq"]), scale=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("needs", ["x_lam", "B_A", "all"])
def test_qrlora_matmul_backward_matches_jax_grad(needs):
    """``ops.qrlora_matmul``'s dx, dλ, dB and dA against ``jax.grad`` of the
    reference's XLA formula ``x·W + ((x·B)·λ)·A·scale`` (its one-λ custom
    VJP returns zeros for B and A, a route the reference's LoRA never
    takes), float32, x of rank 3, scale 0.7; W is frozen."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    W = (rng.standard_normal((24, 20)) / 5).astype(np.float32)
    B = (rng.standard_normal((24, 6)) / 5).astype(np.float32)
    A = rng.standard_normal((6, 20)).astype(np.float32)
    lam = rng.standard_normal(6).astype(np.float32)
    cot = rng.standard_normal((2, 5, 20)).astype(np.float32)
    names = ("x", "W", "B", "A", "lam")
    wanted = {"x_lam": ("x", "lam"), "B_A": ("B", "A"), "all": ("x", "B", "A", "lam")}[needs]

    def f(x, W, B, A, lam):
        return jnp.sum((x @ W + ((x @ B) * lam) @ A * 0.7) * cot)

    jg = jax.grad(f, argnums=tuple(names.index(n) for n in wanted))(x, W, B, A, lam)
    ts = {n: torch.from_numpy(v).requires_grad_(n in wanted)
          for n, v in zip(names, (x, W, B, A, lam))}
    y = ops.qrlora_matmul(ts["x"], ts["W"], ts["B"], ts["A"], ts["lam"], 0.7)
    (y * torch.from_numpy(cot)).sum().backward()
    for n, g in zip(wanted, jg):
        print(f"[parity] qrlora_matmul d{n}: max|Δ| {np.abs(ts[n].grad.numpy() - np.asarray(g)).max():.2e}")
        np.testing.assert_allclose(ts[n].grad.numpy(), np.asarray(g), atol=ATOL, rtol=1e-5)
    for n in set(names) - set(wanted):
        assert ts[n].grad is None


def test_qrlora_matmul_factor_grads_keep_the_factor_dtype():
    """bf16 B and A (the model's factors) get bf16 gradients, the fp32
    products cast once, as JAX's gradient of a bf16 leaf is."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((7, 16), generator=g)
    W = torch.randn((16, 8), generator=g)
    B = torch.randn((16, 4), generator=g).bfloat16().requires_grad_(True)
    A = torch.randn((4, 8), generator=g).bfloat16().requires_grad_(True)
    lam = torch.ones(4)
    ops.qrlora_matmul(x, W, B, A, lam).sum().backward()
    assert B.grad.dtype == A.grad.dtype == torch.bfloat16
    gB, gA = jax.grad(lambda B, A: jnp.sum(jnp.asarray(x.numpy()) @ jnp.asarray(W.numpy())
                                           + (jnp.asarray(x.numpy()) @ B) @ A),
                      argnums=(0, 1))(jnp.asarray(B.detach().float().numpy(), jnp.bfloat16),
                                      jnp.asarray(A.detach().float().numpy(), jnp.bfloat16))
    np.testing.assert_allclose(B.grad.float().numpy(), np.asarray(gB, np.float32), rtol=2**-7,
                               atol=1e-6)
    np.testing.assert_allclose(A.grad.float().numpy(), np.asarray(gA, np.float32), rtol=2**-7,
                               atol=1e-6)


def test_adamw_updates_a_bf16_leaf_as_jax():
    """LoRA's factors are bf16 trainable leaves: AdamW clips their gradient
    and keeps its moments in fp32 and casts the new value back, as the
    reference's does (its bf16 × fp32 clip promotes to fp32); bitwise, with
    the clip active."""
    from repro.optim import AdamWConfig as JAdamWConfig
    from repro.optim import adamw_init as j_init
    from repro.optim import adamw_update as j_update
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    rng = np.random.default_rng(3)
    p = jnp.asarray(rng.standard_normal((16, 4)), jnp.bfloat16)
    g = jnp.asarray(rng.standard_normal((16, 4)) * 3, jnp.bfloat16)  # |g| > clip_norm
    jp, jopt = {"B": p}, j_init({"B": p})
    tp = {"B": torch.from_numpy(np.asarray(p, np.float32)).bfloat16()}
    topt = adamw_init(tp)
    for _ in range(3):
        jp, jopt, jm = j_update({"B": g}, jopt, jp, JAdamWConfig(lr=1e-2))
        tp, topt, tm = adamw_update({"B": torch.from_numpy(np.asarray(g, np.float32)).bfloat16()},
                                    topt, tp, AdamWConfig(lr=1e-2))
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
    assert tp["B"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["B"].float().numpy(), np.asarray(jp["B"], np.float32))
    np.testing.assert_allclose(topt["m"]["B"].numpy(), np.asarray(jopt["m"]["B"]), rtol=1e-6)
