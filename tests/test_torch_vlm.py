"""The vlm family of the port (llama-3.2-vision-11b: groups of four self
layers and one gated cross-attention layer against projected image rows)
against the JAX package on reduced llama-3.2-vision-11b cut to two groups
(``n_layers=10``, float32, CPU).

``xa_gate`` starts at zero in both packages, so on fresh params the cross
layers add nothing: every comparison first sets the gates of both trees to
the same nonzero values (±U[0.5, 1.5] from a numpy seed) and λ to random
nonzero values, and each lane takes its own image.  Tolerances, stated
once below: float32 logits through two frameworks 2e-5; greedy tokens
equal; step-0 λ gradients 1e-5 of each projection's largest |gradient|
(float32 rounding through ten layers' backward reads up to 3.7e-6 of it,
2.7e-7 absolute, at layer 0's wv); three train steps' losses 1e-5; a
quantized base's logits 1e-4 (the kernels' plain versions against XLA's
fp32 products)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.core import adapter_api as jadp
from repro.core.quantize import quantize_base_params as jquantize
from repro.models import build_model as jax_build
from repro.models import transformer as jtfm
from repro.optim import AdamWConfig as JAdamWConfig
from repro.training import init_train_state as j_init_state
from repro.training import make_decode_step as j_make_decode_step
from repro.training import make_prefill_step as j_make_prefill_step
from repro.training import make_train_step as j_make_step
from repro.training import steps as jsteps
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.quantize import quantize_base_params
from repro_torch.interop import params_from_jax
from repro_torch.launch import serve
from repro_torch.launch import train as train_launch
from repro_torch.models import build_model, lane_state
from repro_torch.models import transformer
from repro_torch.optim import AdamWConfig
from repro_torch.serving import EngineConfig, MultiTenantEngine
from repro_torch.training import init_train_state, make_train_step
from repro_torch.tree import tree_leaves

ARCH = "llama-3.2-vision-11b"
N_LAYERS = 10  # two groups of five: the group loop and the per-stack "last4" mask
APPLY_TOL = 2e-5
GRAD_RTOL = 1e-5  # of the projection's largest |gradient|
LOSS_ATOL = 1e-5
QUANT_TOL = 1e-4
DECODE_STEPS = 6


@pytest.fixture(scope="module", autouse=True)
def _threads_and_jax_caches():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def _gates(G, seed=11):
    """Nonzero gates, ±U[0.5, 1.5], float32."""
    rng = np.random.default_rng(seed)
    return (rng.choice([-1.0, 1.0], G) * rng.uniform(0.5, 1.5, G)).astype(np.float32)


def _with(tree, gates=None, lam_seed=None, lam_scale=0.5):
    """A numpy tree with ``gates`` in ``xattn/xa_gate`` and, from
    ``lam_seed``, random λ on every adapter (both packages take the same)."""
    tree = jax.tree_util.tree_map(np.asarray, tree)
    groups = dict(tree["groups"])
    if gates is not None:
        groups["xattn"] = {**groups["xattn"], "xa_gate": gates}
    if lam_seed is not None:
        rng = np.random.default_rng(lam_seed)
        groups["adapters"] = {
            mod: {p: {**leaf, "lam": (rng.standard_normal(leaf["lam"].shape) * lam_scale)
                      .astype(np.float32)} for p, leaf in projs.items()}
            for mod, projs in groups["adapters"].items()}
    return {**tree, "groups": groups}


def _config(family_cfg, **over):
    """Reduced llama-3.2-vision-11b in float32, two groups, QR-LoRA on the
    last 4 layers of each stack (the full config's selection)."""
    kw = {"dtype": "float32", "n_layers": N_LAYERS,
          "adapter": family_cfg.adapter.replace(layers="last4"), **over}
    return family_cfg.replace(**kw)


@pytest.fixture(scope="module")
def fresh():
    """The reference's init (weights, then QR-LoRA on them) as numpy trees:
    (base without adapters, params with them)."""
    jm = jax_build(_config(jax_reduced(ARCH)))
    key = jax.random.PRNGKey(0)
    base = jax.jit(lambda k: jm.init(k, with_adapters=False))(key)
    jp = jm.attach_adapters(key, base)
    return jax.tree_util.tree_map(np.asarray, base), jax.tree_util.tree_map(np.asarray, jp)


@pytest.fixture(scope="module")
def models(fresh):
    """The two models on the same float32 params: nonzero gates, random λ."""
    jm = jax_build(_config(jax_reduced(ARCH)))
    jp = _with(fresh[1], _gates(N_LAYERS // 5), lam_seed=1)
    tm = build_model(_config(get_reduced(ARCH)), "cpu")
    tp = params_from_jax(jp, device="cpu")
    return jm, jax.tree_util.tree_map(jnp.asarray, jp), tm, tp


def _images(cfg, B, seed=2):
    """One distinct standard normal image per lane."""
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.n_image_tokens, cfg.d_image)).astype(np.float32)


def _tokens(cfg, B, S, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def test_config_and_param_count_match_the_reference():
    for mine, ref in ((get_config(ARCH), jax_config(ARCH)), (get_reduced(ARCH), jax_reduced(ARCH))):
        for f in ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab_size", "d_head", "dtype", "rope_theta", "cross_attn_every",
                  "n_image_tokens", "d_image", "microbatches", "group_size"):
            assert getattr(mine, f) == getattr(ref, f), f
        for f in ("mode", "targets", "layers", "tau", "rank_cap"):
            assert getattr(mine.adapter, f) == getattr(ref.adapter, f), f
        assert mine.param_count() == ref.param_count()
    for arch in ("smollm-135m", "musicgen-medium", "moonshot-v1-16b-a3b"):
        for active in (False, True):
            assert get_config(arch).param_count(active) == jax_config(arch).param_count(active)


class _MetaGen(torch.Generator):
    """A generator whose draws land on the meta device (shapes only)."""

    @property
    def device(self):
        return torch.device("meta")


def test_full_width_tree_on_meta_tensors():
    """``tests/test_models_smoke.py:74-84``'s bound (0.5-1.7× the published
    10.6e9) over the port's full-width tree built on the meta device: the
    reference's analytic count plus the RMS-norm scales (two a layer and
    the final one), the image projection and one gate a group; ≈ 19.6 GB
    in bf16, the gates float32."""
    cfg = get_config(ARCH)
    params = transformer.init_decoder_params(_MetaGen(), cfg)
    n = sum(t.numel() for t in tree_leaves(params))
    G = cfg.n_layers // cfg.cross_attn_every
    assert 0.5 * 10.6e9 < n < 1.7 * 10.6e9, n
    extra = (2 * cfg.n_layers + 1) * cfg.d_model + cfg.d_image * cfg.d_model + G
    assert n - extra == jax_config(ARCH).param_count()
    g = params["groups"]
    assert g["attn"]["wq"].shape == (8, 4, 4096, 4096) and g["mlp"]["w_up"].shape == (8, 5, 4096, 14336)
    assert g["ln1"].shape == (8, 5, 4096) and g["xattn"]["wv"].shape == (8, 4096, 1024)
    assert g["xattn"]["xa_gate"].dtype == torch.float32 and g["attn"]["wq"].dtype == torch.bfloat16
    assert params["img_proj"].shape == (1280, 4096)


def _flat(tree):
    return {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _same_tree(mine, ref):
    """Leaf for leaf: the same paths, shapes and dtypes."""
    got, want = _flat(mine), _flat(ref)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).split(".")[1] == v.dtype.name, k


def test_init_tree_and_adapters_match_jax(fresh):
    """The bf16 tree leaf for leaf (shapes, dtypes, ``xa_gate`` float32 in
    it), and QR-LoRA attached by the port to the reference's weights: under
    "last4" λ lands on the last 4 of the 8 flattened self layers and on the
    last 4 of the 2 cross layers, each stack masked on its own, with the
    reference's ranks and factors (bf16, as both packages store them)."""
    cfg16 = _config(get_reduced(ARCH), dtype="bfloat16")
    jm = jax_build(_config(jax_reduced(ARCH), dtype="bfloat16"))
    jbase = jax.jit(lambda k: jm.init(k, with_adapters=False))(jax.random.PRNGKey(4))
    drawn = transformer.init_decoder_params(torch.Generator().manual_seed(0), cfg16)
    _same_tree(drawn, jax.tree_util.tree_map(np.asarray, jbase))
    assert drawn["groups"]["xattn"]["xa_gate"].dtype == torch.float32
    assert drawn["groups"]["attn"]["wq"].dtype == torch.bfloat16

    base, jp = fresh
    attached = build_model(_config(get_reduced(ARCH)), "cpu").attach_adapters(
        None, params_from_jax(base, device="cpu"))
    _same_tree(attached, jp)
    for mod in ("attn", "xattn"):
        for proj in ("wq", "wv"):
            ref = jp["groups"]["adapters"][mod][proj]
            leaf = attached["groups"]["adapters"][mod][proj]
            np.testing.assert_array_equal(leaf["ranks"].numpy(), ref["ranks"])
            for f in ("B", "A"):
                np.testing.assert_allclose(leaf[f].float().numpy(), ref[f].astype(np.float32),
                                           atol=2e-2, err_msg=f"{mod}/{proj}/{f}")
    ranks = attached["groups"]["adapters"]["attn"]["wq"]["ranks"].numpy()
    assert ranks.shape == (2, 4) and (ranks[0] == 0).all() and (ranks[1] > 0).all()
    assert (attached["groups"]["adapters"]["xattn"]["wv"]["ranks"].numpy() > 0).all()


def test_apply_with_images_matches_jax(models):
    jm, jp, tm, tp = models
    toks, img = _tokens(tm.cfg, 2, 9), _images(tm.cfg, 2)
    want, _ = jm.apply(jp, tokens=jnp.asarray(toks), image_embeds=jnp.asarray(img), train=False)
    got = tm.apply(tp, torch.from_numpy(toks), image_embeds=torch.from_numpy(img))
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    print(f"[parity] {ARCH} apply(image_embeds=): max|Δ| {err:.2e}")
    assert got.shape == (2, 9, tm.cfg.vocab_size) and err < APPLY_TOL


def test_gates_and_images_move_the_logits(models):
    """The control: with the gates at zero the cross layers add nothing
    (another image gives the same logits, bitwise); with them set, the
    image moves the logits, and swapping the two lanes' images moves each
    lane's."""
    _, _, tm, tp = models
    toks, img = torch.from_numpy(_tokens(tm.cfg, 2, 9)), torch.from_numpy(_images(tm.cfg, 2))
    closed = {**tp, "groups": {**tp["groups"], "xattn": {
        **tp["groups"]["xattn"], "xa_gate": torch.zeros_like(tp["groups"]["xattn"]["xa_gate"])}}}
    z1 = tm.apply(closed, toks, image_embeds=img)
    z2 = tm.apply(closed, toks, image_embeds=torch.randn_like(img))
    assert torch.equal(z1, z2)
    gated = tm.apply(tp, toks, image_embeds=img)
    swapped = tm.apply(tp, toks, image_embeds=img.flip(0))
    moved = float((gated - z1).abs().max())
    print(f"[control] gates open vs closed: max|Δlogits| {moved:.3f}")
    assert moved > 1e-2
    for b in range(2):
        assert float((swapped[b] - gated[b]).abs().max()) > 1e-2


@pytest.fixture(scope="module")
def reference_loop(models):
    """The reference launcher's serving loop (``repro/launch/serve.py``: its
    jitted ``make_prefill_step`` / ``make_decode_step``) over 2 lanes with
    their own images: a 12-token prompt, then ``DECODE_STEPS`` greedy
    steps → (prompts, images, tokens (B, 1 + DECODE_STEPS), logits rows)."""
    jm, jp, tm, _ = models
    B, P = 2, 12
    prompts, img = _tokens(tm.cfg, B, P, seed=5), _images(tm.cfg, B, seed=6)
    prefill = jax.jit(j_make_prefill_step(jm))
    decode = jax.jit(j_make_decode_step(jm))
    cache = jm.init_decode_state(B, P + 1 + DECODE_STEPS, jnp.float32)
    batch = {"tokens": jnp.asarray(prompts), "image_embeds": jnp.asarray(img)}
    logits, cache = prefill(jp, cache, batch)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
    toks, rows = [np.asarray(tok)], [np.asarray(logits)]
    for _ in range(DECODE_STEPS):
        tok, logits, cache = decode(jp, cache, {"token": tok, "image_embeds": batch["image_embeds"]})
        toks.append(np.asarray(tok))
        rows.append(np.asarray(logits))
    return prompts, img, np.concatenate(toks, axis=1), np.stack(rows, 1)


def test_prefill_decode_matches_full_and_jax(models, reference_loop):
    """``tests/test_decode_consistency.py``'s vlm case: a prefill of the
    first S-1 tokens and a decode of the last against the full forward, in
    the port; then the port's prefill and six greedy decode steps against
    the reference's on the same cache layout: logits within the float32
    bar, tokens equal."""
    _, _, tm, tp = models
    prompts, img, want_toks, want_rows = reference_loop
    B, S = prompts.shape
    ti = torch.from_numpy(img)
    full = tm.apply(tp, torch.from_numpy(prompts), image_embeds=ti)
    cache = tm.init_decode_state(B, 32, torch.float32)
    assert cache["layers"]["attn"]["k"].shape == (2, 4, B, 32, 2, tm.cfg.d_head)
    pre, cache = tm.prefill(tp, cache, torch.from_numpy(prompts[:, :S - 1]), image_embeds=ti)
    dec, cache = tm.decode_step(tp, cache, torch.from_numpy(prompts[:, S - 1:]), image_embeds=ti)
    atol = 3e-5 * max(float(full.abs().max()), 1.0)
    np.testing.assert_allclose(pre.numpy(), full[:, S - 2].numpy(), atol=atol)
    np.testing.assert_allclose(dec.numpy(), full[:, S - 1].numpy(), atol=atol)

    cache = tm.init_decode_state(B, S + 1 + DECODE_STEPS, torch.float32)
    lg, cache = tm.prefill(tp, cache, torch.from_numpy(prompts), image_embeds=ti)
    for t in range(DECODE_STEPS + 1):
        np.testing.assert_allclose(lg.numpy(), want_rows[:, t], atol=APPLY_TOL)
        nxt = torch.argmax(lg, -1).to(torch.int32)[:, None]
        np.testing.assert_array_equal(nxt[:, 0].numpy(), want_toks[:, t])
        if t < DECODE_STEPS:
            lg, cache = tm.decode_step(tp, cache, nxt, image_embeds=ti)


def test_generate_matches_the_reference_serving_loop(models, reference_loop):
    """``launch/serve.py``'s :func:`generate` against the reference launcher's
    loop: the same greedy tokens, lane by lane, each lane with its own
    image, and the logits of every step within the float32 bar."""
    _, _, tm, tp = models
    prompts, img, want_toks, want_rows = reference_loop
    out = serve.generate(tm, tp, prompts, torch.from_numpy(img), DECODE_STEPS + 1,
                         keep_logits=True)
    np.testing.assert_array_equal(out["tokens"], want_toks)
    np.testing.assert_allclose(out["logits"].numpy(), want_rows, atol=APPLY_TOL)
    assert out["tokens"].dtype == np.int32


def test_serve_launcher_prints_the_reference_lines(capsys):
    """The port's launcher on the CPU at the reduced config (zeros for the
    images and λ = 0, as the reference's launcher serves them): the
    reference's four lines, the tokens returned."""
    gen = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "8", "--gen-len", "5"])
    lines = capsys.readouterr().out.splitlines()
    assert gen.shape == (2, 5) and len(lines) == 4
    assert lines[0] == f"[serve] arch={ARCH} batch=2 prompt=8 gen=5"
    assert lines[1].startswith("[serve] prefill: ") and lines[2].startswith("[serve] decode:  ")
    assert lines[3] == f"[serve] sample continuation[0,:16]: {gen[0, :16].tolist()}"


def test_train_steps_match_jax(models):
    """λ-only training with images, in two microbatches (each takes its
    rows' images): step-0 λ gradients against ``jax.grad`` of the
    reference's loss, and three steps' losses against its
    ``make_train_step``."""
    jm, jp, tm, tp = models
    jm2 = jax_build(jm.cfg.replace(microbatches=2, remat=False))  # remat: the same numbers
    tm2 = build_model(tm.cfg.replace(microbatches=2), "cpu")
    B, S = 2, 8
    batches = [(_tokens(tm.cfg, B, S, seed=20 + i), _images(tm.cfg, B, seed=30 + i))
               for i in range(3)]
    zero = _with(jax.tree_util.tree_map(np.asarray, jp), lam_seed=None)
    zero["groups"]["adapters"] = jax.tree_util.tree_map(
        lambda t: np.zeros_like(t) if t.dtype == np.float32 else t, zero["groups"]["adapters"])
    jz = jax.tree_util.tree_map(jnp.asarray, zero)
    jstate = j_init_state(jm2, None, params=jz)
    toks0, img0 = batches[0]

    def jloss(trainable, toks, img):
        params = jadp.merge(trainable, jstate["frozen"])
        kw, t, w = jsteps._model_inputs(jm.cfg, {"tokens": toks, "image_embeds": img})
        logits, aux = jm2.apply(params, train=True, **kw)
        ce, zl = jsteps.lm_loss(logits, t, w)
        return ce + jsteps.Z_LOSS_COEF * zl

    # the reference's accumulation: the microbatches' gradients summed, over k
    jgrad = jax.jit(jax.grad(jloss))
    jgrads = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, *(
        jgrad(jstate["trainable"], jnp.asarray(toks0[h]), jnp.asarray(img0[h]))
        for h in (slice(0, B // 2), slice(B // 2, B))))
    tstate = init_train_state(tm2, params=params_from_jax(zero, device="cpu"))
    jstep = jax.jit(j_make_step(jm2, JAdamWConfig(lr=1e-2)))
    tstep = make_train_step(tm2, AdamWConfig(lr=1e-2))
    for i, (toks, img) in enumerate(batches):
        tstate_new, tmet = tstep(tstate, {"tokens": torch.from_numpy(toks),
                                          "image_embeds": torch.from_numpy(img)})
        if i == 0:
            for mod, projs in jgrads["groups"]["adapters"].items():
                for p, leaf in projs.items():
                    want = np.asarray(leaf["lam"])
                    # each microbatch's backward adds into .grad; the step takes the mean
                    got = tstate["trainable"]["groups"]["adapters"][mod][p]["lam"].grad.numpy() / 2
                    np.testing.assert_allclose(got, want, atol=GRAD_RTOL * np.abs(want).max(),
                                               err_msg=f"{mod}/{p}")
                    assert np.abs(want).max() > 1e-5  # a real gradient
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(toks), "image_embeds": jnp.asarray(img)})
        tstate = tstate_new
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), atol=LOSS_ATOL)


@pytest.mark.parametrize("base", ["int8", "fp8"])
def test_quantized_base_with_xattn_matches_jax(models, base):
    """int8/fp8 bases: ``xattn``'s adapted projections quantize beside
    ``attn``'s (the reference's ``_QUANTIZABLE_MODULES``), bit for bit as
    the reference quantizes them, and ``apply`` with images agrees."""
    jm, jp, tm, tp = models
    jq = jquantize(jp, base)
    tq = quantize_base_params(tp, base)
    for mod in ("attn", "xattn"):
        for proj in ("wq", "wv"):
            leaf, ref = tq["groups"][mod][proj], jq["groups"][mod][proj]
            assert set(leaf) == {"q", "scale"}, (mod, proj)
            np.testing.assert_array_equal(leaf["scale"].numpy(), np.asarray(ref["scale"]))
            np.testing.assert_array_equal(leaf["q"].float().numpy(),
                                          np.asarray(ref["q"]).astype(np.float32))
    toks, img = _tokens(tm.cfg, 2, 9, seed=8), _images(tm.cfg, 2, seed=9)
    want, _ = jm.apply(jq, tokens=jnp.asarray(toks), image_embeds=jnp.asarray(img), train=False)
    got = tm.apply(tq, torch.from_numpy(toks), image_embeds=torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=QUANT_TOL)


def test_engine_refuses_vlm_as_the_reference_does(models):
    _, _, tm, tp = models
    with pytest.raises(NotImplementedError, match="per-lane image"):
        MultiTenantEngine(tm.cfg, EngineConfig(n_lanes=2, max_len=32), params=tp, device="cpu")


def test_lane_axes_and_per_lane_cache(models):
    """The vlm lane axes (``repro/models/transformer.py:514-515``): two lead
    axes (G, P-1) before the lane; a lane extracted and restored round-trips
    and leaves the other lanes alone; no paged layout."""
    jm, _, tm, _ = models
    axes = tm.lane_axes()
    assert axes == jtfm.decode_state_lane_axes(jm.cfg)
    assert axes == {"pos": 0, "layers": {"attn": {"k": 2, "v": 2, "idx": 2}}}
    cache = tm.init_decode_state(3, 8, torch.float32, per_lane=True)
    assert cache["layers"]["attn"]["idx"].shape == (2, 4, 3)
    for leaf in tree_leaves(cache):
        leaf.copy_(torch.arange(leaf.numel()).reshape(leaf.shape).to(leaf.dtype))
    before = {k: v.clone() for k, v in cache["layers"]["attn"].items()}
    snap = lane_state.extract_lane(cache, axes, 1)
    assert snap["layers"]["attn"]["k"].shape == (2, 4, 1, 8, 2, tm.cfg.d_head)
    lane_state.restore_lane(cache, axes, 2, snap)
    for k, v in cache["layers"]["attn"].items():
        assert torch.equal(v.select(2, 2), before[k].select(2, 1))
        assert torch.equal(v.select(2, 0), before[k].select(2, 0))
    with pytest.raises(NotImplementedError):
        tm.init_decode_state(2, 32, torch.float32, paged=True)


def test_train_launcher_batches_carry_one_image_a_row(tmp_path):
    cfg = get_reduced(ARCH)
    batch = next(train_launch.batches(cfg, 2, 16, 0, "cpu"))
    assert set(batch) == {"tokens", "image_embeds"}
    assert batch["image_embeds"].shape == (2, 16, 32)
    assert not torch.equal(batch["image_embeds"][0], batch["image_embeds"][1])
    _, hist = train_launch.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "2",
                                 "--batch", "2", "--seq", "8", "--log-every", "0",
                                 "--ckpt-dir", str(tmp_path / "ckpt")])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
