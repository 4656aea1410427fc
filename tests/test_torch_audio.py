"""The audio family of the port (musicgen-medium: the dense stack over
EnCodec frame embeddings) against the JAX package on reduced musicgen-medium
(float32, CPU): ``apply(embeds=)``, the prefill/decode consistency of
``tests/test_decode_consistency.py:37-42``, the serving prefill and decode
steps, one λ-only train step's loss and λ gradients on frame embeddings
(``tests/test_models_smoke.py:16-27, 47-60``), the engine beside the JAX
engine over code tokens, the launcher, and the full-width parameter count
(``tests/test_models_smoke.py:84``) on meta tensors."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.core import adapter_api as jadp
from repro.models import build_model as jax_build
from repro.optim import AdamWConfig as JAdamWConfig
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import MultiTenantEngine as JEngine
from repro.training import init_train_state as j_init_state
from repro.training import make_decode_step as j_make_decode_step
from repro.training import make_prefill_step as j_make_prefill_step
from repro.training import make_train_step as j_make_step
from repro.training import steps as jsteps
from repro_torch.configs import get_config, get_reduced
from repro_torch.interop import params_from_jax
from repro_torch.launch import serve_multi
from repro_torch.launch import train as train_launch
from repro_torch.models import build_model
from repro_torch.models import transformer
from repro_torch.optim import AdamWConfig
from repro_torch.serving import EngineConfig, MultiTenantEngine
from repro_torch.training import (
    init_train_state,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)

ARCH = "musicgen-medium"
# float32 through 3 layers, two frameworks: measured ~1e-6
APPLY_TOL = 1e-5
LOSS_ATOL = 1e-5
GRAD_ATOL = 1e-7
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _threads_and_jax_caches():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


@pytest.fixture(scope="module")
def models():
    jcfg = jax_reduced(ARCH).replace(dtype="float32")
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_reduced(ARCH).replace(dtype="float32"), "cpu")
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def _frames(cfg, B, S, seed=1):
    return (np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)) * 0.1).astype(
        np.float32)


def test_config_matches_the_reference():
    for mine, ref in ((get_config(ARCH), jax_config(ARCH)), (get_reduced(ARCH), jax_reduced(ARCH))):
        for f in ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                  "vocab_size", "d_head", "dtype"):
            assert getattr(mine, f) == getattr(ref, f), f
        for f in ("mode", "targets", "layers", "tau", "rank_cap"):
            assert getattr(mine.adapter, f) == getattr(ref.adapter, f), f


def test_apply_embeds_matches_jax(models):
    jm, jp, tm, tp = models
    emb = _frames(tm.cfg, 2, 16)
    want, _ = jm.apply(jp, embeds=jnp.asarray(emb), train=False)
    got = tm.apply(tp, embeds=torch.from_numpy(emb))
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    print(f"[parity] {ARCH} apply(embeds=): max|Δ| {err:.2e}")
    assert got.shape == (2, 16, tm.cfg.vocab_size) and err < APPLY_TOL
    # code tokens take the embedding table, as the dense family's do
    toks = np.random.default_rng(2).integers(0, tm.cfg.vocab_size, size=(2, 9)).astype(np.int32)
    want, _ = jm.apply(jp, tokens=jnp.asarray(toks), train=False)
    np.testing.assert_allclose(tm.apply(tp, torch.from_numpy(toks)).numpy(), np.asarray(want),
                               atol=APPLY_TOL)


def test_prefill_decode_matches_full(models):
    """``tests/test_decode_consistency.py:37-42``: a prefill of the first
    S-1 frames and a decode of the last against the full forward, in the
    port, and the port's logits against JAX's prefill and decode."""
    jm, jp, tm, tp = models
    B, S = 2, 12
    emb = _frames(tm.cfg, B, S)
    full = tm.apply(tp, embeds=torch.from_numpy(emb))
    cache = tm.init_decode_state(B, 32, torch.float32)
    pre, cache = tm.prefill(tp, cache, embeds=torch.from_numpy(emb[:, :S - 1]))
    dec, cache = tm.decode_step(tp, cache, embeds=torch.from_numpy(emb[:, S - 1:]))
    atol = 3e-5 * max(float(full.abs().max()), 1.0)
    np.testing.assert_allclose(pre.numpy(), full[:, S - 2].numpy(), atol=atol)
    np.testing.assert_allclose(dec.numpy(), full[:, S - 1].numpy(), atol=atol)
    jcache = jm.init_decode_state(B, 32, jnp.float32)
    jpre, jcache = jm.prefill(jp, jcache, embeds=jnp.asarray(emb[:, :S - 1]))
    jdec, jcache = jm.decode_step(jp, jcache, embeds=jnp.asarray(emb[:, S - 1:]))
    np.testing.assert_allclose(pre.numpy(), np.asarray(jpre), atol=APPLY_TOL)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), atol=APPLY_TOL)


def test_serving_steps_take_embeds_as_jax_does(models):
    """``make_prefill_step`` and ``make_decode_step`` (the audio branches of
    ``repro/training/steps.py:150``, ``:168``): the same logits and greedy
    next token as the reference's."""
    jm, jp, tm, tp = models
    emb = _frames(tm.cfg, 2, 7, seed=3)
    cache = tm.init_decode_state(2, 16, torch.float32)
    jcache = jm.init_decode_state(2, 16, jnp.float32)
    lg, cache = make_prefill_step(tm)(tp, cache, {"embeds": torch.from_numpy(emb[:, :6])})
    jlg, jcache = j_make_prefill_step(jm)(jp, jcache, {"embeds": jnp.asarray(emb[:, :6])})
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=APPLY_TOL)
    nxt, lg, cache = make_decode_step(tm)(tp, cache, {"embeds": torch.from_numpy(emb[:, 6:])})
    jnxt, jlg, jcache = j_make_decode_step(jm)(jp, jcache, {"embeds": jnp.asarray(emb[:, 6:])})
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=APPLY_TOL)
    assert nxt.shape == (2, 1) and nxt.dtype == torch.int32
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))


def test_one_train_step_on_frames_matches_jax(models):
    """One λ-only step on frame embeddings with code targets (every position
    weighted one): the λ gradients against ``jax.grad`` of the reference's
    loss, and the step's loss, grad norm and new λ against its
    ``make_train_step``."""
    jm, jp, tm, tp = models
    emb = _frames(tm.cfg, 2, 16, seed=4)
    tgt = np.random.default_rng(5).integers(0, tm.cfg.vocab_size, size=(2, 16)).astype(np.int32)
    jbatch = {"embeds": jnp.asarray(emb), "targets": jnp.asarray(tgt)}
    jstate = j_init_state(jm, None, params=jp)

    def jloss(trainable):
        params = jadp.merge(trainable, jstate["frozen"])
        kw, t, w = jsteps._model_inputs(jm.cfg, jbatch)
        logits, aux = jm.apply(params, train=True, **kw)
        ce, zl = jsteps.lm_loss(logits, t, w)
        return ce + jsteps.Z_LOSS_COEF * zl + jsteps.MOE_AUX_COEF * aux

    jgrads = jax.grad(jloss)(jstate["trainable"])
    jnew, jmet = j_make_step(jm, JAdamWConfig(lr=1e-2))(jstate, jbatch)
    tstate = init_train_state(tm, params=tp)
    tnew, tmet = make_train_step(tm, AdamWConfig(lr=1e-2))(
        tstate, {"embeds": torch.from_numpy(emb), "targets": torch.from_numpy(tgt)})
    for mod, projs in jgrads["groups"]["adapters"].items():
        for p, leaf in projs.items():
            want = np.asarray(leaf["lam"])
            got = tstate["trainable"]["groups"]["adapters"][mod][p]["lam"].grad.numpy()
            np.testing.assert_allclose(got, want, atol=GRAD_ATOL, err_msg=p)
            assert np.abs(want).max() > 1e-4  # a real gradient
            new = tnew["trainable"]["groups"]["adapters"][mod][p]["lam"].detach().numpy()
            np.testing.assert_allclose(
                new, np.asarray(jnew["trainable"]["groups"]["adapters"][mod][p]["lam"]),
                atol=1e-6)
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), atol=LOSS_ATOL)
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-6)


def test_engine_serves_codes_as_the_jax_engine(models):
    """The multi-tenant engine over code tokens (the default config, paged):
    identical streams and per-step schedule, logits within the bar."""
    jm, jp, tm, tp = models
    kw = dict(n_lanes=3, n_slots=5, max_len=48, collect_logits=True, block_size=8)
    jeng = JEngine(jm.cfg, JEngineConfig(**kw), params=jp)
    teng = MultiTenantEngine(tm.cfg, EngineConfig(**kw), params=tp, device="cpu")
    rng = np.random.default_rng(6)
    shape = np.asarray(jp["groups"]["adapters"]["attn"]["wq"]["lam"]).shape
    lams = {f"t{i}": {"attn": {p: (rng.standard_normal(shape) * 0.3).astype(np.float32)
                               for p in ("wq", "wv")}} for i in range(4)}
    traffic = [(f"t{i % 4}", rng.integers(2, tm.cfg.vocab_size, size=int(rng.integers(4, 20)))
                .astype(np.int32), int(rng.integers(4, 12))) for i in range(6)]
    runs = []
    for eng, j in ((jeng, True), (teng, False)):
        for t, lam in lams.items():
            eng.add_tenant(t, jax.tree_util.tree_map(jnp.asarray, lam) if j else lam)
        reqs = [eng.submit(t, p, n) for t, p, n in traffic]
        sched = []
        while eng.scheduler.has_work:
            eng.step()
            sched.append([(e.uid, e.lane, e.token, e.index) for e in eng.events])
        runs.append((reqs, sched))
    assert teng.layout == jeng.layout == "paged"
    assert runs[0][1] == runs[1][1]
    worst = 0.0
    for jr, tr in zip(runs[0][0], runs[1][0]):
        assert tr.tokens == jr.tokens
        d = np.abs(np.stack(tr.logits) - np.stack(jr.logits)).max()
        worst = max(worst, float(d))
    print(f"[parity] {ARCH} engine vs JAX engine: logits max|Δ| {worst:.2e}")
    assert worst < LOGIT_TOL
    assert teng.steps == jeng.steps


def test_serve_and_train_launchers_take_the_audio_arch(capsys, tmp_path):
    done = serve_multi.main(["--reduced", "--device", "cpu", "--arch", ARCH, "--gen-len", "6"])
    assert len(done) == 4 and "all 4 tenants match" in capsys.readouterr().out
    _, hist = train_launch.main(["--reduced", "--device", "cpu", "--arch", ARCH, "--steps", "3",
                                 "--batch", "2", "--seq", "16", "--log-every", "0",
                                 "--ckpt-dir", str(tmp_path / "ckpt")])
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    batch = next(train_launch.batches(get_reduced(ARCH), 2, 16, 0, "cpu"))
    assert set(batch) == {"embeds", "targets"} and batch["embeds"].shape == (2, 16, 64)


class _MetaGen(torch.Generator):
    """A generator whose draws land on the meta device (shapes only)."""

    @property
    def device(self):
        return torch.device("meta")


def test_param_count_at_full_width_on_meta_tensors():
    """``tests/test_models_smoke.py:84``'s bound for musicgen-medium (0.5-1.7×
    its published 1.5e9), counted over the port's full-width decoder params
    built on the meta device; the reference's analytic count is the same
    but for the RMS-norm scales (two a layer and the final one), which it
    leaves out."""
    cfg = get_config(ARCH)
    params = transformer.init_decoder_params(_MetaGen(), cfg)
    n = sum(t.numel() for t in jax.tree_util.tree_leaves(params))
    assert all(t.device.type == "meta" for t in jax.tree_util.tree_leaves(params))
    assert 0.5 * 1.5e9 < n < 1.7 * 1.5e9, n
    assert n - (2 * cfg.n_layers + 1) * cfg.d_model == jax_config(ARCH).param_count()
