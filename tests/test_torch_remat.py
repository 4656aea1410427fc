"""Remat (``cfg.remat``, on by default as in the reference) on the port's
decoders: for every decoder family, reduced and in float32, a train step
with remat on and off gives the same loss, the same gradient on every
trainable leaf and the same updated λ, bit for bit (the recompute runs the
same operations on the same inputs); counting the one-λ matmul's calls
shows the backward recomputes the forward when remat is on and not when it
is off; and no serve path (prefill, decode, the speculative verify, a
``MultiTenantEngine`` step, a forward without grad) reaches
``torch.utils.checkpoint.checkpoint``."""
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from repro_torch.configs import get_reduced
from repro_torch.kernels import qrlora_matmul as mm
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.serving import BASE_TENANT, EngineConfig, MultiTenantEngine
from repro_torch.training import init_train_state, make_train_step
from repro_torch.tree import tree_leaves

FAMILIES = {"dense": "smollm-135m", "audio": "musicgen-medium", "moe": "moonshot-v1-16b-a3b",
            "vlm": "llama-3.2-vision-11b", "ssm": "xlstm-125m",
            "hybrid": "jamba-1.5-large-398b"}
B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Torch's CPU ops on two threads in this module (the suite's parallel
    workers oversubscribe larger OpenMP teams)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
    if cfg.family == "audio":
        return {"embeds": torch.from_numpy(rng.standard_normal((B, S, cfg.d_model),
                                                               np.float32) * 0.1),
                "targets": tokens}
    batch = {"tokens": tokens}
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_image), np.float32))
    return batch


_PARAMS = {}


def _params(arch):
    """Reduced float32 params, λ drawn nonzero (a λ = 0 start would leave
    half the adapter gradient identically zero); built once per arch."""
    if arch not in _PARAMS:
        model = build_model(get_reduced(arch).replace(dtype="float32"), "cpu")
        params = model.init(torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(1)
        for projs in params["groups"]["adapters"].values():
            for leaf in projs.values():
                leaf["lam"] = torch.randn(leaf["lam"].shape, generator=gen) * 0.3
        _PARAMS[arch] = params
    return _PARAMS[arch]


def _step(arch, remat):
    """One train step (two microbatches) → (metrics, gradient leaves, new λ
    leaves, one-λ matmul calls in the step)."""
    cfg = get_reduced(arch).replace(dtype="float32", remat=remat, microbatches=2)
    model = build_model(cfg, "cpu")
    state = init_train_state(model, params=_params(arch))
    calls = []
    real = mm.qrlora_matmul

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    mm.qrlora_matmul = counted
    try:
        new, metrics = make_train_step(model, AdamWConfig(lr=1e-2))(state, _batch(cfg))
    finally:
        mm.qrlora_matmul = real
    grads = [p.grad for p in tree_leaves(state["trainable"])]
    return metrics, grads, tree_leaves(new["trainable"]), len(calls)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_changes_no_number(family):
    arch = FAMILIES[family]
    on, off = _step(arch, True), _step(arch, False)
    for k in ("loss", "ce", "aux", "grad_norm"):
        assert torch.equal(torch.as_tensor(on[0][k]), torch.as_tensor(off[0][k])), k
    assert len(on[1]) == len(off[1]) > 0
    for a, b in zip(on[1], off[1]):
        assert a is not None and torch.equal(a, b)
    assert any(bool((g != 0).any()) for g in on[1])
    for a, b in zip(on[2], off[2]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_recomputes_the_forward(family):
    """The one-λ matmul's calls in a step: the forwards' alone without remat;
    with remat the backward calls it again (each group recomputed once, and
    inside the vlm, ssm and hybrid groups a position's own checkpoint may
    recompute it once more), never fewer than once a forward call."""
    arch = FAMILIES[family]
    fwd = _step(arch, False)[3]
    with_remat = _step(arch, True)[3]
    assert fwd > 0
    if family in ("vlm", "ssm", "hybrid"):
        assert 2 * fwd <= with_remat <= 3 * fwd
    else:
        assert with_remat == 2 * fwd


def _no_checkpoint(monkeypatch):
    def boom(*args, **kw):
        raise AssertionError("a serve path reached torch.utils.checkpoint.checkpoint")

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", boom)


@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid", "vlm"])
def test_serve_paths_never_checkpoint(family, monkeypatch):
    """Prefill and decode (and the dense family's speculative verify) with
    grad enabled, the forward without ``train``, and a train forward under
    ``no_grad``: none reaches the checkpoint wrapper (patched to raise)."""
    _no_checkpoint(monkeypatch)
    arch = FAMILIES[family]
    cfg = get_reduced(arch).replace(dtype="float32")
    model = build_model(cfg, "cpu")
    params = _params(arch)
    batch = _batch(cfg)
    kw = {"image_embeds": batch["image_embeds"]} if family == "vlm" else {}
    tokens = batch["tokens"]
    model.apply(params, tokens, **kw)
    with torch.no_grad():
        model.apply(params, tokens, train=True, **kw)
    cache = model.init_decode_state(B, 32, torch.float32)
    _, cache = model.prefill(params, cache, tokens, **kw)
    model.decode_step(params, cache, tokens[:, :1], **kw)
    if family == "dense":
        cache = model.init_decode_state(B, 32, torch.float32, per_lane=True)
        _, cache = model.prefill(params, cache, tokens[:, :8])
        model.verify_step(params, cache, tokens[:, 8:11])


def test_engine_serve_never_checkpoints(monkeypatch):
    """A ``MultiTenantEngine`` serve (the paged default layout) runs to its
    end with the checkpoint wrapper patched to raise."""
    _no_checkpoint(monkeypatch)
    cfg = get_reduced("smollm-135m").replace(dtype="float32")
    eng = MultiTenantEngine(cfg, EngineConfig(n_lanes=2, n_slots=2, max_len=32),
                            params=_params("smollm-135m"), device="cpu")
    req = eng.submit(BASE_TENANT, np.arange(2, 9, dtype=np.int32), 4)
    done = eng.run()
    assert len(done[req.uid].tokens) == 4
