"""Decoder forward, prefill and decode of the PyTorch port against the JAX
reference: same params (initialised in JAX, crossed over with
``repro_torch.interop``), same token inputs from numpy, float32 on the CPU.

Logits bound: 2e-5 absolute.  Logits are O(1) (unit-variance unembedding of
an RMS-normalised state); both sides run the same float32 arithmetic in a
different summation order through 3 layers, which measures ~2e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models import build_model as jax_build
from repro_torch.configs import get_reduced
from repro_torch.interop import params_from_jax
from repro_torch.models import build_model

ATOL = 2e-5


@pytest.fixture(scope="module")
def models():
    jcfg = jax_reduced("smollm-135m").replace(dtype="float32")
    cfg = get_reduced("smollm-135m").replace(dtype="float32")
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jm, jp, build_model(cfg, "cpu"), tp


def _tokens(shape, seed=0, vocab=256):
    return np.random.default_rng(seed).integers(2, vocab, size=shape).astype(np.int32)


def test_apply_logits_match_jax(models):
    jm, jp, tm, tp = models
    toks = _tokens((2, 11))
    want, _ = jm.apply(jp, tokens=jnp.asarray(toks), train=False)
    got = tm.apply(tp, torch.from_numpy(toks))
    print(f"[parity] apply logits: max|Δ| {np.abs(got.numpy() - np.asarray(want)).max():.2e}")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_dense_prefill_and_decode_logits_match_jax(models):
    """The lock-step dense cache the merged-weight reference decodes with."""
    jm, jp, tm, tp = models
    toks = _tokens((2, 9), seed=1)
    jc = jm.init_decode_state(2, 32, jnp.float32)
    tc = tm.init_decode_state(2, 32, torch.float32)
    jl, jc = jm.prefill(jp, jc, tokens=jnp.asarray(toks))
    tl, tc = tm.prefill(tp, tc, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    worst = np.abs(tl.numpy() - np.asarray(jl)).max()
    for step in range(4):
        nxt = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
        jl, jc = jm.decode_step(jp, jc, token=jnp.asarray(nxt))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(nxt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, err_msg=f"step {step}")
        worst = max(worst, np.abs(tl.numpy() - np.asarray(jl)).max())
    print(f"[parity] dense prefill+decode logits: max|Δ| {worst:.2e}")
    assert int(tc["pos"]) == int(jc["pos"]) == 13


def _lam_tables(params_np, n_slots=4, seed=2):
    """Each adapter's λ leaf replaced by a (n_layers, n_slots, cap) table,
    slot 0 zero — the λ-store's install layout."""
    rng = np.random.default_rng(seed)
    out = {}
    for mod, projs in params_np["groups"]["adapters"].items():
        for proj, leaf in projs.items():
            G, cap = leaf["lam"].shape
            tab = (rng.standard_normal((G, n_slots, cap)) * 0.3).astype(np.float32)
            tab[:, 0] = 0.0
            out[(mod, proj)] = tab
    return out


def _with_tables(params, tables, to):
    groups = dict(params["groups"])
    adapters = {m: dict(p) for m, p in groups["adapters"].items()}
    for (mod, proj), tab in tables.items():
        adapters[mod][proj] = {**adapters[mod][proj], "lam": to(tab)}
    return {**params, "groups": {**groups, "adapters": adapters}}


def test_paged_prefill_and_decode_with_seg_match_jax(models):
    """The serving path: bucketed block-aligned prefill of two lanes with
    different tenants through a paged view, then shared decode steps with
    per-lane slot ids and an attend bound."""
    jm, jp, tm, tp = models
    tables = _lam_tables(jax.tree_util.tree_map(np.asarray, jp))
    jv = _with_tables(jp, tables, jnp.asarray)
    tv = _with_tables(tp, tables, torch.from_numpy)
    bs, max_len, n_lanes = 4, 32, 2
    jc = jm.init_decode_state(n_lanes, max_len, jnp.float32, paged=True, block_size=bs)
    tc = tm.init_decode_state(n_lanes, max_len, torch.float32, paged=True, block_size=bs)
    next_block, lanes = 1, []
    for lane, (P, slot) in enumerate(((5, 2), (9, 3))):
        Pb = 8 if P <= 8 else 16
        padded = np.zeros((Pb,), np.int32)
        padded[:P] = _tokens((P,), seed=10 + lane)
        nb = -(-P // bs)
        blocks = list(range(next_block, next_block + nb))
        next_block += nb
        write_ids = np.zeros((Pb // bs,), np.int32)
        write_ids[:nb] = blocks
        row = np.zeros((max_len // bs,), np.int32)
        row[:nb] = blocks
        seg, length = np.asarray([slot], np.int32), np.asarray([P], np.int32)
        jl, filled = jm.prefill(jv, jm.paged_prefill_view(jc, jnp.asarray(write_ids)),
                                tokens=jnp.asarray(padded)[None], seg_ids=jnp.asarray(seg),
                                length=jnp.asarray(length))
        jc = jm.commit_paged_prefill(jc, filled, lane, jnp.asarray(row), P)
        tl, filled = tm.prefill(tv, tm.paged_prefill_view(tc, torch.from_numpy(write_ids)),
                                torch.from_numpy(padded)[None], seg_ids=torch.from_numpy(seg),
                                length=torch.from_numpy(length))
        tm.commit_paged_prefill(tc, filled, lane, torch.from_numpy(row), P)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        lanes.append((slot, int(np.argmax(np.asarray(jl)[0]))))
    seg = np.asarray([s for s, _ in lanes], np.int32)
    tok = np.asarray([[t] for _, t in lanes], np.int32)
    for step in range(3):  # stays inside the prompts' last blocks: no growth needed
        jl, jc = jm.decode_step(jv, jc, token=jnp.asarray(tok), seg_ids=jnp.asarray(seg),
                                attend_blocks=4)
        tl, tc = tm.decode_step(tv, tc, torch.from_numpy(tok), seg_ids=torch.from_numpy(seg),
                                attend_blocks=4)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, err_msg=f"step {step}")
        print(f"[parity] paged decode step {step} logits: "
              f"max|Δ| {np.abs(tl.numpy() - np.asarray(jl)).max():.2e}")
        tok = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
    np.testing.assert_array_equal(tc["layers"]["attn"]["idx"].numpy(),
                                  np.asarray(jc["layers"]["attn"]["idx"]))
    np.testing.assert_array_equal(tc["layers"]["attn"]["block_tbl"].numpy(),
                                  np.asarray(jc["layers"]["attn"]["block_tbl"]))
    # the pools hold the same K/V in every block the lanes own
    owned = list(range(1, next_block))
    np.testing.assert_allclose(tc["layers"]["attn"]["k"][:, owned].numpy(),
                               np.asarray(jc["layers"]["attn"]["k"])[:, owned], atol=ATOL)


def test_paged_cache_lane_axes_match_jax(models):
    jm, _, tm, _ = models
    assert tm.lane_axes() == jm.lane_axes(paged=True)


def test_apply_bf16_logits_match_jax_within_rounding():
    """bfloat16, with nonzero λ so every adapted projection takes the one-λ
    matmul route.  The port keeps (x·B)⊙λ in fp32 there (the reference's
    kernel oracle), where the reference's XLA training path rounds it to
    bf16; with the other rounding points of a bf16 forward, logits of 3
    layers read max|Δ| 0.046 at max|logit| 3.7.  Bound: 2^-5 of the largest
    |logit|."""
    jm = jax_build(jax_reduced("smollm-135m"))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    for projs in params["groups"]["adapters"].values():
        for leaf in projs.values():
            leaf["lam"] = (rng.standard_normal(leaf["lam"].shape) * 0.3).astype(np.float32)
    toks = _tokens((2, 11), seed=3)
    want, _ = jm.apply(jax.tree_util.tree_map(jnp.asarray, params), tokens=jnp.asarray(toks),
                       train=False)
    got = build_model(get_reduced("smollm-135m"), "cpu").apply(
        params_from_jax(params, device="cpu"), torch.from_numpy(toks))
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    print(f"[parity] bf16 apply logits: max|Δ| {err:.2e} (max|logit| {np.abs(want).max():.2f})")
    assert err <= 2**-5 * np.abs(want).max()
