"""Pivoted QR and rank selection of the PyTorch port against the JAX
reference and its NumPy oracle (float32, CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pivoted_qr as jqr
from repro_torch.core import pivoted_qr as tqr

# Q and R of the port within 1e-5 of the JAX function and of the float64
# NumPy oracle: entries are O(1) and both sides run float32 Householder
# steps, so they differ by summation order only (~1e-6 here).
ATOL = 1e-5


def _matrix(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(48, 48), (48, 16), (16, 48), (40, 24)])
def test_qr_pivoted_matches_jax_and_numpy(shape):
    W = _matrix(shape, seed=sum(shape))
    Q, R, perm = tqr.qr_pivoted(torch.from_numpy(W))
    jQ, jR, jperm = jqr.qr_pivoted(jnp.asarray(W))
    nQ, nR, nperm = jqr.qr_pivoted_np(W)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(perm.numpy(), nperm)
    print(f"[parity] qr_pivoted {shape}: max|ΔQ| {np.abs(Q.numpy() - np.asarray(jQ)).max():.2e} "
          f"max|ΔR| {np.abs(R.numpy() - np.asarray(jR)).max():.2e} vs JAX")
    np.testing.assert_allclose(Q.numpy(), np.asarray(jQ), atol=ATOL)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=ATOL)
    np.testing.assert_allclose(Q.numpy(), nQ, atol=ATOL)
    np.testing.assert_allclose(R.numpy(), nR, atol=ATOL)
    # diag R ≥ 0 and non-increasing in magnitude (the pivoting contract)
    d = torch.diagonal(R).numpy()
    assert (d >= 0).all() and (np.diff(d) <= 1e-5).all()


def test_qr_pivoted_num_reflectors_and_unpermute():
    W = _matrix((32, 24), seed=3)
    Q, R, perm = tqr.qr_pivoted(torch.from_numpy(W), num_reflectors=10)
    jQ, jR, jperm = jqr.qr_pivoted(jnp.asarray(W), num_reflectors=10)
    assert Q.shape == (32, 10) and R.shape == (10, 24)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_allclose(Q.numpy(), np.asarray(jQ), atol=ATOL)
    # full QR: Q · R̃ reconstructs W in the original column order
    Q, R, perm = tqr.qr_pivoted(torch.from_numpy(W))
    Rt = tqr.unpermute_columns(R, perm)
    np.testing.assert_allclose(
        Rt.numpy(), np.asarray(jqr.unpermute_columns(jnp.asarray(R.numpy()), jnp.asarray(perm.numpy()))),
        atol=0,
    )
    np.testing.assert_allclose((Q @ Rt).numpy(), W, atol=1e-4)


@pytest.mark.parametrize("policy,tau,fixed", [
    ("energy", 0.5, 0), ("energy", 0.9, 0), ("magnitude", 0.5, 0),
    ("magnitude", 0.1, 0), ("fixed", 0.0, 5),
])
def test_select_rank_matches_jax(policy, tau, fixed):
    rdiag = np.sort(np.abs(_matrix((32,), seed=7)))[::-1].copy()
    got = tqr.select_rank(torch.from_numpy(rdiag), policy, tau, fixed)
    want = int(jqr.select_rank(jnp.asarray(rdiag), policy, tau, fixed))
    assert got == want


def test_select_rank_rejects_unknown_policy():
    with pytest.raises(ValueError):
        tqr.select_rank(torch.ones(4), "bogus", 0.5)
