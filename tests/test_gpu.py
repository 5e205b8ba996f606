"""Checks that need the card: the precision of the dense operators' GEMVs
and the batched Cholesky inverse.  Marked ``gpu``; the ``gpu`` fixture
skips them on a run without one.  ``python chip_smoke.py`` runs them.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ccqppy_jax.ops.linop import DenseOperator, FastDense
from ccqppy_jax.utils.random_qp import random_qp_batch

pytestmark = pytest.mark.gpu

N = 1000


def _ensemble(batch, seed=0):
    As, _, _ = random_qp_batch(jax.random.PRNGKey(seed), batch, N,
                               jnp.float32, diag_boost=1.0)
    x = jax.random.uniform(jax.random.PRNGKey(seed + 1), (batch, N),
                           jnp.float32, -1.0, 1.0)
    A64 = np.asarray(As, np.float64)
    y64 = np.einsum("kij,kj->ki", A64, np.asarray(x, np.float64))
    return As, x, A64, y64


def _rel_err(y, y64):
    return float(np.max(np.abs(np.asarray(y, np.float64) - y64))
                 / np.max(np.abs(y64)))


def test_highest_gemv_matches_f64(gpu):
    """DenseOperator's batched GEMV (HIGHEST) is f32-accurate at n=1000."""
    As, x, _, y64 = _ensemble(16)
    y = jax.jit(jax.vmap(lambda A, v: DenseOperator(A).matvec(v)))(As, x)
    assert _rel_err(y, y64) <= 1e-5


def test_default_gemv_error_model(gpu):
    """FastDense's DEFAULT batched GEMV stays within its documented error
    model (ops/linop.py FastDense)."""
    As, x, _, y64 = _ensemble(16)
    y = jax.jit(jax.vmap(lambda A, v: FastDense(A).matvec(v)))(As, x)
    assert _rel_err(y, y64) <= 1e-5


def test_default_gemm_precision(gpu):
    """At DEFAULT precision an f32 matrix-matrix product on this card runs
    with TF32 products: its error is far above f32 rounding, and HIGHEST
    restores it."""
    As, _, A64, _ = _ensemble(1)
    X = jax.random.uniform(jax.random.PRNGKey(5), (N, 64), jnp.float32,
                           -1.0, 1.0)
    ref = A64[0] @ np.asarray(X, np.float64)
    lo = jax.jit(lambda a, b: jnp.dot(a, b))(As[0], X)
    hi = jax.jit(lambda a, b: jnp.dot(
        a, b, precision=jax.lax.Precision.HIGHEST))(As[0], X)
    assert _rel_err(hi, ref) <= 1e-5
    assert 1e-5 < _rel_err(lo, ref) <= 1e-2


def test_cholesky_inverse_matches_scipy(gpu):
    """spd_inverse_batch (batched Cholesky + triangular solve) against
    scipy's f64 cho_solve: Frobenius error within 5 cond(A) sqrt(n) eps."""
    import scipy.linalg as sl

    from ccqppy_jax.models.direct import spd_inverse_batch

    As, _, A64, _ = _ensemble(4, seed=2)
    Ainv = np.asarray(spd_inverse_batch(As, chunk=2), np.float64)
    eye = np.eye(N)
    for A, Ai in zip(A64, Ainv):
        X = sl.cho_solve(sl.cho_factor(A), eye)
        ev = np.linalg.eigvalsh(A)
        bound = 5 * ev[-1] / ev[0] * np.sqrt(N) * np.finfo(np.float32).eps
        assert np.linalg.norm(Ai - X) / np.linalg.norm(X) <= bound
