"""Linear-operator tests: dense, block-sparse (ELL), scipy-BSR builder, and
solving through a block-sparse Hessian (the contact-mechanics configuration:
block-sparse A + blockwise cone/box constraints)."""
import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

import ccqppy_jax as cq
from ccqppy_jax.models import BBPGDConfig, MPRGPBBConfig
from ccqppy_jax.ops.linop import BlockSparseOperator, DenseOperator


def _block_tridiag(nb, bs, seed=0, dtype=np.float64):
    """SPD block-tridiagonal matrix (nb blocks of size bs)."""
    rng = np.random.default_rng(seed)
    n = nb * bs
    D = rng.standard_normal((n, n)) * 0.1
    A = np.zeros((n, n))
    # banded mask: keep block tridiagonal
    for i in range(nb):
        for j in range(max(0, i - 1), min(nb, i + 2)):
            A[i*bs:(i+1)*bs, j*bs:(j+1)*bs] = D[i*bs:(i+1)*bs, j*bs:(j+1)*bs]
    A = 0.5 * (A + A.T) + 2.0 * np.eye(n)
    return A.astype(dtype)


def test_from_scipy_bsr_matvec_matches_dense():
    bs, nb = 4, 6
    A = _block_tridiag(nb, bs)
    op = BlockSparseOperator.from_scipy_bsr(
        sp.bsr_matrix(A, blocksize=(bs, bs)), dtype=jnp.float64)
    x = jnp.asarray(np.random.default_rng(1).standard_normal(nb * bs))
    np.testing.assert_allclose(np.asarray(op.matvec(x)), A @ np.asarray(x),
                               atol=1e-12)
    assert abs(float(op.inf_norm()) - np.abs(A).sum(axis=1).max()) < 1e-12


def test_blocksparse_solver_end_to_end():
    """BBPGD through a block-sparse operator matches the dense solve."""
    bs, nb = 4, 8
    A = _block_tridiag(nb, bs, seed=2)
    n = nb * bs
    rng = np.random.default_rng(3)
    x_exact = rng.uniform(-0.5, 0.5, n)
    b = jnp.asarray(-A @ x_exact)
    proj = cq.box(-jnp.ones(n, jnp.float64), jnp.ones(n, jnp.float64),
                  jnp.float64)
    cfg = BBPGDConfig(tol=1e-10, max_matvecs=5000)

    op_sparse = BlockSparseOperator.from_scipy_bsr(
        sp.bsr_matrix(A, blocksize=(bs, bs)), dtype=jnp.float64)
    r_sparse = cq.models.bbpgd.solve(op_sparse, b, proj=proj, config=cfg)
    r_dense = cq.models.bbpgd.solve(jnp.asarray(A), b, proj=proj, config=cfg)

    assert bool(r_sparse.converged)
    np.testing.assert_allclose(np.asarray(r_sparse.x), np.asarray(r_dense.x),
                               atol=1e-9)
    np.testing.assert_allclose(np.asarray(r_sparse.x), x_exact, atol=1e-6)


def test_blocksparse_mprgp_bb_with_cone_blocks():
    """The BASELINE 'n=10k block-sparse + disjoint cone' configuration in
    miniature: block-sparse A, blockwise Lorentz-cone constraint."""
    bs, nb = 3, 12
    A = _block_tridiag(nb, bs, seed=4)
    n = nb * bs
    rng = np.random.default_rng(5)
    x_t = rng.uniform(-1, 1, n)
    b = jnp.asarray(-A @ x_t)
    proj = cq.blockwise(cq.lorentz_cone(1.0, jnp.float64), 3)
    op = BlockSparseOperator.from_scipy_bsr(
        sp.bsr_matrix(A, blocksize=(bs, bs)), dtype=jnp.float64)
    r = cq.models.mprgp.solve_bb(op, b, proj=proj,
                                 config=MPRGPBBConfig(tol=1e-8,
                                                      max_matvecs=10000))
    assert bool(r.converged)
    # KKT check: projected gradient residual near zero and feasible iterate
    assert bool(proj.contains(r.x))
    assert float(r.residual) < 1e-8


def test_blocksparse_memory_footprint():
    """The ELL layout only stores the nonzero band: for block-tridiagonal,
    3 blocks/row vs nb blocks/row dense."""
    bs, nb = 4, 32
    A = _block_tridiag(nb, bs, seed=6)
    op = BlockSparseOperator.from_scipy_bsr(
        sp.bsr_matrix(A, blocksize=(bs, bs)), dtype=jnp.float64)
    assert op.blocks.shape[1] <= 3
    dense_elems = (nb * bs) ** 2
    assert op.blocks.size < 0.2 * dense_elems


# ------------------------------------------------------- generators
def test_random_qp_exactly_symmetric_and_consistent():
    """The Wishart generator gives an exactly symmetric A (whatever the
    GEMM's summation order) and b == -A x_uncon to f32 rounding."""
    import jax

    from ccqppy_jax.utils.random_qp import random_qp, random_qp_batch

    A, b, x = random_qp(jax.random.PRNGKey(3), 48, jnp.float32, 1.0)
    A, b, x = (np.asarray(v) for v in (A, b, x))
    assert A.dtype == np.float32
    np.testing.assert_array_equal(A, A.T)
    ref = -(A.astype(np.float64) @ x.astype(np.float64))
    scale = np.abs(A.astype(np.float64)) @ np.abs(x.astype(np.float64))
    assert np.all(np.abs(b - ref) <= 8 * np.finfo(np.float32).eps * scale)
    As, bs, _ = random_qp_batch(jax.random.PRNGKey(3), 5, 24, jnp.float32,
                                1.0, chunk=2)
    As = np.asarray(As)
    assert As.shape == (5, 24, 24) and np.asarray(bs).shape == (5, 24)
    np.testing.assert_array_equal(As, As.transpose(0, 2, 1))
    assert np.all(np.linalg.eigvalsh(As.astype(np.float64)) >= 24 - 1e-3)


def test_block_tridiag_qp_matches_dense():
    """The ELL block-tridiagonal generator: SPD, matvec == its dense form,
    b == -A x_exact, and PCG under the box recovers the interior x_exact."""
    import ccqppy_jax as cq
    from ccqppy_jax.models import PCGConfig
    from ccqppy_jax.utils.random_qp import block_tridiag_qp

    n, bs = 64, 4
    op, b, x_exact = block_tridiag_qp(n, seed=1, dtype=jnp.float64, block=bs)
    assert op.blocks.shape == (n // bs, 3, bs, bs) and op.n == n
    dense = np.zeros((n, n))
    blocks, cols = np.asarray(op.blocks), np.asarray(op.cols)
    for r in range(n // bs):
        for k in range(3):
            c = cols[r, k]
            dense[r*bs:(r+1)*bs, c*bs:(c+1)*bs] += blocks[r, k]
    np.testing.assert_allclose(dense, dense.T, atol=1e-15)
    assert np.linalg.eigvalsh(dense)[0] > 0
    np.testing.assert_allclose(np.asarray(b), -dense @ np.asarray(x_exact),
                               rtol=1e-6, atol=1e-6)
    proj = cq.box(-jnp.ones(n, jnp.float64), jnp.ones(n, jnp.float64),
                  jnp.float64)
    r = cq.models.pcg.solve(op, b, proj=proj,
                            config=PCGConfig(tol=1e-10, max_matvecs=500))
    assert bool(r.converged)
    np.testing.assert_allclose(np.asarray(r.x), np.asarray(x_exact),
                               atol=1e-7)


def test_fast_dense_contract_and_rr_solve():
    """FastDense: one f32 buffer, cheap DEFAULT-precision ``matvec`` +
    HIGHEST ``matvec_exact``.  On the CPU both tiers are full f32, so this
    asserts the CONTRACT and the rr-PCG integration; the DEFAULT error on
    the card is checked by tests/test_gpu.py."""
    import jax

    import ccqppy_jax as cq
    from ccqppy_jax.models import PCGConfig
    from ccqppy_jax.ops.linop import DenseOperator, FastDense

    rng = np.random.default_rng(0)
    n = 64
    G = rng.standard_normal((n, n))
    A = jnp.asarray(G @ G.T + n * np.eye(n), jnp.float32)
    b = jnp.asarray(-np.asarray(A) @ rng.uniform(-1, 1, n), jnp.float32)
    op = FastDense(A)
    x = jnp.asarray(rng.standard_normal(n), jnp.float32)
    # exact path identical to DenseOperator's HIGHEST matvec
    np.testing.assert_array_equal(np.asarray(op.matvec_exact(x)),
                                  np.asarray(DenseOperator(A).matvec(x)))
    assert op.diagonal().shape == (n,)
    # rr-PCG over FastDense converges with a verified (exact-sweep) residual
    proj = cq.box(-jnp.ones(n, jnp.float32), jnp.ones(n, jnp.float32))
    cfg = PCGConfig(tol=1e-5, max_matvecs=500, refresh_every=8,
                    segment_drop=3e-2)
    r = cq.models.pcg.solve(op, b, proj=proj, config=cfg)
    assert bool(r.converged)
    g = np.asarray(op.matvec_exact(r.x)) + np.asarray(b)
    from ccqppy_jax.models.base import pg_residual
    tres = float(pg_residual(proj, r.x, jnp.asarray(g), 1e-6, op))
    assert tres <= 1e-5 * 1.02
