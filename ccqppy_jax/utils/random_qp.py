"""Random convex-QP ensemble generation, on device.

Replaces the reference's host-side generator
(``CCQPpy/benchmarks/benchmark_random_ccqp.py:36-63``): Hessian from
the Wishart distribution ``W(df=n, scale=I)`` and unconstrained optimum
``x ~ U(-1, 1)^n`` with ``b = -A x`` — but batched with ``jax.random`` so a
16k-problem ensemble materializes on the device in a few fused kernels
instead of a Python loop.  (A Wishart(n, I) draw is ``G G^T`` with ``G`` an n x n
standard normal.)  Unlike the reference — whose uniform draw ignores the
seed, making trials only partially reproducible — every draw here derives
from the caller's key.

``diag_boost`` adds ``c * n * I``: with 0 the raw Wishart is almost surely
full-rank but often ill-conditioned; benchmark configs that want
well-conditioned ensembles pass e.g. 1.0.
"""
from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp


def random_qp(key, n, dtype=jnp.float32, diag_boost=0.0):
    """One random QP: (A, b, x_uncon) with A ~ Wishart(n, I), b = -A x.

    Both products run at HIGHEST precision, so the ensemble does not
    depend on the backend's default matmul precision, and ``A`` is
    symmetrized so it is exactly symmetric whatever the GEMM's summation
    order."""
    hi = jax.lax.Precision.HIGHEST
    kg, kx = jax.random.split(key)
    G = jax.random.normal(kg, (n, n), dtype)
    A = jnp.dot(G, G.T, preferred_element_type=dtype, precision=hi)
    A = 0.5 * (A + A.T)
    if diag_boost:
        A = A + diag_boost * n * jnp.eye(n, dtype=dtype)
    x = jax.random.uniform(kx, (n,), dtype, minval=-1.0, maxval=1.0)
    b = -jnp.dot(A, x, preferred_element_type=dtype, precision=hi)
    return A, b, x


# Jitted generators/concats cached per static signature: a fresh ``jax.jit``
# per call would re-trace and re-compile every time.
@lru_cache(maxsize=32)
def _gen_fn(n, dtype, diag_boost):
    return jax.jit(jax.vmap(lambda k: random_qp(k, n, dtype, diag_boost)))


@lru_cache(maxsize=32)
def _concat_fn(num_parts):
    # Donating the parts lets XLA free each source chunk as it is copied
    # into the output, keeping the peak near 1x the final footprint — the
    # HBM cap that is chunked generation's whole purpose.
    return jax.jit(lambda *ps: tuple(
        jnp.concatenate([p[i] for p in ps]) for i in range(3)),
        donate_argnums=tuple(range(num_parts)))


def random_qp_batch(key, batch, n, dtype=jnp.float32, diag_boost=0.0,
                    chunk=None):
    """Batch of independent random QPs: A (B,n,n), b (B,n), x_uncon (B,n).

    ``chunk`` generates the batch in pieces of that size to cap peak HBM
    (the Wishart factor G transiently doubles the footprint of A).  Defaults
    to the whole batch below 256, else 256.
    """
    keys = jax.random.split(key, batch)
    gen = _gen_fn(int(n), jnp.dtype(dtype).name, float(diag_boost))
    if chunk is None:
        chunk = batch if batch <= 256 else 256
    if chunk >= batch:
        return gen(keys)
    parts = [gen(keys[i:i + chunk]) for i in range(0, batch, chunk)]
    return _concat_fn(len(parts))(*parts)


def block_tridiag_qp(n, seed=0, dtype=jnp.float32, block=4):
    """SPD block-tridiagonal QP in ELL layout: (op, b, x_exact).

    ``op`` is a ``BlockSparseOperator`` with ``block`` x ``block`` blocks,
    three per block row (left neighbour, diagonal, right neighbour), built
    directly in ELL layout so no dense matrix ever exists (n=1M is 4 TB
    dense).  Row-sum dominance keeps A SPD with a nontrivial spectrum
    (condition ~1e2).  ``x_exact ~ U(-0.5, 0.5)^n`` and ``b = -A x_exact``,
    so under the box [-1, 1]^n the constrained optimum is ``x_exact``.
    """
    import numpy as np

    from ccqppy_jax.ops.linop import BlockSparseOperator

    bs = int(block)
    nbr = int(n) // bs
    rng = np.random.default_rng(seed)
    # Off-diagonal block B_i couples block rows i and i+1.
    off = (0.35 * rng.standard_normal((nbr - 1, bs, bs))).astype(np.float32)
    diag = 0.35 * rng.standard_normal((nbr, bs, bs)).astype(np.float32)
    diag = 0.5 * (diag + diag.transpose(0, 2, 1)) + 3.0 * np.eye(bs, dtype=np.float32)

    blocks = np.zeros((nbr, 3, bs, bs), np.float32)
    cols = np.zeros((nbr, 3), np.int32)
    # slot 0: left neighbour (transpose of its off block), slot 1: diagonal,
    # slot 2: right neighbour.  Edge rows pad with zero blocks pointing at 0.
    blocks[1:, 0] = off.transpose(0, 2, 1)
    cols[1:, 0] = np.arange(nbr - 1)
    blocks[:, 1] = diag
    cols[:, 1] = np.arange(nbr)
    blocks[:-1, 2] = off
    cols[:-1, 2] = np.arange(1, nbr)

    op = BlockSparseOperator(jnp.asarray(blocks, dtype), jnp.asarray(cols),
                             nbr * bs)
    x_exact = jnp.asarray(rng.uniform(-0.5, 0.5, nbr * bs), dtype)
    b = -op.matvec(x_exact)
    return op, b, x_exact
