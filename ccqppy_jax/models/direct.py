"""Direct-factorization serving mode: fixed Hessians, streaming right-hand
sides.

The headline serving workload (bench.py; BASELINE.json north star) streams
perturbed right-hand sides against a FIXED ensemble of Hessians — the
regime the batched iterative solvers attack with ~16 HBM sweeps of A per
solve.  With A fixed, a direct factorization is legitimate one-time
preprocessing with the same status as the Jacobi warm start's ``diag(A)``
(a property of the fixed ensemble; the per-call x0 is recomputed from each
incoming b inside the timed region):

  prep (once, outside the serving clock):
      A^-1 for every ensemble member via batched Cholesky
      (``spd_inverse_batch`` — chunked, f32, HIGHEST precision).
  per call (timed):
      x0 = proj(A^-1 (-b))          -- ONE HBM sweep (of A^-1)
      g  = A x0 + b; Eq.25 residual -- ONE verification sweep (of A)
      straggler lanes (res > tol) polish via warm-started PCG.

Accuracy anchor: the f32 Cholesky inverse of a cond~5 SPD matrix applies
with relative error ~cond * eps_f32 ~ 3e-7, so the unconstrained-optimal
x0 carries residual ||A (x0 - x*)|| / (3n) ~ 1e-5-grade — below the serving
tolerance on the conditioned box ensemble; lanes whose box clips bite
harder are caught by the verification sweep and finished iteratively.

When NOT to use it: the inversion costs O(B n^3) once (amortized over the
stream); a workload with per-solve fresh Hessians must use the iterative
solvers (the A changes, the factorization doesn't transfer), and curved
sets (cones) with strongly active constraints gain little because the
unconstrained optimum is far from the constrained one — the projected
inverse guess no longer lands below tol.  The reference has no
counterpart (its only warm-start hook is the ``x0`` argument,
``CCQPpy/src/ccqppy/solvers.py:19,94`` — this module is that
hook, weaponized).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ccqppy_jax.models.pcg import PCGConfig


def spd_inverse_batch(As, chunk=128):
    """Batched SPD inverse via Cholesky: ``A^-1 = L^-T L^-1`` per lane.

    Runs in chunks of ``chunk`` lanes to bound transient workspace (L, I,
    L^-1 are each chunk x n x n), writing into a DONATED accumulator so
    peak HBM stays ~ |As| + |out| + one chunk's workspace — at the
    headline scale (B=1024, n=1000) that is 4.1 + 4.1 + ~1 GB.  All
    matmuls at HIGHEST precision: a reduced-precision inverse would put
    the projected guess's residual far above the serving tolerance.
    """
    As = jnp.asarray(As)
    B, n, _ = As.shape

    @jax.jit
    def inv_chunk(Ac):
        with jax.default_matmul_precision("highest"):
            L = jax.lax.linalg.cholesky(Ac)
            eye = jnp.broadcast_to(jnp.eye(n, dtype=Ac.dtype), Ac.shape)
            Linv = jax.lax.linalg.triangular_solve(L, eye, left_side=True,
                                                   lower=True)
            return jnp.einsum("bki,bkj->bij", Linv, Linv,
                              precision=jax.lax.Precision.HIGHEST)

    from functools import partial

    @partial(jax.jit, static_argnums=2, donate_argnums=0)
    def upd(buf, c, i):
        return jax.lax.dynamic_update_slice(buf, c, (i, 0, 0))

    out = jnp.zeros_like(As)
    for i in range(0, B, int(chunk)):
        out = upd(out, inv_chunk(As[i:i + int(chunk)]), i)
    return out


@jax.jit
def direct_x0(Ainv, b, proj):
    """Projected inverse apply ``proj(A^-1 (-b))`` — the direct warm start.

    HIGHEST-precision GEMV (see ``spd_inverse_batch``) with the post-GEMV
    optimization barrier (ops/linop.py ``_gemv_fence``).
    """
    y = jnp.einsum("bij,bj->bi", Ainv, -b,
                   preferred_element_type=b.dtype,
                   precision=jax.lax.Precision.HIGHEST)
    y = jax.lax.optimization_barrier(y)
    return jax.vmap(proj.project)(y)


def solve_direct_batched(Ainv, A, b, proj, config: PCGConfig = None,
                         phase1=3, bucket=64, host_fallback=True):
    """Direct-serving batched solve: warm start from the precomputed
    inverse, verify with one fresh sweep, polish stragglers with compacted
    warm-started PCG.

    Composes the existing verified pipeline: ``pcg`` with the direct x0
    converges at its init+verification for lanes the projected inverse
    already solves (the typical case), and runs normally for the rest;
    ``solve_batched_fused_compact`` gathers the stragglers.  Matvec counts
    include the A^-1 application (+1 per lane), so reported totals reflect
    every operator-sized HBM sweep spent.
    """
    from ccqppy_jax.parallel.batch import solve_batched_fused_compact

    config = config if config is not None else PCGConfig(tol=1e-5,
                                                         max_matvecs=500)
    x0 = direct_x0(Ainv, b, proj)
    r = solve_batched_fused_compact("pcg", A, b, phase1, x0=x0, proj=proj,
                                    config=config, bucket=bucket,
                                    host_fallback=host_fallback)
    return dataclasses.replace(r, matvecs=r.matvecs + 1)
