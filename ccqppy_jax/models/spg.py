"""Spectral projected gradient for QP (SPG-QP).

JAX re-design of the reference ``CCQPSolverSPG`` ("Algorithm 5 of
Pospisil 2018", ``CCQPpy/src/ccqppy/solvers.py:846-999``).

Differences by design:
* The GLL nonmonotone memory — a Python ``deque(maxlen=m)`` in the reference
  (``solvers.py:931-932``) — becomes a fixed (m,)-shaped ring buffer carried
  in the loop state (initialised to -inf so ``max`` over it is exact).
* The randomized step ``beta_k ~ U(sigma1, min(betahat, sigma2))`` uses a
  threaded ``jax.random`` key instead of the reference's *global-state*
  ``np.random.uniform`` (``solvers.py:959``) — runs are reproducible per seed
  and independent across vmapped lanes (keys are split per problem by the
  batch API).  Like numpy, ``maxval < minval`` simply samples from the
  reversed interval (both compute ``lo + (hi - lo) * u``).
* Faithful quirks kept and documented: the objective surrogate is initialised
  to ``f0 = g.x`` (not the true objective, ``solvers.py:923``) and its update
  uses ``betak^2`` on the *linear* term (``solvers.py:963`` — textbook GLL
  uses ``betak``).
* The reference's convergence test is ``||d_k|| <= tol`` (``solvers.py:949``),
  NOT the Eq.25 residual — a criterion that can report false convergence when
  the step collapses.  Our default is the honest ``criterion="eq25"``; the
  faithful ``"d_norm"`` is available behind the config flag (see SPGConfig).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ccqppy_jax.models.base import (SolverConfig, default_x0, init_trace,
                                    make_result, pg_residual, record_trace)
from ccqppy_jax.ops.linop import as_operator
from ccqppy_jax.ops.projections import identity


@dataclasses.dataclass(frozen=True)
class SPGConfig(SolverConfig):
    """m / tau / sigma1 / sigma2: reference ctor args (``solvers.py:856-857``).

    criterion: "eq25" (default: stop on the Mazhar Eq.25 projected-gradient
    residual like every other solver) or "d_norm" (faithful reference
    behavior: stop on ``||d_k|| <= tol``, ``solvers.py:949``).  The faithful
    criterion can declare success far from optimality when the step
    collapses — measured on the n=10k Lorentz-cone benchmark:
    ||d||-converged with a TRUE Eq.25 residual of 5.8e-1 — so it is opt-in
    (used by the reference-parity tests), not the default: no solver default
    may report converged with a true residual above tol.  "eq25" costs no
    extra matvec (the gradient carry is exact) and makes the reported
    residual comparable across solvers."""

    m: int = 5
    tau: float = 0.5
    sigma1: float = 0.01
    sigma2: float = 0.5
    criterion: str = "eq25"


class _State(NamedTuple):
    x: jax.Array
    g: jax.Array
    f: jax.Array
    alpha: jax.Array
    fq: jax.Array      # (m,) ring buffer of surrogate objective values
    fq_pos: jax.Array
    key: jax.Array
    res: jax.Array     # ||d_k||
    mv: jax.Array
    it: jax.Array
    done: jax.Array
    trace: jax.Array


@partial(jax.jit, static_argnames=("config",))
def solve(A, b, x0=None, proj=None, config: SPGConfig = SPGConfig(),
          key=None):
    op = as_operator(A)
    b = jnp.asarray(b)
    proj = proj if proj is not None else identity()
    x0 = default_x0(b, x0, proj)
    dtype = b.dtype
    if key is None:
        key = jax.random.PRNGKey(0)

    # Init (Pospisil 2018 lines 1-3 / ``solvers.py:920-932``): two matvecs.
    g0 = op.matvec(x0) + b
    f0 = op.dot(g0, x0)
    alpha0 = op.dot(g0, g0) / op.dot(g0, op.matvec(g0))
    fq0 = jnp.full((config.m,), -jnp.inf, dtype).at[0].set(f0)

    s0 = _State(x=x0, g=g0, f=f0, alpha=alpha0, fq=fq0,
                fq_pos=jnp.int32(1), key=key,
                res=jnp.asarray(jnp.inf, dtype), mv=jnp.int32(2),
                it=jnp.int32(0), done=jnp.asarray(False),
                trace=init_trace(config, dtype))

    def cond(s):
        return ~s.done

    def body(s):
        d = proj.project(s.x - s.alpha * s.g) - s.x
        Ad = op.matvec(d)
        mv = s.mv + 1

        dd = op.dot(d, d)
        dAd = op.dot(d, Ad)
        dg = op.dot(d, s.g)

        if config.criterion == "eq25":
            res = pg_residual(proj, s.x, s.g, config.gd, op)
        else:
            res = jnp.sqrt(dd)
        done = (res <= config.tol) | (mv >= config.max_matvecs)

        # Safeguarded nonmonotone step (lines 9-18 / ``solvers.py:953-959``).
        fmax = jnp.max(s.fq)
        xi = (fmax - s.f) / dAd
        beta = -dg / dAd
        betahat = config.tau * beta + jnp.sqrt(
            jnp.maximum(config.tau**2 * beta**2 + 2 * xi, 0))
        key, sub = jax.random.split(s.key)
        hi = jnp.minimum(betahat, config.sigma2)
        betak = config.sigma1 + (hi - config.sigma1) * jax.random.uniform(sub, dtype=dtype)

        x = s.x + betak * d
        g = s.g + betak * Ad
        f = s.f + betak * betak * dg + 0.5 * betak**2 * dAd
        fq = s.fq.at[s.fq_pos % config.m].set(f)

        alpha = dd / dAd
        # Freeze the state when done so the reported (x, res) match the
        # reference's break-before-update semantics.
        x = jnp.where(done, s.x, x)
        g = jnp.where(done, s.g, g)
        f = jnp.where(done, s.f, f)
        fq = jnp.where(done, s.fq, fq)
        alpha = jnp.where(done, s.alpha, alpha)
        return _State(x, g, f, alpha, fq, s.fq_pos + 1, key, res, mv,
                      s.it + 1, done, record_trace(s.trace, s.it, res))

    s = lax.while_loop(cond, body, s0)
    return make_result(s.x, s.res, s.mv, s.it, config.max_matvecs, s.trace)
