"""Barzilai-Borwein projected gradient descent (BBPGD) and its fallback
variant (BBPGDf).

JAX re-design of the reference ``CCQPSolverBBPGD`` ("Algorithm 1 of
Yan 2019", ``CCQPpy/src/ccqppy/solvers.py:560-693``) and
``CCQPSolverBBPGDf`` ("Algorithm 5 of Pospisil 2015b", ``solvers.py:696-843``).
Per outer iteration: one matvec, one projection, three dot products — all
fused inside a single ``lax.while_loop`` body.

Matvec accounting note: the reference does NOT count the matvec spent on the
initial BB step ``alpha0 = g.g / g.Ag`` (``solvers.py:635``); we count every
operator application, so our reported count is exactly one higher on the same
trajectory (SURVEY.md section 7 "matvec-count parity").
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ccqppy_jax.models.base import (SolverConfig, default_x0, eps_of,
                                    init_trace, make_result, pg_residual,
                                    record_trace)
from ccqppy_jax.ops.linop import as_operator
from ccqppy_jax.ops.projections import identity


@dataclasses.dataclass(frozen=True)
class BBPGDConfig(SolverConfig):
    """precond: "none" or "jacobi".  Jacobi runs the iteration in the
    diag(A)-metric: steps x <- proj(x - a D^-1 g) with the BB1 step computed
    in the scaled inner product (dx.D dx / dx.dg).  Exact for separable sets
    (the D-metric projection onto a box is still a coordinatewise clip);
    convergence is still measured with the UNSCALED Eq.25 residual, so
    stopping semantics match the unpreconditioned solver.  A capability the
    reference lacks entirely; helps when diag(A) is strongly heterogeneous
    (e.g. multi-scale contact problems)."""

    precond: str = "none"


@dataclasses.dataclass(frozen=True)
class BBPGDfConfig(BBPGDConfig):
    pass


class _State(NamedTuple):
    x: jax.Array
    g: jax.Array
    alpha: jax.Array
    res: jax.Array
    mv: jax.Array
    it: jax.Array
    done: jax.Array
    # fallback tracking (BBPGDf; unused by plain BBPGD)
    resmin: jax.Array
    xmin: jax.Array
    gmin: jax.Array
    trace: jax.Array


def _init(op, b, x0, proj, config, dinv):
    g0 = op.matvec(x0) + b
    res0 = pg_residual(proj, x0, g0, config.gd, op)
    # Initial BB step; in the Jacobi metric this is the scaled Rayleigh
    # quotient (g.D^-1 g) / (D^-1 g . A D^-1 g).
    s0g = dinv * g0 if dinv is not None else g0
    gAg = op.dot(s0g, op.matvec(s0g))
    num = op.dot(g0, s0g) if dinv is not None else op.dot(g0, g0)
    alpha0 = num / gAg
    inf = jnp.asarray(jnp.inf, b.dtype)
    return _State(
        x=x0, g=g0, alpha=alpha0, res=res0,
        mv=jnp.int32(2), it=jnp.int32(0), done=res0 < config.tol,
        resmin=inf, xmin=x0, gmin=g0, trace=init_trace(config, b.dtype),
    )


def _solve(A, b, x0, proj, config, fallback: bool):
    op = as_operator(A)
    b = jnp.asarray(b)
    proj = proj if proj is not None else identity()
    x0 = default_x0(b, x0, proj)
    if config.precond == "jacobi":
        diag = op.diagonal()
        dinv = 1.0 / diag
    else:
        diag = dinv = None
    s0 = _init(op, b, x0, proj, config, dinv)
    tiny = eps_of(b)

    def cond(s):
        return ~s.done

    def body(s):
        # Gradient-projection step with the current BB1 step size
        # (Jacobi-scaled when preconditioning is on).
        step_dir = dinv * s.g if dinv is not None else s.g
        x = proj.project(s.x - s.alpha * step_dir)
        g = op.matvec(x) + b
        mv = s.mv + 1
        res = pg_residual(proj, x, g, config.gd, op)
        done = (res < config.tol) | (mv >= config.max_matvecs)

        if fallback:
            # Track the best-so-far point (``solvers.py:792-796``)...
            better = res < s.resmin
            resmin = jnp.where(better, res, s.resmin)
            xmin = jnp.where(better, x, s.xmin)
            gmin = jnp.where(better, g, s.gmin)
            # ...and on step-size stagnation restart from it with a tiny
            # projected-gradient step (``solvers.py:798-800``).  Note the
            # reference keeps the *stale* gradient g after the restart — a
            # faithful quirk we replicate (the next alpha heals it).
            x = jnp.where(s.alpha < tiny, proj.project(xmin - config.gd * gmin), x)
        else:
            resmin, xmin, gmin = s.resmin, s.xmin, s.gmin

        # BB1 step: alpha = dx.dx / (dx.dg + 10 eps)  (``solvers.py:653-656``);
        # in the Jacobi metric the numerator is dx.D dx.
        dx = x - s.x
        dg = g - s.g
        num = op.dot(dx, diag * dx) if diag is not None else op.dot(dx, dx)
        alpha = num / (op.dot(dx, dg) + tiny)
        return _State(x, g, alpha, res, mv, s.it + 1, done,
                      resmin, xmin, gmin, record_trace(s.trace, s.it, res))

    s = lax.while_loop(cond, body, s0)
    return make_result(s.x, s.res, s.mv, s.it, config.max_matvecs, s.trace)


@partial(jax.jit, static_argnames=("config",))
def solve(A, b, x0=None, proj=None, config: BBPGDConfig = BBPGDConfig()):
    """BBPGD (Yan 2019 Alg. 1)."""
    return _solve(A, b, x0, proj, config, fallback=False)


@partial(jax.jit, static_argnames=("config",))
def solve_fallback(A, b, x0=None, proj=None,
                   config: BBPGDfConfig = BBPGDfConfig()):
    """BBPGD with stagnation fallback (Pospisil 2015b Alg. 5)."""
    return _solve(A, b, x0, proj, config, fallback=True)
