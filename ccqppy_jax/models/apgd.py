"""Nesterov-accelerated projected gradient descent (APGD) and the
anti-relaxation variant (APGD-AR).

JAX re-design of the reference ``CCQPSolverAPGD`` ("Algorithm 6 of
Pospisil 2015" with Mazhar-2015 backtracking, ``CCQPpy/src/ccqppy/
solvers.py:197-367``) and ``CCQPSolverAPGDAntiRelaxation``
(``solvers.py:370-557``).  The data-dependent Lipschitz backtracking loop —
the reference's inner ``while True`` doubling L per trial — becomes a nested
``lax.while_loop`` whose carry holds (x_trial, A x_trial, L, mv), bounded by
``max_backtracks`` as an infinite-loop guard (f64 can only double ~60 times
before overflow anyway).

Anti-relaxation differences (Mazhar 2015 lines 18-28):
* tracks the best-residual iterate and returns it, not the last
  (``solvers.py:500-503, 525``);
* restarts momentum when g . (x+ - x) > 0 (``solvers.py:510-512``).
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
class APGDConfig(SolverConfig):
    """backtrack_grow:   L multiplier on a failed Lipschitz trial
                         (reference hard-codes 2, ``solvers.py:306``).
    relax:              L multiplier after each outer iteration
                         (reference hard-codes 0.9, ``solvers.py:328``).
    max_backtracks:     static bound on the inner loop (guard only).
    anti_relaxation:    enable the Mazhar best-iterate + restart variant.
    """

    backtrack_grow: float = 2.0
    relax: float = 0.9
    max_backtracks: int = 64
    anti_relaxation: bool = False
    # fp slack on the Lipschitz test, in units of machine eps (see
    # quad_bound_holds): violations below ~backtrack_slack*eps*|f| are
    # treated as satisfied.  0 reproduces the reference's strict test
    # bit-for-bit (the trajectory-parity tests use that); the default makes
    # deep-tolerance solves robust — without it, rounding-noise "violations"
    # near convergence double L unboundedly (measured L -> 6.6e5 and a
    # frozen iterate at res ~ 7e-10 on the README box QP in f64, while the
    # default converges to 3.8e-11 in 89 matvecs).
    backtrack_slack: float = 16.0


class _State(NamedTuple):
    x: jax.Array       # x_k
    y: jax.Array       # extrapolated point y_k
    theta: jax.Array
    L: jax.Array
    res: jax.Array
    mv: jax.Array
    it: jax.Array
    done: jax.Array
    # anti-relaxation tracking
    resmin: jax.Array
    xhat: jax.Array
    trace: jax.Array


class _Inner(NamedTuple):
    x1: jax.Array
    Ax1: jax.Array
    L: jax.Array
    mv: jax.Array
    ok: jax.Array
    bt: jax.Array


@partial(jax.jit, static_argnames=("config",))
def solve(A, b, x0=None, proj=None, config: APGDConfig = APGDConfig()):
    op = as_operator(A)
    b = jnp.asarray(b)
    proj = proj if proj is not None else identity()
    x0 = default_x0(b, x0, proj)
    dtype = b.dtype

    # Initial Lipschitz estimate L0 = ||A (x0 - 1)|| / ||x0 - 1||
    # (``solvers.py:263-268``), guarded against x0 == 1.
    xdiff = x0 - jnp.ones_like(x0)
    num = op.norm(op.matvec(xdiff))
    den = op.norm(xdiff)
    L0 = jnp.where(den > 0, num / jnp.where(den > 0, den, 1), jnp.asarray(1.0, dtype))

    inf = jnp.asarray(jnp.inf, dtype)
    s0 = _State(x=x0, y=x0, theta=jnp.asarray(1.0, dtype), L=L0,
                res=inf, mv=jnp.int32(1), it=jnp.int32(0),
                done=jnp.asarray(False),
                resmin=inf, xhat=x0, trace=init_trace(config, dtype))

    def cond(s):
        return ~s.done

    def body(s):
        Ay = op.matvec(s.y)
        mv = s.mv + 1
        g = Ay + b

        # Trial point at the current 1/L step.
        x1 = proj.project(s.y - g / s.L)
        rhs_const = 0.5 * op.dot(s.y, Ay) + op.dot(s.y, b)

        def quad_bound_holds(x1, Ax1, L):
            # f(x1) <= f(y) + g.(x1-y) + L/2 ||x1-y||^2  (Mazhar line 9).
            # The fp slack makes the test robust near convergence: both
            # sides are O(f(x)) values agreeing to machine precision there,
            # so the strict inequality turns into coin-flip rounding noise —
            # measured on the README box QP at res ~ 1e-10 (f64), noise
            # failures doubled L to 6.6e5 and froze the iterate (the
            # reference has the same hazard, ``solvers.py:477-480``, and
            # merely converges before hitting it).  A violation below fp
            # resolution is treated as satisfied.
            lhs = 0.5 * op.dot(x1, Ax1) + op.dot(x1, b)
            d = x1 - s.y
            rhs = rhs_const + op.dot(g, d) + 0.5 * L * op.dot(d, d)
            slack = (config.backtrack_slack * jnp.finfo(dtype).eps
                     * (jnp.abs(lhs) + jnp.abs(rhs)))
            return lhs <= rhs + slack

        Ax1_0 = op.matvec(x1)
        i0 = _Inner(x1, Ax1_0, s.L, mv + 1,
                    quad_bound_holds(x1, Ax1_0, s.L), jnp.int32(0))

        def icond(c):
            return (~c.ok) & (c.mv < config.max_matvecs) & (c.bt < config.max_backtracks)

        def ibody(c):
            L = c.L * config.backtrack_grow
            x1 = proj.project(s.y - g / L)
            Ax1 = op.matvec(x1)
            return _Inner(x1, Ax1, L, c.mv + 1,
                          quad_bound_holds(x1, Ax1, L), c.bt + 1)

        c = lax.while_loop(icond, ibody, i0)
        x1, Ax1, L, mv = c.x1, c.Ax1, c.L, c.mv

        # Momentum update (Pospisil 2015 lines 7-8 / ``solvers.py:313-316``).
        th = s.theta
        th1 = 0.5 * (-th * th + th * jnp.sqrt(4 + th * th))
        beta = th * (1 - th) / (th * th + th1)
        y1 = (1 + beta) * x1 - beta * s.x

        res = pg_residual(proj, x1, Ax1 + b, config.gd, op)

        if config.anti_relaxation:
            better = res < s.resmin
            resmin = jnp.where(better, res, s.resmin)
            xhat = jnp.where(better, x1, s.xhat)
            # Momentum restart on non-monotone progress (Mazhar lines 25-28).
            restart = op.dot(g, x1 - s.x) > 0
            y1 = jnp.where(restart, x1, y1)
            th1 = jnp.where(restart, 1.0, th1)
        else:
            resmin, xhat = s.resmin, s.xhat

        done = (res < config.tol) | (mv >= config.max_matvecs)
        return _State(x1, y1, th1, L * config.relax, res, mv, s.it + 1, done,
                      resmin, xhat, record_trace(s.trace, s.it, res))

    s = lax.while_loop(cond, body, s0)
    x_out = s.xhat if config.anti_relaxation else s.x
    return make_result(x_out, s.res, s.mv, s.it, config.max_matvecs, s.trace)


def solve_anti_relaxation(A, b, x0=None, proj=None,
                          config: APGDConfig = None):
    """APGD-AR: best-iterate tracking + momentum restart."""
    if config is None:
        config = APGDConfig(anti_relaxation=True)
    elif not config.anti_relaxation:
        config = dataclasses.replace(config, anti_relaxation=True)
    return solve(A, b, x0, proj, config=config)


@dataclasses.dataclass(frozen=True)
class APGDSCConfig(SolverConfig):
    """Strong-convexity accelerated projected gradient (``solve_sc``).

    restart: gradient-mapping momentum restart (O'Donoghue-Candes): reset
    the extrapolation whenever the prox-gradient direction opposes the
    momentum, guarding against the limit cycles a mis-estimated mu can
    induce.  Costs nothing (the test reuses in-hand vectors).

    bound_iters: power-iteration count for the IN-SOLVE spectral-bound
    fallback used when the operator carries no mu (raw arrays): 2 x
    bound_iters matvecs, honestly charged to the budget.  Production
    ensembles precompute bounds once (``estimate_spectral_bounds``) and
    wrap in ``SpectralDense`` instead."""

    restart: bool = True
    bound_iters: int = 32


class _SCState(NamedTuple):
    x: jax.Array
    y: jax.Array          # extrapolated point
    res: jax.Array
    mv: jax.Array
    it: jax.Array
    done: jax.Array
    verifying: jax.Array  # a stale-gradient claim awaits a fresh check
    trace: jax.Array


@partial(jax.jit, static_argnames=("config",))
def solve_sc(A, b, x0=None, proj=None, config: APGDSCConfig = APGDSCConfig()):
    """Accelerated projected gradient with OPTIMAL CONSTANT MOMENTUM for
    strongly convex problems — the round-5 cone-ensemble workhorse.

    Classic APGD (``solve`` above; reference ``solvers.py:197-367``) uses
    the 1/k^2 theta-sequence and pays backtracking matvecs to find L.  When
    spectral bounds L >= lambda_max, mu <= lambda_min are KNOWN (carried by
    the operator — ``SpectralDense``; estimated once per fixed ensemble via
    ``estimate_spectral_bounds``), the optimal schedule is a fixed step 1/L
    with constant momentum beta = (1-sqrt(mu/L))/(1+sqrt(mu/L)), giving the
    linear rate 1 - sqrt(mu/L) per iteration at exactly ONE matvec per
    iteration — no backtracking, no branch divergence under vmap, and
    (unlike MPRGP's three-branch active-set machinery) no sensitivity to
    curved-set face structure.  Measured on the headline cone ensemble
    (B=1024, n=999, 333 Lorentz blocks, tol 1e-5): p50 21 matvecs vs fused
    MPRGP-BB's 40, conv 1.0, true residuals <= 7.6e-6.

    Verified convergence (repo bar, models/pcg.py): the per-iteration
    gradient is FRESH at the extrapolated point y, so the Eq.25 residual at
    the new iterate x1 is evaluated with a slightly stale gradient — a
    claim; a ``verifying`` iteration then spends its matvec on ``A x1`` and
    only a fresh-gradient residual below tol may exit.  Failed claims
    resume with a plain prox step from x (its fresh gradient is in hand).
    """
    op = as_operator(A)
    b = jnp.asarray(b)
    proj = proj if proj is not None else identity()
    x0 = default_x0(b, x0, proj)
    dtype = b.dtype
    L, mu = op.spectral_bounds()
    mv0 = jnp.int32(0)
    if mu is None:
        # In-solve fallback: estimate both spectrum ends by power iteration
        # through op.matvec (lambda_min via the shifted operator c I - A,
        # whose top eigenvalue is c - lambda_min).  2 x bound_iters matvecs,
        # charged to the budget — precompute + SpectralDense for ensembles.
        k = int(config.bound_iters)
        tiny = jnp.finfo(dtype).tiny
        v0 = jnp.full_like(b, 1.0) / jnp.sqrt(jnp.asarray(b.size, dtype))

        def _lam_max(shift):
            def apply(v):
                Av = op.matvec(v)
                return jnp.where(shift > 0, shift * v - Av, Av)

            def pbody(i, v):
                w = apply(v)
                return w / (op.norm(w) + tiny)

            v = lax.fori_loop(0, k, pbody, v0)
            return op.dot(v, apply(v))

        L = 1.02 * _lam_max(jnp.asarray(0.0, dtype))
        shift = 1.01 * L
        mu = jnp.maximum(0.98 * (shift - _lam_max(shift)), 0.0)
        mv0 = jnp.int32(2 * k + 2)
    L = jnp.asarray(L, dtype)
    q = jnp.clip(jnp.asarray(mu, dtype) / L, 1e-12, 1.0)
    beta = (1 - jnp.sqrt(q)) / (1 + jnp.sqrt(q))

    x_init = proj.project(x0)
    s0 = _SCState(x=x_init, y=x_init, res=jnp.asarray(jnp.inf, dtype),
                  mv=mv0, it=jnp.int32(0),
                  done=mv0 >= config.max_matvecs,
                  verifying=jnp.asarray(False),
                  trace=init_trace(config, dtype))

    def body(s):
        v = jnp.where(s.verifying, s.x, s.y)
        g = op.matvec(v) + b                     # the one sweep (fresh at v)
        mv = s.mv + 1
        x1 = proj.project(s.y - g / L)
        x1v = proj.project(s.x - g / L)          # resume step on failed claim
        x_eval = jnp.where(s.verifying, s.x, x1)
        res = pg_residual(proj, x_eval, g, config.gd, op)
        if config.restart:
            do_restart = op.dot(s.y - x1, x1 - s.x) > 0
        else:
            do_restart = jnp.asarray(False)
        b_eff = jnp.where(do_restart, 0.0, beta)
        done_v = s.verifying & (res < config.tol)
        x_next = jnp.where(done_v, s.x, jnp.where(s.verifying, x1v, x1))
        y_next = jnp.where(s.verifying, x_next, x1 + b_eff * (x1 - s.x))
        done = done_v | (mv >= config.max_matvecs)
        verifying1 = ~s.verifying & (res < config.tol) & ~done
        return _SCState(x_next, y_next, res, mv, s.it + 1, done, verifying1,
                        record_trace(s.trace, s.it, res))

    s = lax.while_loop(lambda s: ~s.done, body, s0)
    # make_result's converged := mv < max keeps unverified budget-edge
    # claims honest; every done_v exit carries a fresh-gradient residual.
    return make_result(s.x, s.res, s.mv, s.it, config.max_matvecs, s.trace)
