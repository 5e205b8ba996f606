"""PCG — projected conjugate gradients with active-set restarts.

A solver the reference does not have, designed for batched execution on an
accelerator.  Motivation: MPRGP (models/mprgp.py) is the matvec-optimal polisher,
but under ``vmap`` its three-way ``lax.cond`` lowers to *both* branches
executing masked — ~3 matvecs of HBM traffic per iteration, which inflates
the wall-clock of a batched ensemble even when the matvec COUNT is low.
PCG is the
branch-free reformulation: every iteration costs exactly ONE matvec of
bandwidth, in or out of ``vmap``.

Algorithm (per iteration, state ``x`` feasible, ``g = A x + b`` exact):

1. ``Ap = A p``                                   (the only matvec)
2. ``alpha = min(alpha_cg, alpha_feasible)`` with ``alpha_cg = r.r / p.(m*Ap)``
   and the exact closed-form max feasible step of the projection algebra
   (``Projection.max_feasible_step`` — the reference bisects instead,
   ``CCQPpy/src/ccqppy/solvers.py:1112-1118``).
3. ``x += alpha p``; ``g += alpha Ap``            (gradient stays EXACT)
4. Refresh the binding mask ``m = proj.binding_mask(x, g)`` — free since no
   matvec is needed; bounds release the moment their gradient sign flips
   (MPRGP needs a proportioning matvec for the same effect).
5. ``r = -m * g``; restart CG (``beta = 0``) whenever the active set changed
   or the step hit a bound, else standard Fletcher-Reeves update.

The gradient carry is exact in exact arithmetic — but over 100+ f32
iterations its accumulated rounding drifts from the truth (measured:
cond~200 families reported converged at carried-res < tol with TRUE
residuals 3x above), so the plain path VERIFIES every convergence claim
against a freshly recomputed gradient and resumes until the true Eq. 25
residual passes (see the nested-loop structure in ``_solve``); the
reported residual and flag always come from a fresh gradient.  There is
likewise no silent mask-staleness failure mode (a frozen active set would
falsely report convergence on ~9%% of Wishart box lanes — measured).  Restricted to sets with a meaningful per-coordinate binding mask
(identity / bounds / box and blockwise/product compositions); on curved sets
(ball, cone) the conservative default mask freezes boundary lanes, which then
exit at the matvec budget and should be finished by a fallback solver — the
``parallel.mixed`` pipeline does exactly that.

Uses: (a) standalone first-order solver — on box ensembles it reaches tol in
fewer matvecs than BBPGD; (b) warm-started polish phase of the
mixed-precision ladder (``parallel/mixed.py``).
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
class PCGConfig(SolverConfig):
    """precond: "none" or "jacobi".  Jacobi preconditions the face-restricted
    CG with M = diag(A): the recurrence carries z = M^-1 r and conjugates in
    the M-inner product (beta = r1.z1 / r.z) — textbook preconditioned CG
    restricted to the current free set.  The preconditioner application is
    elementwise (free — no extra HBM sweep of A), active-set logic and the
    Eq.25 stopping residual are untouched, so convergence *semantics* match
    the unpreconditioned solver while the sweep COUNT drops on problems with
    strongly heterogeneous diag(A) (measured, f64 n=48 1e3-condition-spread
    diagonal family at tol 1e-8: 94 -> 6 matvecs; BBPGD 363 -> 7 on the
    same problem; parity on flat-diagonal Wishart —
    tests/test_solvers.py::test_jacobi_precond_matvec_win).
    No reference counterpart (SURVEY.md section 5.6).

    refresh_every: 0 (default) = plain single-precision PCG.  > 0 enables
    MIXED-PRECISION RESIDUAL REPLACEMENT: CG sweeps ride ``op.matvec`` (for
    ``MixedPrecDense``, the bfloat16-resident copy — half the HBM bytes)
    in segments of at most ``refresh_every``
    iterations; at each segment end the gradient is recomputed with
    ``op.matvec_exact`` (f32, HIGHEST), the TRUE Eq.25 residual is evaluated,
    and CG restarts from the exact gradient.  This is textbook iterative
    refinement in correction form: within a segment the carried gradient
    drifts from the truth by (A - A_low)(x - x_seg_start) — proportional to
    the segment's own step, so each refresh cycle reduces the TRUE residual
    by a factor ~ ||A - A_low|| ||A^-1|| and convergence goes arbitrarily far
    below the bf16 operator floor.  Every reported residual and the converged
    flag come from exact-gradient evaluations only.  With a single-precision
    operator the path is valid but pointless (matvec_exact == matvec).

    inner_margin: segment early-stop factor — a segment ends when its
    (perturbed-system) residual estimate falls below ``tol * inner_margin``
    or after ``refresh_every`` iterations, whichever first.

    segment_drop: relative per-segment stop (0 disables).  A refinement
    cycle against a low-precision operator can only reduce the TRUE residual
    by a factor ~ ||A - A_low|| ||A^-1|| regardless of how far the segment
    pushes its own (perturbed) residual — iterations beyond that cap are
    wasted.  With ``segment_drop = c``, a segment also stops once its
    estimate falls below ``c * res_segment_start``, so each cycle spends
    only the iterations its precision can cash.  Calibration: c ~ a few x
    ||A - A_low||/||A|| * cond(A); ~3e-2 for bfloat16 (2^-8 rounding) and
    ~4e-3 for float16 (2^-11) on cond~5 ensembles.

    refresh_restart: True (default) restarts CG (beta = 0) at every refresh —
    the iterative-refinement correction form.  False KEEPS the conjugate
    direction across the refresh (van der Vorst-style: r replaced by the
    exact residual, p continued via the standard beta update).  MEASURED:
    keep-p is strictly worse here — the bf16 replacement perturbation
    (~||A - A_low|| cond(A) relative, ~2e-2) breaks conjugacy faster than
    the saved restarts pay back (f64 n=64 box QP, tol 1e-5: restart 31
    matvecs, keep-p 78; at tol 1e-10 keep-p fails outright).  The flag stays
    for operators with much smaller low-precision error."""

    precond: str = "none"
    refresh_every: int = 0
    inner_margin: float = 0.3
    refresh_restart: bool = True
    segment_drop: float = 0.0


class _State(NamedTuple):
    x: jax.Array
    g: jax.Array
    m: jax.Array        # binding mask (1 = coordinate free to move)
    r: jax.Array        # face-restricted steepest descent -m*g
    p: jax.Array        # conjugate direction (supported on the free set)
    rr: jax.Array       # r.z (== r.r unpreconditioned)
    res: jax.Array
    mv: jax.Array
    it: jax.Array
    done: jax.Array
    trace: jax.Array


def _solve(A, b, x0, proj, config):
    op = as_operator(A)
    b = jnp.asarray(b)
    proj = proj if proj is not None else identity()
    if not proj.polyhedral:
        # Curved sets break the two PCG invariants (exact feasible steps and
        # a meaningful per-coordinate binding mask): from a cone apex every
        # descent direction can have max_feasible_step 0, stalling the loop
        # at the initial iterate for the whole budget (measured on the n=10k
        # cone benchmark).  ``proj``'s structure is trace-static, so this
        # delegates at compile time to MPRGP-BB — the robust curved-set
        # solver (100% convergence on the Wishart cone ensembles where the
        # BB-projection family limit-cycles: projection onto a curved set
        # breaks the BB secant pair, stalling BBPGD/BBPGDf on 47-89% of
        # lanes at tol 1e-5; benchmarks/results/disjoint_constraints.json).
        from ccqppy_jax.models import mprgp
        cfg = mprgp.MPRGPBBConfig(tol=config.tol,
                                  max_matvecs=config.max_matvecs,
                                  gd=config.gd, trace_len=config.trace_len)
        if cfg.fused:   # the single-sweep default (MPRGPConfig.fused)
            return mprgp._solve_fused(op, b, x0, proj, cfg, bb_variant=True)
        return mprgp._solve(op, b, x0, proj, cfg, bb_variant=True)
    x0 = default_x0(b, x0, proj)
    tiny = eps_of(b)

    if config.precond == "jacobi":
        diag = op.diagonal()
        dinv = 1.0 / jnp.maximum(diag, tiny)
        prec = lambda r: dinv * r
    else:
        prec = lambda r: r

    if config.refresh_every > 0:
        return _solve_rr(op, b, x0, proj, config, prec, tiny)

    def body(s):
        Ap = op.matvec(s.p)
        mv = s.mv + 1
        mAp = s.m * Ap
        pAp = op.dot(s.p, mAp)
        alpha_cg = s.rr / (pAp + tiny)
        # max_feasible_step is defined for steps x - a*q; we move along +p.
        alpha_f = op.reduce_min(proj.max_feasible_step(s.x, -s.p))
        alpha = jnp.minimum(alpha_cg, jnp.maximum(alpha_f, 0.0))
        # project() only clears fp dust: the step is feasible by construction.
        x = proj.project(s.x + alpha * s.p)
        g = s.g + alpha * Ap
        # Snap newly-binding coordinates exactly onto their bound: a
        # CG-limited step can stop inside the at-bound proximity band, and
        # without the snap the mask freezes the coordinate a band-width
        # short — a permanent Eq.25 floor of |g_i|*dist/gd (see
        # Projection.snap_binding).  The <=32-ulp move is below one
        # matvec's rounding in the gradient carry.
        x = proj.snap_binding(x, g)
        m = proj.binding_mask(x, g)
        changed = jnp.any(m != s.m)
        r = -m * g
        z = m * prec(r)
        rr = op.dot(r, z)
        restart = changed | (alpha_f < alpha_cg)
        beta = jnp.where(restart, 0.0, rr / (s.rr + tiny))
        p = z + beta * s.p
        res = pg_residual(proj, x, g, config.gd, op)
        # rr == 0 (exactly: r = -m*g is a masked copy and z = m*dinv*r with
        # dinv > 0, so a fully-frozen mask zeroes r.z bit-exactly) with
        # res >= tol: no direction is left to move in — stalled.  The test
        # must be exact, not a tiny-threshold: rr is a SQUARED (M-weighted)
        # norm, so near-convergence gradients legitimately pass below any
        # absolute epsilon (a 10*eps threshold falsely stalled f64 solves
        # one iteration short of a 1e-10 tol).
        # ``mv + 1``: one matvec of budget is reserved for the segment's
        # verification refresh (below), so reported totals never exceed
        # config.max_matvecs.
        done = (res < config.tol) | (mv + 1 >= config.max_matvecs) \
            | (rr == 0)
        return _State(x, g, m, r, p, rr, res, mv, s.it + 1, done,
                      record_trace(s.trace, s.it, res))

    # VERIFIED CONVERGENCE (round 4): the in-loop residual above is computed
    # from the CARRIED gradient recurrence ``g += alpha Ap`` — exact in exact
    # arithmetic, but over hundreds of f32 iterations the accumulated
    # rounding drifts it from the truth (measured: cond~200 Wishart families
    # report converged at carried-res < 2e-5 with TRUE residuals 3x above —
    # round-3 ``results/illcond.json``).  So the while-loop is nested: each
    # inner segment runs on the cheap recurrence until it CLAIMS res < tol
    # (or stalls/budget), then one fresh ``g = A x + b`` re-evaluates the
    # true Eq.25 residual; the loop resumes from the exact gradient until
    # the claim verifies.  Cost in the no-drift case: exactly one extra
    # sweep per solve.  This is the repo-wide bar (models/spg.py): no solver
    # default may report converged with a true residual above tol.
    def inner_init(x, g, res, mv, it, trace):
        x = proj.snap_binding(x, g)
        m = proj.binding_mask(x, g)
        r = -m * g
        z = m * prec(r)
        rr = op.dot(r, z)
        return _State(x=x, g=g, m=m, r=r, p=z, rr=rr, res=res, mv=mv, it=it,
                      done=(res < config.tol) | (mv + 1 >= config.max_matvecs)
                      | (rr == 0),
                      trace=trace)

    def outer_body(o):
        s = lax.while_loop(lambda s: ~s.done, body,
                           inner_init(o.x, o.g, o.res, o.mv, o.it, o.trace))
        # Verification refresh at the operator's EXACT precision (identical
        # to matvec for plain operators; load-bearing for FastDense, whose
        # cheap sweep carries bf16-grade product rounding).
        g_t = op.matvec_exact(s.x) + b
        mv = s.mv + 1
        res_t = pg_residual(proj, s.x, g_t, config.gd, op)
        # it == o.it: the segment had no room to move (frozen mask or
        # budget) — a further segment would spin; exit with the honest
        # residual and converged=False.
        done = (res_t < config.tol) | (mv >= config.max_matvecs) \
            | (s.it == o.it)
        return _State(s.x, g_t, s.m, s.r, s.p, s.rr, res_t, mv, s.it, done,
                      s.trace)

    g0 = op.matvec(x0) + b
    x0 = proj.snap_binding(x0, g0)
    res0 = pg_residual(proj, x0, g0, config.gd, op)
    o0 = _State(x=x0, g=g0, m=jnp.zeros_like(b), r=jnp.zeros_like(b),
                p=jnp.zeros_like(b), rr=jnp.zeros((), b.dtype), res=res0,
                mv=jnp.int32(1), it=jnp.int32(0),
                done=(res0 < config.tol) | (1 >= config.max_matvecs),
                trace=init_trace(config, b.dtype))
    o = lax.while_loop(lambda o: ~o.done, outer_body, o0)
    result = make_result(o.x, o.res, o.mv, o.it, config.max_matvecs, o.trace)
    # make_result's budget semantics (converged := mv < max) would mislabel
    # the stagnation exit above as converged.  Report the honest criterion —
    # o.res is a fresh-gradient TRUE residual on every exit path — so
    # downstream fixup passes (parallel/mixed.py selects stragglers by
    # ~converged) re-solve stalled lanes instead of trusting them.
    return dataclasses.replace(result, converged=o.res < config.tol)


class _RRInner(NamedTuple):
    x: jax.Array
    g: jax.Array        # carried (perturbed-operator) gradient
    m: jax.Array
    r: jax.Array
    p: jax.Array
    rr: jax.Array
    thr: jax.Array      # segment stop threshold on the residual estimate
    mv: jax.Array
    k: jax.Array
    done: jax.Array


class _RROuter(NamedTuple):
    x: jax.Array
    g: jax.Array        # EXACT gradient (op.matvec_exact)
    m: jax.Array
    p: jax.Array        # carried conjugate direction (keep-p mode)
    rr: jax.Array       # last inner r.z (for the cross-segment beta)
    fresh: jax.Array    # True -> next segment starts steepest-descent
    res: jax.Array      # true Eq.25 residual at the last refresh
    mv: jax.Array
    it: jax.Array
    done: jax.Array
    trace: jax.Array


def _solve_rr(op, b, x0, proj, config, prec, tiny):
    """Residual-replacement mixed-precision PCG (see PCGConfig.refresh_every).

    Structure: an outer loop of f32 gradient refreshes around inner segments
    of cheap (bf16 for MixedPrecDense) CG iterations.  The nesting is load-
    bearing under vmap: a per-iteration ``lax.cond`` on "is this a refresh
    step" would execute BOTH matvecs masked on every iteration; nested loops
    keep every inner step exactly one cheap sweep and every outer step
    exactly one exact sweep.  Matvec counts include both kinds (low-precision
    applications move half the bytes — docs/precision.md)."""
    K = int(config.refresh_every)
    inner_tol = config.tol * config.inner_margin

    def inner_body(t):
        Ap = op.matvec(t.p)                       # cheap sweep
        mAp = t.m * Ap
        pAp = op.dot(t.p, mAp)
        alpha_cg = t.rr / (pAp + tiny)
        alpha_f = op.reduce_min(proj.max_feasible_step(t.x, -t.p))
        alpha = jnp.minimum(alpha_cg, jnp.maximum(alpha_f, 0.0))
        x = proj.project(t.x + alpha * t.p)
        g = t.g + alpha * Ap
        x = proj.snap_binding(x, g)       # see the plain body / snap_binding
        m = proj.binding_mask(x, g)
        changed = jnp.any(m != t.m)
        r = -m * g
        z = m * prec(r)
        rr = op.dot(r, z)
        restart = changed | (alpha_f < alpha_cg)
        beta = jnp.where(restart, 0.0, rr / (t.rr + tiny))
        p = z + beta * t.p
        # Perturbed-system residual estimate: early-stops the segment only —
        # convergence is judged solely at exact-gradient refreshes.
        res_est = pg_residual(proj, x, g, config.gd, op)
        # The budget check keeps the total count honest: without it a lane
        # could overshoot config.max_matvecs by up to a full segment of cheap
        # sweeps (+1 exact) in its final refresh cycle.  The +2 accounts for
        # the segment-closing exact refresh, so reported matvecs never exceed
        # the budget.
        done = (res_est < t.thr) | (rr == 0) | (t.k + 1 >= K) \
            | (t.mv + 2 >= config.max_matvecs)
        return _RRInner(x, g, m, r, p, rr, t.thr, t.mv + 1, t.k + 1, done)

    def outer_body(s):
        # Segment start: exact steepest descent on the free set, conjugated
        # against the carried direction (van der Vorst residual replacement)
        # unless restart mode / first segment / the refresh flipped the mask.
        r0 = -s.m * s.g
        z0 = s.m * prec(r0)
        rr0 = op.dot(r0, z0)
        if config.refresh_restart:
            p0 = z0
        else:
            beta0 = jnp.where(s.fresh, 0.0, rr0 / (s.rr + tiny))
            p0 = z0 + beta0 * s.p
        thr = jnp.asarray(inner_tol, b.dtype)
        if config.segment_drop > 0:
            thr = jnp.maximum(thr, config.segment_drop * s.res)
        t0 = _RRInner(s.x, s.g, s.m, r0, p0, rr0, thr, s.mv, jnp.int32(0),
                      (rr0 == 0) | (s.mv >= config.max_matvecs))
        t = lax.while_loop(lambda t: ~t.done, inner_body, t0)
        # Exact refresh: gradient, mask, TRUE residual.
        g = op.matvec_exact(t.x) + b
        mv = t.mv + 1
        m = proj.binding_mask(t.x, g)
        res = pg_residual(proj, t.x, g, config.gd, op)
        it = s.it + t.k
        # t.k == 0: the segment had no free direction to move in (frozen
        # mask) — a further segment would spin on the budget; stop with the
        # honest residual.
        done = (res < config.tol) | (mv >= config.max_matvecs) | (t.k == 0)
        fresh = jnp.any(m != t.m)
        return _RROuter(t.x, g, m, t.p, t.rr, fresh, res, mv, it, done,
                        record_trace(s.trace, s.it, res))

    g0 = op.matvec_exact(x0) + b
    x0 = proj.snap_binding(x0, g0)
    m0 = proj.binding_mask(x0, g0)
    res0 = pg_residual(proj, x0, g0, config.gd, op)
    s0 = _RROuter(x=x0, g=g0, m=m0, p=jnp.zeros_like(b),
                  rr=jnp.ones((), b.dtype), fresh=jnp.asarray(True),
                  res=res0, mv=jnp.int32(1),
                  it=jnp.int32(0),
                  done=(res0 < config.tol) | (1 >= config.max_matvecs),
                  trace=init_trace(config, b.dtype))
    s = lax.while_loop(lambda s: ~s.done, outer_body, s0)
    result = make_result(s.x, s.res, s.mv, s.it, config.max_matvecs, s.trace)
    return dataclasses.replace(result, converged=s.res < config.tol)


@partial(jax.jit, static_argnames=("config",))
def solve(A, b, x0=None, proj=None, config: PCGConfig = PCGConfig()):
    """Projected CG with active-set restarts (no reference counterpart —
    see module docstring)."""
    return _solve(A, b, x0, proj, config)
