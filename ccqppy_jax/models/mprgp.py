"""MPRGP — Modified Proportioning with Reduced Gradient Projections — and
its Barzilai-Borwein variant (MPRGP-BB).

JAX re-design of the reference ``CCQPSolverMPRGP`` (Dostal, "Optimal
Quadratic Programming Algorithms" Alg. 5.8; ``CCQPpy/src/ccqppy/
solvers.py:1002-1224``) and of ``CCQPSolverMPRGPBB``, which exists only in
the reference's pdoc snapshot (``docs/src/ccqppy/solvers.html`` — see
SURVEY.md section 2.4).

Key re-designs (each documented where it lands):

* **Exact feasible step.**  The reference finds the max feasible step along
  the CG direction by recursively halving a trial step in a data-dependent
  Python loop (``solvers.py:1112-1118``, factor 0.8 in the docs variant).
  We use the projection algebra's closed-form ``max_feasible_step`` — exact,
  branch-free, and O(n) — for every supported set.
* **Correct active sets.**  The disk reference detects the active set with
  ``isclose(x, proj(x))`` (``solvers.py:1081,1093``), which is true for EVERY
  coordinate of a feasible point, so its proportioning test degenerates (the
  chopped gradient is always zero).  We use the per-operator
  ``free_chopped`` split (at-bound detection), i.e. the semantics of
  Dostal's algorithm and of the docs MPRGP-BB's ``projected_gradient``.
* **Recurrence-based matvec economy.**  The reference recomputes
  ``A @ (x_new - x)`` for each BB step and refreshes ``g = A x + b`` at the
  loop top (3-4 matvecs per iteration).  Because ``g`` is affine in ``x``,
  ``A dx == dg`` is available from the gradient recurrence for free; our CG
  and proportioning iterations cost ONE matvec, expansion two.  Matvec
  counts to tolerance are therefore roughly 3x lower than the reference on
  identical trajectories — this is the framework's headline metric, won
  algorithmically.
* Three-way branch (CG / expansion / proportioning) via ``lax.cond`` with a
  unified state shape; under ``vmap`` XLA converts the branches to masked
  selects, which is exactly the right batched execution model.

Gradient convention: ``g = A x + b`` throughout (the docs MPRGP-BB flips to
``g = A x - b``; we keep the package-wide convention — SURVEY.md section 2.5).
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
class MPRGPConfig(SolverConfig):
    """gamma: proportioning threshold Gamma — the chopped/free balance test
    is ``||beta||^2 < Gamma^2 ||psi||^2`` (disk reference: implicit 1,
    ``solvers.py:1098``; docs MPRGP-BB exposes it, default 1).

    fused: True (default) runs the SINGLE-SWEEP formulation: every iteration
    issues exactly one operator application, with the branch (CG / expansion
    / proportioning) choosing the operand.  Under ``vmap`` a ``lax.cond``
    lowers to BOTH branches executing masked, so the classic three-branch
    body moves up to 4 HBM sweeps of A per iteration (CG's A p + expansion's
    refresh + proportioning's seed + refresh) even though only 1-2 are live
    per lane — measured 4.05x wall on the B=1024 n=999 cone ensemble.  The
    fused form splits an expansion step across two iterations (the second-
    leg gradient refresh borrows the NEXT iteration's matvec slot via a
    ``pending`` flag), visiting the same iterates with the same matvec
    count.  False selects the reference-shaped ``lax.cond`` body (useful as
    a differential-testing oracle; also marginally leaner for SINGLE
    un-vmapped solves where lax.cond executes only the taken branch).

    Both forms VERIFY convergence claims made from the CG branch's carried
    gradient recurrence against a fresh ``g = A x + b`` before reporting
    converged (round 5, advisor r4 — the drift failure pcg.py closed in
    round 4 applies equally here).  Cost: +1 matvec on CG-claim exits
    (fused) or per claim cycle (unfused); exits from the fresh-gradient
    branches (proportioning, expansion finish) pay nothing extra in the
    fused form."""

    gamma: float = 1.0
    fused: bool = True


@dataclasses.dataclass(frozen=True)
class MPRGPBBConfig(MPRGPConfig):
    """expansion: second-leg rule of the expansion step.
    "bb"    (default) — projected step along the full half-point gradient
            with a BB step size (the disk reference's rule,
            ``solvers.py:1140-1148``).  Robust on curved sets: on a cone the
            tangential free gradient has ZERO feasible step, and the docs
            variant's fixed-step rule 2-cycles there (verified).
    "fixed" — the docs-snapshot rule x1 = proj(x_half - (2/||A||_inf) psi),
            sound for polyhedral (box/bound) sets only."""

    expansion: str = "bb"


class _State(NamedTuple):
    x: jax.Array
    g: jax.Array
    p: jax.Array
    alpha_bb: jax.Array
    x_prev: jax.Array   # previous iterate for the alternating BB step
    g_prev: jax.Array
    res: jax.Array
    mv: jax.Array
    it: jax.Array
    done: jax.Array
    trace: jax.Array


def _solve(A, b, x0, proj, config, bb_variant: bool):
    op = as_operator(A)
    b = jnp.asarray(b)
    proj = proj if proj is not None else identity()
    x0 = default_x0(b, x0, proj)
    dtype = b.dtype
    tiny = eps_of(b)
    gamma2 = jnp.asarray(config.gamma**2, dtype)

    x_init = proj.project(x0)
    g_init = op.matvec(x_init) + b
    res0 = pg_residual(proj, x_init, g_init, config.gd, op)

    if bb_variant:
        # Fixed expansion step alpha_bar = 2 / ||A||_inf (docs MPRGPBB);
        # only used when config.expansion == "fixed".
        alpha_bar = 2.0 / op.inf_norm()
        alpha_bb0 = jnp.asarray(0.0, dtype)   # sentinel: seed on first use
        mv0 = jnp.int32(1)
    else:
        # Disk reference seeds alpha_bb = g.g / g.Ag up front
        # (``solvers.py:1077``, one counted matvec).
        alpha_bar = None
        alpha_bb0 = op.dot(g_init, g_init) / op.dot(g_init, op.matvec(g_init))
        mv0 = jnp.int32(2)

    psi0, _ = proj.free_chopped(x_init, g_init)
    s0 = _State(x=x_init, g=g_init, p=psi0, alpha_bb=alpha_bb0,
                x_prev=x_init, g_prev=g_init, res=res0, mv=mv0,
                it=jnp.int32(0), done=res0 < config.tol,
                trace=init_trace(config, dtype))

    def cond(s):
        return ~s.done

    def body(s):
        psi, beta_ch = proj.free_chopped(s.x, s.g)
        proportional = op.dot(beta_ch, beta_ch) < gamma2 * op.dot(psi, psi)

        def cg_or_expand(s):
            Ap = op.matvec(s.p)
            mv = s.mv + 1
            pAp = op.dot(s.p, Ap) + tiny
            # Disk reference: alpha_cg = psi.p / p.Ap (``solvers.py:1106``);
            # Dostal writes g.p / p.Ap — identical on the face where p lives.
            alpha_cg = op.dot(psi, s.p) / pAp
            alpha_f = op.reduce_min(proj.max_feasible_step(s.x, s.p))

            def cg(_):
                x1 = s.x - alpha_cg * s.p
                g1 = s.g - alpha_cg * Ap
                psi1, _ = proj.free_chopped(x1, g1)
                bcg = op.dot(psi1, Ap) / pAp
                p1 = psi1 - bcg * s.p
                # BB step from the recurrence: dx = -a p, dg = -a Ap.
                a_bb = op.dot(s.p, s.p) / pAp
                return x1, g1, p1, a_bb, mv

            def expand(_):
                # Half-step to the boundary, then a projected step.  The
                # disk reference uses a BB-sized second leg
                # (``solvers.py:1140-1148``); the docs variant a fixed
                # 2/||A||_inf leg.  dx = -alpha_f p => A dx = -alpha_f Ap.
                xh = s.x - alpha_f * s.p
                gh = s.g - alpha_f * Ap
                if bb_variant and config.expansion == "fixed":
                    psih, _ = proj.free_chopped(xh, gh)
                    x1 = proj.project(xh - alpha_bar * psih)
                else:
                    a = op.dot(s.p, s.p) / pAp   # == dx.dx / dx.dg
                    x1 = proj.project(xh - a * gh)
                g1 = op.matvec(x1) + b
                psi1, _ = proj.free_chopped(x1, g1)
                dx = x1 - s.x
                dg = g1 - s.g
                a_bb = op.dot(dx, dx) / (op.dot(dx, dg) + tiny)
                return x1, g1, psi1, a_bb, mv + 1

            return lax.cond(alpha_cg <= alpha_f, cg, expand, None)

        def proportioning(s):
            # Step along the gradient with a BB step size.  Disk reference
            # steps along the FULL gradient (``solvers.py:1167``); its BB
            # size is recomputed from iterate diffs, seeded at init.  The
            # docs variant seeds lazily from g.g/g.Ag — we fold both into
            # the alternating-BB recurrence (A dx == dg, no extra matvec).
            if bb_variant:
                dx = s.x - s.x_prev
                dg = s.g - s.g_prev
                seed_needed = s.alpha_bb == 0
                a_seed = op.dot(s.g, s.g) / (op.dot(s.g, op.matvec(s.g)) + tiny)
                a_hist = op.dot(dx, dx) / (op.dot(dx, dg) + tiny)
                a_bb = jnp.where(seed_needed, a_seed, a_hist)
                mv = s.mv + jnp.where(seed_needed, 1, 0).astype(jnp.int32)
            else:
                a_bb = s.alpha_bb
                mv = s.mv
            x1 = proj.project(s.x - a_bb * s.g)
            g1 = op.matvec(x1) + b
            mv = mv + 1
            psi1, _ = proj.free_chopped(x1, g1)
            dx = x1 - s.x
            dg = g1 - s.g
            a_next = op.dot(dx, dx) / (op.dot(dx, dg) + tiny)
            return x1, g1, psi1, a_next, mv

        x1, g1, p1, a_bb, mv = lax.cond(proportional, cg_or_expand,
                                        proportioning, s)
        res = pg_residual(proj, x1, g1, config.gd, op)
        # ``mv + 1``: one matvec of budget is reserved for the outer
        # verification refresh (below), so totals never exceed the budget.
        done = (res < config.tol) | (mv + 1 >= config.max_matvecs)
        return _State(x1, g1, p1, a_bb, s.x, s.g, res, mv, s.it + 1, done,
                      record_trace(s.trace, s.it, res))

    # VERIFIED CONVERGENCE (round 5, advisor r4 medium): the CG branch
    # carries its gradient by recurrence (g1 = g - alpha_cg Ap) — exact in
    # exact arithmetic, but over 100+ f32 iterations the accumulated
    # rounding drifts it from the truth, the same failure mode pcg.py
    # closed in round 4.  On mostly-interior problems the proportioning /
    # expansion branches (which DO refresh g) may never fire, so a res<tol
    # claim can rest entirely on the drifted carry.  The loop is therefore
    # nested exactly like pcg.py: each inner segment runs until it CLAIMS
    # res < tol (or exhausts the reserved budget), then one fresh
    # ``g = A x + b`` re-evaluates the true Eq.25 residual and the loop
    # resumes from the exact gradient until the claim verifies.  Cost: one
    # extra matvec per solve in the no-drift case; the repo-wide bar
    # (models/pcg.py) — no solver default may report converged with a true
    # residual above tol — now holds for every MPRGP exit path.
    def outer_body(o):
        s = lax.while_loop(cond, body, o)
        g_t = op.matvec(s.x) + b           # verification refresh
        mv = s.mv + 1
        res_t = pg_residual(proj, s.x, g_t, config.gd, op)
        psi_t, _ = proj.free_chopped(s.x, g_t)
        done = (res_t < config.tol) | (mv >= config.max_matvecs)
        return _State(s.x, g_t, psi_t, s.alpha_bb, s.x_prev, s.g_prev,
                      res_t, mv, s.it, done, s.trace)

    o0 = s0._replace(done=(s0.res < config.tol)
                     | (s0.mv >= config.max_matvecs))
    o = lax.while_loop(lambda o: ~o.done, outer_body, o0)
    result = make_result(o.x, o.res, o.mv, o.it, config.max_matvecs, o.trace)
    # o.res is a fresh-gradient residual on every exit path; report the
    # honest criterion so a budget exit whose drifted carry happened to dip
    # below tol is not mislabeled converged (cf. pcg.py).
    return dataclasses.replace(
        result, converged=result.converged & (o.res < config.tol))


class _FusedState(NamedTuple):
    x: jax.Array
    g: jax.Array        # exact gradient at x — except pending: gradient at xh
    p: jax.Array
    x_prev: jax.Array   # expansion start point (full-step BB pair at finish)
    g_prev: jax.Array
    alpha_bb: jax.Array
    pending: jax.Array  # bool: an expansion's gradient refresh is owed
    verifying: jax.Array  # bool: a CG convergence claim awaits a fresh-g check
    res: jax.Array
    mv: jax.Array
    it: jax.Array
    done: jax.Array
    trace: jax.Array


def _solve_fused(A, b, x0, proj, config, bb_variant: bool):
    """Single-sweep MPRGP: one operator application per iteration, branch
    logic by select (see ``MPRGPConfig.fused``).

    The iteration owns ONE matvec slot; its operand is

      * ``x``        when a previous expansion's gradient refresh is owed
        (the lane spent last iteration's slot on ``A p``) — the refresh is
        a FRESH ``g = A x + b``, matching the unfused body's
        ``op.matvec(x1) + b`` (a ``g + A dx`` recurrence would accumulate
        rounding the unfused body does not);
      * ``p``        for the CG/expansion family (needs ``A p`` up front for
        ``alpha_cg`` and the feasible-step comparison);
      * ``proj(x - alpha_bb g)``  for proportioning — the projected point
        needs no matvec to construct, ``g1 = A x1 + b`` is fresh, and the
        BB pair completes from ``dg = g1 - g0`` (equal to ``A dx`` in
        exact arithmetic).

    All remaining work is O(n) elementwise/dots — noise next to the O(n^2)
    sweep.  Trajectories match the unfused body (same iterates, same matvec
    totals) with two documented deltas: the BB variant's proportioning seed
    ``g.g/g.Ag`` is spent at init (the lazy in-branch seed has no matvec
    slot of its own), costing +1 matvec on trajectories whose first
    proportioning step is away from the initial iterate; and an expansion's
    residual check lands one iteration later (when its refreshed gradient
    exists), so iteration counts — not matvec counts — read higher by the
    number of expansions taken.
    """
    op = as_operator(A)
    b = jnp.asarray(b)
    proj = proj if proj is not None else identity()
    x0 = default_x0(b, x0, proj)
    dtype = b.dtype
    tiny = eps_of(b)
    gamma2 = jnp.asarray(config.gamma**2, dtype)
    fixed_exp = bb_variant and config.expansion == "fixed"
    alpha_bar = 2.0 / op.inf_norm() if fixed_exp else None

    x_init = proj.project(x0)
    g_init = op.matvec(x_init) + b
    res0 = pg_residual(proj, x_init, g_init, config.gd, op)
    alpha_bb0 = op.dot(g_init, g_init) / (
        op.dot(g_init, op.matvec(g_init)) + tiny)
    psi0, _ = proj.free_chopped(x_init, g_init)
    zeros = jnp.zeros_like(b)
    false = jnp.asarray(False)
    s0 = _FusedState(x=x_init, g=g_init, p=psi0,
                     x_prev=x_init, g_prev=g_init, alpha_bb=alpha_bb0,
                     pending=false, verifying=false, res=res0,
                     mv=jnp.int32(2), it=jnp.int32(0),
                     done=(res0 < config.tol) | (2 >= config.max_matvecs),
                     trace=init_trace(config, dtype))

    def cond(s):
        return ~s.done

    def body(s):
        # ---- operand selection (all O(n)) --------------------------------
        # For a pending lane (x, g) is the inconsistent (x1, gh) pair; psi/
        # beta/x_prop computed from it are dead values the selects drop.
        # A verifying lane (round 5, advisor r4 medium) also takes the
        # refresh path: its last CG step CLAIMED res < tol from the carried
        # gradient recurrence, and the claim must be re-checked against a
        # fresh ``g = A x + b`` before the solver may report converged —
        # the same drift failure pcg.py closed in round 4.  Fresh-gradient
        # branches (proportioning, expansion finish) exit directly: their
        # residual already comes from an exact gradient, so verification
        # costs an extra sweep ONLY on CG-claim exits.
        psi, beta_ch = proj.free_chopped(s.x, s.g)
        proportional = op.dot(beta_ch, beta_ch) < gamma2 * op.dot(psi, psi)
        x_prop = proj.project(s.x - s.alpha_bb * s.g)
        dx_prop = x_prop - s.x
        br_fin = s.pending | s.verifying
        br_cg_ex = ~br_fin & proportional
        v = jnp.where(br_fin, s.x,
                      jnp.where(br_cg_ex, s.p, x_prop))
        Av = op.matvec(v)                         # the one sweep
        mv = s.mv + 1

        # ---- expansion finish / claim verify: FRESH g at s.x (Av == A x) -
        g_fin = Av + b
        dxf = s.x - s.x_prev
        a_fin = op.dot(dxf, dxf) / (op.dot(dxf, g_fin - s.g_prev) + tiny)

        # ---- proportioning: FRESH gradient at x_prop (Av == A x_prop) ----
        g_pp = Av + b
        a_pp = op.dot(dx_prop, dx_prop) / (op.dot(dx_prop, g_pp - s.g) + tiny)

        # ---- CG / expansion (Av == A p) ----------------------------------
        pAp = op.dot(s.p, Av) + tiny
        alpha_cg = op.dot(psi, s.p) / pAp
        alpha_f = op.reduce_min(proj.max_feasible_step(s.x, s.p))
        take_cg = alpha_cg <= alpha_f
        x_cg = s.x - alpha_cg * s.p
        g_cg = s.g - alpha_cg * Av
        a_cgbb = op.dot(s.p, s.p) / pAp
        xh = s.x - alpha_f * s.p
        gh = s.g - alpha_f * Av
        if fixed_exp:
            psih, _ = proj.free_chopped(xh, gh)
            x_ex = proj.project(xh - alpha_bar * psih)
        else:
            x_ex = proj.project(xh - a_cgbb * gh)

        # ---- merge -------------------------------------------------------
        br_cg = br_cg_ex & take_cg
        br_ex = br_cg_ex & ~take_cg

        def sel(fin, cg, ex, pp):
            return jnp.where(br_fin, fin,
                             jnp.where(br_cg, cg, jnp.where(br_ex, ex, pp)))

        x1 = sel(s.x, x_cg, x_ex, x_prop)
        g1 = sel(g_fin, g_cg, gh, g_pp)
        a1 = sel(a_fin, a_cgbb, s.alpha_bb, a_pp)
        # A verification refresh moves nothing (x1 == s.x), so its a_fin
        # secant pair is stale history — keep the carried BB step instead.
        a1 = jnp.where(s.verifying, s.alpha_bb, a1)
        x_prev1 = jnp.where(br_ex, s.x, s.x_prev)
        g_prev1 = jnp.where(br_ex, s.g, s.g_prev)

        psi1, _ = proj.free_chopped(x1, g1)
        bcg = op.dot(psi1, Av) / pAp
        p1 = jnp.where(br_cg, psi1 - bcg * s.p, psi1)
        p1 = jnp.where(br_ex, zeros, p1)

        res1 = pg_residual(proj, x1, g1, config.gd, op)
        # An expansion iteration's gradient is not yet exact — keep the last
        # honest residual; the finish iteration reports the refreshed one.
        res = jnp.where(br_ex, s.res, res1)
        # Residual freshness: br_fin (A x refresh) and proportioning compute
        # g1 from the sweep; CG's res1 is recurrence-carried and may only
        # CLAIM — the claim defers exit to a verifying refresh next
        # iteration.  Budget exhaustion exits regardless; make_result's
        # ``converged := mv < max`` then reports such lanes unconverged, so
        # an unverified claim is never labeled converged.
        fresh_now = br_fin | (~br_fin & ~proportional)
        done = ((res < config.tol) & fresh_now & ~br_ex) \
            | (mv >= config.max_matvecs)
        verifying1 = br_cg & (res1 < config.tol) & ~done
        pending1 = br_ex & ~done
        # Budget exit on an expansion iteration: the post-expansion x1 has
        # no matching residual (res is the stale pre-expansion value) —
        # return the pre-expansion iterate so the reported (x, residual)
        # pair is consistent (advisor r4).
        x1 = jnp.where(br_ex & done, s.x, x1)
        return _FusedState(x1, g1, p1, x_prev1, g_prev1, a1,
                           pending1, verifying1, res, mv, s.it + 1, done,
                           record_trace(s.trace, s.it, res))

    s = lax.while_loop(cond, body, s0)
    result = make_result(s.x, s.res, s.mv, s.it, config.max_matvecs, s.trace)
    # Every converged=True exit carries a fresh-gradient residual: claims
    # from the CG carry are re-checked by a verifying refresh before done
    # can set, and budget exits are unconverged by the mv < max semantics.
    return result


@partial(jax.jit, static_argnames=("config",))
def solve(A, b, x0=None, proj=None, config: MPRGPConfig = MPRGPConfig()):
    """MPRGP (Dostal Alg. 5.8, disk-reference lineage, corrected semantics)."""
    if config.fused:
        return _solve_fused(A, b, x0, proj, config, bb_variant=False)
    return _solve(A, b, x0, proj, config, bb_variant=False)


@partial(jax.jit, static_argnames=("config",))
def solve_bb(A, b, x0=None, proj=None,
             config: MPRGPBBConfig = MPRGPBBConfig()):
    """MPRGP-BB (docs-snapshot lineage: fixed 2/||A||_inf expansion step,
    alternating-BB proportioning, Gamma-weighted proportioning test)."""
    if config.fused:
        return _solve_fused(A, b, x0, proj, config, bb_variant=True)
    return _solve(A, b, x0, proj, config, bb_variant=True)
