"""Projection-operator algebra for convex feasible sets, in JAX.

This is the JAX re-design of the reference's "solution spaces" layer
(``CCQPpy/src/ccqppy/solution_spaces.py``).  Differences by design:

* Every operator is a frozen **pytree dataclass** of pure, shape-polymorphic
  functions: no embedded dimension, no Python loops, no per-coordinate
  dispatch.  Operators ``vmap`` over batches of points *and* over batches of
  their own parameters (bounds, radii, cone aspect ratios).
* ``free_chopped`` implements the mathematically correct MPRGP free/chopped
  gradient split.  The reference's box variant has an operator-precedence bug
  (``solution_spaces.py:340-341``) and its ``normal_vector`` returns zeros for
  strictly-infeasible points (``solution_spaces.py:152-154``); we implement the
  intended semantics, documented per-operator.
* ``max_feasible_step`` gives the exact largest step ``a`` with ``x - a*p``
  feasible, in closed form for every set.  The reference instead halves a trial
  step in a data-dependent Python loop (``solvers.py:1112-1118``) — a pattern
  that is both algorithmically loose and hostile to XLA.
* ``pg_residual_vec`` evaluates ``(x - project(x - gd*g)) / gd`` — the
  Mazhar-2015 Eq. 25 residual probe used by every reference solver
  (``solvers.py:136-139``) — in a cancellation-free closed form for separable
  sets, so the probe stays exact in float32 (the literal formula with
  ``gd = 1e-6`` underflows to zero at f32 precision).
* The Lorentz-cone projection is the *correct* second-order-cone projection;
  the reference's is known-bugged (``solution_spaces.py:439`` carries a
  ``TODO: this projection op is bugged``).

Set convention: we project onto a closed convex set Omega; solvers minimize
``f(x) = 1/2 x^T A x + b^T x`` over Omega with gradient ``g = A x + b``
(matching the reference's executable convention — see SURVEY.md section 2.5).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ccqppy_jax.utils.pytree import register_pytree_dataclass

# Active-set detection tolerances, mirroring numpy.isclose defaults used by the
# reference (``solvers.py:1081,1093``).  |x - bound| <= ATOL + RTOL * |bound|.
ACTIVE_RTOL = 1e-5
ACTIVE_ATOL = 1e-8


def _near(x, ref):
    """Elementwise ``isclose(x, ref)`` with the reference's tolerances."""
    return jnp.abs(x - ref) <= ACTIVE_ATOL + ACTIVE_RTOL * jnp.abs(ref)


def _at_bound(x, ref):
    """Tight at-bound test for ``binding_mask``: a projection lands iterates
    *exactly* on the bound, so only a few-ulp band is needed — a wide band
    (``_near``) would freeze genuinely interior coordinates and stall the
    ``pcg`` face solver."""
    band = 16 * jnp.finfo(x.dtype).eps * (1 + jnp.abs(ref))
    return jnp.abs(x - ref) <= band


def _safe_div(num, den, fallback):
    """num / den where den != 0, else fallback (no NaN generation)."""
    den_ok = den != 0
    safe = jnp.where(den_ok, den, 1)
    return jnp.where(den_ok, num / safe, fallback)


def _min_positive_root(a, b, c, dtype):
    """Smallest t >= 0 with a t^2 + b t + c < 0 just beyond it, else +inf.

    Assumes q(0) = c >= 0 (the start point is feasible).  Used for the exact
    max-feasible-step of quadratically-bounded sets (ball, Lorentz cone).
    """
    inf = jnp.asarray(jnp.inf, dtype)
    # Linear case a == 0: q crosses zero at -c/b when b < 0.
    lin = jnp.where(b < 0, _safe_div(-c, b, inf), inf)

    disc = b * b - 4 * a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0))
    # Roots ordered r1 <= r2 for a > 0 (q negative strictly between them);
    # for a < 0, q is negative outside [r2', r1'] — the relevant crossing is
    # the larger root of the upward-flipped parabola.
    r1 = _safe_div(-b - sq, 2 * a, inf)
    r2 = _safe_div(-b + sq, 2 * a, inf)
    pos_up = jnp.where(disc <= 0, inf, jnp.where(r1 >= 0, r1, inf))
    # a < 0: c >= 0 implies disc >= 0; q(t) < 0 for t > max-root.
    pos_down = jnp.maximum(jnp.maximum(r1, r2), 0)
    quad = jnp.where(a > 0, pos_up, pos_down)
    return jnp.where(a == 0, lin, quad)


class Projection:
    """Interface for projections onto closed convex sets.

    Mirrors the reference ``ProjOpBase`` surface
    (``solution_spaces.py:9-74``) as jittable pure functions:

    * ``project(x)``           — Euclidean projection onto the set.
    * ``normal(x)``            — outward (sub)normal at the active boundary,
                                 zero for interior points (per-face entries
                                 for separable sets, reference-style).
    * ``free_chopped(x, g)``   — MPRGP free / chopped gradient split.
    * ``max_feasible_step(x, p)`` — largest a >= 0 with x - a p feasible.
    * ``pg_residual_vec(x, g, gd)`` — stable (x - project(x - gd g)) / gd.
    * ``contains(x)``          — feasibility predicate (scalar bool).

    ``__call__`` aliases ``project`` so operators remain drop-in callables
    like the reference's (``solution_spaces.py:186``).
    """

    def __call__(self, x):
        return self.project(x)

    # --- default implementations -------------------------------------------
    def project(self, x):
        raise NotImplementedError

    def normal(self, x):
        return jnp.zeros_like(x)

    def free_chopped(self, x, g):
        """Default split via the outward normal.

        free    = g on the inactive part, tangential part on the active
                  smooth boundary.
        chopped = max(0, n.g) n  — the KKT-violating outward component.

        The tangential truncation applies for EITHER gradient sign at an
        active point.  Round 5 tested the proposed alternative (return the
        full ``g`` as free when ``n.g < 0``, on the theory that the
        constraint is then "locally inactive") and REFUTED it: ``n.g < 0``
        means the descent direction ``-g`` points OUTWARD (infeasible), and
        at a constrained optimum on a smooth boundary ``g = -lambda n``
        gives exactly ``n.g < 0`` with the constraint KKT-ACTIVE — the
        tangential free gradient correctly vanishes there, while the full-g
        rule leaves a pure-normal "free" direction with zero feasible step,
        and MPRGP-BB limit-cycles in its expansion branch (measured: the
        mixed cone+box segment problem of
        tests/test_projections.py::test_segment_in_solver went from
        converged at tol 1e-8 to DNF at the full 2000-matvec budget).
        """
        n = self.normal(x)
        ng = jnp.vdot(n, g)
        nn = jnp.vdot(n, n)
        active = nn > 0
        coef = _safe_div(ng, nn, jnp.zeros_like(ng))
        chopped = jnp.where(active & (ng > 0), coef, 0) * n
        free = jnp.where(active, g - coef * n, g)
        return free, chopped

    def max_feasible_step(self, x, p):
        raise NotImplementedError

    def binding_mask(self, x, g):
        """Per-coordinate indicator (same dtype as x) of coordinates free to
        move in a face-restricted step from feasible ``x`` with gradient ``g``.

        1 where the coordinate is strictly inside its constraint, or sits on
        a bound the negative gradient points *away* from (the bound releases);
        0 where the bound binds.  Used by the ``pcg`` polish solver to run CG
        inside the current face with exact-gradient carry (models/pcg.py).

        Default (sound for any set, conservative for curved ones): freeze
        every coordinate the outward normal touches.  Separable sets override
        with the exact bound/sign test.
        """
        n = self.normal(self.project(x))
        return (n == 0).astype(x.dtype)

    def snap_binding(self, x, g):
        """Place every coordinate that ``binding_mask`` binds EXACTLY on its
        bound.  A CG-limited step can stop inside the ``_at_bound`` proximity
        band (16 ulp) of a bound whose gradient points outward; the mask then
        freezes the coordinate a band-width SHORT of the bound, leaving a
        permanent Eq.25 violation of ~|g_i| * dist/gd — measured: 2% of
        drifted-Wishart box lanes stalled at residual 3.7e-4 against tol 2e-5
        for their whole budget (f32, n=1000).  Snapping moves x by at most
        the band (<= 32 ulp relative), whose effect on a carried gradient is
        below one matvec's own rounding error.  Default (sound for any set):
        no snap.  Bounded sets override with the exact bound assignment."""
        return x

    #: True when the set is an intersection of half-spaces aligned with the
    #: implementation's exact max_feasible_step/binding_mask (identity,
    #: bounds, box, and compositions thereof).  The ``pcg`` face solver
    #: requires it: on polyhedral sets a feasible step never needs re-
    #: projection, so its gradient recurrence holds exactly in exact
    #: arithmetic (fp drift over deep sweeps is handled by pcg's verified
    #: convergence claims — models/pcg.py).
    polyhedral = False

    def pg_residual_vec(self, x, g, gd):
        """(x - project(x - gd*g)) / gd, literal fallback.

        Rearranged as ``g + (u - project(u)) / gd`` with ``u = x - gd*g`` which
        is exact when the projection is the identity near x and loses at most
        the projection's own rounding otherwise.  Sets with active curvature
        override this with a cancellation-free closed form (the f32 noise of
        the literal form is ~eps*|x|/gd = 0.1 per ACTIVE coordinate at
        gd=1e-6, which floors large-n residuals around 1e-4)."""
        u = x - gd * g
        return g + (u - self.project(u)) / gd

    def contains(self, x):
        return jnp.linalg.norm(x - self.project(x)) <= ACTIVE_ATOL + ACTIVE_RTOL * jnp.linalg.norm(x)


@register_pytree_dataclass
class IdentityProj(Projection):
    """All of R^n.  Reference: ``IdentityProjOp`` (solution_spaces.py:77-125).

    The reference's disk ``projected_gradient`` is a bodyless stub returning
    None (solution_spaces.py:100-109); the docs snapshot returns
    ``(g, zeros)`` — we implement the latter (docs solution_spaces.html:1028).
    """

    polyhedral = True

    def project(self, x):
        return x

    def free_chopped(self, x, g):
        return g, jnp.zeros_like(g)

    def binding_mask(self, x, g):
        return jnp.ones_like(x)

    def max_feasible_step(self, x, p):
        return jnp.asarray(jnp.inf, x.dtype)

    def pg_residual_vec(self, x, g, gd):
        return g

    def contains(self, x):
        return jnp.asarray(True)


@register_pytree_dataclass
class LowerBoundProj(Projection):
    """{x : x >= lb}.  Reference: ``LowerBoundProjOp`` (solution_spaces.py:128-201)."""

    lb: jax.Array
    polyhedral = True

    def project(self, x):
        return jnp.maximum(x, self.lb)

    def is_active(self, x):
        return _near(x, self.lb)

    def normal(self, x):
        # Reference quirk: returns zeros when x is strictly infeasible
        # (solution_spaces.py:152-154, inverted isclose).  We return the
        # outward normal of the projected point instead — the intended
        # semantics per its own docstring.
        return jnp.where(self.is_active(self.project(x)), -1.0, 0.0).astype(x.dtype)

    def free_chopped(self, x, g):
        active = self.is_active(x)
        free = jnp.where(active, 0, g)
        chopped = jnp.where(active, jnp.minimum(g, 0), 0)
        return free, chopped

    def binding_mask(self, x, g):
        # Bound binds iff at the bound AND the gradient pushes outward
        # (descent -g would decrease x below lb).
        return jnp.where(_at_bound(x, self.lb) & (g > 0), 0.0, 1.0).astype(x.dtype)

    def snap_binding(self, x, g):
        return jnp.where(_at_bound(x, self.lb) & (g > 0),
                         jnp.broadcast_to(self.lb, x.shape).astype(x.dtype), x)

    def max_feasible_step(self, x, p):
        # x - a p >= lb  =>  for p_i > 0: a <= (x_i - lb_i) / p_i.
        inf = jnp.asarray(jnp.inf, x.dtype)
        gap = jnp.maximum(x - self.lb, 0)
        ratio = jnp.where(p > 0, _safe_div(gap, p, inf), inf)
        return jnp.min(ratio)

    def pg_residual_vec(self, x, g, gd):
        # Exact: (x - max(x - gd g, lb)) / gd == min(g, (x - lb)/gd).
        return jnp.minimum(g, (x - self.lb) / gd)

    def contains(self, x):
        return jnp.all(x >= self.lb - (ACTIVE_ATOL + ACTIVE_RTOL * jnp.abs(self.lb)))


@register_pytree_dataclass
class UpperBoundProj(Projection):
    """{x : x <= ub}.  Reference: ``UpperBoundProjOp`` (solution_spaces.py:204-277)."""

    ub: jax.Array
    polyhedral = True

    def project(self, x):
        return jnp.minimum(x, self.ub)

    def is_active(self, x):
        return _near(x, self.ub)

    def normal(self, x):
        return jnp.where(self.is_active(self.project(x)), 1.0, 0.0).astype(x.dtype)

    def free_chopped(self, x, g):
        active = self.is_active(x)
        free = jnp.where(active, 0, g)
        chopped = jnp.where(active, jnp.maximum(g, 0), 0)
        return free, chopped

    def binding_mask(self, x, g):
        return jnp.where(_at_bound(x, self.ub) & (g < 0), 0.0, 1.0).astype(x.dtype)

    def snap_binding(self, x, g):
        return jnp.where(_at_bound(x, self.ub) & (g < 0),
                         jnp.broadcast_to(self.ub, x.shape).astype(x.dtype), x)

    def max_feasible_step(self, x, p):
        inf = jnp.asarray(jnp.inf, x.dtype)
        gap = jnp.maximum(self.ub - x, 0)
        ratio = jnp.where(p < 0, _safe_div(gap, -p, inf), inf)
        return jnp.min(ratio)

    def pg_residual_vec(self, x, g, gd):
        return jnp.maximum(g, (x - self.ub) / gd)

    def contains(self, x):
        return jnp.all(x <= self.ub + (ACTIVE_ATOL + ACTIVE_RTOL * jnp.abs(self.ub)))


@register_pytree_dataclass
class BoxProj(Projection):
    """{x : lb <= x <= ub}.  Reference: ``BoxProjOp`` (solution_spaces.py:280-366).

    The reference's ``projected_gradient`` mis-parenthesizes its lower-bound
    active test (solution_spaces.py:340-341); we implement the intended
    semantics: a coordinate is active iff at (or beyond) either bound.
    """

    lb: jax.Array
    ub: jax.Array
    polyhedral = True

    def project(self, x):
        return jnp.clip(x, self.lb, self.ub)

    def active_lower(self, x):
        return _near(x, self.lb) | (x < self.lb)

    def active_upper(self, x):
        return _near(x, self.ub) | (x > self.ub)

    def normal(self, x):
        xp = self.project(x)
        n = jnp.where(_near(xp, self.ub), 1.0, 0.0) - jnp.where(_near(xp, self.lb), 1.0, 0.0)
        return n.astype(x.dtype)

    def free_chopped(self, x, g):
        lo = self.active_lower(x)
        hi = self.active_upper(x)
        active = lo | hi
        free = jnp.where(active, 0, g)
        chopped = jnp.where(lo, jnp.minimum(g, 0), 0) + jnp.where(hi, jnp.maximum(g, 0), 0)
        return free, chopped

    def binding_mask(self, x, g):
        blocked = (_at_bound(x, self.lb) & (g > 0)) | \
                  (_at_bound(x, self.ub) & (g < 0))
        return jnp.where(blocked, 0.0, 1.0).astype(x.dtype)

    def snap_binding(self, x, g):
        x = jnp.where(_at_bound(x, self.lb) & (g > 0),
                      jnp.broadcast_to(self.lb, x.shape).astype(x.dtype), x)
        return jnp.where(_at_bound(x, self.ub) & (g < 0),
                         jnp.broadcast_to(self.ub, x.shape).astype(x.dtype), x)

    def max_feasible_step(self, x, p):
        inf = jnp.asarray(jnp.inf, x.dtype)
        gap_lo = jnp.maximum(x - self.lb, 0)
        gap_hi = jnp.maximum(self.ub - x, 0)
        r_lo = jnp.where(p > 0, _safe_div(gap_lo, p, inf), inf)
        r_hi = jnp.where(p < 0, _safe_div(gap_hi, -p, inf), inf)
        return jnp.min(jnp.minimum(r_lo, r_hi))

    def pg_residual_vec(self, x, g, gd):
        # Exact closed form: (x - clip(x - gd g, lb, ub)) / gd
        #                  == clip(g, (x - ub)/gd, (x - lb)/gd).
        return jnp.clip(g, (x - self.ub) / gd, (x - self.lb) / gd)

    def contains(self, x):
        tol_l = ACTIVE_ATOL + ACTIVE_RTOL * jnp.abs(self.lb)
        tol_u = ACTIVE_ATOL + ACTIVE_RTOL * jnp.abs(self.ub)
        return jnp.all((x >= self.lb - tol_l) & (x <= self.ub + tol_u))


@register_pytree_dataclass
class BallProj(Projection):
    """{x : ||x - center|| <= radius}.  Reference: ``SphereProjOp``
    (solution_spaces.py:369-435), which is origin-centred; we generalize with a
    center.  The reference's ``projected_gradient`` raises NotImplementedError
    (solution_spaces.py:405-415); ours implements the tangential/outward split.
    """

    radius: jax.Array
    center: jax.Array

    @staticmethod
    def make(radius, center=0.0, dtype=jnp.float32):
        return BallProj(jnp.asarray(radius, dtype), jnp.asarray(center, dtype))

    def project(self, x):
        y = x - self.center
        nrm = jnp.linalg.norm(y)
        scale = jnp.where(nrm > self.radius, _safe_div(self.radius, nrm, jnp.ones_like(nrm)), 1.0)
        return self.center + scale * y

    def is_active(self, x):
        nrm = jnp.linalg.norm(x - self.center)
        return nrm >= self.radius - (ACTIVE_ATOL + ACTIVE_RTOL * jnp.abs(self.radius))

    def normal(self, x):
        y = self.project(x) - self.center
        nrm = jnp.linalg.norm(y)
        unit = _safe_div(y, nrm, jnp.zeros_like(y))
        return jnp.where(self.is_active(x), unit, 0)

    def free_chopped(self, x, g):
        # Tangential truncation for either gradient sign at the active
        # sphere — at the constrained optimum g = -lambda n, so the
        # tangential free gradient correctly vanishes (see the refutation
        # note in Projection.free_chopped).
        n = self.normal(x)
        ng = jnp.vdot(n, g)
        active = self.is_active(x)
        tangential = g - ng * n
        free = jnp.where(active, tangential, g)
        chopped = jnp.where(active, jnp.maximum(ng, 0), 0) * n
        return free, chopped

    def max_feasible_step(self, x, p):
        # ||(x - a p) - c||^2 <= r^2: quadratic in a with q(0) <= 0 inside.
        y = x - self.center
        a = jnp.vdot(p, p)
        b = -2 * jnp.vdot(y, p)
        c = jnp.vdot(y, y) - self.radius**2
        # q(a) = a*t^2 + b*t + c must stay <= 0; entering _min_positive_root
        # convention (q >= 0 feasible) requires flipping signs.
        return _min_positive_root(-a, -b, -c, x.dtype)

    def pg_residual_vec(self, x, g, gd):
        """Cancellation-free closed form: the gd->0 limit of
        (x - project(x - gd g))/gd is the negated tangent-cone projection of
        -g.  Interior: g.  Active sphere: remove the inward-pointing normal
        component, i.e. g - min(<n,g>, 0) n.  Deviation from the literal
        finite-gd probe is O(gd * |g|^2 / r) (surface curvature) — below any
        meaningful tolerance, while the literal form's f32 rounding noise is
        ~0.1 per active coordinate (see Projection.pg_residual_vec)."""
        n = self.normal(x)
        ng = jnp.vdot(n, g)
        return jnp.where(self.is_active(x), g - jnp.minimum(ng, 0) * n, g)

    def contains(self, x):
        r = self.radius
        return jnp.linalg.norm(x - self.center) <= r + (ACTIVE_ATOL + ACTIVE_RTOL * jnp.abs(r))


@register_pytree_dataclass
class LorentzConeProj(Projection):
    """Second-order (ice-cream) cone {(u, z) : ||u|| <= mu z}, z the LAST
    coordinate.

    Correct Moreau three-case SOC projection — the reference's
    ``ConeProjOp`` carries ``# TODO(palmerb4): This projection op is bugged``
    (solution_spaces.py:439) and flips the sign of the z-component of its
    surface projection (solution_spaces.py:491-492).  Standard result:

        inside  (||u|| <=  mu z) -> x
        polar   (mu ||u|| <= -z) -> 0
        else    t = (mu ||u|| + z) / (mu^2 + 1);  proj = (t mu u/||u||, t)
    """

    mu: jax.Array

    @staticmethod
    def make(mu=1.0, dtype=jnp.float32):
        return LorentzConeProj(jnp.asarray(mu, dtype))

    def _split(self, x):
        return x[..., :-1], x[..., -1]

    def project(self, x):
        u, z = self._split(x)
        mu = self.mu
        un = jnp.linalg.norm(u, axis=-1)
        inside = un <= mu * z
        polar = mu * un <= -z
        t = (mu * un + z) / (mu * mu + 1)
        udir = _safe_div(u, un[..., None], jnp.zeros_like(u))
        proj_u = t[..., None] * mu * udir
        proj_z = t
        out_u = jnp.where(inside[..., None], u, jnp.where(polar[..., None], 0, proj_u))
        out_z = jnp.where(inside, z, jnp.where(polar, 0, proj_z))
        return jnp.concatenate([out_u, out_z[..., None]], axis=-1)

    def is_active(self, x):
        u, z = self._split(x)
        un = jnp.linalg.norm(u, axis=-1)
        slack = self.mu * z - un
        return slack <= ACTIVE_ATOL + ACTIVE_RTOL * jnp.abs(self.mu * z)

    def is_apex(self, x):
        return jnp.linalg.norm(x, axis=-1) <= ACTIVE_ATOL

    def normal(self, x):
        """Outward unit normal on the cone surface; zero at interior/apex."""
        xp = self.project(x)
        u, _ = self._split(xp)
        mu = self.mu
        un = jnp.linalg.norm(u, axis=-1)
        udir = _safe_div(u, un[..., None], jnp.zeros_like(u))
        denom = jnp.sqrt(1 + mu * mu)
        zpart = jnp.broadcast_to(jnp.asarray(-mu / denom)[..., None],
                                 u.shape[:-1] + (1,))
        n = jnp.concatenate([udir / denom, zpart], axis=-1)
        active = self.is_active(xp) & ~self.is_apex(xp)
        return jnp.where(active[..., None], n, 0).reshape(x.shape)

    def free_chopped(self, x, g):
        n = self.normal(x)
        ng = jnp.sum(n * g, axis=-1)
        on_surface = self.is_active(x) & ~self.is_apex(x)
        apex = self.is_apex(x)
        tangential = g - ng[..., None] * n
        free_surface = jnp.where(on_surface[..., None], tangential, g)
        chop_surface = jnp.where(on_surface[..., None], jnp.maximum(ng, 0)[..., None] * n, 0)
        # Apex: optimal iff project(-g) == 0; violation is the feasible
        # descent component -project(-g).
        desc = self.project(-g)
        free = jnp.where(apex[..., None], 0, free_surface)
        chopped = jnp.where(apex[..., None], -desc, chop_surface)
        return free, chopped

    def max_feasible_step(self, x, p):
        u, z = self._split(x)
        pu, pz = self._split(p)
        mu2 = self.mu * self.mu
        # q(a) = mu^2 (z - a pz)^2 - ||u - a pu||^2 >= 0 and z - a pz >= 0.
        qa = mu2 * pz * pz - jnp.vdot(pu, pu)
        qb = -2 * mu2 * z * pz + 2 * jnp.vdot(u, pu)
        qc = mu2 * z * z - jnp.vdot(u, u)
        root = _min_positive_root(qa, qb, qc, x.dtype)
        inf = jnp.asarray(jnp.inf, x.dtype)
        zcap = jnp.where(pz > 0, _safe_div(z, pz, inf), inf)
        return jnp.minimum(root, zcap)

    def pg_residual_vec(self, x, g, gd):
        """Cancellation-free closed form (see BallProj.pg_residual_vec).

        Apex: EXACT for any gd by positive homogeneity of the cone
        projection — (0 - P(-gd g))/gd = -P(-g).  Surface (z > 0): the
        tangent cone is the half-space {v : <n, v> <= 0}, so the limit is
        g - min(<n,g>, 0) n.  Interior: g."""
        n = self.normal(x)
        ng = jnp.sum(n * g, axis=-1)
        surf = g - jnp.minimum(ng, 0)[..., None] * n
        apex = self.is_apex(x)
        on_surface = self.is_active(x) & ~apex
        out = jnp.where(on_surface[..., None], surf, g)
        return jnp.where(apex[..., None], -self.project(-g), out)

    def contains(self, x):
        u, z = self._split(x)
        un = jnp.linalg.norm(u, axis=-1)
        ok = un <= self.mu * z + (ACTIVE_ATOL + ACTIVE_RTOL * jnp.abs(self.mu * z))
        return jnp.all(ok)


@register_pytree_dataclass(meta_fields=("block_dim", "child_axes"))
class BlockwiseProj(Projection):
    """Cartesian power of one sub-operator over contiguous equal blocks.

    The batched form of the reference's uniform ``DisjointProjOp`` usage
    (``benchmark_random_ccqp.py:202-211`` builds k copies of a 3-dim op):
    reshape to (num_blocks, block_dim) and ``vmap`` the child — zero Python
    dispatch, fully batched.

    The child operator's array parameters may be either unbatched (shared
    across blocks, ``child_axes=None`` — the default) or stacked with a
    leading ``num_blocks`` axis (per-block, ``child_axes=0``): e.g.
    ``BlockwiseProj(box(lb, ub), 3, child_axes=0)`` with ``lb``/``ub`` of
    shape ``(num_blocks, 3)`` gives every contact its own friction bounds —
    the reference's per-block ``DisjointProjOp`` pattern
    (``solution_spaces.py:495-560``) with a single vmapped kernel.
    ``child_axes`` is a vmap ``in_axes`` prefix for the child pytree
    (``0``/``None``, or a nested tuple for mixed per-field axes).
    """

    child: Projection
    block_dim: int
    child_axes: object = None

    def _blocks(self, x):
        return x.reshape(x.shape[:-1] + (-1, self.block_dim))

    def _child_map(self, method, x, *extra):
        xb = self._blocks(x)
        extras = [self._blocks(e) for e in extra]
        if self.child_axes is None:
            child = self.child
            return jax.vmap(lambda xb_i, *e: getattr(child, method)(xb_i, *e)
                            )(xb, *extras)
        axes = (self.child_axes,) + (0,) * (1 + len(extra))
        return jax.vmap(lambda c, xb_i, *e: getattr(c, method)(xb_i, *e),
                        in_axes=axes)(self.child, xb, *extras)

    def project(self, x):
        return self._child_map("project", x).reshape(x.shape)

    def normal(self, x):
        return self._child_map("normal", x).reshape(x.shape)

    def free_chopped(self, x, g):
        free, chopped = self._child_map("free_chopped", x, g)
        return free.reshape(x.shape), chopped.reshape(x.shape)

    @property
    def polyhedral(self):
        return self.child.polyhedral

    def binding_mask(self, x, g):
        m = self._child_map("binding_mask", x, g)
        return m.reshape(x.shape)

    def snap_binding(self, x, g):
        return self._child_map("snap_binding", x, g).reshape(x.shape)

    def max_feasible_step(self, x, p):
        steps = self._child_map("max_feasible_step", x, p)
        return jnp.min(steps)

    def pg_residual_vec(self, x, g, gd):
        xb, gb = self._blocks(x), self._blocks(g)
        if self.child_axes is None:
            child = self.child
            r = jax.vmap(lambda xi, gi: child.pg_residual_vec(xi, gi, gd)
                         )(xb, gb)
        else:
            r = jax.vmap(lambda c, xi, gi: c.pg_residual_vec(xi, gi, gd),
                         in_axes=(self.child_axes, 0, 0))(self.child, xb, gb)
        return r.reshape(x.shape)

    def contains(self, x):
        return jnp.all(self._child_map("contains", x))


@register_pytree_dataclass(meta_fields=("dims",))
class ProductProj(Projection):
    """Cartesian product of heterogeneous sub-operators over contiguous
    index blocks — the general form of the reference's ``DisjointProjOp``
    (solution_spaces.py:495-560).  The child list and block sizes are static,
    so the composition unrolls at trace time into fused elementwise code.
    """

    children: tuple
    dims: tuple

    @staticmethod
    def make(*ops_and_dims):
        """ProductProj.make((op, dim), (op, dim), ...)."""
        ops = tuple(o for o, _ in ops_and_dims)
        dims = tuple(int(d) for _, d in ops_and_dims)
        return ProductProj(ops, dims)

    def _slices(self, x):
        out, start = [], 0
        for d in self.dims:
            out.append(jax.lax.slice_in_dim(x, start, start + d, axis=-1))
            start += d
        return out

    def _apply_concat(self, method, x, *extra):
        xs = self._slices(x)
        extras = [self._slices(e) for e in extra]
        parts = [getattr(c, method)(xi, *[e[i] for e in extras])
                 for i, (c, xi) in enumerate(zip(self.children, xs))]
        return jnp.concatenate(parts, axis=-1)

    def project(self, x):
        return self._apply_concat("project", x)

    def normal(self, x):
        return self._apply_concat("normal", x)

    def free_chopped(self, x, g):
        xs, gs = self._slices(x), self._slices(g)
        fc = [c.free_chopped(xi, gi) for c, xi, gi in zip(self.children, xs, gs)]
        free = jnp.concatenate([f for f, _ in fc], axis=-1)
        chopped = jnp.concatenate([ch for _, ch in fc], axis=-1)
        return free, chopped

    @property
    def polyhedral(self):
        return all(c.polyhedral for c in self.children)

    def binding_mask(self, x, g):
        xs, gs = self._slices(x), self._slices(g)
        parts = [c.binding_mask(xi, gi) for c, xi, gi in zip(self.children, xs, gs)]
        return jnp.concatenate(parts, axis=-1)

    def snap_binding(self, x, g):
        xs, gs = self._slices(x), self._slices(g)
        parts = [c.snap_binding(xi, gi)
                 for c, xi, gi in zip(self.children, xs, gs)]
        return jnp.concatenate(parts, axis=-1)

    def max_feasible_step(self, x, p):
        xs, ps = self._slices(x), self._slices(p)
        steps = [c.max_feasible_step(xi, pi) for c, xi, pi in zip(self.children, xs, ps)]
        return jnp.min(jnp.stack(steps))

    def pg_residual_vec(self, x, g, gd):
        xs, gs = self._slices(x), self._slices(g)
        parts = [c.pg_residual_vec(xi, gi, gd) for c, xi, gi in zip(self.children, xs, gs)]
        return jnp.concatenate(parts, axis=-1)

    def contains(self, x):
        xs = self._slices(x)
        return jnp.all(jnp.stack([c.contains(xi) for c, xi in zip(self.children, xs)]))


@register_pytree_dataclass(meta_fields=("dims", "counts", "batched"))
class SegmentProj(Projection):
    """Scalable Cartesian product of MANY heterogeneous blocks.

    The reference's ``DisjointProjOp`` (solution_spaces.py:495-560) composes
    arbitrary child operators over contiguous index blocks with a Python loop
    per call.  ``ProductProj`` above mirrors that faithfully but unrolls the
    children at trace time — O(num_blocks) HLO, which explodes compile time
    for realistic mixed contact problems (thousands of interleaved cone/box
    blocks).  ``SegmentProj`` is the scalable form: blocks are grouped by
    (operator type, block size), each group's parameters are stacked with a
    leading group axis, and every method is ONE static coordinate gather +
    ``vmap`` over the group + ONE scatter per GROUP — trace size O(num_types),
    constant in the number of blocks.

    Build with ``segment_product((op, dim), (op, dim), ...)`` — the same
    call shape as ``ProductProj.make``; grouping and parameter stacking are
    automatic and the result is numerically identical to ``ProductProj``
    (tests assert bitwise equality).

    Fields (one entry per group):
      children: child op per group; array params stacked to (count, ...)
                when ``batched[g]``.
      indices:  int32 (count * dim,) flat coordinate ids owned by the group
                (a permutation of arange(n) across groups).
      dims/counts/batched: static per-group block size / block count /
                whether params carry a leading group axis.
    """

    children: tuple
    indices: tuple
    dims: tuple
    counts: tuple
    batched: tuple

    # Methods take 1-D x (per-problem), matching how solvers call projections;
    # batching over problems is the OUTER vmap's job (jnp.take / at[].set
    # have batching rules, so SegmentProj composes with vmap transparently).

    def _gather(self, x, g):
        return jnp.take(x, self.indices[g]).reshape(
            self.counts[g], self.dims[g])

    def _call(self, g, method, *blocked_args):
        child = self.children[g]
        if self.batched[g]:
            return jax.vmap(lambda c, *a: getattr(c, method)(*a))(
                child, *blocked_args)
        return jax.vmap(lambda *a: getattr(child, method)(*a))(*blocked_args)

    def _map_scatter(self, method, x, *extra):
        out = jnp.empty_like(x)
        for g in range(len(self.children)):
            parts = [self._gather(a, g) for a in (x,) + extra]
            yg = self._call(g, method, *parts)
            out = out.at[self.indices[g]].set(yg.reshape(-1))
        return out

    def project(self, x):
        return self._map_scatter("project", x)

    def normal(self, x):
        return self._map_scatter("normal", x)

    def free_chopped(self, x, g):
        free = jnp.empty_like(x)
        chopped = jnp.empty_like(x)
        for gi in range(len(self.children)):
            fg, cg = self._call(gi, "free_chopped",
                                self._gather(x, gi), self._gather(g, gi))
            free = free.at[self.indices[gi]].set(fg.reshape(-1))
            chopped = chopped.at[self.indices[gi]].set(cg.reshape(-1))
        return free, chopped

    @property
    def polyhedral(self):
        return all(c.polyhedral for c in self.children)

    def binding_mask(self, x, g):
        return self._map_scatter("binding_mask", x, g)

    def snap_binding(self, x, g):
        return self._map_scatter("snap_binding", x, g)

    def max_feasible_step(self, x, p):
        steps = []
        for g in range(len(self.children)):
            sg = self._call(g, "max_feasible_step",
                            self._gather(x, g), self._gather(p, g))
            steps.append(jnp.min(sg))
        return jnp.min(jnp.stack(steps))

    def pg_residual_vec(self, x, g, gd):
        out = jnp.empty_like(x)
        for gi in range(len(self.children)):
            child = self.children[gi]
            xg, gg = self._gather(x, gi), self._gather(g, gi)
            if self.batched[gi]:
                rg = jax.vmap(lambda c, xi, gi_: c.pg_residual_vec(xi, gi_, gd)
                              )(child, xg, gg)
            else:
                rg = jax.vmap(lambda xi, gi_: child.pg_residual_vec(xi, gi_, gd)
                              )(xg, gg)
            out = out.at[self.indices[gi]].set(rg.reshape(-1))
        return out

    def contains(self, x):
        oks = []
        for g in range(len(self.children)):
            oks.append(jnp.all(self._call(g, "contains", self._gather(x, g))))
        return jnp.all(jnp.stack(oks))


def segment_product(*ops_and_dims):
    """Build a ``SegmentProj`` from (op, dim) pairs — the scalable
    ``DisjointProjOp`` composition (see SegmentProj).  Blocks of the same
    operator type, block size, and parameter shapes are grouped; their
    parameters are stacked along a new leading axis and applied via ``vmap``.
    """
    groups = {}   # key -> [(position, op, dim), ...]
    order = []
    pos = 0
    for op, dim in ops_and_dims:
        dim = int(dim)
        leaves, treedef = jax.tree_util.tree_flatten(op)
        key = (type(op), dim, str(treedef),
               tuple(jnp.shape(l) for l in leaves))
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append((pos, op, dim))
        pos += dim

    children, indices, dims, counts, batched = [], [], [], [], []
    for key in order:
        members = groups[key]
        dim = members[0][2]
        idx = jnp.concatenate([
            jnp.arange(p, p + dim, dtype=jnp.int32) for p, _, _ in members])
        ops = [op for _, op, _ in members]
        has_params = len(jax.tree_util.tree_leaves(ops[0])) > 0
        if len(ops) > 1 and has_params:
            child = jax.tree.map(lambda *ls: jnp.stack(ls), *ops)
            is_batched = True
        else:
            child = ops[0]
            is_batched = False
        children.append(child)
        indices.append(idx)
        dims.append(dim)
        counts.append(len(ops))
        batched.append(is_batched)
    return SegmentProj(tuple(children), tuple(indices), tuple(dims),
                       tuple(counts), tuple(batched))


def box(lb, ub, dtype=jnp.float32):
    return BoxProj(jnp.asarray(lb, dtype), jnp.asarray(ub, dtype))


def lower_bound(lb, dtype=jnp.float32):
    return LowerBoundProj(jnp.asarray(lb, dtype))


def upper_bound(ub, dtype=jnp.float32):
    return UpperBoundProj(jnp.asarray(ub, dtype))


def identity():
    return IdentityProj()


def ball(radius, center=0.0, dtype=jnp.float32):
    return BallProj.make(radius, center, dtype)


def lorentz_cone(mu=1.0, dtype=jnp.float32):
    return LorentzConeProj.make(mu, dtype)


def blockwise(child, block_dim, child_axes=None):
    """Cartesian power of ``child`` over contiguous ``block_dim``-sized
    blocks.  ``child_axes=0`` maps a leading ``num_blocks`` axis on the
    child's array parameters to per-block values (see BlockwiseProj)."""
    return BlockwiseProj(child, int(block_dim), child_axes)
