"""Drop-in compatibility layer mirroring the reference CCQPpy class API.

A CCQPpy user can switch imports and keep their code:

    from ccqppy_jax.compat import CCQPSolverSPG, BoxProjOp
    result = CCQPSolverSPG(1e-10, 5000).solve(A, b, convex_proj_op=BoxProjOp(3, lb, ub))
    result.solution, result.solution_residual, ...

Class and argument names, defaults, and the ``solve() -> self`` /
``solution_*`` property protocol match the reference
(``CCQPpy/src/ccqppy/solvers.py:11-68`` ABC and per-class ctors;
``solution_spaces.py`` operator ctors).  Under the hood everything runs the
jit-compiled functional core; ``solution_time`` is wall-clock around the
device computation including ``block_until_ready`` (the reference times the
whole solve, ``solvers.py:118,167-168``).

Intentional deviations (all documented in the functional modules):
* matvec counts are exact operator-application counts (the reference
  under-counts some init matvecs and re-derives recurrence-available
  products — SURVEY.md section 7);
* SPG uses a seedable JAX PRNG (``spg_key`` ctor kwarg) instead of global
  numpy state;
* the cone projection is the correct SOC projection.
"""
from __future__ import annotations

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from ccqppy_jax.models import (APGDConfig, BBPGDConfig, BBPGDfConfig,
                               MPRGPBBConfig, MPRGPConfig, PGDConfig,
                               SPGConfig, apgd, bbpgd, mprgp, pgd, spg)
from ccqppy_jax.ops import projections as P

def _default_dtype():
    """Resolved at CALL time, not import time: a user who enables x64 after
    importing this module (the reference's tests run f64 at tol 1e-8,
    ``CCQPpy/tests/test_module.py:18-73``) must get f64 solves
    through the drop-in API — a frozen module constant silently gave f32."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def _asarray(x):
    return jnp.asarray(x, _default_dtype())


# --------------------------------------------------------------------------
# Projection operators (reference: solution_spaces.py)
# --------------------------------------------------------------------------
class _ProjOpWrapper:
    """Reference-style operator facade over a functional Projection."""

    def __init__(self, core, embedded_dimension, name):
        self._core = core
        self._dim = int(embedded_dimension)
        self._name = name

    @property
    def core(self):
        return self._core

    @property
    def name(self):
        return self._name

    @property
    def embedded_dimension(self):
        return self._dim

    def __call__(self, x):
        return np.asarray(self._core.project(_asarray(x)))

    def normal_vector(self, x):
        return np.asarray(self._core.normal(_asarray(x)))

    def projected_gradient(self, x, g):
        free, chopped = self._core.free_chopped(_asarray(x), _asarray(g))
        return np.asarray(free), np.asarray(chopped)

    def plot(self, num_random_samples, lb, ub, seed=0):
        """3-D scatter of projected uniform box samples — reference
        ``ProjOpBase.plot`` (solution_spaces.py:48-74)."""
        from ccqppy_jax.utils.plotting import plot_projection_samples
        return plot_projection_samples(self._core, self._dim,
                                       num_random_samples, lb, ub, seed=seed)


class IdentityProjOp(_ProjOpWrapper):
    def __init__(self, embedded_dimension):
        super().__init__(P.identity(), embedded_dimension, "Identity")


class LowerBoundProjOp(_ProjOpWrapper):
    def __init__(self, embedded_dimension, lower_bound=None):
        lb = (-jnp.ones(embedded_dimension, _default_dtype())
              if lower_bound is None else _asarray(lower_bound))
        super().__init__(P.LowerBoundProj(lb), embedded_dimension, "Lower Bound")


class UpperBoundProjOp(_ProjOpWrapper):
    def __init__(self, embedded_dimension, upper_bound=None):
        ub = (jnp.ones(embedded_dimension, _default_dtype())
              if upper_bound is None else _asarray(upper_bound))
        super().__init__(P.UpperBoundProj(ub), embedded_dimension, "Upper Bound")


class BoxProjOp(_ProjOpWrapper):
    def __init__(self, embedded_dimension, lower_bound=None, upper_bound=None):
        lb = (-jnp.ones(embedded_dimension, _default_dtype())
              if lower_bound is None else _asarray(lower_bound))
        ub = (jnp.ones(embedded_dimension, _default_dtype())
              if upper_bound is None else _asarray(upper_bound))
        super().__init__(P.BoxProj(lb, ub), embedded_dimension, "Box")


class SphereProjOp(_ProjOpWrapper):
    def __init__(self, embedded_dimension, radius=None):
        r = 1.0 if radius is None else radius
        super().__init__(P.ball(r, dtype=_default_dtype()), embedded_dimension,
                         "Sphere")


class ConeProjOp(_ProjOpWrapper):
    def __init__(self, embedded_dimension, aspect_ratio=None):
        mu = 1.0 if aspect_ratio is None else aspect_ratio
        super().__init__(P.lorentz_cone(mu, dtype=_default_dtype()),
                         embedded_dimension, "Cone")


class DisjointProjOp(_ProjOpWrapper):
    """Cartesian product of sub-operators over contiguous blocks
    (reference solution_spaces.py:495-560)."""

    def __init__(self, *proj_ops):
        dim = sum(op.embedded_dimension for op in proj_ops)
        core = P.ProductProj.make(*[(op.core, op.embedded_dimension)
                                    for op in proj_ops])
        super().__init__(core, dim, "Disjoint Union")


# --------------------------------------------------------------------------
# Solvers (reference: solvers.py)
# --------------------------------------------------------------------------
# Compiled executables cached per (solver, operand signature): the AOT path
# bypasses jax.jit's dispatch cache, so without this every ``solve()`` call
# through the drop-in API would re-trace and re-compile — seconds per call,
# hidden from ``solution_time`` but a real throughput cost for a user looping
# over same-shaped problems (advisor finding, round 2).
_AOT_CACHE = {}


def _sig(tree):
    """Hashable trace signature of an operand pytree: structure + per-leaf
    shape/dtype (values don't affect compilation)."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return (str(treedef),
            tuple((jnp.shape(l), str(jnp.result_type(l))) for l in leaves))


def _aot(solve_fn, A, b, x0, proj, config, **kw):
    """Ahead-of-time compile a jitted solver for the given operands so the
    caller can time pure execution.  Compiled executables are cached by
    operand signature; a solver that is not itself jitted (APGD-AR composes
    jitted solves) is called as is."""
    key = (id(solve_fn), _sig(A), _sig(b), _sig(x0), _sig(proj), config,
           tuple(sorted(kw)), _sig(kw))
    fn = _AOT_CACHE.get(key)
    if fn is None:
        if hasattr(solve_fn, "lower"):
            fn = solve_fn.lower(A, b, x0=x0, proj=proj, config=config,
                                **kw).compile()
        else:   # a plain Python composition of jitted solvers
            fn = functools.partial(solve_fn, config=config)
        _AOT_CACHE[key] = fn
    return fn


class _SolverWrapper:
    """Reference-style ``solve() -> self`` facade over a functional solver."""

    _solve_fn = None
    _config_cls = None
    _name = None

    def __init__(self, desired_residual_tol,
                 max_matrix_vector_multiplications=2**31 - 1, **extra):
        self.desired_residual_tol = desired_residual_tol
        self.max_matrix_vector_multiplications = max_matrix_vector_multiplications
        self._extra = extra
        self._result = None

    def _config(self):
        max_mv = self.max_matrix_vector_multiplications
        if max_mv in (np.inf, float("inf")):
            max_mv = 2**31 - 1
        return self._config_cls(tol=float(self.desired_residual_tol),
                                max_matvecs=int(max_mv), **self._extra)

    def solve(self, A, b, x0=None, convex_proj_op=None):
        A = _asarray(A)
        b = _asarray(b)
        proj = convex_proj_op.core if isinstance(convex_proj_op, _ProjOpWrapper) \
            else convex_proj_op
        x0 = None if x0 is None else _asarray(x0)
        # AOT-compile outside the timer so ``solution_time`` measures the
        # solve, not XLA compilation (first-use compile is seconds — a
        # reference user benchmarking through this drop-in API would
        # otherwise see a wildly pessimistic first solve).
        fn = _aot(type(self)._solve_fn, A, b, x0, proj, self._config())
        t0 = time.time()
        r = fn(A, b, x0=x0, proj=proj)
        r.x.block_until_ready()
        elapsed = time.time() - t0
        self._result = r
        self._solution_time = elapsed
        return self

    @property
    def name(self):
        return self._name

    @property
    def solution(self):
        return np.asarray(self._result.x)

    @property
    def solution_residual(self):
        return float(self._result.residual)

    @property
    def solution_converged(self):
        return bool(self._result.converged)

    @property
    def solution_time(self):
        return self._solution_time

    @property
    def solution_num_matrix_vector_multiplications(self):
        return int(self._result.matvecs)


class CCQPSolverPGD(_SolverWrapper):
    _solve_fn = staticmethod(pgd.solve)
    _config_cls = PGDConfig
    _name = "PGD"

    def __init__(self, desired_residual_tol,
                 max_matrix_vector_multiplications=2**31 - 1, step_size=0.01):
        super().__init__(desired_residual_tol,
                         max_matrix_vector_multiplications,
                         step_size=float(step_size))


class CCQPSolverAPGD(_SolverWrapper):
    _solve_fn = staticmethod(apgd.solve)
    _config_cls = APGDConfig
    _name = "APGD"


class CCQPSolverAPGDAntiRelaxation(_SolverWrapper):
    _solve_fn = staticmethod(apgd.solve_anti_relaxation)
    _config_cls = APGDConfig
    _name = "Anti-relaxation APGD"

    def _config(self):
        cfg = super()._config()
        import dataclasses
        return dataclasses.replace(cfg, anti_relaxation=True)


class CCQPSolverBBPGD(_SolverWrapper):
    _solve_fn = staticmethod(bbpgd.solve)
    _config_cls = BBPGDConfig
    _name = "BBPGD"


class CCQPSolverBBPGDf(_SolverWrapper):
    _solve_fn = staticmethod(bbpgd.solve_fallback)
    _config_cls = BBPGDfConfig
    _name = "BBPGDf"


class CCQPSolverSPG(_SolverWrapper):
    """SPG drop-in.  Deviation from the reference: the default stop criterion
    is the honest Eq.25 residual, not the reference's ``||d_k|| <= tol``
    (``solvers.py:949``) which can report success far from optimality — pass
    ``criterion="d_norm"`` for bit-faithful reference stopping behavior."""

    _name = "SPG-QP"
    _config_cls = SPGConfig

    def __init__(self, desired_residual_tol,
                 max_matrix_vector_multiplications=2**31 - 1,
                 m=5, tau=0.5, sigma1=0.01, sigma2=0.5, spg_key=0,
                 criterion="eq25"):
        super().__init__(desired_residual_tol,
                         max_matrix_vector_multiplications,
                         m=int(m), tau=float(tau), sigma1=float(sigma1),
                         sigma2=float(sigma2), criterion=str(criterion))
        self._key = jax.random.PRNGKey(spg_key)

    def solve(self, A, b, x0=None, convex_proj_op=None):
        A = _asarray(A)
        b = _asarray(b)
        proj = convex_proj_op.core if isinstance(convex_proj_op, _ProjOpWrapper) \
            else convex_proj_op
        x0 = None if x0 is None else _asarray(x0)
        fn = _aot(spg.solve, A, b, x0, proj, self._config(), key=self._key)
        t0 = time.time()
        r = fn(A, b, x0=x0, proj=proj, key=self._key)
        r.x.block_until_ready()
        self._solution_time = time.time() - t0
        self._result = r
        return self


class CCQPSolverMPRGP(_SolverWrapper):
    _solve_fn = staticmethod(mprgp.solve)
    _config_cls = MPRGPConfig
    _name = "MPRGP"


class CCQPSolverMPRGPBB(_SolverWrapper):
    _solve_fn = staticmethod(mprgp.solve_bb)
    _config_cls = MPRGPBBConfig
    _name = "MPGP-BB"

    def __init__(self, desired_residual_tol,
                 max_matrix_vector_multiplications=2**31 - 1, Gamma=1.0):
        super().__init__(desired_residual_tol,
                         max_matrix_vector_multiplications,
                         gamma=float(Gamma))
