"""Shared solver machinery: results, configs, convergence criterion.

Replaces the reference's per-class boilerplate (``solvers.py:11-68`` ABC plus
the five ``solution_*`` properties repeated in every solver) with one
functional core:

* ``SolveResult`` — a pytree carrying everything the reference exposes via
  properties (``solution``, ``solution_residual``, ``solution_converged``,
  ``solution_num_matrix_vector_multiplications``) plus the iteration count.
  Wall-clock time is attached host-side by the high-level API (device code
  must not call ``time.time``).
* ``pg_residual`` — the Mazhar-2015 Eq. 25 normalized projected-gradient
  residual ``|| (x - proj(x - gd*g)) || / (3 n gd)`` with ``gd = 1e-6``,
  identical to the check repeated at ``solvers.py:136-139, 321-323, 496-498,
  628-631, 767-770, 1069-1072, 1184-1185`` — but evaluated through each
  projection's cancellation-free closed form so it remains meaningful in f32.
* ``SolverConfig`` — frozen dataclass of jit-static hyperparameters.  The
  reference hard-codes these as magic constants inside the algorithms
  (SURVEY.md section 5.6); here every one is hoisted and documented.

Budget semantics (kept bit-for-bit from the reference, ``solvers.py:163-164``):
``converged := matvecs < max_matvecs`` at exit — i.e. a solve that exhausts
its matvec budget reports not-converged, anything else converged.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ccqppy_jax.utils.pytree import register_pytree_dataclass


@register_pytree_dataclass
class SolveResult:
    """Result pytree of a single QP solve (batched under vmap)."""

    x: jax.Array          # solution iterate
    residual: jax.Array   # final Eq.25 residual (SPG d_norm mode: ||d_k||)
    converged: jax.Array  # bool — matvec budget not exhausted
    matvecs: jax.Array    # int32 count of operator applications
    iterations: jax.Array # int32 outer-iteration count
    solve_time: jax.Array # seconds; filled host-side by timed wrappers, else 0
    trace: jax.Array      # (trace_len,) residual history; (0,) when disabled


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Hyperparameters common to all solvers (jit-static).

    tol:          desired Eq.25 residual (reference ``desired_residual_tol``).
    max_matvecs:  operator-application budget (reference
                  ``max_matrix_vector_multiplications``).
    gd:           finite-difference probe step of the residual criterion
                  (reference hard-codes 1e-6, ``solvers.py:137``).
    """

    tol: float = 1e-8
    max_matvecs: int = 10_000
    gd: float = 1e-6
    trace_len: int = 0


def pg_residual(proj, x, g, gd, op=None):
    """Normalized projected-gradient residual (Mazhar 2015 Eq. 25).

    When ``op`` is given, the norm and the logical dimension n come from the
    operator so distributed (shard_map) solves reduce globally; without it
    the local vdot/shape are used.
    """
    r = proj.pg_residual_vec(x, g, gd)
    if op is None:
        return jnp.linalg.norm(r) / (3.0 * x.shape[-1])
    n = op.global_size(x)
    return jnp.sqrt(op.dot(r, r)) / (3.0 * n)


def make_result(x, residual, matvecs, iterations, max_matvecs, trace=None):
    return SolveResult(
        x=x,
        residual=residual,
        converged=matvecs < max_matvecs,
        matvecs=jnp.asarray(matvecs, jnp.int32),
        iterations=jnp.asarray(iterations, jnp.int32),
        solve_time=jnp.zeros((), x.dtype),
        trace=trace if trace is not None else jnp.zeros((0,), x.dtype),
    )


def init_trace(config, dtype):
    """Residual-history buffer: (trace_len,) filled with NaN, or (0,) when
    disabled.  Updates via ``record_trace`` rely on JAX's drop-out-of-bounds
    scatter semantics, so the same code path serves both cases."""
    return jnp.full((config.trace_len,), jnp.nan, dtype)


def record_trace(trace, it, res):
    """Record iteration ``it``'s residual.  Out-of-range iterations are
    dropped; a disabled (0-length) buffer is returned untouched (the check
    is static, so the disabled path compiles to nothing)."""
    if trace.shape[0] == 0:
        return trace
    return trace.at[it].set(res, mode="drop")


def default_x0(b, x0, proj=None):
    """Reference default: x0 = 0 (``solvers.py:126``).

    When ``proj`` is given the start point is projected onto the feasible
    set, generalizing the reference MPRGP's ``x = proj(x0)`` init
    (``solvers.py:1063``) to every solver: all iterations keep x feasible
    anyway, and starting feasible makes the first gradient — and the BB /
    Lipschitz step-size seeds derived from it — well-scaled even for far
    infeasible warm starts (important at f32 where a wild first step can
    stall BB methods just above tolerance)."""
    if x0 is None:
        x0 = jnp.zeros_like(b)
    else:
        x0 = jnp.asarray(x0, b.dtype)
    if proj is not None:
        x0 = proj.project(x0)
    return x0


def eps_of(x):
    """10*eps stagnation guard matching the reference (``solvers.py:656``)."""
    return 10 * jnp.finfo(x.dtype).eps
