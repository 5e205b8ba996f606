"""Observability & debugging utilities (SURVEY.md section 5 subsystems).

The reference's entire observability story is ``print`` banners and two
result properties (``solution_time``, matvec count).  Equivalents here:

* ``timed_solve``       — ``block_until_ready``-bracketed wall-clock timing
                          written into ``SolveResult.solve_time`` (the
                          reference times the whole solve incl. setup,
                          ``solvers.py:118,167-168``).
* residual traces       — every solver records its per-iteration Eq.25
                          residual on device when ``config.trace_len > 0``
                          (the analog of the docs MPRGP-BB's ``v`` iteration
                          prints); ``trim_trace`` cuts the NaN tail.
* ``profile_solve``     — wraps a solve in a ``jax.profiler`` trace for
                          xprof/tensorboard.
* ``check_result``      — host-side postcondition check: finiteness,
                          feasibility, residual consistency (the checkify/
                          sanitizer analog; raises with a readable report).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np

import jax
import jax.numpy as jnp


def timed_solve(fn, *args, **kwargs):
    """Run ``fn`` (a solver call) and fill ``solve_time`` with wall seconds.

    Times one dispatch including device execution (first call therefore
    includes compilation — call twice to measure steady-state)."""
    t0 = time.perf_counter()
    r = fn(*args, **kwargs)
    jax.block_until_ready(r.x)
    elapsed = time.perf_counter() - t0
    return dataclasses.replace(
        r, solve_time=jnp.asarray(elapsed, r.solve_time.dtype))


@contextlib.contextmanager
def profile_solve(log_dir):
    """jax.profiler trace around a solve block::

        with profile_solve("/tmp/trace"):
            solve(...).x.block_until_ready()
    """
    jax.profiler.start_trace(str(log_dir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def trim_trace(result):
    """Return the recorded residual history without the unused NaN tail.

    For batched results returns a list of per-lane histories (lanes converge
    at different iterations)."""
    tr = np.asarray(result.trace)
    if tr.ndim == 1:
        return tr[~np.isnan(tr)]
    return [row[~np.isnan(row)] for row in tr]


def check_result(result, proj=None, A=None, b=None, gd=1e-6, raise_on_fail=True):
    """Postcondition sanity report for a SolveResult.

    Checks (batched or single):
    * solution and residual are finite;
    * the iterate is feasible under ``proj`` (when given);
    * the reported residual matches a recomputation from (A, b) (when given).

    Returns a dict report; raises AssertionError on failure unless
    ``raise_on_fail=False``.
    """
    report = {}
    x = np.asarray(result.x)
    report["finite_x"] = bool(np.isfinite(x).all())
    report["finite_residual"] = bool(np.isfinite(np.asarray(result.residual)).all())

    if proj is not None:
        xs = x if x.ndim > 1 else x[None]
        feas = [bool(proj.contains(jnp.asarray(xi))) for xi in xs]
        report["feasible"] = all(feas)
        report["infeasible_lanes"] = [i for i, f in enumerate(feas) if not f]

    if A is not None and b is not None and proj is not None:
        from ccqppy_jax.models.base import pg_residual
        A_ = jnp.asarray(A)
        b_ = jnp.asarray(b)
        if A_.ndim == 3:
            g = jnp.einsum("bij,bj->bi", A_, jnp.asarray(result.x),
                           precision=jax.lax.Precision.HIGHEST) + b_
            recomputed = np.asarray(jax.vmap(
                lambda xi, gi: pg_residual(proj, xi, gi, gd)
            )(jnp.asarray(result.x), g))
        else:
            g = jnp.dot(A_, jnp.asarray(result.x),
                        precision=jax.lax.Precision.HIGHEST) + b_
            recomputed = np.asarray(pg_residual(proj, jnp.asarray(result.x),
                                                g, gd))
        reported = np.asarray(result.residual)
        denom = np.maximum(np.abs(recomputed), 1e-30)
        report["residual_rel_err"] = float(
            np.max(np.abs(recomputed - reported) / np.maximum(denom, 1.0)))
        report["residual_consistent"] = bool(report["residual_rel_err"] < 1e-2)

    ok = all(v for k, v in report.items()
             if isinstance(v, bool))
    report["ok"] = ok
    if raise_on_fail and not ok:
        raise AssertionError(f"SolveResult check failed: {report}")
    return report
