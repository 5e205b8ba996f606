"""Mixed-precision batched ensemble pipeline: bf16 descent + f32 PCG polish.

The headline batched workload (B independent dense n-dim QPs) is HBM-
bandwidth-bound: every solver iteration re-reads the whole stacked
Hessian, so solves/s ~ bandwidth / (bytes-per-sweep * sweeps).  This module
attacks both factors:

* **bytes/sweep** — phase A iterates against a bfloat16-resident copy of A
  (``ops.linop.CastDense``): half the bytes per sweep.
  The bf16 operator error floors the TRUE residual around 1e-2 normalized
  (the self-reported residual keeps falling, so phase A's stop
  tolerance must stay above the floor).  Phase B then polishes with the f32
  operator: warm-started projected CG (``models.pcg``) that typically needs
  ~8 sweeps to cross 3 more orders of magnitude.
* **sweeps** — a batched ``lax.while_loop`` runs to the SLOWEST lane.  The
  optional fixup phase re-checks convergence host-side, gathers the few
  unconverged lanes into a small power-of-two bucket, and finishes them with
  a full-precision fallback solve — so stragglers and curved-set lanes the
  PCG mask froze cost a tiny compacted solve instead of full-batch sweeps.

Whether the ladder beats plain f32 PCG on the card is not measured yet.
Mixed precision is aimed at ill-conditioned families with deep sweep
counts (residual-replacement rr-PCG, ``models/pcg.py`` ``refresh_every`` +
``MixedPrecDense``), and a bf16 ensemble stores 2x the problems per card.
Per-lane convergence semantics are exact: every reported residual is a
true f32 residual.

The reference has no counterpart (serial f64 numpy).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from ccqppy_jax.models import SOLVERS, PCGConfig
from ccqppy_jax.parallel.batch import _row_gather, host_compact_finish
from ccqppy_jax.ops.linop import CastDense


def prepare_dense_batch(As, low_dtype=None):
    """Place a stacked dense Hessian batch (B, n, n) on the device.

    With ``low_dtype``, also return a low-precision copy for phase A:
    ``As, As16 = prepare_dense_batch(As, jnp.bfloat16)``.  Single-device
    ensembles only — sharded paths place their own operands.
    """
    As = jax.device_put(As)
    if low_dtype is None:
        return As
    return As, As.astype(low_dtype)


# Row-gather for the fixup: per-row DMA (parallel/batch.py), jitted once.
_gather_rows = jax.jit(_row_gather)


@functools.lru_cache(maxsize=64)
def _fixup_fn(solver, cfg):
    """Cached jitted warm-started batched fixup solve."""
    fn = SOLVERS[solver][0]

    def run(A2, b2, x02, proj):
        return jax.vmap(lambda A, b, x0: fn(A, b, x0=x0, proj=proj,
                                            config=cfg))(A2, b2, x02)

    return jax.jit(run)


@functools.lru_cache(maxsize=64)
def _ladder_fn(phase_a_solver, cfg_a, cfg_b, has_x0):
    """Build (and cache) the jitted two-phase ladder for a config triple."""
    fn_a = SOLVERS[phase_a_solver][0]
    fn_b = SOLVERS["pcg"][0]

    def run(As_low, As, bs, x0, proj):
        def one(A_lo, A, b, x0_i, proj_i):
            ra = fn_a(CastDense(A_lo), b, x0=x0_i, proj=proj_i, config=cfg_a)
            rb = fn_b(A, b, x0=ra.x, proj=proj_i, config=cfg_b)
            return dataclasses.replace(
                rb, matvecs=ra.matvecs + rb.matvecs,
                iterations=ra.iterations + rb.iterations)
        return jax.vmap(one, in_axes=(0, 0, 0, 0 if has_x0 else None, None)
                        )(As_low, As, bs, x0, proj)

    return jax.jit(run)


def solve_batched_mixed(As, bs, proj=None, config=None, *, As_low=None,
                        x0=None, phase_a_tol=5e-3, phase_a_budget=48,
                        phase_a_solver="bbpgd_f", polish_config=None,
                        fixup=True, fixup_solver="mprgp_bb",
                        fixup_bucket_min=16):
    """Solve a batch of dense QPs via the bf16 -> f32 precision ladder.

    As:            (B, n, n) float32 stacked Hessians — ideally from
                   ``prepare_dense_batch``.
    As_low:        optional pre-built bfloat16 copy (built on the fly, and
                   paid per call, if omitted).
    config:        full-precision SolverConfig: ``tol`` / ``max_matvecs`` are
                   the solve's true tolerance and (approximate) total budget.
    phase_a_tol:   bf16 self-reported stop tolerance.  Must sit at or above
                   the bf16 operator-error floor of the problem family
                   (default 5e-3; the TRUE residual handed to phase B is
                   floor-bound regardless of how much lower this is set).
    fixup:         host-side straggler compaction: lanes unconverged after
                   the polish are gathered into a power-of-two bucket and
                   finished with ``fixup_solver`` at full precision.  The
                   default is MPRGP-BB — robust on curved sets where the
                   BB-projection family limit-cycles (its 3x masked-branch
                   traffic is irrelevant at bucket scale).  DOCUMENTED
                   OVERSPEND: a lane entering fixup already exhausted
                   ``config.max_matvecs``; the fixup is a rescue pass with a
                   fresh budget of the same size (curved-set lanes frozen by
                   PCG's conservative mask burned their budget without
                   progress).  Reported ``matvecs`` honestly include the
                   overspend; pass ``fixup=False`` for a strict budget
                   contract.

    Returns a SolveResult; ``matvecs`` counts BOTH phases' operator
    applications (phase-A applications move half the bytes).  Residuals and
    convergence flags are always from full-precision operators.
    """
    if config is None:
        raise ValueError("config (full-precision SolverConfig) is required")
    As = jnp.asarray(As)
    bs = jnp.asarray(bs)
    if As_low is None:
        As_low = As.astype(jnp.bfloat16)

    cfg_a = SOLVERS[phase_a_solver][1](tol=float(phase_a_tol),
                                       max_matvecs=int(phase_a_budget),
                                       gd=config.gd)
    if polish_config is None:
        budget_b = int(config.max_matvecs) - int(phase_a_budget)
        if budget_b < 4:
            raise ValueError(
                f"phase_a_budget={phase_a_budget} leaves {budget_b} < 4 "
                f"matvecs for the polish phase of a "
                f"max_matvecs={config.max_matvecs} budget")
        polish_config = PCGConfig(tol=config.tol, max_matvecs=budget_b,
                                  gd=config.gd, trace_len=config.trace_len)

    # Both phases fused in one cached jit: a single dispatch, no host
    # round-trip between phases, no per-call vmap retracing.
    run = _ladder_fn(phase_a_solver, cfg_a, polish_config, x0 is not None)
    result = run(As_low, As, bs, x0, proj)

    if not fixup:
        return result

    # --- fixup: compact the stragglers, finish at full precision -----------
    cfg_f = SOLVERS[fixup_solver][1](tol=config.tol,
                                     max_matvecs=int(config.max_matvecs),
                                     gd=config.gd)

    def run2(A2, b2, x02, proj2, keys2):
        return _fixup_fn(fixup_solver, cfg_f)(A2, b2, x02, proj2)

    return host_compact_finish(run2, As, bs, result, proj,
                               bucket_min=fixup_bucket_min,
                               gather_A=_gather_rows)
