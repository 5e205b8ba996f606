"""Scenario parallelism: batched QP solves via vmap + mesh sharding.

This is the batched replacement for the reference benchmark's serial
4-deep Python loop over [solver x family x size x trial]
(``CCQPpy/benchmarks/benchmark_random_ccqp.py:76-102``):

* ``solve_batched`` — ``jax.vmap`` over the problem axis.  JAX's while-loop
  batching rule gives *exact* per-lane convergence masking for free: the
  fused loop runs until every lane is done, carries of finished lanes are
  select-frozen, so results (including per-lane matvec counts) are identical
  to solving each problem alone.
* ``solve_batched_sharded`` — the same, spread over the devices of a 1-D
  mesh axis with ``shard_map`` (data-parallel over scenarios: the
  BASELINE.json "16k independent n=1k box QPs" configuration).  Collective-
  free: every device solves its own shard of the batch; linear scaling is
  the expectation, limited only by lane-convergence skew inside each shard.

Projection parameters may be shared (unbatched) or per-problem (stacked with
a leading batch axis) — pass ``proj_batched=True`` for the latter.
"""
from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PSpec

from ccqppy_jax.models import SOLVERS


def _get_solver(solver):
    if isinstance(solver, str):
        return SOLVERS[solver][0]
    return solver


def solve_batched(solver, A, b, x0=None, proj=None, config=None, keys=None,
                  proj_batched=False):
    """Solve a batch of QPs: A (B,n,n) or operator pytree with leading batch
    axis on its leaves; b (B,n).  Returns a SolveResult with leading batch
    axis on every field."""
    fn = _get_solver(solver)
    in_proj_axis = 0 if proj_batched else None

    def one(A_i, b_i, x0_i, proj_i, key_i):
        kwargs = {}
        if key_i is not None:
            kwargs["key"] = key_i
        return fn(A_i, b_i, x0=x0_i, proj=proj_i, config=config, **kwargs)

    return jax.vmap(one, in_axes=(0, 0, 0 if x0 is not None else None,
                                  in_proj_axis, 0 if keys is not None else None)
                    )(A, b, x0, proj, keys)


def solve_batched_sharded(solver, A, b, mesh, axis="batch", x0=None,
                          proj=None, config=None, keys=None,
                          proj_batched=False):
    """Shard the batch across ``mesh[axis]`` and vmap-solve each shard.

    The batch size must divide the axis size.  Inputs may live anywhere;
    outputs come back sharded over ``axis`` (leading dim).
    """
    fn = _get_solver(solver)

    def local_solve(A_l, b_l, x0_l, proj_l, keys_l):
        return solve_batched(fn, A_l, b_l, x0=x0_l, proj=proj_l,
                             config=config, keys=keys_l,
                             proj_batched=proj_batched)

    sharded = PSpec(axis)
    repl = PSpec()

    in_specs = (sharded, sharded,
                sharded if x0 is not None else repl,
                sharded if proj_batched else repl,
                sharded if keys is not None else repl)
    # Every result field is sharded over the batch axis — except a disabled
    # (zero-length) residual trace, which XLA pins to replicated.
    from ccqppy_jax.models.base import SolveResult
    trace_on = config is not None and getattr(config, "trace_len", 0) > 0
    out_specs = SolveResult(
        x=sharded, residual=sharded, converged=sharded, matvecs=sharded,
        iterations=sharded, solve_time=sharded,
        trace=sharded if trace_on else repl)

    shmapped = jax.shard_map(
        local_solve, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False)
    return shmapped(A, b, x0, proj, keys)


def solve_batched_compact(solver, A, b, phase1_matvecs, x0=None, proj=None,
                          config=None, keys=None, proj_batched=False):
    """Two-phase batched solve with straggler compaction.

    A single batched while-loop runs until the SLOWEST lane converges, so
    one hard problem makes the whole batch re-read every A each iteration
    (measured ~1.6-2x waste on Wishart ensembles).  This variant:

      phase 1: solve everything with a matvec budget of ``phase1_matvecs``
               (pick ~2x the median cost);
      phase 2: gather the unconverged lanes into a compact batch (padded to
               a power of two to bound recompilations), warm-start them from
               their phase-1 iterates, and run with the remaining budget.

    Results are bit-valid per lane (converged lanes' residuals are genuine);
    matvec counts accumulate across phases and per-lane totals respect
    ``config.max_matvecs``: phase 2 runs with exactly the budget phase 1 left
    (``max_matvecs - phase1_matvecs``; a lane reaching phase 2 spent the full
    phase-1 budget).  A solver whose iteration spends several matvecs before
    its budget check (APGD backtracking) can overshoot by that intra-
    iteration amount — the same overshoot an uninterrupted solve has.  Note
    the continuation is not trajectory-identical to an uninterrupted solve
    (BB solvers re-seed their step size at restart) — convergence semantics,
    not trajectories, are preserved.
    """
    import dataclasses

    fn = _get_solver(solver)
    remaining = int(config.max_matvecs) - int(phase1_matvecs)
    if remaining < 4:
        raise ValueError(
            f"phase1_matvecs={phase1_matvecs} leaves {remaining} < 4 matvecs "
            f"for phase 2 of a max_matvecs={config.max_matvecs} budget; pick "
            "a smaller phase-1 budget (~2x the median solve cost)")
    cfg1 = dataclasses.replace(config, max_matvecs=int(phase1_matvecs))
    r1 = solve_batched(fn, A, b, x0=x0, proj=proj, config=cfg1, keys=keys,
                       proj_batched=proj_batched)
    cfg2 = dataclasses.replace(config, max_matvecs=remaining)

    def run2(A2, b2, x02, proj2, keys2):
        return solve_batched(fn, A2, b2, x0=x02, proj=proj2, config=cfg2,
                             keys=keys2, proj_batched=proj_batched)

    return host_compact_finish(run2, A, b, r1, proj, keys=keys,
                               proj_batched=proj_batched, bucket_min=1)


def _row_gather(arr, idx):
    """Layout-preserving in-graph row gather: a ``lax.map`` of row
    ``dynamic_slice``s compiles to per-row DMA, unlike XLA's gather lowering
    which relayouts the whole stacked operand (parallel/mixed.py measured
    +7.8 GB HBM on the headline batch)."""
    return jax.lax.map(
        lambda j: jax.lax.dynamic_slice_in_dim(arr, j, 1, axis=0)[0], idx)


def _default_gather_A(A, idx):
    """Row-gather for a stacked dense A; tree-mapped take for operator
    pytrees with a leading batch axis on their leaves."""
    if getattr(A, "ndim", None) == 3:
        return _row_gather(A, idx)
    return jax.tree.map(lambda leaf: jnp.take(leaf, idx, axis=0), A)


def host_compact_finish(run2, A, b, r1, proj, keys=None, proj_batched=False,
                        bucket_min=16, gather_A=None, eligible=None):
    """Shared host-side straggler compaction: gather the unconverged lanes of
    ``r1`` into a power-of-two bucket, re-solve them warm-started via
    ``run2(A2, b2, x02, proj2, keys2) -> SolveResult``, scatter the results
    back.  Used by ``solve_batched_compact``, the fused-compact host
    fallback, and the mixed-precision ladder's fixup (parallel/mixed.py).

    ``gather_A`` overrides the Hessian gather (e.g. a layout-cached variant);
    the default uses per-row DMA for (B, n, n) stacks and a tree-mapped take
    for operator pytrees.  ``eligible`` (bool mask, default ``~converged``)
    restricts which lanes are re-solved — callers with a per-lane budget
    contract pass ``~converged & (matvecs < budget)`` so exhausted lanes are
    not re-run.
    """
    import numpy as np

    from ccqppy_jax.models.base import SolveResult

    conv = np.asarray(r1.converged)
    mask = ~conv if eligible is None else np.asarray(eligible)
    if not mask.any():
        return r1
    idx = np.nonzero(mask)[0]
    m = len(idx)
    bucket = max(1 << (m - 1).bit_length(), int(bucket_min))
    pad = np.concatenate([idx, np.repeat(idx[-1], bucket - m)])
    pad_j = jnp.asarray(pad)

    A2 = (gather_A or _default_gather_A)(A, pad_j)
    b2 = jnp.take(b, pad_j, axis=0)
    x02 = jnp.take(r1.x, pad_j, axis=0)
    keys2 = None if keys is None else jnp.take(keys, pad_j, axis=0)
    proj2 = jax.tree.map(lambda leaf: jnp.take(leaf, pad_j, axis=0), proj) \
        if proj_batched else proj
    r2 = run2(A2, b2, x02, proj2, keys2)

    sl = slice(0, m)
    idx_j = jnp.asarray(idx)
    # Re-solved lanes report their phase-2 residual history (the tail then
    # agrees with the reported final residual); phase-1 traces of those lanes
    # are replaced, not appended — trace buffers are fixed-length.
    trace = r1.trace
    if getattr(trace, "ndim", 0) >= 2 and trace.shape[-1] > 0:
        trace = trace.at[idx_j].set(r2.trace[sl])
    return SolveResult(
        x=r1.x.at[idx_j].set(r2.x[sl]),
        residual=r1.residual.at[idx_j].set(r2.residual[sl]),
        converged=r1.converged.at[idx_j].set(r2.converged[sl]),
        matvecs=r1.matvecs.at[idx_j].add(r2.matvecs[sl]),
        iterations=r1.iterations.at[idx_j].add(r2.iterations[sl]),
        solve_time=r1.solve_time,
        trace=trace,
    )


@lru_cache(maxsize=64)
def _fused_compact_fn(solver, cfg1, cfg2, bucket, has_x0, has_keys):
    """Build (and cache) the single-dispatch two-phase compacted solve."""
    import dataclasses

    from ccqppy_jax.models.base import SolveResult

    fn = _get_solver(solver)

    def run(As, bs, x0, proj, keys):
        B = bs.shape[0]
        r1 = jax.vmap(lambda A, b, x0_i, k: fn(
            A, b, x0=x0_i, proj=proj, config=cfg1,
            **({} if k is None else {"key": k})),
            in_axes=(0, 0, 0 if has_x0 else None, 0 if has_keys else None)
        )(As, bs, x0, keys)
        bad = ~r1.converged
        nbad = jnp.sum(bad)
        idx = jnp.nonzero(bad, size=bucket, fill_value=0)[0]
        valid = jnp.arange(bucket) < nbad

        # Tree-map supports operator pytrees (e.g. MixedPrecDense) with a
        # leading batch axis on every leaf; a raw (B, n, n) stack is the
        # single-leaf case.
        A2 = jax.tree.map(lambda leaf: _row_gather(leaf, idx), As)
        b2 = jnp.take(bs, idx, axis=0)
        x02 = jnp.take(r1.x, idx, axis=0)
        # Phase-2 keys: per-lane fold_in so the restarted SPG stream is
        # independent of the (already consumed) phase-1 stream.
        keys2 = None if not has_keys else jax.vmap(
            lambda k: jax.random.fold_in(k, 1))(jnp.take(keys, idx, axis=0))
        r2 = jax.vmap(lambda A, b, x0_i, k: fn(
            A, b, x0=x0_i, proj=proj, config=cfg2,
            **({} if k is None else {"key": k})),
            in_axes=(0, 0, 0, 0 if has_keys else None))(A2, b2, x02, keys2)

        # Scatter phase-2 results over the genuine stragglers; padding lanes
        # point out of bounds and drop.  Re-solved lanes report their phase-2
        # residual history so the trace tail matches the final residual.
        sc = jnp.where(valid, idx, B)
        trace = r1.trace
        if getattr(trace, "ndim", 0) >= 2 and trace.shape[-1] > 0:
            trace = trace.at[sc].set(r2.trace, mode="drop")
        return SolveResult(
            x=r1.x.at[sc].set(r2.x, mode="drop"),
            residual=r1.residual.at[sc].set(r2.residual, mode="drop"),
            converged=r1.converged.at[sc].set(r2.converged, mode="drop"),
            matvecs=r1.matvecs.at[sc].add(r2.matvecs, mode="drop"),
            iterations=r1.iterations.at[sc].add(r2.iterations, mode="drop"),
            solve_time=r1.solve_time,
            trace=trace,
        )

    return jax.jit(run)


def solve_batched_fused_compact(solver, A, b, phase1_matvecs, x0=None,
                                proj=None, config=None, bucket=256,
                                host_fallback=True, keys=None):
    """Two-phase straggler compaction fused into ONE dispatch.

    ``solve_batched_compact`` (above) pays 4+ extra host round-trips, each
    a dispatch and a device-to-host sync.  This variant runs phase 1
    (budget ``phase1_matvecs``), the
    straggler gather (layout-preserving per-row DMA), the warm-started
    compact phase 2, and the result scatter inside a single jit.

    ``bucket`` is the static phase-2 width: pick it above the expected
    straggler count at the chosen phase-1 budget (e.g. B/8 at a p90 budget).
    If MORE than ``bucket`` lanes miss phase 1, the overflow lanes keep their
    honest phase-1 state (converged=False); with ``host_fallback=True`` a
    host-side compacted pass then finishes them (rare -> the extra dispatches
    are only paid when it actually happens).

    Requires a shared (unbatched) projection.  Results are per-lane honest:
    converged flags/residuals are genuine, matvec counts accumulate.
    """
    import dataclasses

    import numpy as np

    if not isinstance(solver, str):
        raise TypeError("solve_batched_fused_compact takes a solver NAME "
                        "(the jitted pipeline is cached per name+config)")
    remaining = int(config.max_matvecs) - int(phase1_matvecs)
    if remaining < 4:
        raise ValueError(
            f"phase1_matvecs={phase1_matvecs} leaves {remaining} < 4 matvecs "
            f"for phase 2 of a max_matvecs={config.max_matvecs} budget")
    cfg1 = dataclasses.replace(config, max_matvecs=int(phase1_matvecs))
    cfg2 = dataclasses.replace(config, max_matvecs=remaining)
    run = _fused_compact_fn(solver, cfg1, cfg2, int(bucket), x0 is not None,
                            keys is not None)
    r = run(A, b, x0, proj, keys)
    if not host_fallback:
        return r
    conv = np.asarray(r.converged)
    if conv.all():
        return r
    # Overflow lanes (> bucket stragglers missed the fused phase 2 and spent
    # only the phase-1 budget): finish them with the host-side compacted
    # path, warm-started, on the remaining budget.  Lanes that already
    # exhausted the FULL budget keep their honest converged=False — re-running
    # them would break the per-lane matvec contract for no benefit.
    fn = _get_solver(solver)
    eligible = ~conv & (np.asarray(r.matvecs) < int(config.max_matvecs))
    if not eligible.any():
        return r

    def run2(A2, b2, x02, proj2, keys2):
        return solve_batched(fn, A2, b2, x0=x02, proj=proj2, config=cfg2,
                             keys=keys2)

    # fold_in mirrors the fused phase 2: overflow lanes restart their RNG
    # stream independent of the consumed phase-1 stream.
    keys_f = None if keys is None else jax.vmap(
        lambda k: jax.random.fold_in(k, 1))(keys)
    return host_compact_finish(run2, A, b, r, proj, keys=keys_f,
                               eligible=eligible)


def make_batch_mesh(n_devices=None, axis="batch"):
    """1-D device mesh over all (or the first n) local devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    import numpy as np
    return Mesh(np.array(devs), (axis,))
