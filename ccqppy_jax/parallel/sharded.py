"""Operator parallelism: one huge QP row-sharded over a device mesh.

The BASELINE.json "single huge QP: n=1M block-sparse A row-sharded over
multi-host" configuration.  Design (the scaling-book recipe — pick a
mesh, shard the state, let collectives ride the device interconnect):

* A is partitioned into row blocks, one per device along ``axis``;
  x, g, b and all solver state vectors carry the matching 1-D sharding.
* Inside ``shard_map`` the UNMODIFIED solver kernels run on the local
  shards; a ``ShardedDenseOperator`` supplies the collective-aware matvec
  (all-gather x + local GEMV), dot products (psum), inf-norm (pmax) and
  feasible-step reduction (pmin).  No solver code changes — the operator
  abstraction owns the distribution.
* Projections must be separable (box/bounds/identity) or blockwise with
  block boundaries aligned to shards; pass per-shard bound arrays.

Communication per iteration: ONE all-gather of the iterate (n floats over
the interconnect) plus O(few) scalar psums — the minimum for a dense
row-sharded GEMV.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as PSpec

from ccqppy_jax.models import SOLVERS
from ccqppy_jax.ops.linop import ShardedDenseOperator


def make_mesh(n_devices=None, axis="model"):
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def solve_sharded(solver, A, b, mesh, axis="model", x0=None, proj=None,
                  config=None, proj_sharded=True):
    """Solve one QP with A (n, n) row-sharded over ``mesh[axis]``.

    Parameters
    ----------
    proj_sharded:
        True  -> the projection's array parameters (bounds) are sharded like
                 x (the usual case for box/bound sets).
        False -> the projection carries no arrays (identity) or only scalars
                 shared by every shard (scalar-bound box, blockwise with
                 shard-aligned blocks whose child bounds are shared).
    """
    if isinstance(solver, str):
        fn = SOLVERS[solver][0]
    else:
        fn = solver
    axis_size = mesh.shape[axis]
    n = b.shape[-1]
    if n % axis_size:
        raise ValueError(f"n={n} must divide the mesh axis size {axis_size}")

    vec = PSpec(axis)
    mat = PSpec(axis, None)
    repl = PSpec()
    proj_spec = vec if proj_sharded else repl

    def local_solve(A_l, b_l, x0_l, proj_l):
        op = ShardedDenseOperator(A_l, axis, axis_size)
        return fn(op, b_l, x0=x0_l, proj=proj_l, config=config)

    shmapped = jax.shard_map(
        local_solve, mesh=mesh,
        in_specs=(mat, vec, vec if x0 is not None else repl, proj_spec),
        out_specs=SOLVERS_result_specs(vec, repl),
        check_vma=False)
    return shmapped(A, b, x0, proj)


def solve_sharded_blocksparse(solver, blocks, cols, b, mesh, axis="model",
                              x0=None, proj=None, config=None,
                              proj_sharded=True):
    """Solve one huge block-sparse QP row-sharded over ``mesh[axis]``.

    The BASELINE.json n=1M configuration: dense storage is impossible at
    that scale, so A arrives in the ELL layout of ``BlockSparseOperator``
    (``blocks`` (nbr, k_max, bs, bs), ``cols`` (nbr, k_max) GLOBAL block-
    column ids) and is row-block-partitioned over the mesh; the solver
    carries the sharded iterate, matvecs all-gather x and reduce
    dot products with psum — see ``ShardedBlockSparseOperator``.

    The number of block rows must divide the mesh axis size, and the
    projection must be separable or blockwise with blocks aligned to shard
    boundaries (same constraint as ``solve_sharded``).
    """
    from ccqppy_jax.ops.linop import ShardedBlockSparseOperator

    if isinstance(solver, str):
        fn = SOLVERS[solver][0]
    else:
        fn = solver
    axis_size = mesh.shape[axis]
    n = b.shape[-1]
    nbr = blocks.shape[0]
    if nbr % axis_size:
        raise ValueError(f"{nbr} block rows must divide the mesh axis size "
                         f"{axis_size}")

    vec = PSpec(axis)
    ell = PSpec(axis, None, None, None)
    colspec = PSpec(axis, None)
    repl = PSpec()
    proj_spec = vec if proj_sharded else repl

    def local_solve(blocks_l, cols_l, b_l, x0_l, proj_l):
        op = ShardedBlockSparseOperator(blocks_l, cols_l, axis, axis_size, n)
        return fn(op, b_l, x0=x0_l, proj=proj_l, config=config)

    shmapped = jax.shard_map(
        local_solve, mesh=mesh,
        in_specs=(ell, colspec, vec, vec if x0 is not None else repl,
                  proj_spec),
        out_specs=SOLVERS_result_specs(vec, repl),
        check_vma=False)
    return shmapped(blocks, cols, b, x0, proj)


def SOLVERS_result_specs(vec, repl):
    """SolveResult out_specs: the solution vector is sharded, every scalar
    field is replicated (identical on all shards after psum reductions)."""
    from ccqppy_jax.models.base import SolveResult
    return SolveResult(x=vec, residual=repl, converged=repl, matvecs=repl,
                       iterations=repl, solve_time=repl, trace=repl)
