"""BASELINE.json config #5: a single huge block-sparse QP (n up to 1M).

Dense storage at n=1M is 4 TB — impossible anywhere.  The block-sparse ELL
operator (``ops.linop.BlockSparseOperator``: block-tridiagonal SPD, 4x4
blocks, 3 blocks per block-row; ``utils.random_qp.block_tridiag_qp``) holds
the same problem in ~200 MB, and the matvec is a static gather + batched
small GEMM.  On one card this script times the full PCG/BBPGDf solve
(``chip_smoke.py --four-cards`` checks the sharded solve against it); on a
multi-device mesh the identical problem row-shards via
``parallel.solve_sharded_blocksparse`` (one tiled all-gather of x per
iteration — exercised at small scale by ``__graft_entry__.dryrun_multichip``
and tests/test_parallel.py).

The reference has no sparse or large-n path at all (dense numpy only; its
benchmarks cap at n=36, ``benchmark_random_ccqp.py:188``).

Run:  python benchmarks/benchmark_huge_qp.py [n] [solver]
Writes benchmarks/results/huge_qp.json.
"""
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

import jax
import jax.numpy as jnp

import ccqppy_jax as cq
from ccqppy_jax.models import SOLVERS
from ccqppy_jax.utils.random_qp import block_tridiag_qp

OUT = pathlib.Path(__file__).resolve().parent / "results"

# Eq.25 normalizes by 3n, so a fixed tol weakens with dimension; 1e-9 at
# n=1M corresponds to a projected-gradient norm of 3e-3 (what 1e-5 means at
# n=3k).  The reference criterion is kept; only the target moves.
TOL = 1e-9
BUDGET = 10_000
BS = 4          # block size


def main(n=1_000_000, solver="pcg", seed=0):
    n = int(n) // BS * BS
    op, b, x_exact = block_tridiag_qp(n, int(seed), block=BS)
    jax.block_until_ready(op.blocks)
    proj = cq.box(-jnp.ones(n), jnp.ones(n))
    fn, cfg_cls = SOLVERS[solver][0], SOLVERS[solver][1]
    cfg = cfg_cls(tol=TOL, max_matvecs=BUDGET)

    # Roofline-guarded shared harness (utils/benchmark.py); reps perturb b
    # with random noise well above the f32 ulp.  Conservative traffic
    # floor: 20 sweeps of the ELL blocks (PCG needs ~48).
    from ccqppy_jax.utils.benchmark import timed_run
    ell_bytes = op.blocks.size * op.blocks.dtype.itemsize

    def mk(rep):
        k = jax.random.fold_in(jax.random.PRNGKey(9), rep + 1)
        return (b + 1e-4 * jax.random.normal(k, b.shape, b.dtype),)

    out = timed_run(lambda b_: fn(op, b_, proj=proj, config=cfg),
                    reps=3, make_args=mk, implied_bytes=20.0 * ell_bytes)
    el, r = out.wall_s, out.result
    err = float(jnp.linalg.norm(r.x - x_exact) / jnp.linalg.norm(x_exact))

    row = {
        "n": n, "solver": solver, "converged": bool(r.converged),
        "matvecs": int(r.matvecs), "iterations": int(r.iterations),
        "residual": float(r.residual), "rel_err_vs_exact": err,
        "wall_s": round(el, 4),
        "iters_per_s": round(int(r.iterations) / el, 1),
        "backend": jax.default_backend(),
        "operator_mb": round(op.blocks.size * op.blocks.dtype.itemsize / 1e6, 1),
    }
    print(json.dumps(row))
    OUT.mkdir(exist_ok=True)
    (OUT / "huge_qp.json").write_text(json.dumps(row, indent=1))


if __name__ == "__main__":
    main(*sys.argv[1:])
