"""BASELINE.json config #3: n=10k dense SPD QP, Lorentz-cone + disjoint-union
projections, MPRGP-BB vs SPG (plus BBPGDf/PCG for context).

The reference cannot run this configuration at all: its ConeProjOp is bugged
(``CCQPpy/src/ccqppy/solution_spaces.py:439`` "TODO: This projection
op is bugged") and a serial n=10k dense solve in f64 numpy takes minutes per
trial.  Here the constraint set is the disjoint union of 3-dim Lorentz cones
(``blockwise(lorentz_cone(mu), 3)`` — the contact-friction layout,
``benchmark_random_ccqp.py:202-211``), A is a conditioned Wishart, and each
solver runs jitted on the device.

Run:  python benchmarks/benchmark_large_cone.py [n] [mu]
Writes benchmarks/results/large_cone.json and prints a table.
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
from ccqppy_jax.models.base import pg_residual
from ccqppy_jax.ops.linop import as_operator
from ccqppy_jax.ops import projections as P
from ccqppy_jax.utils.random_qp import random_qp

OUT = pathlib.Path(__file__).resolve().parent / "results"

SOLVER_NAMES = ["mprgp_bb", "spg", "bbpgd_f", "pcg"]
TOL = 1e-5
BUDGET = 20_000


def main(n=9999, mu=1.0, seed=0):
    n = int(n) // 3 * 3                       # 3-dim cone blocks
    A, b, _ = random_qp(jax.random.PRNGKey(int(seed)), n, jnp.float32,
                        diag_boost=1.0)
    A.block_until_ready()
    proj = P.blockwise(P.lorentz_cone(float(mu)), 3)

    rows = []
    for name in SOLVER_NAMES:
        fn, cfg_cls = SOLVERS[name]
        kwargs = {"tol": TOL, "max_matvecs": BUDGET}
        cfg = cfg_cls(**kwargs)

        # Roofline-guarded shared harness; reps perturb b with random noise
        # at ~1e-4 |b| (a scalar shift would fall below the f32 ulp of
        # |b| ~ 1e4 and leave b bitwise unchanged).  Conservative traffic
        # floor: 8 sweeps of the n^2 operand (the cheapest solver does 19).
        from ccqppy_jax.utils.benchmark import timed_run
        holder = {}

        def mk(rep, _name=name):
            k = jax.random.fold_in(jax.random.PRNGKey(9),
                                   1000 * SOLVER_NAMES.index(_name) + rep + 1)
            holder["b"] = b + 1e-4 * jax.random.normal(k, b.shape, b.dtype)
            return (holder["b"],)

        out = timed_run(lambda b_: fn(A, b_, proj=proj, config=cfg),
                        reps=3, make_args=mk,
                        implied_bytes=float(n) * n * 4 * 8)
        el, r, b_rep = out.wall_s, out.result, holder["b"]
        # audit: true residual and feasibility of the returned iterate
        g = jnp.dot(A, r.x, precision=jax.lax.Precision.HIGHEST) + b_rep
        res_true = float(pg_residual(proj, r.x, g, 1e-6, as_operator(A)))
        feas = float(jnp.linalg.norm(r.x - proj.project(r.x)))
        row = {
            "solver": name,
            "converged": bool(r.converged),
            "matvecs": int(r.matvecs),
            "residual": float(r.residual),
            "true_residual": res_true,
            "feasibility_gap": feas,
            "wall_s": round(el, 4),
            "iters_per_s": round(int(r.iterations) / el, 1),
        }
        rows.append(row)
        print("%-10s conv=%-5s mv=%-6d res=%.2e true=%.2e wall=%.3fs" % (
            name, row["converged"], row["matvecs"], row["residual"],
            res_true, el))

    OUT.mkdir(exist_ok=True)
    payload = {"n": n, "mu": mu, "tol": TOL, "budget": BUDGET,
               "backend": jax.default_backend(), "rows": rows}
    (OUT / "large_cone.json").write_text(json.dumps(payload, indent=1))
    print("wrote", OUT / "large_cone.json")


if __name__ == "__main__":
    main(*sys.argv[1:])
