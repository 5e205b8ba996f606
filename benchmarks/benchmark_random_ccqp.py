"""Random-CCQP benchmark entry points.

Batched re-design of the reference script
(``CCQPpy/benchmarks/benchmark_random_ccqp.py:155-221``): the same
two studies — single-constraint families and disjoint (blockwise) 3-dim
constraint families — but each (solver, family, size) cell is one batched
device solve, results go to JSON + PNG files instead of blocking interactive
windows, and sizes extend far beyond the reference's n<=36 (the serial
reference needs hours there; the batched harness takes seconds).

Run:  python benchmarks/benchmark_random_ccqp.py [single|disjoint|both]
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax.numpy as jnp

from ccqppy_jax.utils.benchmark import (BenchmarkRandomCCQP, default_families,
                                        disjoint_families)

OUT = pathlib.Path(__file__).resolve().parent / "results"


def benchmark_single_constraint(num_trials=64, dtype=jnp.float32):
    """Reference ``benchmark_single_constraint`` (:155-183): 6 solvers x 5
    single-constraint families; extended sizes."""
    bench = BenchmarkRandomCCQP(
        num_trials,
        solvers=["pgd", "apgd", "apgd_ar", "bbpgd", "bbpgd_f", "spg", "pcg"],
        proj_factories=default_families(dtype),
        sizes=[8, 32, 128, 512],
        tol=1e-5, max_matvecs=5000, dtype=dtype, diag_boost=1.0)
    result = bench.run()
    OUT.mkdir(exist_ok=True)
    result.to_json(OUT / "single_constraint.json")
    bench.process_results(save_prefix=str(OUT / "single_constraint"))
    print(result.summary())
    return result


def benchmark_disjoint_constraints(num_trials=64, dtype=jnp.float32):
    """Reference ``benchmark_disjoint_constraints`` (:186-216): 3-dim
    constraint blocks (incl. the Lorentz cone, which the reference's bugged
    ConeProjOp could not meaningfully run)."""
    bench = BenchmarkRandomCCQP(
        num_trials,
        solvers=["apgd_ar", "bbpgd", "bbpgd_f", "spg", "mprgp", "mprgp_bb", "pcg"],
        proj_factories=disjoint_families(block_dim=3, dtype=dtype),
        sizes=[9, 33, 129, 513],
        tol=1e-5, max_matvecs=5000, dtype=dtype, diag_boost=1.0)
    result = bench.run()
    OUT.mkdir(exist_ok=True)
    result.to_json(OUT / "disjoint_constraints.json")
    bench.process_results(save_prefix=str(OUT / "disjoint_constraints"))
    print(result.summary())
    return result


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "disjoint"
    if which in ("single", "both"):
        benchmark_single_constraint()
    if which in ("disjoint", "both"):
        benchmark_disjoint_constraints()
