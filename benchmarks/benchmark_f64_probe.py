"""f64 cost probe: measure, don't assert (SURVEY.md section 7).

The framework's precision story (docs/precision.md) iterates in f32 and
reserves f64 for deep tolerances and CPU parity runs.  This probe measures
what f64 costs: the SAME batched box-QP ensemble solved with the flagship
PCG solver in f32 and in f64 (``jax_enable_x64``) on whatever backend is
live, reporting wall clock, per-sweep cost, and the achieved true residual
of each.

The f64 run also answers the accuracy half of the story: how far below the
f32 iterate floor (~1-2e-5 normalized Eq.25 residual at n=1000) the f64
iterate actually lands.

Writes benchmarks/results/f64_probe.json.
"""
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

OUT = pathlib.Path(__file__).resolve().parent / "results"

B, N = 256, 256
BUDGET = 800
REPS = 3


def run_dtype(dtype_name, tol):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import ccqppy_jax as cq
    from ccqppy_jax.models import PCGConfig
    from ccqppy_jax.models.pcg import solve as pcg_solve
    from ccqppy_jax.ops.linop import DenseOperator
    from ccqppy_jax.utils.random_qp import random_qp_batch

    dtype = jnp.dtype(dtype_name)
    As, bs, _ = random_qp_batch(jax.random.PRNGKey(0), B, N, dtype,
                                diag_boost=1.0)
    As.block_until_ready()
    proj = cq.box(-jnp.ones(N, dtype), jnp.ones(N, dtype))
    cfg = PCGConfig(tol=tol, max_matvecs=BUDGET)

    run = jax.jit(jax.vmap(lambda A, b: pcg_solve(DenseOperator(A), b,
                                                  proj=proj, config=cfg)))
    # Roofline-guarded shared harness (utils/benchmark.py): full-output
    # materialization fence + physically-impossible-wall rejection; reps
    # perturb b with random noise above the working dtype's ulp of |b|.
    from ccqppy_jax.utils.benchmark import timed_run
    itemsize = jnp.dtype(dtype).itemsize

    def mk(rep):
        k = jax.random.fold_in(jax.random.PRNGKey(3), rep + 1)
        return (As, bs + 1e-3 * jax.random.normal(k, bs.shape, dtype))

    out = timed_run(run, reps=REPS, make_args=mk,
                    implied_bytes=float(B) * 8 * N * N * itemsize)
    wall, r = out.wall_s, out.result
    mv_max = int(np.max(np.asarray(r.matvecs)))
    return {
        "dtype": dtype_name, "tol": tol,
        "wall_s": round(wall, 4),
        "solves_per_s": round(B / wall, 1),
        "sweep_cost_ms": round(1e3 * wall / max(mv_max, 1), 4),
        "converged": float(np.mean(np.asarray(r.converged))),
        "matvecs_p50": float(np.median(np.asarray(r.matvecs))),
        "matvecs_max": mv_max,
        "residual_max": float(np.max(np.asarray(r.residual))),
        "residual_p50": float(np.median(np.asarray(r.residual))),
    }


def main():
    import jax
    jax.config.update("jax_enable_x64", True)   # before any tracing

    # Same well-conditioned family both sides; the f64 run then pushes an
    # aggressively tighter tolerance to show where each dtype's floor is.
    rows = [run_dtype("float32", 2e-5),
            run_dtype("float64", 2e-5),
            run_dtype("float64", 1e-9)]

    ratio = rows[1]["wall_s"] / rows[0]["wall_s"]
    meta = {"backend": jax.default_backend(),
            "workload": f"B={B} n={N} box QPs (diag_boost=1 Wishart), "
                        f"PCG, jacobi-free x0",
            "f64_over_f32_wall": round(ratio, 2),
            "rows": rows}
    OUT.mkdir(exist_ok=True)
    with open(OUT / "f64_probe.json", "w") as f:
        json.dump(meta, f, indent=1)
    for r in rows:
        print(r)
    print(f"f64/f32 wall ratio at tol 2e-5: {ratio:.2f}x")
    print("wrote benchmarks/results/f64_probe.json")


if __name__ == "__main__":
    main()
