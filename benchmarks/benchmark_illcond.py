"""Ill-conditioned ensembles: where does mixed-precision rr-PCG pay?

The headline (well-conditioned, ``diag_boost=1`` -> cond ~ 5) ensemble only
needs ~15 sweeps, so bfloat16 cheap sweeps can absorb at most a third of the
wall and the rr ladder ties plain f32 (docs/precision.md section 5).  The
residual-replacement theory (models/pcg.py ``PCGConfig.refresh_every``)
predicts the win appears when the sweep count grows: iterative refinement
against a bf16 operator contracts the TRUE residual by ~ eps_bf16 * cond(A)
per refresh cycle, so it stays convergent while cond(A) << 1/eps_bf16 ~ 256,
and the cheap-sweep fraction -> 1 as sweeps grow with sqrt(cond).

This study scans the gap between the headline family and the raw Wishart
(reference generator, ``CCQPpy/benchmarks/benchmark_random_ccqp.py:59-60``,
which is f32-infeasible at n=1000 — the iterate floors near residual 2e-5):
``A = G G^T + diag_boost * n * I`` at diag_boost in {0.1, 0.05, 0.02}
(cond ~ 41 / 81 / 201), n=1000, box [-1,1]^n, Jacobi warm start, measuring
plain f32 PCG vs rr-PCG on the SAME problems at the SAME tolerance, with
both sides' solution quality certified by an independently recomputed
full-precision Eq.25 residual.

Writes benchmarks/results/illcond.json and prints a table.
"""
import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

OUT = pathlib.Path(__file__).resolve().parent / "results"


def true_residual_fn(proj, gd):
    import jax
    import jax.numpy as jnp

    from ccqppy_jax.models.base import pg_residual
    from ccqppy_jax.ops.linop import DenseOperator

    def one(A, b, x):
        op = DenseOperator(A)
        g = op.matvec(x) + b
        return pg_residual(proj, x, g, gd, op)

    return jax.jit(jax.vmap(one))


def main():
    import numpy as np

    import jax
    import jax.numpy as jnp

    import ccqppy_jax as cq
    from ccqppy_jax.models import PCGConfig
    from ccqppy_jax.models.pcg import solve as pcg_solve
    from ccqppy_jax.ops.linop import DenseOperator, MixedPrecDense
    from ccqppy_jax.parallel import prepare_dense_batch
    from ccqppy_jax.utils.random_qp import random_qp_batch

    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=1000)
    ap.add_argument("-B", type=int, default=1024)
    ap.add_argument("--tol", type=float, default=2e-5)
    ap.add_argument("--budget", type=int, default=2000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--boosts", type=float, nargs="+",
                    default=[0.1, 0.05, 0.02])
    ap.add_argument("--refresh", type=int, nargs="+", default=[16, 32])
    args = ap.parse_args()

    n, B = args.n, args.B
    proj = cq.box(-jnp.ones(n), jnp.ones(n))
    gd = PCGConfig().gd
    res_fn = true_residual_fn(proj, gd)

    cfg_f32 = PCGConfig(tol=args.tol, max_matvecs=args.budget)

    def run_plain(As, bs, x0):
        def one(A, b, x0_):
            return pcg_solve(DenseOperator(A), b, x0=x0_, proj=proj,
                             config=cfg_f32)
        return jax.vmap(one)(As, bs, x0)

    run_plain = jax.jit(run_plain)

    def make_rr(cfg_rr):
        def run(As, As16, bs, x0):
            def one(A, A16, b, x0_):
                return pcg_solve(MixedPrecDense(A, A16), b, x0=x0_,
                                 proj=proj, config=cfg_rr)
            return jax.vmap(one)(As, As16, bs, x0)
        return jax.jit(run)

    from ccqppy_jax.utils.benchmark import dense_sweep_bytes, timed_run

    def timed(fn, *arrs, tag=5):
        # Roofline-guarded shared harness (utils/benchmark.py): full-output
        # materialization fence, walls implying > 2x HBM peak rejected.
        # Each rep perturbs b with random noise (a uniform scalar shift
        # falls below the f32 ulp of |b| ~ 1e3 and leaves most entries
        # bitwise unchanged).  Conservative traffic floor: 20 f32 sweeps
        # (the shallowest family's p50 is ~48).
        holder = {}
        key = jax.random.PRNGKey(tag)

        def mk(rep):
            sub = jax.random.fold_in(key, rep + 1)
            a2 = list(arrs)
            a2[-2] = arrs[-2] + 1e-3 * jax.random.normal(
                sub, arrs[-2].shape, arrs[-2].dtype)
            holder["b"] = a2[-2]
            return tuple(a2)

        out = timed_run(fn, reps=args.reps, make_args=mk,
                        implied_bytes=dense_sweep_bytes(B, n, 20))
        return out.wall_s, out.result, holder["b"]

    rows = []
    for boost in args.boosts:
        As, bs, _ = random_qp_batch(jax.random.PRNGKey(0), B, n, jnp.float32,
                                    diag_boost=float(boost), chunk=256)
        As.block_until_ready()
        As, As16 = prepare_dense_batch(As, jnp.bfloat16)
        diag = jnp.diagonal(As, axis1=-2, axis2=-1)
        x0_fn = jax.jit(lambda b: jnp.clip(-b / diag, -1.0, 1.0))
        x0 = x0_fn(bs)

        wall_p, last_p, b_p = timed(run_plain, As, bs, x0)
        tres_p = np.asarray(res_fn(As, b_p, last_p.x))
        row = {
            "diag_boost": boost, "n": n, "B": B, "tol": args.tol,
            "plain_f32": {
                "wall_s": round(wall_p, 4),
                "solves_per_s": round(B / wall_p, 1),
                "converged": float(np.mean(np.asarray(last_p.converged))),
                "matvecs_p50": float(np.median(np.asarray(last_p.matvecs))),
                "matvecs_max": int(np.max(np.asarray(last_p.matvecs))),
                "true_res_max": float(tres_p.max()),
            },
            "rr": [],
        }
        for K in args.refresh:
            # segment_drop ~ eps_bf16 * cond estimate: segments stop once
            # they've cashed what bf16 precision can pay per cycle.
            drop = min(0.5, 4e-3 * (4.0 + boost) / max(boost, 1e-3))
            cfg_rr = PCGConfig(tol=args.tol, max_matvecs=args.budget,
                               refresh_every=K, segment_drop=float(drop))
            wall_r, last_r, b_r = timed(make_rr(cfg_rr), As, As16, bs, x0)
            tres_r = np.asarray(res_fn(As, b_r, last_r.x))
            row["rr"].append({
                "refresh_every": K, "segment_drop": round(drop, 4),
                "wall_s": round(wall_r, 4),
                "solves_per_s": round(B / wall_r, 1),
                "converged": float(np.mean(np.asarray(last_r.converged))),
                "matvecs_p50": float(np.median(np.asarray(last_r.matvecs))),
                "matvecs_max": int(np.max(np.asarray(last_r.matvecs))),
                "true_res_max": float(tres_r.max()),
                "speedup_vs_plain": round(wall_p / wall_r, 3),
            })
        rows.append(row)
        best = max(row["rr"], key=lambda r: r["speedup_vs_plain"])
        print(f"boost={boost:<5} plain {B/wall_p:8.1f}/s "
              f"(p50 {row['plain_f32']['matvecs_p50']:.0f} mv, "
              f"conv {row['plain_f32']['converged']:.2f}) | best rr "
              f"K={best['refresh_every']} {best['solves_per_s']:8.1f}/s "
              f"({best['speedup_vs_plain']:.2f}x, conv {best['converged']:.2f})")
        # free this family's Hessians before the next one (8 GB per family)
        for a in (As, As16, diag, x0):
            a.delete()

    OUT.mkdir(exist_ok=True)
    meta = {"backend": jax.default_backend(),
            "workload": f"B={B} n={n} box QPs, A = G G^T + boost*n*I, "
                        f"tol {args.tol:g}, jacobi x0, PCG plain-f32 vs "
                        f"rr-PCG (MixedPrecDense bf16 sweeps)",
            "rows": rows}
    with open(OUT / "illcond.json", "w") as f:
        json.dump(meta, f, indent=1)
    print("wrote benchmarks/results/illcond.json")


if __name__ == "__main__":
    main()
