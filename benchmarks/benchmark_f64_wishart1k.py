"""The reference's hardest workload: raw Wishart n=1000 at f64 truth.

`BenchmarkRandomCCQP`'s generator with no diagonal boost
(``CCQPpy/benchmarks/benchmark_random_ccqp.py:59-60``) draws
A ~ Wishart(df=n, I) — near-singular at n=1000 (condition ~1e5-1e7): f32
iterates floor around Eq.25 residual ~2e-5 on this family, so tol 1e-5
needs f64 truth.  Reference counterpart: serial f64 numpy at **2.13
solves/s** (BBPGDf, tol 1e-5 — BASELINE.md, CPU).

This benchmark is the f64-EXACT rung of the
existing mixed-precision ladder (models/pcg.py ``refresh_every`` +
``ops.linop.MixedPrecDense``): the operand pair is (A float64, A_low
float32); CG recurrences ride native-f32 sweeps with the state carried in
f64, and every ``refresh_every`` iterations — and before any convergence
claim — the gradient is recomputed by ONE f64 sweep, which also
produces the only residuals ever reported.  Per refinement cycle the true
residual contracts by ~ ||A - A_f32|| ||A^-1|| ~ 6e-8 * cond(A) (< 1 for
cond up to ~1e7, exactly this family), so the solve reaches f64-grade
residuals at f32 sweep cost.  Whether plain f64 PCG (twice the bytes per
sweep, native f64 on the card) beats this rung is not measured yet.

Every row is audited by an independently recomputed f64 Eq.25 residual;
timed through the roofline-guarded ``timed_run``.

Writes benchmarks/results/f64_wishart1k.json.
"""
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

OUT = pathlib.Path(__file__).resolve().parent / "results"

B, N = 64, 1000
# (tol, budget) ladder: 1e-5 is the BASELINE.md comparison row; 1e-9 and
# 1e-10 are the reference's desired_tol story (README.md:55-59 leads with a
# 1e-10 example) — each refinement cycle contracts the true residual by
# ~ eps_f32 * cond(A), so deep tolerances just take more cycles until the
# f64-refresh floor (~ eps_f64 * cond * scale) is reached.
TOLS = ((1e-5, 20_000), (1e-9, 60_000), (1e-10, 80_000))
CHUNK_BUDGET = 10_000   # per-dispatch matvec cap: deep tolerances run as
                        # warm-restarted continuation dispatches, budgets
                        # accumulating.
REFRESH = 128
SEGMENT_DROP = 0.25      # ~ few x eps_f32 * cond — see PCGConfig.segment_drop
REFERENCE_SOLVES_PER_S = 2.13     # BASELINE.md, measured 2026-08-17 (tol 1e-5)


def main():
    import jax
    jax.config.update("jax_enable_x64", True)   # before any tracing

    import numpy as np

    import jax.numpy as jnp

    import ccqppy_jax as cq
    from ccqppy_jax.models import PCGConfig
    from ccqppy_jax.models.base import pg_residual
    from ccqppy_jax.models.pcg import solve as pcg_solve
    from ccqppy_jax.ops.linop import DenseOperator, MixedPrecDense
    from ccqppy_jax.utils.benchmark import timed_run
    from ccqppy_jax.utils.random_qp import random_qp_batch

    dtype = jnp.float64
    As, bs, _ = random_qp_batch(jax.random.PRNGKey(0), B, N, dtype,
                                diag_boost=0.0, chunk=64)
    As.block_until_ready()
    As32 = As.astype(jnp.float32)
    proj = cq.box(-jnp.ones(N, dtype), jnp.ones(N, dtype))

    # diag rides as an ARGUMENT: captured in a closure it would be inlined
    # into the jit as a constant (host-materialized at lowering).
    diag = jnp.diagonal(As, axis1=-2, axis2=-1)

    audit = jax.jit(jax.vmap(
        lambda A, b, x: pg_residual(proj, x, DenseOperator(A).matvec(x) + b,
                                    1e-6, DenseOperator(A))))

    rows = []
    for tol, budget in TOLS:
        per_dispatch = min(budget, CHUNK_BUDGET)
        cfg = PCGConfig(tol=tol, max_matvecs=per_dispatch,
                        refresh_every=REFRESH, segment_drop=SEGMENT_DROP)

        chunk = jax.jit(lambda A64, A32, b_, x0_, cfg=cfg: jax.vmap(
            lambda a64, a32, b, x0: pcg_solve(
                MixedPrecDense(a64, a32), b, x0=x0, proj=proj, config=cfg))(
                A64, A32, b_, x0_))

        def run(A64, A32, b_, d_):
            # Warm-restarted continuation: each dispatch spends at most
            # CHUNK_BUDGET matvecs; totals accumulate across chunks up to
            # the row's budget.  Restarted rr-PCG re-seeds its segment
            # structure from the carried iterate — convergence semantics,
            # not trajectories, are preserved (cf. parallel/batch.py
            # compaction notes).
            x = jnp.clip(-b_ / d_, -1.0, 1.0)
            r = chunk(A64, A32, b_, x)
            mv = r.matvecs
            import dataclasses as _dc
            while (not bool(jax.device_get(r.converged.all()))
                   and int(jax.device_get(mv.max())) < budget):
                r2 = chunk(A64, A32, b_, r.x)
                mv = mv + r2.matvecs
                r = _dc.replace(r2, matvecs=mv)
            return _dc.replace(r, matvecs=mv)

        def mk(rep):
            k = jax.random.fold_in(jax.random.PRNGKey(7), rep + 1)
            return (As, As32,
                    bs + 1e-3 * jax.random.normal(k, bs.shape, dtype), diag)

        # Traffic floor: 100 f32 sweeps/lane of the (n, n) operand.
        out = timed_run(run, reps=2, make_args=mk,
                        implied_bytes=float(B) * 100 * N * N * 4)
        r = out.result
        b_last = mk(1)[2]
        tres = np.asarray(audit(As, b_last, r.x))
        mvs = np.asarray(r.matvecs)
        conv = np.asarray(r.converged)
        row = {
            "B": B, "n": N, "tol": tol,
            "method": "rr-PCG, f64-exact rung: f32 cheap sweeps + "
                      f"emulated-f64 refresh every {REFRESH} "
                      "(MixedPrecDense f64/f32)",
            "family": "raw Wishart (diag_boost=0) — the reference generator",
            "wall_s": round(out.wall_s, 3),
            "solves_per_s": round(B / out.wall_s, 2),
            "converged": float(conv.mean()),
            "matvecs_p50": float(np.median(mvs)),
            "matvecs_max": int(mvs.max()),
            "true_residual_max_converged": float(tres[conv].max())
            if conv.any() else None,
            "true_residual_p50": float(np.median(tres)),
            "backend": jax.default_backend(),
        }
        if tol == 1e-5:
            row["vs_reference_2.13_per_s"] = round(
                B / out.wall_s / REFERENCE_SOLVES_PER_S, 1)
        rows.append(row)
        print(json.dumps(row), flush=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "f64_wishart1k.json").write_text(json.dumps(
        {"rows": rows}, indent=1))


if __name__ == "__main__":
    main()
