"""Headline benchmark: batched 1k-dim box-QP throughput on one GPU.

Workload (matched on both sides):
  B independent QPs, n=1000, A = G G^T + n I (well-conditioned Wishart,
  G ~ N(0,1)^{n x n}), b = -A x_uncon with x_uncon ~ U(-1,1)^n, box [-1,1]^n,
  tol 2e-5, 500-matvec budget.  Hessians are FIXED per ensemble; each timed
  batch streams freshly perturbed right-hand sides (real serving streams b,
  not A).

HEADLINE — direct-factorization serving (models/direct.py):
  * one-time prep OUTSIDE the clock (same status as the Jacobi
    ``diag(A)`` prep): batched Cholesky inverse of the fixed ensemble;
  * per timed call: x0 = proj(A^-1 (-b)) — ONE sweep of A^-1 at HIGHEST —
    then the verified-PCG pipeline, whose init/verification sweep checks
    every lane's true residual against tol; straggler lanes are finished
    by the fused compaction polish;
  * ~2 operator sweeps per solve instead of the iterative path's ~16.
  Baseline for this mode: the reference ``CCQPSolverBBPGDf`` given the
  SAME courtesy (scipy cho_factor prep outside its clock, clipped
  cho_solve warm start, measured in this container 2026-08-21):
  217.3 solves/s, mv avg 1.0.  Without prep it measures 208/s at this tol.

ITERATIVE metric (reported alongside): PCG face solver + per-call Jacobi
x0 + fused straggler compaction (phase1=17, bucket=256) at B=2048, with
the post-GEMV optimization barrier (ops/linop.py ``_gemv_fence``).  Its
baseline is the no-prep reference BBPGDf: 157.7 solves/s (BASELINE.md).

Timing integrity: every number runs through the roofline-guarded
``timed_run`` (utils/benchmark.py) or replicates its fence pattern —
dependent-checksum in-clock fence, full materialization + convergence
check of EVERY timed batch outside the clock, walls implying > 2x the
device's HBM peak (``PEAK_HBM_BYTES_PER_S``) rejected.  Pipelined
(steady-state) dispatch keeps several batches in flight, as a serving
stream would; single-dispatch numbers are reported alongside.

Prints ONE JSON line, naming the device it ran on:
  {"metric": ..., "value": N, "unit": "solves/s", "vs_baseline": N, ...}
"""
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

REFERENCE_DIRECT_SOLVES_PER_S = 217.3   # cho-prep courtesy; module docstring
REFERENCE_ITER_SOLVES_PER_S = 157.7     # no-prep BBPGDf; BASELINE.md

N = 1000
TOL = 2e-5
BUDGET = 500
SEED = 0

B_ITER = 2048
PHASE1 = 17        # p50 sweep count + the verification sweep (round 4)
BUCKET = 256
PIPELINE = 5       # iterative: back-to-back dispatches per measurement

B_DIRECT = 1024    # As + A^-1 both resident: 2 x 4.1 GB
PIPE_DIRECT = 8


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    import ccqppy_jax as cq
    from ccqppy_jax.models import PCGConfig
    from ccqppy_jax.models.direct import (direct_x0, spd_inverse_batch)
    from ccqppy_jax.parallel import (prepare_dense_batch,
                                     solve_batched_fused_compact)
    from ccqppy_jax.utils.benchmark import (card_info, dense_sweep_bytes,
                                            materialize, peak_hbm_bytes_per_s,
                                            timed_run, use_compile_cache)
    from ccqppy_jax.utils.random_qp import random_qp_batch

    use_compile_cache()
    device = card_info()
    peak = peak_hbm_bytes_per_s(device["kind"])

    As, bs, _ = random_qp_batch(jax.random.PRNGKey(SEED), B_ITER, N,
                                jnp.float32, diag_boost=1.0, chunk=256)
    As = prepare_dense_batch(As)

    proj = cq.box(-jnp.ones(N), jnp.ones(N))
    cfg = PCGConfig(tol=TOL, max_matvecs=BUDGET)
    diag = jnp.diagonal(As, axis1=-2, axis2=-1)
    diag.block_until_ready()
    jacobi_x0 = jax.jit(lambda b: jnp.clip(-b / diag, -1.0, 1.0))
    checksum = jax.jit(lambda x: jnp.sum(jnp.abs(x)))

    def perturbed(base, tag, rep):
        k = jax.random.fold_in(jax.random.PRNGKey(tag), rep + 1)
        # Random NORMAL noise at 1e-3 absolute — a uniform scalar shift of
        # that size would fall below the f32 ulp of the largest |b| entries
        # (~1e3) and leave them bitwise unchanged.
        return base + 1e-3 * jax.random.normal(k, base.shape, base.dtype)

    def check(r_):
        c = float(np.mean(np.asarray(r_.converged)))
        assert c == 1.0, f"timed rep convergence {c} != 1.0"

    def run_iter(b):
        return solve_batched_fused_compact(
            "pcg", As, b, PHASE1, x0=jacobi_x0(b), proj=proj, config=cfg,
            bucket=BUCKET, host_fallback=False)

    # ---- iterative warm-up (compile) -------------------------------------
    r = run_iter(bs)
    conv = float(np.mean(np.asarray(r.converged)))
    assert conv == 1.0, f"warm-up convergence {conv} != 1.0"

    # ---- iterative: single-dispatch through timed_run --------------------
    implied_iter = dense_sweep_bytes(B_ITER, N, 10)
    out = timed_run(run_iter, reps=3, implied_bytes=implied_iter,
                    make_args=lambda rep: (perturbed(bs, 11, rep),),
                    warmup=False, check=check,
                    fence=lambda r_: checksum(r_.x))
    iter_single = out.wall_s

    # ---- iterative: steady-state pipelined -------------------------------
    def pipelined(run, base, tag, depth, implied):
        walls = []
        for trial in range(2):
            bs_l = [perturbed(base, tag + trial, i) for i in range(depth)]
            for b_ in bs_l:
                b_.block_until_ready()
            t0 = time.perf_counter()
            outs = [run(b_) for b_ in bs_l]
            cs = float(checksum(outs[-1].x))
            wall = (time.perf_counter() - t0) / depth
            assert cs > 0.0
            assert wall > implied / (2 * peak), "wall under roofline"
            walls.append(wall)
            # EVERY trial's batches materialized + convergence-checked
            # outside the clock (advisor r4).
            for r_ in outs:
                materialize(r_)
                check(r_)
        return min(walls)

    iter_wall = pipelined(run_iter, bs, 100, PIPELINE, implied_iter)
    iter_value = B_ITER / iter_wall

    # ---- direct serving phase --------------------------------------------
    # Fresh B=1024 ensemble (same family, next seed): the B=2048 iterative
    # stack is deleted first so ensemble + inverse (2 x 4.1 GB) fit; a
    # slice view of the big stack would materialize a third copy.
    As.delete()
    del As, diag
    As_d, bs_d, _ = random_qp_batch(jax.random.PRNGKey(SEED + 1), B_DIRECT,
                                    N, jnp.float32, diag_boost=1.0,
                                    chunk=256)
    As_d.block_until_ready()
    As_d = prepare_dense_batch(As_d)

    def run_direct_with(Ainv, b):
        return solve_batched_fused_compact(
            "pcg", As_d, b, 3, x0=direct_x0(Ainv, b, proj), proj=proj,
            config=cfg, bucket=64, host_fallback=False)

    from ccqppy_jax.models.base import pg_residual
    from ccqppy_jax.ops.linop import DenseOperator
    res_audit = jax.jit(jax.vmap(
        lambda A, b, x: pg_residual(proj, x, DenseOperator(A).matvec(x) + b,
                                    1e-6, DenseOperator(A))))

    prep_t0 = time.perf_counter()
    Ainv = spd_inverse_batch(As_d, chunk=128)
    Ainv.block_until_ready()
    prep_s = time.perf_counter() - prep_t0

    implied_direct = dense_sweep_bytes(B_DIRECT, N, 2)
    out = timed_run(lambda b: run_direct_with(Ainv, b), reps=3,
                    implied_bytes=implied_direct,
                    make_args=lambda rep: (perturbed(bs_d, 21, rep),),
                    warmup=True, check=check,
                    fence=lambda r_: checksum(r_.x))
    direct_single = out.wall_s
    mv = np.asarray(out.result.matvecs)

    direct_wall = pipelined(lambda b: run_direct_with(Ainv, b), bs_d, 200,
                            PIPE_DIRECT, implied_direct)
    value = B_DIRECT / direct_wall

    # independent residual audit of the last single-dispatch result
    b_last = perturbed(bs_d, 21, 2)
    tres = float(np.asarray(res_audit(As_d, b_last, out.result.x)).max())
    assert tres <= TOL * 1.05, f"audited residual {tres} above tol"

    result = {
        "metric": f"batched {N}-dim box-QP solves/s (fixed-ensemble "
                  f"serving: precomputed Cholesky inverse + verified PCG "
                  f"polish, tol {TOL:g}, B={B_DIRECT}, "
                  f"steady-state pipelined dispatch)",
        "device": device,
        "value": round(value, 1),
        "unit": "solves/s",
        "vs_baseline": round(value / REFERENCE_DIRECT_SOLVES_PER_S, 2),
        "convergence_rate": 1.0,
        "wall_s": round(direct_wall, 4),
        "single_dispatch_solves_per_s": round(B_DIRECT / direct_single, 1),
        "true_residual_max": tres,
        "matvecs_p50": float(np.median(mv)),
        "prep_seconds_outside_clock": round(prep_s, 1),
        "iterative_solves_per_s": round(iter_value, 1),
        "iterative_vs_baseline": round(
            iter_value / REFERENCE_ITER_SOLVES_PER_S, 2),
        "iterative_single_dispatch_solves_per_s": round(
            B_ITER / iter_single, 1),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
