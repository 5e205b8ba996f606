"""Heterogeneous (mixed-type) constraint composition at headline scale —
the reference's actual contact-mechanics pattern, batched.

The reference's ``DisjointProjOp`` interleaves arbitrary per-contact sets
with per-block parameters (``CCQPpy/src/ccqppy/
solution_spaces.py:495-560``; study shape at
``benchmark_random_ccqp.py:201-211``, n <= 12).  This benchmark proves the
scalable form (``ops.projections.segment_product`` / ``SegmentProj``:
O(num_types) trace, per-group stacked parameters) under REAL load:

  B = 1024 independent QPs, n = 999 — 333 interleaved dim-3 blocks
  ALTERNATING Lorentz cones (per-block aspect ratio mu_i in [0.5, 2]) and
  boxes (per-block half-widths in [0.5, 1.5]), conditioned Wishart
  A = G G^T + n I, b = -A x_uncon, tol 1e-5.

Solver: the strong-convexity accelerated projected gradient
(``apgd_sc`` + per-lane spectral bounds, one-time prep — see
benchmark_cone_ensemble.py), with fused MPRGP-BB as the comparison row.
Compile time of the first batched solve is recorded to substantiate the
O(num_types)-trace claim: 167 cones + 166 boxes in 2 segment groups
compile in seconds, where the ProductProj unrolling (O(333) slices in the
solver body) would multiply trace size by the block count.

Writes benchmarks/results/mixed_segment_ensemble.json.
"""
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

OUT = pathlib.Path(__file__).resolve().parent / "results"

N = 999            # 333 interleaved dim-3 blocks
BATCH = 1024
TOL = 1e-5
BUDGET = 2000
PIPELINE = 10


def main():
    import numpy as np

    import jax
    import jax.numpy as jnp

    from ccqppy_jax.models import APGDSCConfig, MPRGPBBConfig
    from ccqppy_jax.models.base import pg_residual
    from ccqppy_jax.ops import projections as P
    from ccqppy_jax.ops.linop import (DenseOperator, SpectralDense,
                                      estimate_spectral_bounds)
    from ccqppy_jax.parallel import prepare_dense_batch, solve_batched
    from ccqppy_jax.utils.benchmark import (dense_sweep_bytes, materialize,
                                            peak_hbm_bytes_per_s, timed_run)
    from ccqppy_jax.utils.random_qp import random_qp_batch

    As, bs, _ = random_qp_batch(jax.random.PRNGKey(0), BATCH, N,
                                jnp.float32, diag_boost=1.0, chunk=256)
    As.block_until_ready()
    As = prepare_dense_batch(As)

    # Interleaved heterogeneous composition with PER-BLOCK parameters —
    # exactly the reference's DisjointProjOp(op1(3), op2(3), ...) pattern.
    rng = np.random.default_rng(7)
    blocks = []
    n_cones = n_boxes = 0
    for i in range(N // 3):
        if i % 2 == 0:
            mu = float(rng.uniform(0.5, 2.0))
            blocks.append((P.lorentz_cone(mu), 3))
            n_cones += 1
        else:
            hw = rng.uniform(0.5, 1.5, 3).astype(np.float32)
            blocks.append((P.box(jnp.asarray(-hw), jnp.asarray(hw)), 3))
            n_boxes += 1
    t0 = time.perf_counter()
    proj = P.segment_product(*blocks)
    build_s = time.perf_counter() - t0
    print(f"segment_product build ({n_cones} cones + {n_boxes} boxes, "
          f"{len(proj.children)} groups): {build_s:.2f}s", flush=True)

    diag = jnp.diagonal(As, axis1=-2, axis2=-1)
    diag.block_until_ready()
    jac_x0 = jax.jit(lambda b_: jax.vmap(proj.project)(-b_ / diag))

    res_audit = jax.jit(jax.vmap(
        lambda A, b, x: pg_residual(proj, x,
                                    DenseOperator(A).matvec(x) + b,
                                    1e-6, DenseOperator(A))))

    def perturbed(tag, rep):
        k = jax.random.fold_in(jax.random.PRNGKey(tag), rep + 1)
        return bs + 1e-3 * jax.random.normal(k, bs.shape, bs.dtype)

    rows = []

    def audit_row(name, wall, r, b_used, extra=None):
        tres = np.asarray(res_audit(As, b_used, r.x))
        mvs = np.asarray(r.matvecs)
        row = {
            "solver": name, "n": N, "B": BATCH, "tol": TOL,
            "wall_s": round(wall, 4),
            "solves_per_s": round(BATCH / wall, 1),
            "converged": float(np.mean(np.asarray(r.converged))),
            "matvecs_p50": float(np.median(mvs)),
            "matvecs_max": int(np.max(mvs)),
            "true_residual_max": float(tres.max()),
            "implied_gbps": round(
                BATCH * np.mean(mvs) * N * N * 4 / wall / 1e9, 1),
        }
        if extra:
            row.update(extra)
        rows.append(row)
        print(f"{name:<30} {row['solves_per_s']:8.1f} solves/s "
              f"(conv {row['converged']:.3f}, p50 {row['matvecs_p50']:.0f} "
              f"mv, true res max {row['true_residual_max']:.2e}, "
              f"~{row['implied_gbps']} GB/s implied)", flush=True)
        return row

    # ---- headline: apgd_sc + spectral prep -------------------------------
    t0 = time.perf_counter()
    Lb, mub = estimate_spectral_bounds(As, iters=32)
    Lb.block_until_ready(); mub.block_until_ready()
    prep_s = time.perf_counter() - t0
    sop = SpectralDense(As, Lb, mub)
    sc_cfg = APGDSCConfig(tol=TOL, max_matvecs=BUDGET)

    def run_headline(b_):
        return solve_batched("apgd_sc", sop, b_, x0=jac_x0(b_), proj=proj,
                             config=sc_cfg)

    t0 = time.perf_counter()
    materialize(run_headline(bs))
    compile_s = time.perf_counter() - t0
    print(f"first batched solve incl compile: {compile_s:.1f}s "
          f"(O(num_types) trace: 2 segment groups for 333 blocks)",
          flush=True)

    implied = dense_sweep_bytes(BATCH, N, 14)
    out = timed_run(run_headline, reps=3, implied_bytes=implied,
                    make_args=lambda rep: (perturbed(1, rep),),
                    warmup=False)
    audit_row("apgd_sc + spectral prep", out.wall_s, out.result,
              perturbed(1, 2),
              {"prep_seconds_outside_clock": round(prep_s, 1),
               "first_solve_incl_compile_s": round(compile_s, 1)})

    # ---- pipelined steady-state headline ---------------------------------
    walls = []
    last, b_pipe_last = None, None
    for trial in range(2):
        bs_l = [perturbed(100 + trial, i) for i in range(PIPELINE)]
        for b_ in bs_l:
            b_.block_until_ready()
        t0 = time.perf_counter()
        outs = [run_headline(b_) for b_ in bs_l]
        materialize(outs[-1])
        wall = (time.perf_counter() - t0) / PIPELINE
        assert wall > implied / (2 * peak_hbm_bytes_per_s()), \
            "wall under roofline floor"
        walls.append(wall)
        for r_, b_ in zip(outs, bs_l):
            materialize(r_)
            assert float(np.mean(np.asarray(r_.converged))) == 1.0
            assert float(np.asarray(res_audit(As, b_, r_.x)).max()) \
                <= TOL * 1.05
        last, b_pipe_last = outs[-1], bs_l[-1]
    headline = audit_row("apgd_sc pipelined (headline)", min(walls), last,
                         b_pipe_last, {"pipeline_depth": PIPELINE})
    assert headline["converged"] == 1.0

    # ---- comparison: fused MPRGP-BB --------------------------------------
    cfg = MPRGPBBConfig(tol=TOL, max_matvecs=BUDGET, fused=True)
    out = timed_run(
        lambda b_: solve_batched("mprgp_bb", As, b_, x0=jac_x0(b_),
                                 proj=proj, config=cfg),
        reps=2, implied_bytes=implied,
        make_args=lambda rep: (perturbed(2, rep),))
    audit_row("mprgp_bb fused plain", out.wall_s, out.result,
              perturbed(2, 1))

    OUT.mkdir(exist_ok=True)
    meta = {"backend": jax.default_backend(),
            "workload": f"B={BATCH} n={N} INTERLEAVED per-block-parameter "
                        f"{n_cones} Lorentz cones (mu in [0.5,2]) + "
                        f"{n_boxes} boxes (half-width in [0.5,1.5]), dim-3 "
                        f"blocks via segment_product, conditioned Wishart, "
                        f"tol {TOL:g}",
            "timing": "roofline-guarded timed_run; headline = steady-state "
                      "pipelined dispatch; every pipelined batch "
                      "convergence-checked and residual-audited",
            "rows": rows}
    (OUT / "mixed_segment_ensemble.json").write_text(json.dumps(meta,
                                                                indent=1))
    print("wrote benchmarks/results/mixed_segment_ensemble.json")


if __name__ == "__main__":
    main()
