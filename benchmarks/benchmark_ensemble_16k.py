"""BASELINE.json config #4: 16k independent random n=1k box QPs.

16,384 stacked f32 Hessians are 64 GB, so the configuration is natively a
``solve_batched_sharded`` job over several cards (each device solves its
shard; zero collectives).  On ONE card this script streams the ensemble in
chunks, two ways:

* **Fenced pass** (one chunk): generation and solve each closed by a full
  fence, giving the honest per-phase split (``gen_s`` / ``solve_s``).
* **Streamed pass** (whole ensemble): ONE jit — a ``lax.scan`` over chunks
  whose body generates its chunk's Wisharts on device and solves them in
  place.  Zero host dispatches between chunks, and each chunk's 4 GB
  Hessian stack is a scan-body transient XLA frees before the next chunk.
  Solutions stay device-resident (a per-chunk checksum of x rides in the
  fenced outputs — same compiled program, so the fence is complete); a
  pipeline consuming results on the device never copies them out.

Reported ``solves_per_s`` counts the SOLVE phase of the fenced pass (the
reference baseline in BASELINE.md is likewise solve-only);
``end_to_end_per_s`` is the streamed pass including all generation.

Reference equivalent: 16,384 serial f64 numpy solves — ~104 s of solving at
its measured 157.7 solves/s.

Run:  python benchmarks/benchmark_ensemble_16k.py [total] [chunk]
Writes benchmarks/results/ensemble_16k.json.
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
from ccqppy_jax.models import PCGConfig
from ccqppy_jax.parallel import prepare_dense_batch, solve_batched
from ccqppy_jax.utils.benchmark import materialize
from ccqppy_jax.utils.random_qp import random_qp_batch

OUT = pathlib.Path(__file__).resolve().parent / "results"

N = 1000
TOL = 2e-5
BUDGET = 500


def main(total=16384, chunk=1024, seed=0):
    total, chunk = int(total), int(chunk)
    proj = cq.box(-jnp.ones(N), jnp.ones(N))
    cfg = PCGConfig(tol=TOL, max_matvecs=BUDGET)
    keys = jax.random.split(jax.random.PRNGKey(int(seed)), total // chunk)

    def gen(k):
        As, bs, _ = random_qp_batch(k, chunk, N, jnp.float32,
                                    diag_boost=1.0, chunk=256)
        return prepare_dense_batch(As), bs

    # --- warm-up: compile generation + solve at chunk shape ---------------
    As, bs = gen(keys[0])
    r = solve_batched("pcg", As, bs, proj=proj, config=cfg)
    materialize(r)
    del As, bs, r

    # --- fenced pass: honest per-phase split on 2 chunks ------------------
    gen_s = solve_s = 0.0
    for k in keys[:2]:
        t0 = time.perf_counter()
        As, bs = gen(k)
        As.block_until_ready()
        t1 = time.perf_counter()
        r = solve_batched("pcg", As, bs, proj=proj, config=cfg)
        materialize(r)
        t2 = time.perf_counter()
        gen_s += t1 - t0
        solve_s += t2 - t1
        del As, bs, r
    gen_s /= 2
    solve_s /= 2

    # --- streamed pass: gen + solve fused in ONE jit over all chunks ------
    from jax import lax

    from ccqppy_jax.models import SOLVERS
    from ccqppy_jax.utils.benchmark import timed_run
    from ccqppy_jax.utils.random_qp import random_qp

    solve = SOLVERS["pcg"][0]
    n_chunks = total // chunk

    @jax.jit
    def stream(key):
        chunk_keys = jax.random.split(key, n_chunks)

        def step(_, k):
            ks = jax.random.split(k, chunk)
            A, b, _ = jax.vmap(
                lambda kk: random_qp(kk, N, jnp.float32, 1.0))(ks)
            diag = jnp.diagonal(A, axis1=-2, axis2=-1)
            x0 = jnp.clip(-b / diag, -1.0, 1.0)
            r = jax.vmap(lambda A_, b_, x0_: solve(
                A_, b_, x0=x0_, proj=proj, config=cfg))(A, b, x0)
            # The solutions stay DEVICE-RESIDENT (r.x is 65 MB for the full
            # ensemble; a pipeline consuming results on the device never
            # copies them out).  The fence is still complete: converged/matvecs/
            # checksum are outputs of the SAME compiled program as x, so
            # materializing them cannot complete before the solves did.
            return None, (r.converged, r.matvecs,
                          jnp.sum(jnp.abs(r.x), axis=-1))

        _, outs = lax.scan(step, None, chunk_keys)
        return outs

    out = timed_run(
        stream, reps=2,
        make_args=lambda rep: (jax.random.fold_in(
            jax.random.PRNGKey(int(seed) + 1), rep + 1),),
        implied_bytes=float(total) * 10 * N * N * 4)   # >=10 sweeps/lane
    stream_s = out.wall_s
    conv, mv, xsum = out.result
    assert np.asarray(xsum).shape == (n_chunks, chunk)
    assert float(np.min(np.asarray(xsum))) > 0.0
    conv = np.asarray(conv).ravel()
    mv = np.asarray(mv).ravel()
    assert conv.shape == (total,)
    row = {
        "total_problems": total, "n": N, "chunk": chunk, "tol": TOL,
        # Fenced per-phase split: each phase pays its own dispatch +
        # full-materialization fence, so these rates are NOT device
        # throughput — they exist to
        # apportion gen vs solve.  The streamed number below is the
        # end-to-end figure of merit.
        "fenced_gen_s_per_chunk": round(gen_s, 3),
        "fenced_solve_s_per_chunk": round(solve_s, 3),
        "fenced_solve_per_s": round(chunk / solve_s, 1),
        "stream_s": round(stream_s, 3),
        "end_to_end_per_s": round(total / stream_s, 1),
        "stream_speedup_vs_fenced": round(
            (gen_s + solve_s) * (total // chunk) / stream_s, 3),
        "convergence_rate": float(conv.mean()),
        "matvecs_median": int(np.median(mv)),
        "backend": jax.default_backend(),
    }
    print(json.dumps(row))
    OUT.mkdir(exist_ok=True)
    (OUT / "ensemble_16k.json").write_text(json.dumps(row, indent=1))


if __name__ == "__main__":
    main(*sys.argv[1:])
