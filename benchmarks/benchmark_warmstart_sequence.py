"""Warm-started QP sequences — the time-stepping workload, fused on device.

The reference's only resume mechanism is the ``x0`` argument
(``solvers.py:19,94``); this is also how real contact-mechanics pipelines
use CCQP solvers: at each time step the Hessian is fixed (or slowly
varying) and the rhs moves a little, so the previous step's solution is an
excellent start.  This script quantifies the warm-start payoff at batch
scale: B independent box QPs whose rhs drifts by a random walk over T
steps, solved cold (x0 = 0 every step) vs warm (x0 = previous solution).

The WHOLE T-step sequence runs inside ONE jit — a ``lax.scan`` over steps
carrying (b, x_prev, key), generating the drift on device with a threaded
PRNG key and solving each step warm-started from the carry.  The steps are
serially dependent, so a per-step dispatch would pay the host's dispatch
cost T times; with the scan there is exactly one dispatch for the whole
sequence — for both the cold and warm variants — so the sweep ratio is
the wall ratio.  Whether per-step dispatch costs anything measurable on a
local card is not measured yet.

Run:  python benchmarks/benchmark_warmstart_sequence.py [B] [n] [steps]
Writes benchmarks/results/warmstart_sequence.json.
"""
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

import ccqppy_jax as cq
from ccqppy_jax.models import SOLVERS, PCGConfig
from ccqppy_jax.parallel import prepare_dense_batch
from ccqppy_jax.utils.benchmark import dense_sweep_bytes, timed_run
from ccqppy_jax.utils.random_qp import random_qp_batch

OUT = pathlib.Path(__file__).resolve().parent / "results"

TOL = 2e-5
BUDGET = 500
DRIFT = 0.02        # rhs random-walk scale per step (relative)


def main(B=512, n=1000, steps=20, seed=0):
    B, n, steps = int(B), int(n), int(steps)
    As, bs, _ = random_qp_batch(jax.random.PRNGKey(int(seed)), B, n,
                                jnp.float32, diag_boost=1.0)
    As = prepare_dense_batch(As)
    proj = cq.box(-jnp.ones(n), jnp.ones(n))
    cfg = PCGConfig(tol=TOL, max_matvecs=BUDGET)
    bscale = float(jnp.mean(jnp.abs(bs)))
    solve = SOLVERS["pcg"][0]

    def make_seq(warm):
        @jax.jit
        def seq(As_, b0, key):
            def step(carry, _):
                b, x_prev, k = carry
                k, sub = jax.random.split(k)
                b = b + DRIFT * bscale * jax.random.normal(sub, b.shape,
                                                           b.dtype)
                x0 = x_prev if warm else jnp.zeros_like(b)
                r = jax.vmap(lambda A, b_, x0_: solve(
                    A, b_, x0=x0_, proj=proj, config=cfg))(As_, b, x0)
                stats = (jnp.sum(r.matvecs), jnp.all(r.converged),
                         jnp.max(r.residual), jnp.max(r.matvecs))
                return (b, r.x, k), stats
            init = (b0, jnp.zeros_like(b0), key)
            (_, xT, _), stats = lax.scan(step, init, None, length=steps)
            return xT, stats
        return seq

    rows = {}
    for label, warm in (("cold", False), ("warm", True)):
        seq = make_seq(warm)

        def mk(rep, _seq=seq):
            return (As, bs, jax.random.fold_in(jax.random.PRNGKey(1),
                                               rep + 1))

        # Conservative traffic floor: 10 f32 sweeps/step (cold p50 is ~19).
        out = timed_run(seq, reps=3, make_args=mk,
                        implied_bytes=dense_sweep_bytes(B, n, 10 * steps),
                        check=lambda o: (_ for _ in ()).throw(
                            AssertionError("unconverged step"))
                        if not bool(np.all(np.asarray(o[1][1]))) else None)
        _, (mvs, convs, resmax, mvmax) = out.result
        mvs = np.asarray(mvs)
        rows[label] = {
            "matvecs_total": int(mvs.sum()),
            "sweeps_per_step_p50": float(np.median(mvs)) / B,
            "sweeps_per_step_max": int(np.max(np.asarray(mvmax))),
            "wall_s": round(out.wall_s, 4),
            "steps_per_s": round(steps / out.wall_s, 2),
            "all_converged": bool(np.all(np.asarray(convs))),
            "residual_max": float(np.max(np.asarray(resmax))),
        }
        print(label, json.dumps(rows[label]), flush=True)

    row = {
        "B": B, "n": n, "steps": steps, "drift": DRIFT, "tol": TOL,
        "execution": "whole sequence fused in one jit (lax.scan over "
                     "steps, drift generated on device, carried warm "
                     "start); one dispatch per sequence for BOTH variants",
        "cold": rows["cold"], "warm": rows["warm"],
        "matvec_ratio_cold_over_warm": round(
            rows["cold"]["matvecs_total"]
            / max(rows["warm"]["matvecs_total"], 1), 2),
        "speedup": round(rows["cold"]["wall_s"]
                         / max(rows["warm"]["wall_s"], 1e-9), 2),
        "backend": jax.default_backend(),
    }
    print(json.dumps({k: row[k] for k in
                      ("matvec_ratio_cold_over_warm", "speedup")}))
    OUT.mkdir(exist_ok=True)
    (OUT / "warmstart_sequence.json").write_text(json.dumps(row, indent=1))


if __name__ == "__main__":
    main(*sys.argv[1:])
