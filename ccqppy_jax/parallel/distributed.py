"""Multi-host bootstrap + network-aware meshes for multi-host solves.

The reference has no distributed layer at all (pure single-process numpy —
SURVEY.md section 2.8); the equivalent here is JAX's multi-controller
runtime: every host runs the same program, ``jax.distributed.initialize``
wires the hosts into one cluster, and XLA collectives ride the fast
intra-host interconnect ("ici": NVLink between the GPUs of one host) and
the data-center network ("dcn") across hosts.  This module owns the three
pieces solvers need:

* ``init_distributed()``    — idempotent ``jax.distributed.initialize``
  wrapper.  Pass the coordinator address, process count and process id
  explicitly or via the standard env vars.  A CPU
  cluster additionally needs the gloo collectives backend, which this
  selects automatically — that is what the 2-process CPU test runs on
  (tests/test_distributed.py).
* ``make_hybrid_mesh()``    — a (dcn x ici) 2-D mesh: the OUTER axis spans
  processes over DCN, the INNER axis spans each process's local devices
  over ICI.  The solver mapping puts scenario batching (collective-free —
  every device solves its own problems) on the DCN axis and operator/tensor
  parallelism (one all-gather per iteration) on the ICI axis, so no
  iteration-critical collective ever crosses DCN.  This is the
  scaling-book recipe: pick the mesh so the fast axis carries the traffic.
* ``scaling_probe()``       — iterations/s at 1..N devices on the live
  backend (used by benchmarks/benchmark_scaling.py; the north-star target
  is >= 85% scaling from 1 device to 2 hosts).

Multi-host paths are tested on multi-process CPU (gloo collectives) and the
8-device virtual CPU mesh; on GPU hosts only the platform and the
collective transport change.
"""
from __future__ import annotations

import os

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

_INITIALIZED = False


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, local_device_ids=None,
                     cpu_collectives="gloo"):
    """Idempotent ``jax.distributed.initialize`` for multi-host runs.

    Call BEFORE any other jax call on every host, with
    ``coordinator_address`` ("ip:port"), ``num_processes`` and
    ``process_id``, or export the standard JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID env vars.

    On CPU backends the gloo cross-process collectives implementation is
    selected (XLA's default CPU client has no cross-process transport).
    Single-process usage is a no-op beyond initialize(), so library code
    can call this unconditionally.

    Returns (process_index, process_count).
    """
    global _INITIALIZED
    if not _INITIALIZED:
        want_cpu = (os.environ.get("JAX_PLATFORMS", "").startswith("cpu")
                    or getattr(jax.config, "jax_platforms", None) == "cpu")
        if want_cpu and cpu_collectives:
            jax.config.update("jax_cpu_collectives_implementation",
                              cpu_collectives)
        kwargs = {}
        if coordinator_address is not None:
            kwargs["coordinator_address"] = coordinator_address
        if num_processes is not None:
            kwargs["num_processes"] = int(num_processes)
        if process_id is not None:
            kwargs["process_id"] = int(process_id)
        if local_device_ids is not None:
            kwargs["local_device_ids"] = local_device_ids
        jax.distributed.initialize(**kwargs)
        _INITIALIZED = True
    return jax.process_index(), jax.process_count()


def make_hybrid_mesh(dcn_axis="batch", ici_axis="model", ici_size=None):
    """2-D (dcn, ici) device mesh spanning all processes.

    The outer ``dcn_axis`` has one group per process (size = process_count);
    the inner ``ici_axis`` spans each process's local devices.  Shard the
    scenario batch over ``dcn_axis`` (collective-free) and row-shard huge
    QPs over ``ici_axis`` (the per-iteration all-gather stays on ICI).

    Single-process: a plain 2-D mesh over local devices with the requested
    ``ici_size`` (default: all local devices on the ici axis, dcn size 1).
    """
    nproc = jax.process_count()
    local = jax.local_device_count()
    if nproc > 1:
        from jax.experimental import mesh_utils
        # process_is_granule: the outer axis spans PROCESSES (one granule
        # per host) — matches CPU and GPU clusters; the ICI axis spans
        # each process's local devices.
        devices = mesh_utils.create_hybrid_device_mesh(
            mesh_shape=(1, local), dcn_mesh_shape=(nproc, 1),
            devices=jax.devices(), process_is_granule=True)
        return Mesh(devices, (dcn_axis, ici_axis))
    ici = local if ici_size is None else int(ici_size)
    if local % ici:
        raise ValueError(f"ici_size={ici} must divide {local} local devices")
    devices = np.array(jax.devices()).reshape(local // ici, ici)
    return Mesh(devices, (dcn_axis, ici_axis))


def scaling_probe(n_devices_list=None, batch_per_device=64, n=256,
                  solver="pcg", tol=1e-5, max_matvecs=400, reps=3,
                  dtype=jnp.float32, peak_bytes_per_s=None):
    """Measure scenario-parallel solver iterations/s at 1..N devices.

    For each device count k, solves ``k * batch_per_device`` independent
    n-dim box QPs sharded over a k-device mesh (weak scaling — fixed work
    per device) and reports iterations/s plus parallel efficiency vs the
    FIRST measured device count (``efficiency_vs_first`` — pass a list
    starting at 1 for a true 1-device baseline).  Ideal scenario scaling is
    linear: the per-lane while_loops are collective-free; efficiency loss
    comes only from lane-convergence skew and dispatch overheads.

    Each row also carries the skew decomposition: the SPMD program runs one
    fused while_loop, so every device spins until the globally slowest lane
    converges; ``occupancy`` = (sum of per-lane iterations) / (total lanes *
    global max iterations) is the fraction of lane-slots doing useful work,
    and ``skew_wall_factor`` = global-max iters / this row's own p50 —
    the extreme-value growth that makes weak-scaling efficiency fall at
    small per-device batches (more devices -> more lanes -> a farther tail).
    Straggler compaction (``solve_batched_fused_compact``) or bigger
    per-device work amortizes it — see docs/distributed.md.
    ``peak_bytes_per_s`` is the roofline guard's peak (default: the
    device's entry in ``utils.benchmark.PEAK_HBM_BYTES_PER_S``).  Returns a
    list of dicts.
    """
    import ccqppy_jax as cq
    from ccqppy_jax.models import SOLVERS
    from ccqppy_jax.parallel.batch import solve_batched_sharded
    from ccqppy_jax.utils.random_qp import random_qp_batch

    if n_devices_list is None:
        total = len(jax.devices())
        n_devices_list = [k for k in (1, 2, 4, 8, 16, 32) if k <= total]
    cfg = SOLVERS[solver][1](tol=tol, max_matvecs=max_matvecs)
    proj = cq.box(-jnp.ones(n, dtype), jnp.ones(n, dtype), dtype)

    from ccqppy_jax.utils.benchmark import timed_run

    rows = []
    base = None
    for k in n_devices_list:
        mesh = Mesh(np.array(jax.devices()[:k]), ("batch",))
        B = k * batch_per_device
        As, bs, _ = random_qp_batch(jax.random.PRNGKey(0), B, n, dtype,
                                    diag_boost=1.0)

        def run():
            return solve_batched_sharded(solver, As, bs, mesh, axis="batch",
                                         proj=proj, config=cfg)

        # Warm run establishes the per-lane matvec counts, which set a
        # conservative roofline floor for the guarded measurement (half the
        # known operator traffic): the round-3 lesson — hand-rolled
        # ``min(_timed(...))`` over a ``block_until_ready`` fence is exactly
        # the pattern that produced a 320x-inflated wall (VERDICT r3).
        r = run()
        mv_total = int(np.asarray(r.matvecs).sum())
        implied = 0.5 * mv_total * n * n * np.dtype(np.float32).itemsize
        out = timed_run(run, reps=reps, implied_bytes=implied,
                        peak_bytes_per_s=peak_bytes_per_s)
        t = out.wall_s
        r = out.result
        it_arr = np.asarray(r.iterations)
        iters = int(it_arr.sum())
        gmax = int(it_arr.max())
        row = {
            "devices": k, "batch": B, "n": n,
            "iterations_per_s": iters / t,
            "solves_per_s": B / t,
            "converged": float(np.asarray(r.converged).mean()),
            "wall_s": t,
            # Skew decomposition (see docstring): all devices spin to the
            # globally slowest lane.
            "max_iterations": gmax,
            "median_iterations": float(np.median(it_arr)),
            "occupancy": iters / (B * gmax) if gmax else 1.0,
            "skew_wall_factor": gmax / max(float(np.median(it_arr)), 1.0),
        }
        if base is None:
            base = row["iterations_per_s"] / k
        row["efficiency_vs_first"] = row["iterations_per_s"] / (k * base)
        rows.append(row)
    return rows
