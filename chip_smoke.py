"""Smoke test of the solver's main path on an NVIDIA GPU.

    python chip_smoke.py                # one card: phases 1-8 below
    python chip_smoke.py --four-cards   # four cards: the sharded paths only

One card.  Each phase prints one line; any failure exits non-zero.

1. device: JAX's first device must be a GPU (there is no CPU fallback);
   prints its kind and the card's name and power limit (nvidia-smi).
2. quick start: the README's SPG example and the compat ``CCQPSolverSPG``
   on the 3x3 problem solve to [1, 0, 1].
3. iterative: B=2048 n=1000 box-QP ensemble, fused-compaction PCG with the
   Jacobi x0 at tol 2e-5, exactly as ``bench.py`` drives it.
4. direct: B=1024 batched Cholesky inverse, direct x0, verified PCG
   (``bench.py``'s serving phase); the inverse is checked against scipy.
5. cone: B=1024 n=999 Lorentz-cone ensemble, ``apgd_sc`` over
   ``SpectralDense`` and fused-compaction ``mprgp_bb``.
6. gemv: batched GEMV at HIGHEST and DEFAULT against f64, and their times.
7. memory: peak device memory per phase and the compiled iterative
   program's memory analysis.
8. gpu tests: the ``gpu``-marked tests, run in this process.

Every solve phase checks that sampled lanes lie on the set and audits them
against a plain float64 reference written here (``eq25_residual``, numpy
only) and against the package's own solve of the same lanes on the host
CPU in float64 at tol 1e-10.  One-card phases keep their arrays on JAX's
first device alone.

Four cards.  The row-sharded n=1M block-tridiagonal PCG solve, the
row-sharded n=9996 Lorentz-cone MPRGP-BB solve and the batch-sharded
B=2048 ensemble, each against the same problem solved on one card.

Timings are for information; each is printed with the card's name and
power limit.  The last line of output is one JSON object.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

GD = 1e-6              # Eq.25 probe step (Mazhar 2015; the reference's)
N_LANES = 16           # lanes audited per solve phase
REF_TOL = 1e-10        # tol of the float64 CPU reference solves


# ------------------------------------------------------------ f64 reference
def box_project(x, lb=-1.0, ub=1.0):
    return np.clip(x, lb, ub)


def cone_project(x, mu=1.0):
    """Projection onto the product of 3-dim Lorentz cones
    {(u, z) : ||u|| <= mu z} over consecutive blocks, z last."""
    xb = x.reshape(x.shape[:-1] + (-1, 3))
    u, z = xb[..., :-1], xb[..., -1]
    un = np.linalg.norm(u, axis=-1)
    t = (mu * un + z) / (mu * mu + 1.0)
    scale = np.divide(t * mu, un, out=np.zeros_like(un), where=un > 0)
    inside = un <= mu * z
    polar = mu * un <= -z
    pu = np.where(inside[..., None], u,
                  np.where(polar[..., None], 0.0, scale[..., None] * u))
    pz = np.where(inside, z, np.where(polar, 0.0, t))
    return np.concatenate([pu, pz[..., None]], axis=-1).reshape(x.shape)


def cone_snap(x, mu=1.0):
    """Put blocks whose cone slack passes numpy's default ``isclose`` test
    (the reference's active-set test) exactly onto the cone surface.

    A float32 iterate on the surface sits off it by its rounding, and the
    literal Eq.25 quotient divides that offset by GD: a 1e-7 offset alone
    would read as a 0.1 residual component.  Snapping first removes that
    artefact; the distance moved is counted in the solution bound."""
    xb = x.reshape(x.shape[:-1] + (-1, 3)).copy()
    u, z = xb[..., :-1], xb[..., -1]
    un = np.linalg.norm(u, axis=-1)
    on = np.isclose(un, mu * z)
    apex = on & (np.abs(z) <= 1e-8)
    surf = on & ~apex & (un > 0)
    u[surf] *= (mu * z[surf] / un[surf])[:, None]
    xb[apex] = 0.0
    return xb.reshape(x.shape)


def eq25_residual(A, b, x, kind):
    """Mazhar-2015 Eq.25 residual ||x - P(x - GD g)|| / (3 n GD), g = A x + b,
    in float64 numpy, for stacked lanes A (k, n, n), b and x (k, n).

    ``kind`` is ``"box"`` ([-1, 1]^n) or ``"cone"`` (3-dim Lorentz cones,
    mu = 1).  The residual is taken at the audited point ``xa``: the f64
    projection of ``x`` onto the set (cone blocks snapped by ``cone_snap``).
    Returns ``(residual (k,), xa (k, n))``."""
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    x = np.asarray(x, np.float64)
    project = box_project if kind == "box" else cone_project
    xa = project(x)
    if kind == "cone":
        xa = cone_snap(xa)
    g = np.einsum("kij,kj->ki", A, xa) + b
    r = xa - project(xa - GD * g)
    return np.linalg.norm(r, axis=-1) / (3.0 * x.shape[-1] * GD), xa


def feasibility_gap(x, xa, kind):
    """How far returned lanes x (k, n) lie off the set: max |x - xa| per lane
    against what rounding allows.  Boxes: 8 float32 ulps of max(|x|, 1) (a
    clip is exact; a step onto a bound rounds once).  Cones: the ``isclose``
    tolerance ``cone_snap`` uses, 1e-8 + 1e-5 |x|.  Returns
    ``(gap (k,), allowed (k,))``."""
    x = np.asarray(x, np.float64)
    gap = np.max(np.abs(x - xa), axis=-1)
    size = np.max(np.abs(x), axis=-1)
    if kind == "box":
        allowed = 8 * np.finfo(np.float32).eps * np.maximum(size, 1.0)
    else:
        allowed = 1e-8 + 1e-5 * size
    return gap, allowed


def checked_residual(name, A, b, x, kind):
    """``eq25_residual`` of lanes that must be feasible: fails if any lane is
    further off the set than ``feasibility_gap`` allows.  Returns
    ``(residual (k,), xa (k, n), largest gap as a share of its allowance)``."""
    res, xa = eq25_residual(A, b, x, kind)
    gap, allowed = feasibility_gap(x, xa, kind)
    share = float(np.max(gap / allowed))
    assert share <= 1.0, f"{name}: a lane lies {gap.max():.3e} off the set"
    return res, xa, share


def solution_bound(A, res, xa, x, spectrum=None):
    """Bound on ||x - x*||_2 for lanes A (k, n, n) from an Eq.25 residual.

    For f with eigenvalues in [mu, L] and t = GD <= 2 / (L + mu), the map
    x -> P(x - t g(x)) contracts by (1 - t mu) around x*, so
    ||xa - x*|| <= ||xa - P(xa - t g)|| / (t mu) = 3 n res / mu; the
    distance from the returned x to the audited xa is added.  ``spectrum``
    = (mu, L) bounds per lane; default: the exact f64 eigenvalues."""
    if spectrum is None:
        ev = np.linalg.eigvalsh(np.asarray(A, np.float64))
        spectrum = ev[:, 0], ev[:, -1]
    mu, L = spectrum
    assert np.all(mu > 0) and np.all(GD * (L + mu) <= 2.0)
    n = A.shape[-1]
    return 3.0 * n * res / mu + np.linalg.norm(
        np.asarray(x, np.float64) - xa, axis=-1), L / mu


# ----------------------------------------------------------------- helpers
class Smoke:
    """Phase bookkeeping: one printed line per phase, card label on every
    timing, peak device memory after every phase."""

    def __init__(self, device):
        self.device = device
        self.label = "; ".join(device["card"])
        self.peaks = []

    def say(self, phase, text):
        print(f"[{phase}] {text}", flush=True)

    def timing(self, name, seconds):
        return f"{name} {seconds * 1e3:.1f} ms ({self.label})"

    def peak(self, phase):
        import jax
        stats = jax.devices()[0].memory_stats() or {}
        self.peaks.append((phase, stats.get("peak_bytes_in_use")))


def sample_lanes(batch, seed):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(batch, size=N_LANES, replace=False))


def host(x):
    import jax
    return np.asarray(jax.device_get(x))


def cpu_reference(solver, A, b, kind, config_cls):
    """The package's own solve of the sampled lanes on the host CPU in
    float64 at REF_TOL: returns x (k, n)."""
    import jax
    import jax.numpy as jnp

    import ccqppy_jax as cq
    from ccqppy_jax.parallel import solve_batched

    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        n = A.shape[-1]
        A_c = jnp.asarray(A, jnp.float64)
        b_c = jnp.asarray(b, jnp.float64)
        if kind == "box":
            proj = cq.box(-jnp.ones(n, jnp.float64), jnp.ones(n, jnp.float64),
                          jnp.float64)
        else:
            proj = cq.blockwise(cq.lorentz_cone(1.0, dtype=jnp.float64), 3)
        r = solve_batched(solver, A_c, b_c, proj=proj,
                          config=config_cls(tol=REF_TOL))
        conv = np.asarray(r.converged)
        assert conv.all(), f"CPU f64 reference: {int((~conv).sum())} lanes " \
                           "did not converge"
        return np.asarray(r.x)


def on_first_card(name, *arrays):
    """One-card phases keep their arrays on JAX's first device only."""
    import jax
    for a in arrays:
        assert a.devices() == {jax.devices()[0]}, \
            f"{name}: array on {a.devices()}, not on {jax.devices()[0]} alone"


def audit(smoke, phase, name, As, bs, r, tol, kind, ref_solver, ref_cfg_cls,
          seed):
    """All lanes converged on the first card; sampled lanes lie on the set
    and their f64 Eq.25 residual is <= tol; and ||x_gpu - x_ref||_inf is
    within the bound both residuals give."""
    on_first_card(name, As, bs, r.x, r.converged)
    conv = host(r.converged)
    assert conv.all(), f"{name}: {int((~conv).sum())}/{conv.size} lanes " \
                       "did not converge"
    lanes = sample_lanes(conv.size, seed)
    A = host(As[lanes])
    b = host(bs[lanes])
    x = host(r.x[lanes])
    res, xa, gap = checked_residual(name, A, b, x, kind)
    assert res.max() <= tol, f"{name}: f64 Eq.25 residual {res.max():.3e} " \
                             f"> tol {tol:g}"
    x_ref = cpu_reference(ref_solver, A, b, kind, ref_cfg_cls)
    res_ref, xa_ref, _ = checked_residual(name + " (CPU reference)", A, b,
                                          x_ref, kind)
    bound_gpu, cond = solution_bound(A, res, xa, x)
    bound_ref, _ = solution_bound(A, res_ref, xa_ref, x_ref)
    err = np.max(np.abs(x - x_ref), axis=-1)
    ratio = err / (bound_gpu + bound_ref)
    assert ratio.max() <= 1.0, f"{name}: |x_gpu - x_ref|_inf {err.max():.3e} " \
                               "exceeds its residual bound"
    mv = host(r.matvecs)
    smoke.say(phase, f"{name}: {conv.size}/{conv.size} converged, matvecs "
                     f"p50 {np.median(mv):.0f} max {mv.max()}; f64 Eq.25 "
                     f"residual on {len(lanes)} lanes max {res.max():.3e} "
                     f"<= tol {tol:g}; off the set by at most {gap:.3f} of "
                     f"the rounding allowance; |x_gpu - x_ref|_inf max "
                     f"{err.max():.3e}, at most {ratio.max():.3f} of the "
                     f"bound 3n(res_gpu + res_ref)/lambda_min (cond(A) <= "
                     f"{cond.max():.2f})")
    return lanes


def timed(fn, *args, reps=3):
    """Min wall of ``reps`` calls of ``fn(*args)``, each closed by
    ``block_until_ready`` (information only)."""
    import jax
    jax.block_until_ready(fn(*args))
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        walls.append(time.perf_counter() - t0)
    return min(walls)


# ------------------------------------------------------------ one card
def phase_quickstart(smoke):
    import jax.numpy as jnp

    import ccqppy_jax as cq
    from ccqppy_jax.compat import BoxProjOp, CCQPSolverSPG

    want = np.array([1.0, 0.0, 1.0])
    A = jnp.array([[2., -1., 0.], [-1., 2., -1.], [0., -1., 2.]])
    b = -A @ jnp.array([1., 0., 1.])
    proj = cq.box([-2., -2., -4.], [2., 2., 5.])
    r = cq.models.spg.solve(A, b, proj=proj,
                            config=cq.models.SPGConfig(tol=1e-6,
                                                       max_matvecs=5000))
    err = np.max(np.abs(host(r.x) - want))
    assert bool(r.converged) and err < 1e-4, (host(r.x), bool(r.converged))
    solver = CCQPSolverSPG(1e-6, 5000)
    solver.solve(A, b, convex_proj_op=BoxProjOp(3, [-2., -2., -4.],
                                               [2., 2., 5.]))
    err_c = np.max(np.abs(np.asarray(solver.solution) - want))
    assert solver.solution_converged and err_c < 1e-4, solver.solution
    smoke.say(2, f"quick start: SPG x={np.round(host(r.x), 6).tolist()} "
                 f"({int(r.matvecs)} matvecs), compat CCQPSolverSPG "
                 f"x={np.round(np.asarray(solver.solution), 6).tolist()}; "
                 f"both within {max(err, err_c):.1e} of [1, 0, 1]")


def phase_iterative(smoke, batch=2048, n=1000, tol=2e-5, budget=500,
                    phase1=17, bucket=256):
    import jax
    import jax.numpy as jnp

    import ccqppy_jax as cq
    from ccqppy_jax.models import PCGConfig
    from ccqppy_jax.parallel import (prepare_dense_batch,
                                     solve_batched_fused_compact)
    from ccqppy_jax.utils.random_qp import random_qp_batch

    As, bs, _ = random_qp_batch(jax.random.PRNGKey(0), batch, n, jnp.float32,
                                diag_boost=1.0, chunk=256)
    As = prepare_dense_batch(As)
    proj = cq.box(-jnp.ones(n, jnp.float32), jnp.ones(n, jnp.float32))
    cfg = PCGConfig(tol=tol, max_matvecs=budget)
    jacobi_x0 = jax.jit(
        lambda A, b: jnp.clip(-b / jnp.diagonal(A, axis1=-2, axis2=-1),
                              -1.0, 1.0))

    def run(As_, b_):
        return solve_batched_fused_compact(
            "pcg", As_, b_, phase1, x0=jacobi_x0(As_, b_), proj=proj,
            config=cfg, bucket=bucket, host_fallback=False)

    r = run(As, bs)
    lanes = audit(smoke, 3, f"iterative pcg B={batch} n={n}", As, bs, r, tol,
                  "box", "pcg", PCGConfig, seed=3)
    wall = timed(run, As, bs)
    compiled = jax.jit(run).lower(As, bs).compile()
    mem = compiled.memory_analysis()
    smoke.say(3, "iterative timing (information): "
                 + smoke.timing(f"{batch} solves", wall))
    smoke.peak(3)
    return As, mem, lanes


def phase_direct(smoke, batch=1024, n=1000, tol=2e-5, budget=500,
                 chunk=128):
    import scipy.linalg as sl

    import jax
    import jax.numpy as jnp

    import ccqppy_jax as cq
    from ccqppy_jax.models import PCGConfig
    from ccqppy_jax.models.direct import direct_x0, spd_inverse_batch
    from ccqppy_jax.parallel import (prepare_dense_batch,
                                     solve_batched_fused_compact)
    from ccqppy_jax.utils.random_qp import random_qp_batch

    As, bs, _ = random_qp_batch(jax.random.PRNGKey(1), batch, n, jnp.float32,
                                diag_boost=1.0, chunk=256)
    As = prepare_dense_batch(As)
    proj = cq.box(-jnp.ones(n, jnp.float32), jnp.ones(n, jnp.float32))
    cfg = PCGConfig(tol=tol, max_matvecs=budget)

    t0 = time.perf_counter()
    Ainv = spd_inverse_batch(As, chunk=chunk)
    Ainv.block_until_ready()
    prep_s = time.perf_counter() - t0

    # Inverse against scipy's f64 cho_solve.  An f32 Cholesky inverse has
    # forward error ~ cond(A) sqrt(n) eps_f32 in Frobenius norm; allow 5x.
    lanes = sample_lanes(batch, 4)
    A64 = host(As[lanes]).astype(np.float64)
    Ainv_g = host(Ainv[lanes]).astype(np.float64)
    eye = np.eye(n)
    worst = 0.0
    for i in range(len(lanes)):
        X = sl.cho_solve(sl.cho_factor(A64[i]), eye)
        ev = np.linalg.eigvalsh(A64[i])
        bound = 5.0 * (ev[-1] / ev[0]) * np.sqrt(n) * np.finfo(np.float32).eps
        rel = np.linalg.norm(Ainv_g[i] - X) / np.linalg.norm(X)
        assert rel <= bound, f"lane {lanes[i]}: inverse rel. error {rel:.3e}" \
                             f" > {bound:.3e}"
        worst = max(worst, rel / bound)

    def run(b_):
        return solve_batched_fused_compact(
            "pcg", As, b_, 3, x0=direct_x0(Ainv, b_, proj), proj=proj,
            config=cfg, bucket=64, host_fallback=False)

    r = run(bs)
    smoke.say(4, f"direct: spd_inverse_batch B={batch} n={n} vs scipy f64 "
                 f"cho_solve on {len(lanes)} lanes: Frobenius rel. error at "
                 f"most {worst:.3f} of 5 cond(A) sqrt(n) eps_f32; "
                 + smoke.timing("prep (information)", prep_s))
    audit(smoke, 4, f"direct serving B={batch} n={n}", As, bs, r, tol, "box",
          "pcg", PCGConfig, seed=4)
    wall = timed(run, bs)
    smoke.say(4, "direct timing (information): "
                 + smoke.timing(f"{batch} solves", wall))
    smoke.peak(4)


def phase_cone(smoke, batch=1024, n=999, tol=1e-5, budget=2000, phase1=43,
               bucket=256):
    import jax
    import jax.numpy as jnp

    from ccqppy_jax.models import APGDSCConfig, MPRGPBBConfig
    from ccqppy_jax.ops import projections as P
    from ccqppy_jax.ops.linop import SpectralDense, estimate_spectral_bounds
    from ccqppy_jax.parallel import (prepare_dense_batch, solve_batched,
                                     solve_batched_fused_compact)
    from ccqppy_jax.utils.random_qp import random_qp_batch

    As, bs, _ = random_qp_batch(jax.random.PRNGKey(0), batch, n, jnp.float32,
                                diag_boost=1.0, chunk=256)
    As = prepare_dense_batch(As)
    proj = P.blockwise(P.lorentz_cone(1.0), 3)
    x0 = jax.jit(lambda A, b: jax.vmap(proj.project)(
        -b / jnp.diagonal(A, axis1=-2, axis2=-1)))(As, bs)

    L, mu = estimate_spectral_bounds(As, iters=32)
    sop = SpectralDense(As, L, mu)
    r_sc = solve_batched("apgd_sc", sop, bs, x0=x0, proj=proj,
                         config=APGDSCConfig(tol=tol, max_matvecs=budget))
    audit(smoke, 5, f"cone apgd_sc B={batch} n={n}", As, bs, r_sc, tol,
          "cone", "mprgp_bb", MPRGPBBConfig, seed=5)
    r_mp = solve_batched_fused_compact(
        "mprgp_bb", As, bs, phase1, x0=x0, proj=proj,
        config=MPRGPBBConfig(tol=tol, max_matvecs=budget, fused=True),
        bucket=bucket, host_fallback=False)
    audit(smoke, 5, f"cone mprgp_bb B={batch} n={n}", As, bs, r_mp, tol,
          "cone", "mprgp_bb", MPRGPBBConfig, seed=6)
    smoke.peak(5)


def phase_gemv(smoke, As, lanes):
    """HIGHEST and DEFAULT batched GEMV against f64 numpy; their times."""
    import jax
    import jax.numpy as jnp

    from ccqppy_jax.ops.linop import DenseOperator, FastDense

    batch, n, _ = As.shape
    x = jax.random.uniform(jax.random.PRNGKey(7), (batch, n), jnp.float32,
                           -1.0, 1.0)
    hi = jax.jit(jax.vmap(lambda A, v: DenseOperator(A).matvec(v)))
    lo = jax.jit(jax.vmap(lambda A, v: FastDense(A).matvec(v)))
    A64 = host(As[lanes]).astype(np.float64)
    y64 = np.einsum("kij,kj->ki", A64, host(x[lanes]).astype(np.float64))
    scale = np.max(np.abs(y64))
    y_hi, y_lo = hi(As, x), lo(As, x)
    on_first_card("gemv", As, y_hi, y_lo)
    err_hi = np.max(np.abs(host(y_hi[lanes]) - y64)) / scale
    err_lo = np.max(np.abs(host(y_lo[lanes]) - y64)) / scale
    assert err_hi <= 1e-5, f"HIGHEST GEMV max rel. error {err_hi:.3e}"
    # A matrix-matrix product at DEFAULT shows whether the card multiplies
    # f32 in TF32 where it can use its tensor cores.
    X = jax.random.uniform(jax.random.PRNGKey(8), (n, 64), jnp.float32,
                           -1.0, 1.0)
    ref = A64[0] @ host(X).astype(np.float64)
    gemm = host(jax.jit(jnp.dot)(As[lanes[0]], X)).astype(np.float64)
    err_mm = np.max(np.abs(gemm - ref)) / np.max(np.abs(ref))
    sweep = batch * n * n * As.dtype.itemsize
    from ccqppy_jax.utils.benchmark import peak_hbm_bytes_per_s
    peak = peak_hbm_bytes_per_s(smoke.device["kind"])
    parts = []
    for name, fn in (("HIGHEST", hi), ("DEFAULT", lo)):
        w = timed(fn, As, x, reps=10)
        parts.append(f"{name} {w * 1e3:.3f} ms/sweep = "
                     f"{sweep / w / 1e9:.0f} GB/s ({sweep / w / peak:.1%} of "
                     f"{peak / 1e12:.2f} TB/s)")
    w_copy = timed(jax.jit(lambda a: a * 2.0), As, reps=5)
    parts.append(f"copy {2 * sweep / w_copy / 1e9:.0f} GB/s")
    kind = lambda e: "TF32-grade" if e > 1e-5 else "f32-grade"
    smoke.say(6, f"gemv B={batch} n={n}: max rel. error vs f64 HIGHEST "
                 f"{err_hi:.2e}, DEFAULT {err_lo:.2e} ({kind(err_lo)}); "
                 f"DEFAULT GEMM n x 64 {err_mm:.2e} ({kind(err_mm)}); "
                 f"times (information, {smoke.label}): " + "; ".join(parts))
    smoke.peak(6)


def phase_memory(smoke, mem, iter_bytes):
    peaks = ", ".join(f"phase {p}: {b / 2**30:.2f} GiB" for p, b in smoke.peaks
                      if b is not None)
    temp = mem.temp_size_in_bytes
    relayout = temp >= 0.9 * iter_bytes
    smoke.say(7, f"memory: peak_bytes_in_use {peaks}; compiled iterative "
                 f"program: arguments {mem.argument_size_in_bytes / 2**30:.2f}"
                 f" GiB, outputs {mem.output_size_in_bytes / 2**20:.1f} MiB, "
                 f"temp {temp / 2**30:.3f} GiB "
                 f"({'a' if relayout else 'no'} relayout copy of the "
                 f"{iter_bytes / 2**30:.2f} GiB Hessian stack)")


def phase_gpu_tests(smoke):
    import pytest

    class Count:
        def __init__(self):
            self.outcomes = {}

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.outcomes[report.nodeid] = report.outcome

    # tests/conftest.py forces the CPU only when JAX_PLATFORMS is unset.
    os.environ["JAX_PLATFORMS"] = "gpu"
    here = os.path.dirname(os.path.abspath(__file__))
    count = Count()
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu",
                      os.path.join(here, "tests", "test_gpu.py")],
                     plugins=[count])
    passed = sorted(k for k, v in count.outcomes.items() if v == "passed")
    other = {k: v for k, v in count.outcomes.items() if v != "passed"}
    assert rc == 0 and passed and not other, (rc, other)
    smoke.say(8, f"gpu tests: {len(passed)} passed, none skipped or failed")


def one_card(smoke):
    phase_quickstart(smoke)
    smoke.peak(2)
    As, mem, lanes = phase_iterative(smoke)
    phase_direct(smoke)
    phase_cone(smoke)
    phase_gemv(smoke, As, lanes)
    phase_memory(smoke, mem, As.size * As.dtype.itemsize)
    del As
    phase_gpu_tests(smoke)


# ----------------------------------------------------------- four cards
def four_cards(smoke, n_huge=1_000_000, n_cone=9996, batch=2048, n=1000,
               ell_tol=1e-9, n_perm=4):
    """The sharded paths over a 4-device mesh, each against one card.

    ``ell_tol`` is the ELL solve's Eq.25 tol: the residual normalizes by
    3n, so 1e-9 at n=1M asks for what 1e-5 asks at n=3k."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as PSpec

    import ccqppy_jax as cq
    from ccqppy_jax.models import SOLVERS, MPRGPBBConfig, PCGConfig
    from ccqppy_jax.ops import projections as P
    from ccqppy_jax.parallel import (make_batch_mesh, make_mesh,
                                     solve_batched, solve_batched_sharded,
                                     solve_sharded,
                                     solve_sharded_blocksparse)
    from ccqppy_jax.utils.random_qp import (block_tridiag_qp, random_qp,
                                            random_qp_batch)

    devs = jax.devices()[:4]

    def spread(arr):
        ids = {s.device.id for s in arr.addressable_shards}
        assert ids == {d.id for d in devs}, f"shards on devices {ids}"
        return len(ids)

    # --- one huge block-sparse QP, rows sharded over 4 cards -------------
    mesh = make_mesh(4, axis="model")
    op, b, x_exact = block_tridiag_qp(n_huge, seed=0)
    proj = cq.box(-jnp.ones(n_huge, jnp.float32),
                  jnp.ones(n_huge, jnp.float32))
    cfg = PCGConfig(tol=ell_tol, max_matvecs=10_000)
    r1 = SOLVERS["pcg"][0](op, b, proj=proj, config=cfg)
    r4 = solve_sharded_blocksparse("pcg", op.blocks, op.cols, b, mesh,
                                   axis="model", proj=proj, config=cfg)
    assert bool(r1.converged) and bool(r4.converged)
    ndev = spread(r4.x)
    # Both converge to x_exact (interior of the box).  PCG is CG here;
    # psum order perturbs iterates at f32 rounding, which CG amplifies by
    # at most cond(A) ~ 1e2: allow 1e-4 absolute on |x| <= 0.5.
    x1, x4 = host(r1.x), host(r4.x)
    for x in (x1, x4):
        gap, allowed = feasibility_gap(x[None], np.clip(x, -1, 1)[None], "box")
        assert gap[0] <= allowed[0], f"ELL PCG: x off the box by {gap[0]:.3e}"
    dx = float(np.max(np.abs(x4 - x1)))
    assert dx <= 1e-4, f"sharded ELL PCG differs from one card by {dx:.3e}"
    assert int(r4.matvecs) <= 2 * int(r1.matvecs)
    smoke.say("4x", f"ELL PCG n={n_huge} over {ndev} cards: converged, "
                    f"{int(r4.matvecs)} matvecs (one card {int(r1.matvecs)})"
                    f", |x_4 - x_1|_inf {dx:.2e} <= 1e-4")
    del op, b, x_exact, r1, r4

    # --- one dense Lorentz-cone QP, rows sharded over 4 cards ------------
    # At n=9996 in f32 the rounding noise of the Eq.25 residual is about
    # tol, so MPRGP-BB's matvec count on ONE card already depends on
    # summation order: permuting the cone blocks (an exactly equivalent
    # problem) or changing one entry of b by one ulp moves it several-fold
    # (PERF.md).  The four-card count is therefore held to the psum-order
    # slack of tests/test_parallel.py (2x) around the range one card shows
    # over ``n_perm`` block permutations.  In f64 that noise is ~1e-16 and
    # the counts must agree within 1, as tests/test_parallel.py requires.
    solve1 = SOLVERS["mprgp_bb"][0]
    permute = jax.jit(lambda A, b, p: (A[p][:, p], b[p]))
    for dtype in (jnp.float32, jnp.float64):
        with jax.enable_x64(dtype == jnp.float64):
            A, b, _ = random_qp(jax.random.PRNGKey(0), n_cone, dtype,
                                diag_boost=1.0)
            proj = P.blockwise(P.lorentz_cone(1.0, dtype=dtype), 3)
            cfg = MPRGPBBConfig(tol=1e-5, max_matvecs=20_000)
            r1 = solve1(A, b, proj=proj, config=cfg)
            r4 = solve_sharded("mprgp_bb", A, b, mesh, axis="model",
                               proj=proj, config=cfg, proj_sharded=False)
            ndev = spread(r4.x)
            mv1, mv4 = int(r1.matvecs), int(r4.matvecs)
            envelope = [mv1]
            rng = np.random.default_rng(0)
            for _ in range(n_perm if dtype == jnp.float32 else 0):
                blk = rng.permutation(n_cone // 3)
                p = jnp.asarray((3 * blk[:, None] + np.arange(3)).ravel())
                rp = solve1(*permute(A, b, p), proj=proj, config=cfg)
                assert bool(rp.converged)
                envelope.append(int(rp.matvecs))
            A64, b64 = host(A)[None], host(b)[None]
            x1, x4 = host(r1.x)[None], host(r4.x)[None]
        name = f"dense cone MPRGP-BB n={n_cone} {jnp.dtype(dtype).name}"
        res1, xa1, _ = checked_residual(name, A64, b64, x1, "cone")
        res4, xa4, gap = checked_residual(name, A64, b64, x4, "cone")
        # A = G G^T + n I: lambda_min >= n (Weyl); lambda_max <= ||A||_inf.
        spectrum = (np.array([float(n_cone)]),
                    np.abs(A64[0]).sum(axis=1).max(keepdims=True))
        bound = (solution_bound(A64, res1, xa1, x1, spectrum)[0]
                 + solution_bound(A64, res4, xa4, x4, spectrum)[0])[0]
        dx = float(np.max(np.abs(x4 - x1)))
        lo, hi = min(envelope), max(envelope)
        perms = (f"; over {len(envelope) - 1} block permutations "
                 f"{sorted(envelope[1:])}" if len(envelope) > 1 else "")
        smoke.say("4x", f"{name} over {ndev} cards: {mv4} matvecs (one "
                        f"card {mv1}{perms}), f64 Eq.25 "
                        f"residual {res4[0]:.2e} (one card {res1[0]:.2e}), "
                        f"off the set by {gap:.3f} of the allowance, "
                        f"|x_4 - x_1|_inf {dx:.2e} (bound {bound:.2e})")
        assert bool(r1.converged) and bool(r4.converged)
        assert max(res1[0], res4[0]) <= cfg.tol and dx <= bound
        if dtype == jnp.float64:
            assert abs(mv4 - mv1) <= 1, (mv4, mv1)
        else:
            assert lo <= 2 * mv4 and mv4 <= 2 * hi, (mv4, envelope)
        del A, b, r1, r4

    # --- the B=2048 ensemble, batch sharded over 4 cards -----------------
    As, bs, _ = random_qp_batch(jax.random.PRNGKey(0), batch, n, jnp.float32,
                                diag_boost=1.0, chunk=256)
    proj = cq.box(-jnp.ones(n, jnp.float32), jnp.ones(n, jnp.float32))
    cfg = PCGConfig(tol=2e-5, max_matvecs=500)
    r1 = solve_batched("pcg", As, bs, proj=proj, config=cfg)
    bmesh = make_batch_mesh(4, axis="batch")
    shard = NamedSharding(bmesh, PSpec("batch"))
    As4 = jax.device_put(As, shard)
    bs4 = jax.device_put(bs, shard)
    r4 = solve_batched_sharded("pcg", As4, bs4, bmesh, axis="batch",
                               proj=proj, config=cfg)
    ndev = spread(r4.x)
    conv1, conv4 = host(r1.converged), host(r4.converged)
    mv1, mv4 = host(r1.matvecs), host(r4.matvecs)
    lanes = sample_lanes(batch, 8)
    A_s, b_s = host(As[lanes]), host(bs[lanes])
    x1, x4 = host(r1.x[lanes]), host(r4.x[lanes])
    name = f"batch-sharded PCG B={batch} n={n}"
    res1, xa1, _ = checked_residual(name, A_s, b_s, x1, "box")
    res4, xa4, gap = checked_residual(name, A_s, b_s, x4, "box")
    bound = (solution_bound(A_s, res1, xa1, x1)[0]
             + solution_bound(A_s, res4, xa4, x4)[0])
    dx = np.max(np.abs(x4 - x1), axis=-1)
    smoke.say("4x", f"{name} over {ndev} cards: "
                    f"{int(conv4.sum())}/{batch} converged (one card "
                    f"{int(conv1.sum())}), matvecs p50 "
                    f"{np.median(mv4):.0f} (one card {np.median(mv1):.0f}), "
                    f"{int(np.sum(mv4 != mv1))} lanes differ in count; on "
                    f"{len(lanes)} lanes f64 Eq.25 residual max "
                    f"{res4.max():.2e}, off the set by {gap:.3f} of the "
                    f"allowance, |x_4 - x_1|_inf max {dx.max():.2e}, "
                    f"at most {np.max(dx / bound):.3f} of the bound")
    assert conv1.all() and conv4.all()
    assert np.all(mv4 <= 2 * mv1) and np.all(mv1 <= 2 * mv4)
    assert max(res1.max(), res4.max()) <= cfg.tol and np.all(dx <= bound)


# ------------------------------------------------------------------ main
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, over four cards")
    args = ap.parse_args(argv)

    import jax

    from ccqppy_jax.utils.benchmark import card_info, use_compile_cache

    cache = use_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX's first device is "
                 f"{dev.platform!r}); there is no CPU fallback")
    want = 4 if args.four_cards else 1
    if len(jax.devices()) < want:
        sys.exit(f"chip_smoke: needs {want} GPUs, found {len(jax.devices())}")
    device = card_info()
    smoke = Smoke(device)
    for line in device["card"]:
        print(line, flush=True)
    smoke.say(1, f"device: platform {dev.platform}, kind {dev.device_kind}, "
                 f"{len(jax.devices())} visible; card {smoke.label}; "
                 f"compile cache {cache}")
    if args.four_cards:
        four_cards(smoke)
    else:
        one_card(smoke)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": want}}))


if __name__ == "__main__":
    main()
