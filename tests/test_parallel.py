"""Batched + sharded solving tests on the 8-device virtual CPU mesh."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import ccqppy_jax as cq
from ccqppy_jax.models import BBPGDConfig, MPRGPBBConfig, SPGConfig
from ccqppy_jax.parallel import (make_batch_mesh, make_mesh, solve_batched,
                                 solve_batched_sharded, solve_sharded)
from ccqppy_jax.utils.random_qp import random_qp_batch

CFG = BBPGDConfig(tol=1e-8, max_matvecs=5000)


@pytest.fixture(scope="module")
def batch_problem():
    B, n = 16, 24
    As, bs, xs = random_qp_batch(jax.random.PRNGKey(0), B, n, jnp.float64,
                                 diag_boost=1.0)
    proj = cq.box(-jnp.ones(n, jnp.float64), jnp.ones(n, jnp.float64),
                  jnp.float64)
    return As, bs, xs, proj


def test_vmap_batching_exact(batch_problem):
    """Batched lanes match standalone solves (JAX's while-loop batching
    select-freezes finished lanes).  Tolerance is a few ulps: the batched
    matvec accumulates in a different order than the single GEMV."""
    As, bs, _, proj = batch_problem
    r = solve_batched("bbpgd", As, bs, proj=proj, config=CFG)
    assert bool(jnp.all(r.converged))
    for i in (0, 7, 15):
        r1 = cq.models.bbpgd.solve(As[i], bs[i], proj=proj, config=CFG)
        np.testing.assert_allclose(np.asarray(r.x[i]), np.asarray(r1.x),
                                   rtol=0, atol=1e-12)
        assert abs(int(r.matvecs[i]) - int(r1.matvecs)) <= 2


def test_shard_map_batching_matches_vmap(batch_problem):
    As, bs, _, proj = batch_problem
    mesh = make_batch_mesh()
    r_v = solve_batched("bbpgd", As, bs, proj=proj, config=CFG)
    r_s = solve_batched_sharded("bbpgd", As, bs, mesh, proj=proj, config=CFG)
    np.testing.assert_allclose(np.asarray(r_s.x), np.asarray(r_v.x),
                               rtol=0, atol=0)
    np.testing.assert_array_equal(np.asarray(r_s.matvecs),
                                  np.asarray(r_v.matvecs))


def test_batched_spg_with_keys(batch_problem):
    As, bs, _, proj = batch_problem
    keys = jax.random.split(jax.random.PRNGKey(3), As.shape[0])
    r = solve_batched("spg", As, bs, proj=proj,
                      config=SPGConfig(tol=1e-6, max_matvecs=5000), keys=keys)
    assert bool(jnp.all(r.converged))


@pytest.mark.parametrize("solver", ["bbpgd", "mprgp_bb", "pgd", "apgd_ar"])
def test_sharded_huge_qp_matches_single_device(solver):
    """Row-sharded solve over the 8-device mesh reproduces the single-device
    trajectory exactly (same matvec count, same solution)."""
    n = 64
    As, bs, _ = random_qp_batch(jax.random.PRNGKey(1), 1, n, jnp.float64,
                                diag_boost=1.0)
    A, b = As[0], bs[0]
    proj = cq.box(-jnp.ones(n, jnp.float64), jnp.ones(n, jnp.float64),
                  jnp.float64)
    mesh = make_mesh(axis="model")
    cfg_cls = cq.models.SOLVERS[solver][1]
    kwargs = {"tol": 1e-8, "max_matvecs": 5000}
    if solver == "pgd":
        kwargs["step_size"] = 1e-4
    cfg = cfg_cls(**kwargs)
    r_sh = solve_sharded(solver, A, b, mesh, proj=proj, config=cfg)
    r_1d = cq.models.SOLVERS[solver][0](A, b, proj=proj, config=cfg)
    assert bool(r_sh.converged) == bool(r_1d.converged)
    np.testing.assert_allclose(np.asarray(r_sh.x), np.asarray(r_1d.x),
                               atol=1e-9)
    if solver in ("bbpgd", "pgd", "mprgp_bb"):
        assert abs(int(r_sh.matvecs) - int(r_1d.matvecs)) <= 1
    else:
        # APGD's Lipschitz backtracking branches on knife-edge float
        # comparisons; psum reduction-order noise can flip a trial, so only
        # the rough cost must agree.
        assert int(r_sh.matvecs) <= 2 * int(r_1d.matvecs)


def test_graft_entry():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    xs = out[0]
    assert xs.shape == args[0].shape[:1] + (args[0].shape[-1],)
    ge.dryrun_multichip(8)


def test_fused_compact_matches_plain(batch_problem):
    """Single-dispatch straggler compaction (parallel/batch.py
    solve_batched_fused_compact): same convergence semantics as the plain
    batched solve — every lane converged, honest residuals, matvec counts
    accumulated across phases."""
    from ccqppy_jax.parallel import solve_batched_fused_compact
    As, bs, _, proj = batch_problem
    r_plain = solve_batched("bbpgd", As, bs, proj=proj, config=CFG)
    mv = np.asarray(r_plain.matvecs)
    p1 = int(np.median(mv))          # force genuine stragglers into phase 2
    r = solve_batched_fused_compact("bbpgd", As, bs, p1, proj=proj,
                                    config=CFG, bucket=8)
    assert bool(jnp.all(r.converged))
    np.testing.assert_allclose(np.asarray(r.x), np.asarray(r_plain.x),
                               atol=1e-6)
    # Lanes that finished inside phase 1 are bit-identical to plain.
    done_in_p1 = mv < p1
    assert done_in_p1.any()
    np.testing.assert_allclose(np.asarray(r.x)[done_in_p1],
                               np.asarray(r_plain.x)[done_in_p1],
                               rtol=0, atol=0)


def test_fused_compact_bucket_overflow_host_fallback(batch_problem):
    """More stragglers than the bucket: host fallback finishes the overflow
    lanes (converged flags stay honest either way)."""
    from ccqppy_jax.parallel import solve_batched_fused_compact
    As, bs, _, proj = batch_problem
    r = solve_batched_fused_compact("bbpgd", As, bs, 3, proj=proj,
                                    config=CFG, bucket=2, host_fallback=True)
    assert bool(jnp.all(r.converged))
    r_no = solve_batched_fused_compact("bbpgd", As, bs, 3, proj=proj,
                                       config=CFG, bucket=2,
                                       host_fallback=False)
    conv = np.asarray(r_no.converged)
    res = np.asarray(r_no.residual)
    assert (res[conv] < CFG.tol * 1.001).all()


def test_compact_budget_honest_and_trace_scatter(batch_problem):
    """Two-phase compaction respects the per-lane matvec budget (phase 2 gets
    exactly what phase 1 left) and re-solved lanes report their phase-2
    residual trace, so the trace tail agrees with the final residual."""
    import dataclasses

    from ccqppy_jax.parallel import solve_batched_compact
    As, bs, _, proj = batch_problem
    cfg = dataclasses.replace(CFG, trace_len=512)
    r_plain = solve_batched("bbpgd", As, bs, proj=proj, config=cfg)
    p1 = int(np.median(np.asarray(r_plain.matvecs)))
    r = solve_batched_compact("bbpgd", As, bs, p1, proj=proj, config=cfg)
    assert bool(jnp.all(r.converged))
    assert (np.asarray(r.matvecs) <= cfg.max_matvecs).all()
    # Trace tail of every lane must match its reported final residual: the
    # last finite trace entry is the residual the loop exited on.
    traces = np.asarray(r.trace)
    res = np.asarray(r.residual)
    for i in range(traces.shape[0]):
        finite = traces[i][np.isfinite(traces[i])]
        if finite.size:
            np.testing.assert_allclose(finite[-1], res[i], rtol=1e-6)


def test_compact_rejects_budgetless_phase2(batch_problem):
    from ccqppy_jax.parallel import (solve_batched_compact,
                                     solve_batched_fused_compact)
    As, bs, _, proj = batch_problem
    with pytest.raises(ValueError, match="phase1_matvecs"):
        solve_batched_compact("bbpgd", As, bs, CFG.max_matvecs, proj=proj,
                              config=CFG)
    with pytest.raises(ValueError, match="phase1_matvecs"):
        solve_batched_fused_compact("bbpgd", As, bs, CFG.max_matvecs,
                                    proj=proj, config=CFG)


def test_fused_compact_budget_honest(batch_problem):
    from ccqppy_jax.parallel import solve_batched_fused_compact
    As, bs, _, proj = batch_problem
    r = solve_batched_fused_compact("bbpgd", As, bs, 3, proj=proj,
                                    config=CFG, bucket=2, host_fallback=True)
    assert (np.asarray(r.matvecs) <= CFG.max_matvecs).all()


@pytest.mark.parametrize("solver", ["bbpgd", "mprgp_bb", "pcg"])
def test_sharded_blocksparse_matches_single_device(solver):
    """Row-sharded block-sparse solve (the BASELINE n=1M configuration at
    test scale) matches the single-device BlockSparseOperator solve."""
    import scipy.sparse as sp

    from ccqppy_jax.models import SOLVERS
    from ccqppy_jax.ops.linop import BlockSparseOperator
    from ccqppy_jax.parallel import solve_sharded_blocksparse

    bs_, nb = 4, 16                       # 16 block rows over 8 devices
    n = bs_ * nb
    rng = np.random.default_rng(11)
    D = rng.standard_normal((n, n)) * 0.1
    A = np.zeros((n, n))
    for i in range(nb):
        for j in range(max(0, i - 1), min(nb, i + 2)):
            A[i*bs_:(i+1)*bs_, j*bs_:(j+1)*bs_] = \
                D[i*bs_:(i+1)*bs_, j*bs_:(j+1)*bs_]
    A = 0.5 * (A + A.T) + 2.0 * np.eye(n)
    x_exact = rng.uniform(-0.5, 0.5, n)
    b = jnp.asarray(-A @ x_exact)
    proj = cq.box(-jnp.ones(n, jnp.float64), jnp.ones(n, jnp.float64),
                  jnp.float64)
    cfg = SOLVERS[solver][1](tol=1e-10, max_matvecs=5000)

    op = BlockSparseOperator.from_scipy_bsr(
        sp.bsr_matrix(A, blocksize=(bs_, bs_)), dtype=jnp.float64)
    fn = SOLVERS[solver][0]
    r_single = fn(op, b, proj=proj, config=cfg)

    mesh = make_mesh()
    r_sharded = solve_sharded_blocksparse(solver, op.blocks, op.cols, b,
                                          mesh, proj=proj, config=cfg)
    assert bool(r_sharded.converged)
    np.testing.assert_allclose(np.asarray(r_sharded.x),
                               np.asarray(r_single.x), atol=1e-9)
    np.testing.assert_allclose(np.asarray(r_sharded.x), x_exact, atol=1e-6)
    assert abs(int(r_sharded.matvecs) - int(r_single.matvecs)) <= 2


def test_fused_compact_spg_keys(batch_problem):
    """SPG (the one RNG-carrying solver) works through the fused compaction
    path: per-lane keys thread into phase 1, straggler lanes restart phase 2
    on a fold_in-derived independent stream, and the host fallback path
    threads keys the same way."""
    from ccqppy_jax.parallel import solve_batched_fused_compact
    As, bs, _, proj = batch_problem
    cfg = SPGConfig(tol=1e-6, max_matvecs=5000)
    keys = jax.random.split(jax.random.PRNGKey(3), As.shape[0])
    r_plain = solve_batched("spg", As, bs, proj=proj, config=cfg, keys=keys)
    mv = np.asarray(r_plain.matvecs)
    p1 = int(np.median(mv))          # force genuine stragglers into phase 2
    r = solve_batched_fused_compact("spg", As, bs, p1, proj=proj, config=cfg,
                                    bucket=8, keys=keys)
    assert bool(jnp.all(r.converged))
    res = np.asarray(r.residual)
    # Lanes that finished inside phase 1 are bit-identical to plain (same
    # key stream); re-solved lanes converge on their own stream.
    done_in_p1 = mv < p1
    assert done_in_p1.any() and (~done_in_p1).any()
    np.testing.assert_allclose(np.asarray(r.x)[done_in_p1],
                               np.asarray(r_plain.x)[done_in_p1],
                               rtol=0, atol=0)
    # Overflow -> host fallback leg with keys (bucket smaller than stragglers).
    n_bad = int((~done_in_p1).sum())
    if n_bad > 2:
        r_of = solve_batched_fused_compact("spg", As, bs, p1, proj=proj,
                                           config=cfg, bucket=2,
                                           host_fallback=True, keys=keys)
        assert bool(jnp.all(r_of.converged))


def test_sharded_jacobi_pcg_diagonal_contract():
    """Jacobi-preconditioned PCG through the row-sharded path: the sharded
    ``diagonal()`` (contiguous-equal-row-block contract, ops/linop.py)
    feeds the preconditioner and the distributed solve matches the
    single-device Jacobi solve exactly."""
    from ccqppy_jax.models import PCGConfig
    n = 64
    rng = np.random.default_rng(21)
    # Strongly heterogeneous diagonal so Jacobi genuinely changes the
    # trajectory (a wrong diagonal would show up as a different matvec count
    # or solution).
    d = jnp.asarray(10.0 ** rng.uniform(-1.5, 1.5, n), jnp.float64)
    G = rng.standard_normal((n, n))
    A = jnp.asarray(G @ G.T + np.eye(n) * 1.0, jnp.float64)
    A = A + jnp.diag(d) * n
    b = jnp.asarray(-np.asarray(A) @ rng.uniform(-1, 1, n), jnp.float64)
    proj = cq.box(-jnp.ones(n, jnp.float64), jnp.ones(n, jnp.float64),
                  jnp.float64)
    cfg = PCGConfig(tol=1e-9, max_matvecs=5000, precond="jacobi")
    mesh = make_mesh(axis="model")
    r_sh = solve_sharded("pcg", A, b, mesh, proj=proj, config=cfg)
    r_1d = cq.models.pcg.solve(A, b, proj=proj, config=cfg)
    assert bool(r_sh.converged) and bool(r_1d.converged)
    np.testing.assert_allclose(np.asarray(r_sh.x), np.asarray(r_1d.x),
                               atol=1e-9)
    assert abs(int(r_sh.matvecs) - int(r_1d.matvecs)) <= 1
    # Jacobi actually engaged: cheaper than the unpreconditioned solve.
    r_no = cq.models.pcg.solve(A, b, proj=proj,
                               config=PCGConfig(tol=1e-9, max_matvecs=5000))
    assert int(r_1d.matvecs) < int(r_no.matvecs)


def test_scenario_parallel_program_has_no_collectives(batch_problem):
    """The dp (scenario) axis is collective-free BY CONSTRUCTION, and the
    compiled program proves it: the optimized HLO of a batch-sharded solve
    contains no cross-device communication op.  This is the load-bearing
    fact behind the weak-scaling story (docs/distributed.md): per-device
    efficiency on real hardware is governed only by lane-convergence skew,
    never by communication."""
    As, bs, _, proj = batch_problem
    mesh = make_batch_mesh()
    lowered = jax.jit(
        lambda A, b: solve_batched_sharded("pcg", A, b, mesh, proj=proj,
                                           config=cq.models.PCGConfig(
                                               tol=1e-8, max_matvecs=500))
    ).lower(As, bs)
    hlo = lowered.compile().as_text()
    for op in ("all-reduce", "all-gather", "collective-permute",
               "all-to-all", "reduce-scatter"):
        assert op not in hlo, f"unexpected collective {op} in dp program"


def test_dryrun_multichip_16_devices():
    """Mesh-factorization coverage beyond the driver's n=8: a 16-virtual-
    device dry run must factor to a 2x8 (batch x model) hybrid mesh and
    converge all three legs (dp ensemble, tp row-sharded dense, tp
    block-sparse).  Runs in a subprocess with its own CPU device count,
    because the in-process backend is pinned to 8 virtual devices by
    conftest."""
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__ as g; g.dryrun_multichip(16)"],
        cwd=repo, capture_output=True, text=True, timeout=600,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=16"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    assert "dryrun_multichip OK" in out, out
    assert "{'batch': 2, 'model': 8}" in out, out
    # all three legs converged: dp reports count/B, tp legs report bools
    assert "converged=4/4" in out and out.count("converged=True") == 2, out


@pytest.mark.parametrize("n_devices,want_shape", [
    (12, {"batch": 3, "model": 4}),    # asymmetric, non-power-of-two
    (32, {"batch": 4, "model": 8}),    # beyond the driver's 8/16 coverage
])
def test_dryrun_multichip_asymmetric_and_32(n_devices, want_shape):
    """Mesh-factorization hardening (VERDICT r4 stretch): the dry run's
    factor logic must build non-degenerate (batch, model) meshes for
    non-power-of-two and larger device counts, and all three legs must
    converge.  Subprocess for the same backend-pinning reason as the
    16-device test."""
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-c",
         f"import __graft_entry__ as g; g.dryrun_multichip({n_devices})"],
        cwd=repo, capture_output=True, text=True, timeout=900,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS":
             f"--xla_force_host_platform_device_count={n_devices}"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout
    assert "dryrun_multichip OK" in out, out
    assert str(want_shape) in out, out
    B = 2 * want_shape["batch"]
    assert f"converged={B}/{B}" in out and out.count("converged=True") == 2, out


def test_direct_serving_shards_over_batch_axis():
    """The round-5 direct-factorization serving mode composes with scenario
    sharding: the projected-inverse warm start and the verified-PCG finish
    both shard over the batch axis of a mesh (collective-free — each device
    serves its own ensemble shard), which is how the serving pipeline spans
    several devices."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as PSpec

    import ccqppy_jax as cq
    from ccqppy_jax.models import PCGConfig
    from ccqppy_jax.models.base import pg_residual
    from ccqppy_jax.models.direct import direct_x0, spd_inverse_batch
    from ccqppy_jax.ops.linop import DenseOperator
    from ccqppy_jax.parallel import make_batch_mesh, solve_batched_sharded
    from ccqppy_jax.utils.random_qp import random_qp_batch

    mesh = make_batch_mesh()
    ndev = len(jax.devices())
    B, n, tol = 2 * ndev, 32, 1e-8
    As, bs, _ = random_qp_batch(jax.random.PRNGKey(3), B, n, jnp.float64,
                                diag_boost=1.0)
    proj = cq.box(-jnp.ones(n, jnp.float64), jnp.ones(n, jnp.float64),
                  jnp.float64)
    Ainv = spd_inverse_batch(As, chunk=4)

    sh = NamedSharding(mesh, PSpec("batch"))
    As_s = jax.device_put(As, sh)
    bs_s = jax.device_put(bs, sh)
    Ainv_s = jax.device_put(Ainv, sh)
    x0 = direct_x0(Ainv_s, bs_s, proj)     # shards with its operands

    cfg = PCGConfig(tol=tol, max_matvecs=500)
    r = solve_batched_sharded("pcg", As_s, bs_s, mesh, x0=x0, proj=proj,
                              config=cfg)
    assert bool(jnp.all(r.converged))
    # result actually sharded over the batch axis
    starts = {s.index[0].start for s in r.x.addressable_shards}
    assert len(starts) == ndev
    audit = jax.vmap(lambda A, b, x: pg_residual(
        proj, x, DenseOperator(A).matvec(x) + b, 1e-6, DenseOperator(A)))(
        As, bs, r.x)
    assert float(jnp.max(audit)) <= tol * 1.02
    # the warm start does its job: interior-dominated lanes finish in the
    # init/verify sweeps
    assert float(jnp.median(r.matvecs)) <= 4
