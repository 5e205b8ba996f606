"""Tests for the mixed-precision ensemble pipeline and its building blocks.

Covers the extensions with no reference counterpart:
``Projection.binding_mask`` (ops/projections.py), the low-precision
``CastDense`` operator (ops/linop.py), the ``pcg`` face solver (models/pcg.py),
and ``parallel.solve_batched_mixed`` (parallel/mixed.py).  The reference is a
serial f64 numpy library (SURVEY.md section 6); these paths are design
headroom, so the tests here are semantic (exactness of gradient carry, mask
correctness, true-residual convergence) rather than parity checks.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ccqppy_jax.models import SOLVERS, BBPGDfConfig, PCGConfig
from ccqppy_jax.ops import projections as P
from ccqppy_jax.ops.linop import CastDense, DenseOperator, as_operator
from ccqppy_jax.models.base import pg_residual
from ccqppy_jax.parallel import prepare_dense_batch, solve_batched_mixed
from ccqppy_jax.utils.random_qp import random_qp_batch


# ---------------------------------------------------------------- binding_mask

def test_binding_mask_box_semantics():
    """Free iff strictly inside, or at a bound the gradient releases."""
    lb = -jnp.ones(4, jnp.float64)
    ub = jnp.ones(4, jnp.float64)
    proj = P.box(lb, ub)
    #       interior   at lb, g>0 (binds)   at lb, g<0 (releases)   at ub, g<0 (binds)
    x = jnp.asarray([0.0, -1.0, -1.0, 1.0], jnp.float64)
    g = jnp.asarray([9.0, 1.0, -1.0, -1.0], jnp.float64)
    m = np.asarray(proj.binding_mask(x, g))
    np.testing.assert_array_equal(m, [1.0, 0.0, 1.0, 0.0])


def test_binding_mask_bounds_and_identity():
    x = jnp.asarray([-1.0, 0.0], jnp.float64)
    g = jnp.asarray([1.0, 1.0], jnp.float64)
    lo = P.lower_bound(-jnp.ones(2, jnp.float64))
    np.testing.assert_array_equal(np.asarray(lo.binding_mask(x, g)), [0.0, 1.0])
    up = P.upper_bound(jnp.zeros(2, jnp.float64))
    # x[1]=0 at ub with g>0: descent moves down, bound releases.
    np.testing.assert_array_equal(np.asarray(up.binding_mask(x, g)), [1.0, 1.0])
    np.testing.assert_array_equal(
        np.asarray(up.binding_mask(x, -g)), [1.0, 0.0])
    ident = P.identity()
    np.testing.assert_array_equal(np.asarray(ident.binding_mask(x, g)), [1.0, 1.0])


def test_binding_mask_curved_sets_conservative():
    """Ball/cone fall back to the normal-vector mask: boundary coordinates
    the outward normal touches are frozen (sound, conservative)."""
    ball = P.ball(1.0, dtype=jnp.float64)
    x_on = jnp.asarray([1.0, 0.0], jnp.float64)       # on the sphere
    g = jnp.asarray([1.0, 1.0], jnp.float64)
    m = np.asarray(ball.binding_mask(x_on, g))
    assert m[0] == 0.0                                 # normal has support here
    x_in = jnp.asarray([0.3, 0.0], jnp.float64)        # strictly inside
    np.testing.assert_array_equal(np.asarray(ball.binding_mask(x_in, g)),
                                  [1.0, 1.0])


def test_binding_mask_compositions():
    box = P.box(-jnp.ones(2, jnp.float64), jnp.ones(2, jnp.float64))
    x = jnp.asarray([-1.0, 0.0, -1.0, 0.0], jnp.float64)
    g = jnp.asarray([1.0, 1.0, -1.0, 1.0], jnp.float64)
    expect = [0.0, 1.0, 1.0, 1.0]
    bw = P.blockwise(box, 2)
    np.testing.assert_array_equal(np.asarray(bw.binding_mask(x, g)), expect)
    pp = P.ProductProj.make((box, 2), (box, 2))
    np.testing.assert_array_equal(np.asarray(pp.binding_mask(x, g)), expect)


# ------------------------------------------------------------------- CastDense

def test_cast_dense_matvec_f32_accumulation():
    rng = np.random.default_rng(0)
    A = jnp.asarray(rng.standard_normal((16, 16)), jnp.float32)
    x = jnp.asarray(rng.standard_normal(16), jnp.float32)
    op = CastDense.from_f32(A)
    assert op.A.dtype == jnp.bfloat16
    y = op.matvec(x)
    assert y.dtype == jnp.float32
    y_ref = np.asarray(A, np.float32) @ np.asarray(x, np.float32)
    # bf16 storage error ~2^-8 relative; accumulation is f32.
    np.testing.assert_allclose(np.asarray(y), y_ref,
                               atol=0.05 * np.abs(y_ref).max())
    assert op.diagonal().dtype == jnp.float32
    assert float(op.inf_norm()) > 0


def test_cast_dense_inside_solver():
    """A solver iterating against CastDense converges to the *perturbed*
    problem's solution — the self-reported residual is honest for bf16-A."""
    rng = np.random.default_rng(1)
    G = rng.standard_normal((8, 8))
    A = jnp.asarray(G @ G.T + 8 * np.eye(8), jnp.float32)
    x_exact = jnp.asarray(rng.uniform(-0.5, 0.5, 8), jnp.float32)
    b = -A @ x_exact
    fn, cfg_cls = SOLVERS["bbpgd_f"]
    # tol must sit above the bf16 floor: each matvec quantizes x to bf16
    # (~2^-8 relative), so the achievable residual is operator-error bound.
    r = fn(CastDense.from_f32(A), b, config=cfg_cls(tol=5e-3, max_matvecs=500))
    assert bool(r.converged)
    # Close to the f32 solution within the bf16 operator-error floor.
    assert float(jnp.linalg.norm(r.x - x_exact)) < 0.1 * float(
        jnp.linalg.norm(x_exact)) + 0.05


# ------------------------------------------------------------------------- PCG

def test_pcg_exact_gradient_carry():
    """After any number of iterations, the carried g equals A x + b to fp
    roundoff — the property that makes PCG's convergence check honest."""
    rng = np.random.default_rng(2)
    G = rng.standard_normal((12, 12))
    A = jnp.asarray(G @ G.T + 12 * np.eye(12), jnp.float64)
    x_exact = jnp.asarray(rng.uniform(-2, 2, 12), jnp.float64)
    b = -A @ x_exact
    proj = P.box(-jnp.ones(12, jnp.float64), jnp.ones(12, jnp.float64))
    fn, cfg_cls = SOLVERS["pcg"]
    r = fn(A, b, proj=proj, config=cfg_cls(tol=1e-10, max_matvecs=500))
    assert bool(r.converged)
    g_true = A @ r.x + b
    res_true = pg_residual(proj, r.x, g_true, 1e-6, as_operator(A))
    assert float(res_true) < 1e-9


def test_pcg_active_box_matches_reference_problem():
    """The reference's hardest oracle (ActiveBoxConstrainedSPD,
    problem_suite.py:152-177): box [9,10]^3, solution pinned at [9,9,9]."""
    A = jnp.asarray([[2., -1, 0], [-1, 2, -1], [0, -1, 2]], jnp.float64)
    x_exact = jnp.asarray([1.0, 1.0, 1.0], jnp.float64)
    b = -A @ x_exact
    proj = P.box(9 * jnp.ones(3, jnp.float64), 10 * jnp.ones(3, jnp.float64))
    fn, cfg_cls = SOLVERS["pcg"]
    r = fn(A, b, proj=proj, config=cfg_cls(tol=1e-8, max_matvecs=1000))
    assert bool(r.converged)
    np.testing.assert_allclose(np.asarray(r.x), [9.0, 9.0, 9.0], atol=1e-6)


def test_pcg_unconstrained_is_cg():
    """With the identity set, PCG is plain CG: n-dim SPD solves in <= n+1
    matvecs (Krylov exactness)."""
    rng = np.random.default_rng(3)
    n = 10
    G = rng.standard_normal((n, n))
    A = jnp.asarray(G @ G.T + n * np.eye(n), jnp.float64)
    x_exact = jnp.asarray(rng.uniform(-1, 1, n), jnp.float64)
    b = -A @ x_exact
    fn, cfg_cls = SOLVERS["pcg"]
    r = fn(A, b, config=cfg_cls(tol=1e-10, max_matvecs=200))
    assert bool(r.converged)
    assert int(r.matvecs) <= n + 2
    np.testing.assert_allclose(np.asarray(r.x), np.asarray(x_exact), atol=1e-8)


# ------------------------------------------------------- solve_batched_mixed

def _small_ensemble(B=12, n=24, seed=0):
    As, bs, _ = random_qp_batch(jax.random.PRNGKey(seed), B, n, jnp.float32,
                                diag_boost=1.0)
    proj = P.box(-0.5 * jnp.ones(n, jnp.float32), 0.5 * jnp.ones(n, jnp.float32))
    return As, bs, proj


def _true_residuals(As, bs, xs, proj):
    def one(A, b, x):
        g = jnp.dot(A, x, precision=jax.lax.Precision.HIGHEST) + b
        return pg_residual(proj, x, g, 1e-6, as_operator(A))
    return np.asarray(jax.vmap(one)(As, bs, xs))


@pytest.mark.parametrize("fixup", [True, False])
def test_solve_batched_mixed_true_residual(fixup):
    """Every lane reported converged has a TRUE f32 residual below tol —
    the pipeline's core guarantee (bf16 phase cannot fake convergence)."""
    As, bs, proj = _small_ensemble()
    tol = 1e-5
    cfg = BBPGDfConfig(tol=tol, max_matvecs=800)
    r = solve_batched_mixed(As, bs, proj=proj, config=cfg,
                            phase_a_budget=24, fixup=fixup)
    conv = np.asarray(r.converged)
    res_true = _true_residuals(As, bs, r.x, proj)
    assert res_true[conv].max() < 2 * tol   # fp reorder slack
    if fixup:
        assert conv.all(), "fixup must finish every straggler at this scale"


def test_solve_batched_mixed_counts_both_phases():
    """matvecs aggregates phase A + polish: a run given a larger bf16 phase
    budget reports at least as many matvecs as one whose phase A is capped
    at a single application (phase A may also stop early on its own tol)."""
    As, bs, proj = _small_ensemble(B=4, n=16, seed=1)
    cfg = BBPGDfConfig(tol=1e-5, max_matvecs=600)
    r_tiny = solve_batched_mixed(As, bs, proj=proj, config=cfg,
                                 phase_a_budget=1, fixup=False)
    r = solve_batched_mixed(As, bs, proj=proj, config=cfg,
                            phase_a_budget=16, phase_a_tol=1e-7, fixup=False)
    assert np.asarray(r.matvecs).min() >= 2   # both phases applied A
    assert np.asarray(r.matvecs).sum() > np.asarray(r_tiny.matvecs).sum() - 4 * 16


def test_solve_batched_mixed_warm_start():
    As, bs, proj = _small_ensemble(B=4, n=16, seed=2)
    cfg = BBPGDfConfig(tol=1e-5, max_matvecs=600)
    r1 = solve_batched_mixed(As, bs, proj=proj, config=cfg)
    r2 = solve_batched_mixed(As, bs, proj=proj, config=cfg, x0=r1.x)
    assert np.asarray(r2.converged).all()
    assert np.asarray(r2.matvecs).max() < np.asarray(r1.matvecs).max()


def test_prepare_dense_batch_cpu_passthrough():
    """prepare_dense_batch is a plain device_put plus the optional cast:
    values and the bf16 copy round-trip."""
    rng = np.random.default_rng(4)
    As = jnp.asarray(rng.standard_normal((3, 8, 8)), jnp.float32)
    ref = np.asarray(As)
    out, low = prepare_dense_batch(As, jnp.bfloat16)
    np.testing.assert_array_equal(np.asarray(out), ref)
    assert low.dtype == jnp.bfloat16
    np.testing.assert_allclose(np.asarray(low, np.float32), ref, atol=0.02)


def test_prepare_dense_batch_from_host_array():
    """A host (numpy) stack lands on the device unchanged, same dtype and
    shape; no cast copy unless asked for."""
    import jax
    rng = np.random.default_rng(5)
    As = rng.standard_normal((2, 6, 6)).astype(np.float32)
    out = prepare_dense_batch(As)
    assert isinstance(out, jax.Array)
    assert out.dtype == jnp.float32 and out.shape == As.shape
    np.testing.assert_array_equal(np.asarray(out), As)
    out32, low = prepare_dense_batch(As, jnp.float16)
    assert low.dtype == jnp.float16 and low.shape == As.shape
    np.testing.assert_array_equal(np.asarray(out32), As)


def test_pcg_stall_reports_not_converged():
    """A fully-frozen binding mask (x0 inside the at-bound band with an
    outward gradient) stalls PCG; the stall must report converged=False so
    fixup passes re-solve the lane (was mislabeled converged=True)."""
    n = 4
    A = jnp.eye(n, dtype=jnp.float64)
    b = jnp.ones(n, jnp.float64)
    proj = P.lower_bound(jnp.zeros(n, jnp.float64))
    fn, cfg_cls = SOLVERS["pcg"]
    # x0 within the f64 at-bound band (16*eps ~ 3.5e-15) but far enough from
    # the bound that the Eq.25 probe still reports res ~ x0/gd >> tol.
    x0 = jnp.full(n, 3e-15, jnp.float64)
    r = fn(A, b, x0=x0, proj=proj, config=cfg_cls(tol=1e-12, max_matvecs=100))
    assert bool(r.converged) == (float(r.residual) < 1e-12)
    # The frozen mask means zero progress; the honest flag is what matters.
    if float(r.residual) >= 1e-12:
        assert not bool(r.converged)


def test_pcg_no_false_stall_near_tolerance():
    """Near-convergence gradients have tiny (but nonzero) rr; the stall test
    must not fire there (a 10*eps absolute threshold falsely stalled f64
    solves one iteration short of tol=1e-10)."""
    rng = np.random.default_rng(11)
    n = 64
    G = rng.standard_normal((n, n)) * 0.1
    A = jnp.asarray(0.5 * (G + G.T) + 2 * np.eye(n), jnp.float64)
    x_exact = jnp.asarray(rng.uniform(-0.5, 0.5, n), jnp.float64)
    b = -A @ x_exact
    proj = P.box(-jnp.ones(n, jnp.float64), jnp.ones(n, jnp.float64))
    fn, cfg_cls = SOLVERS["pcg"]
    # tol 1e-11 sits above the fp floor of the gradient recurrence (~2e-12
    # on this matrix scale) but far below where a 10*eps absolute rr
    # threshold falsely stalled.
    r = fn(A, b, proj=proj, config=cfg_cls(tol=1e-11, max_matvecs=5000))
    assert bool(r.converged), float(r.residual)
    assert float(r.residual) < 1e-11


def test_solve_batched_compact_straggler_path():
    """solve_batched_compact's phase-2 path (was: TypeError, missing trace
    field) returns honest accumulated results."""
    from ccqppy_jax.parallel import solve_batched_compact
    As, bs, proj = _small_ensemble(B=6, n=16, seed=3)
    cfg = BBPGDfConfig(tol=5e-5, max_matvecs=800)   # above the f32 floor
    r = solve_batched_compact("bbpgd_f", As, bs, 3, proj=proj, config=cfg)
    assert np.asarray(r.converged).all()
    assert np.asarray(r.matvecs).min() > 3   # both phases counted


# --------------------------------------------- residual-replacement mixed PCG

def _rr_problem(n=64, seed=0):
    from ccqppy_jax.ops.linop import MixedPrecDense
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, n))
    A = jnp.asarray(G @ G.T + n * np.eye(n), jnp.float64)
    b = jnp.asarray(-np.asarray(A) @ rng.uniform(-1, 1, n), jnp.float64)
    proj = P.box(-0.8 * jnp.ones(n, jnp.float64),
                 0.8 * jnp.ones(n, jnp.float64), jnp.float64)
    return A, b, proj, MixedPrecDense.from_f32(A)


@pytest.mark.parametrize("tol", [1e-5, 1e-10])
def test_pcg_rr_converges_below_bf16_floor(tol):
    """Residual-replacement PCG on a MixedPrecDense operator converges
    arbitrarily below the bf16 operator-error floor (~1e-2 normalized), and
    the reported residual is a TRUE full-precision one."""
    A, b, proj, op = _rr_problem()
    cfg = PCGConfig(tol=tol, max_matvecs=2000, refresh_every=16)
    r = SOLVERS["pcg"][0](op, b, proj=proj, config=cfg)
    assert bool(r.converged)
    g = A @ r.x + b
    true = float(pg_residual(proj, r.x, g, 1e-6, DenseOperator(A)))
    assert true < tol * 1.01, true
    assert abs(true - float(r.residual)) <= 1e-12 + 0.05 * true


def test_pcg_rr_matches_plain_solution():
    A, b, proj, op = _rr_problem(seed=3)
    cfg = PCGConfig(tol=1e-9, max_matvecs=2000, refresh_every=16)
    r_rr = SOLVERS["pcg"][0](op, b, proj=proj, config=cfg)
    r_pl = SOLVERS["pcg"][0](A, b, proj=proj,
                             config=PCGConfig(tol=1e-9, max_matvecs=2000))
    assert bool(r_rr.converged) and bool(r_pl.converged)
    np.testing.assert_allclose(np.asarray(r_rr.x), np.asarray(r_pl.x),
                               atol=1e-7)


def test_pcg_rr_single_precision_operator_is_consistent():
    """refresh_every > 0 with a PLAIN operator (matvec_exact == matvec) is
    valid and agrees with the plain path."""
    A, b, proj, _ = _rr_problem(seed=5)
    cfg = PCGConfig(tol=1e-10, max_matvecs=2000, refresh_every=16)
    r = SOLVERS["pcg"][0](A, b, proj=proj, config=cfg)
    r_pl = SOLVERS["pcg"][0](A, b, proj=proj,
                             config=PCGConfig(tol=1e-10, max_matvecs=2000))
    assert bool(r.converged) and bool(r_pl.converged)
    np.testing.assert_allclose(np.asarray(r.x), np.asarray(r_pl.x),
                               atol=1e-9)


def test_pcg_rr_batched():
    """rr-PCG under vmap via solve_batched with a batched MixedPrecDense."""
    from ccqppy_jax.ops.linop import MixedPrecDense
    from ccqppy_jax.parallel import solve_batched
    B, n = 8, 32
    As, bs_, _ = random_qp_batch(jax.random.PRNGKey(2), B, n, jnp.float64,
                                 diag_boost=1.0)
    op = MixedPrecDense(As, As.astype(jnp.bfloat16))
    proj = P.box(-jnp.ones(n, jnp.float64), jnp.ones(n, jnp.float64),
                 jnp.float64)
    cfg = PCGConfig(tol=1e-8, max_matvecs=2000, refresh_every=16)
    r = solve_batched("pcg", op, bs_, proj=proj, config=cfg)
    assert bool(jnp.all(r.converged))
    for i in (0, 5):
        g = As[i] @ r.x[i] + bs_[i]
        true = float(pg_residual(proj, r.x[i], g, 1e-6, DenseOperator(As[i])))
        assert true < 1e-8 * 1.01


def test_pcg_rr_budget_exhaustion_honest():
    A, b, proj, op = _rr_problem(seed=7)
    cfg = PCGConfig(tol=1e-14, max_matvecs=20, refresh_every=8)
    r = SOLVERS["pcg"][0](op, b, proj=proj, config=cfg)
    assert not bool(r.converged)


def test_f64_exact_rung_raw_wishart():
    """The f64-exact rung of the mixed ladder (MixedPrecDense with A f64 /
    A_low f32 + rr-PCG): on the reference's raw-Wishart family (cond up to
    ~1e7 — f32-infeasible, the iterate floors at Eq.25 ~2e-5) the f32-sweep
    refinement must reach tol 1e-5 with TRUE residuals certified by an
    independent f64 recompute.  This is the configuration of
    benchmarks/benchmark_f64_wishart1k.py."""
    import jax
    import numpy as np

    import ccqppy_jax as cq
    from ccqppy_jax.models import PCGConfig
    from ccqppy_jax.models.base import pg_residual
    from ccqppy_jax.models.pcg import solve as pcg_solve
    from ccqppy_jax.ops.linop import DenseOperator, MixedPrecDense
    from ccqppy_jax.utils.random_qp import random_qp_batch

    B, N, tol = 8, 160, 1e-5
    As, bs, _ = random_qp_batch(jax.random.PRNGKey(0), B, N, jnp.float64,
                                diag_boost=0.0)
    As32 = As.astype(jnp.float32)
    proj = cq.box(-jnp.ones(N, jnp.float64), jnp.ones(N, jnp.float64),
                  jnp.float64)
    cfg = PCGConfig(tol=tol, max_matvecs=20000, refresh_every=128,
                    segment_drop=0.25)
    diag = jnp.diagonal(As, axis1=-2, axis2=-1)
    x0 = jnp.clip(-bs / diag, -1.0, 1.0)
    r = jax.vmap(lambda a64, a32, b, x0_: pcg_solve(
        MixedPrecDense(a64, a32), b, x0=x0_, proj=proj, config=cfg))(
        As, As32, bs, x0)
    tres = np.asarray(jax.vmap(
        lambda A, b, x: pg_residual(proj, x, DenseOperator(A).matvec(x) + b,
                                    1e-6, DenseOperator(A)))(As, bs, r.x))
    assert bool(np.all(np.asarray(r.converged)))
    assert tres.max() <= tol * 1.02, f"true residual {tres.max():.3e}"
    # beyond the f32 iterate floor: at least one lane certified below 1e-5
    assert tres.min() < 1e-5


def test_f64_rung_deep_tolerance():
    """VERDICT r4 #5: the f64-exact rung must reach DEEP tolerances
    (<= 1e-9 — the reference's desired_tol story, README.md:55-59) on a
    hard family: each refinement cycle contracts the true residual by
    ~ eps_f32 * cond, so tolerance depth only costs cycles until the
    f64-refresh floor.  Also guards the round-5 regression: a GEMV
    optimization barrier placed between the cheap f32 sweep and its
    f64-cast consumer broke the fusion that keeps the sweep's products
    full-precision (raw-Wishart n=1000 conv 1.0 -> 0.75; see
    MixedPrecDense.matvec)."""
    import jax

    import ccqppy_jax as cq
    from ccqppy_jax.models import PCGConfig
    from ccqppy_jax.models.base import pg_residual
    from ccqppy_jax.ops.linop import DenseOperator, MixedPrecDense
    from ccqppy_jax.utils.random_qp import random_qp_batch

    B, n = 4, 128
    # Raw Wishart, seed chosen for cond in [6e4, 2.4e5] — inside the rung's
    # documented per-cycle contraction regime eps_f32 * cond < 1 (a
    # cond ~1.6e7 draw floors around 3e-8, the documented ~1e7 limit).
    As, bs, _ = random_qp_batch(jax.random.PRNGKey(6), B, n, jnp.float64,
                                diag_boost=0.0)
    As32 = As.astype(jnp.float32)
    proj = cq.box(-jnp.ones(n, jnp.float64), jnp.ones(n, jnp.float64))
    cfg = PCGConfig(tol=1e-9, max_matvecs=30000, refresh_every=128,
                    segment_drop=0.25)
    r = jax.vmap(lambda a64, a32, b: cq.models.pcg.solve(
        MixedPrecDense(a64, a32), b, proj=proj, config=cfg))(As, As32, bs)
    assert bool(jnp.all(r.converged))
    aud = jax.vmap(lambda A, b, x: pg_residual(
        proj, x, DenseOperator(A).matvec(x) + b, 1e-6, DenseOperator(A)))(
        As, bs, r.x)
    assert float(jnp.max(aud)) <= 1e-9 * 1.02
