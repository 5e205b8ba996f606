"""Drop-in compat API tests: reference-style classes over the JAX core.

Mirrors the reference's own test suite
(``CCQPpy/tests/test_module.py``) through our compat layer — the
same class names, ctor signatures, ``solve() -> self`` protocol, and
``solution_*`` properties.
"""
import numpy as np
import pytest

from ccqppy_jax import compat


def _tridiag():
    A = np.array([[2.0, -1.0, 0.0], [-1.0, 2.0, -1.0], [0.0, -1.0, 2.0]])
    x_exact = np.array([1.0, 0.0, 1.0])
    return A, -A @ x_exact, x_exact


def test_identity_proj_op():
    """Reference TestSolutionSpaces.test_identity (test_module.py:10-15)."""
    op = compat.IdentityProjOp(10)
    x = np.random.default_rng(0).uniform(-5, 5, 10)
    np.testing.assert_allclose(op(x), x)
    assert op.embedded_dimension == 10
    assert op.name == "Identity"


ALL_SOLVERS = [
    lambda: compat.CCQPSolverPGD(1e-8, 10000, 0.1),
    lambda: compat.CCQPSolverAPGD(1e-8, 10000),
    lambda: compat.CCQPSolverAPGDAntiRelaxation(1e-8, 10000),
    lambda: compat.CCQPSolverBBPGD(1e-8, 10000),
    lambda: compat.CCQPSolverBBPGDf(1e-8, 10000),
    lambda: compat.CCQPSolverSPG(1e-8, 10000),
    lambda: compat.CCQPSolverMPRGP(1e-8, 10000),
    lambda: compat.CCQPSolverMPRGPBB(1e-8, 10000),
]


@pytest.mark.parametrize("make_solver", ALL_SOLVERS)
def test_solvers_against_simple_problems(make_solver):
    """Reference TestSolversAgainstSimpleProblems (test_module.py:18-73):
    every solver on box problems converges to the exact solution; plus the
    result-property protocol round-trips."""
    A, b, x_exact = _tridiag()
    cases = [
        compat.IdentityProjOp(3),
        compat.BoxProjOp(3, np.zeros(3), 2 * np.ones(3)),
        compat.DisjointProjOp(compat.IdentityProjOp(1), compat.IdentityProjOp(1),
                              compat.IdentityProjOp(1)),
    ]
    for proj in cases:
        solver = make_solver()
        out = solver.solve(A, b, convex_proj_op=proj)
        assert out is solver
        assert solver.solution_converged
        np.testing.assert_allclose(solver.solution, x_exact, atol=1e-5)
        assert solver.solution_num_matrix_vector_multiplications < 10000
        assert solver.solution_time >= 0
        assert isinstance(solver.solution_residual, float)


def test_disjoint_proj_op_heterogeneous():
    op = compat.DisjointProjOp(
        compat.BoxProjOp(2, -np.ones(2), np.ones(2)),
        compat.SphereProjOp(3, 1.0),
        compat.ConeProjOp(3, 1.0),
    )
    assert op.embedded_dimension == 8
    x = np.array([2.0, -3.0, 1.0, 1.0, 1.0, 3.0, 0.0, 0.5])
    y = op(x)
    np.testing.assert_allclose(y[:2], [1.0, -1.0])
    assert np.linalg.norm(y[2:5]) <= 1.0 + 1e-9
    assert np.linalg.norm(y[5:7]) <= y[7] + 1e-9


def test_projected_gradient_protocol():
    op = compat.LowerBoundProjOp(3, np.zeros(3))
    free, chopped = op.projected_gradient(np.array([0.0, 1.0, 0.0]),
                                          np.array([2.0, 1.0, -3.0]))
    np.testing.assert_allclose(free, [0.0, 1.0, 0.0])
    np.testing.assert_allclose(chopped, [0.0, 0.0, -3.0])


def test_spg_seedable():
    A, b, x_exact = _tridiag()
    s1 = compat.CCQPSolverSPG(1e-8, 10000, spg_key=5).solve(A, b)
    s2 = compat.CCQPSolverSPG(1e-8, 10000, spg_key=5).solve(A, b)
    np.testing.assert_array_equal(s1.solution, s2.solution)


def test_plot_smoke(tmp_path):
    """ProjOpBase.plot parity (solution_spaces.py:48-74) — renders without
    a display via Agg."""
    import matplotlib
    matplotlib.use("Agg")
    op = compat.BoxProjOp(3, -np.ones(3), np.ones(3))
    ax = op.plot(50, -2 * np.ones(3), 2 * np.ones(3))
    assert ax is not None


def test_dtype_resolved_at_call_time():
    """Enabling/disabling x64 AFTER importing compat must be honored: the
    drop-in layer resolves its dtype per call, not at import (round-4
    advisor: a frozen module constant silently gave f32 solves to users who
    flipped the flag post-import; the reference's own tests run f64 at tol
    1e-8, CCQPpy/tests/test_module.py:18-73)."""
    import jax

    A, b, _ = _tridiag()
    assert jax.config.jax_enable_x64  # conftest default
    try:
        jax.config.update("jax_enable_x64", False)
        s32 = compat.CCQPSolverBBPGD(1e-5, 1000).solve(A, b)
        assert np.asarray(s32.solution).dtype == np.float32
        op32 = compat.BoxProjOp(3)
        assert np.asarray(op32.core.lb).dtype == np.float32
    finally:
        jax.config.update("jax_enable_x64", True)
    s64 = compat.CCQPSolverBBPGD(1e-10, 1000).solve(A, b)
    assert np.asarray(s64.solution).dtype == np.float64
    assert s64.solution_residual < 1e-10
