"""chip_smoke.py off the card: it refuses to run without a GPU, and its
plain float64 Eq.25 audit agrees with the package's ``pg_residual``."""
import importlib.util
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

import ccqppy_jax as cq
from ccqppy_jax.models.base import pg_residual

REPO = pathlib.Path(__file__).resolve().parent.parent


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(script, cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_smoke_exits_nonzero_without_gpu():
    proc = _run(REPO / "chip_smoke.py", REPO)
    assert proc.returncode != 0
    assert "no GPU" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_smoke_alone_exits_nonzero(tmp_path):
    """Copied out of the repo, the script cannot import the package."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    proc = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _problem(n, seed):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, n))
    A = G @ G.T + n * np.eye(n)
    b = -A @ rng.uniform(-1.5, 1.5, n)
    return A, b, rng


@pytest.mark.parametrize("kind", ["box", "cone"])
def test_audit_matches_pg_residual(kind):
    """On feasible points (solver iterates and random projected points) the
    smoke's numpy Eq.25 residual equals the package's closed form."""
    smoke = _smoke()
    n = 30
    A, b, rng = _problem(n, 2 if kind == "box" else 3)
    if kind == "box":
        proj = cq.box(-jnp.ones(n), jnp.ones(n), jnp.float64)
    else:
        proj = cq.blockwise(cq.lorentz_cone(1.0, dtype=jnp.float64), 3)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    points = [np.asarray(proj.project(jnp.asarray(rng.standard_normal(n))))
              for _ in range(3)]
    for budget in (4, 12):
        r = cq.models.mprgp.solve_bb(
            Aj, bj, proj=proj,
            config=cq.models.MPRGPBBConfig(tol=1e-14, max_matvecs=budget))
        points.append(np.asarray(r.x))
    for x in points:
        res, xa = smoke.eq25_residual(A[None], b[None], x[None], kind)
        np.testing.assert_allclose(xa[0], x, atol=1e-12)
        want = float(pg_residual(proj, jnp.asarray(x),
                                 Aj @ jnp.asarray(x) + bj, smoke.GD))
        assert want > 1e-8
        # Boxes: the closed form is exact up to the literal quotient's f64
        # cancellation (eps |x| / GD per coordinate).  Cones: the literal
        # quotient at GD = 1e-6 differs from the package's gd -> 0 limit
        # by O(GD |g_tangential|^2 / radius) where the surface curves —
        # large at random points, negligible near a solution.
        np.testing.assert_allclose(res[0], want,
                                   rtol=1e-7 if kind == "box" else 1e-3)


@pytest.mark.parametrize("kind", ["box", "cone"])
def test_checked_residual_rejects_points_off_the_set(kind):
    """A solver iterate passes the feasibility check; the same iterate
    pushed 1e-4 off the set fails it, although the audit's projection
    would hide the offset from the residual."""
    smoke = _smoke()
    n = 30
    A, b, _ = _problem(n, 5)
    if kind == "box":
        proj = cq.box(-jnp.ones(n), jnp.ones(n), jnp.float64)
    else:
        proj = cq.blockwise(cq.lorentz_cone(1.0, dtype=jnp.float64), 3)
    x = np.asarray(cq.models.mprgp.solve_bb(
        jnp.asarray(A), jnp.asarray(b), proj=proj,
        config=cq.models.MPRGPBBConfig(tol=1e-12, max_matvecs=2000)).x)
    _, xa, share = smoke.checked_residual("ok", A[None], b[None], x[None],
                                          kind)
    assert share <= 1.0
    # Push every coordinate outward: past the box bound, or along the
    # cone's u part so ||u|| exceeds z.
    push = np.sign(x) if kind == "box" else np.tile([1.0, 1.0, -1.0], n // 3)
    bad = np.clip(x, -1, 1) + 1e-4 * push if kind == "box" else x + 1e-4 * push
    with pytest.raises(AssertionError, match="off the set"):
        smoke.checked_residual("bad", A[None], b[None], bad[None], kind)


def test_solution_bound_covers_true_error():
    """The residual bound 3n res / lambda_min covers the distance of an
    early iterate to the solution."""
    smoke = _smoke()
    n = 24
    A, b, _ = _problem(n, 4)
    proj = cq.box(-jnp.ones(n), jnp.ones(n), jnp.float64)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    x_star = np.asarray(cq.models.pcg.solve(
        Aj, bj, proj=proj,
        config=cq.models.PCGConfig(tol=1e-13, max_matvecs=2000)).x)
    x = np.asarray(cq.models.pgd.solve(
        Aj, bj, proj=proj,
        config=cq.models.PGDConfig(tol=1e-14, max_matvecs=6)).x)
    res, xa = smoke.eq25_residual(A[None], b[None], x[None], "box")
    bound, cond = smoke.solution_bound(A[None], res, xa, x[None])
    err = np.linalg.norm(x - x_star)
    assert 1e-6 < err <= bound[0]
    assert 1.0 < cond[0] < 10.0
