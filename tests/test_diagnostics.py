"""Residual traces + diagnostics utilities."""
import numpy as np

import jax
import jax.numpy as jnp

import ccqppy_jax as cq
from ccqppy_jax.models import BBPGDConfig, MPRGPConfig
from ccqppy_jax.parallel import solve_batched
from ccqppy_jax.utils import problems
from ccqppy_jax.utils.diagnostics import check_result, timed_solve, trim_trace
from ccqppy_jax.utils.random_qp import random_qp_batch


def test_residual_trace_recorded():
    prob = problems.box_constrained_spd()
    cfg = BBPGDConfig(tol=1e-10, max_matvecs=1000, trace_len=64)
    r = cq.models.bbpgd.solve(prob.A, prob.b, proj=prob.proj, config=cfg)
    hist = trim_trace(r)
    assert len(hist) == int(r.iterations)
    # monotone-ish decrease to below tol at the end
    assert hist[-1] < 1e-10
    assert hist[0] > hist[-1]


def test_trace_disabled_is_free():
    prob = problems.box_constrained_spd()
    r = cq.models.bbpgd.solve(prob.A, prob.b, proj=prob.proj,
                              config=BBPGDConfig(tol=1e-10))
    assert r.trace.shape == (0,)


def test_trace_in_batched_solve():
    As, bs, _ = random_qp_batch(jax.random.PRNGKey(0), 8, 16, jnp.float64,
                                diag_boost=1.0)
    proj = cq.box(-jnp.ones(16, jnp.float64), jnp.ones(16, jnp.float64),
                  jnp.float64)
    cfg = BBPGDConfig(tol=1e-9, max_matvecs=1000, trace_len=32)
    r = solve_batched("bbpgd", As, bs, proj=proj, config=cfg)
    hists = trim_trace(r)
    assert len(hists) == 8
    for h, it in zip(hists, np.asarray(r.iterations)):
        assert len(h) == min(it, 32)


def test_trace_mprgp():
    prob = problems.active_box_constrained_spd()
    cfg = MPRGPConfig(tol=1e-10, max_matvecs=1000, trace_len=64)
    r = cq.models.mprgp.solve(prob.A, prob.b, proj=prob.proj, config=cfg)
    assert len(trim_trace(r)) == int(r.iterations)


def test_timed_solve():
    prob = problems.box_constrained_spd()
    r = timed_solve(cq.models.bbpgd.solve, prob.A, prob.b, proj=prob.proj,
                    config=BBPGDConfig(tol=1e-10))
    assert float(r.solve_time) > 0


def test_check_result_passes_and_fails():
    prob = problems.box_constrained_spd()
    r = cq.models.bbpgd.solve(prob.A, prob.b, proj=prob.proj,
                              config=BBPGDConfig(tol=1e-10))
    rep = check_result(r, proj=prob.proj, A=prob.A, b=prob.b)
    assert rep["ok"] and rep["feasible"] and rep["residual_consistent"]

    import dataclasses
    bad = dataclasses.replace(r, x=r.x.at[0].set(jnp.nan))
    rep2 = check_result(bad, proj=prob.proj, raise_on_fail=False)
    assert not rep2["ok"]
