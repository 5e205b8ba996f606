"""Fixed-step projected gradient descent (PGD).

JAX re-design of the reference ``CCQPSolverPGD``
(``CCQPpy/src/ccqppy/solvers.py:71-194``): the whole iteration
``x <- proj(x - t g); g = A x + b`` runs as a ``lax.while_loop`` with all
state on device — one fused GEMV + elementwise projection per iteration,
zero host round-trips.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ccqppy_jax.models.base import (SolverConfig, default_x0, init_trace,
                                    make_result, pg_residual, record_trace)
from ccqppy_jax.ops.linop import as_operator
from ccqppy_jax.ops.projections import identity


@dataclasses.dataclass(frozen=True)
class PGDConfig(SolverConfig):
    """step_size: fixed step t (reference ctor arg, default 0.01,
    ``solvers.py:81``; the reference tests pass 0.1)."""

    step_size: float = 0.01


class _State(NamedTuple):
    x: jax.Array
    g: jax.Array
    res: jax.Array
    mv: jax.Array
    it: jax.Array
    done: jax.Array
    trace: jax.Array


@partial(jax.jit, static_argnames=("config",))
def solve(A, b, x0=None, proj=None, config: PGDConfig = PGDConfig()):
    op = as_operator(A)
    b = jnp.asarray(b)
    proj = proj if proj is not None else identity()
    x0 = default_x0(b, x0, proj)
    t = jnp.asarray(config.step_size, b.dtype)

    g0 = op.matvec(x0) + b
    res0 = pg_residual(proj, x0, g0, config.gd, op)
    s0 = _State(x0, g0, res0, jnp.int32(1), jnp.int32(0), res0 < config.tol,
                init_trace(config, b.dtype))

    def cond(s):
        return ~s.done

    def body(s):
        x = proj.project(s.x - t * s.g)
        g = op.matvec(x) + b
        mv = s.mv + 1
        res = pg_residual(proj, x, g, config.gd, op)
        done = (res < config.tol) | (mv >= config.max_matvecs)
        return _State(x, g, res, mv, s.it + 1, done,
                      record_trace(s.trace, s.it, res))

    s = lax.while_loop(cond, body, s0)
    return make_result(s.x, s.res, s.mv, s.it, config.max_matvecs, s.trace)
