"""Analytical oracle problem suite with known exact solutions.

Re-design of the reference ``problem_suite``
(``CCQPpy/src/ccqppy/problem_suite.py``): the same five problems —
shared 3x3 SPD tridiagonal Hessian ``A = tridiag(-1, 2, -1)`` with
``b = -A x_exact`` so the unconstrained stationary point equals the intended
solution (``problem_suite.py:42-177``) — expressed as plain data (frozen
pytrees), not classes, so a whole suite can be stacked and ``vmap``-solved.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ccqppy_jax.ops import projections as P


@dataclasses.dataclass(frozen=True)
class OracleProblem:
    """A QP with a known unique exact solution."""

    name: str
    A: object
    b: object
    proj: object
    exact_solution: object

    @property
    def number_of_unknowns(self):
        return self.b.shape[-1]


def _tridiag(dtype):
    return jnp.asarray(np.array([[2.0, -1.0, 0.0],
                                 [-1.0, 2.0, -1.0],
                                 [0.0, -1.0, 2.0]]), dtype)


def _make(name, proj, x_exact, dtype):
    A = _tridiag(dtype)
    x = jnp.asarray(x_exact, dtype)
    return OracleProblem(name, A, -A @ x, proj, x)


def unconstrained_spd_1(dtype=jnp.float64):
    """problem_suite.py:42-66 — identity projection, x* = [1, 0, 1]."""
    return _make("UnconstrainedSPD1", P.identity(), [1.0, 0.0, 1.0], dtype)


def unconstrained_spd_2(dtype=jnp.float64):
    """problem_suite.py:69-93 — product of three 1-dim identity blocks."""
    proj = P.blockwise(P.identity(), 1)
    return _make("UnconstrainedSPD2", proj, [1.0, 0.0, 1.0], dtype)


def box_constrained_spd(dtype=jnp.float64):
    """problem_suite.py:96-121 — box [0,2]^3, inactive at the optimum."""
    proj = P.box(jnp.zeros(3), 2 * jnp.ones(3), dtype)
    return _make("BoxConstrainedSPD", proj, [1.0, 0.0, 1.0], dtype)


def thin_box_constrained_spd(dtype=jnp.float64):
    """problem_suite.py:124-149 — thin box, still inactive at the optimum."""
    proj = P.box(jnp.array([-10.0, -0.1, 0.9]), jnp.array([10.0, 0.1, 1.1]), dtype)
    return _make("ThinBoxConstrainedSPD", proj, [1.0, 0.0, 1.0], dtype)


def active_box_constrained_spd(dtype=jnp.float64):
    """problem_suite.py:152-177 — box [9,10]^3; the unconstrained optimum
    [1,1,1] lies outside, the constrained optimum is the corner [9,9,9]."""
    A = _tridiag(dtype)
    x_uncon = jnp.asarray([1.0, 1.0, 1.0], dtype)
    proj = P.box(9 * jnp.ones(3), 10 * jnp.ones(3), dtype)
    return OracleProblem("ActiveBoxConstrainedSPD", A, -A @ x_uncon, proj,
                         jnp.asarray([9.0, 9.0, 9.0], dtype))


def all_problems(dtype=jnp.float64):
    return [
        unconstrained_spd_1(dtype),
        unconstrained_spd_2(dtype),
        box_constrained_spd(dtype),
        thin_box_constrained_spd(dtype),
        active_box_constrained_spd(dtype),
    ]


def readme_problem(dtype=jnp.float64):
    """The README usage example (``CCQPpy/README.md:30-50``):
    same tridiagonal A, x_exact = [1, 0, 1] clipped into the box
    [-2,2] x [-2,2] x [-4,5]."""
    proj = P.box(jnp.array([-2.0, -2.0, -4.0]), jnp.array([2.0, 2.0, 5.0]), dtype)
    return _make("READMEBox", proj, [1.0, 0.0, 1.0], dtype)
