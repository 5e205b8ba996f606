"""Solver suite: functional, jit-compiled, vmappable QP solvers.

Each solver module exposes ``solve(A, b, x0=None, proj=None, config=...)``
returning a ``SolveResult`` pytree.  ``SOLVERS`` maps short names to
(solve_fn, config_cls) for benchmark harnesses and the compat layer.
"""
from ccqppy_jax.models import apgd, bbpgd, direct, mprgp, pcg, pgd, spg
from ccqppy_jax.models.apgd import APGDConfig, APGDSCConfig
from ccqppy_jax.models.base import SolveResult, SolverConfig, pg_residual
from ccqppy_jax.models.bbpgd import BBPGDConfig, BBPGDfConfig
from ccqppy_jax.models.direct import (direct_x0, solve_direct_batched,
                                      spd_inverse_batch)
from ccqppy_jax.models.mprgp import MPRGPBBConfig, MPRGPConfig
from ccqppy_jax.models.pcg import PCGConfig
from ccqppy_jax.models.pgd import PGDConfig
from ccqppy_jax.models.spg import SPGConfig

SOLVERS = {
    "pgd": (pgd.solve, PGDConfig),
    "apgd": (apgd.solve, APGDConfig),
    "apgd_ar": (apgd.solve_anti_relaxation, APGDConfig),
    "apgd_sc": (apgd.solve_sc, APGDSCConfig),
    "bbpgd": (bbpgd.solve, BBPGDConfig),
    "bbpgd_f": (bbpgd.solve_fallback, BBPGDfConfig),
    "spg": (spg.solve, SPGConfig),
    "mprgp": (mprgp.solve, MPRGPConfig),
    "mprgp_bb": (mprgp.solve_bb, MPRGPBBConfig),
    "pcg": (pcg.solve, PCGConfig),
}

__all__ = [
    "SOLVERS", "SolveResult", "SolverConfig", "pg_residual",
    "pgd", "apgd", "bbpgd", "spg", "mprgp", "pcg",
    "PGDConfig", "APGDConfig", "BBPGDConfig", "BBPGDfConfig",
    "SPGConfig", "MPRGPConfig", "MPRGPBBConfig", "PCGConfig",
]
