"""ccqppy_jax — a batched convex-constrained QP solver framework in JAX.

Solves  min_x  1/2 x^T A x + b^T x   s.t.  x in Omega
(Omega a closed convex set given by a projection operator), with the full
capability surface of the reference CCQPpy library re-designed for
accelerators (it runs on NVIDIA GPUs and, for tests, on the CPU):

* ``ccqppy_jax.ops``      — projection-operator algebra + linear operators
                            (dense / block-sparse / mesh-sharded).
* ``ccqppy_jax.models``   — the solver suite: PGD, APGD, APGD-AR, BBPGD,
                            BBPGDf, SPG, MPRGP, MPRGP-BB as jit-compiled
                            ``lax.while_loop`` kernels, plus PCG (projected
                            CG with active-set restarts; no reference
                            counterpart).
* ``ccqppy_jax.parallel`` — scenario batching (vmap/shard_map), the
                            row-sharded single-huge-QP path, and the
                            bf16->f32 mixed-precision ensemble pipeline.
* ``ccqppy_jax.utils``    — oracle problems, random QP ensembles, benchmark
                            harness, plotting.
* ``ccqppy_jax.compat``   — drop-in class API mirroring the reference
                            (``CCQPSolverBBPGD(...).solve(A, b, ...)``).

Gradient convention: ``g = A x + b`` (the reference's executable convention;
see SURVEY.md section 2.5).
"""

__version__ = "0.1.0"

from ccqppy_jax import models, ops, parallel, utils  # noqa: F401
from ccqppy_jax.models import (SOLVERS, SolveResult, apgd, bbpgd, mprgp, pgd,
                               spg)  # noqa: F401
from ccqppy_jax.ops import projections  # noqa: F401
from ccqppy_jax.ops.linop import (BlockSparseOperator, CastDense,
                                  DenseOperator, FastDense, MixedPrecDense,
                                  ShardedDenseOperator, as_operator)  # noqa: F401
from ccqppy_jax.ops.projections import (BallProj, BlockwiseProj, BoxProj,
                                        IdentityProj, LorentzConeProj,
                                        LowerBoundProj, ProductProj,
                                        SegmentProj, UpperBoundProj, ball,
                                        blockwise, box, identity,
                                        lorentz_cone, lower_bound,
                                        segment_product,
                                        upper_bound)  # noqa: F401
