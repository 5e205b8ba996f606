"""Parallelism layer: scenario batching (vmap/shard_map over a batch axis)
and single-huge-QP operator parallelism (row-sharded A with collective
matvecs).  See SURVEY.md section 2.8 for the design mapping."""
from ccqppy_jax.parallel.batch import (make_batch_mesh, solve_batched,
                                       solve_batched_compact,
                                       solve_batched_fused_compact,
                                       solve_batched_sharded)
from ccqppy_jax.parallel.distributed import (init_distributed,
                                             make_hybrid_mesh, scaling_probe)
from ccqppy_jax.parallel.mixed import prepare_dense_batch, solve_batched_mixed
from ccqppy_jax.parallel.sharded import (make_mesh, solve_sharded,
                                         solve_sharded_blocksparse)

__all__ = ["solve_batched", "solve_batched_compact",
           "solve_batched_fused_compact", "solve_batched_sharded",
           "make_batch_mesh", "solve_batched_mixed", "prepare_dense_batch",
           "solve_sharded", "solve_sharded_blocksparse", "make_mesh",
           "init_distributed", "make_hybrid_mesh", "scaling_probe"]
