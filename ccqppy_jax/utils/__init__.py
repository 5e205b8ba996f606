"""Utilities: oracle problems, random QP ensembles, benchmark harness,
plotting, pytree helpers.

``benchmark`` is imported lazily (it depends on ``models``, which depends on
``utils.pytree`` — eager import would be circular).
"""
from ccqppy_jax.utils import random_qp
from ccqppy_jax.utils.random_qp import random_qp_batch

__all__ = ["problems", "random_qp", "random_qp_batch", "BenchmarkRandomCCQP",
           "BenchmarkResult", "default_families", "disjoint_families",
           "benchmark", "plotting", "timed_run", "TimedRun", "materialize",
           "dense_sweep_bytes"]


def __getattr__(name):
    if name in ("BenchmarkRandomCCQP", "BenchmarkResult", "default_families",
                "disjoint_families", "timed_run", "TimedRun", "materialize",
                "dense_sweep_bytes"):
        from ccqppy_jax.utils import benchmark as _b
        return getattr(_b, name)
    if name in ("benchmark", "problems", "plotting"):
        import importlib
        return importlib.import_module(f"ccqppy_jax.utils.{name}")
    raise AttributeError(name)
