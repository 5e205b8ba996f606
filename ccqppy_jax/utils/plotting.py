"""Matplotlib visual helpers (host-side, optional).

Covers the reference's two plotting features:
* ``ProjOpBase.plot`` — 3-D scatter of projected uniform box samples
  (``CCQPpy/src/ccqppy/solution_spaces.py:48-74``); here the sample
  projection is one vmapped device call instead of a per-sample Python loop.
* ``BenchmarkRandomCCQP.plot`` — per-projection-family mean-metric curves vs
  problem size with 95% t-confidence bands
  (``benchmarks/benchmark_random_ccqp.py:104-145``).

matplotlib is imported lazily so headless/benchmark runs never pay for it.
"""
from __future__ import annotations

import numpy as np


def plot_projection_samples(proj, dim, num_samples, lb, ub, seed=0, ax=None,
                            show=False):
    """Scatter projections of uniform samples from the box [lb, ub]^dim."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    import jax
    import jax.numpy as jnp

    lb = np.broadcast_to(np.asarray(lb, np.float64), (dim,))
    ub = np.broadcast_to(np.asarray(ub, np.float64), (dim,))
    rng = np.random.default_rng(seed)
    xs = jnp.asarray(rng.uniform(lb, ub, (num_samples, dim)))
    projected = np.asarray(jax.vmap(proj.project)(xs))

    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
    cols = [projected[:, i] if i < dim else np.zeros(num_samples)
            for i in range(3)]
    ax.scatter(*cols)
    ax.set_xlabel("x0")
    ax.set_ylabel("x1")
    ax.set_zlabel("x2")
    if show:
        plt.show()
    return ax


def plot_benchmark_metric(metric_name, data, solver_names, family_names,
                          sizes, do_log_y=False, with_95_conf=True,
                          save_path=None, show=False):
    """Mean metric vs problem size per projection family, 95% t-bands.

    data: array [n_solvers, n_families, n_sizes, n_trials].
    """
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    import scipy.stats as st

    data = np.asarray(data)
    n_solvers, n_families, n_sizes, n_trials = data.shape
    fig, axes = plt.subplots(1, n_families, figsize=(4 * n_families, 4),
                             squeeze=False, sharey=True)
    for j, fam in enumerate(family_names):
        ax = axes[0, j]
        for i, sol in enumerate(solver_names):
            mean = data[i, j].mean(axis=-1)
            ax.plot(sizes, mean, marker="o", label=sol)
            if with_95_conf and n_trials > 1:
                sem = st.sem(data[i, j], axis=-1)
                half = sem * st.t.ppf((1 + 0.95) / 2.0, n_trials - 1)
                ax.fill_between(sizes, mean - half, mean + half, alpha=0.2)
        ax.set_title(fam)
        ax.set_xlabel("problem size")
        if do_log_y:
            ax.set_yscale("log")
    axes[0, 0].set_ylabel(metric_name)
    axes[0, -1].legend(fontsize=8)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
    if show:
        plt.show()
    return fig
