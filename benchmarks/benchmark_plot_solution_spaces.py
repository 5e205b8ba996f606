"""Visual smoke test of every projection operator.

Re-design of ``CCQPpy/benchmarks/benchmark_plot_solution_spaces.py``:
builds each operator family for dims 1-3 and scatters projections of uniform
box samples — but the sample projection is one vmapped device call and the
figures are saved to files instead of blocking on plt.show().

Run:  python benchmarks/benchmark_plot_solution_spaces.py
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax.numpy as jnp
import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from ccqppy_jax.ops import projections as P  # noqa: E402
from ccqppy_jax.utils.plotting import plot_projection_samples  # noqa: E402

OUT = pathlib.Path(__file__).resolve().parent / "results"


def main(num_samples=200):
    OUT.mkdir(exist_ok=True)
    cases = []
    for dim in (1, 2, 3):
        ones = jnp.ones(dim)
        cases += [
            (f"identity_{dim}d", P.identity(), dim),
            (f"lower_bound_{dim}d", P.lower_bound(-ones), dim),
            (f"upper_bound_{dim}d", P.upper_bound(ones), dim),
            (f"box_{dim}d", P.box(-ones, ones), dim),
            (f"ball_{dim}d", P.ball(1.0), dim),
        ]
        if dim >= 2:
            cases.append((f"cone_{dim}d", P.lorentz_cone(1.0), dim))

    for name, op, dim in cases:
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
        plot_projection_samples(op, dim, num_samples,
                                -2 * jnp.ones(dim), 2 * jnp.ones(dim), ax=ax)
        ax.set_title(name)
        fig.savefig(OUT / f"proj_{name}.png", dpi=80)
        plt.close(fig)
        print("wrote", OUT / f"proj_{name}.png")


if __name__ == "__main__":
    main()
