"""Render the reference-parity PNG curves from the study JSONs.

The reference's benchmark output is interactive matplotlib plots
(``CCQPpy/benchmarks/benchmark_random_ccqp.py:104-145``); ours are
files.  The study scripts (`benchmark_random_ccqp.py`) write both the JSON
tensors and the PNGs; this script re-renders the PNGs from those JSONs
alone — no re-solve, no hardware needed.

Run:  python benchmarks/render_plots.py
Writes benchmarks/results/{single_constraint,disjoint_constraints}_{metric}.png
"""
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

from ccqppy_jax.utils.plotting import plot_benchmark_metric

RESULTS = pathlib.Path(__file__).resolve().parent / "results"


def render(stem):
    with open(RESULTS / f"{stem}.json") as f:
        d = json.load(f)
    for metric, logy in (("solve_time", True), ("matvecs", True),
                         ("residual", False)):
        path = RESULTS / f"{stem}_{metric}.png"
        plot_benchmark_metric(
            metric, np.asarray(d[metric]), d["solvers"], d["families"],
            d["sizes"], do_log_y=logy, save_path=str(path))
        print("wrote", path)


if __name__ == "__main__":
    for stem in ("single_constraint", "disjoint_constraints"):
        render(stem)
