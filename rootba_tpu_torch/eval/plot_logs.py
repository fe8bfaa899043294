"""Quick matplotlib diagnostics for one or more runs (port of
python/rootba/plot_logs.py: cost vs time/iteration, trust region, CG
iterations, memory)."""

from __future__ import annotations

import argparse
import os
import sys
from typing import List

import numpy as np


def plot_logs(paths: List[str], save: str | None = None):
    import matplotlib

    if save:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from rootba_tpu_torch.eval.log import find_log, load_ba_log

    fig, axes = plt.subplots(2, 3, figsize=(15, 8))
    for path in paths:
        if os.path.isdir(path):
            path = find_log(path)
        log = load_ba_log(path)
        label = os.path.basename(os.path.dirname(os.path.abspath(path))) \
            or path
        it = np.asarray(log["iteration"])
        cost = np.asarray(log["cost"])
        t = np.asarray(log["cumulative_time"])

        axes[0, 0].semilogy(t, cost, marker=".", label=label)
        axes[0, 0].set_xlabel("time [s]")
        axes[0, 0].set_ylabel("cost")

        axes[0, 1].semilogy(it, cost, marker=".", label=label)
        axes[0, 1].set_xlabel("iteration")
        axes[0, 1].set_ylabel("cost")

        axes[0, 2].semilogy(it, np.asarray(log["trust_region_radius"]),
                            marker=".", label=label)
        axes[0, 2].set_xlabel("iteration")
        axes[0, 2].set_ylabel("trust region radius")

        axes[1, 0].plot(it, np.asarray(log["linear_solver_iterations"]),
                        marker=".", label=label)
        axes[1, 0].set_xlabel("iteration")
        axes[1, 0].set_ylabel("CG iterations")

        axes[1, 1].plot(it, np.asarray(log["iteration_time"]), marker=".",
                        label=label)
        axes[1, 1].set_xlabel("iteration")
        axes[1, 1].set_ylabel("iteration time [s]")

        axes[1, 2].plot(it, np.asarray(log["resident_memory_peak"]) / 1e9,
                        marker=".", label=label)
        axes[1, 2].set_xlabel("iteration")
        axes[1, 2].set_ylabel("peak memory [GB]")

    for ax in axes.ravel():
        ax.grid(True, alpha=0.3)
        ax.legend(fontsize=7)
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=120)
        print(f"saved {save}")
    else:
        plt.show()


def main(argv=None):
    ap = argparse.ArgumentParser(description="plot rootba_tpu BA logs")
    ap.add_argument("logs", nargs="+", help="ba_log files or run dirs")
    ap.add_argument("--save", default=None, help="save figure to file")
    args = ap.parse_args(argv)
    plot_logs(args.logs, args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
