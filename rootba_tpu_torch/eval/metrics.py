"""Declarative metric registry (port of python/rootba/metric.py
concepts: each metric extracts a scalar from a loaded log, with
display/decimals/relative-to hints for tables)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np


@dataclass
class MetricDesc:
    name: str
    display_name: str
    extract: Callable  # log -> float
    decimals: int = 3
    bigger_is_better: bool = False
    format_string: str = "{:.3f}"

    def value(self, log) -> float:
        try:
            return float(self.extract(log))
        except Exception:
            return float("nan")


def _solver(log):
    return log["_static"]["solver"]


METRICS: Dict[str, MetricDesc] = {}


def register(name, display_name, extract, **kw):
    METRICS[name] = MetricDesc(name, display_name, extract, **kw)
    return METRICS[name]


register("cost", "final cost",
         lambda log: np.asarray(log["cost"])[-1], decimals=6)
register("cost_valid", "final cost (valid)",
         lambda log: np.asarray(log["cost_valid"])[-1], decimals=6)
register("num_iterations", "#it",
         lambda log: int(np.asarray(log["iteration"])[-1]), decimals=0)
register("num_successful", "#it-ok",
         lambda log: _solver(log)["num_successful_steps"], decimals=0)
register("linear_solver_iterations", "#cg",
         lambda log: int(np.sum(np.asarray(
             log["linear_solver_iterations"]))), decimals=0)
register("total_time", "t-total [s]",
         lambda log: _solver(log)["total_time_in_seconds"])
register("preprocessor_time", "t-pre [s]",
         lambda log: _solver(log)["preprocessor_time_in_seconds"])
register("minimizer_time", "t-min [s]",
         lambda log: _solver(log)["minimizer_time_in_seconds"])
register("linear_solver_time", "t-lin [s]",
         lambda log: _solver(log)["linear_solver_time_in_seconds"])
register("residual_evaluation_time", "t-res [s]",
         lambda log: _solver(log)["residual_evaluation_time_in_seconds"])
register("jacobian_evaluation_time", "t-jac [s]",
         lambda log: _solver(log)["jacobian_evaluation_time_in_seconds"])
register("stage1_time", "t-stage1 [s]",
         lambda log: float(np.sum(np.asarray(log["stage1_time"]))))
register("stage2_time", "t-stage2 [s]",
         lambda log: float(np.sum(np.asarray(log["stage2_time"]))))
register("solve_reduced_system_time", "t-solve [s]",
         lambda log: float(np.sum(np.asarray(
             log["solve_reduced_system_time"]))))
register("back_substitution_time", "t-backsub [s]",
         lambda log: float(np.sum(np.asarray(
             log["back_substitution_time"]))))
register("peak_memory", "mem [GB]",
         lambda log: _solver(log)["resident_memory_peak"] / 1e9)


def cost_threshold(initial: float, best: float, tolerance: float) -> float:
    """Performance-profile threshold: best + tol*(initial - best)
    (reference python/rootba/latex/performance_profiles.py:19-90)."""
    return best + tolerance * (initial - best)


def time_to_threshold(log, threshold: float) -> float:
    """Cumulative time at which the cost first drops below threshold;
    inf if never."""
    cost = np.asarray(log["cost"], dtype=np.float64)
    t = np.asarray(log["cumulative_time"], dtype=np.float64)
    below = np.nonzero(cost <= threshold)[0]
    if below.size == 0:
        return float("inf")
    return float(t[below[0]])
