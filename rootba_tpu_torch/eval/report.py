"""Batch-evaluation report generation.

Port of the reference's pylatex report layer concepts
(python/rootba/latex/: results tables with best-value highlighting,
overview tables, convergence plots, performance profiles) to
markdown + PNG output (no LaTeX toolchain dependency):

* results tables: one row per sequence, one column block per
  experiment, best value bolded;
* performance profiles (latex/performance_profiles.py:19-90): for each
  tolerance tau, the cost threshold is best + tau*(initial - best)
  over all experiments of a sequence; plot fraction of sequences
  solved-to-threshold vs relative time alpha.
* convergence plots: cost vs time per sequence.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from rootba_tpu_torch.eval.experiments import Experiment
from rootba_tpu_torch.eval.metrics import (
    METRICS,
    cost_threshold,
    time_to_threshold,
)


def results_table_md(
    experiments: Dict[str, Experiment],
    metrics: Sequence[str],
    relative_to_metric: Optional[str] = None,
) -> str:
    """Markdown results table: sequences x (experiment, metric)."""
    exps = list(experiments.values())
    seqs = sorted({s for e in exps for s in e.sequences()})
    descs = [METRICS[m] for m in metrics]

    header = ["sequence"]
    for e in exps:
        for d in descs:
            header.append(f"{e.display_name}: {d.display_name}")
    lines = ["| " + " | ".join(header) + " |",
             "|" + "---|" * len(header)]
    for seq in seqs:
        vals: List[List[float]] = []
        for e in exps:
            run = e.runs.get(seq)
            row = []
            for d in descs:
                row.append(d.value(run.log) if run and run.log else
                           float("nan"))
            vals.append(row)
        cells = [seq]
        for ei in range(len(exps)):
            for mi, d in enumerate(descs):
                v = vals[ei][mi]
                col = [vals[k][mi] for k in range(len(exps))]
                finite = [x for x in col if math.isfinite(x)]
                best = (max(finite) if d.bigger_is_better else min(finite)) \
                    if finite else None
                txt = ("-" if not math.isfinite(v)
                       else f"{v:.{d.decimals}f}")
                if best is not None and math.isfinite(v) and v == best:
                    txt = f"**{txt}**"
                cells.append(txt)
        lines.append("| " + " | ".join(cells) + " |")
    return "\n".join(lines)


def overview_table_md(experiments: Dict[str, Experiment]) -> str:
    lines = ["| experiment | #runs | completed | failed |", "|---|---|---|---|"]
    for e in experiments.values():
        ok = sum(1 for r in e.runs.values() if not r.is_failed)
        bad = len(e.runs) - ok
        lines.append(f"| {e.display_name} | {len(e.runs)} | {ok} | {bad} |")
    return "\n".join(lines)


def compute_performance_profile(
    experiments: Dict[str, Experiment],
    tolerance: float,
    alphas: np.ndarray,
):
    """Fraction of sequences solved to the cost threshold within
    alpha x (fastest experiment's time), per experiment."""
    exps = list(experiments.values())
    seqs = sorted({s for e in exps for s in e.sequences()})
    times = np.full((len(exps), len(seqs)), np.inf)
    for si, seq in enumerate(seqs):
        initial = None
        best = np.inf
        logs = []
        for e in exps:
            run = e.runs.get(seq)
            log = run.log if run and run.log is not None else None
            logs.append(log)
            if log is not None:
                cost = np.asarray(log["cost"], dtype=np.float64)
                initial = cost[0] if initial is None else initial
                best = min(best, float(np.min(cost)))
        if initial is None or not np.isfinite(best):
            continue
        thresh = cost_threshold(float(initial), best, tolerance)
        for ei, log in enumerate(logs):
            if log is not None:
                times[ei, si] = time_to_threshold(log, thresh)
    tmin = np.min(times, axis=0)  # fastest per sequence
    profiles = np.zeros((len(exps), len(alphas)))
    for ei in range(len(exps)):
        with np.errstate(invalid="ignore"):
            rel = times[ei] / tmin
        for ai, a in enumerate(alphas):
            profiles[ei, ai] = np.mean(
                (rel <= a) & np.isfinite(times[ei])) if len(seqs) else 0.0
    return [e.display_name for e in exps], profiles


def plot_performance_profiles(
    experiments: Dict[str, Experiment],
    tolerances: Sequence[float],
    out_path: str,
    max_alpha: float = 8.0,
):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    alphas = np.linspace(1.0, max_alpha, 200)
    fig, axes = plt.subplots(1, len(tolerances),
                             figsize=(5 * len(tolerances), 4),
                             squeeze=False)
    for ti, tol in enumerate(tolerances):
        names, profiles = compute_performance_profile(
            experiments, tol, alphas)
        ax = axes[0, ti]
        for name, prof in zip(names, profiles):
            ax.plot(alphas, 100 * prof, label=name)
        ax.set_title(f"tolerance {tol}")
        ax.set_xlabel("relative time alpha")
        ax.set_ylabel("% solved to accuracy")
        ax.set_ylim(0, 105)
        ax.grid(True, alpha=0.3)
        ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_convergence(
    experiments: Dict[str, Experiment],
    out_path: str,
    sequences: Optional[Sequence[str]] = None,
    ncols: int = 3,
):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    exps = list(experiments.values())
    seqs = sequences or sorted({s for e in exps for s in e.sequences()})
    nrows = -(-len(seqs) // ncols)
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=(5 * ncols, 3.5 * nrows),
                             squeeze=False)
    for si, seq in enumerate(seqs):
        ax = axes[si // ncols][si % ncols]
        for e in exps:
            run = e.runs.get(seq)
            if run and run.log is not None:
                ax.semilogy(np.asarray(run.log["cumulative_time"]),
                            np.asarray(run.log["cost"]),
                            marker=".", label=e.display_name)
        ax.set_title(seq, fontsize=9)
        ax.set_xlabel("time [s]")
        ax.set_ylabel("cost")
        ax.grid(True, alpha=0.3)
        ax.legend(fontsize=7)
    for si in range(len(seqs), nrows * ncols):
        axes[si // ncols][si % ncols].axis("off")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_bar_metric(
    experiments: Dict[str, Experiment],
    metric: str,
    out_path: str,
):
    """Grouped bar chart of one metric per sequence x experiment
    (reference latex/plot.py runtime/memory bar charts)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = METRICS[metric]
    exps = list(experiments.values())
    seqs = sorted({s for e in exps for s in e.sequences()})
    x = np.arange(len(seqs))
    width = 0.8 / max(len(exps), 1)
    fig, ax = plt.subplots(figsize=(max(6, 0.8 * len(seqs) + 2), 4))
    for ei, e in enumerate(exps):
        vals = []
        for seq in seqs:
            run = e.runs.get(seq)
            v = d.value(run.log) if run and run.log else float("nan")
            vals.append(v)
        ax.bar(x + (ei - (len(exps) - 1) / 2) * width, vals, width,
               label=e.display_name)
    ax.set_xticks(x)
    ax.set_xticklabels(seqs, rotation=30, ha="right", fontsize=8)
    ax.set_ylabel(d.display_name)
    ax.grid(True, axis="y", alpha=0.3)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def _tex_escape(s: str) -> str:
    return (s.replace("_", r"\_").replace("%", r"\%")
            .replace("#", r"\#").replace("&", r"\&"))


def results_table_tex(
    experiments: Dict[str, Experiment],
    metrics: Sequence[str],
) -> str:
    """LaTeX results table (booktabs), best value per metric bolded
    (reference latex/results_table.py top-highlighting)."""
    exps = list(experiments.values())
    seqs = sorted({s for e in exps for s in e.sequences()})
    descs = [METRICS[m] for m in metrics]
    ncol = 1 + len(exps) * len(descs)
    lines = [r"\begin{tabular}{l" + "r" * (ncol - 1) + "}",
             r"\toprule"]
    head = ["sequence"]
    for e in exps:
        for d in descs:
            head.append(_tex_escape(f"{e.display_name} {d.display_name}"))
    lines.append(" & ".join(head) + r" \\")
    lines.append(r"\midrule")
    for seq in seqs:
        vals: List[List[float]] = []
        for e in exps:
            run = e.runs.get(seq)
            vals.append([d.value(run.log) if run and run.log
                         else float("nan") for d in descs])
        cells = [_tex_escape(seq)]
        for ei in range(len(exps)):
            for mi, d in enumerate(descs):
                v = vals[ei][mi]
                col = [vals[k][mi] for k in range(len(exps))]
                finite = [x for x in col if math.isfinite(x)]
                best = (max(finite) if d.bigger_is_better
                        else min(finite)) if finite else None
                txt = ("--" if not math.isfinite(v)
                       else f"{v:.{d.decimals}f}")
                if best is not None and math.isfinite(v) and v == best:
                    txt = r"\textbf{" + txt + "}"
                cells.append(txt)
        lines.append(" & ".join(cells) + r" \\")
    lines += [r"\bottomrule", r"\end{tabular}"]
    return "\n".join(lines)


def generate_latex_report(
    experiments: Dict[str, Experiment],
    output_dir: str,
    metrics: Sequence[str],
    figures: Sequence[str],
) -> str:
    """Self-contained report.tex (the role the reference's pylatex PDF
    plays, python/rootba/latex/; compile with pdflatex if desired)."""
    parts = [
        r"\documentclass[landscape]{article}",
        r"\usepackage[margin=1.5cm]{geometry}",
        r"\usepackage{booktabs,graphicx}",
        r"\begin{document}",
        r"\section*{rootba\_tpu batch evaluation}",
        r"{\small", results_table_tex(experiments, metrics), "}",
    ]
    for fig in figures:
        if os.path.exists(os.path.join(output_dir, fig)):
            parts.append(
                r"\includegraphics[width=\linewidth]{" + fig + "}")
    parts.append(r"\end{document}")
    tex_path = os.path.join(output_dir, "report.tex")
    with open(tex_path, "w") as fp:
        fp.write("\n".join(parts) + "\n")
    return tex_path


def generate_report(
    experiments: Dict[str, Experiment],
    output_dir: str,
    metrics: Sequence[str] = ("cost", "num_iterations", "total_time",
                              "linear_solver_time", "peak_memory"),
    tolerances: Sequence[float] = (0.01, 0.003, 0.001),
) -> str:
    os.makedirs(output_dir, exist_ok=True)
    parts = ["# rootba_tpu batch evaluation report", ""]
    parts += ["## Overview", "", overview_table_md(experiments), ""]
    parts += ["## Results", "", results_table_md(experiments, metrics), ""]
    pp_path = os.path.join(output_dir, "performance_profiles.png")
    try:
        plot_performance_profiles(experiments, tolerances, pp_path)
        parts += ["## Performance profiles", "",
                  f"![performance profiles](performance_profiles.png)", ""]
    except Exception as e:  # profile plots need >= 1 completed run
        parts += [f"(performance profiles skipped: {e})", ""]
    conv_path = os.path.join(output_dir, "convergence.png")
    try:
        plot_convergence(experiments, conv_path)
        parts += ["## Convergence", "", "![convergence](convergence.png)",
                  ""]
    except Exception as e:
        parts += [f"(convergence plots skipped: {e})", ""]
    figures = ["performance_profiles.png", "convergence.png"]
    for metric, title in (("total_time", "Runtime"),
                          ("peak_memory", "Peak memory")):
        png = f"bar_{metric}.png"
        try:
            plot_bar_metric(experiments, metric,
                            os.path.join(output_dir, png))
            parts += [f"## {title}", "", f"![{title}]({png})", ""]
            figures.append(png)
        except Exception as e:
            parts += [f"({title} bar chart skipped: {e})", ""]
    try:
        generate_latex_report(experiments, output_dir, metrics, figures)
    except Exception as e:
        parts += [f"(latex report skipped: {e})", ""]
    report_path = os.path.join(output_dir, "report.md")
    with open(report_path, "w") as fp:
        fp.write("\n".join(parts))
    return report_path
