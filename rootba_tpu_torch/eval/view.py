"""Map export / quick visualization (stand-in for the reference's
Pangolin GUI, src/rootba/pangolin: BalMapDisplay camera frusta + point
cloud). Headless-friendly: PLY export for external viewers plus a
matplotlib 3D snapshot.

    python -m rootba_tpu_torch.eval.view problem.npz --ply map.ply --png map.png
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from rootba_tpu_torch.bal import nplie
from rootba_tpu_torch.bal.problem import BalProblem


def camera_centers(problem: BalProblem) -> np.ndarray:
    qinv = nplie.quat_conj(problem.cam_q)
    return nplie.quat_rotate(qinv, -problem.cam_t)


def export_ply(problem: BalProblem, path: str, max_points: int = 2_000_000):
    """Landmarks (gray) + camera centers (red) as a PLY point cloud."""
    pts = problem.lm_p
    if pts.shape[0] > max_points:
        idx = np.random.default_rng(0).choice(
            pts.shape[0], max_points, replace=False)
        pts = pts[idx]
    centers = camera_centers(problem)
    n = pts.shape[0] + centers.shape[0]
    with open(path, "w") as fp:
        fp.write("ply\nformat ascii 1.0\n"
                 f"element vertex {n}\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 "property uchar red\nproperty uchar green\n"
                 "property uchar blue\nend_header\n")
        for p in pts:
            fp.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f} 180 180 180\n")
        for c in centers:
            fp.write(f"{c[0]:.5f} {c[1]:.5f} {c[2]:.5f} 255 40 40\n")
    print(f"wrote {path} ({n} points)")


def render_png(problem: BalProblem, path: str, max_points: int = 50_000):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = problem.lm_p
    if pts.shape[0] > max_points:
        idx = np.random.default_rng(0).choice(
            pts.shape[0], max_points, replace=False)
        pts = pts[idx]
    centers = camera_centers(problem)

    fig = plt.figure(figsize=(9, 9))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=0.3, c="gray",
               alpha=0.5, linewidths=0)
    ax.scatter(centers[:, 0], centers[:, 1], centers[:, 2], s=12,
               c="red", marker="^")
    # robust axis limits (BAL clouds have far outliers)
    lo, hi = np.percentile(pts, [2, 98], axis=0)
    ax.set_xlim(lo[0], hi[0])
    ax.set_ylim(lo[1], hi[1])
    ax.set_zlim(lo[2], hi[2])
    ax.set_title(f"{problem.num_cameras} cams / "
                 f"{problem.num_landmarks} lms")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    print(f"wrote {path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="view/export a BAL map")
    ap.add_argument("input", help="problem file (.npz / BAL text)")
    ap.add_argument("--ply", default=None, help="export PLY point cloud")
    ap.add_argument("--png", default=None, help="render 3D snapshot PNG")
    args = ap.parse_args(argv)

    from rootba_tpu_torch.bal.problem import load_normalized_bal_problem
    from rootba_tpu_torch.config.options import BalDatasetOptions

    problem = load_normalized_bal_problem(
        BalDatasetOptions(input=args.input, quiet=True, normalize=False))
    if not args.ply and not args.png:
        args.png = "map.png"
    if args.ply:
        export_ply(problem, args.ply)
    if args.png:
        render_png(problem, args.png)
    return 0


if __name__ == "__main__":
    sys.exit(main())
