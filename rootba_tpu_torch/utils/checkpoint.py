"""Mid-solve checkpoint/resume, the port's copy of the JAX package's
`utils/checkpoint.py`.

The reference has no mid-solve checkpointing (SURVEY §5: backup()/
restore() is per-LM-step rollback only, bal_problem.cpp:590-608; end
state is optionally saved via save_output). This module snapshots the
complete state of the host LM driver -- cameras, per-bucket landmark
positions, damping state (lambda, lambda_vee), iteration counter and
the per-iteration log so far -- as a single npz written atomically
(tmp + rename). optimize_lm resumes from it when solver.checkpoint_path
points at an existing file.

The file format is the JAX package's (FORMAT_VERSION 1, the same npz
keys and meta JSON), so a checkpoint written by either package resumes
in the other, given the same bucket layout (rows padded to multiples of
8, which every mesh of 1, 2, 4 or 8 ranks keeps). The arrays keep the
state's dtype: a float32 solve stores and restores float32 bits.

Under a mesh (parallel.mesh) the landmark shards are gathered to every
rank (a collective: every rank saves) and rank 0 alone writes; the file
holds the whole state, so it resumes on any number of ranks that keeps
its bucket layout (1, 2, 4 or 8).
solver/lm.optimize_lm checks that every rank sees the same file before
it loads.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import List

import numpy as np

from rootba_tpu_torch.parallel.mesh import gather_to_host

FORMAT_VERSION = 1


def iteration_to_dict(it) -> dict:
    """IterationSummary -> plain dict (nested dataclasses included)."""
    return dataclasses.asdict(it)


def iteration_from_dict(d: dict):
    from rootba_tpu_torch.log.summary import (
        IterationSummary,
        ResidualInfoHost,
        ResidualItemHost,
    )

    d = dict(d)
    for key in ("cost", "cost_change"):
        ri = d.get(key)
        if isinstance(ri, dict):
            d[key] = ResidualInfoHost(
                all=ResidualItemHost(**ri["all"]),
                valid=ResidualItemHost(**ri["valid"]),
                is_numerically_valid=ri.get("is_numerically_valid", True),
            )
    return IterationSummary(**d)


def save_checkpoint(path: str, state, lam: float, lambda_vee: float,
                    it: int, iteration_summaries: List[dict],
                    mesh=None) -> None:
    """Atomically write the LM driver state. `state` is a BAState
    (CamState + per-bucket landmark positions [L, 3]) of tensors on any
    device; they are written as numpy arrays of their own dtype. Under
    a mesh every rank calls this (the landmark shards are gathered) and
    rank 0 writes."""
    def host(t):
        return t.detach().cpu().numpy()

    arrays = {
        "cam_q": host(state.cams.q),
        "cam_t": host(state.cams.t),
        "cam_intr": host(state.cams.intr),
        "meta": np.frombuffer(json.dumps({
            "version": FORMAT_VERSION,
            "lam": float(lam),
            "lambda_vee": float(lambda_vee),
            "it": int(it),
            "num_buckets": len(state.lm_ps),
            "iterations": iteration_summaries,
        }).encode(), dtype=np.uint8),
    }
    for i, p in enumerate(state.lm_ps):
        arrays[f"lm_p{i}"] = gather_to_host(p, mesh)
    if mesh is not None and mesh.rank != 0:
        return
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as fp:
            np.savez(fp, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str):
    """Returns (cam_q, cam_t, cam_intr, lm_ps, lam, lambda_vee, it,
    iteration_summaries) or None if absent."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        if meta.get("version") != FORMAT_VERSION:
            raise ValueError(
                f"checkpoint {path} has version {meta.get('version')}, "
                f"expected {FORMAT_VERSION}")
        lm_ps = [z[f"lm_p{i}"] for i in range(meta["num_buckets"])]
        return (z["cam_q"], z["cam_t"], z["cam_intr"], lm_ps,
                meta["lam"], meta["lambda_vee"], meta["it"],
                meta["iterations"])
