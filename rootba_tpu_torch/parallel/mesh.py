"""Landmark sharding over a torch.distributed process group.

Port of the JAX package's `parallel/mesh.py`. The decomposition is the
same: the landmark axis is embarrassingly parallel, so each rank keeps a
contiguous block of every bucket's landmark rows (`P("lm")` there); the
camera axis is the contended one, so camera state and every
camera-indexed accumulator ([N, 9] vectors, [N, 9, 9] blocks, the SC
pair blocks) are replicated, and each per-camera sum is a partial sum
per rank followed by one all-reduce (the collective GSPMD inserts
there). The solvers call `all_reduce_sum` at each such sum; without a
mesh it returns its argument.

Every value that steers control flow (costs, l_diff, the CG and
power-series stops, the stage1 failure count) comes out of an
all-reduce or out of replicated ops on replicated inputs, so the ranks
cannot diverge: an all-reduce hands every rank the same bits.

Backends, one fixed rule (`backend_for`): NCCL when each rank owns a
card of its own, gloo otherwise (the CPU, or more ranks than cards:
NCCL refuses two ranks on one device). gloo reduces and broadcasts CUDA
tensors but gathers none, so the solve path uses `all_reduce` only, and
`gather_to_host` gathers the landmark shards as host tensors over a
gloo group (the default group under gloo, a gloo group beside it under
NCCL).

Launch: every rank runs the same program with `init_distributed` (or
the ROOTBA_COORDINATOR / ROOTBA_NUM_PROCESSES / ROOTBA_PROCESS_ID
environment variables), then `bundle_adjust` with `num_devices` 0 (every
rank) or the world size.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# all-reduces of the solve path since the last reset_stats(): how many,
# and the host seconds spent in them (an NCCL all-reduce returns before
# the card has run it, so under NCCL this is the host's share only)
STATS = {"all_reduces": 0, "all_reduce_s": 0.0}


def reset_stats() -> None:
    STATS["all_reduces"] = 0
    STATS["all_reduce_s"] = 0.0


def backend_for(world_size: int) -> str:
    """'nccl' when every rank can own a card of its own, else 'gloo'."""
    if torch.cuda.is_available() and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def local_rank() -> int:
    """This process's rank on its host: LOCAL_RANK when a launcher sets
    it, else the global rank (one host)."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def rank_cuda_device() -> torch.device:
    """The card of this rank: cuda:{local_rank % device_count}."""
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Join the process group, on the backend of `backend_for`.
    Arguments default to the ROOTBA_COORDINATOR ("host:port" or
    "tcp://host:port") / ROOTBA_NUM_PROCESSES / ROOTBA_PROCESS_ID
    environment variables, as the JAX package's."""
    coordinator_address = coordinator_address or os.environ.get(
        "ROOTBA_COORDINATOR")
    if num_processes is None and "ROOTBA_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["ROOTBA_NUM_PROCESSES"])
    if process_id is None and "ROOTBA_PROCESS_ID" in os.environ:
        process_id = int(os.environ["ROOTBA_PROCESS_ID"])
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "init_distributed needs the coordinator address, the number "
            "of processes and this process's id (arguments or "
            "ROOTBA_COORDINATOR / ROOTBA_NUM_PROCESSES / ROOTBA_PROCESS_ID)")
    backend = backend_for(num_processes)
    if backend == "nccl":
        torch.cuda.set_device(
            int(os.environ.get("LOCAL_RANK", process_id))
            % torch.cuda.device_count())
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)


# the gloo group of the host gathers under a non-gloo default group, per
# default group (new_group is collective: every rank makes it at its
# first gather, which every rank reaches at the same point)
_HOST_GROUP = [None, None]


@dataclass(frozen=True)
class LandmarkMesh:
    """One rank's view of the landmark mesh over the default process
    group: its rank, the world size and the device this rank solves
    on."""

    rank: int
    size: int
    device: torch.device

    def rows(self, L: int):
        """This rank's block [lo, hi) of L landmark rows (L divides
        evenly: bucketize pads rows to pad_rows_for_mesh)."""
        if L % self.size:
            raise ValueError(f"{L} landmark rows do not divide over "
                             f"{self.size} ranks (bucketize with "
                             f"row_align=pad_rows_for_mesh({self.size}))")
        per = L // self.size
        return self.rank * per, (self.rank + 1) * per

    @property
    def host_group(self):
        """The gloo group that gathers host tensors (None: the default
        group)."""
        if dist.get_backend() == "gloo":
            return None
        world = dist.group.WORLD
        if _HOST_GROUP[0] is not world:
            _HOST_GROUP[:] = [world, dist.new_group(backend="gloo")]
        return _HOST_GROUP[1]


def make_mesh(num_devices: int,
              device: torch.device) -> Optional[LandmarkMesh]:
    """The mesh of `num_devices` (the JAX package's meaning): 1 is no
    mesh, 0 every rank of the initialized process group, k > 1 must be
    the world size. Without a process group, 0 is no mesh too, and
    k > 1 is an error. `device` is this rank's device."""
    if num_devices == 1:
        return None
    if not (dist.is_available() and dist.is_initialized()):
        if num_devices > 1:
            raise ValueError(
                f"num_devices={num_devices} needs a process group of "
                f"{num_devices} ranks (parallel.mesh.init_distributed); "
                f"none is initialized")
        return None
    world = dist.get_world_size()
    if num_devices > 1 and num_devices != world:
        raise ValueError(f"num_devices={num_devices} but the process group "
                         f"has {world} ranks")
    return LandmarkMesh(rank=dist.get_rank(), size=world,
                        device=torch.device(device))


def pad_rows_for_mesh(num_devices: int, base_align: int = 8) -> int:
    """Row alignment so every bucket's landmark count divides evenly over
    the mesh: lcm(base_align, num_devices). For powers of two this is the
    JAX package's value; its doubling loop never ends for a count with
    an odd factor (3)."""
    return math.lcm(base_align, max(num_devices, 1))


def shard_rows(x, mesh: Optional[LandmarkMesh]):
    """This rank's block of x's leading (landmark) axis; a tensor comes
    back as a copy, so the full one can be freed."""
    if mesh is None:
        return x
    lo, hi = mesh.rows(x.shape[0])
    if isinstance(x, torch.Tensor):
        return x[lo:hi].clone()
    return x[lo:hi]


def shard_bucket_index(bucket, mesh: Optional[LandmarkMesh]):
    """A bucket index (a NamedTuple of [L, ...] arrays or tensors) with
    every field cut to this rank's landmark rows."""
    if mesh is None:
        return bucket
    return type(bucket)(*(shard_rows(x, mesh) for x in bucket))


def shard_state(state, mesh: Optional[LandmarkMesh]):
    """Cameras replicated, every bucket's landmark positions cut to this
    rank's rows."""
    if mesh is None:
        return state
    return type(state)(cams=state.cams,
                       lm_ps=tuple(shard_rows(p, mesh)
                                   for p in state.lm_ps))


def all_reduce_sum(t: torch.Tensor,
                   mesh: Optional[LandmarkMesh]) -> torch.Tensor:
    """The sum of t over the ranks (in place); t itself without a
    mesh."""
    if mesh is None:
        return t
    t = t.contiguous()
    t0 = time.monotonic()
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    STATS["all_reduces"] += 1
    STATS["all_reduce_s"] += time.monotonic() - t0
    return t


def gather_to_host(x: torch.Tensor,
                   mesh: Optional[LandmarkMesh]) -> np.ndarray:
    """The rank-order concatenation of every rank's block of a sharded
    tensor, as numpy on every rank (a collective: every rank calls it);
    without a mesh, x itself."""
    local = x.detach().cpu().contiguous()
    if mesh is None or mesh.size == 1:
        return local.numpy()
    parts = [torch.empty_like(local) for _ in range(mesh.size)]
    dist.all_gather(parts, local, group=mesh.host_group)
    return torch.cat(parts, dim=0).numpy()


def host_all_reduce(values, mesh: LandmarkMesh) -> np.ndarray:
    """Sum of small float64 host vectors over the ranks (the gloo host
    group; for agreement checks off the solve path)."""
    t = torch.as_tensor(np.asarray(values, np.float64)).clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.host_group)
    return t.numpy()
