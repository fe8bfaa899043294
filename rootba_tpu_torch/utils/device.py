"""Device resolution and float32 precision settings.

Counterpart of the JAX package's `utils/jax_setup.py`. The port runs on
the card unless the caller asks for the CPU; a missing card is an error,
never a silent fall back to the CPU.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from rootba_tpu_torch.parallel.mesh import rank_cuda_device


def set_full_fp32_precision() -> None:
    """Full float32 matrix products: no TF32 in cuBLAS or cuDNN. Matches
    the reference's Precision.HIGHEST (its MXU products and the dense
    RCS GEMV run at full f32 accuracy)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(name: str = "cuda") -> torch.device:
    """torch.device for `name` ('cuda', 'cuda:N' or 'cpu'), with the
    float32 precision settings applied. Raises when a card is asked
    for and none is available. Under a process group (parallel.mesh)
    'cuda' is this rank's card."""
    dev = torch.device(name)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (use 'cuda' or "
                         f"'cpu')")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but no CUDA device is available; "
            f"pass device='cpu' (CLI: --device cpu) to run on the CPU")
    if (dev.type == "cuda" and dev.index is None
            and dist.is_available() and dist.is_initialized()):
        dev = rank_cuda_device()
    set_full_fp32_precision()
    return dev
