"""Start the ranks' process group (counterpart of
``mistral_inference_tpu/parallel/distributed.py``).

A run over N GPUs is N processes, one per GPU, started by ``torchrun``
(``torchrun --nproc-per-node N -m mistral_inference_tpu_torch.main demo
<folder> --tensor N``), which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE`` and ``MASTER_ADDR`` / ``MASTER_PORT``. Every rank runs
the same program; only the primary rank prints and answers HTTP.

The backend is never chosen quietly: NCCL when every local rank has a GPU
of its own, gloo on the CPU. Ranks that would share a GPU (more local ranks
than GPUs) raise unless the caller asks for ``backend="gloo"``, which
stages CUDA tensors through the host: it runs the sharded math and the
kernels at shard shapes on one card, at none of NCCL's speed.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else _env_int("WORLD_SIZE", 1)


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else _env_int("RANK", 0)


def is_primary() -> bool:
    """True on the rank that prints and answers HTTP (rank 0)."""
    return rank() == 0


def _backend(requested: Optional[str], device: str) -> str:
    """The backend the rule of this module gives, or a ValueError."""
    local_world = _env_int("LOCAL_WORLD_SIZE", world_size())
    if device == "cpu":
        if requested not in (None, "gloo"):
            raise ValueError(f"backend {requested!r} on the CPU: only gloo runs there")
        return "gloo"
    n_gpus = torch.cuda.device_count()
    if n_gpus == 0:
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the ranks "
                           "on the CPU over gloo")
    shared = local_world > n_gpus
    if requested is None:
        if shared:
            raise ValueError(f"{local_world} local ranks would share {n_gpus} GPU(s), which "
                             "NCCL refuses; pass backend='gloo' to run them over the host")
        return "nccl"
    if requested == "nccl" and shared:
        raise ValueError(f"{local_world} local ranks would share {n_gpus} GPU(s): NCCL "
                         "refuses a duplicate GPU")
    if requested not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {requested!r}")
    return requested


def rank_device(device: Optional[str] = None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (modulo the GPUs, where gloo
    ranks share them), or the CPU when asked."""
    if device is not None and device != "cuda":
        return torch.device(device)
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", _env_int("LOCAL_RANK", 0) % n)


def init_distributed(
    backend: Optional[str] = None,
    device: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join the default process group from the environment ``torchrun``
    sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``).
    ``device="cpu"`` runs the ranks on the CPU (gloo); otherwise each rank
    takes ``cuda:LOCAL_RANK`` and the backend follows the rule of the module
    docstring. A no-op that returns False in a world of one process started
    without ``torchrun``; True once the group exists."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    dev = "cpu" if device == "cpu" else "cuda"
    chosen = _backend(backend, dev)
    kw = {}
    if chosen == "nccl":
        kw["device_id"] = rank_device()
        torch.cuda.set_device(kw["device_id"])
    dist.init_process_group(chosen, timeout=timedelta(seconds=timeout_s), **kw)
    return True
