"""Rows of the global batch under data parallelism (counterpart of
``mistral_inference_tpu/parallel/multihost.py``).

Every rank runs the host loop on the whole global batch. A data rank d of
``data`` = DP computes the rows [d b, (d + 1) b), b = ceil(B / DP), of the
batch padded with empty rows (seqlens 0, which the ring and the Mamba state
ignore); ``fetch`` brings the ranks' rows back together, so the host loop,
sampling included, sees the same global tensor on every rank. The JAX
package's ``fetch`` (``process_allgather``) plays this part there.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from mistral_inference_tpu_torch.parallel.mesh import Mesh


def rows_per_rank(batch: int, mesh: Optional[Mesh]) -> int:
    """b: the rows each data rank holds of a global batch of ``batch``."""
    return batch if mesh is None else -(-batch // mesh.data)


def first_row(batch: int, mesh: Optional[Mesh]) -> Optional[int]:
    """The global row of this rank's first row, or None without data
    parallelism (the rank holds every row)."""
    if mesh is None or mesh.data == 1:
        return None
    return mesh.d * rows_per_rank(batch, mesh)


def local_rows(x: torch.Tensor, row0: int, b: int) -> torch.Tensor:
    """Rows [row0, row0 + b) of ``x`` (B, ...) padded with zero rows past
    B; a new tensor, never a view of ``x``."""
    B = x.shape[0]
    if row0 + b > B:
        x = torch.cat([x, x.new_zeros((row0 + b - B, *x.shape[1:]))])
    return x[row0:row0 + b].clone()


def fetch(x: torch.Tensor, mesh: Optional[Mesh], batch: int) -> torch.Tensor:
    """The data ranks' rows (b, ...) gathered into the global (batch, ...):
    one all-gather over ``data``."""
    if mesh is None or mesh.data == 1:
        return x
    return mesh.all_gather(x, "data", 0)[:batch]


def to_global(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Host data that every rank holds alike, unchanged: there is no global
    array to build in this port. For tests: raises if a rank's ``x``
    differs from rank 0's (one broadcast over the world)."""
    if mesh is None or mesh.size == 1:
        return x
    ref = x.clone()
    dist.broadcast(ref, src=0)
    if not torch.equal(ref, x):
        raise ValueError(f"rank {mesh.rank} holds another value than rank 0")
    return x
