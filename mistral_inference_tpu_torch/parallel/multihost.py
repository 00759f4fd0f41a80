"""Rows of the global batch under data parallelism (counterpart of
``mistral_inference_tpu/parallel/multihost.py``).

Every rank runs the host loop on the whole global batch. A data rank d of
``data`` = DP computes the rows [d b, (d + 1) b), b = ceil(B / DP), of the
batch padded with empty rows (seqlens 0, which the ring and the Mamba state
ignore); ``fetch`` brings the ranks' rows back together, so the host loop,
sampling included, sees the same global tensor on every rank. The JAX
package's ``fetch`` (``process_allgather``) plays this part there.
``copy_rows`` moves a global row's state into another global row (the
serving engines' prefix copies and staged rows), across data ranks where
the two rows live on two of them.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

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


def copy_rows(
    dst: torch.Tensor,
    src: torch.Tensor,
    pairs: Sequence[Tuple[int, int]],
    mesh: Optional[Mesh],
    dst_row0: Optional[int],
    src_row0: Optional[int],
    cut: Callable[[torch.Tensor], torch.Tensor] = lambda r: r,
) -> None:
    """For each (s, d) of ``pairs`` (global rows), ``cut(dst[:, d]) =
    cut(src[:, s])`` in place, ``cut`` a view of a row (L, ...). ``dst``
    and ``src`` (L, b, ...) hold a data rank's b rows from global row
    ``dst_row0`` / ``src_row0`` (None: every row). A pair whose rows live on
    one rank is copied there; the pairs whose rows live on two data ranks
    move through one all-gather over ``data``, the same on every rank.
    ``dst`` may be ``src``: the pairs are then applied in order only where
    no pair crosses ranks."""
    if dst_row0 is None:
        for s, d in pairs:
            cut(dst[:, d]).copy_(cut(src[:, s]))
        return
    bd, bs, me = dst.shape[1], src.shape[1], mesh.d
    cross = []
    for s, d in pairs:
        if s // bs != d // bd:
            cross.append((s, d))
        elif d // bd == me:
            cut(dst[:, d - dst_row0]).copy_(cut(src[:, s - src_row0]))
    if not cross:
        return
    blank = torch.zeros_like(cut(src[:, 0]))
    send = torch.stack([cut(src[:, s - src_row0]) if s // bs == me else blank
                        for s, _ in cross])
    got = mesh.all_gather(send, "data", 0).unflatten(0, (mesh.data, len(cross)))
    for k, (s, d) in enumerate(cross):
        if d // bd == me:
            cut(dst[:, d - dst_row0]).copy_(got[s // bs, k])
