"""The port's device mesh: one process per rank, one device per process
(counterpart of ``mistral_inference_tpu/parallel/mesh.py``).

The axes are ``(data, seq, expert, tensor)``, in the order of the JAX
package's ``make_mesh``, ``tensor`` innermost, so rank = ((d S + s) E + e) T
+ t. Every rank runs the same host loop on the same global inputs; the
forwards hide the shards:

* ``tensor``: every sharded linear shards its output axis, as the JAX
  package's kernels-under-mesh layout (``param_specs(pallas=True)``) does.
  ``wqkv``, ``w13`` and Mamba's ``in_proj`` take the rank's part of each
  fused piece; ``wo``, ``w2`` (an expert's too) and Mamba's ``out_proj``
  take D / T output columns over the whole K. Their input is all-gathered
  over ``tensor`` first (the attention output of the rank's heads, the FFN
  hidden, Mamba's gated activation) and their output after, in rank order,
  so every rank holds one device's activations in bits. No all-reduce over
  ``tensor`` is left; attention and the KV ring hold the rank's heads.
* ``seq``: a prefill chunk whose length ``seq`` divides is split into
  ``seq`` runs of tokens, one a seq rank; its K/V are all-gathered over
  ``seq`` and every seq rank writes the whole chunk into its ring, which
  is replicated over ``seq``. Decode steps, fused verify chunks and chunks
  that ``seq`` does not divide replicate.
* ``expert``: each rank holds a contiguous ``E / ep`` of the experts; the
  partial MoE outputs are summed by one all-reduce over ``expert``.
* ``data``: each data rank computes its rows of the global batch, and the
  outputs are all-gathered, so the host loops see the global batch.

Every collective of the port goes through ``Mesh.all_reduce`` and
``Mesh.all_gather``, which count what they issue (``Mesh.counts``). An axis
set of size 1 issues nothing.
"""

from __future__ import annotations

import collections
import math
from dataclasses import KW_ONLY, dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

AXES = ("data", "seq", "expert", "tensor")
# The axis sets that own a process group, in the order every rank creates them.
GROUP_AXES = (("data",), ("seq",), ("expert",), ("tensor",), AXES)

Axes = Union[str, Sequence[str]]


def _axes(axes: Axes) -> Tuple[str, ...]:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in axes:
        if a not in AXES:
            raise ValueError(f"unknown mesh axis {a!r}; the axes are {AXES}")
    return tuple(a for a in AXES if a in axes)  # canonical order


@dataclass
class Mesh:
    """Axis sizes, this rank's place and, once ``make_mesh`` has made them,
    its process groups. A mesh without groups (``Mesh(tensor=2, rank=1)``)
    describes a rank for the shard rules alone and issues no collective.
    The positional sizes are (data, expert, tensor), as the JAX package's
    ``make_mesh`` takes them; ``seq`` and the rest are keywords, since the
    rank order is (data, seq, expert, tensor)."""

    data: int = 1
    expert: int = 1
    tensor: int = 1
    _: KW_ONLY
    seq: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    groups: Dict[Tuple[str, ...], object] = field(default_factory=dict, repr=False)
    # collectives issued by kind ("all_reduce", "all_gather"), since the last reset
    counts: collections.Counter = field(default_factory=collections.Counter, repr=False)

    def __post_init__(self) -> None:
        for a in AXES:
            if getattr(self, a) < 1:
                raise ValueError(f"mesh axis {a} must be at least 1, got {getattr(self, a)}")
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} is outside a mesh of {self.size}")
        self.device = torch.device(self.device)

    @property
    def size(self) -> int:
        return self.data * self.seq * self.expert * self.tensor

    @property
    def coords(self) -> Tuple[int, int, int, int]:
        """(d, s, e, t) of this rank."""
        return coords(self.rank, self.seq, self.expert, self.tensor)

    @property
    def d(self) -> int:
        return self.coords[0]

    @property
    def s(self) -> int:
        return self.coords[1]

    @property
    def e(self) -> int:
        return self.coords[2]

    @property
    def t(self) -> int:
        return self.coords[3]

    def seq_split(self, T: int) -> bool:
        """Whether a T-token chunk is split over ``seq`` (the JAX package's
        ``seq_axis`` rule): a seq axis above 1 that divides T. A decode step
        (T = 1) never is."""
        return self.seq > 1 and T > 1 and T % self.seq == 0

    def axis_size(self, axes: Axes) -> int:
        return math.prod(getattr(self, a) for a in _axes(axes))

    def _group(self, axes: Axes):
        """The process group of ``axes``, or None where the set has one rank."""
        key = _axes(axes)
        if self.axis_size(key) == 1:
            return None
        if key not in self.groups:
            raise RuntimeError(f"this mesh has no process group for {key}: make it with "
                               "parallel.mesh.make_mesh after init_distributed")
        return self.groups[key]

    def all_reduce(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """The sum of ``x`` over the ranks of ``axes``, in ``x``'s dtype; ``x``
        itself is reduced in place and returned."""
        group = self._group(axes)
        if group is None:
            return x
        self.counts["all_reduce"] += 1
        dist.all_reduce(x, group=group)
        return x

    def all_gather(self, x: torch.Tensor, axes: Axes, dim: int) -> torch.Tensor:
        """The ranks' ``x`` over ``axes`` concatenated along ``dim``, in rank
        order: the same tensor on every rank of the group."""
        group = self._group(axes)
        if group is None:
            return x
        self.counts["all_gather"] += 1
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.axis_size(axes))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    def broadcast_object(self, obj, src: int = 0):
        """A picklable ``obj`` of mesh rank ``src``, on every rank of the
        mesh (host control, such as a request to replay; not counted)."""
        group = self._group(AXES)
        if group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=group)
        return box[0]

    def reset_counts(self) -> None:
        self.counts.clear()


def reduce(x: torch.Tensor, mesh: Optional[Mesh], axes: Axes) -> torch.Tensor:
    """``mesh.all_reduce(x, axes)``; ``x`` itself without a mesh."""
    return x if mesh is None else mesh.all_reduce(x, axes)


def gather(x: torch.Tensor, mesh: Optional[Mesh], axes: Axes, dim: int) -> torch.Tensor:
    """``mesh.all_gather(x, axes, dim)``; ``x`` itself without a mesh."""
    return x if mesh is None else mesh.all_gather(x, axes, dim)


def coords(rank: int, seq: int, expert: int, tensor: int) -> Tuple[int, int, int, int]:
    """(d, s, e, t) of ``rank`` in a mesh with these inner axis sizes."""
    return (rank // (seq * expert * tensor), rank // (expert * tensor) % seq,
            rank // tensor % expert, rank % tensor)


def _group_ranks(sizes: Dict[str, int], axes: Tuple[str, ...]) -> List[List[int]]:
    """Every group of ``axes``: the ranks that differ only along them, one
    list per setting of the other axes, in rank order."""
    groups: Dict[Tuple[int, ...], List[int]] = {}
    for r in range(math.prod(sizes.values())):
        c = dict(zip(AXES, coords(r, sizes["seq"], sizes["expert"], sizes["tensor"])))
        groups.setdefault(tuple(c[a] for a in AXES if a not in axes), []).append(r)
    return list(groups.values())


def make_mesh(
    data: int = 1,
    expert: int = 1,
    tensor: int = 1,
    *,
    seq: int = 1,
    device: Optional[Union[str, torch.device]] = None,
) -> Optional[Mesh]:
    """The mesh over the first ``data * seq * expert * tensor`` ranks of
    the initialized default process group (``distributed.init_distributed``).
    Every rank of the world must call it, with the same sizes: each creates
    every group in the same order, as ``torch.distributed`` requires. A rank
    past the mesh gets None. ``device`` defaults to the rank's device;
    ``seq`` and ``device`` are keywords (see ``Mesh``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed: call "
                           "parallel.distributed.init_distributed first")
    sizes = {"data": data, "seq": seq, "expert": expert, "tensor": tensor}
    for a, n in sizes.items():
        if n < 1:
            raise ValueError(f"mesh axis {a} must be at least 1, got {n}")
    n, world, rank = math.prod(sizes.values()), dist.get_world_size(), dist.get_rank()
    if n > world:
        raise ValueError(f"a mesh of {data} x {seq} x {expert} x {tensor} (data x seq x "
                         f"expert x tensor) needs {n} ranks, found {world}")
    groups = {}
    for axes in GROUP_AXES:
        if math.prod(sizes[a] for a in axes) == 1:
            continue
        for ranks in _group_ranks(sizes, axes):
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[axes] = g
    if rank >= n:
        return None
    if device is None:
        from mistral_inference_tpu_torch.parallel.distributed import rank_device

        device = rank_device()
    return Mesh(data, expert, tensor, seq=seq, rank=rank, device=torch.device(device),
                groups=groups)


def auto_factorize(n_devices: int, n_kv_heads: int = 8, n_experts: int = 0) -> Tuple[int, int, int]:
    """A (data, expert, tensor) factorization of ``n_devices``, as the JAX
    package picks it: tensor as large as divides ``n_kv_heads`` (TP shards
    KV heads), then expert up to ``n_experts``, the rest to data."""
    tensor = math.gcd(n_devices, n_kv_heads)
    rem = n_devices // tensor
    expert = math.gcd(rem, n_experts) if n_experts else 1
    return rem // expert, expert, tensor
