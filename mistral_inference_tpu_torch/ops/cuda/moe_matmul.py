"""Row-tiled quantized matmul with a weight per tile: wrapper, launch counter
and plain PyTorch version (counterpart of
``mistral_inference_tpu/ops/pallas/moe_matmul.py::moe_matmul_quant_ragged``).

One hand-written CUDA kernel for Hopper (K5, ``csrc/moe_matmul.cu``). Rows of
``x (Mp, K)`` come in ``n_tiles`` tiles of ``TM = Mp / n_tiles``; tile ``t``
is multiplied by the quantized weight ``q[tile_group[t]]`` of an ``(E, ...)``
stack, or ``q[li, tile_group[t]]`` of an ``(L, E, ...)`` stack, with the
grouped-dequant rounding points of ``ops/cuda/matmul_quant.py`` (fp32 dot per
group, the scale after the dot, fp32 sum over groups, one cast). Dense
prefill is the E = 1 case; sorted-by-expert MoE prefill the general one. Pad
rows are computed like any other row: the caller discards them.

``tile_group`` is read on the device; the host never waits for it. The
wrapper launches the kernel for CUDA tensors, and for nothing else: on CPU
tensors it runs ``moe_matmul_quant_ragged_plain``. There is no fallback from
a CUDA tensor to the plain version.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from mistral_inference_tpu_torch.ops.cuda import _call
from mistral_inference_tpu_torch.ops.cuda.matmul_quant import _weight_bits, grouped_dot_plain

_P, _I = _call.P, _call.I
_SIGS = {
    ("moe_matmul", "moe_matmul_quant_ragged_bf16"): [_P] * 5 + [_I] * 8 + [_P],
}
_launch = functools.partial(_call.launch, _SIGS)
_need = _call.need


def moe_matmul_quant_ragged_plain(
    x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, tile_group: torch.Tensor,
    li: Optional[int] = None,
) -> torch.Tensor:
    """Plain version of K5: one grouped-dequant product per row tile, pad
    rows included. Returns (Mp, N) in x.dtype."""
    if li is not None:
        q, scale = q[int(li)], scale[int(li)]
    n_tiles = tile_group.shape[0]
    TM = x.shape[0] // n_tiles
    if TM * n_tiles != x.shape[0]:
        raise ValueError(f"{n_tiles} tiles do not divide {x.shape[0]} rows")
    out = torch.empty((x.shape[0], scale.shape[-1]), dtype=x.dtype, device=x.device)
    for t, e in enumerate(tile_group.tolist()):
        rows = slice(t * TM, (t + 1) * TM)
        out[rows] = grouped_dot_plain(x[rows], q[e], scale[e]).to(x.dtype)
    return out


def moe_matmul_quant_ragged(
    x: torch.Tensor,  # (Mp, K) bf16 on the card, rows sorted by weight, padded to tiles
    q: torch.Tensor,  # (E, K, N) int8 | (E, K / 2, N) packed int4, or (L, E, ...) with li
    scale: torch.Tensor,  # (E, ng, N) fp32, or (L, E, ng, N)
    tile_group: torch.Tensor,  # (Mp / TM,) int32: the weight of each row tile
    li: Optional[int] = None,
) -> torch.Tensor:
    """K5. Returns (Mp, N) in x.dtype."""
    if q.dim() != (3 if li is None else 4) or scale.dim() != q.dim():
        raise ValueError("q and scale must be (E, ...) stacks, or (L, E, ...) stacks with li")
    if not x.is_cuda:
        return moe_matmul_quant_ragged_plain(x, q, scale, tile_group, li)
    Mp, K = x.shape
    E, stored, N = q.shape[-3:]
    lead = tuple(q.shape[:-3])
    bits, ng, g = _weight_bits(x, q, scale)
    n_tiles = tile_group.shape[0]
    dev = x.device
    _need(x, "x", torch.bfloat16, (Mp, K), dev)
    _need(q, "q", torch.int8, lead + (E, stored, N), dev)
    _need(scale, "scale", torch.float32, lead + (E, ng, N), dev)
    if tile_group.dtype != torch.int32 or tile_group.device != dev or not tile_group.is_contiguous():
        raise TypeError("tile_group must be a contiguous int32 tensor on x's device")
    layer = 0 if li is None else int(li)
    if not 0 <= layer < (lead[0] if lead else 1):
        raise ValueError(f"layer index {li} out of range")
    bk = min(g, 64)
    if (
        n_tiles < 1 or Mp % n_tiles or (Mp // n_tiles) % 128 or N % 64 or K % 8
        or g % 16 or g % bk or 64 % bk or (bits == 4 and (K // 2) % bk)
    ):
        raise ValueError(
            "the CUDA kernel takes row tiles that are multiples of 128, N % 64 == 0 and a "
            f"group size of 16, 32 or a multiple of 64; got Mp={Mp} tiles={n_tiles} K={K} "
            f"N={N} group={g}"
        )
    out = torch.empty((Mp, N), dtype=torch.bfloat16, device=dev)
    _launch(
        "moe_matmul", "moe_matmul_quant_ragged_bf16", dev, x.data_ptr(), q.data_ptr(),
        scale.data_ptr(), tile_group.data_ptr(), out.data_ptr(), Mp, K, N, ng, bits, n_tiles,
        E, layer,
    )
    moe_matmul_quant_ragged.launches += 1
    return out


moe_matmul_quant_ragged.launches = 0

KERNELS = (moe_matmul_quant_ragged,)
