"""The two quantized matmuls of the MoE feed-forward: wrappers, launch
counters and plain PyTorch versions (counterpart of
``mistral_inference_tpu/ops/pallas/moe_matmul.py``). Two hand-written CUDA
kernels for Hopper, both with the grouped-dequant rounding points of
``ops/cuda/matmul_quant.py`` (fp32 dot per group, the scale after the dot,
fp32 sum over groups, one cast).

K5, ``moe_matmul_quant_ragged`` (``csrc/moe_matmul.cu``): row-tiled, a weight
per tile. Rows of ``x (Mp, K)`` come in ``n_tiles`` tiles of ``TM = Mp /
n_tiles``; tile ``t`` is multiplied by the quantized weight
``q[tile_group[t]]`` of an ``(E, ...)`` stack, or ``q[li, tile_group[t]]`` of
an ``(L, E, ...)`` stack. Dense prefill is the E = 1 case; sorted-by-expert
MoE prefill the general one. Pad rows are computed like any other row: the
caller discards them. ``tile_group`` is read on the device; the host never
waits for it.

K8, ``moe_matmul_quant`` and ``moe_matmul_quant_stacked``
(``csrc/moe_expert_matmul.cu``): per expert, its capacity buffer ``x[e] (C,
K)`` times its own weight, one launch for all experts; the MoE decode step.
The stacked name reads layer ``li`` of an ``(L, E, ...)`` stack through a
pointer offset, so no layer is ever copied. Each live expert's weight is
read once whatever C is; an expert whose rows are all zero reads none.
``moe_matmul_quant.launches`` counts the kernel's launches through either
name.

``ragged_shape_ok`` and ``expert_shape_ok`` are the kernels' shape rules in
pure Python: the wrappers check them before a launch, and the CPU tests hold
every preset's shapes to them.

The wrappers launch a kernel for CUDA tensors, and for nothing else: on CPU
tensors they run the plain versions. There is no fallback from a CUDA tensor
to a plain version.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from mistral_inference_tpu_torch.ops.cuda import _call
from mistral_inference_tpu_torch.ops.cuda.matmul_quant import (
    _weight_bits,
    group_ok,
    grouped_dot_plain,
    weight_ok,
)

_P, _I = _call.P, _call.I
_SIGS = {
    ("moe_matmul", "moe_matmul_quant_ragged_bf16"): [_P] * 5 + [_I] * 8 + [_P],
    ("moe_expert_matmul", "moe_matmul_quant_bf16"): [_P] * 4 + [_I] * 6 + [_P],
}
_launch = functools.partial(_call.launch, _SIGS)
_need = _call.need

EXPERT_ROWS_MAX = 128  # K8's largest capacity


def ragged_shape_ok(Mp: int, n_tiles: int, K: int, N: int, ng: int, bits: int) -> bool:
    """Whether K5 takes x (Mp, K) in ``n_tiles`` row tiles against a weight of
    K x N in ``ng`` groups: row tiles a multiple of the block's 128 rows, N of
    its 128 columns, K of the 64-step stage (int4: each half of it)."""
    return (
        bits in (4, 8) and Mp > 0 and n_tiles > 0 and Mp % n_tiles == 0
        and (Mp // n_tiles) % 128 == 0 and N > 0 and N % 128 == 0 and N // 128 <= 65535
        and K % (128 if bits == 4 else 64) == 0 and group_ok(K, ng)
    )


def expert_shape_ok(C: int, K: int, N: int, ng: int, bits: int) -> bool:
    """Whether K8 takes capacity buffers of C rows against weights of K x N in
    ``ng`` groups: at most 128 rows and a weight the loop it shares with K3
    takes (``matmul_quant.weight_ok``)."""
    return 0 < C <= EXPERT_ROWS_MAX and weight_ok(K, N, ng, bits)


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
    if not ragged_shape_ok(Mp, n_tiles, K, N, ng, bits):
        raise ValueError(
            "the CUDA kernel takes row tiles that are multiples of 128, N % 128 == 0, "
            "K % 64 == 0 (int4: 128) and a group size of 16, 32 or a multiple of 64; "
            f"got Mp={Mp} tiles={n_tiles} K={K} N={N} group={g} int{bits}"
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


def moe_matmul_quant_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: one grouped-dequant product per expert, empty
    slots included. x (E, C, K), q (E, K', N), scale (E, ng, N) -> (E, C, N)
    in x.dtype."""
    return torch.stack(
        [grouped_dot_plain(x[e], q[e], scale[e]) for e in range(x.shape[0])]
    ).to(x.dtype)


def _run_experts(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, layer: int) -> torch.Tensor:
    """Launch K8 on q (E, K', N) and scale (E, ng, N), or on layer ``layer``
    of q (L, E, K', N) and scale (L, E, ng, N)."""
    E, C, K = x.shape
    stored, N = q.shape[-2:]
    lead = tuple(q.shape[:-3])
    L = lead[0] if lead else 1
    bits, ng, _ = _weight_bits(x, q, scale)
    dev = x.device
    _need(x, "x", torch.bfloat16, (E, C, K), dev)
    _need(q, "q", torch.int8, lead + (E, stored, N), dev)
    _need(scale, "scale", torch.float32, lead + (E, ng, N), dev)
    if not 0 <= layer < L:
        raise ValueError(f"layer index {layer} out of range for {L} layers")
    if not expert_shape_ok(C, K, N, ng, bits) or E > 65535:
        raise ValueError(
            "the CUDA kernel takes C <= 128, N % 128 == 0, K % 64 == 0 (int4: 128, with an "
            "even group count) and a group size of 16, 32 or a multiple of 64; got "
            f"E={E} C={C} K={K} N={N} groups={ng} int{bits}"
        )
    out = torch.empty((E, C, N), dtype=torch.bfloat16, device=dev)
    _launch(
        "moe_expert_matmul", "moe_matmul_quant_bf16", dev, x.data_ptr(),
        q.data_ptr() + layer * E * stored * N, scale.data_ptr() + layer * E * ng * N * 4,
        out.data_ptr(), E, C, K, N, ng, bits,
    )
    moe_matmul_quant.launches += 1
    return out


def moe_matmul_quant(
    x: torch.Tensor,  # (E, C, K) bf16 on the card: the experts' capacity buffers
    q: torch.Tensor,  # (E, K, N) int8 | (E, K / 2, N) packed int4
    scale: torch.Tensor,  # (E, ng, N) fp32
) -> torch.Tensor:
    """K8. ``x[e] @ dequant(q[e])`` for every expert -> (E, C, N) in x.dtype."""
    if x.dim() != 3 or q.dim() != 3 or scale.dim() != 3:
        raise ValueError("moe_matmul_quant takes x (E, C, K), q (E, K', N) and scale (E, ng, N)")
    if not x.is_cuda:
        return moe_matmul_quant_plain(x, q, scale)
    return _run_experts(x, q, scale, 0)


moe_matmul_quant.launches = 0


def moe_matmul_quant_stacked(
    x: torch.Tensor,  # (E, C, K)
    q: torch.Tensor,  # (L, E, K, N) int8 | (L, E, K / 2, N) packed int4
    scale: torch.Tensor,  # (L, E, ng, N) fp32
    li: int,
) -> torch.Tensor:
    """K8 on layer ``li`` of a stack, read in place: ``x[e] @ dequant(q[li, e])``."""
    if x.dim() != 3 or q.dim() != 4 or scale.dim() != 4:
        raise ValueError(
            "moe_matmul_quant_stacked takes x (E, C, K), q (L, E, K', N) and scale (L, E, ng, N)"
        )
    if not x.is_cuda:
        return moe_matmul_quant_plain(x, q[int(li)], scale[int(li)])
    return _run_experts(x, q, scale, int(li))


KERNELS = (moe_matmul_quant_ragged, moe_matmul_quant)
