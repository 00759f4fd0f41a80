"""Decode-sized quantized linear: wrapper, launch counter and plain PyTorch
version (counterpart of ``mistral_inference_tpu/ops/pallas/matmul_quant.py``).

One hand-written CUDA kernel for Hopper (K3, ``csrc/matmul_quant.cu``) serves
both entry names: ``matmul_quant(x, q, scale)`` and ``matmul_quant_stacked(x,
q, scale, li)``, which reads layer ``li`` of an ``(L, ...)`` stack through a
pointer offset, so no layer is ever copied.

The function: ``x (M, K) @ dequant(q)`` for ``q`` int8 ``(K, N)`` or int4
packed ``(K / 2, N)`` in split-halves layout, with fp32 scales ``(K / g, N)``.
Rounding points (those of the TPU kernel): the integer weight is exact in
``x.dtype``; each group's dot is summed in fp32; the group's scale multiplies
the fp32 partial after the dot; groups are summed in fp32; one cast to
``x.dtype`` at the end.

The kernel splits the reduction by the shape alone, never by the rows. A
column shard of a weight (``parallel/sharding.py``) passes ``split_n``, the
N of the whole weight, so that its launch takes the whole weight's split and
each of its columns the bits that column has in the whole product.

``shape_ok`` is the kernel's shape rule in pure Python, K8's rule at up to
256 rows: N a multiple of 128, a group of 16 or 32 steps or a multiple of 64,
K a multiple of 64 (int4: 128, with an even group count). The wrappers check
it before a launch and raise ``ValueError`` for a shape it refuses, and the
CPU tests hold every preset's linears to it.

The wrappers launch the kernel for CUDA tensors, and for nothing else: on CPU
tensors they run ``matmul_quant_plain``. There is no fallback from a CUDA
tensor to the plain version. ``matmul_quant.launches`` counts the kernel's
launches through either entry name.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from mistral_inference_tpu_torch.ops.cuda import _call

_P, _I = _call.P, _call.I
_SIGS = {("matmul_quant", "matmul_quant_bf16"): [_P] * 4 + [_I] * 6 + [_P]}
_launch = functools.partial(_call.launch, _SIGS)
_need = _call.need

ROWS_MAX = 256  # two row blocks of 128


def group_ok(K: int, ng: int) -> bool:
    """A group of 16k steps that divides the 64-step stage or is a multiple of it."""
    if ng < 1 or K % ng:
        return False
    g = K // ng
    return g % 16 == 0 and (g % 64 == 0 or 64 % g == 0)


def weight_ok(K: int, N: int, ng: int, bits: int) -> bool:
    """Whether the loop K3 and K8 share (``csrc/dequant_mma.cuh``) takes a
    weight of K x N in ``ng`` groups: N a multiple of 128, ``group_ok``, K a
    multiple of the 64-row stage (int4: 128) and, for int4, an even group
    count (a stored row serves a group of each half)."""
    return (
        bits in (4, 8) and N > 0 and N % 128 == 0 and K > 0
        and K % (128 if bits == 4 else 64) == 0 and group_ok(K, ng)
        and (bits == 8 or ng % 2 == 0)
    )


def shape_ok(M: int, K: int, N: int, ng: int, bits: int) -> bool:
    """Whether K3 takes x (M, K) against a weight of K x N in ``ng`` groups:
    1-256 rows and a weight ``weight_ok`` takes."""
    return 0 < M <= ROWS_MAX and weight_ok(K, N, ng, bits)


def nibbles(q4: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed int4 bytes -> (low, high) signed nibbles as int32 in [-8, 7]:
    the low nibble sign-extended (``(v << 28) >> 28`` on int32, written here
    without an overflowing shift) and ``v >> 4``, arithmetic."""
    v = q4.to(torch.int32)
    return ((v & 0xF) ^ 8) - 8, v >> 4


def _weight_bits(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> Tuple[int, int, int]:
    """(bits, groups, group size) from the operands' last two dims."""
    K, stored, ng = x.shape[-1], q.shape[-2], scale.shape[-2]
    if stored == K:
        bits = 8
    elif stored * 2 == K:
        bits = 4
    else:
        raise ValueError(f"q has {stored} stored rows for K = {K}: neither int8 nor packed int4")
    if q.dtype != torch.int8:
        raise TypeError(f"q must be int8 (int4 is packed two to a byte), got {q.dtype}")
    if ng < 1 or K % ng:
        raise ValueError(f"{ng} scale groups do not divide K = {K}")
    return bits, ng, K // ng


def grouped_dot_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The grouped-dequant product written out, in fp32: x (M, K), q (K, N) or
    packed (K / 2, N), scale (ng, N) -> (M, N) fp32, before the final cast.
    One group at a time, so that no (ng, M, N) tensor exists."""
    bits, ng, g = _weight_bits(x, q, scale)
    if bits == 4:
        q = torch.cat(nibbles(q), dim=0)
    acc = torch.zeros((x.shape[0], q.shape[1]), dtype=torch.float32, device=x.device)
    for i in range(ng):
        w = q[i * g : (i + 1) * g].to(x.dtype).float()  # exact
        acc += (x[:, i * g : (i + 1) * g].float() @ w) * scale[i].float()
    return acc


def matmul_quant_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version of K3. Returns (M, N) in x.dtype."""
    return grouped_dot_plain(x, q, scale).to(x.dtype)


def _run(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, layer: int,
         split_n: Optional[int]) -> torch.Tensor:
    """Launch K3 on q (K', N) and scale (ng, N), or on layer ``layer`` of
    q (L, K', N) and scale (L, ng, N); the reduction split is that of a
    weight of ``split_n`` columns (N when None)."""
    M, K = x.shape
    stored, N = q.shape[-2:]
    lead = tuple(q.shape[:-2])
    L = lead[0] if lead else 1
    bits, ng, _ = _weight_bits(x, q, scale)
    dev = x.device
    _need(x, "x", torch.bfloat16, (M, K), dev)
    _need(q, "q", torch.int8, lead + (stored, N), dev)
    _need(scale, "scale", torch.float32, lead + (ng, N), dev)
    if not 0 <= layer < L:
        raise ValueError(f"layer index {layer} out of range for {L} layers")
    if not shape_ok(M, K, N, ng, bits):
        raise ValueError(
            "the CUDA kernel takes 1-256 rows, N % 128 == 0, a group of 16 or 32 steps or a "
            "multiple of 64, and K % 64 == 0 (int4: K % 128 == 0 and an even group count); "
            f"got M={M} K={K} N={N} groups={ng} int{bits}"
        )
    split_n = N if split_n is None else int(split_n)
    if split_n < N or split_n % 128:
        raise ValueError(f"split_n = {split_n} must be a multiple of 128 of at least N = {N}")
    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    _launch(
        "matmul_quant", "matmul_quant_bf16", dev, x.data_ptr(),
        q.data_ptr() + layer * stored * N, scale.data_ptr() + layer * ng * N * 4,
        out.data_ptr(), M, K, N, ng, bits, split_n,
    )
    matmul_quant.launches += 1
    return out


def matmul_quant(
    x: torch.Tensor,  # (M, K) bf16 on the card
    q: torch.Tensor,  # (K, N) int8 | (K / 2, N) packed int4
    scale: torch.Tensor,  # (ng, N) fp32
    split_n: Optional[int] = None,  # a shard's whole N: the split to take
) -> torch.Tensor:
    """K3. ``x @ dequant(q)`` -> (M, N) in x.dtype."""
    if q.dim() != 2 or scale.dim() != 2:
        raise ValueError("matmul_quant takes one layer's q (K', N) and scale (ng, N)")
    if not x.is_cuda:
        return matmul_quant_plain(x, q, scale)
    return _run(x, q, scale, 0, split_n)


matmul_quant.launches = 0


def matmul_quant_stacked(
    x: torch.Tensor,  # (M, K)
    q: torch.Tensor,  # (L, K, N) int8 | (L, K / 2, N) packed int4
    scale: torch.Tensor,  # (L, ng, N) fp32
    li: int,
) -> torch.Tensor:
    """K3 on layer ``li`` of a stack, read in place: ``x @ dequant(q[li])``."""
    if q.dim() != 3 or scale.dim() != 3:
        raise ValueError("matmul_quant_stacked takes q (L, K', N) and scale (L, ng, N)")
    if not x.is_cuda:
        return matmul_quant_plain(x, q[int(li)], scale[int(li)])
    return _run(x, q, scale, int(li), None)


KERNELS = (matmul_quant,)
