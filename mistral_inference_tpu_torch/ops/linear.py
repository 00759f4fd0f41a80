"""Quantized-weight linear application: int8 and packed int4, weight-only
(counterpart of ``mistral_inference_tpu/ops/linear.py``).

A quantized weight is a dict leaf of the params tree, in the JAX package's
format byte for byte, so that one stacked export loads in both packages:

    int8: {"q":  int8 (..., in,     out), "scale": fp32 (..., groups, out)}
    int4: {"q4": int8 (..., in / 2, out), "scale": fp32 (..., groups, out)}

Grouped symmetric quantization along the reduction axis ``in`` (group size
``g``), no zero points. int4 packs two signed nibbles per byte in
split-halves layout: byte row r holds element r in its low nibble and
element r + in / 2 in its high nibble, so unpacking is a concatenation along
``in``. The key name carries the packing. A leaf may hold a whole ``(L, ...)``
stack plus ``"li"``, the layer to use.

A plain (unquantized) weight of this port is a tensor ``(out, in)`` applied
with ``F.linear``; a quantized one is ``(in, out)`` as above.

``linear`` routes a quantized product by its shape alone, as the JAX package
does on its accelerator, to the hand-written CUDA kernels of ``ops/cuda``
(which run their plain versions on CPU tensors, so the CPU tests run the
decomposition the card runs):

* rows <= 256: ``matmul_quant`` (K3), every decode-step linear;
* 256 < rows < 8192 in multiples of 256: ``moe_matmul_quant_ragged`` (K5) as
  its one-weight case, every mid-band prefill linear;
* anything else: ``x @ dequant(w)``, a plain matrix product on a
  materialized weight, which the JAX package too leaves to its compiler.
"""

from __future__ import annotations

from typing import Dict, Union

import torch
import torch.nn.functional as F

from mistral_inference_tpu_torch.ops.cuda.matmul_quant import (
    matmul_quant,
    matmul_quant_stacked,
    nibbles,
)
from mistral_inference_tpu_torch.ops.cuda.moe_matmul import moe_matmul_quant_ragged

QuantWeight = Dict[str, torch.Tensor]
Weight = Union[torch.Tensor, QuantWeight]

DEFAULT_GROUP = 128
DECODE_ROWS_MAX = 256  # K3 up to here
PREFILL_TILE_ROWS = 256  # K5's row tile on the dense path
DEQUANT_ROWS_MIN = 8192  # from here a materialized weight and one product

# (tiles, device) -> tile_group of zeros for K5's one-weight case
_ZERO_TILES: Dict[tuple, torch.Tensor] = {}


def is_quantized(w: Weight) -> bool:
    return isinstance(w, dict) and ("q" in w or "q4" in w)


def quantize_weight(w: torch.Tensor, bits: int, group: int = DEFAULT_GROUP) -> QuantWeight:
    """(..., in, out) float -> grouped symmetric int8 or packed int4 with fp32
    scales (..., in / g, out), g = min(group, in)."""
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    *lead, K, N = w.shape
    g = min(group, K)
    if K % g or (bits == 4 and K % 2):
        raise ValueError(f"in = {K} is not a multiple of the group {g} (or is odd for int4)")
    ng = K // g
    # Contiguous even for a transposed view, so that the stored bytes come out
    # (in, out) row-major, N-minor, as the kernels read them.
    wf = w.contiguous().float().reshape(*lead, ng, g, N)
    qmax = 127.0 if bits == 8 else 7.0
    absmax = wf.abs().amax(dim=-2, keepdim=True)  # (..., ng, 1, N)
    # Divide by a tensor, not a Python number: on CUDA, PyTorch turns division
    # by a host scalar into a multiply by its reciprocal, which is not IEEE
    # division and changes a few scales in their last bit.
    scale = (absmax / torch.full_like(absmax, qmax)).clamp_min(1e-8)
    q = torch.round(wf / scale).clamp(-qmax, qmax).to(torch.int8).reshape(*lead, K, N)
    scale = scale[..., 0, :]
    if bits == 4:
        half = K // 2
        lo, hi = q[..., :half, :].to(torch.int32), q[..., half:, :].to(torch.int32)
        # hi << 4 lies in [-128, 112] and the low nibble in [0, 15]: their
        # union fits int8 exactly.
        return {"q4": ((lo & 0x0F) | (hi << 4)).to(torch.int8), "scale": scale}
    return {"q": q, "scale": scale}


def _unpack_int4(q: torch.Tensor) -> torch.Tensor:
    """(..., K / 2, N) split-halves packed -> (..., K, N) int8 in [-8, 7]."""
    return torch.cat(nibbles(q), dim=-2).to(torch.int8)


def dequant(w: Weight, dtype: torch.dtype) -> torch.Tensor:
    """A quantized weight as a dense (..., in, out) tensor in ``dtype`` (the
    fp32 product of integer and scale, rounded once). A plain weight is
    returned cast, in its own (out, in) layout."""
    if not is_quantized(w):
        return w.to(dtype)
    if "li" in w:  # layer-stacked leaf: take this layer first
        w = {k: v[int(w["li"])] for k, v in w.items() if k != "li"}
    q = _unpack_int4(w["q4"]) if "q4" in w else w["q"]
    *lead, K, N = q.shape
    ng = w["scale"].shape[-2]
    deq = q.reshape(*lead, ng, K // ng, N).float() * w["scale"][..., :, None, :]
    return deq.reshape(*lead, K, N).to(dtype)


def _zero_tiles(n: int, device: torch.device) -> torch.Tensor:
    tg = _ZERO_TILES.get((n, device))
    if tg is None:
        tg = torch.zeros((n,), dtype=torch.int32, device=device)
        _ZERO_TILES[(n, device)] = tg
    return tg


def linear(x: torch.Tensor, w: Weight) -> torch.Tensor:
    """``x`` (..., in) times a plain weight (out, in) or a quantized leaf."""
    if not is_quantized(w):
        return F.linear(x, w)
    K = x.shape[-1]
    scale = w["scale"]
    N = scale.shape[-1]
    rows = x.numel() // K
    q = w["q4"] if "q4" in w else w["q"]
    li = w.get("li")
    if rows <= DECODE_ROWS_MAX and N % 128 == 0 and K % 128 == 0:
        x2 = x.reshape(rows, K)
        out = matmul_quant(x2, q, scale) if li is None else matmul_quant_stacked(x2, q, scale, li)
    elif (
        DECODE_ROWS_MAX < rows < DEQUANT_ROWS_MIN and rows % PREFILL_TILE_ROWS == 0
        and N % 128 == 0 and K % 256 == 0
    ):
        tiles = rows // PREFILL_TILE_ROWS
        if li is None:
            out = moe_matmul_quant_ragged(
                x.reshape(rows, K), q[None], scale[None], _zero_tiles(tiles, x.device)
            )
        else:
            # A dense (L, K', N) layer stack is the kernel's weight axis: a
            # tile_group filled with the layer index selects layer li.
            tg = torch.full((tiles,), int(li), dtype=torch.int32, device=x.device)
            out = moe_matmul_quant_ragged(x.reshape(rows, K), q, scale, tg)
    else:
        return x @ dequant(w, x.dtype)
    return out.reshape(*x.shape[:-1], N)
