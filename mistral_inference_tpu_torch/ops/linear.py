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

Under a mesh a rank may hold fewer rows than one device would (its data
rows, its seq run of a chunk). ``rows`` is then one device's row count, by
which the product is routed, so that a token takes the kernel it takes on
one device: a K5 launch pads the rank's rows to whole 256-row tiles, whose
rows it computes like any other. A column shard's leaf carries
``"n_whole"``, the whole weight's N, which K3 takes its reduction split
from. The cuBLAS routes (a plain weight, ``x @ dequant(w)``) run at the
rank's own row count: under ``data`` or ``seq`` they give one device's
bits only where cuBLAS rounds a row alike at both counts, which is not
guaranteed. ``fixed_rows_linear`` is a plain product whose row bits are
guaranteed: one cuBLAS call per block of ``ROW_BLOCK`` rows (Mamba's
``dt_proj`` and head).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
import torch.nn.functional as F

from mistral_inference_tpu_torch.ops.cuda.matmul_quant import (
    matmul_quant,
    matmul_quant_stacked,
    nibbles,
)
from mistral_inference_tpu_torch.ops.cuda.moe_matmul import moe_matmul_quant_ragged
from mistral_inference_tpu_torch.utils import profiling
from mistral_inference_tpu_torch.utils.profiling import METRICS

QuantWeight = Dict[str, torch.Tensor]
Weight = Union[torch.Tensor, QuantWeight]

DEFAULT_GROUP = 128
DECODE_ROWS_MAX = 256  # K3 up to here
PREFILL_TILE_ROWS = 256  # K5's row tile on the dense path
DEQUANT_ROWS_MIN = 8192  # from here a materialized weight and one product
ROW_BLOCK = 128  # rows per cuBLAS call of fixed_rows_linear: a decode step's in one

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


def fixed_rows_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``F.linear(x, w)`` for a plain weight, each row's bits a function of
    that row and ``w`` alone. The rows, zero-padded to whole blocks of
    ``ROW_BLOCK``, go through one ``F.linear`` a block: every call has one
    (M, N, K) and so takes one cuBLAS kernel, whatever the row count and
    wherever the row sits. One batched product would not do: cuBLAS may pick
    its kernel by the batch count."""
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    n = x2.shape[0]
    pad = -n % ROW_BLOCK
    if pad:
        x2 = F.pad(x2, (0, 0, 0, pad))
    out = torch.cat([F.linear(x2[i:i + ROW_BLOCK], w) for i in range(0, max(n, 1), ROW_BLOCK)])
    return out[:n].reshape(*x.shape[:-1], w.shape[0])


def linear(x: torch.Tensor, w: Weight, rows: Optional[int] = None) -> torch.Tensor:
    """``x`` (..., in) times a plain weight (out, in) or a quantized leaf,
    the product routed as one of ``rows`` rows (``x``'s own when None).
    While the tracing switch is on, the call is the span ``ops.linear``: K,
    N, bits, group, rows (the route's) and route (K3, K5, dequant or
    plain)."""
    if profiling.TRACING:
        with METRICS.span("ops.linear", **_linear_attrs(x, w, rows)):
            return _linear(x, w, rows)
    return _linear(x, w, rows)


def _route(rows: int, N: int, K: int) -> str:
    """The kernel a quantized product of ``rows`` rows goes to."""
    if rows <= DECODE_ROWS_MAX and N % 128 == 0 and K % 128 == 0:
        return "K3"
    if (DECODE_ROWS_MAX < rows < DEQUANT_ROWS_MIN and rows % PREFILL_TILE_ROWS == 0
            and N % 128 == 0 and K % 256 == 0):
        return "K5"
    return "dequant"


def rows_alike(w: QuantWeight, row_counts: Sequence[int]) -> bool:
    """Whether the quantized product ``w`` gives a row the same bits at each
    of ``row_counts`` rows: one route at every count, and a hand-written
    kernel's (K3 or K5, neither of which splits a reduction by the rows);
    ``dequant`` is a cuBLAS product, whose kernel the row count picks."""
    K = w["q"].shape[-2] if "q" in w else 2 * w["q4"].shape[-2]
    routes = {_route(n, w["scale"].shape[-1], K) for n in row_counts}
    return len(routes) == 1 and "dequant" not in routes


def _linear_attrs(x: torch.Tensor, w: Weight, rows: Optional[int]) -> Dict[str, object]:
    K = x.shape[-1]
    n = x.numel() // K if rows is None else rows
    if not is_quantized(w):
        return dict(K=K, N=w.shape[0], bits=8 * w.element_size(), group=0, rows=n, route="plain")
    N = w["scale"].shape[-1]
    return dict(K=K, N=N, bits=4 if "q4" in w else 8, group=K // w["scale"].shape[-2], rows=n,
                route=_route(n, N, K))


def _linear(x: torch.Tensor, w: Weight, rows: Optional[int]) -> torch.Tensor:
    if not is_quantized(w):
        return F.linear(x, w)
    K = x.shape[-1]
    scale = w["scale"]
    N = scale.shape[-1]
    n = x.numel() // K
    route = _route(n if rows is None else rows, N, K)
    q = w["q4"] if "q4" in w else w["q"]
    li = w.get("li")
    if route == "K3":
        x2 = x.reshape(n, K)
        out = (matmul_quant(x2, q, scale, w.get("n_whole")) if li is None
               else matmul_quant_stacked(x2, q, scale, li))
    elif route == "K5":
        tiles = -(-n // PREFILL_TILE_ROWS)
        x2 = x.reshape(n, K)
        if tiles * PREFILL_TILE_ROWS != n:  # a rank's share of the rows: whole tiles
            x2 = F.pad(x2, (0, 0, 0, tiles * PREFILL_TILE_ROWS - n))
        if li is None:
            out = moe_matmul_quant_ragged(x2, q[None], scale[None], _zero_tiles(tiles, x.device))
        else:
            # A dense (L, K', N) layer stack is the kernel's weight axis: a
            # tile_group filled with the layer index selects layer li.
            tg = torch.full((tiles,), int(li), dtype=torch.int32, device=x.device)
            out = moe_matmul_quant_ragged(x2, q, scale, tg)
        out = out[:n]
    else:
        return x @ dequant(w, x.dtype)
    return out.reshape(*x.shape[:-1], N)
