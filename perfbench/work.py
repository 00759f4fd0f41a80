"""The yardstick's arithmetic: the card's published peaks, and the operations
and bytes each measured call needs, counted from the model's shapes and the
traffic (the rows and ring fills of the forward the call belongs to), never
from a kernel's launch arguments. So a later kernel under the same call is
read against the same work.

Bytes count each input read once and each output written once; operations
count 2 per multiply-add. Weight bytes are the stored integers plus their
fp32 group scales; activations are in the model dtype (2 bytes).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

from perfbench.weights import Dims

ACT = 2  # bytes of an activation (bf16)


@dataclass(frozen=True)
class Peaks:
    """A card's data-sheet peaks: dense bf16 tensor-core rate and HBM bandwidth."""

    name: str
    bf16_flops: float
    hbm_bytes_per_s: float
    power_w: float


# NVIDIA H100 Tensor Core GPU data sheet, SXM part, dense (no sparsity), at 700 W.
PEAKS = {"NVIDIA H100 80GB HBM3": Peaks("H100 SXM", 989e12, 3.35e12, 700.0)}


def peaks_for(device_name: str) -> Peaks:
    """The entry whose key is the longest prefix of ``device_name``; a card
    the table lacks raises, never a default."""
    best = max((k for k in PEAKS if device_name.startswith(k)), key=len, default=None)
    if best is None:
        raise KeyError(f"no published peaks for {device_name!r}")
    return PEAKS[best]


def least_seconds(flops: float, nbytes: float, p: Peaks) -> float:
    """The least time the card needs: the larger of its two bounds."""
    return max(flops / p.bf16_flops, nbytes / p.hbm_bytes_per_s)


def weight_bytes(K: int, N: int, bits: int, group: int) -> float:
    return K * N * bits / 8 + (K // min(group, K)) * N * 4


def linear_work(K: int, N: int, bits: int, group: int, rows: int) -> Tuple[float, float]:
    """A quantized (K -> N) product over ``rows`` rows."""
    return 2.0 * rows * K * N, weight_bytes(K, N, bits, group) + rows * (K + N) * ACT


def _ring_elem(d: Dims) -> Tuple[float, float]:
    """(bytes an element of the ring, bytes of scales per token and KV head)."""
    return (1.0, 4.0) if d.kv_quant in ("fp8", "int8") else (float(ACT), 0.0)


def _window(d: Dims, span: int) -> int:
    return min(d.window, span) if d.window else span


def attn_decode_work(d: Dims, fills: Sequence[int], span: int) -> Tuple[float, float]:
    """One layer's decode attention for the live rows whose ring held
    ``fills`` tokens before the step: each writes its token, then reads its
    visible slots (the new one included); operations 4 H Dh a slot."""
    W = _window(d, span)
    e, s = _ring_elem(d)
    Hq, Hkv, Dh = d.n_heads, d.n_kv_heads, d.head_dim
    slot = Hkv * (2 * Dh * e + 2 * s)  # K and V of one token with their scales
    flops = nbytes = 0.0
    for L in fills:
        vis = min(L + 1, W)
        flops += 4.0 * Hq * Dh * vis
        # q in, out, the new K/V in, its ring write, the visible slots read
        nbytes += 2 * Hq * Dh * ACT + 2 * Hkv * Dh * ACT + slot + vis * slot
    return flops, nbytes


def attn_prefill_work(d: Dims, chunks: Sequence[Tuple[int, int]], span: int) -> Tuple[float, float]:
    """One layer's attention for prefill rows, each (fill before, tokens in
    the chunk): the chunk's queries over the ring's visible slots and over
    the chunk itself, and the chunk's ring write."""
    W = _window(d, span)
    e, s = _ring_elem(d)
    Hq, Hkv, Dh = d.n_heads, d.n_kv_heads, d.head_dim
    slot = Hkv * (2 * Dh * e + 2 * s)
    flops = nbytes = 0.0
    for L0, n in chunks:
        if n <= 0:
            continue
        # sum over t < n of min(L0 + t + 1, W) visible keys
        full = max(0, min(n, L0 + n - W + 1))  # queries that see a whole window
        part = n - full
        vis = full * W + part * (L0 + 1) + part * (part - 1) / 2
        flops += 4.0 * Hq * Dh * vis
        ring_read = min(L0, W - 1)
        nbytes += (2 * n * Hq * Dh * ACT + 2 * n * Hkv * Dh * ACT
                   + ring_read * slot + min(n, W) * slot)
    return flops, nbytes


def expert_bytes(d: Dims) -> float:
    """One expert's stored w1 | w3 and w2."""
    D, F = d.dim, d.hidden
    return weight_bytes(D, 2 * F, d.quant_bits, d.group) + weight_bytes(F, D, d.quant_bits, d.group)


def moe_work(d: Dims, rows: int, experts_used: int) -> Tuple[float, float]:
    """The routed feed-forward over ``rows`` real rows whose top-k choices
    fall on ``experts_used`` experts: those experts' bytes, the rows in and
    out and their hidden activations out of w13 and into w2."""
    D, F, k = d.dim, d.hidden, d.top_k
    flops = 2.0 * rows * k * (D * 2 * F + F * D)
    nbytes = experts_used * expert_bytes(d) + rows * 2 * D * ACT + rows * k * 3 * F * ACT
    return flops, nbytes


def layer_params(d: Dims) -> float:
    """Parameters a token passes through in one layer: attention, and the
    dense feed-forward or the router and top-k experts."""
    D, F = d.dim, d.hidden
    attn = D * (d.n_heads + 2 * d.n_kv_heads) * d.head_dim + d.n_heads * d.head_dim * D
    ffn = d.experts * D + d.top_k * 3 * D * F if d.experts else 3 * D * F
    return attn + ffn


def decode_forward_flops(d: Dims, fills: Sequence[int], span: int) -> float:
    """A decode forward's model operations for its live rows: every layer's
    parameters and attention, and the head."""
    rows = len(fills)
    attn = attn_decode_work(d, fills, span)[0]
    return 2.0 * rows * (d.n_layers * layer_params(d) + d.vocab * d.dim) + d.n_layers * attn


def prefill_forward_flops(d: Dims, chunks: Sequence[Tuple[int, int]], span: int) -> float:
    """A prefill chunk's model operations over its real tokens (the head
    runs outside the forward, on one position a row, and is not counted)."""
    tokens = sum(n for _, n in chunks)
    return 2.0 * tokens * d.n_layers * layer_params(d) + d.n_layers * attn_prefill_work(
        d, chunks, span)[0]

