"""Dense decoder-only Transformer (Mistral-7B family), counterpart of
``mistral_inference_tpu/models/transformer.py``.

Parameters are a plain dict of tensors with a list of per-layer dicts; a
linear weight is stored (out_features, in_features) and applied with
``F.linear`` (cuBLAS), or is a quantized leaf of ``ops/linear.py`` (int8 or
packed int4, (in, out) with group scales) applied through that module's
CUDA kernels. Projections that read the same input share one weight and one
product: ``wqkv`` stacks wq, wk and wv, and ``w13`` stacks w1 and w3, since
the host's time per call, not the card, bounds a decode step. The layer
stack is a Python loop. Attention goes through the CUDA kernels of
``ops/cuda/attention.py``, chosen by shape alone:

* first prefill chunk (empty ring): ``flash_attention`` over the chunk;
* later chunks: ``ring_attention_stats`` over the stored ring,
  ``flash_attention(return_stats=True)`` over the chunk, and
  ``merge_attention_parts``;
* decode (T == 1): ``fused_update_decode_attention``, which writes the ring
  and attends ring-only; or, with ``FUSED_DECODE`` off, ``update_stacked``
  and then ``decode_attention``, the read-only kernel.

On CPU tensors the same names run their plain versions, so the CPU tests run
the decomposition the card runs.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from mistral_inference_tpu_torch.args import TransformerArgs
from mistral_inference_tpu_torch.cache import (
    KVCache,
    kv_roundtrip,
    ring_writes,
    slot_positions,
    update_stacked,
)
from mistral_inference_tpu_torch.ops.cuda.attention import (
    decode_attention,
    flash_attention,
    fused_update_decode_attention,
    merge_attention_parts,
    ring_attention_stats,
)
from mistral_inference_tpu_torch.ops.linear import is_quantized, linear
from mistral_inference_tpu_torch.ops.norm import rms_norm
from mistral_inference_tpu_torch.ops.rope import apply_rope, rope_for_positions

Params = Dict[str, Any]

DEFAULT_ROPE_THETA = 1e6

# Decode (T == 1) route, counterpart of the JAX package's fused-decode switch:
# True sends a step through the fused write-and-attend kernel (K2); False
# writes the ring with ``update_stacked`` and attends with the read-only
# ``decode_attention`` (K6). Both leave the same ring bytes.
FUSED_DECODE = True


def init_params(
    args: TransformerArgs,
    dtype: torch.dtype,
    generator: torch.Generator,
    device: torch.device,
) -> Params:
    """Random weights with the JAX package's distributions: linear weights
    N(0, 1) / sqrt(fan_in), embeddings N(0, 1), norms 1. Generated directly
    in ``dtype`` on ``device`` (no fp32 copy of a 7B model)."""
    D, Dh, F_ = args.dim, args.head_dim, args.hidden_dim
    H, Hkv, V = args.n_heads, args.n_kv_heads, args.vocab_size

    def lin(out_f: int, in_f: int) -> torch.Tensor:
        w = torch.randn((out_f, in_f), generator=generator, dtype=dtype, device=device)
        return w.mul_(in_f**-0.5)

    def ones(n: int) -> torch.Tensor:
        return torch.ones((n,), dtype=dtype, device=device)

    layers = [
        {
            "attention_norm": ones(D),
            "ffn_norm": ones(D),
            "wqkv": lin((H + 2 * Hkv) * Dh, D),  # wq, wk, wv stacked on out
            "wo": lin(D, H * Dh),
            "w13": lin(2 * F_, D),  # w1, w3 stacked on out
            "w2": lin(D, F_),
        }
        for _ in range(args.n_layers)
    ]
    return {
        "tok_embeddings": torch.randn((V, D), generator=generator, dtype=dtype, device=device),
        "layers": layers,
        "norm": ones(D),
        "output": lin(V, D),
    }


def _dense_ffn(x: torch.Tensor, w: Params) -> torch.Tensor:
    """SwiGLU: w2(silu(w1 x) * w3 x)."""
    gate, up = linear(x, w["w13"]).chunk(2, dim=-1)
    return linear(F.silu(gate) * up, w["w2"])


class RingInputs(NamedTuple):
    """What attention needs to know of one window's ring for this chunk. It
    is the same for every layer of that window, so ``forward`` makes it once
    per window, not once per layer."""

    write_slot: Optional[torch.Tensor]  # fused decode: (B,) int32 slot, -1 = none
    # prefill and non-fused decode: cache.ring_writes
    writes: Optional[Tuple[torch.Tensor, ...]]
    # (B, W) position and validity of each slot: after a decode step's write,
    # before a prefill chunk's; None for the first chunk, which attends to
    # itself alone.
    slot_pos: Optional[torch.Tensor]
    slot_valid: Optional[torch.Tensor]


def _ring_inputs(
    window: int,
    W: int,
    positions: torch.Tensor,  # (B, T) int32
    token_valid: torch.Tensor,  # (B, T) bool
    kv_len: torch.Tensor,  # (B,) fill before this chunk
    new_total: torch.Tensor,  # (B,) fill after it
    attend_cache: bool,
) -> RingInputs:
    """RingInputs of one window: a decode step (T == 1 over the ring) gets
    its write slot (fused route) or write plan (non-fused route) and the
    ring's state after the write; a prefill chunk its write plan."""
    if attend_cache and positions.shape[1] == 1:
        after = slot_positions(new_total, window, W)
        if not FUSED_DECODE:
            return RingInputs(
                None, ring_writes(positions, token_valid, new_total, window), *after
            )
        pos = positions[:, 0]
        should = token_valid[:, 0] & (pos >= new_total - window)
        write_slot = torch.where(should, pos % window, -1).to(torch.int32)
        return RingInputs(write_slot, None, *after)
    writes = ring_writes(positions, token_valid, new_total, window)
    if not attend_cache:
        return RingInputs(None, writes, None, None)
    return RingInputs(None, writes, *slot_positions(kv_len, window, W))


def _attention_block(
    h: torch.Tensor,  # (B, T, D), normed
    w: Params,
    cache: KVCache,
    li: int,
    positions: torch.Tensor,  # (B, T) int32
    token_valid: torch.Tensor,  # (B, T) bool
    rope_cs: Tuple[torch.Tensor, torch.Tensor],
    ring: RingInputs,
    args: TransformerArgs,
) -> torch.Tensor:
    """One layer's attention; writes this chunk's K/V into layer ``li`` of
    the ring in place."""
    B, T, _ = h.shape
    H, Hkv, Dh = args.n_heads, args.n_kv_heads, args.head_dim
    window = cache.windows[li]
    CK, CV, KS, VS = cache.k, cache.v, cache.k_scale, cache.v_scale
    scaled = KS is not None

    cos, sin = rope_cs
    xq, xk, xv = linear(h, w["wqkv"]).split([H * Dh, Hkv * Dh, Hkv * Dh], dim=-1)
    xq = apply_rope(xq.view(B, T, H, Dh), cos, sin)
    xk = apply_rope(xk.view(B, T, Hkv, Dh), cos, sin)
    xv = xv.reshape(B, T, Hkv, Dh).contiguous()

    if ring.write_slot is not None:
        # Decode: write the ring first, then attend ring-only. Safe for T == 1:
        # the query's own key cannot be evicted by a later token of the chunk.
        out = fused_update_decode_attention(
            xq, xk, xv, CK, CV, KS, VS, li, window, ring.write_slot, positions[:, 0],
            ring.slot_pos, ring.slot_valid,
        )
        return linear(out, w["wo"])
    if T == 1 and ring.slot_pos is not None:
        # Decode, non-fused route: the same write through update_stacked,
        # then the read-only kernel over the ring as it now stands.
        update_stacked(CK, CV, KS, VS, li, xk, xv, ring.writes)
        out = decode_attention(
            xq, CK, CV, KS, VS, li, positions, ring.slot_pos, ring.slot_valid, window
        )
        return linear(out, w["wo"])

    # Under an int8 ring the chunk attends to quantize-rounded copies of its
    # own K/V, so prefill logits see what decode later reads from the ring.
    xk_att = kv_roundtrip(xk) if scaled else xk
    xv_att = kv_roundtrip(xv) if scaled else xv
    if ring.slot_pos is not None:
        o_r, m_r, l_r = ring_attention_stats(
            xq, CK[li], CV[li], KS[li] if scaled else None, VS[li] if scaled else None,
            positions, ring.slot_pos, token_valid, ring.slot_valid, window,
        )
        o_c, m_c, l_c = flash_attention(
            xq, xk_att, xv_att, positions, positions, token_valid, token_valid, window,
            return_stats=True,
        )
        out = merge_attention_parts(o_r, m_r, l_r, o_c, m_c, l_c).reshape(B, T, H * Dh)
    else:
        out = flash_attention(
            xq, xk_att, xv_att, positions, positions, token_valid, token_valid, window
        )
    update_stacked(CK, CV, KS, VS, li, xk, xv, ring.writes)
    return linear(out, w["wo"])


def forward(
    params: Params,
    tokens: torch.Tensor,  # (B, T) int
    seqlens: torch.Tensor,  # (B,) int32: valid tokens per row in this chunk
    cache: KVCache,
    args: TransformerArgs,
    attend_cache: bool,
    head: str = "full",
) -> torch.Tensor:
    """One chunk pass (a prefill chunk or one decode step).

    Returns prelogits (B, T, V) fp32, or with ``head="none"`` the final-norm
    hidden states (B, T, D). The cache is updated IN PLACE: every layer's
    ring gets this chunk's K/V and ``cache.kv_len`` advances by ``seqlens``.
    """
    B, T = tokens.shape
    device = tokens.device
    kv_len = cache.kv_len
    seqlens = seqlens.to(torch.int32)
    new_total = kv_len + seqlens
    steps = torch.arange(T, dtype=torch.int32, device=device)
    positions = kv_len[:, None] + steps[None, :]
    token_valid = steps[None, :] < seqlens[:, None]

    h = F.embedding(tokens.long(), params["tok_embeddings"])
    theta = args.rope_theta or DEFAULT_ROPE_THETA
    rope_cs = rope_for_positions(positions, args.head_dim, theta)
    rings: Dict[int, RingInputs] = {}
    for li, lw in enumerate(params["layers"]):
        window = cache.windows[li]
        if window not in rings:
            rings[window] = _ring_inputs(
                window, cache.size, positions, token_valid, kv_len, new_total, attend_cache
            )
        h = h + _attention_block(
            rms_norm(h, lw["attention_norm"], args.norm_eps), lw, cache, li, positions,
            token_valid, rope_cs, rings[window], args,
        )
        h = h + _dense_ffn(rms_norm(h, lw["ffn_norm"], args.norm_eps), lw)
    cache.kv_len = new_total
    h = rms_norm(h, params["norm"], args.norm_eps)
    if head == "none":
        return h
    return output_head(params, h)


def output_head(params: Params, h: torch.Tensor) -> torch.Tensor:
    """Vocab projection in the model dtype, returned as fp32."""
    return F.linear(h, params["output"]).float()


def param_count(params: Params) -> int:
    """Logical weights: a quantized leaf counts its integers (two per packed
    int4 byte), not its scales."""

    def count(w) -> int:
        if is_quantized(w):
            return 2 * w["q4"].numel() if "q4" in w else w["q"].numel()
        return w.numel()

    n = sum(t.numel() for k, t in params.items() if k != "layers")
    return n + sum(count(w) for lw in params["layers"] for w in lw.values())
