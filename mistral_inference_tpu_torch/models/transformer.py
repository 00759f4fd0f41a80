"""Decoder-only Transformer, dense (Mistral-7B family) or sparse-MoE (Mixtral
family), counterpart of ``mistral_inference_tpu/models/transformer.py``.

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
  and then ``decode_attention``, the read-only kernel;
* a speculative verify chunk (``write_cache="spec"``, T <= 8 over a ring that
  never wraps): ``fused_verify_chunk_attention``, which writes all T
  candidates and attends ring-only. With ``write_cache=False`` the verify
  chunk takes the later-chunk route above and writes nothing.

With ``args.moe`` a layer's feed-forward is a router ``gate`` (E, dim) in the
model dtype and two expert stacks applied as ``x @ w``: ``w13`` (E, dim, 2 *
hidden), w1 and w3 fused along out, and ``w2`` (E, hidden, dim); each is a
plain tensor or a quantized leaf. ``args.moe_impl`` picks the compute:

* ``"dense"`` (``_moe_ffn``): every expert on every token, combined with the
  routing matrix; plain batched products, the oracle.
* ``"dispatch"`` (``_moe_ffn_dispatch``): up to 256 rows, capacity buffers
  (E, C, dim) whose expert products go through ``moe_matmul_quant`` (K8) for
  quantized leaves; above, ``_moe_ffn_ragged``: the assignments sorted by
  expert and padded to 256-row tiles through ``moe_matmul_quant_ragged``
  (K5, one weight per tile), which drops nothing.

With quantized experts no routing step waits for the card: every shape is
fixed by the row count.

On CPU tensors the same names run their plain versions, so the CPU tests run
the decomposition the card runs.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

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
    fused_verify_chunk_attention,
    merge_attention_parts,
    ring_attention_stats,
)
from mistral_inference_tpu_torch.ops.cuda.moe_matmul import (
    moe_matmul_quant,
    moe_matmul_quant_ragged,
    moe_matmul_quant_stacked,
)
from mistral_inference_tpu_torch.ops.linear import (
    DEFAULT_GROUP,
    Weight,
    dequant,
    is_quantized,
    linear,
    quantize_weight,
)
from mistral_inference_tpu_torch.ops.norm import rms_norm
from mistral_inference_tpu_torch.ops.rope import apply_rope, rope_for_positions

Params = Dict[str, Any]

DEFAULT_ROPE_THETA = 1e6

# Decode (T == 1) route, counterpart of the JAX package's fused-decode switch:
# True sends a step through the fused write-and-attend kernel (K2); False
# writes the ring with ``update_stacked`` and attends with the read-only
# ``decode_attention`` (K6). Both leave the same ring bytes.
FUSED_DECODE = True

MOE_RAGGED_ROWS = 256  # above this, dispatch routes to the sorted ragged path
MOE_RAGGED_TM = 256  # row tile of the sorted grouped product (K5)
MOE_EXPERT_ROWS_MAX = 128  # K8 up to this capacity


def init_params(
    args: TransformerArgs,
    dtype: torch.dtype,
    generator: torch.Generator,
    device: torch.device,
    quant: Optional[str] = None,
    group: int = DEFAULT_GROUP,
) -> Params:
    """Random weights with the JAX package's distributions: linear weights
    N(0, 1) / sqrt(fan_in), embeddings N(0, 1), norms 1. Generated directly
    in ``dtype`` on ``device`` (no fp32 copy of a 7B model).

    With ``quant`` ("int8" | "int4") each big linear is quantized as soon as
    it is drawn and its dense form dropped, one expert at a time, so a model
    whose dense form exceeds the device (Mixtral-8x7B) is made without it:
    the peak is the quantized model plus one weight's fp32 copy. The draws
    are those of ``quant=None``, so the result equals quantizing afterwards.
    """
    if quant not in (None, "int8", "int4"):
        raise ValueError(f"quant must be None, 'int8' or 'int4', got {quant!r}")
    bits = {None: 0, "int8": 8, "int4": 4}[quant]
    D, Dh, F_ = args.dim, args.head_dim, args.hidden_dim
    H, Hkv, V = args.n_heads, args.n_kv_heads, args.vocab_size

    def draw(shape: Tuple[int, int], fan_in: int) -> torch.Tensor:
        w = torch.randn(shape, generator=generator, dtype=dtype, device=device)
        return w.mul_(fan_in**-0.5)

    def lin(out_f: int, in_f: int) -> torch.Tensor:
        return draw((out_f, in_f), in_f)

    def big(out_f: int, in_f: int) -> Weight:
        w = lin(out_f, in_f)
        return quantize_weight(w.t(), bits, group) if bits else w

    def experts(in_f: int, out_f: int) -> Weight:
        """An (E, in, out) stack, applied as x @ w."""
        ws = []
        for _ in range(args.moe.num_experts):
            w = draw((in_f, out_f), in_f)
            ws.append(quantize_weight(w, bits, group) if bits else w)
        if bits:
            return {k: torch.stack([w[k] for w in ws]) for k in ws[0]}
        return torch.stack(ws)

    def ones(n: int) -> torch.Tensor:
        return torch.ones((n,), dtype=dtype, device=device)

    def ffn() -> Params:
        if args.moe:
            return {
                "gate": lin(args.moe.num_experts, D),
                "w13": experts(D, 2 * F_),  # w1, w3 stacked on out
                "w2": experts(F_, D),
            }
        return {"w13": big(2 * F_, D), "w2": big(D, F_)}

    layers = [
        {
            "attention_norm": ones(D),
            "ffn_norm": ones(D),
            "wqkv": big((H + 2 * Hkv) * Dh, D),  # wq, wk, wv stacked on out
            "wo": big(D, H * Dh),
            **ffn(),
        }
        for _ in range(args.n_layers)
    ]
    params = {
        "tok_embeddings": torch.randn((V, D), generator=generator, dtype=dtype, device=device),
        "layers": layers,
        "norm": ones(D),
        "output": lin(V, D),
    }
    if args.vision_encoder is not None:
        # Drawn last, so a text-only model's draws are unchanged; never
        # quantized, as in the JAX package.
        from mistral_inference_tpu_torch.models.vision import init_vision_params

        params["vision"] = init_vision_params(args.vision_encoder, D, dtype, generator, device)
    return params


def _dense_ffn(x: torch.Tensor, w: Params) -> torch.Tensor:
    """SwiGLU: w2(silu(w1 x) * w3 x)."""
    gate, up = linear(x, w["w13"]).chunk(2, dim=-1)
    return linear(F.silu(gate) * up, w["w2"])


# ---------------------------------------------------------------------------
# Sparse mixture of experts
# ---------------------------------------------------------------------------


def _route(x: torch.Tensor, gate: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k experts of each token and their softmax weights in fp32 (over
    the selected logits, like the reference): (N, k) int64, (N, k) fp32.
    Equal logits go to the lower expert index first, as ``jax.lax.top_k``
    orders them: a stable descending sort, since ``torch.topk`` promises no
    tie order on the card and bf16 gate logits do tie."""
    logits = F.linear(x, gate)  # (N, E)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return idx[:, :top_k], torch.softmax(vals[:, :top_k].float(), dim=-1)


def _expert_weight(w: Weight, dtype: torch.dtype) -> torch.Tensor:
    """An expert stack as a dense (E, in, out) tensor."""
    return dequant(w, dtype) if is_quantized(w) else w


def _swiglu(h13: torch.Tensor) -> torch.Tensor:
    gate, up = h13.chunk(2, dim=-1)
    return F.silu(gate) * up


def _moe_ffn(x: torch.Tensor, w: Params, top_k: int) -> torch.Tensor:
    """Top-k routed SwiGLU experts, every expert evaluated on every token and
    combined with the routing matrix: exact, and the oracle of the other two.
    x (N, D)."""
    E = w["gate"].shape[0]
    top_idx, top_w = _route(x, w["gate"], top_k)
    combine = (F.one_hot(top_idx, E).float() * top_w[..., None]).sum(dim=1).to(x.dtype)  # (N, E)
    hidden = _swiglu(torch.matmul(x, _expert_weight(w["w13"], x.dtype)))  # (E, N, F)
    expert_out = torch.bmm(hidden, _expert_weight(w["w2"], x.dtype))  # (E, N, D)
    return torch.einsum("ne,end->nd", combine, expert_out)


def _ragged_kernel_gate(x: torch.Tensor, w: Params) -> bool:
    """K5 takes both expert stacks quantized, with dim and hidden (each the
    reduction of one product and the width of the other) multiples of 256."""
    if not (is_quantized(w["w13"]) and is_quantized(w["w2"])):
        return False
    hidden = w["w13"]["scale"].shape[-1] // 2
    return x.shape[-1] % 256 == 0 and hidden % 256 == 0


def _moe_ffn_ragged(x: torch.Tensor, w: Params, top_k: int) -> torch.Tensor:
    """Drop-free sorted grouped-product MoE, the prefill path: the N * k
    assignments sorted by expert (stable, so ties keep token order), each
    projection one grouped product over the sorted rows, the weighted outputs
    gathered back per token.

    Quantized expert stacks go through ``moe_matmul_quant_ragged`` (K5): each
    expert's rows are padded to whole ``MOE_RAGGED_TM``-row tiles inside a
    buffer of the worst-case size, which depends on the row count alone, and
    every tile carries its expert's index. Anything else runs one plain
    product per expert on its own rows, which reads the counts on the host.
    """
    N, D = x.shape
    E = w["gate"].shape[0]
    top_idx, top_w = _route(x, w["gate"], top_k)
    flat_e = top_idx.reshape(-1)  # (N k,) token-major
    order = torch.argsort(flat_e, stable=True)
    tok = order // top_k  # source token of each sorted row
    counts = F.one_hot(flat_e, E).sum(dim=0)  # (E,), no host sync
    NK = N * top_k
    inv = torch.empty_like(order)
    inv[order] = torch.arange(NK, device=x.device)  # flat -> sorted position
    wts = top_w.reshape(-1).to(x.dtype)

    if _ragged_kernel_gate(x, w):
        TM = MOE_RAGGED_TM
        # Worst-case padded rows, a whole number of tiles: the per-expert
        # sizes rounded up to TM sum to at most NK + E (TM - 1).
        Mp = (-(-NK // TM) + E) * TM
        padded = -(-counts // TM) * TM
        cum_pad = torch.cumsum(padded, 0)
        offsets = cum_pad - padded  # padded start of each expert's rows
        starts = torch.cumsum(counts, 0) - counts  # sorted start of each expert's rows
        # Padded position p belongs to expert g_of_p at rank j; pad rows read
        # a row of their expert (or row 0) and are discarded at the gather
        # back. Tiles past the last expert's rows carry the clamped E - 1.
        p = torch.arange(Mp, device=x.device)
        g_of_p = torch.searchsorted(cum_pad, p, right=True).clamp_max(E - 1)
        j = p - offsets[g_of_p]
        sorted_idx = (starts[g_of_p] + torch.minimum(j, counts[g_of_p] - 1)).clamp(0, NK - 1)
        xs_p = x[tok[sorted_idx]]  # (Mp, D) padded sorted rows
        tile_group = g_of_p[::TM].to(torch.int32).contiguous()

        def mm(inp: torch.Tensor, leaf: Weight) -> torch.Tensor:
            q = leaf["q4"] if "q4" in leaf else leaf["q"]
            return moe_matmul_quant_ragged(inp, q, leaf["scale"], tile_group, leaf.get("li"))

        out_p = mm(_swiglu(mm(xs_p, w["w13"])), w["w2"])  # (Mp, D)
        pos_f = offsets[flat_e] + (inv - starts[flat_e])  # (N k,) token-major
        out = out_p[pos_f]
    else:
        sizes = counts.tolist()  # the host waits for the counts here
        w13, w2 = _expert_weight(w["w13"], x.dtype), _expert_weight(w["w2"], x.dtype)
        rows = torch.split(x[tok], sizes)  # rows grouped by expert
        out = torch.cat([_swiglu(r @ w13[e]) @ w2[e] for e, r in enumerate(rows)])[inv]
    return (out * wts[:, None]).reshape(N, top_k, D).sum(dim=1)


def _expert_mm(inp: torch.Tensor, leaf: Weight) -> torch.Tensor:
    """(E, C, in) @ (E, in, out). A quantized leaf at a decode-sized capacity
    goes through ``moe_matmul_quant`` (K8), which streams each live expert's
    stored bytes once; anything else is a plain batched product on a dense
    weight."""
    if is_quantized(leaf):
        C, K = inp.shape[-2:]
        if C <= MOE_EXPERT_ROWS_MAX and K % 256 == 0 and leaf["scale"].shape[-1] % 128 == 0:
            q = leaf["q4"] if "q4" in leaf else leaf["q"]
            if "li" in leaf:  # (L, E, ...) stack: read in place
                return moe_matmul_quant_stacked(inp, q, leaf["scale"], leaf["li"])
            return moe_matmul_quant(inp, q, leaf["scale"])
    return torch.bmm(inp, _expert_weight(leaf, inp.dtype))


def moe_capacity(n_rows: int, top_k: int, n_experts: int, capacity_factor: float) -> int:
    """Slots per expert: ceil(N k factor / E), at least 8, at most N."""
    C = max(8, int(-(-n_rows * top_k * capacity_factor // n_experts)))
    return min(C, n_rows)


def _moe_ffn_dispatch(
    x: torch.Tensor, w: Params, top_k: int, capacity_factor: float
) -> torch.Tensor:
    """Capacity-bounded expert dispatch: tokens go into per-expert buffers of
    ``moe_capacity`` slots in token-major order (pad tokens of ragged rows
    included: they are rows like any other here), each expert runs its SwiGLU
    on its own (C, D) buffer, and outputs gather back weighted by the router.
    Assignments beyond an expert's capacity contribute zero. Above
    ``MOE_RAGGED_ROWS`` rows the drop-free ``_moe_ffn_ragged`` takes over."""
    N, D = x.shape
    E = w["gate"].shape[0]
    if N > MOE_RAGGED_ROWS:
        return _moe_ffn_ragged(x, w, top_k)
    C = moe_capacity(N, top_k, E, capacity_factor)
    top_idx, top_w = _route(x, w["gate"], top_k)

    flat_e = top_idx.reshape(-1)  # (N k,) token-major
    onehot = F.one_hot(flat_e, E)
    slot = (torch.cumsum(onehot, 0) * onehot).sum(dim=-1) - 1  # rank within its expert
    keep = slot < C

    # The buffers by gather: src[e, c] is the token in slot c of expert e, or
    # N, a row of zeros. Every kept (e, slot) has exactly one source, so the
    # buffers do not depend on the order of the writes below; the dropped
    # assignments all land in column C, which is cut off.
    NK = N * top_k
    src = torch.full((E, C + 1), N, dtype=torch.long, device=x.device)
    src[flat_e, torch.where(keep, slot, C)] = torch.arange(NK, device=x.device) // top_k
    buf = torch.cat([x, x.new_zeros((1, D))])[src[:, :C]]  # (E, C, D)

    out_buf = _expert_mm(_swiglu(_expert_mm(buf, w["w13"])), w["w2"])  # (E, C, D)

    gathered = out_buf[flat_e, slot.clamp_max(C - 1)]  # (N k, D)
    weights = (top_w.reshape(-1) * keep.float()).to(x.dtype)
    return (gathered * weights[:, None]).reshape(N, top_k, D).sum(dim=1)


def _moe_block(x: torch.Tensor, w: Params, args: TransformerArgs) -> torch.Tensor:
    """The MoE feed-forward of one layer on x (B, T, D), all B T positions as
    rows, by ``args.moe_impl``."""
    rows = x.reshape(-1, x.shape[-1])
    k = args.moe.num_experts_per_tok
    if args.moe_impl == "dispatch":
        out = _moe_ffn_dispatch(rows, w, k, args.moe_capacity_factor)
    else:
        out = _moe_ffn(rows, w, k)
    return out.reshape(x.shape)


class RingInputs(NamedTuple):
    """What attention needs to know of one window's ring for this chunk. It
    is the same for every layer of that window, so ``forward`` makes it once
    per window, not once per layer."""

    # fused decode and fused verify: (B,) int32 slot of the chunk's first
    # token, -1 = none
    write_slot: Optional[torch.Tensor]
    # prefill and non-fused decode: cache.ring_writes; None when nothing is
    # written (write_cache=False)
    writes: Optional[Tuple[torch.Tensor, ...]]
    # (B, W) position and validity of each slot: after the write of a decode
    # step or a fused verify chunk, before a prefill chunk's; None for the
    # first chunk, which attends to itself alone.
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
    write_cache: Union[bool, str] = True,
) -> RingInputs:
    """RingInputs of one window: a decode step (T == 1 over the ring) gets
    its write slot (fused route) or write plan (non-fused route) and the
    ring's state after the write; a fused verify chunk its first write slot
    and the state after all T writes; a prefill chunk its write plan; a
    no-write verify chunk the ring's state alone."""
    if attend_cache and write_cache == "spec":
        # Valid only on a ring that never wraps, so every valid token is
        # written: the T slots are consecutive from the first token's.
        write_slot0 = torch.where(token_valid[:, 0], positions[:, 0] % window, -1)
        return RingInputs(
            write_slot0.to(torch.int32), None, *slot_positions(new_total, window, W)
        )
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
    writes = ring_writes(positions, token_valid, new_total, window) if write_cache else None
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
    write_cache: Union[bool, str] = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer's attention; unless ``write_cache`` is False it writes this
    chunk's K/V into layer ``li`` of the ring in place. Returns (the block's
    output, this chunk's rope'd K, its V: (B, T, Hkv, Dh) before
    quantization)."""
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

    if write_cache == "spec" and ring.write_slot is not None:
        # Speculative verify, fused: write ALL T candidate tokens into
        # consecutive slots, then attend every query ring-only; causality
        # inside the chunk is position arithmetic. Valid ONLY on a ring that
        # never wraps (the caller checked that min(windows) covers every
        # position): nothing is evicted, rejected slots stay invisible (the
        # caller advances kv_len only past accepted tokens) and are
        # overwritten when real tokens reach those positions.
        out = fused_verify_chunk_attention(
            xq, xk, xv, CK, CV, KS, VS, li, window, ring.write_slot, positions,
            ring.slot_pos, ring.slot_valid,
        )
        return linear(out, w["wo"]), xk, xv
    if ring.write_slot is not None:
        # Decode: write the ring first, then attend ring-only. Safe for T == 1:
        # the query's own key cannot be evicted by a later token of the chunk.
        out = fused_update_decode_attention(
            xq, xk, xv, CK, CV, KS, VS, li, window, ring.write_slot, positions[:, 0],
            ring.slot_pos, ring.slot_valid,
        )
        return linear(out, w["wo"]), xk, xv
    if T == 1 and ring.slot_pos is not None:
        # Decode, non-fused route: the same write through update_stacked,
        # then the read-only kernel over the ring as it now stands.
        update_stacked(CK, CV, KS, VS, li, xk, xv, ring.writes)
        out = decode_attention(
            xq, CK, CV, KS, VS, li, positions, ring.slot_pos, ring.slot_valid, window
        )
        return linear(out, w["wo"]), xk, xv

    # Under a scaled ring the chunk attends to copies of its own K/V rounded
    # through the ring's dtype, so prefill logits see what decode later reads
    # from the ring.
    xk_att = kv_roundtrip(xk, CK.dtype) if scaled else xk
    xv_att = kv_roundtrip(xv, CV.dtype) if scaled else xv
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
    if ring.writes is not None:
        update_stacked(CK, CV, KS, VS, li, xk, xv, ring.writes)
    return linear(out, w["wo"]), xk, xv


ChunkKV = Tuple[torch.Tensor, torch.Tensor]


def forward(
    params: Params,
    tokens: torch.Tensor,  # (B, T) int
    seqlens: torch.Tensor,  # (B,) int32: valid tokens per row in this chunk
    cache: KVCache,
    args: TransformerArgs,
    attend_cache: bool,
    head: str = "full",
    write_cache: Union[bool, str] = True,
    input_embeds: Optional[torch.Tensor] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, ChunkKV]]:
    """One chunk pass (a prefill chunk or one decode step).

    ``input_embeds`` (B, T, D) in the model dtype, when given, replaces the
    token embeddings: a multimodal prefill chunk, its image tokens' slots
    holding image features (``models/vision.embed_multimodal``).

    Returns prelogits (B, T, V) fp32, or with ``head="none"`` the final-norm
    hidden states (B, T, D). The cache is updated IN PLACE: every layer's
    ring gets this chunk's K/V and ``cache.kv_len`` advances by ``seqlens``.

    ``write_cache`` has three values, the last two for speculative decoding's
    verify pass over a chunk ``[t0, d_1 .. d_K]``:

    * ``True``: as above.
    * ``False``: the chunk attends [ring ++ chunk] exactly like a prefill
      chunk but the ring and ``kv_len`` are left untouched, and the return is
      ``(prelogits, (chunk_k, chunk_v))``: the per-layer rope'd K/V stacks
      (L, B, T, Hkv, Dh), before quantization, of which ``cache.scatter_chunk``
      later writes just the accepted prefix. Rejected draft tokens therefore
      never touch the ring, which keeps the commit safe even when the ring
      wraps. Needs T > 1 over a ring (``attend_cache``).
    * ``"spec"``: ALL T candidate tokens are written into consecutive ring
      slots and every query attends ring-only at the fill after the write;
      ``kv_len`` is NOT advanced: the caller moves it past the accepted
      prefix (``cache.rewind``). Only for rings that never wrap.
    """
    B, T = tokens.shape
    device = tokens.device
    if write_cache is not True and not attend_cache:
        raise ValueError("a verify pass (write_cache other than True) attends to the ring")
    if write_cache is False and T == 1:
        raise ValueError("no-write (speculative verify) requires T > 1")
    kv_len = cache.kv_len
    seqlens = seqlens.to(torch.int32)
    new_total = kv_len + seqlens
    steps = torch.arange(T, dtype=torch.int32, device=device)
    positions = kv_len[:, None] + steps[None, :]
    token_valid = steps[None, :] < seqlens[:, None]

    if input_embeds is None:
        h = F.embedding(tokens.long(), params["tok_embeddings"])
    elif tuple(input_embeds.shape) != (B, T, params["tok_embeddings"].shape[1]):
        raise ValueError(f"input_embeds must be (B, T, dim), got {tuple(input_embeds.shape)}")
    else:
        h = input_embeds
    theta = args.rope_theta or DEFAULT_ROPE_THETA
    rope_cs = rope_for_positions(positions, args.head_dim, theta)
    rings: Dict[int, RingInputs] = {}
    chunk_k: List[torch.Tensor] = []
    chunk_v: List[torch.Tensor] = []
    for li, lw in enumerate(params["layers"]):
        window = cache.windows[li]
        if window not in rings:
            rings[window] = _ring_inputs(
                window, cache.size, positions, token_valid, kv_len, new_total, attend_cache,
                write_cache,
            )
        attn_out, xk, xv = _attention_block(
            rms_norm(h, lw["attention_norm"], args.norm_eps), lw, cache, li, positions,
            token_valid, rope_cs, rings[window], args, write_cache,
        )
        h = h + attn_out
        if write_cache is False:
            chunk_k.append(xk)
            chunk_v.append(xv)
        x = rms_norm(h, lw["ffn_norm"], args.norm_eps)
        h = h + (_moe_block(x, lw, args) if args.moe else _dense_ffn(x, lw))
    if write_cache is True:
        cache.kv_len = new_total
    h = rms_norm(h, params["norm"], args.norm_eps)
    out = h if head == "none" else output_head(params, h)
    if write_cache is False:
        return out, (torch.stack(chunk_k), torch.stack(chunk_v))
    return out


def output_head(params: Params, h: torch.Tensor) -> torch.Tensor:
    """Vocab projection in the model dtype, returned as fp32."""
    return F.linear(h, params["output"]).float()


def param_count(params: Params) -> int:
    """Logical weights: a quantized leaf counts its integers (two per packed
    int4 byte), not its scales. A vision encoder's weights count too."""

    def count(w) -> int:
        if is_quantized(w):
            return 2 * w["q4"].numel() if "q4" in w else w["q"].numel()
        if isinstance(w, dict):
            return sum(count(x) for x in w.values())
        if isinstance(w, list):
            return sum(count(x) for x in w)
        return w.numel()

    return count(params)
