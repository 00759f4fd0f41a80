"""Ring KV cache (counterpart of ``mistral_inference_tpu/cache.py``).

One stacked pair of rings ``(L, B, W, Hkv * Dh)`` in flat-head layout, and
for the scaled rings (int8 and float8_e4m3fn) one fp32 scale per (token,
kv-head), stored ``(L, B, Hkv, W)``.
Token at absolute position p of a layer with window w lives in slot
``p % w``; ``slot_positions`` recovers each slot's position from the fill
``kv_len``, so attention masks are position arithmetic and the ring is never
unrotated. Per-layer windows share one W = max(window) rounded up to 128.

Where the JAX package returns updated buffers from pure functions (and
donates the old ones), this port updates the ring IN PLACE: ``update_stacked``
and the fused decode kernel write into the tensors they are given. Ring bytes
move through ``uint8`` views of one-byte rings, so no element is ever
converted on its way and no indexing op needs a float8 implementation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import torch

INT8_MAX = 127.0
FP8_MAX = 448.0  # float8_e4m3fn

# Scaled ring dtypes -> the scale rule's qmax. Both store one byte per element
# with one fp32 scale per (token, kv-head); dequant = float(q) * scale.
_RING_QMAX = {torch.float8_e4m3fn: FP8_MAX, torch.int8: INT8_MAX}


@dataclass
class KVCache:
    k: torch.Tensor  # (L, B, W, Hkv*Dh) ring dtype
    v: torch.Tensor
    kv_len: torch.Tensor  # (B,) int32: tokens absorbed per row so far
    windows: List[int]  # per-layer ring size (<= W)
    # (L, B, Hkv, W) fp32 scales for scaled rings; None for bf16 rings.
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]

    @property
    def size(self) -> int:
        return self.k.shape[2]

    @classmethod
    def alloc(
        cls,
        n_layers: int,
        batch: int,
        max_seq_len: int,
        n_kv_heads: int,
        head_dim: int,
        sliding_window: Optional[Union[int, List[Optional[int]]]] = None,
        dtype: torch.dtype = torch.bfloat16,
        kv_quant: str = "bf16",
        device: Union[str, torch.device] = "cuda",
    ) -> "KVCache":
        sizes = _cache_sizes(n_layers, max_seq_len, sliding_window)
        # W padded to 128: the kernels tile the ring in 128-slot steps. Slots
        # at or past a layer's window are never written or valid.
        W = -(-max(sizes) // 128) * 128
        kv_dtype = kv_cache_dtype(kv_quant, dtype)
        shape = (n_layers, batch, W, n_kv_heads * head_dim)
        scales = None, None
        if is_scaled_dtype(kv_dtype):
            sshape = (n_layers, batch, n_kv_heads, W)
            scales = (
                torch.ones(sshape, dtype=torch.float32, device=device),
                torch.ones(sshape, dtype=torch.float32, device=device),
            )
        return cls(
            k=_zeros(shape, kv_dtype, device),
            v=_zeros(shape, kv_dtype, device),
            kv_len=torch.zeros((batch,), dtype=torch.int32, device=device),
            windows=sizes,
            k_scale=scales[0],
            v_scale=scales[1],
        )


def _cache_sizes(
    n_layers: int,
    max_seq_len: int,
    sliding_window: Optional[Union[int, List[Optional[int]]]],
) -> List[int]:
    if sliding_window is None:
        return n_layers * [max_seq_len]
    if isinstance(sliding_window, int):
        return n_layers * [min(sliding_window, max_seq_len)]
    if n_layers % len(sliding_window):
        raise ValueError("a per-layer window list must tile n_layers")
    reps = n_layers // len(sliding_window)
    return reps * [
        min(w, max_seq_len) if w is not None else max_seq_len for w in sliding_window
    ]


def _zeros(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """A zero ring: a one-byte ring is made as uint8 zeros and viewed, so no
    fill kernel needs a float8 implementation."""
    if dtype.itemsize == 1:
        return torch.zeros(shape, dtype=torch.uint8, device=device).view(dtype)
    return torch.zeros(shape, dtype=dtype, device=device)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A one-byte ring as its uint8 bytes (the same memory), anything else as
    it is: what ring writes index into."""
    return t.view(torch.uint8) if t.element_size() == 1 else t


def kv_cache_dtype(kv_quant: str, dtype: torch.dtype) -> torch.dtype:
    if kv_quant not in ("bf16", "fp8", "int8"):
        raise ValueError(f"kv_quant must be 'bf16', 'fp8' or 'int8', got {kv_quant!r}")
    return {"fp8": torch.float8_e4m3fn, "int8": torch.int8}.get(kv_quant, dtype)


def is_scaled_dtype(dtype: torch.dtype) -> bool:
    """True for the scaled ring dtypes (fp8, int8): per-(token, head) fp32
    scales accompany the ring and every read folds them back in."""
    return dtype in _RING_QMAX


def _quantize_ring(x: torch.Tensor, kv_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., Dh) -> (``kv_dtype`` (..., Dh), fp32 scale (...,)) under the
    per-(token, head) absmax rule: scale = max(absmax / qmax, 1e-8); for int8
    (qmax 127) q = clip(round(x / scale), -127, 127) with round-half-to-even,
    for float8_e4m3fn (qmax 448) q = (x / scale) cast with round to nearest
    even, no clip. The fused decode and verify kernels repeat this bit for
    bit. |x / scale| exceeds 448 by a rounding at most, where PyTorch's cast
    and the JAX package's agree (they part above 464: PyTorch saturates to
    448, XLA gives NaN)."""
    qmax = _RING_QMAX[kv_dtype]
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    # Divide by a tensor, not a Python number: on CUDA, PyTorch turns division
    # by a host scalar into a multiply by its reciprocal, which is not IEEE
    # division and breaks the bit-exact rule on a few percent of inputs.
    scale = (amax / torch.full_like(amax, qmax)).clamp_min(1e-8)
    y = xf / scale[..., None]
    if kv_dtype == torch.int8:
        y = torch.round(y).clamp(-INT8_MAX, INT8_MAX)
    return y.to(kv_dtype), scale


def ring_writes(
    positions: torch.Tensor,  # (B, T)
    token_valid: torch.Tensor,  # (B, T)
    new_total: torch.Tensor,  # (B,)
    window: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Which chunk tokens land in a ``window``-slot ring, and where: slot =
    pos % window. A token that a later token of the same chunk would
    overwrite is dropped, so the slots written are unique. Returns (b_idx,
    t_idx, slot), each (N,). Finding N syncs with the host, so the caller
    makes this once per chunk and window and hands it to every layer."""
    should = token_valid & (positions >= new_total[:, None] - window)
    b_idx, t_idx = should.nonzero(as_tuple=True)
    return b_idx, t_idx, positions[b_idx, t_idx] % window


def update_stacked(
    CK: torch.Tensor,  # (L, B, W, Hkv*Dh), updated in place
    CV: torch.Tensor,
    KS: Optional[torch.Tensor],  # (L, B, Hkv, W), updated in place; None for bf16
    VS: Optional[torch.Tensor],
    li: int,
    xk: torch.Tensor,  # (B, T, Hkv, Dh)
    xv: torch.Tensor,
    writes: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],  # ring_writes(...)
) -> None:
    """Write this chunk's K/V for layer ``li`` into the stacked ring, in place
    (the JAX package returns new buffers; here the caller's tensors change)."""
    b_idx, t_idx, slot = writes
    k_sel, v_sel = xk[b_idx, t_idx], xv[b_idx, t_idx]  # (N, Hkv, Dh)
    N = k_sel.shape[0]
    if KS is not None:
        qk, k_scale = _quantize_ring(k_sel, CK.dtype)
        qv, v_scale = _quantize_ring(v_sel, CV.dtype)
        KS[li, b_idx, :, slot] = k_scale
        VS[li, b_idx, :, slot] = v_scale
        k_sel, v_sel = qk, qv
    HD = CK.shape[-1]  # not -1: the chunk may write nothing (N = 0)
    _bytes(CK)[li, b_idx, slot] = _bytes(k_sel.reshape(N, HD).to(CK.dtype))
    _bytes(CV)[li, b_idx, slot] = _bytes(v_sel.reshape(N, HD).to(CV.dtype))


def scatter_chunk(
    cache: KVCache,
    chunk_k: torch.Tensor,  # (L, B, T, Hkv, Dh) rope'd keys, before quantization
    chunk_v: torch.Tensor,
    accept: torch.Tensor,  # (B,) int32: how many leading chunk tokens to write
) -> KVCache:
    """Write the first ``accept[b]`` tokens of an already-computed chunk's
    K/V into every layer's ring, in place, and advance ``kv_len`` by
    ``accept``. Returns the cache.

    This is the speculative-decoding commit: the verify forward ran with
    ``write_cache=False`` (it attended [ring ++ chunk] without touching the
    ring) and returned these per-layer chunk K/V stacks; only the accepted
    prefix is ever written, so rejected draft tokens cannot clobber live
    ring entries even when the ring wraps. int8 rings quantize on write
    with the rule of ``update_stacked``: the committed bytes are those a
    plain decode step would have written."""
    T = chunk_k.shape[2]
    steps = torch.arange(T, dtype=torch.int32, device=accept.device)
    accept = accept.to(torch.int32)
    positions = cache.kv_len[:, None] + steps[None, :]
    token_valid = steps[None, :] < accept[:, None]
    new_total = cache.kv_len + accept
    # A chunk no longer than the smallest window lands in T distinct slots
    # per row, so the write has a fixed shape and the host never waits for
    # the card (a speculative block commits once per iteration). A longer
    # chunk overwrites itself and goes through ring_writes, which does wait.
    masked = T <= min(cache.windows)
    plans = {}  # one write plan per window, shared by its layers
    for li, window in enumerate(cache.windows):
        if window not in plans:
            if masked:
                plans[window] = ((positions % window).long(), token_valid)
            else:
                plans[window] = ring_writes(positions, token_valid, new_total, window)
        update = _update_stacked_masked if masked else update_stacked
        update(
            cache.k, cache.v, cache.k_scale, cache.v_scale, li, chunk_k[li], chunk_v[li],
            plans[window],
        )
    cache.kv_len = new_total
    return cache


def _update_stacked_masked(
    CK: torch.Tensor,  # (L, B, W, Hkv*Dh), updated in place
    CV: torch.Tensor,
    KS: Optional[torch.Tensor],
    VS: Optional[torch.Tensor],
    li: int,
    xk: torch.Tensor,  # (B, T, Hkv, Dh)
    xv: torch.Tensor,
    plan: Tuple[torch.Tensor, torch.Tensor],  # slot (B, T) int64; write (B, T) bool
) -> None:
    """``update_stacked`` with a fixed shape: every token's slot is written,
    with its new value where ``write`` is set and with what the slot already
    held elsewhere. The slots of one row must be distinct."""
    slot, write = plan
    B, T = slot.shape
    rows = torch.arange(B, device=slot.device)[:, None]
    if KS is not None:
        xk, k_scale = _quantize_ring(xk, CK.dtype)
        xv, v_scale = _quantize_ring(xv, CV.dtype)
        for S_, new in ((KS, k_scale), (VS, v_scale)):
            S_[li, rows, :, slot] = torch.where(write[..., None], new, S_[li, rows, :, slot])
    for C, new in ((CK, xk), (CV, xv)):
        C, new = _bytes(C), _bytes(new.reshape(B, T, -1).to(C.dtype))
        C[li, rows, slot] = torch.where(write[..., None], new, C[li, rows, slot])


def copy_prefix_rows(
    cache: KVCache,
    srcs: Sequence[int],  # source batch rows
    dsts: Sequence[int],  # destination batch rows
    qs: Sequence[int],  # prefix lengths; q <= 0 is a no-op
) -> KVCache:
    """Prefix-cache commit, in place: for each i in order, copy the ring
    slots holding positions [0, qs[i]) of row ``srcs[i]`` into row
    ``dsts[i]`` in every layer, scales included, and set that row's
    ``kv_len`` to qs[i]. The copies run in array order, so a same-wave chain
    (a row copied into and then a later copy's source) reads its source after
    it was written. Exact bytes: what a fresh prefill of the same tokens
    writes.

    Valid ONLY where the source ring never wrapped past q (positions 0..q-1
    live in slots 0..q-1): the serving engine checks the source's fill
    against min(windows) before it copies."""
    for src, dst, q in zip(srcs, dsts, qs):
        if q <= 0:
            continue
        for ring in (cache.k, cache.v):
            b = _bytes(ring)
            b[:, dst, :q] = b[:, src, :q]
        if cache.k_scale is not None:
            for sc in (cache.k_scale, cache.v_scale):
                sc[:, dst, :, :q] = sc[:, src, :, :q]
        cache.kv_len[dst] = q
    return cache


def adopt_rows(
    cache: KVCache,
    carry: torch.Tensor,  # (B, V) fp32: the engine's last prelogits per row
    src: KVCache,  # a staging cache: batch B_s, the same (L, W, Hkv * Dh)
    src_carry: torch.Tensor,  # (B_s, V)
    src_rows: Sequence[int],  # staging rows to adopt
    dst_rows: Sequence[int],  # rows of ``cache``; a row >= B is dropped
) -> Tuple[KVCache, torch.Tensor]:
    """Whole-row adoption from a narrow staging cache, in place: ring bytes,
    scales, ``kv_len`` and the prelogits carry row move together, so a row
    prefilled at staging width is indistinguishable from one prefilled in
    place (same windows, so the same slot arithmetic; the copy is exact
    bytes, quantized payloads and scales included). Returns (cache, carry).

    Serving motivation: an admission prefill costs about as much however few
    rows are new, since occupied rows ride along at seqlens 0; prefilling a
    trickle of new rows in a B_s-row staging cache and adopting them makes
    admission cost proportional to the new rows."""
    B = cache.k.shape[1]
    pairs = [(s, d) for s, d in zip(src_rows, dst_rows) if d < B]
    if not pairs:
        return cache, carry
    dev = cache.k.device
    si = torch.tensor([s for s, _ in pairs], dtype=torch.long, device=dev)
    di = torch.tensor([d for _, d in pairs], dtype=torch.long, device=dev)
    for ring, ring_src in ((cache.k, src.k), (cache.v, src.v)):
        _bytes(ring)[:, di] = _bytes(ring_src)[:, si]
    if cache.k_scale is not None:
        cache.k_scale[:, di] = src.k_scale[:, si]
        cache.v_scale[:, di] = src.v_scale[:, si]
    cache.kv_len[di] = src.kv_len[si]
    carry[di] = src_carry[si]
    return cache, carry


def rewind(cache: KVCache, new_len: torch.Tensor) -> KVCache:
    """Set ``kv_len`` to ``new_len`` (per row), in place. ONLY safe on a
    ring that never wrapped (window >= every position ever written): there
    the slots at or past ``new_len`` recover position s - W < 0 in
    ``slot_positions`` and are invalid, while slots below it still recover
    pos = s. On a wrapped ring the overwritten-then-rewound slots would
    bring back stale positions pointing at clobbered bytes. Two callers
    rely on this: the draft cache of ``speculative.py`` (always
    full-context), and the target cache on the fused verify route
    (``write_cache="spec"`` writes all K+1 candidates into the ring, then
    the caller advances ``kv_len`` past the accepted prefix), which
    ``speculative._spec_fused_ok`` opens only when min(windows) covers every
    reachable position. The wrap-safe route keeps the target ring clean
    instead: no-write verify, then ``scatter_chunk``."""
    cache.kv_len = new_len.to(torch.int32)
    return cache


def dequant_layer(
    ck: torch.Tensor,  # (B, W, Hkv*Dh) one layer's ring
    ks: Optional[torch.Tensor],  # (B, Hkv, W) fp32, or None for bf16 rings
    dtype: torch.dtype,
    n_kv_heads: int,
) -> torch.Tensor:
    """Ring slots -> (B, W, Hkv, Dh) in ``dtype``, applying scales if present."""
    B, W, HD = ck.shape
    ck4 = ck.reshape(B, W, n_kv_heads, HD // n_kv_heads)
    if ks is None:
        return ck4.to(dtype)
    return (ck4.float() * ks.permute(0, 2, 1)[..., None]).to(dtype)


def kv_roundtrip(x: torch.Tensor, kv_dtype: torch.dtype) -> torch.Tensor:
    """Quantize-dequantize through the ring rule of ``kv_dtype``. Prefill
    attends to these copies of its own chunk's K/V, so its logits see exactly
    what decode later reads back from the ring (the decode == prefill
    invariant)."""
    q, scale = _quantize_ring(x, kv_dtype)
    return (q.float() * scale[..., None]).to(x.dtype)


def fp8_roundtrip(x: torch.Tensor) -> torch.Tensor:
    return kv_roundtrip(x, torch.float8_e4m3fn)


def slot_positions(
    kv_len: torch.Tensor,  # (B,) tokens in the ring
    window: int,
    W: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absolute position held by each ring slot: with n tokens written and
    ring size w, slot s holds p = s + w * floor((n - 1 - s) / w), the unique
    p = s (mod w) in [n - w, n). Slots with p < 0 or s >= w are invalid.
    Returns (pos (B, W) int32 with -1 where invalid, valid (B, W) bool)."""
    s = torch.arange(W, dtype=torch.int32, device=kv_len.device)[None, :]
    n = kv_len[:, None].to(torch.int32)
    pos = s + window * torch.div(n - 1 - s, window, rounding_mode="floor")
    valid = (pos >= 0) & (s < window) & (n > 0)
    return torch.where(valid, pos, -1).to(torch.int32), valid
