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

Under a mesh (``parallel/``) a rank's rings hold its KV heads and, with
data parallelism, its rows of the global batch from ``row0`` on, while
``kv_len`` stays the global (B,) fill on every rank, so the host loops read
and rewind it as on one device. ``local`` is the view a forward works on.
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
    # Under data parallelism the global row of the rings' first row (they
    # hold k.shape[1] rows of the padded batch); None: they hold every row.
    row0: Optional[int] = None

    @property
    def size(self) -> int:
        return self.k.shape[2]

    def local(self) -> "KVCache":
        """The rings with ``kv_len`` of their own rows only (a copy): what a
        forward of this rank's rows reads and advances. The global fill is
        the caller's to advance."""
        from mistral_inference_tpu_torch.parallel.multihost import local_rows

        return KVCache(self.k, self.v, local_rows(self.kv_len, self.row0, self.k.shape[1]),
                       self.windows, self.k_scale, self.v_scale)

    def leading(self, n: int) -> "KVCache":
        """Rows [0, n) of a cache that holds every row, with no copy: the
        rings, scales and ``kv_len`` are views (each layer's n rows stay one
        contiguous block, as the kernels read a layer). A forward through it
        writes those rows' ring bytes in place and replaces its ``kv_len``,
        which the caller copies back."""
        if self.row0 is not None:
            raise ValueError("a data rank's cache holds a share of the rows, not a leading run")
        return KVCache(self.k[:, :n], self.v[:, :n], self.kv_len[:n], self.windows,
                       None if self.k_scale is None else self.k_scale[:, :n],
                       None if self.v_scale is None else self.v_scale[:, :n])

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
        ring_rows: Optional[int] = None,
        row0: Optional[int] = None,
    ) -> "KVCache":
        """Rings of ``batch`` rows, or under data parallelism of this rank's
        ``ring_rows`` from global row ``row0``; ``kv_len`` has ``batch``."""
        sizes = _cache_sizes(n_layers, max_seq_len, sliding_window)
        rows = batch if ring_rows is None else ring_rows
        # W padded to 128: the kernels tile the ring in 128-slot steps. Slots
        # at or past a layer's window are never written or valid.
        W = -(-max(sizes) // 128) * 128
        kv_dtype = kv_cache_dtype(kv_quant, dtype)
        shape = (n_layers, rows, W, n_kv_heads * head_dim)
        scales = None, None
        if is_scaled_dtype(kv_dtype):
            sshape = (n_layers, rows, n_kv_heads, W)
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
            row0=row0,
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
    plain decode step would have written. Under data parallelism the chunk
    holds this rank's rows, ``accept`` the global batch's."""
    if cache.row0 is not None:
        from mistral_inference_tpu_torch.parallel.multihost import local_rows

        scatter_chunk(cache.local(), chunk_k, chunk_v,
                      local_rows(accept, cache.row0, chunk_k.shape[1]))
        cache.kv_len = cache.kv_len + accept.to(torch.int32)
        return cache
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
    mesh=None,  # under data parallelism, the mesh whose data ranks hold the rows
) -> KVCache:
    """Prefix-cache commit, in place: for each i in order, copy the ring
    slots holding positions [0, qs[i]) of row ``srcs[i]`` into row
    ``dsts[i]`` in every layer, scales included, and set that row's
    ``kv_len`` to qs[i]. The copies run in array order, so a same-wave chain
    (a row copied into and then a later copy's source) reads its source after
    it was written. Exact bytes: what a fresh prefill of the same tokens
    writes. Under data parallelism the rows are global, and a copy between
    two data ranks' rows moves its bytes over ``data``
    (``multihost.copy_rows``).

    Valid ONLY where the source ring never wrapped past q (positions 0..q-1
    live in slots 0..q-1): the serving engine checks the source's fill
    against min(windows) before it copies."""
    from mistral_inference_tpu_torch.parallel.multihost import copy_rows

    for src, dst, q in zip(srcs, dsts, qs):
        if q <= 0:
            continue
        for ring in (cache.k, cache.v):
            b = _bytes(ring)
            copy_rows(b, b, [(src, dst)], mesh, cache.row0, cache.row0, lambda r: r[:, :q])
        if cache.k_scale is not None:
            for sc in (cache.k_scale, cache.v_scale):
                copy_rows(sc, sc, [(src, dst)], mesh, cache.row0, cache.row0,
                          lambda r: r[..., :q])
        cache.kv_len[dst] = q
    return cache


def adopt_rows(
    cache: KVCache,
    carry: torch.Tensor,  # (B, V) fp32: the engine's last prelogits per row
    src: KVCache,  # a staging cache: batch B_s, the same (L, W, Hkv * Dh)
    src_carry: torch.Tensor,  # (B_s, V)
    src_rows: Sequence[int],  # staging rows to adopt
    dst_rows: Sequence[int],  # rows of ``cache``; a row >= B is dropped
    mesh=None,  # under data parallelism, the mesh whose data ranks hold the rows
) -> Tuple[KVCache, torch.Tensor]:
    """Whole-row adoption from a narrow staging cache, in place: ring bytes,
    scales, ``kv_len`` and the prelogits carry row move together, so a row
    prefilled at staging width is indistinguishable from one prefilled in
    place (same windows, so the same slot arithmetic; the copy is exact
    bytes, quantized payloads and scales included). Returns (cache, carry).
    Under data parallelism the rows are global (the carries and fills hold
    every row), and a row staged on another data rank than its destination
    moves over ``data``.

    Serving motivation: an admission prefill costs about as much however few
    rows are new, since occupied rows ride along at seqlens 0; prefilling a
    trickle of new rows in a B_s-row staging cache and adopting them makes
    admission cost proportional to the new rows."""
    from mistral_inference_tpu_torch.parallel.multihost import copy_rows

    B = cache.kv_len.shape[0]
    pairs = [(s, d) for s, d in zip(src_rows, dst_rows) if d < B]
    if not pairs:
        return cache, carry
    rings = [(cache.k, src.k), (cache.v, src.v)]
    if cache.k_scale is not None:
        rings += [(cache.k_scale, src.k_scale), (cache.v_scale, src.v_scale)]
    for ring, ring_src in rings:
        if ring.dtype.itemsize == 1:
            ring, ring_src = _bytes(ring), _bytes(ring_src)
        copy_rows(ring, ring_src, pairs, mesh, cache.row0, src.row0)
    dev = cache.kv_len.device
    si = torch.tensor([s for s, _ in pairs], dtype=torch.long, device=dev)
    di = torch.tensor([d for _, d in pairs], dtype=torch.long, device=dev)
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
