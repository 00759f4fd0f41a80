"""Attention kernels of the dense path: wrappers, launch counters and plain
PyTorch versions (counterpart of ``mistral_inference_tpu/ops/pallas/attention.py``).

Six hand-written CUDA kernels for Hopper (sources in ``csrc/``, built by
``_build.py``):

* ``flash_attention`` (K1, ``csrc/flash_attention.cu``): a chunk's attention
  to its own keys, optionally with online-softmax stats, on the Hopper tile
  loop of ``csrc/flash_hopper.cuh`` (wgmma, an asynchronous K/V pipeline,
  visibility decided per tile), the long walks of a causal chunk first.
* ``ring_attention_stats`` (K4, ``csrc/ring_attention.cu``): a chunk's
  queries over one layer's stored ring, with stats, on the same tile loop.
* ``fused_update_decode_attention`` (K2, ``csrc/fused_decode.cu``): one
  decode step's ring write plus ring-only attention.
* ``decode_attention`` (K6, ``csrc/decode_attention.cu``): T = 1 attention
  over one layer of the stacked ring, for the decode route that writes the
  ring with ``update_stacked``.
* ``fused_verify_chunk_attention`` (K7, ``csrc/fused_decode.cu``): a
  speculative verify chunk's T candidate K/V written to consecutive ring
  slots, then all T queries attending ring-only.

  K2, K6 and K7 run one loop, ``csrc/decode_hopper.cuh`` (K2 and K7 with the
  ring write in front): a thread-block cluster per (row, KV head) streams the
  visible slots and merges its partials in distributed shared memory, in one
  launch. So K2 gives K6's bits over the ring it has written, and K7's query
  t a K2 step's bits at its position.
* ``segment_flash_attention`` (K10, ``csrc/segment_attention.cu``, the
  head-dim-64 segment-mask instantiation of K4's Hopper tile loop): the
  vision encoder's non-causal attention, where a patch sees only its own
  segment.

The four kernels that read or write the KV ring (K4, K2, K6, K7) are each
built for three ring types, picked by the ring's dtype: int8 and
float8_e4m3fn, both with fp32 scales per (slot, kv head), and bf16. A ring of
any other dtype raises.

Each wrapper launches its kernel for CUDA tensors, and for nothing else: on
CPU tensors it runs the plain version in this module, which computes the
same function with the same rounding points. There is no fallback from a
CUDA tensor to the plain version. Each wrapper counts its kernel launches in
its ``launches`` attribute, and the float8 instantiation of each ring kernel
its own launches in ``FP8_LAUNCHES[wrapper]`` as well.

The mask is position arithmetic (``0 <= q_pos - kv_pos < window`` with
validity flags), or for K10 segment equality. A query row that sees no key returns 0 with m = -1e30 and
l = 0, the convention ``merge_attention_parts`` relies on.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from mistral_inference_tpu_torch.cache import _bytes, _quantize_ring
from mistral_inference_tpu_torch.ops.attention import NEG_INF, sliding_window_mask
from mistral_inference_tpu_torch.ops.cuda import _call

_P, _I, _F = _call.P, _call.I, _call.F
_SIGS = {
    ("flash_attention", "flash_attention_bf16"): [_P] * 7 + [_I] + [_P] * 3 + [_I] * 5 + [_F, _P],
    **{("ring_attention", f"ring_attention_stats_{kind}"):
       [_P] * 9 + [_I] + [_P] * 3 + [_I] * 5 + [_F, _P] for kind in ("int8", "fp8")},
    ("ring_attention", "ring_attention_stats_bf16"): [_P] * 7 + [_I] + [_P] * 3 + [_I] * 5 + [_F, _P],
    **{("fused_decode", f"fused_decode_{kind}"):
       [_P] * 7 + [_I, _I] + [_P] * 5 + [_I] * 4 + [_F, _P] for kind in ("int8", "fp8")},
    ("fused_decode", "fused_decode_bf16"): [_P] * 5 + [_I, _I] + [_P] * 5 + [_I] * 4 + [_F, _P],
    **{("decode_attention", f"decode_attention_{kind}"):
       [_P] * 5 + [_I, _I] + [_P] * 4 + [_I] * 4 + [_F, _P] for kind in ("int8", "fp8")},
    ("decode_attention", "decode_attention_bf16"): [_P] * 3 + [_I, _I] + [_P] * 4 + [_I] * 4 + [_F, _P],
    **{("fused_decode", f"fused_verify_{kind}"):
       [_P] * 7 + [_I, _I] + [_P] * 5 + [_I] * 5 + [_F, _P] for kind in ("int8", "fp8")},
    ("fused_decode", "fused_verify_bf16"): [_P] * 5 + [_I, _I] + [_P] * 5 + [_I] * 5 + [_F, _P],
    ("segment_attention", "flash_attention_seg_bf16"): [_P] * 5 + [_I] * 3 + [_F, _P],
}
_launch = functools.partial(_call.launch, _SIGS)
_need = _call.need


# The ring dtypes the ring kernels are built for, by the suffix of their symbols.
_RING_KINDS = {torch.int8: "int8", torch.float8_e4m3fn: "fp8", torch.bfloat16: "bf16"}


def _ring_kind(ring: torch.Tensor, scale: Optional[torch.Tensor]) -> str:
    """The instantiation that takes ``ring``: "int8" or "fp8" (scaled rings,
    which come with fp32 scales) or "bf16" (none). Raises on any other ring
    dtype, and on scales that do not match the ring."""
    kind = _RING_KINDS.get(ring.dtype)
    if kind is None:
        raise TypeError(f"the ring must be int8, float8_e4m3fn or bf16, got {ring.dtype}")
    if (scale is None) != (kind == "bf16"):
        raise ValueError(f"a {kind} ring takes {'no' if kind == 'bf16' else 'fp32'} scales")
    return kind


def _counted(wrapper, kind: str) -> None:
    """Count one launch of ``wrapper``'s ``kind`` instantiation."""
    wrapper.launches += 1
    if kind == "fp8":
        FP8_LAUNCHES[wrapper].launches += 1


def _meta(x: torch.Tensor, name: str, dtype, shape, device) -> torch.Tensor:
    """Positions (int32) and validity flags (bool), read one element at a
    time: cast and made contiguous only where needed (a no-op cast still
    costs a dispatch, and the host bounds decode), then shape-checked."""
    if x.dtype != dtype or not x.is_contiguous():
        x = x.to(dtype).contiguous()
    if x.device != device or tuple(x.shape) != tuple(shape):
        raise ValueError(
            f"{name} must have shape {tuple(shape)} on {device}, "
            f"got {tuple(x.shape)} on {x.device}"
        )
    return x


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def attend_stats_plain(
    q: torch.Tensor,  # (B, T, H, D)
    k: torch.Tensor,  # (B, S, Hkv, D), any ring dtype
    v: torch.Tensor,
    k_scale: Optional[torch.Tensor],  # (B, Hkv, S) fp32, or None
    v_scale: Optional[torch.Tensor],
    q_pos: torch.Tensor,  # (B, T)
    kv_pos: torch.Tensor,  # (B, S)
    q_valid: torch.Tensor,  # (B, T) bool
    kv_valid: torch.Tensor,  # (B, S) bool
    window: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The function K1, K4, K2, K6 and K7 compute, written out: fp32 dots,
    the key scale after the dot, probabilities (times the value scale)
    rounded to q.dtype before the PV product. Returns (out (B, T, H, D) in
    q.dtype, m (B, T, H) fp32, l (B, T, H) fp32)."""
    mask = sliding_window_mask(q_pos, kv_pos, q_valid, kv_valid, window)
    return _attend_masked_plain(q, k, v, k_scale, v_scale, mask)


def _attend_masked_plain(q, k, v, k_scale, v_scale, mask):
    """attend_stats_plain under any (B, T, S) boolean mask."""
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = D**-0.5
    qg = q.reshape(B, T, Hkv, G, D).float()
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k.float())
    if k_scale is not None:
        scores = scores * (k_scale.float()[:, :, None, None, :] * scale)
    else:
        scores = scores * scale
    mask = mask[:, None, None]
    m = torch.where(mask, scores, NEG_INF).amax(dim=-1)  # (B, Hkv, G, T)
    p = torch.where(mask, torch.exp(scores - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    if v_scale is not None:
        p = p * v_scale.float()[:, :, None, None, :]
    acc = torch.einsum("bhgts,bshd->bhgtd", p.to(q.dtype).float(), v.float())
    out = torch.where(l[..., None] > 0, acc / l[..., None], 0.0)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, T, H, D).to(q.dtype)
    return out, m.permute(0, 3, 1, 2).reshape(B, T, H), l.permute(0, 3, 1, 2).reshape(B, T, H)


def segment_attention_plain(
    q: torch.Tensor,  # (B, N, H, D)
    k: torch.Tensor,  # (B, N, H, D)
    v: torch.Tensor,
    seg: torch.Tensor,  # (B, N) int segment ids
) -> torch.Tensor:
    """Plain version of K10: a masked softmax in fp32 where query t sees key
    s iff seg[t] == seg[s], probabilities rounded to q.dtype before the PV
    product as the kernel rounds them. Returns (B, N, H * D)."""
    B, N, H, D = q.shape
    mask = seg[:, :, None] == seg[:, None, :]
    out, _, _ = _attend_masked_plain(q, k, v, None, None, mask)
    return out.reshape(B, N, H * D)


def merge_attention_parts(o1, m1, l1, o2, m2, l2) -> torch.Tensor:
    """Exactly combine two partial attentions over disjoint key sets, each
    normalized within its part with stats (m, l): softmax over the union is
    the merge weighted by exp(m_i - max(m)) * l_i. A row that sees no key in
    one part returns the other part's bits as they are (not o * w / w, which
    may round to a neighbour): a row whose ring is still empty gets exactly
    its chunk-only attention. Rows empty in both parts return 0. o: (B, T,
    H, D); m, l: (B, T, H). Plain PyTorch on every device."""
    m = torch.maximum(m1, m2)
    w1 = torch.where(l1 > 0, torch.exp(m1 - m), 0.0) * l1
    w2 = torch.where(l2 > 0, torch.exp(m2 - m), 0.0) * l2
    denom = (w1 + w2).clamp_min(1e-30)[..., None]
    merged = ((o1.float() * w1[..., None] + o2.float() * w2[..., None]) / denom).to(o1.dtype)
    merged = torch.where((l2 > 0)[..., None], merged, o1)
    return torch.where((l1 > 0)[..., None], merged, o2)


def _ring_write_plain(xk, xv, CK, CV, KS, VS, li: int, write_slot) -> None:
    """Rows with write_slot >= 0 write their T tokens (xk, xv: (B, T, Hkv, D))
    into slots write_slot, write_slot + 1, ... of layer ``li``, in place."""
    T = xk.shape[1]
    rows = (write_slot >= 0).nonzero(as_tuple=True)[0]
    steps = torch.arange(T, device=xk.device)
    slots = write_slot[rows].long()[:, None] + steps  # (N, T)
    k_new, v_new = xk[rows], xv[rows]  # (N, T, Hkv, D)
    n = rows.shape[0]
    if KS is not None:
        k_new, k_s = _quantize_ring(k_new, CK.dtype)
        v_new, v_s = _quantize_ring(v_new, CV.dtype)
        KS[li, rows[:, None], :, slots] = k_s
        VS[li, rows[:, None], :, slots] = v_s
    HD = CK.shape[-1]  # not -1: no row may write (n = 0)
    _bytes(CK)[li, rows[:, None], slots] = _bytes(k_new.reshape(n, T, HD).to(CK.dtype))
    _bytes(CV)[li, rows[:, None], slots] = _bytes(v_new.reshape(n, T, HD).to(CV.dtype))


def fused_update_decode_attention_plain(
    xq, xk, xv, CK, CV, KS, VS, li, window, write_slot, q_pos, kv_pos, kv_valid
) -> torch.Tensor:
    """Plain version of K2: the ring write of update_stacked for T = 1 (in
    place), then ring-only attention. Returns (B, 1, H * D)."""
    B, _, H, D = xq.shape
    S, Hkv = CK.shape[2], xk.shape[2]
    _ring_write_plain(xk, xv, CK, CV, KS, VS, li, write_slot)
    out, _, _ = attend_stats_plain(
        xq, CK[li].reshape(B, S, Hkv, D), CV[li].reshape(B, S, Hkv, D),
        None if KS is None else KS[li], None if VS is None else VS[li],
        q_pos.reshape(B, 1), kv_pos,
        torch.ones((B, 1), dtype=torch.bool, device=xq.device), kv_valid, window,
    )
    return out.reshape(B, 1, H * D)


def decode_attention_plain(
    q, CK, CV, KS, VS, li, q_pos, kv_pos, kv_valid, window
) -> torch.Tensor:
    """Plain version of K6: T = 1 attention over layer ``li`` of the stacked
    ring as it stands, nothing written. Returns (B, 1, H * D)."""
    B, _, H, D = q.shape
    S = CK.shape[2]
    Hkv = CK.shape[3] // D
    out, _, _ = attend_stats_plain(
        q, CK[li].reshape(B, S, Hkv, D), CV[li].reshape(B, S, Hkv, D),
        None if KS is None else KS[li], None if VS is None else VS[li],
        q_pos.reshape(B, 1), kv_pos,
        torch.ones((B, 1), dtype=torch.bool, device=q.device), kv_valid, window,
    )
    return out.reshape(B, 1, H * D)


def fused_verify_chunk_attention_plain(
    xq, xk, xv, CK, CV, KS, VS, li, window, write_slot0, q_pos, kv_pos, kv_valid
) -> torch.Tensor:
    """Plain version of K7: the ring write of update_stacked for all T chunk
    tokens of every live row (in place, slots write_slot0 .. write_slot0 +
    T - 1), then ring-only attention of every query at its own position.
    Returns (B, T, H * D)."""
    B, T, H, D = xq.shape
    S, Hkv = CK.shape[2], xk.shape[2]
    _ring_write_plain(xk, xv, CK, CV, KS, VS, li, write_slot0)
    out, _, _ = attend_stats_plain(
        xq, CK[li].reshape(B, S, Hkv, D), CV[li].reshape(B, S, Hkv, D),
        None if KS is None else KS[li], None if VS is None else VS[li],
        q_pos.reshape(B, T), kv_pos,
        torch.ones((B, T), dtype=torch.bool, device=xq.device), kv_valid, window,
    )
    return out.reshape(B, T, H * D)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def flash_attention(
    q: torch.Tensor,  # (B, T, H, D) bf16 on the card
    k: torch.Tensor,  # (B, S, Hkv, D)
    v: torch.Tensor,
    q_pos: torch.Tensor,  # (B, T) int32
    kv_pos: torch.Tensor,  # (B, S) int32
    q_valid: torch.Tensor,  # (B, T) bool
    kv_valid: torch.Tensor,  # (B, S) bool
    window: int,
    return_stats: bool = False,
):
    """K1. Returns (B, T, H * D), or with ``return_stats`` the tuple
    ((B, T, H, D) out, (B, T, H) m, (B, T, H) l)."""
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if not q.is_cuda:
        out, m, l = attend_stats_plain(
            q, k, v, None, None, q_pos, kv_pos, q_valid, kv_valid, int(window)
        )
    else:
        dev = q.device
        bf = torch.bfloat16
        _need(q, "q", bf, (B, T, H, D), dev)
        _need(k, "k", bf, (B, S, Hkv, D), dev)
        _need(v, "v", bf, (B, S, Hkv, D), dev)
        if D != 128:
            raise ValueError("the CUDA kernels take head_dim 128")
        qp = _meta(q_pos, "q_pos", torch.int32, (B, T), dev)
        kp = _meta(kv_pos, "kv_pos", torch.int32, (B, S), dev)
        qv = _meta(q_valid, "q_valid", torch.bool, (B, T), dev)
        kv = _meta(kv_valid, "kv_valid", torch.bool, (B, S), dev)
        out = torch.empty((B, T, H, D), dtype=bf, device=dev)
        m = l = None
        if return_stats:
            m = torch.empty((B, T, H), dtype=torch.float32, device=dev)
            l = torch.empty((B, T, H), dtype=torch.float32, device=dev)
        _launch(
            "flash_attention", "flash_attention_bf16", dev,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(), kp.data_ptr(),
            qv.data_ptr(), kv.data_ptr(), int(window), out.data_ptr(),
            None if m is None else m.data_ptr(), None if l is None else l.data_ptr(),
            B, T, S, H, Hkv, D**-0.5,
        )
        flash_attention.launches += 1
    if return_stats:
        return out, m, l
    return out.reshape(B, T, H * D)


flash_attention.launches = 0


def ring_attention_stats(
    q: torch.Tensor,  # (B, T, H, D)
    kq: torch.Tensor,  # (B, S, Hkv * D) stored ring layout, int8, fp8 or bf16
    vq: torch.Tensor,
    k_scale: Optional[torch.Tensor],  # (B, Hkv, S) fp32 for scaled rings, else None
    v_scale: Optional[torch.Tensor],
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    q_valid: torch.Tensor,
    kv_valid: torch.Tensor,
    window: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4. Returns (out (B, T, H, D), m (B, T, H), l (B, T, H)) for
    merge_attention_parts."""
    B, T, H, D = q.shape
    S = kq.shape[1]
    Hkv = kq.shape[2] // D
    if not q.is_cuda:
        return attend_stats_plain(
            q, kq.reshape(B, S, Hkv, D), vq.reshape(B, S, Hkv, D), k_scale, v_scale,
            q_pos, kv_pos, q_valid, kv_valid, int(window),
        )
    dev = q.device
    _need(q, "q", torch.bfloat16, (B, T, H, D), dev)
    if D != 128:
        raise ValueError("the CUDA kernels take head_dim 128")
    kind = _ring_kind(kq, k_scale)
    _need(kq, "kq", kq.dtype, (B, S, Hkv * D), dev)
    _need(vq, "vq", kq.dtype, (B, S, Hkv * D), dev)
    qp = _meta(q_pos, "q_pos", torch.int32, (B, T), dev)
    kp = _meta(kv_pos, "kv_pos", torch.int32, (B, S), dev)
    qv = _meta(q_valid, "q_valid", torch.bool, (B, T), dev)
    kv = _meta(kv_valid, "kv_valid", torch.bool, (B, S), dev)
    out = torch.empty((B, T, H, D), dtype=torch.bfloat16, device=dev)
    m = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    l = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    tail = (
        qp.data_ptr(), kp.data_ptr(), qv.data_ptr(), kv.data_ptr(), int(window),
        out.data_ptr(), m.data_ptr(), l.data_ptr(), B, T, S, H, Hkv, D**-0.5,
    )
    if kind != "bf16":
        _need(k_scale, "k_scale", torch.float32, (B, Hkv, S), dev)
        _need(v_scale, "v_scale", torch.float32, (B, Hkv, S), dev)
        _launch(
            "ring_attention", f"ring_attention_stats_{kind}", dev, q.data_ptr(),
            kq.data_ptr(), vq.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(), *tail,
        )
    else:
        _launch(
            "ring_attention", "ring_attention_stats_bf16", dev, q.data_ptr(),
            kq.data_ptr(), vq.data_ptr(), *tail,
        )
    _counted(ring_attention_stats, kind)
    return out, m, l


ring_attention_stats.launches = 0


def fused_update_decode_attention(
    xq: torch.Tensor,  # (B, 1, H, D)
    xk: torch.Tensor,  # (B, 1, Hkv, D) post-rope, pre-quantization
    xv: torch.Tensor,
    CK: torch.Tensor,  # (L, B, S, Hkv * D) ring, updated IN PLACE
    CV: torch.Tensor,
    KS: Optional[torch.Tensor],  # (L, B, Hkv, S) fp32, updated in place; None for bf16
    VS: Optional[torch.Tensor],
    li: int,
    window: int,
    write_slot: torch.Tensor,  # (B,) int32, -1 = write nothing for this row
    q_pos: torch.Tensor,  # (B,) int32
    kv_pos: torch.Tensor,  # (B, S) int32, slot positions AFTER the write
    kv_valid: torch.Tensor,  # (B, S) bool
) -> torch.Tensor:
    """K2. Writes this step's K/V into layer ``li`` of the ring in place (the
    JAX kernel returns aliased buffers instead), then attends ring-only.
    Returns (B, 1, H * D)."""
    B, _, H, D = xq.shape
    L, S = CK.shape[0], CK.shape[2]
    Hkv = xk.shape[2]
    if not xq.is_cuda:
        return fused_update_decode_attention_plain(
            xq, xk, xv, CK, CV, KS, VS, int(li), int(window), write_slot, q_pos,
            kv_pos, kv_valid,
        )
    dev = xq.device
    bf = torch.bfloat16
    if D != 128:
        raise ValueError("the CUDA kernels take head_dim 128")
    _need(xq, "xq", bf, (B, 1, H, D), dev)
    _need(xk, "xk", bf, (B, 1, Hkv, D), dev)
    _need(xv, "xv", bf, (B, 1, Hkv, D), dev)
    kind = _ring_kind(CK, KS)
    _need(CK, "CK", CK.dtype, (L, B, S, Hkv * D), dev)
    _need(CV, "CV", CK.dtype, (L, B, S, Hkv * D), dev)
    if not 0 <= int(li) < L:
        raise ValueError(f"layer index {li} out of range for {L} layers")
    ws = _meta(write_slot, "write_slot", torch.int32, (B,), dev)
    qp = _meta(q_pos, "q_pos", torch.int32, (B,), dev)
    kp = _meta(kv_pos, "kv_pos", torch.int32, (B, S), dev)
    kv = _meta(kv_valid, "kv_valid", torch.bool, (B, S), dev)
    out = torch.empty((B, 1, H * D), dtype=bf, device=dev)
    tail = (
        int(li), int(window), ws.data_ptr(), qp.data_ptr(), kp.data_ptr(),
        kv.data_ptr(), out.data_ptr(), B, S, H, Hkv, D**-0.5,
    )
    if kind != "bf16":
        _need(KS, "KS", torch.float32, (L, B, Hkv, S), dev)
        _need(VS, "VS", torch.float32, (L, B, Hkv, S), dev)
        _launch(
            "fused_decode", f"fused_decode_{kind}", dev, xq.data_ptr(), xk.data_ptr(),
            xv.data_ptr(), CK.data_ptr(), CV.data_ptr(), KS.data_ptr(), VS.data_ptr(),
            *tail,
        )
    else:
        _launch(
            "fused_decode", "fused_decode_bf16", dev, xq.data_ptr(), xk.data_ptr(),
            xv.data_ptr(), CK.data_ptr(), CV.data_ptr(), *tail,
        )
    _counted(fused_update_decode_attention, kind)
    return out


fused_update_decode_attention.launches = 0


DECODE_MAX_GROUP = 8  # query heads per KV head K6 takes


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, D)
    CK: torch.Tensor,  # (L, B, S, Hkv * D) ring, read only
    CV: torch.Tensor,
    KS: Optional[torch.Tensor],  # (L, B, Hkv, S) fp32; None for bf16 rings
    VS: Optional[torch.Tensor],
    li: int,
    q_pos: torch.Tensor,  # (B, 1) or (B,) int32
    kv_pos: torch.Tensor,  # (B, S) int32
    kv_valid: torch.Tensor,  # (B, S) bool
    window: int,
) -> torch.Tensor:
    """K6. T = 1 attention over layer ``li`` of the stacked ring, read in
    place through the layer index (no slice is copied) and not written. Up
    to 8 query heads per KV head. Returns (B, 1, H * D)."""
    B, T, H, D = q.shape
    if T != 1:
        raise ValueError("decode_attention takes one query token per row")
    if q_pos.numel() != B:
        raise ValueError(f"q_pos must hold one position per row, got {tuple(q_pos.shape)}")
    L, S = CK.shape[0], CK.shape[2]
    Hkv = CK.shape[3] // D
    if not q.is_cuda:
        return decode_attention_plain(
            q, CK, CV, KS, VS, int(li), q_pos, kv_pos, kv_valid, int(window)
        )
    dev = q.device
    bf = torch.bfloat16
    if D != 128:
        raise ValueError("the CUDA kernels take head_dim 128")
    if H % Hkv or H // Hkv > DECODE_MAX_GROUP:
        raise ValueError(
            f"decode_attention takes at most {DECODE_MAX_GROUP} query heads per KV head, "
            f"got {H} heads over {Hkv}"
        )
    _need(q, "q", bf, (B, 1, H, D), dev)
    kind = _ring_kind(CK, KS)
    _need(CK, "CK", CK.dtype, (L, B, S, Hkv * D), dev)
    _need(CV, "CV", CK.dtype, (L, B, S, Hkv * D), dev)
    if not 0 <= int(li) < L:
        raise ValueError(f"layer index {li} out of range for {L} layers")
    qp = _meta(q_pos, "q_pos", torch.int32, tuple(q_pos.shape), dev)
    kp = _meta(kv_pos, "kv_pos", torch.int32, (B, S), dev)
    kv = _meta(kv_valid, "kv_valid", torch.bool, (B, S), dev)
    out = torch.empty((B, 1, H * D), dtype=bf, device=dev)
    tail = (
        int(li), int(window), qp.data_ptr(), kp.data_ptr(), kv.data_ptr(), out.data_ptr(),
        B, S, H, Hkv, D**-0.5,
    )
    if kind != "bf16":
        _need(KS, "KS", torch.float32, (L, B, Hkv, S), dev)
        _need(VS, "VS", torch.float32, (L, B, Hkv, S), dev)
        _launch(
            "decode_attention", f"decode_attention_{kind}", dev, q.data_ptr(), CK.data_ptr(),
            CV.data_ptr(), KS.data_ptr(), VS.data_ptr(), *tail,
        )
    else:
        _launch(
            "decode_attention", "decode_attention_bf16", dev, q.data_ptr(), CK.data_ptr(),
            CV.data_ptr(), *tail,
        )
    _counted(decode_attention, kind)
    return out


decode_attention.launches = 0


VERIFY_MAX_TOKENS = 8  # chunk tokens K7 takes
VERIFY_MAX_ROWS = 32  # and query rows per KV head (query heads per KV head x tokens): kMaxRows


def fused_verify_chunk_attention(
    xq: torch.Tensor,  # (B, T, H, D), T <= 8
    xk: torch.Tensor,  # (B, T, Hkv, D) post-rope, pre-quantization
    xv: torch.Tensor,
    CK: torch.Tensor,  # (L, B, S, Hkv * D) ring, updated IN PLACE
    CV: torch.Tensor,
    KS: Optional[torch.Tensor],  # (L, B, Hkv, S) fp32, updated in place; None for bf16
    VS: Optional[torch.Tensor],
    li: int,
    window: int,
    write_slot0: torch.Tensor,  # (B,) int32 slot of the chunk's first token, -1 = dead row
    q_pos: torch.Tensor,  # (B, T) int32
    kv_pos: torch.Tensor,  # (B, S) int32, slot positions AFTER the write
    kv_valid: torch.Tensor,  # (B, S) bool
) -> torch.Tensor:
    """K7. Writes a speculative verify chunk's T candidate K/V into T
    consecutive slots of layer ``li`` of the ring in place (the JAX kernel
    returns aliased buffers instead), then attends every query ring-only:
    query t sees the slots whose position is at most its own, so causality
    inside the chunk is position arithmetic. Only for a ring that never
    wraps (``write_slot0 + T <= window``): a rejected candidate stays in its
    slot, hidden by ``kv_len``, until the real token of that position
    overwrites it. Returns (B, T, H * D)."""
    B, T, H, D = xq.shape
    L, S = CK.shape[0], CK.shape[2]
    Hkv = xk.shape[2]
    if not 1 <= T <= VERIFY_MAX_TOKENS:
        raise ValueError(
            f"fused_verify_chunk_attention takes 1..{VERIFY_MAX_TOKENS} tokens, got {T}"
        )
    if not xq.is_cuda:
        return fused_verify_chunk_attention_plain(
            xq, xk, xv, CK, CV, KS, VS, int(li), int(window), write_slot0, q_pos,
            kv_pos, kv_valid,
        )
    dev = xq.device
    bf = torch.bfloat16
    if D != 128:
        raise ValueError("the CUDA kernels take head_dim 128")
    if H % Hkv or (H // Hkv) * T > VERIFY_MAX_ROWS:
        raise ValueError(
            f"the kernel takes at most {VERIFY_MAX_ROWS} query rows per KV head, got "
            f"{H // Hkv} heads x {T} tokens"
        )
    _need(xq, "xq", bf, (B, T, H, D), dev)
    _need(xk, "xk", bf, (B, T, Hkv, D), dev)
    _need(xv, "xv", bf, (B, T, Hkv, D), dev)
    kind = _ring_kind(CK, KS)
    _need(CK, "CK", CK.dtype, (L, B, S, Hkv * D), dev)
    _need(CV, "CV", CK.dtype, (L, B, S, Hkv * D), dev)
    if not 0 <= int(li) < L:
        raise ValueError(f"layer index {li} out of range for {L} layers")
    ws = _meta(write_slot0, "write_slot0", torch.int32, (B,), dev)
    qp = _meta(q_pos, "q_pos", torch.int32, (B, T), dev)
    kp = _meta(kv_pos, "kv_pos", torch.int32, (B, S), dev)
    kv = _meta(kv_valid, "kv_valid", torch.bool, (B, S), dev)
    out = torch.empty((B, T, H * D), dtype=bf, device=dev)
    tail = (
        int(li), int(window), ws.data_ptr(), qp.data_ptr(), kp.data_ptr(),
        kv.data_ptr(), out.data_ptr(), B, T, S, H, Hkv, D**-0.5,
    )
    if kind != "bf16":
        _need(KS, "KS", torch.float32, (L, B, Hkv, S), dev)
        _need(VS, "VS", torch.float32, (L, B, Hkv, S), dev)
        _launch(
            "fused_decode", f"fused_verify_{kind}", dev, xq.data_ptr(), xk.data_ptr(),
            xv.data_ptr(), CK.data_ptr(), CV.data_ptr(), KS.data_ptr(), VS.data_ptr(),
            *tail,
        )
    else:
        _launch(
            "fused_decode", "fused_verify_bf16", dev, xq.data_ptr(), xk.data_ptr(),
            xv.data_ptr(), CK.data_ptr(), CV.data_ptr(), *tail,
        )
    _counted(fused_verify_chunk_attention, kind)
    return out


fused_verify_chunk_attention.launches = 0

SEGMENT_HEAD_DIM = 64  # the head dim K10 is built for (Pixtral's encoder)


def segment_flash_attention(
    q: torch.Tensor,  # (B, N, H, D) bf16 on the card
    k: torch.Tensor,  # (B, N, H, D)
    v: torch.Tensor,
    seg: torch.Tensor,  # (B, N) int32 segment ids: a patch sees its own segment only
) -> torch.Tensor:
    """K10, the vision encoder's attention. Returns (B, N, H * D).

    Every N goes through the kernel: the JAX package's gate on the stock TPU
    kernel, N >= 512 and N % 512 == 0, follows that kernel's block sizes, and
    the 128-row tiles here take any N."""
    B, N, H, D = q.shape
    if not q.is_cuda:
        return segment_attention_plain(q, k, v, seg)
    dev = q.device
    bf = torch.bfloat16
    if D != SEGMENT_HEAD_DIM:
        raise ValueError(f"the segment kernel takes head_dim {SEGMENT_HEAD_DIM}, got {D}")
    _need(q, "q", bf, (B, N, H, D), dev)
    _need(k, "k", bf, (B, N, H, D), dev)
    _need(v, "v", bf, (B, N, H, D), dev)
    sg = _meta(seg, "seg", torch.int32, (B, N), dev)
    out = torch.empty((B, N, H * D), dtype=bf, device=dev)
    _launch(
        "segment_attention", "flash_attention_seg_bf16", dev, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), sg.data_ptr(), out.data_ptr(), B, N, H, D**-0.5,
    )
    segment_flash_attention.launches += 1
    return out


segment_flash_attention.launches = 0



class LaunchCount:
    """The launch counter of one instantiation of a wrapper's kernel: a name
    and a ``launches`` count, beside the wrapper's own."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0


# The float8 ring instantiations of the four ring kernels, counted apart.
FP8_LAUNCHES = {
    fn: LaunchCount(f"{fn.__name__}_fp8")
    for fn in (ring_attention_stats, fused_update_decode_attention, decode_attention,
               fused_verify_chunk_attention)
}

KERNELS = (
    flash_attention, ring_attention_stats, fused_update_decode_attention, decode_attention,
    fused_verify_chunk_attention, segment_flash_attention, *FP8_LAUNCHES.values(),
)
