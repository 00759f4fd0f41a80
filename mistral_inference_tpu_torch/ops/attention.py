"""Masked GQA attention written out in plain PyTorch: the oracle the CUDA
kernels' plain versions are checked against (counterpart of
``mistral_inference_tpu/ops/attention.py``).

The mask is position arithmetic: key j is visible to query i iff
``0 <= q_pos - kv_pos < window`` and both are valid. GQA groups query heads
over KV heads without repeating K/V.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # finite, so fully-masked rows never make NaNs


def attend(
    q: torch.Tensor,  # (B, T, H, D)
    k: torch.Tensor,  # (B, S, Hkv, D)
    v: torch.Tensor,  # (B, S, Hkv, D)
    mask: Optional[torch.Tensor],  # (B, T, S) bool, True = may attend
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Returns (B, T, H * D) in q.dtype; logits and softmax in fp32."""
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    if scale is None:
        scale = D**-0.5
    qg = q.reshape(B, T, Hkv, G, D).float()
    logits = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) * scale
    if mask is not None:
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype).reshape(B, T, H * D)


def attend_scaled(
    q: torch.Tensor,  # (B, T, H, D)
    kq: torch.Tensor,  # (B, S, Hkv, D) quantized ring values
    vq: torch.Tensor,
    k_scale: torch.Tensor,  # (B, S, Hkv) fp32
    v_scale: torch.Tensor,
    mask: Optional[torch.Tensor],  # (B, T, S) bool
    scale: Optional[float] = None,
) -> torch.Tensor:
    """GQA attention over a scaled ring with the scales applied after the
    dots: logits * k_scale_j per key, (probs * v_scale_j) @ v_raw."""
    B, T, H, D = q.shape
    S, Hkv = kq.shape[1], kq.shape[2]
    G = H // Hkv
    if scale is None:
        scale = D**-0.5
    qg = q.reshape(B, T, Hkv, G, D).float()
    logits = torch.einsum("bthgd,bshd->bhgts", qg, kq.float())
    ks = k_scale.float().permute(0, 2, 1)[:, :, None, None, :]  # (B, Hkv, 1, 1, S)
    logits = logits * (ks * scale)
    if mask is not None:
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    vs = v_scale.float().permute(0, 2, 1)[:, :, None, None, :]
    out = torch.einsum("bhgts,bshd->bthgd", probs * vs, vq.float())
    return out.to(q.dtype).reshape(B, T, H * D)


def sliding_window_mask(
    q_pos: torch.Tensor,  # (B, T) int32
    kv_pos: torch.Tensor,  # (B, S) int32
    q_valid: torch.Tensor,  # (B, T) bool
    kv_valid: torch.Tensor,  # (B, S) bool
    window: int,
) -> torch.Tensor:
    """Causal + local mask: allowed iff 0 <= q_pos - kv_pos < window."""
    delta = q_pos[:, :, None] - kv_pos[:, None, :]
    allowed = (delta >= 0) & (delta < window)
    return allowed & q_valid[:, :, None] & kv_valid[:, None, :]
