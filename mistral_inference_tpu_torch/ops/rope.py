"""Rotary position embeddings with real cos/sin pairs (counterpart of
``mistral_inference_tpu/ops/rope.py``): 1-D for the decoder, 2-D for the
vision encoder's patch grid. The head dim is viewed as adjacent (even, odd)
pairs."""

from __future__ import annotations

from typing import Tuple

import torch


def rope_for_positions(
    positions: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin at integer positions (B, T) -> two (B, T, 1, head_dim // 2)
    fp32 tensors, computed directly from the positions (no table)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (exps / head_dim))
    pos = positions.clamp_min(0).float()
    angles = pos[..., None] * freqs
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def precompute_rope_2d(
    dim: int, height: int, width: int, theta: float, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """2-D RoPE tables for vision, (height, width, dim // 2) fp32 cos/sin:
    the even frequency bands rotate by the patch's row, the odd bands by its
    column, concatenated [row bands | column bands]."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    rows = torch.outer(torch.arange(height, dtype=torch.float32, device=device), freqs[0::2])
    cols = torch.outer(torch.arange(width, dtype=torch.float32, device=device), freqs[1::2])
    angles = torch.cat([
        rows[:, None, :].expand(height, width, rows.shape[-1]),
        cols[None, :, :].expand(height, width, cols.shape[-1]),
    ], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate adjacent pairs of the last dim of x (..., n_heads, head_dim) in
    fp32 and cast back to x.dtype: (xr + i xi) * (cos + i sin), as one
    complex product (four kernels on the card where the pairwise form takes
    nine)."""
    xc = torch.view_as_complex(x.float().unflatten(-1, (-1, 2)))
    out = torch.view_as_real(xc * torch.complex(cos, sin))
    return out.flatten(-2).to(x.dtype)
