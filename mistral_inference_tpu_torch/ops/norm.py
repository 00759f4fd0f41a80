"""RMSNorm, computed in fp32 (counterpart of ``mistral_inference_tpu/ops/norm.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * weight: the normalization in fp32, cast
    back to x.dtype before the weight multiply."""
    normed = F.rms_norm(x.float(), x.shape[-1:], eps=eps)
    return normed.to(x.dtype) * weight
