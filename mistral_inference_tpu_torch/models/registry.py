"""Architecture presets for random-weight runs at published widths.

Counterpart of ``mistral_inference_tpu/models/registry.py``: the dense
Mistral-7B, Nemo-12B, Codestral-22B, Large-2-123B and Small-3.1-24B, the
sparse-MoE Mixtral, the multimodal Pixtral-12B and the Mamba2 Codestral-Mamba
presets. Real checkpoints carry their own ``params.json``.
"""

from __future__ import annotations

import copy
from typing import Dict, Union

from mistral_inference_tpu_torch.args import (
    MambaArgs,
    MoeArgs,
    TransformerArgs,
    VisionEncoderArgs,
)

PIXTRAL_VISION = VisionEncoderArgs(
    hidden_size=1024, num_channels=3, image_size=1024, patch_size=16,
    intermediate_size=4096, num_hidden_layers=24, num_attention_heads=16,
    rope_theta=1e4, image_token_id=10,
)

REGISTRY: Dict[str, Union[TransformerArgs, MambaArgs]] = {
    "mistral-7b-v0.1": TransformerArgs(
        dim=4096, n_layers=32, head_dim=128, hidden_dim=14336, n_heads=32,
        n_kv_heads=8, norm_eps=1e-5, vocab_size=32_000, rope_theta=1e4,
        sliding_window=4096,
    ),
    "mistral-7b-v0.3": TransformerArgs(
        dim=4096, n_layers=32, head_dim=128, hidden_dim=14336, n_heads=32,
        n_kv_heads=8, norm_eps=1e-5, vocab_size=32_768, rope_theta=1e6,
    ),
    "mistral-nemo-12b": TransformerArgs(
        dim=5120, n_layers=40, head_dim=128, hidden_dim=14336, n_heads=32,
        n_kv_heads=8, norm_eps=1e-5, vocab_size=131_072, rope_theta=1e6,
    ),
    "codestral-22b": TransformerArgs(
        dim=6144, n_layers=56, head_dim=128, hidden_dim=16384, n_heads=48,
        n_kv_heads=8, norm_eps=1e-5, vocab_size=32_768, rope_theta=1e6,
    ),
    "mixtral-8x7b": TransformerArgs(
        dim=4096, n_layers=32, head_dim=128, hidden_dim=14336, n_heads=32,
        n_kv_heads=8, norm_eps=1e-5, vocab_size=32_000, rope_theta=1e6,
        moe=MoeArgs(num_experts=8, num_experts_per_tok=2),
    ),
    "mixtral-8x22b": TransformerArgs(
        dim=6144, n_layers=56, head_dim=128, hidden_dim=16384, n_heads=48,
        n_kv_heads=8, norm_eps=1e-5, vocab_size=32_768, rope_theta=1e6,
        moe=MoeArgs(num_experts=8, num_experts_per_tok=2),
    ),
    "mistral-large-2-123b": TransformerArgs(
        dim=12288, n_layers=88, head_dim=128, hidden_dim=28672, n_heads=96,
        n_kv_heads=8, norm_eps=1e-5, vocab_size=32_768, rope_theta=1e6,
    ),
    # No window: the ring holds the whole context.
    "pixtral-12b": TransformerArgs(
        dim=5120, n_layers=40, head_dim=128, hidden_dim=14336, n_heads=32,
        n_kv_heads=8, norm_eps=1e-5, vocab_size=131_072, rope_theta=1e9,
        vision_encoder=PIXTRAL_VISION,
    ),
    "mistral-small-3.1-24b": TransformerArgs(
        dim=5120, n_layers=40, head_dim=128, hidden_dim=32768, n_heads=32,
        n_kv_heads=8, norm_eps=1e-5, vocab_size=131_072, rope_theta=1e9,
    ),
    "codestral-mamba-7b": MambaArgs(
        dim=4096, n_layers=64, vocab_size=32_768, n_groups=8, rms_norm=True,
        residual_in_fp32=True, fused_add_norm=True, pad_vocab_size_multiple=16,
        tie_embeddings=False,
    ),
}


def get_args(name: str) -> Union[TransformerArgs, MambaArgs]:
    """A fresh copy of a preset (callers may edit kv_quant, moe_impl or depth)."""
    return copy.deepcopy(REGISTRY[name])
