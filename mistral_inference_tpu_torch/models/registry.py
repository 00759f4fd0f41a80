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


def param_count(name: str) -> int:
    """The parameters of preset ``name`` by the JAX package's formula, counted
    from its shapes without building it (``models.transformer.param_count``
    counts a built tree). A Mamba layer: ``in_proj`` and ``dt_proj``, the
    conv taps, ``out_proj``, ``A_log``, ``D`` and ``dt_bias``, the gated
    norm and the layer norm; a transformer layer: the attention, the
    feed-forward (an MoE's experts and router) and two norms."""
    a = get_args(name)
    if isinstance(a, MambaArgs):
        gd = a.n_groups * a.d_state
        per_layer = (
            a.dim * (2 * a.d_inner + 2 * gd + a.n_ssm_heads)
            + a.d_conv * (a.d_inner + 2 * gd)
            + a.d_inner * a.dim
            + 3 * a.n_ssm_heads
            + a.d_inner
            + a.dim
        )
        total = a.n_layers * per_layer + a.padded_vocab_size * a.dim + a.dim
        if not a.tie_embeddings:
            total += a.padded_vocab_size * a.dim
        return total
    attn = a.dim * (a.n_heads + 2 * a.n_kv_heads) * a.head_dim + a.n_heads * a.head_dim * a.dim
    ffn = 3 * a.dim * a.hidden_dim
    if a.moe:
        ffn = a.moe.num_experts * ffn + a.dim * a.moe.num_experts
    per_layer = attn + ffn + 2 * a.dim
    return a.n_layers * per_layer + 2 * a.vocab_size * a.dim + a.dim
