"""Architecture presets for random-weight runs at published widths.

Counterpart of ``mistral_inference_tpu/models/registry.py`` (the dense
Mistral-7B, the sparse-MoE Mixtral and the Mamba2 Codestral-Mamba presets).
Real checkpoints carry their own ``params.json``.
"""

from __future__ import annotations

import copy
from typing import Dict, Union

from mistral_inference_tpu_torch.args import MambaArgs, MoeArgs, TransformerArgs

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
    "codestral-mamba-7b": MambaArgs(
        dim=4096, n_layers=64, vocab_size=32_768, n_groups=8, rms_norm=True,
        residual_in_fp32=True, fused_add_norm=True, pad_vocab_size_multiple=16,
        tie_embeddings=False,
    ),
}


def get_args(name: str) -> Union[TransformerArgs, MambaArgs]:
    """A fresh copy of a preset (callers may edit kv_quant, moe_impl or depth)."""
    return copy.deepcopy(REGISTRY[name])
