"""Architecture presets for random-weight runs at published widths.

Counterpart of ``mistral_inference_tpu/models/registry.py`` (the two dense
Mistral-7B presets). Real checkpoints carry their own ``params.json``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from mistral_inference_tpu_torch.args import TransformerArgs

REGISTRY: Dict[str, TransformerArgs] = {
    "mistral-7b-v0.1": TransformerArgs(
        dim=4096, n_layers=32, head_dim=128, hidden_dim=14336, n_heads=32,
        n_kv_heads=8, norm_eps=1e-5, vocab_size=32_000, rope_theta=1e4,
        sliding_window=4096,
    ),
    "mistral-7b-v0.3": TransformerArgs(
        dim=4096, n_layers=32, head_dim=128, hidden_dim=14336, n_heads=32,
        n_kv_heads=8, norm_eps=1e-5, vocab_size=32_768, rope_theta=1e6,
    ),
}


def get_args(name: str) -> TransformerArgs:
    """A fresh copy of a preset (callers may edit kv_quant or depth)."""
    return dataclasses.replace(REGISTRY[name])
