"""Model configuration for the dense decoder path.

Counterpart of ``mistral_inference_tpu/args.py::TransformerArgs``, cut to the
fields the dense path reads. MoE, LoRA and vision arrive with later slices
of the port.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union


@dataclass
class TransformerArgs:
    dim: int
    n_layers: int
    head_dim: int
    hidden_dim: int
    n_heads: int
    n_kv_heads: int
    norm_eps: float
    vocab_size: int

    max_batch_size: int = 0
    # Rotary base; None means the reference default 1e6.
    rope_theta: Optional[float] = None
    # Scalar, per-layer list (tiled to n_layers), or None = full context.
    sliding_window: Optional[Union[int, List[Optional[int]]]] = None
    # KV ring element type: "bf16" (the model dtype) or "int8" with one fp32
    # scale per (token, kv-head).
    kv_quant: str = "bf16"
    # Weight quantization state: "bf16" (the model dtype), "int8" or "int4"
    # weight-only. Set by ``Transformer.quantize``.
    quant: str = "bf16"

    def __post_init__(self) -> None:
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        if self.kv_quant not in ("bf16", "int8"):
            raise ValueError(f"kv_quant must be 'bf16' or 'int8', got {self.kv_quant!r}")
        if self.quant not in ("bf16", "int8", "int4"):
            raise ValueError(f"quant must be 'bf16', 'int8' or 'int4', got {self.quant!r}")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TransformerArgs":
        """Build from a ``params.json``-style dict; unknown keys are ignored."""
        d = dict(d)
        if d.get("sliding_window") is None and d.get("_sliding_window") is not None:
            d["sliding_window"] = d["_sliding_window"]
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})
