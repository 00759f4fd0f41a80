"""Model configuration: the decoder, dense or sparse-MoE, and the Mamba2
family.

Counterpart of ``mistral_inference_tpu/args.py::TransformerArgs``,
``::MoeArgs``, ``::VisionEncoderArgs`` and ``::MambaArgs``, cut to the fields
the ported paths read. LoRA arrives with a later slice of the port.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union

PATCH_MERGE = "patch_merge"


@dataclass
class MoeArgs:
    num_experts: int
    num_experts_per_tok: int

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MoeArgs":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclass(frozen=True)
class VisionEncoderArgs:
    """The Pixtral vision encoder: a pre-norm transformer over image patches
    with 2-D RoPE, then an optional PatchMerger and a GELU adapter to the
    decoder's width."""

    hidden_size: int
    num_channels: int
    image_size: int
    patch_size: int
    intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    rope_theta: float = 1e4  # of the 2-D RoPE
    image_token_id: int = 10
    adapter_bias: bool = True
    spatial_merge_size: int = 1
    add_pre_mm_projector_layer_norm: bool = False
    mm_projector_id: str = ""

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "VisionEncoderArgs":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


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
    # Sparse mixture of experts in place of the dense feed-forward.
    moe: Optional[MoeArgs] = None
    # Scalar, per-layer list (tiled to n_layers), or None = full context.
    sliding_window: Optional[Union[int, List[Optional[int]]]] = None
    # KV ring element type: "bf16" (the model dtype), or "fp8"
    # (float8_e4m3fn) or "int8" with one fp32 scale per (token, kv-head).
    kv_quant: str = "bf16"
    # Weight quantization state: "bf16" (the model dtype), "int8" or "int4"
    # weight-only. Set by ``Transformer.quantize``.
    quant: str = "bf16"
    # MoE compute strategy: "dense" evaluates every expert on every token
    # (exact, the oracle); "dispatch" routes tokens into per-expert capacity
    # buffers (assignments over an expert's capacity contribute zero) and,
    # above 256 rows, through the drop-free sorted grouped product.
    moe_impl: str = "dense"
    moe_capacity_factor: float = 2.0
    # Pixtral-style image encoder whose features replace the image tokens'
    # embeddings; None for a text-only model.
    vision_encoder: Optional[VisionEncoderArgs] = None

    def __post_init__(self) -> None:
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        if self.kv_quant not in ("bf16", "fp8", "int8"):
            raise ValueError(f"kv_quant must be 'bf16', 'fp8' or 'int8', got {self.kv_quant!r}")
        if self.quant not in ("bf16", "int8", "int4"):
            raise ValueError(f"quant must be 'bf16', 'int8' or 'int4', got {self.quant!r}")
        if self.moe_impl not in ("dense", "dispatch"):
            raise ValueError(f"moe_impl must be 'dense' or 'dispatch', got {self.moe_impl!r}")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TransformerArgs":
        """Build from a ``params.json``-style dict; unknown keys are ignored."""
        d = dict(d)
        if d.get("sliding_window") is None and d.get("_sliding_window") is not None:
            d["sliding_window"] = d["_sliding_window"]
        if d.get("lora") is not None:
            raise ValueError("live LoRA adapters are not ported yet")
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        if isinstance(kw.get("moe"), dict):
            kw["moe"] = MoeArgs.from_dict(kw["moe"])
        if isinstance(kw.get("vision_encoder"), dict):
            kw["vision_encoder"] = VisionEncoderArgs.from_dict(kw["vision_encoder"])
        return cls(**kw)


@dataclass
class MambaArgs:
    """Mamba2 (Codestral-Mamba). The SSD widths default to the reference's
    ``ssm_cfg``: d_state 128, d_conv 4, expand 2, headdim 64."""

    dim: int
    n_layers: int
    vocab_size: int
    n_groups: int
    rms_norm: bool
    residual_in_fp32: bool
    fused_add_norm: bool
    pad_vocab_size_multiple: int
    tie_embeddings: bool
    model_type: str = "mamba"
    # Weight quantization state: "bf16" (the model dtype), "int8" or "int4"
    # weight-only. Set by ``Mamba.quantize``.
    quant: str = "bf16"
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64

    def __post_init__(self) -> None:
        if self.model_type != "mamba":
            raise ValueError(f"model_type must be 'mamba', got {self.model_type!r}")
        if self.quant not in ("bf16", "int8", "int4"):
            raise ValueError(f"quant must be 'bf16', 'int8' or 'int4', got {self.quant!r}")
        if self.d_inner % self.headdim or self.n_ssm_heads % self.n_groups:
            raise ValueError("headdim must divide d_inner and n_groups the SSD heads")

    @property
    def d_inner(self) -> int:
        return self.expand * self.dim

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.headdim

    @property
    def conv_dim(self) -> int:
        """Channels of the depthwise conv: x | B | C."""
        return self.d_inner + 2 * self.n_groups * self.d_state

    @property
    def padded_vocab_size(self) -> int:
        m = self.pad_vocab_size_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MambaArgs":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})
