"""Weights of a Mistral-family configuration, drawn from the run's seed on
the card, in the model dtype, one layer at a time, one call a tensor.

The same function serves both sides: the harness hands a layer to the
program, which quantizes it as it arrives, and the plain reference draws the
same layer again (the same seed gives the same draws on the same device)
and works out its quantized form with its own code. Neither ever holds a
Mixtral's dense form whole.

Distributions (the port's own ``init_params`` uses them too): linear
weights N(0, 1) / sqrt(fan_in), embeddings N(0, 1), norm weights 1.
Layouts are the port's: ``wqkv`` (Hq Dh + 2 Hkv Dh, D), ``wo`` (D, Hq Dh),
a dense ``w13`` (2 F, D) and ``w2`` (D, F); an MoE layer's ``gate`` (E, D),
``w13`` (E, D, 2 F) and ``w2`` (E, F, D).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


@dataclass(frozen=True)
class Dims:
    dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    hidden: int
    vocab: int
    experts: int  # 0: a dense feed-forward
    top_k: int
    window: Optional[int]
    rope_theta: float
    norm_eps: float
    dtype: torch.dtype
    quant_bits: int  # 4 or 8: weight-only grouped quantization of the big linears
    group: int
    kv_quant: str  # "fp8" | "int8" | "bf16"


def dims(config: Dict[str, Any]) -> Dims:
    """The sizes of a Hugging Face style ``config.json`` and the assumptions
    the file states under ``assumed``."""
    a = config["assumed"]
    D, H = config["hidden_size"], config["num_attention_heads"]
    return Dims(
        dim=D, n_layers=config["num_hidden_layers"], n_heads=H,
        n_kv_heads=config["num_key_value_heads"], head_dim=config.get("head_dim") or D // H,
        hidden=config["intermediate_size"], vocab=config["vocab_size"],
        experts=config.get("num_local_experts", 0) or 0,
        top_k=config.get("num_experts_per_tok", 0) or 0,
        window=config.get("sliding_window"), rope_theta=float(config["rope_theta"]),
        norm_eps=float(config["rms_norm_eps"]), dtype=DTYPES[config["torch_dtype"]],
        quant_bits={"int4": 4, "int8": 8}[a["weights"]], group=int(a["group"]),
        kv_quant=a["kv_ring"],
    )


def _generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream * 7919 + 17) % (2**63))
    return g


def _draw(sizes: Dict[str, tuple], fan_in: Dict[str, int], d: Dims, seed: int, stream: int,
          device) -> Dict[str, torch.Tensor]:
    # One call a tensor, in a fixed order from one generator: no leaf shares
    # storage with another, so the caller can drop each on its own.
    g = _generator(seed, stream, device)
    return {name: torch.randn(shape, generator=g, dtype=d.dtype, device=device)
            .mul_(fan_in[name] ** -0.5) for name, shape in sizes.items()}


def layer(d: Dims, seed: int, li: int, device) -> Dict[str, torch.Tensor]:
    """Layer ``li``'s weights in the port's layout, in the model dtype."""
    D, F, E = d.dim, d.hidden, d.experts
    q, kv = d.n_heads * d.head_dim, d.n_kv_heads * d.head_dim
    sizes: Dict[str, tuple] = {"wqkv": (q + 2 * kv, D), "wo": (D, q)}
    fan = {"wqkv": D, "wo": q, "gate": D, "w13": D, "w2": F}
    if E:
        sizes.update(gate=(E, D), w13=(E, D, 2 * F), w2=(E, F, D))
    else:
        sizes.update(w13=(2 * F, D), w2=(D, F))
    w = _draw(sizes, fan, d, seed, 100 + li, device)
    ones = torch.ones((D,), dtype=d.dtype, device=device)
    w["attention_norm"], w["ffn_norm"] = ones, ones.clone()
    return w


def embeddings(d: Dims, seed: int, device) -> torch.Tensor:
    return torch.randn((d.vocab, d.dim), generator=_generator(seed, 1, device), dtype=d.dtype,
                       device=device)


def head(d: Dims, seed: int, device) -> torch.Tensor:
    """The output head (V, D); the final norm's weight is 1."""
    return _draw({"output": (d.vocab, d.dim)}, {"output": d.dim}, d, seed, 2, device)["output"]
