"""Weight-only quantization of a params tree: a transformer, dense or MoE,
or a Mamba2 model (counterpart of ``mistral_inference_tpu/quant/weights.py``).

Quantizes the big linears of every layer to int8 or packed int4 with grouped
fp32 scales (``ops/linear.py``): a transformer's ``wqkv``, ``wo``, ``w13``,
``w2`` (in an MoE layer the last two are (E, in, out) expert stacks, quantized
in one call with the experts as a leading axis); a Mamba layer's ``in_proj``
and ``out_proj``. Embeddings, norms, the MoE router ``gate``, the output head
and Mamba's ``dt_proj`` (it feeds softplus(dt), the recurrence's decay rates),
convs and SSD parameters stay in the model dtype: they are a small share of
the bytes and the usual accuracy-critical tails.

This port keeps wq|wk|wv, w1|w3 and Mamba's z|x|B|C fused along ``out``.
Grouped quantization is per output column, so the fused quantized leaf is
exactly the concatenation along ``out`` of the separate leaves' bytes and
scales.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from mistral_inference_tpu_torch.args import TransformerArgs
from mistral_inference_tpu_torch.ops.linear import DEFAULT_GROUP, is_quantized, quantize_weight

Params = Dict[str, Any]

QUANT_LEAVES = ("wqkv", "wo", "w13", "w2")
MAMBA_QUANT_LEAVES = ("in_proj", "out_proj")


def _bits(mode: str) -> int:
    if mode not in ("int8", "int4"):
        raise ValueError(f"mode must be 'int8' or 'int4', got {mode!r}")
    return 8 if mode == "int8" else 4


def quantize_params(params: Params, mode: str, group: int = DEFAULT_GROUP) -> Params:
    """mode: "int8" | "int4". Mutates (and returns) the tree: each big linear
    (out, in), or expert stack (E, in, out), becomes a {"q" | "q4", "scale"}
    leaf (..., in, out), one weight at a time, and the dense tensor is dropped
    as it converts, so the peak stays one weight's fp32 copy above the steady
    state. A Mamba tree (layers with ``in_proj``) quantizes its
    ``MAMBA_QUANT_LEAVES``. Refuses a tree that is already quantized:
    re-quantizing packed bytes would be nonsense."""
    bits = _bits(mode)
    leaves = MAMBA_QUANT_LEAVES if "in_proj" in params["layers"][0] else QUANT_LEAVES
    for i, lw in enumerate(params["layers"]):
        for leaf in leaves:
            if is_quantized(lw[leaf]):
                raise ValueError(f"layers[{i}].{leaf} is already quantized")
        for leaf in leaves:
            w = lw.pop(leaf)
            lw[leaf] = quantize_weight(w if w.dim() == 3 else w.t(), bits, group)
            del w
    return params


def init_quantized_params(
    args: TransformerArgs,
    dtype: torch.dtype,
    mode: str,
    generator: torch.Generator,
    device: torch.device,
    group: int = DEFAULT_GROUP,
) -> Params:
    """Random params with the big linears born quantized: random stored bytes
    (any byte is a valid code) and scales of 0.01, so no full-precision copy
    of the model ever exists. For measurements and tests, not for quality."""
    from mistral_inference_tpu_torch.models.transformer import init_params

    bits = _bits(mode)
    key = "q4" if bits == 4 else "q"

    def rand_quant(*shape: int) -> Dict[str, torch.Tensor]:
        """For a plain weight (out, in) or an expert stack (E, in, out)."""
        lead, (in_f, out_f) = shape[:-2], (shape[-2:] if len(shape) == 3 else shape[::-1])
        g = min(group, in_f)
        stored = in_f // 2 if bits == 4 else in_f
        q = torch.randint(
            -128, 128, (*lead, stored, out_f), generator=generator, dtype=torch.int8,
            device=device,
        )
        scale = torch.full((*lead, in_f // g, out_f), 0.01, dtype=torch.float32, device=device)
        return {key: q, "scale": scale}

    # Everything but the big linears comes from a one-layer template.
    params = init_params(dataclasses.replace(args, n_layers=1), dtype, generator, device)
    template = params["layers"][0]
    params["layers"] = [
        {
            leaf: rand_quant(*w.shape) if leaf in QUANT_LEAVES else w.clone()
            for leaf, w in template.items()
        }
        for _ in range(args.n_layers)
    ]
    return params
