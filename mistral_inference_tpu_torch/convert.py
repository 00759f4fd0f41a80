"""Carry weights from the JAX package's parameter tree into this port.

The JAX tree stacks each layer weight as ``(L, in, out)`` and applies it as
``x @ w``. This port keeps a list of per-layer dicts with each linear weight
``(out, in)``, applied with ``F.linear``, and stacks the projections that
read one input: ``wqkv`` = [wq; wk; wv] and ``w13`` = [w1; w3] along out.
After conversion both compute the same function. A quantized JAX leaf,
``{"q" | "q4": int8 (L, in', out), "scale": fp32 (L, groups, out)}``, keeps
its (in, out) layout and its bytes: it becomes one such leaf per layer, and
the leaves that fuse are concatenated along out, which grouped quantization
per output column makes exact. An MoE tree (``layers["moe"]``: ``gate (L,
dim, E)``, ``w1`` / ``w3 (L, E, dim, hidden)``, ``w2 (L, E, hidden, dim)``,
plain or quantized) becomes per layer a router ``gate (E, dim)`` and the expert
stacks ``w13 (E, dim, 2 hidden)`` and ``w2 (E, hidden, dim)``, which keep the
(in, out) layout in both forms: they are applied as ``x @ w``. The input is a
tree of numpy arrays (for example ``jax.tree.map(np.asarray, params)``), so
this module needs no JAX.

``mamba_params_from_numpy`` does the same for a Mamba2 tree
(``models/mamba.py``): ``z_proj | x_proj | b_proj | c_proj`` become one
``in_proj`` along out, the three conv segments one (K, conv_dim) conv, and
the head ``lm_head (dim, V)`` an ``(V, dim)`` weight.

A tree with a ``"vision"`` subtree (``models/vision.py``) carries it too:
its linears (``(L, in, out)`` stacks and the adapter's, PatchMerger's
``(in, out)`` weights) become ``(out, in)``, with q | k | v and w1 | w3 fused
as in the decoder; ``patch_conv`` (O, I, P, P), the norms and the adapter
biases are copied as they are.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from mistral_inference_tpu_torch.model import resolve_device
from mistral_inference_tpu_torch.models.transformer import Params

# port weight -> the JAX leaves stacked along its out dim; "ffn" stands for
# the tree's feed-forward family, "feed_forward" or "moe"
_LINEAR = {
    "wqkv": (("attention", "wq"), ("attention", "wk"), ("attention", "wv")),
    "wo": (("attention", "wo"),),
    "w13": (("ffn", "w1"), ("ffn", "w3")),
    "w2": (("ffn", "w2"),),
}


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bf16: widen exactly, narrow in torch
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable, contiguous copy
    return t.to(device).contiguous()


def params_from_numpy(
    tree: Dict[str, Any],
    device: Optional[Union[str, torch.device]] = None,
) -> Params:
    """Dense or MoE JAX params (numpy leaves), plain or weight-only quantized
    -> this port's params, on the card unless ``device="cpu"``. Raises on
    the trees the port does not carry yet (LoRA)."""
    device = resolve_device(device)
    layers = tree["layers"]
    ffn = "moe" if "moe" in layers else "feed_forward"
    if ffn not in layers:
        raise ValueError("the tree has neither a feed_forward nor a moe family")
    for group in ("attention", ffn):
        for name in layers[group]:
            if name.endswith("_lora"):
                raise ValueError(f"{group}.{name}: LoRA leaves do not convert yet")
    n_layers = np.asarray(layers["attention_norm"]).shape[0]
    out_layers = []
    for i in range(n_layers):
        lw = {
            "attention_norm": _tensor(layers["attention_norm"][i], device),
            "ffn_norm": _tensor(layers["ffn_norm"][i], device),
        }
        if ffn == "moe":
            lw["gate"] = _tensor(np.asarray(layers["moe"]["gate"][i]).T, device)
        for key, leaves in _LINEAR.items():
            parts = [layers[ffn if group == "ffn" else group][name] for group, name in leaves]
            if isinstance(parts[0], dict):
                lw[key] = {
                    k: _tensor(np.concatenate([np.asarray(p[k][i]) for p in parts], axis=-1), device)
                    for k in parts[0]
                }
            elif np.asarray(parts[0][i]).ndim == 3:  # expert stacks stay (E, in, out)
                lw[key] = _tensor(np.concatenate([np.asarray(p[i]) for p in parts], axis=-1), device)
            else:
                w = [np.asarray(p[i]).T for p in parts]
                lw[key] = _tensor(np.concatenate(w, axis=0), device)
        out_layers.append(lw)
    params = {
        "tok_embeddings": _tensor(tree["tok_embeddings"], device),
        "layers": out_layers,
        "norm": _tensor(tree["norm"], device),
        "output": _tensor(np.asarray(tree["output"]).T, device),
    }
    if "vision" in tree:
        params["vision"] = vision_params_from_numpy(tree["vision"], device)
    return params


def _linear_t(*parts: np.ndarray, device) -> torch.Tensor:
    """(in, out) weights -> one (out, in) weight, the parts stacked on out."""
    return _tensor(np.concatenate([np.asarray(p).T for p in parts], axis=0), device)


def vision_params_from_numpy(
    tree: Dict[str, Any],
    device: Optional[Union[str, torch.device]] = None,
) -> Params:
    """The JAX vision encoder's params (numpy leaves) -> this port's
    (``models/vision.py``), on the card unless ``device="cpu"``."""
    device = resolve_device(device)
    layers = tree["layers"]
    att, ffn = layers["attention"], layers["feed_forward"]
    out: Params = {
        "patch_conv": _tensor(tree["patch_conv"], device),
        "ln_pre": _tensor(tree["ln_pre"], device),
        "layers": [
            {
                "attention_norm": _tensor(layers["attention_norm"][i], device),
                "ffn_norm": _tensor(layers["ffn_norm"][i], device),
                "wqkv": _linear_t(att["wq"][i], att["wk"][i], att["wv"][i], device=device),
                "wo": _linear_t(att["wo"][i], device=device),
                "w13": _linear_t(ffn["w1"][i], ffn["w3"][i], device=device),
                "w2": _linear_t(ffn["w2"][i], device=device),
            }
            for i in range(np.asarray(layers["attention_norm"]).shape[0])
        ],
        "adapter": {
            name: {"w": _linear_t(lin["w"], device=device),
                   **({"b": _tensor(lin["b"], device)} if "b" in lin else {})}
            for name, lin in tree["adapter"].items()
        },
    }
    if "patch_merger" in tree:
        out["patch_merger"] = {"w": _linear_t(tree["patch_merger"]["w"], device=device)}
    if "pre_mm_projector_norm" in tree:
        out["pre_mm_projector_norm"] = _tensor(tree["pre_mm_projector_norm"], device)
    return out


_MAMBA_IN_PROJ = ("z_proj", "x_proj", "b_proj", "c_proj")


def _mamba_linear(parts, i: int, device):
    """Layer i of the JAX (L, in, out) stacks ``parts``, fused along out:
    a quantized leaf keeps (in, out) and its bytes; a plain one becomes
    (out, in)."""
    if isinstance(parts[0], dict):
        return {
            k: _tensor(np.concatenate([np.asarray(p[k][i]) for p in parts], axis=-1), device)
            for k in parts[0]
        }
    return _tensor(np.concatenate([np.asarray(p[i]) for p in parts], axis=-1).T, device)


def mamba_params_from_numpy(
    tree: Dict[str, Any],
    device: Optional[Union[str, torch.device]] = None,
) -> Params:
    """Mamba2 JAX params (numpy leaves), plain or weight-only quantized ->
    this port's params (``models/mamba.py``), on the card unless
    ``device="cpu"``."""
    device = resolve_device(device)
    layers = tree["layers"]
    out_layers = []
    for i in range(np.asarray(layers["norm"]).shape[0]):
        def seg(name: str) -> np.ndarray:
            return np.concatenate(
                [np.asarray(layers[f"{name}_{s}"][i]) for s in ("x", "B", "C")], axis=-1)

        out_layers.append({
            "norm": _tensor(layers["norm"][i], device),
            "in_proj": _mamba_linear([layers[k] for k in _MAMBA_IN_PROJ], i, device),
            "dt_proj": _tensor(np.asarray(layers["dt_proj"][i]).T, device),
            "conv_w": _tensor(seg("conv_w"), device),
            "conv_b": _tensor(seg("conv_b"), device),
            "A_log": _tensor(layers["A_log"][i], device),
            "D": _tensor(layers["D"][i], device),
            "dt_bias": _tensor(layers["dt_bias"][i], device),
            "mixer_norm": _tensor(layers["mixer_norm"][i], device),
            "out_proj": _mamba_linear([layers["out_proj"]], i, device),
        })
    params = {
        "embedding": _tensor(tree["embedding"], device),
        "layers": out_layers,
        "norm_f": _tensor(tree["norm_f"], device),
    }
    if "lm_head" in tree:
        params["lm_head"] = _tensor(np.asarray(tree["lm_head"]).T, device)
    return params
