"""Carry weights between the JAX package's parameter tree and this port's.

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
(in, out) layout in both forms: they are applied as ``x @ w``.

The JAX tree's leaves may be numpy arrays (for example ``jax.tree.map(
np.asarray, params)``; bf16 as ml_dtypes' bfloat16) or CPU torch tensors
(the stacked checkpoint's reader gives those), so this module needs no JAX.
Each layer is assembled on the host and moved to the device on its own, and
transposes run there.

``mamba_params_from_numpy`` does the same for a Mamba2 tree
(``models/mamba.py``): ``z_proj | x_proj | b_proj | c_proj`` become one
``in_proj`` along out, the three conv segments one (K, conv_dim) conv, and
the head ``lm_head (dim, V)`` an ``(V, dim)`` weight.

A tree with a ``"vision"`` subtree (``models/vision.py``) carries it too:
its linears (``(L, in, out)`` stacks and the adapter's, PatchMerger's
``(in, out)`` weights) become ``(out, in)``, with q | k | v and w1 | w3 fused
as in the decoder; ``patch_conv`` (O, I, P, P), the norms and the adapter
biases are copied as they are.

``params_to_stacked`` (and its Mamba and vision cases) is the inverse: it
un-fuses along out, which is exact for the same reason, and re-stacks to the
JAX tree's ``(L, in, out)`` CPU tensors in their dtypes;
``params_to_numpy`` gives that tree as numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from mistral_inference_tpu_torch.args import MambaArgs, TransformerArgs
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


def _cpu(a: Any) -> torch.Tensor:
    """A numpy array (ml_dtypes' bfloat16 included) or a tensor -> a CPU
    tensor of the same dtype and bits."""
    if isinstance(a, torch.Tensor):
        return a.cpu()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bf16 of its own: move the bits
        return torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable, contiguous copy


def _torch_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return _cpu(tree)


def _dev(t: torch.Tensor, device, transpose: bool = False) -> torch.Tensor:
    """A host tensor on ``device``, transposed there when asked."""
    t = t.to(device)
    return (t.t() if transpose else t).contiguous()


def _fused(parts: Sequence[Any], i: int, device) -> Any:
    """Layer i of the JAX (L, ..., in, out) leaves ``parts`` fused along out:
    a quantized leaf or an expert stack keeps (..., in, out), a plain linear
    becomes (out, in)."""
    if isinstance(parts[0], dict):
        return {k: _dev(torch.cat([p[k][i] for p in parts], -1), device) for k in parts[0]}
    w = torch.cat([p[i] for p in parts], -1)
    return _dev(w, device, transpose=w.dim() == 2)


def params_from_numpy(
    tree: Dict[str, Any],
    device: Optional[Union[str, torch.device]] = None,
) -> Params:
    """Dense or MoE JAX params (numpy or CPU torch leaves), plain or
    weight-only quantized -> this port's params, on the card unless
    ``device="cpu"``. Raises on the trees the port does not carry yet
    (LoRA)."""
    device = resolve_device(device)
    layers = tree["layers"]
    ffn = "moe" if "moe" in layers else "feed_forward"
    if ffn not in layers:
        raise ValueError("the tree has neither a feed_forward nor a moe family")
    for group in ("attention", ffn):
        for name in layers[group]:
            if name.endswith("_lora"):
                raise ValueError(f"{group}.{name}: LoRA leaves do not convert yet")
    tree = _torch_tree(tree)
    layers = tree["layers"]
    out_layers = []
    for i in range(layers["attention_norm"].shape[0]):
        lw = {
            "attention_norm": _dev(layers["attention_norm"][i], device),
            "ffn_norm": _dev(layers["ffn_norm"][i], device),
        }
        if ffn == "moe":
            lw["gate"] = _dev(layers["moe"]["gate"][i], device, transpose=True)
        for key, leaves in _LINEAR.items():
            lw[key] = _fused(
                [layers[ffn if group == "ffn" else group][name] for group, name in leaves],
                i, device)
        out_layers.append(lw)
    params = {
        "tok_embeddings": _dev(tree["tok_embeddings"], device),
        "layers": out_layers,
        "norm": _dev(tree["norm"], device),
        "output": _dev(tree["output"], device, transpose=True),
    }
    if "vision" in tree:
        params["vision"] = vision_params_from_numpy(tree["vision"], device)
    return params


def vision_params_from_numpy(
    tree: Dict[str, Any],
    device: Optional[Union[str, torch.device]] = None,
) -> Params:
    """The JAX vision encoder's params (numpy or CPU torch leaves) -> this
    port's (``models/vision.py``), on the card unless ``device="cpu"``."""
    device = resolve_device(device)
    tree = _torch_tree(tree)
    layers = tree["layers"]
    att, ffn = layers["attention"], layers["feed_forward"]
    out: Params = {
        "patch_conv": _dev(tree["patch_conv"], device),
        "ln_pre": _dev(tree["ln_pre"], device),
        "layers": [
            {
                "attention_norm": _dev(layers["attention_norm"][i], device),
                "ffn_norm": _dev(layers["ffn_norm"][i], device),
                "wqkv": _fused([att["wq"], att["wk"], att["wv"]], i, device),
                "wo": _fused([att["wo"]], i, device),
                "w13": _fused([ffn["w1"], ffn["w3"]], i, device),
                "w2": _fused([ffn["w2"]], i, device),
            }
            for i in range(layers["attention_norm"].shape[0])
        ],
        "adapter": {
            name: {"w": _dev(lin["w"], device, transpose=True),
                   **({"b": _dev(lin["b"], device)} if "b" in lin else {})}
            for name, lin in tree["adapter"].items()
        },
    }
    if "patch_merger" in tree:
        out["patch_merger"] = {"w": _dev(tree["patch_merger"]["w"], device, transpose=True)}
    if "pre_mm_projector_norm" in tree:
        out["pre_mm_projector_norm"] = _dev(tree["pre_mm_projector_norm"], device)
    return out


_MAMBA_IN_PROJ = ("z_proj", "x_proj", "b_proj", "c_proj")
_MAMBA_SEGMENTS = ("x", "B", "C")


def mamba_params_from_numpy(
    tree: Dict[str, Any],
    device: Optional[Union[str, torch.device]] = None,
) -> Params:
    """Mamba2 JAX params (numpy or CPU torch leaves), plain or weight-only
    quantized -> this port's params (``models/mamba.py``), on the card unless
    ``device="cpu"``."""
    device = resolve_device(device)
    tree = _torch_tree(tree)
    layers = tree["layers"]
    out_layers = []
    for i in range(layers["norm"].shape[0]):
        def seg(name: str) -> torch.Tensor:
            return _dev(torch.cat([layers[f"{name}_{s}"][i] for s in _MAMBA_SEGMENTS], -1),
                        device)

        out_layers.append({
            "norm": _dev(layers["norm"][i], device),
            "in_proj": _fused([layers[k] for k in _MAMBA_IN_PROJ], i, device),
            "dt_proj": _fused([layers["dt_proj"]], i, device),
            "conv_w": seg("conv_w"),
            "conv_b": seg("conv_b"),
            "A_log": _dev(layers["A_log"][i], device),
            "D": _dev(layers["D"][i], device),
            "dt_bias": _dev(layers["dt_bias"][i], device),
            "mixer_norm": _dev(layers["mixer_norm"][i], device),
            "out_proj": _fused([layers["out_proj"]], i, device),
        })
    params = {
        "embedding": _dev(tree["embedding"], device),
        "layers": out_layers,
        "norm_f": _dev(tree["norm_f"], device),
    }
    if "lm_head" in tree:
        params["lm_head"] = _dev(tree["lm_head"], device, transpose=True)
    return params


# -- the inverse: this port's params -> the JAX tree --------------------------


def _unfused(w: Any, sizes: Optional[List[int]] = None) -> List[Any]:
    """A port linear -> its JAX (..., in, out) parts, split along out into
    ``sizes`` (whole when None), on the CPU."""
    if isinstance(w, dict):
        if sizes is None:
            return [{k: v.cpu() for k, v in w.items()}]
        split = {k: torch.split(v.cpu(), sizes, dim=-1) for k, v in w.items()}
        return [{k: split[k][j] for k in w} for j in range(len(sizes))]
    w = w.cpu()
    if w.dim() == 2:
        w = w.t()
    return [w] if sizes is None else list(torch.split(w, sizes, dim=-1))


def _stacked(per_layer: List[Any]) -> Any:
    if isinstance(per_layer[0], dict):
        return {k: torch.stack([p[k] for p in per_layer]) for k in per_layer[0]}
    return torch.stack([p.cpu() for p in per_layer])


def _columns(layers: List[Dict[str, Any]], split) -> Dict[str, Any]:
    """Stack, across layers, the named JAX leaves that ``split(layer)``
    returns as a dict."""
    per = [split(lw) for lw in layers]
    return {k: _stacked([p[k] for p in per]) for k in per[0]}


def params_to_stacked(params: Params, args: TransformerArgs) -> Dict[str, Any]:
    """This port's dense or MoE params -> the JAX package's tree of CPU
    tensors in their dtypes (``(L, in, out)`` stacks, quantized leaves with
    their bytes and scales)."""
    q, kv, F = args.n_heads * args.head_dim, args.n_kv_heads * args.head_dim, args.hidden_dim

    def attention(lw):
        wq, wk, wv = _unfused(lw["wqkv"], [q, kv, kv])
        return {"wq": wq, "wk": wk, "wv": wv, "wo": _unfused(lw["wo"])[0]}

    def ffn(lw):
        w1, w3 = _unfused(lw["w13"], [F, F])
        out = {"w1": w1, "w2": _unfused(lw["w2"])[0], "w3": w3}
        if "gate" in lw:
            out = {"gate": lw["gate"].cpu().t(), **out}
        return out

    L = params["layers"]
    layers: Dict[str, Any] = {
        "attention_norm": _stacked([lw["attention_norm"] for lw in L]),
        "ffn_norm": _stacked([lw["ffn_norm"] for lw in L]),
        "attention": _columns(L, attention),
        "moe" if "gate" in L[0] else "feed_forward": _columns(L, ffn),
    }
    tree = {
        "tok_embeddings": params["tok_embeddings"].cpu(),
        "layers": layers,
        "norm": params["norm"].cpu(),
        "output": params["output"].cpu().t().contiguous(),
    }
    if "vision" in params:
        tree["vision"] = vision_params_to_stacked(params["vision"])
    return tree


def vision_params_to_stacked(params: Params) -> Dict[str, Any]:
    """This port's vision encoder params -> the JAX vision subtree of CPU
    tensors."""

    def attention(lw):
        hid = lw["wo"].shape[0]
        wq, wk, wv = _unfused(lw["wqkv"], [hid, hid, hid])
        return {"wq": wq, "wk": wk, "wv": wv, "wo": _unfused(lw["wo"])[0]}

    def ffn(lw):
        F = lw["w2"].shape[1]
        w1, w3 = _unfused(lw["w13"], [F, F])
        return {"w1": w1, "w2": _unfused(lw["w2"])[0], "w3": w3}

    L = params["layers"]
    tree: Dict[str, Any] = {
        "patch_conv": params["patch_conv"].cpu(),
        "ln_pre": params["ln_pre"].cpu(),
        "layers": {
            "attention_norm": _stacked([lw["attention_norm"] for lw in L]),
            "ffn_norm": _stacked([lw["ffn_norm"] for lw in L]),
            "attention": _columns(L, attention),
            "feed_forward": _columns(L, ffn),
        },
        "adapter": {
            name: {"w": _unfused(lin["w"])[0].contiguous(),
                   **({"b": lin["b"].cpu()} if "b" in lin else {})}
            for name, lin in params["adapter"].items()
        },
    }
    if "patch_merger" in params:
        tree["patch_merger"] = {"w": _unfused(params["patch_merger"]["w"])[0].contiguous()}
    if "pre_mm_projector_norm" in params:
        tree["pre_mm_projector_norm"] = params["pre_mm_projector_norm"].cpu()
    return tree


def mamba_params_to_stacked(params: Params, args: MambaArgs) -> Dict[str, Any]:
    """This port's Mamba2 params -> the JAX package's tree of CPU tensors."""
    di, gd = args.d_inner, args.n_groups * args.d_state

    def split(lw):
        z, x, b, c = _unfused(lw["in_proj"], [di, di, gd, gd])
        out = {"norm": lw["norm"].cpu(), "z_proj": z, "x_proj": x, "b_proj": b, "c_proj": c,
               "dt_proj": _unfused(lw["dt_proj"])[0]}
        for name in ("conv_w", "conv_b"):
            for s, part in zip(_MAMBA_SEGMENTS, torch.split(lw[name].cpu(), [di, gd, gd], -1)):
                out[f"{name}_{s}"] = part
        for name in ("A_log", "D", "dt_bias", "mixer_norm"):
            out[name] = lw[name].cpu()
        out["out_proj"] = _unfused(lw["out_proj"])[0]
        return out

    tree = {
        "embedding": params["embedding"].cpu(),
        "layers": _columns(params["layers"], split),
        "norm_f": params["norm_f"].cpu(),
    }
    if "lm_head" in params:
        tree["lm_head"] = params["lm_head"].cpu().t().contiguous()
    return tree


def _numpy(t: Any) -> Any:
    if isinstance(t, dict):
        return {k: _numpy(v) for k, v in t.items()}
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(params: Params, args: Union[TransformerArgs, MambaArgs]) -> Dict[str, Any]:
    """This port's params -> the JAX package's tree as numpy arrays (bf16 as
    ml_dtypes' bfloat16), the inverse of ``params_from_numpy`` /
    ``mamba_params_from_numpy`` in bits."""
    if isinstance(args, MambaArgs):
        return _numpy(mamba_params_to_stacked(params, args))
    return _numpy(params_to_stacked(params, args))
