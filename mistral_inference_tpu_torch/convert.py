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
(in, out) layout in both forms: they are applied as ``x @ w``. Live LoRA
leaves (``<name>_lora``: ``{"a": (L, [E,] in, r), "b": (L, [E,] r, out)}``)
keep their layout and become per layer ``lora[<name>]`` pairs.

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

With ``mesh`` (``parallel/``) each layer is assembled on the host, cut to
this rank's shard there (``parallel/sharding.py``) and only the shard moves
to the device; the head is vocab-sharded, the rest replicated.

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
from mistral_inference_tpu_torch.models.transformer import LORA_PARTS, Params
from mistral_inference_tpu_torch.parallel import sharding
from mistral_inference_tpu_torch.parallel.mesh import Mesh

# port weight -> the JAX leaves stacked along its out dim; "ffn" stands for
# the tree's feed-forward family, "feed_forward" or "moe"
_LINEAR = {
    "wqkv": (("attention", "wq"), ("attention", "wk"), ("attention", "wv")),
    "wo": (("attention", "wo"),),
    "w13": (("ffn", "w1"), ("ffn", "w3")),
    "w2": (("ffn", "w2"),),
}


_LORA_NAMES = [name for names in LORA_PARTS.values() for name in names]


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


def to_device(tree: Any, device) -> Any:
    """A tree of tensors (dicts and lists) moved to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree  # a shard's "n_whole"


class Placer:
    """Where a loader puts each layer: straight on ``device``; or, under a
    mesh, on the host first, cut to this rank's shard by ``shard(layer,
    args, mesh)`` after ``check(args, mesh, quant, group)`` has passed on the
    first layer, and then moved."""

    def __init__(self, device, mesh: Optional[Mesh], args, shard, check, group_leaf: str):
        self.device, self.mesh, self.args = device, mesh, args
        self._shard, self._check, self._group_leaf = shard, check, group_leaf
        self.build = torch.device("cpu") if mesh is not None else device
        self._checked = False

    def layer(self, lw: Params) -> Params:
        if self.mesh is None:
            return lw
        if not self._checked:
            group = sharding.leaf_group(lw[self._group_leaf]) or 128
            self._check(self.args, self.mesh, self.args.quant, group)
            self._checked = True
        return to_device(self._shard(lw, self.args, self.mesh), self.device)

    def head(self, w: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return w
        return sharding.shard_vocab(w, self.mesh.t, self.mesh.tensor).to(self.device)


def transformer_placer(device, mesh: Optional[Mesh], args) -> Placer:
    return Placer(device, mesh, args, sharding.shard_layer, sharding.check_transformer, "wo")


def mamba_placer(device, mesh: Optional[Mesh], args) -> Placer:
    return Placer(device, mesh, args, sharding.shard_mamba_layer, sharding.check_mamba,
                  "out_proj")


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
    mesh: Optional[Mesh] = None,
    args: Optional[TransformerArgs] = None,
) -> Params:
    """Dense or MoE JAX params (numpy or CPU torch leaves), plain or
    weight-only quantized, with or without live LoRA leaves -> this port's
    params, on the card unless ``device="cpu"``. Raises on a LoRA leaf of a
    linear the model does not adapt live. With ``mesh`` (and the model's
    ``args``), this rank's shard."""
    device = resolve_device(device)
    place = transformer_placer(device, mesh, args)
    final, device = device, place.build
    layers = tree["layers"]
    ffn = "moe" if "moe" in layers else "feed_forward"
    if ffn not in layers:
        raise ValueError("the tree has neither a feed_forward nor a moe family")
    lora = [(group, name[: -len("_lora")]) for group in ("attention", ffn)
            for name in layers[group] if name.endswith("_lora")]
    for group, name in lora:
        if name not in _LORA_NAMES:
            raise ValueError(f"{group}.{name}_lora: no live LoRA on {name}")
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
        if lora:
            lw["lora"] = {
                name: {k: _dev(v[i], device) for k, v in layers[group][name + "_lora"].items()}
                for group, name in lora
            }
        out_layers.append(place.layer(lw))
    params = {
        "tok_embeddings": _dev(tree["tok_embeddings"], final),
        "layers": out_layers,
        "norm": _dev(tree["norm"], final),
        "output": place.head(_dev(tree["output"], device, transpose=True)),
    }
    if "vision" in tree:
        params["vision"] = vision_params_from_numpy(tree["vision"], final)
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
    mesh: Optional[Mesh] = None,
    args: Optional[MambaArgs] = None,
) -> Params:
    """Mamba2 JAX params (numpy or CPU torch leaves), plain or weight-only
    quantized -> this port's params (``models/mamba.py``), on the card unless
    ``device="cpu"``; with ``mesh`` (and ``args``), this rank's shard."""
    device = resolve_device(device)
    place = mamba_placer(device, mesh, args)
    final, device = device, place.build
    tree = _torch_tree(tree)
    layers = tree["layers"]
    out_layers = []
    for i in range(layers["norm"].shape[0]):
        def seg(name: str) -> torch.Tensor:
            return _dev(torch.cat([layers[f"{name}_{s}"][i] for s in _MAMBA_SEGMENTS], -1),
                        device)

        out_layers.append(place.layer({
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
        }))
    params = {
        "embedding": _dev(tree["embedding"], final),
        "layers": out_layers,
        "norm_f": _dev(tree["norm_f"], final),
    }
    if "lm_head" in tree:
        params["lm_head"] = place.head(_dev(tree["lm_head"], device, transpose=True))
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
    their bytes and scales, live LoRA pairs as ``<name>_lora`` stacks)."""
    q, kv, F = args.n_heads * args.head_dim, args.n_kv_heads * args.head_dim, args.hidden_dim

    def lora(lw, names):
        pairs = lw.get("lora", {})
        return {f"{n}_lora": {k: v.cpu() for k, v in pairs[n].items()}
                for n in names if n in pairs}

    def attention(lw):
        wq, wk, wv = _unfused(lw["wqkv"], [q, kv, kv])
        return {"wq": wq, "wk": wk, "wv": wv, "wo": _unfused(lw["wo"])[0],
                **lora(lw, ("wq", "wk", "wv", "wo"))}

    def ffn(lw):
        w1, w3 = _unfused(lw["w13"], [F, F])
        out = {"w1": w1, "w2": _unfused(lw["w2"])[0], "w3": w3}
        if "gate" in lw:
            out = {"gate": lw["gate"].cpu().t(), **out}
        return {**out, **lora(lw, ("w1", "w2", "w3"))}

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
