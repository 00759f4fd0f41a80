"""LoRA adapters: merged into the weights at load, or live (counterpart of
``mistral_inference_tpu/lora.py``).

An adapter file is safetensors with the reference's keys,
``layers.{i}.attention.wq.lora_A.weight`` (r, in) and ``...lora_B.weight``
(out, r), and ``layers.{i}.feed_forward.experts.{e}.w1...`` for MoE experts.
A model built without ``args.lora`` merges ``W += (B @ A) * scaling`` into
its dense weights (every adapted linear but the ``output`` head, the MoE
router ``gate`` included); a model built with it keeps live pairs
(``models/transformer.py``) and the file fills them. The file is read with
the port's own ``io/safetensors.py``.

In the port's layout a plain linear is (out, in), so the reference's
``B @ A`` adds to it as it is, into the rows of its slice of a fused
``wqkv`` or ``w13``; an expert stack is (E, in, out) and takes its
transpose. A quantized weight cannot take a merge: load the adapter into the
dense weights, then quantize (``main.py`` does so for ``--lora_path``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Union

import torch

from mistral_inference_tpu_torch.args import TransformerArgs
from mistral_inference_tpu_torch.io.safetensors import load_file
from mistral_inference_tpu_torch.models.transformer import LORA_PARTS, Params
from mistral_inference_tpu_torch.ops.linear import is_quantized

_ATTENTION = ("wq", "wk", "wv", "wo")
# adapter family -> (the port weight that holds it, the name's part of its
# fusion); the router ``gate`` merges, and has no live pair
_FAMILIES = {name: (key, part) for key, names in LORA_PARTS.items()
             for part, name in enumerate(names)}
_FAMILIES["gate"] = ("gate", 0)
_EXPERT = "layers.{i}.feed_forward.experts.{e}.{w}"


def _module(i: int, name: str) -> str:
    """The checkpoint module path of family ``name`` in layer i."""
    return f"layers.{i}.{'attention' if name in _ATTENTION else 'feed_forward'}.{name}"


def load_lora(model, lora_path: Union[str, Path], scaling: float = 2.0) -> None:
    """Load an adapter file into ``model.params`` in place: merged into the
    dense weights with ``scaling``, or, for a model built with
    ``args.lora``, into its live pairs (which apply ``args.lora.scaling``)."""
    lora_path = Path(lora_path)
    if not lora_path.is_file():
        raise FileNotFoundError(f"{lora_path} does not exist or is not a file")
    if not isinstance(model.args, TransformerArgs):
        raise TypeError(f"LoRA adapters are not supported for {type(model).__name__} models")
    if model.args.quant != "bf16" and model.args.lora is None:
        raise ValueError("cannot merge a LoRA adapter into already-quantized weights: load "
                         "the adapter first, then quantize()")
    sd = load_file(lora_path)
    if not all("lora" in k for k in sd):
        raise ValueError(f"{lora_path} holds keys that are not LoRA adapters")
    if model.args.lora is not None:
        load_live_lora(model.params, sd, model.args.n_layers)
    else:
        model.params = merge_lora(model.params, sd, model.args, scaling)


def load_live_lora(params: Params, lora_sd: Dict[str, torch.Tensor], n_layers: int) -> None:
    """Fill the live pairs (a (in, r), b (r, out), per expert for an MoE
    layer's w1, w2, w3) from the file's lora_A (r, in) and lora_B (out, r),
    in the pairs' dtype and device; layers and experts the file leaves out
    keep their zeros."""
    for i in range(n_layers):
        pairs = params["layers"][i].get("lora", {})
        for name, pair in pairs.items():
            if pair["a"].dim() == 2:
                keys = [(_module(i, name), None)]
            else:
                keys = [(_EXPERT.format(i=i, e=e, w=name), e) for e in range(pair["a"].shape[0])]
            for base, e in keys:
                if base + ".lora_B.weight" not in lora_sd:
                    continue
                for leaf, key in (("a", ".lora_A.weight"), ("b", ".lora_B.weight")):
                    t = lora_sd[base + key].t().to(pair[leaf].device, pair[leaf].dtype)
                    if e is None:
                        pair[leaf].copy_(t)
                    else:
                        pair[leaf][e].copy_(t)


def merge_lora(
    params: Params, lora_sd: Dict[str, torch.Tensor], args: TransformerArgs, scaling: float
) -> Params:
    """W += (B @ A) * scaling, the product in fp32 and rounded to W's dtype
    before the add, for every linear whose lora_B the file holds, in place;
    returns ``params``. The ``output`` head is never merged."""
    q, kv, F = args.n_heads * args.head_dim, args.n_kv_heads * args.head_dim, args.hidden_dim
    offsets = {"wqkv": (0, q, q + kv), "w13": (0, F)}
    for i in range(args.n_layers):
        lw = params["layers"][i]
        for name, (key, part) in _FAMILIES.items():
            base = _module(i, name)
            if base + ".lora_B.weight" not in lora_sd or key not in lw:
                continue
            if args.moe is not None and name not in _ATTENTION + ("gate",):
                continue  # an MoE layer's feed-forward is its experts
            w = lw[key]
            _check_dense(w, f"layers[{i}].{key}")
            delta = _delta(lora_sd, base, scaling, w)  # (out, in)
            start = offsets.get(key, (0,))[part]
            w[start:start + delta.shape[0]] += delta.to(w.dtype)
        if args.moe is None:
            continue
        for name in ("w1", "w2", "w3"):
            key, part = _FAMILIES[name]
            w = lw[key]
            for e in range(args.moe.num_experts):
                base = _EXPERT.format(i=i, e=e, w=name)
                if base + ".lora_B.weight" not in lora_sd:
                    continue
                _check_dense(w, f"layers[{i}].{key}")
                delta = _delta(lora_sd, base, scaling, w).t()  # (in, out)
                start = part * F
                w[e, :, start:start + delta.shape[1]] += delta.to(w.dtype)
    return params


def _check_dense(w, where: str) -> None:
    if is_quantized(w):
        raise ValueError(f"{where} is quantized: merge the adapter before quantizing")


def _delta(lora_sd: Dict[str, torch.Tensor], base: str, scaling: float,
           like: torch.Tensor) -> torch.Tensor:
    """(B @ A) * scaling in fp32 on ``like``'s device: (out, in)."""
    a = lora_sd[base + ".lora_A.weight"].to(like.device, torch.float32)
    b = lora_sd[base + ".lora_B.weight"].to(like.device, torch.float32)
    return (b @ a) * scaling
