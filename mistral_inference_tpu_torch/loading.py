"""Checkpoint folders -> this port's params, and the stacked export
(counterpart of ``mistral_inference_tpu/loading.py``).

A reference folder holds ``params.json`` and exactly one of
``consolidated.safetensors`` or ``consolidated.00.pth``, with state-dict keys
like ``layers.{i}.attention.wq.weight`` in torch's (out, in) layout. The
port's own layout is built straight from those tensors, one layer at a time:
``wqkv`` = [wq; wk; wv] and ``w13`` = [w1; w3] along out, each linear kept
(out, in), the MoE expert stacks (E, in, out) as ``convert.py`` lays them
out. Each layer's tensors are read from the memory-mapped file, moved to the
device and cast to ``dtype`` there, so the host holds about one layer at a
time and bf16 is never widened on the host.

``save_stacked`` writes the JAX package's native export byte for byte:
``params.json`` with ``checkpoint_format: "mit-stacked-v1"`` and a
``consolidated.safetensors`` holding the JAX stacked tree under '/'-joined
keys, bf16 leaves as ``<key>.bf16bits`` uint16, quantized leaves as their
int8 / packed int4 bytes and fp32 scales. One export loads in both packages.
Its loader keeps every stored dtype as it is.
"""

from __future__ import annotations

import functools
import json
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch

from mistral_inference_tpu_torch import convert
from mistral_inference_tpu_torch.args import PATCH_MERGE, MambaArgs, TransformerArgs
from mistral_inference_tpu_torch.io.safetensors import load_file, save_file
from mistral_inference_tpu_torch.models.transformer import Params

STACKED_FORMAT = "mit-stacked-v1"
BF16_BITS = ".bf16bits"


def load_raw_state_dict(folder: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """The consolidated checkpoint's tensors on the CPU, in their stored
    dtypes, memory-mapped. Exactly one of the two formats must exist."""
    folder = Path(folder)
    st = folder / "consolidated.safetensors"
    pth = folder / "consolidated.00.pth"
    if st.is_file() == pth.is_file():
        raise FileNotFoundError(
            f"{folder} needs exactly one of consolidated.safetensors and consolidated.00.pth")
    if st.is_file():
        return load_file(st)
    return torch.load(str(pth), map_location="cpu", mmap=True, weights_only=True)


def is_stacked(folder: Union[str, Path]) -> bool:
    with open(Path(folder) / "params.json") as f:
        return json.load(f).get("checkpoint_format") == STACKED_FORMAT


def _flatten_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_tree(v, key + "/"))
        else:
            out[key] = v
    return out


def _unflatten_tree(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return tree


def _load_stacked(folder: Path) -> Dict[str, Any]:
    """The JAX tree of a stacked export as CPU tensors, stored dtypes kept."""
    flat = {}
    for key, t in load_file(folder / "consolidated.safetensors").items():
        if key.endswith(BF16_BITS):
            key, t = key[: -len(BF16_BITS)], t.view(torch.bfloat16)
        flat[key] = t
    return _unflatten_tree(flat)


def _args_dict(args: Union[TransformerArgs, MambaArgs]) -> Dict[str, Any]:
    """``dataclasses.asdict`` of the JAX package's args for this model, key
    for key in its order: the port's TransformerArgs lacks the JAX fields
    ``lora`` (never set here) and ``model_type``."""
    import dataclasses

    d = dataclasses.asdict(args)
    if isinstance(args, MambaArgs):
        return d
    order = ["dim", "n_layers", "head_dim", "hidden_dim", "n_heads", "n_kv_heads", "norm_eps",
             "vocab_size", "max_batch_size", "rope_theta", "moe", "lora", "sliding_window",
             "model_type", "vision_encoder", "quant", "kv_quant", "moe_impl",
             "moe_capacity_factor"]
    d.update(lora=None, model_type="transformer")
    return {k: d[k] for k in order}


def save_stacked(folder: Union[str, Path], model,
                 tokenizer_from: Optional[Union[str, Path]] = None) -> None:
    """Export a Transformer or Mamba, plain or quantized, in the JAX
    package's stacked format; with ``tokenizer_from``, copy that folder's
    tokenizer files beside it."""
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    d = _args_dict(model.args)
    d["checkpoint_format"] = STACKED_FORMAT
    with open(folder / "params.json", "w") as f:
        json.dump(d, f, indent=1, default=str)
    if tokenizer_from is not None:
        src = Path(tokenizer_from)
        for path in [src / "tekken.json", *sorted(src.glob("tokenizer.model*"))]:
            if path.exists():
                shutil.copy(path, folder / path.name)
    if isinstance(model.args, MambaArgs):
        tree = convert.mamba_params_to_stacked(model.params, model.args)
    else:
        tree = convert.params_to_stacked(model.params, model.args)
    flat = {}
    for key, t in _flatten_tree(tree).items():
        if t.dtype == torch.bfloat16:
            key, t = key + BF16_BITS, t.view(torch.uint16)
        flat[key] = t
    save_file(flat, folder / "consolidated.safetensors")


def _put(sd: Dict[str, torch.Tensor], dtype: torch.dtype, device, *keys: str) -> torch.Tensor:
    """The state dict's tensor under ``keys[0]``, or the tensors under
    ``keys`` stacked along out, on ``device`` in ``dtype``."""
    t = sd[keys[0]] if len(keys) == 1 else torch.cat([sd[k] for k in keys])
    return t.to(device).to(dtype).contiguous()


def load_transformer_params(
    folder: Union[str, Path],
    args: TransformerArgs,
    dtype: torch.dtype = torch.bfloat16,
    device: Optional[Union[str, torch.device]] = None,
) -> Params:
    """This port's params for a reference folder (every leaf cast to
    ``dtype``), or for a stacked export (stored dtypes kept), on the card
    unless ``device="cpu"``."""
    from mistral_inference_tpu_torch.model import resolve_device

    device = resolve_device(device)
    if is_stacked(folder):
        return convert.params_from_numpy(_load_stacked(Path(folder)), device)
    sd = load_raw_state_dict(folder)
    put = functools.partial(_put, sd, dtype, device)
    layers = []
    for i in range(args.n_layers):
        p = f"layers.{i}"
        lw = {
            "attention_norm": put(f"{p}.attention_norm.weight"),
            "ffn_norm": put(f"{p}.ffn_norm.weight"),
            "wqkv": put(*(f"{p}.attention.{w}.weight" for w in ("wq", "wk", "wv"))),
            "wo": put(f"{p}.attention.wo.weight"),
        }
        if args.moe is not None:
            E = args.moe.num_experts
            ex = f"{p}.feed_forward.experts"
            lw["gate"] = put(f"{p}.feed_forward.gate.weight")
            # experts stay (E, in, out): applied as x @ w
            lw["w13"] = torch.stack([
                put(f"{ex}.{e}.w1.weight", f"{ex}.{e}.w3.weight").t() for e in range(E)])
            lw["w2"] = torch.stack([put(f"{ex}.{e}.w2.weight").t() for e in range(E)])
        else:
            lw["w13"] = put(f"{p}.feed_forward.w1.weight", f"{p}.feed_forward.w3.weight")
            lw["w2"] = put(f"{p}.feed_forward.w2.weight")
        layers.append(lw)
    params: Params = {
        "tok_embeddings": put("tok_embeddings.weight"),
        "layers": layers,
        "norm": put("norm.weight"),
        "output": put("output.weight"),
    }
    if args.vision_encoder is not None:
        params["vision"] = _load_vision(args, put)
    return params


def _load_vision(args: TransformerArgs, put) -> Params:
    """Keys ``vision_encoder.*``, ``vision_language_adapter.*``,
    ``patch_merger.*`` and ``pre_mm_projector_norm.*``, each through
    ``put`` (``_put`` over the state dict)."""
    v = args.vision_encoder

    def layer(i: int) -> Params:
        p = f"vision_encoder.transformer.layers.{i}"
        return {
            "attention_norm": put(f"{p}.attention_norm.weight"),
            "ffn_norm": put(f"{p}.ffn_norm.weight"),
            "wqkv": put(*(f"{p}.attention.{w}.weight" for w in ("wq", "wk", "wv"))),
            "wo": put(f"{p}.attention.wo.weight"),
            "w13": put(f"{p}.feed_forward.w1.weight", f"{p}.feed_forward.w3.weight"),
            "w2": put(f"{p}.feed_forward.w2.weight"),
        }

    def adapter(name: str) -> Params:
        lin = {"w": put(f"vision_language_adapter.{name}.weight")}
        if v.adapter_bias:
            lin["b"] = put(f"vision_language_adapter.{name}.bias")
        return lin

    vision: Params = {
        "patch_conv": put("vision_encoder.patch_conv.weight"),  # (O, I, P, P) as stored
        "ln_pre": put("vision_encoder.ln_pre.weight"),
        "layers": [layer(i) for i in range(v.num_hidden_layers)],
        "adapter": {"w_in": adapter("w_in"), "w_out": adapter("w_out")},
    }
    if v.mm_projector_id == PATCH_MERGE:
        vision["patch_merger"] = {"w": put("patch_merger.merging_layer.weight")}
    if v.add_pre_mm_projector_layer_norm:
        vision["pre_mm_projector_norm"] = put("pre_mm_projector_norm.weight")
    return vision


def load_mamba_params(
    folder: Union[str, Path],
    args: MambaArgs,
    dtype: torch.dtype = torch.bfloat16,
    device: Optional[Union[str, torch.device]] = None,
) -> Params:
    """This port's Mamba2 params for a mamba_ssm ``MambaLMHeadModel`` folder,
    or for a stacked export, on the card unless ``device="cpu"``. A_log, D
    and dt_bias stay fp32: they feed the fp32 scan whatever the model dtype.
    mamba_ssm packs ``in_proj`` rows as [z | x | B | C | dt] and the conv's
    channels as [x | B | C]; the port keeps z | x | B | C as one
    ``in_proj``, ``dt_proj`` apart, and the conv as (K, conv_dim)."""
    from mistral_inference_tpu_torch.model import resolve_device

    device = resolve_device(device)
    if is_stacked(folder):
        return convert.mamba_params_from_numpy(_load_stacked(Path(folder)), device)
    sd = load_raw_state_dict(folder)
    zxbc = 2 * args.d_inner + 2 * args.n_groups * args.d_state
    put = functools.partial(_put, sd, dtype, device)
    fp32 = functools.partial(_put, sd, torch.float32, device)
    layers = []
    for i in range(args.n_layers):
        p = f"backbone.layers.{i}"
        in_proj = put(f"{p}.mixer.in_proj.weight")
        if in_proj.shape[0] != zxbc + args.n_ssm_heads:
            raise ValueError(f"{p}.mixer.in_proj.weight has {in_proj.shape[0]} rows, the args "
                             f"give {zxbc + args.n_ssm_heads}")
        layers.append({
            "norm": put(f"{p}.norm.weight"),
            "in_proj": in_proj[:zxbc].contiguous(),
            "dt_proj": in_proj[zxbc:].contiguous(),
            "conv_w": put(f"{p}.mixer.conv1d.weight")[:, 0, :].t().contiguous(),
            "conv_b": put(f"{p}.mixer.conv1d.bias"),
            "A_log": fp32(f"{p}.mixer.A_log"),
            "D": fp32(f"{p}.mixer.D"),
            "dt_bias": fp32(f"{p}.mixer.dt_bias"),
            "mixer_norm": put(f"{p}.mixer.norm.weight"),
            "out_proj": put(f"{p}.mixer.out_proj.weight"),
        })
    params: Params = {
        "embedding": put("backbone.embedding.weight"),
        "layers": layers,
        "norm_f": put("backbone.norm_f.weight"),
    }
    if not args.tie_embeddings:
        params["lm_head"] = put("lm_head.weight")
    return params
