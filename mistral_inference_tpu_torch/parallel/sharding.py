"""This rank's shard of a model (counterpart of
``mistral_inference_tpu/parallel/sharding.py``).

The JAX package lays a global array over the mesh and lets GSPMD insert the
collectives; here each rank holds its shard as plain tensors and the
forwards issue the collectives (``parallel/mesh.py``). The layout is the
JAX package's kernels-under-mesh one (``param_specs(pallas=True)``,
``mamba_param_specs(pallas=True)``): every linear sharded on ``tensor``
keeps its whole reduction axis K and takes N / T of its output columns, so
a shard's product is the matching columns of the whole product. With t of T
the rank's place on ``tensor`` and e of EP its place on ``expert``:

* ``wqkv``, ``w13``, the experts' ``w13`` and Mamba's ``in_proj`` are fused
  along out: each part (q heads, k heads, v heads; w1, w3; z, x, B, C by
  heads or groups) is sliced to piece t of T and the pieces re-fused, so
  the rank's split of the fused product uses local sizes.
* ``wo``, ``w2``, the experts' ``w2`` and Mamba's ``out_proj`` take output
  columns [t D / T, (t + 1) D / T); the forward gathers their input over
  ``tensor`` before the product and their output after it.
* A quantized two-dimensional shard carries ``"n_whole"``, the N of the
  whole weight (``mark_whole_n``), from which K3 picks its reduction split: the split follows
  the shape alone, and the shape is the whole weight's, so a shard's column
  has the bits it has in the whole product. (K5 and K8 split nothing by N.)
* Experts: each expert rank holds the contiguous ``E / EP`` experts
  [e E / EP, (e + 1) E / EP); the router ``gate`` is replicated.
* The output head is sharded on the vocab axis; the embedding, the norms
  (Mamba's ``mixer_norm`` too), Mamba's ``dt_proj`` and the Pixtral encoder
  are replicated, and so are live LoRA pairs, as the JAX package replicates
  them: after the input gathers every sharded linear sees its whole input,
  so a rank adds the columns of the whole delta that its shard holds.
* Mamba shards per head: ``A_log``, ``D``, ``dt_bias``, the conv taps and
  bias per channel of x | B | C.
* ``seq`` and ``data`` replicate every weight.

Quantization is per output column in groups along the reduction axis, so a
column shard holds exactly the bytes of the shard of the quantized full
weight: quantize-then-shard equals shard-then-quantize.

``check_transformer`` and ``check_mamba`` refuse a mesh the model does not
divide, naming the axis, and a quantized shard that the kernels would not
take where the full weight's shape takes them. Where the JAX package falls
back to replicating a leaf an axis does not divide (``_divisible_spec``),
the port raises: a mesh either runs every kernel on its shard or is
refused.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from mistral_inference_tpu_torch.ops.cuda.matmul_quant import weight_ok
from mistral_inference_tpu_torch.ops.linear import is_quantized
from mistral_inference_tpu_torch.parallel.mesh import Mesh

Params = Dict[str, Any]

# The JAX package's ``main.py`` assertion, raised here for a Mamba under seq.
MAMBA_SEQ = ("--seq applies to transformer models only (Mamba prefill is a sequential "
             "recurrence over tokens — it cannot sequence-shard)")


# -- the checks ----------------------------------------------------------------


def _divides(n: int, axis: str, size: int, what: str) -> None:
    if n % size:
        raise ValueError(f"mesh axis {axis}={size} does not divide {what} = {n}")


def _routes(K: int, N: int, ng: int, bits: int) -> bool:
    """Whether ``ops/linear.linear`` sends a decode-sized product of this
    weight to K3 (and a mid-band one to K5)."""
    return K % 128 == 0 and N % 128 == 0 and weight_ok(K, N, ng, bits)


def _check_quant(name: str, K: int, N: int, group: int, bits: int, tensor: int) -> None:
    """A quantized weight K x N sharded to K x N / T: where the kernels take
    the full weight they must take the shard."""
    ng = K // min(group, K)
    Nl = N // tensor
    if _routes(K, N, ng, bits) and not _routes(K, Nl, ng, bits):
        raise ValueError(f"mesh axis tensor={tensor}: the shard of {name}, {K} x {Nl} in {ng} "
                         f"quantization groups of int{bits}, is a shape the quantized kernels "
                         "refuse")


def _bits(quant: Optional[str]) -> int:
    return {None: 0, "bf16": 0, "int8": 8, "int4": 4}[quant]


def check_transformer(args, mesh: Mesh, quant: Optional[str] = None, group: int = 128) -> None:
    """Refuse a mesh that does not divide the model, naming the axis; with
    ``quant`` ("int8" | "int4"), also one whose shards the kernels refuse."""
    T, EP = mesh.tensor, mesh.expert
    _divides(args.n_heads, "tensor", T, "n_heads")
    _divides(args.n_kv_heads, "tensor", T, "n_kv_heads")
    _divides(args.hidden_dim, "tensor", T, "hidden_dim")
    _divides(args.vocab_size, "tensor", T, "vocab_size (the head is vocab-sharded)")
    if args.moe is not None:
        _divides(args.moe.num_experts, "expert", EP, "n_experts")
    elif EP > 1:
        raise ValueError(f"mesh axis expert={EP} needs an MoE model")
    bits = _bits(quant)
    if not bits or T == 1:
        return
    D, Dh, F = args.dim, args.head_dim, args.hidden_dim
    q, kv = args.n_heads * Dh, args.n_kv_heads * Dh
    _check_quant("wqkv", D, q + 2 * kv, group, bits, T)
    _check_quant("wo", q, D, group, bits, T)
    _check_quant("w13", D, 2 * F, group, bits, T)
    _check_quant("w2", F, D, group, bits, T)
    if args.moe is not None and D % 256 == 0 and F % 256 == 0 and (
            (2 * F // T) % 128 or (D // T) % 128):
        raise ValueError(f"mesh axis tensor={T}: an expert's shards, {2 * F // T} and "
                         f"{D // T} columns, are not multiples of 128, which the grouped "
                         "expert kernels need")


def check_mamba(args, mesh: Mesh, quant: Optional[str] = None, group: int = 128) -> None:
    """``check_transformer`` for a Mamba: tensor must divide ``n_groups``
    (and so the heads) and the padded vocabulary; no expert axis."""
    T = mesh.tensor
    if mesh.seq > 1:
        raise ValueError(MAMBA_SEQ)
    _divides(args.n_groups, "tensor", T, "n_groups")
    _divides(args.padded_vocab_size, "tensor", T, "the padded vocab (the head is vocab-sharded)")
    if mesh.expert > 1:
        raise ValueError(f"mesh axis expert={mesh.expert} needs an MoE model")
    bits = _bits(quant)
    if not bits or T == 1:
        return
    di, gd = args.d_inner, args.n_groups * args.d_state
    _check_quant("in_proj", args.dim, 2 * di + 2 * gd, group, bits, T)
    _check_quant("out_proj", di, args.dim, group, bits, T)


def leaf_group(w: Any) -> Optional[int]:
    """The group size of a quantized leaf (None for a plain weight)."""
    if not is_quantized(w):
        return None
    K = w["q"].shape[-2] if "q" in w else 2 * w["q4"].shape[-2]
    return K // w["scale"].shape[-2]


# -- the leaf rules --------------------------------------------------------------


def _part_slices(sizes: Sequence[int], t: int, T: int) -> List[slice]:
    """The rank's piece of each fused part along out, as slices of the
    fused axis."""
    out, off = [], 0
    for n in sizes:
        out.append(slice(off + t * n // T, off + (t + 1) * n // T))
        off += n
    return out


def shard_columns(w: Any, sizes: Sequence[int], t: int, T: int) -> Any:
    """A weight fused along out from parts of ``sizes`` (one part: a plain
    output-sharded linear): piece t of T of each part, re-fused. A plain
    linear is (out, in); a quantized leaf or an expert stack is (..., in,
    out)."""
    if T == 1:
        return w
    parts = _part_slices(sizes, t, T)
    if isinstance(w, dict):
        if "li" in w:
            raise ValueError("a layer-stacked leaf cannot be sharded")
        return {k: torch.cat([v[..., s] for s in parts], -1).contiguous() for k, v in w.items()}
    if w.dim() == 2:
        return torch.cat([w[s] for s in parts], 0).contiguous()
    return torch.cat([w[..., s] for s in parts], -1).contiguous()


def shard_experts(w: Any, e: int, EP: int) -> Any:
    """Experts [e E / EP, (e + 1) E / EP) of an (E, ...) stack or leaf."""
    if EP == 1:
        return w
    if isinstance(w, dict):
        return {k: shard_experts(v, e, EP) for k, v in w.items()}
    E = w.shape[0]
    return w[e * E // EP:(e + 1) * E // EP].contiguous()


def shard_vocab(w: torch.Tensor, t: int, T: int) -> torch.Tensor:
    """Rows t of T of a (V, D) head."""
    if T == 1:
        return w
    V = w.shape[0]
    return w[t * V // T:(t + 1) * V // T].contiguous()


def mark_whole_n(lw: Params, tensor: int) -> Params:
    """Give each quantized two-dimensional leaf of a sharded layer (every
    one is a column shard of N / T columns) ``"n_whole"``, the N of its
    whole weight, from which K3 takes its split. Returns ``lw``."""
    if tensor > 1:
        for w in lw.values():
            if is_quantized(w) and w["scale"].dim() == 2:
                w["n_whole"] = w["scale"].shape[-1] * tensor
    return lw


# -- whole layers and trees -------------------------------------------------------


def shard_layer(lw: Params, args, mesh: Mesh) -> Params:
    """This rank's shard of one transformer layer; live LoRA pairs stay
    whole."""
    t, T = mesh.t, mesh.tensor
    D, Dh, F = args.dim, args.head_dim, args.hidden_dim
    qkv = [args.n_heads * Dh, args.n_kv_heads * Dh, args.n_kv_heads * Dh]
    out = dict(lw)
    out["wqkv"] = shard_columns(lw["wqkv"], qkv, t, T)
    out["wo"] = shard_columns(lw["wo"], [D], t, T)
    if "gate" in lw:
        out["w13"] = shard_columns(shard_experts(lw["w13"], mesh.e, mesh.expert), [F, F], t, T)
        out["w2"] = shard_columns(shard_experts(lw["w2"], mesh.e, mesh.expert), [D], t, T)
    else:
        out["w13"] = shard_columns(lw["w13"], [F, F], t, T)
        out["w2"] = shard_columns(lw["w2"], [D], t, T)
    return mark_whole_n(out, T)


def shard_params(params: Params, args, mesh: Mesh) -> Params:
    """This rank's shard of a transformer's params: every layer, the
    vocab-sharded head; the embedding, norms and vision encoder as they
    are. The layers are replaced one at a time."""
    check_transformer(args, mesh, args.quant, leaf_group(params["layers"][0]["wo"]) or 128)
    layers = params["layers"]
    for i, lw in enumerate(layers):
        layers[i] = shard_layer(lw, args, mesh)
    params["output"] = shard_vocab(params["output"], mesh.t, mesh.tensor)
    return params


def shard_mamba_layer(lw: Params, args, mesh: Mesh) -> Params:
    """This rank's shard of one Mamba2 layer: heads [t nh / T, (t + 1) nh / T)
    and their groups, and D / T of ``out_proj``'s output columns. ``dt_proj``
    stays whole: its product is a few hundred columns, which the rank takes
    from the whole product rather than from a narrower one of other bits."""
    t, T = mesh.t, mesh.tensor
    if T == 1:
        return lw
    di, gd = args.d_inner, args.n_groups * args.d_state
    heads = _part_slices([args.n_ssm_heads], t, T)[0]
    out = dict(lw)
    out["in_proj"] = shard_columns(lw["in_proj"], [di, di, gd, gd], t, T)
    for name in ("conv_w", "conv_b"):  # channels x | B | C on the last axis
        parts = _part_slices([di, gd, gd], t, T)
        out[name] = torch.cat([lw[name][..., s] for s in parts], -1).contiguous()
    for name in ("A_log", "D", "dt_bias"):
        out[name] = lw[name][heads].contiguous()
    out["out_proj"] = shard_columns(lw["out_proj"], [args.dim], t, T)
    return mark_whole_n(out, T)


def shard_mamba_params(params: Params, args, mesh: Mesh) -> Params:
    """This rank's shard of a Mamba2's params; a separate ``lm_head`` is
    vocab-sharded (a tied head slices the replicated embedding at use)."""
    check_mamba(args, mesh, args.quant, leaf_group(params["layers"][0]["out_proj"]) or 128)
    layers = params["layers"]
    for i, lw in enumerate(layers):
        layers[i] = shard_mamba_layer(lw, args, mesh)
    if "lm_head" in params:
        params["lm_head"] = shard_vocab(params["lm_head"], mesh.t, mesh.tensor)
    return params
