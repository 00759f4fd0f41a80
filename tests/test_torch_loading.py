"""The port's checkpoint path against the JAX package's, on the CPU.

* ``io/safetensors.py`` against the ``safetensors`` package, both ways, for
  every dtype the port reads.
* Reference folders (dense, MoE, Pixtral vision, Mamba2; ``.safetensors``
  and ``.pth``, as tests/test_loading.py and tests/test_mamba.py write them):
  the port's ``from_folder(..., device="cpu")`` equals ``params_from_numpy``
  of the JAX loader's tree, in bits.
* ``params_to_numpy`` inverts ``params_from_numpy`` in bits.
* Stacked exports: the JAX package's ``save_stacked`` and the port's write
  the same tensors (keys, dtypes, bytes) and the same ``params.json``; each
  loads in the other package with its leaves unchanged.

Every comparison is exact: loading moves bytes and casts, nothing else.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.torch
import torch

from mistral_inference_tpu.args import MambaArgs as JaxMambaArgs
from mistral_inference_tpu.args import MoeArgs as JaxMoeArgs
from mistral_inference_tpu.args import TransformerArgs as JaxArgs
from mistral_inference_tpu.args import VisionEncoderArgs as JaxVisionArgs
from mistral_inference_tpu.args import load_args as jax_load_args
from mistral_inference_tpu.loading import load_mamba_params as jax_load_mamba
from mistral_inference_tpu.loading import load_transformer_params as jax_load_transformer
from mistral_inference_tpu.loading import save_stacked as jax_save_stacked
from mistral_inference_tpu.model import Mamba as JaxMamba
from mistral_inference_tpu.model import Transformer as JaxTransformer
from mistral_inference_tpu.model import from_folder as jax_from_folder
from mistral_inference_tpu.models.vision import init_vision_params
from mistral_inference_tpu_torch.args import MambaArgs, TransformerArgs, load_args
from mistral_inference_tpu_torch.convert import (
    mamba_params_from_numpy,
    params_from_numpy,
    params_to_numpy,
)
from mistral_inference_tpu_torch.io import safetensors as st
from mistral_inference_tpu_torch.loading import save_stacked
from mistral_inference_tpu_torch.model import Mamba, Transformer, from_folder

# -- helpers ------------------------------------------------------------------


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def assert_same(a, b, path="params"):
    """Trees of tensors (dicts, lists) equal in structure, dtype, shape and
    bits."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (path, a.keys(), b.keys())
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        assert torch.equal(_bits(a), _bits(b)), path


def assert_same_numpy(a, b, path="tree"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (path, a.keys(), b.keys())
        for k in a:
            assert_same_numpy(a[k], b[k], f"{path}/{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), path


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


# -- safetensors I/O ----------------------------------------------------------

ST_DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32, "I8": torch.int8,
    "U8": torch.uint8, "U16": torch.uint16, "I32": torch.int32, "I64": torch.int64,
    "F8_E4M3": torch.float8_e4m3fn,
}


def _draw(dtype: torch.dtype, shape, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    raw = torch.randint(0, 256, (int(np.prod(shape)) * dtype.itemsize,), generator=g,
                        dtype=torch.uint8)
    t = raw.view(dtype).reshape(shape)
    if dtype.is_floating_point:  # no NaN payloads: compare values as well as bits
        t = torch.where(t.float().isfinite(), t, torch.zeros((), dtype=dtype))
    return t


@pytest.mark.parametrize("name", list(ST_DTYPES))
def test_safetensors_matches_the_package(tmp_path, name):
    dtype = ST_DTYPES[name]
    tensors = {"b": _draw(dtype, (3, 5), 0), "a/x.bf16bits": _draw(dtype, (7,), 1),
               "scalar": _draw(dtype, (), 2), "f32": _draw(torch.float32, (2, 3), 3),
               "i8": _draw(torch.int8, (5,), 4)}
    ours, theirs = tmp_path / "ours.safetensors", tmp_path / "theirs.safetensors"
    st.save_file(tensors, ours)
    safetensors.torch.save_file(tensors, str(theirs))
    for got in (safetensors.torch.load_file(str(ours)), st.load_file(theirs), st.load_file(ours)):
        assert got.keys() == tensors.keys()
        for k, t in tensors.items():
            assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
            assert torch.equal(_bits(got[k]), _bits(t)), k
    header = json.loads(ours.read_bytes()[8:8 + int.from_bytes(ours.read_bytes()[:8], "little")])
    assert header["b"]["dtype"] == name


# -- reference folders ---------------------------------------------------------

DENSE = dict(dim=64, n_layers=2, head_dim=16, hidden_dim=128, n_heads=4, n_kv_heads=2,
             norm_eps=1e-5, vocab_size=256, rope_theta=10000.0)
VISION = dict(hidden_size=32, num_channels=3, image_size=32, patch_size=8, intermediate_size=64,
              num_hidden_layers=2, num_attention_heads=4, rope_theta=1e4, image_token_id=2,
              adapter_bias=True, spatial_merge_size=2, add_pre_mm_projector_layer_norm=True,
              mm_projector_id="patch_merge")
MAMBA = dict(dim=64, n_layers=2, vocab_size=256, n_groups=2, rms_norm=True,
             residual_in_fp32=True, fused_add_norm=True, pad_vocab_size_multiple=16,
             tie_embeddings=False, d_state=16, d_conv=4, expand=2, headdim=16,
             model_type="mamba")


def reference_state_dict(family: str, seed: int = 0):
    """(params.json dict, state dict of fp32 tensors) in the reference's key
    names and (out, in) layouts."""
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.05):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    def norm(n):
        return torch.from_numpy((1 + 0.1 * rng.standard_normal(n)).astype(np.float32))

    if family == "mamba":
        d = dict(MAMBA)
        di, gd, nh = 2 * d["dim"], d["n_groups"] * d["d_state"], 2 * d["dim"] // d["headdim"]
        V, D = 256, d["dim"]
        sd = {"backbone.embedding.weight": w(V, D), "backbone.norm_f.weight": norm(D),
              "lm_head.weight": w(V, D)}
        for i in range(d["n_layers"]):
            p = f"backbone.layers.{i}"
            sd.update({
                f"{p}.norm.weight": norm(D),
                f"{p}.mixer.in_proj.weight": w(2 * di + 2 * gd + nh, D),
                f"{p}.mixer.conv1d.weight": w(di + 2 * gd, 1, d["d_conv"], scale=0.3),
                f"{p}.mixer.conv1d.bias": w(di + 2 * gd),
                f"{p}.mixer.A_log": torch.from_numpy(
                    np.log(1 + rng.random(nh) * 15).astype(np.float32)),
                f"{p}.mixer.D": norm(nh),
                f"{p}.mixer.dt_bias": w(nh, scale=0.1),
                f"{p}.mixer.norm.weight": norm(di),
                f"{p}.mixer.out_proj.weight": w(D, di),
            })
        return d, sd
    d = dict(DENSE)
    D, L, H, Hkv, Dh, F, V = (d[k] for k in ("dim", "n_layers", "n_heads", "n_kv_heads",
                                             "head_dim", "hidden_dim", "vocab_size"))
    sd = {"tok_embeddings.weight": w(V, D), "norm.weight": norm(D), "output.weight": w(V, D)}
    for i in range(L):
        p = f"layers.{i}"
        sd.update({
            f"{p}.attention.wq.weight": w(H * Dh, D), f"{p}.attention.wk.weight": w(Hkv * Dh, D),
            f"{p}.attention.wv.weight": w(Hkv * Dh, D), f"{p}.attention.wo.weight": w(D, H * Dh),
            f"{p}.attention_norm.weight": norm(D), f"{p}.ffn_norm.weight": norm(D),
        })
        if family == "moe":
            sd[f"{p}.feed_forward.gate.weight"] = w(4, D)
            for e in range(4):
                ex = f"{p}.feed_forward.experts.{e}"
                sd.update({f"{ex}.w1.weight": w(F, D), f"{ex}.w2.weight": w(D, F),
                           f"{ex}.w3.weight": w(F, D)})
        else:
            sd.update({f"{p}.feed_forward.w1.weight": w(F, D),
                       f"{p}.feed_forward.w2.weight": w(D, F),
                       f"{p}.feed_forward.w3.weight": w(F, D)})
    if family == "moe":
        d["moe"] = {"num_experts": 4, "num_experts_per_tok": 2}
    if family == "vision":
        d["vision_encoder"] = dict(VISION)
        Dv, Fv = VISION["hidden_size"], VISION["intermediate_size"]
        sd["vision_encoder.patch_conv.weight"] = w(Dv, 3, 8, 8)
        sd["vision_encoder.ln_pre.weight"] = norm(Dv)
        for i in range(VISION["num_hidden_layers"]):
            p = f"vision_encoder.transformer.layers.{i}"
            for name, shape in [("attention.wq", (Dv, Dv)), ("attention.wk", (Dv, Dv)),
                                ("attention.wv", (Dv, Dv)), ("attention.wo", (Dv, Dv)),
                                ("feed_forward.w1", (Fv, Dv)), ("feed_forward.w2", (Dv, Fv)),
                                ("feed_forward.w3", (Fv, Dv))]:
                sd[f"{p}.{name}.weight"] = w(*shape)
            sd[f"{p}.attention_norm.weight"] = norm(Dv)
            sd[f"{p}.ffn_norm.weight"] = norm(Dv)
        sd["vision_language_adapter.w_in.weight"] = w(D, Dv)
        sd["vision_language_adapter.w_in.bias"] = w(D)
        sd["vision_language_adapter.w_out.weight"] = w(D, D)
        sd["vision_language_adapter.w_out.bias"] = w(D)
        sd["patch_merger.merging_layer.weight"] = w(Dv, Dv * 4)
        sd["pre_mm_projector_norm.weight"] = norm(Dv)
    return d, sd


def write_reference_folder(folder, family: str, fmt: str = "safetensors",
                           stored: torch.dtype = torch.float32, seed: int = 0):
    d, sd = reference_state_dict(family, seed)
    folder.mkdir(parents=True, exist_ok=True)
    (folder / "params.json").write_text(json.dumps(d))
    sd = {k: v.to(stored) for k, v in sd.items()}
    if fmt == "pth":
        torch.save(sd, folder / "consolidated.00.pth")
    else:
        safetensors.torch.save_file(sd, str(folder / "consolidated.safetensors"))
    return sd


@pytest.mark.parametrize("fmt,stored,dtype", [
    ("safetensors", torch.float32, torch.bfloat16),
    ("pth", torch.bfloat16, torch.float32),
])
@pytest.mark.parametrize("family", ["dense", "moe", "vision", "mamba"])
def test_reference_folder_loads_like_jax(tmp_path, family, fmt, stored, dtype):
    """Stored fp32 loaded as bf16 (a cast on both sides) and stored bf16
    loaded as fp32 (a widening)."""
    write_reference_folder(tmp_path, family, fmt, stored)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jargs = jax_load_args(tmp_path)
    model = from_folder(tmp_path, dtype=dtype, device="cpu")
    if family == "mamba":
        assert isinstance(model, Mamba)
        want = mamba_params_from_numpy(_np_tree(jax_load_mamba(tmp_path, jargs, jdtype)), "cpu")
        assert model.params["layers"][0]["A_log"].dtype == torch.float32
    else:
        assert isinstance(model, Transformer) and model.dtype == dtype
        want = params_from_numpy(_np_tree(jax_load_transformer(tmp_path, jargs, jdtype)), "cpu")
        assert model.params["layers"][0]["wqkv"].dtype == dtype
    assert_same(model.params, want)


def test_reference_folder_needs_one_checkpoint(tmp_path):
    write_reference_folder(tmp_path, "dense")
    (tmp_path / "consolidated.00.pth").write_bytes(b"")
    with pytest.raises(FileNotFoundError, match="exactly one"):
        from_folder(tmp_path, device="cpu")


def test_load_args_dispatch(tmp_path):
    write_reference_folder(tmp_path / "t", "moe")
    write_reference_folder(tmp_path / "m", "mamba")
    t, m = load_args(tmp_path / "t"), load_args(tmp_path / "m")
    assert isinstance(t, TransformerArgs) and t.moe.num_experts == 4 and t.dim == 64
    assert isinstance(m, MambaArgs) and m.d_state == 16
    (tmp_path / "t" / "params.json").write_text(json.dumps(dict(DENSE, model_type="rwkv")))
    with pytest.raises(ValueError, match="model_type"):
        load_args(tmp_path / "t")


# -- JAX models for the stacked tree ---------------------------------------------


def jax_model(case: str, seed: int = 3):
    """A tiny JAX model of the given case, bf16 unless fp32 is named."""
    if case.startswith("mamba"):
        args = JaxMambaArgs(**{k: v for k, v in MAMBA.items() if k != "model_type"})
        model = JaxMamba.random(args, dtype=jnp.bfloat16, seed=seed)
    else:
        kw = dict(dim=128, n_layers=2, head_dim=32, hidden_dim=256, n_heads=4, n_kv_heads=2,
                  norm_eps=1e-5, vocab_size=256, max_batch_size=2, rope_theta=1e4,
                  sliding_window=16, kv_quant="fp8")
        if case.startswith("moe"):
            kw["moe"] = JaxMoeArgs(4, 2)
        if case.startswith("vision"):
            kw["vision_encoder"] = JaxVisionArgs(**dict(VISION, hidden_size=64,
                                                        intermediate_size=128))
        model = JaxTransformer.random(JaxArgs(**kw), dtype=jnp.bfloat16, seed=seed)
        if case.startswith("vision"):
            model.params["vision"] = init_vision_params(
                jax.random.PRNGKey(seed + 1), model.args.vision_encoder, 128, jnp.bfloat16)
    for mode in ("int8", "int4"):
        if case.endswith(mode):
            model.quantize(mode, group=32)
    return model


def port_of(jmodel):
    """The port's model over the JAX model's weights."""
    tree = _np_tree(jmodel.params)
    if isinstance(jmodel, JaxMamba):
        args = MambaArgs.from_dict(dataclasses.asdict(jmodel.args))
        return Mamba(args, mamba_params_from_numpy(tree, "cpu"), torch.bfloat16, "cpu")
    args = TransformerArgs.from_dict(dataclasses.asdict(jmodel.args))
    return Transformer(args, params_from_numpy(tree, "cpu"), torch.bfloat16, "cpu")


CASES = ["bf16", "int8", "int4", "moe-int4", "vision", "mamba", "mamba-int4"]


@pytest.mark.parametrize("case", CASES)
def test_params_to_numpy_inverts_params_from_numpy(case):
    jmodel = jax_model(case)
    model = port_of(jmodel)
    assert_same_numpy(params_to_numpy(model.params, model.args), _np_tree(jmodel.params))


@pytest.mark.parametrize("case", ["int4", "moe-int8", "vision", "mamba-int4"])
def test_stacked_exports_agree_across_packages(tmp_path, case):
    jmodel = jax_model(case)
    model = port_of(jmodel)
    jax_save_stacked(tmp_path / "jax", jmodel)
    save_stacked(tmp_path / "port", model)
    # the same file contents and the same args
    a = st.load_file(tmp_path / "jax" / "consolidated.safetensors")
    b = st.load_file(tmp_path / "port" / "consolidated.safetensors")
    assert_same(a, b, "consolidated.safetensors")
    pa = json.loads((tmp_path / "jax" / "params.json").read_text())
    pb = json.loads((tmp_path / "port" / "params.json").read_text())
    assert pa == pb and list(pa) == list(pb)
    # the JAX export in the port, the port's export in JAX
    loaded = from_folder(tmp_path / "jax", max_batch_size=2, dtype=torch.bfloat16, device="cpu")
    assert dataclasses.asdict(loaded.args) == dataclasses.asdict(model.args)
    assert_same(loaded.params, model.params)
    jloaded = jax_from_folder(tmp_path / "port", max_batch_size=2, dtype=jnp.bfloat16)
    assert dataclasses.asdict(jloaded.args) == dataclasses.asdict(jmodel.args)
    assert_same_numpy(_np_tree(jloaded.params), _np_tree(jmodel.params))


def test_from_folder_quant_rules(tmp_path):
    """``quant`` on a reference folder quantizes after loading; an export
    keeps its mode (the same mode is a no-op, another raises); ``kv_quant``
    is set on the args; the tokenizer files are carried."""
    write_reference_folder(tmp_path / "ref", "dense")
    (tmp_path / "ref" / "tokenizer.model.v3").write_bytes(b"spm")
    q = from_folder(tmp_path / "ref", quant="int8", kv_quant="fp8", device="cpu")
    plain = from_folder(tmp_path / "ref", device="cpu").quantize("int8")
    assert q.args.quant == "int8" and q.args.kv_quant == "fp8"
    assert_same(q.params, plain.params)
    save_stacked(tmp_path / "q", q, tokenizer_from=tmp_path / "ref")
    assert (tmp_path / "q" / "tokenizer.model.v3").read_bytes() == b"spm"
    again = from_folder(tmp_path / "q", quant="int8", device="cpu")
    assert again.args.kv_quant == "fp8" and again.args.max_batch_size == 1
    assert_same(again.params, q.params)
    with pytest.raises(ValueError, match="already int8"):
        from_folder(tmp_path / "q", quant="int4", device="cpu")
