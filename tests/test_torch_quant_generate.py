"""The quantized slice as a whole: int8 and int4 weight-only ``generate()`` of
the port against the JAX package's on shared quantized weights
(``convert.params_from_numpy``), in fp32 on the CPU with an int8 KV ring.

Shapes: 2 layers, dim 256, hidden 512, 4 prompts with chunk 128, so every
prefill linear sees 512 rows (the K5 band of ``ops/linear.linear``) and every
decode linear 4 rows (the K3 band). The JAX side runs twice: on its XLA route
(``x @ dequant(w)``), and with ``attn_impl="pallas"`` under
``MISTRAL_PALLAS_INTERPRET=1``, which sends its linears and attention through
the Pallas kernels in interpret mode, as its own tests run them on the CPU.

Tolerances: greedy tokens equal; logprobs within 2e-3, tests/test_quant.py's
tolerance for an int8 ring (the ring's rounding of K/V to int8 amplifies fp32
summation-order differences). The fused and the non-fused decode routes leave
identical ring bytes, and their logits agree to 1e-6 (the same fp32 function
through the same plain attention; only the write differs in form).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistral_inference_tpu.args import TransformerArgs as JaxArgs
from mistral_inference_tpu.generate import generate as jax_generate
from mistral_inference_tpu.model import Transformer as JaxTransformer
from mistral_inference_tpu.ops.pallas import matmul_quant as jmq
from mistral_inference_tpu.ops.pallas import moe_matmul as jmm
from mistral_inference_tpu_torch.args import TransformerArgs
from mistral_inference_tpu_torch.convert import params_from_numpy
from mistral_inference_tpu_torch.generate import generate
from mistral_inference_tpu_torch.model import Transformer
from mistral_inference_tpu_torch.models import transformer as ttf
from mistral_inference_tpu_torch.ops import linear as tlin
from mistral_inference_tpu_torch.quant.weights import init_quantized_params, quantize_params

CHUNK = 128
GROUP = 64
_rng = np.random.default_rng(0)
# The first chunk is full for every row (4 x 128 = 512 rows); the second is
# ragged and padded to the chunk, as both packages pad it.
PROMPTS = [_rng.integers(1, 512, n).tolist() for n in (150, 128, 131, 140)]
SHORT_PROMPTS = [list(range(1, 14)), [2, 6, 10], [3, 7, 11, 15, 19, 23, 27, 31, 35], [4, 8]]


def jax_args(**overrides) -> JaxArgs:
    kw = dict(dim=256, n_layers=2, head_dim=128, hidden_dim=512, n_heads=2, n_kv_heads=1,
              norm_eps=1e-5, vocab_size=512, max_batch_size=4, rope_theta=10000.0,
              kv_quant="int8")
    kw.update(overrides)
    return JaxArgs(**kw)


def port_of(jmodel) -> Transformer:
    args = TransformerArgs.from_dict(dataclasses.asdict(jmodel.args))
    params = params_from_numpy(jax.tree.map(np.asarray, jmodel.params), device="cpu")
    return Transformer(args, params, torch.float32, device="cpu")


def _leaves(params):
    for i, lw in enumerate(params["layers"]):
        for name, w in lw.items():
            if tlin.is_quantized(w):
                for key, t in w.items():
                    yield f"layers[{i}].{name}.{key}", t
            else:
                yield f"layers[{i}].{name}", w


@pytest.mark.parametrize("route", ["xla", "pallas-interpret"])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_greedy_matches_jax(monkeypatch, mode, route):
    if route == "pallas-interpret":
        monkeypatch.setenv("MISTRAL_PALLAS_INTERPRET", "1")
    jmodel = JaxTransformer.random(
        jax_args(), dtype=jnp.float32, seed=3,
        attn_impl="pallas" if route == "pallas-interpret" else "xla",
    ).quantize(mode, group=GROUP)
    model = port_of(jmodel)
    assert model.args.quant == mode
    seen = {"k3": 0, "k5": 0, "jax_k3": 0, "jax_k5": 0}
    for module, name, key in (
        (tlin, "matmul_quant", "k3"), (tlin, "moe_matmul_quant_ragged", "k5"),
        (jmq, "matmul_quant_stacked", "jax_k3"), (jmm, "moe_matmul_quant_ragged", "jax_k5"),
    ):
        def counted(*a, _fn=getattr(module, name), _key=key, **kw):
            seen[_key] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(module, name, counted)
    jg, jl = jax_generate(PROMPTS, jmodel, max_tokens=4, temperature=0.0, chunk_size=CHUNK)
    tg, tl = generate(PROMPTS, model, max_tokens=4, temperature=0.0, chunk_size=CHUNK)
    # 2 chunks x 2 layers x 4 linears through K5; the decode steps through K3.
    assert seen["k5"] == 16 and seen["k3"] > 0 and seen["k3"] % 8 == 0
    # The JAX side traced its Pallas kernels on that route, and only there.
    assert (seen["jax_k3"] > 0 and seen["jax_k5"] > 0) == (route == "pallas-interpret")
    assert tg == jg
    for a, b, p in zip(tl, jl, PROMPTS):
        assert len(a) == len(b) == len(p) - 1 + 4
        np.testing.assert_allclose(a, b, atol=2e-3, rtol=0)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_port_quantize_gives_the_converted_bytes(mode):
    """Quantizing converted dense weights in the port == converting the tree
    the JAX package quantized: the fused leaves are exact concatenations."""
    jmodel = JaxTransformer.random(jax_args(), dtype=jnp.float32, seed=5)
    model = port_of(jmodel)
    dense_count = ttf.param_count(model.params)
    assert model.quantize(mode, group=GROUP) is model and model.args.quant == mode
    ref = port_of(jmodel.quantize(mode, group=GROUP))
    ours, theirs = dict(_leaves(model.params)), dict(_leaves(ref.params))
    assert sorted(ours) == sorted(theirs)
    for name, t in ours.items():
        assert t.dtype == theirs[name].dtype and t.is_contiguous(), name
        assert torch.equal(t, theirs[name]), name
    key = "q4" if mode == "int4" else "q"
    lw = model.params["layers"][0]
    assert lw["wqkv"][key].shape == (256 // (2 if mode == "int4" else 1), 512)
    assert lw["w13"]["scale"].shape == (256 // GROUP, 1024)
    assert not tlin.is_quantized(model.params["output"])
    # Logical weights: two per packed int4 byte, scales not counted.
    assert ttf.param_count(model.params) == dense_count


@pytest.mark.parametrize("mode,window", [("int8", None), ("int4", None), ("int4", 4)])
def test_quantized_decode_equals_prefill(mode, window):
    """tests/test_quant.py::test_int8_decode_prefill_equivalence and
    ::test_int4_weights_int8_kv_combined inside the port: decode goes through
    the K3 decomposition, the teacher-forced prefill through whatever band its
    rows fall in."""
    jmodel = JaxTransformer.random(
        jax_args(dim=128, head_dim=32, n_heads=4, n_kv_heads=2, hidden_dim=256,
                 sliding_window=window), dtype=jnp.float32, seed=42)
    model = port_of(jmodel).quantize(mode, group=32)
    gen, lps = generate(SHORT_PROMPTS, model, max_tokens=6, temperature=0.0, chunk_size=5)
    full = [p + g for p, g in zip(SHORT_PROMPTS, gen)]
    _, lps_ref = generate(full, model, max_tokens=0, temperature=0.0)
    for a, b in zip(lps, lps_ref):
        assert len(a) == len(b)
        np.testing.assert_allclose(a, b, atol=2e-3, rtol=0)


def test_decode_equals_prefill_across_k3_and_k5():
    """Decode through K3 (4 rows) against teacher-forced prefill through K5
    (512 rows): both are the same grouped-dequant product."""
    model = port_of(JaxTransformer.random(jax_args(), dtype=jnp.float32, seed=9))
    model.quantize("int4", group=GROUP)
    prompts = [p[:125] for p in PROMPTS]
    gen, lps = generate(prompts, model, max_tokens=3, temperature=0.0, chunk_size=CHUNK)
    full = [p + g for p, g in zip(prompts, gen)]  # 128 tokens each: one K5 chunk
    _, lps_ref = generate(full, model, max_tokens=0, temperature=0.0, chunk_size=CHUNK)
    for a, b in zip(lps, lps_ref):
        np.testing.assert_allclose(a, b, atol=2e-3, rtol=0)


def test_requantize_raises():
    model = port_of(JaxTransformer.random(jax_args(n_layers=1), dtype=jnp.float32, seed=0))
    model.quantize("int8")
    with pytest.raises(ValueError, match="already quantized"):
        model.quantize("int4")
    assert model.args.quant == "int8"
    with pytest.raises(ValueError, match="mode"):
        quantize_params({"layers": []}, "fp8")
    with pytest.raises(ValueError, match="quant"):
        TransformerArgs.from_dict({**dataclasses.asdict(model.args), "quant": "int2"})


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_init_quantized_params_is_born_quantized(mode):
    args = TransformerArgs.from_dict(dataclasses.asdict(jax_args(n_layers=3)))
    gen = torch.Generator().manual_seed(0)
    params = init_quantized_params(args, torch.float32, mode, gen, torch.device("cpu"))
    assert len(params["layers"]) == 3
    key = "q4" if mode == "int4" else "q"
    stored = 256 // (2 if mode == "int4" else 1)
    for lw in params["layers"]:
        assert lw["wqkv"][key].shape == (stored, 512) and lw["wqkv"][key].dtype == torch.int8
        assert lw["w2"]["scale"].shape == (4, 256) and bool((lw["w2"]["scale"] == 0.01).all())
        assert not tlin.is_quantized(lw["attention_norm"])
    assert not torch.equal(params["layers"][0]["wo"][key], params["layers"][1]["wo"][key])
    args.quant = mode
    model = Transformer(args, params, torch.float32, device="cpu")
    out, lps = generate(SHORT_PROMPTS, model, max_tokens=2, temperature=0.0)
    assert all(len(g) == 2 for g in out) and all(np.isfinite(lp).all() for lp in lps)


@pytest.mark.parametrize("kv_quant,window", [("int8", None), ("int8", 8), ("bf16", 8)])
def test_non_fused_decode_route_equals_fused(monkeypatch, kv_quant, window):
    """``FUSED_DECODE`` off: update_stacked then decode_attention. The ring
    bytes are identical to the fused route's, and the logits agree to 1e-6."""
    jmodel = JaxTransformer.random(
        jax_args(kv_quant=kv_quant, sliding_window=window), dtype=jnp.float32, seed=11)
    model = port_of(jmodel).quantize("int8", group=GROUP)
    rng = np.random.default_rng(1)
    lens = torch.tensor([11, 3, 7, 12], dtype=torch.int32)
    prompt = torch.from_numpy(rng.integers(1, 512, (4, 12)))
    steps = torch.from_numpy(rng.integers(1, 512, (5, 4, 1)))
    live = torch.tensor([1, 1, 0, 1], dtype=torch.int32)  # one finished row

    def drive(fused):
        monkeypatch.setattr(ttf, "FUSED_DECODE", fused)
        cache = model.alloc_cache(4, 32)
        model.forward(prompt, lens, cache, attend_cache=False)
        logits = [model.forward(tok, live, cache) for tok in steps]
        return cache, torch.stack(logits)

    c_fused, l_fused = drive(True)
    c_plain, l_plain = drive(False)
    for name in ("k", "v", "k_scale", "v_scale", "kv_len"):
        a, b = getattr(c_fused, name), getattr(c_plain, name)
        assert (a is None and b is None) or torch.equal(a, b), name
    rows = live.bool()
    np.testing.assert_allclose(l_plain[:, rows].numpy(), l_fused[:, rows].numpy(),
                               atol=1e-6, rtol=1e-6)
