"""The sparse-MoE slice as a whole: ``generate()`` of the port against the JAX
package's on shared weights (``convert.params_from_numpy``), in fp32 on the
CPU with an int8 KV ring, for ``moe_impl`` dense and dispatch, plain, int8 and
int4 experts.

Shapes: 2 layers, dim 256, hidden 512, 4 experts, top-2, 4 prompts with chunk
128. A prefill chunk is 512 rows, so dispatch hands it to the sorted ragged
path (K5 with one weight per tile), and a decode step is 4 rows in capacity
buffers of 4 slots (K8). With 4 experts, top-2 and the default capacity factor
2.0 the capacity equals the row count wherever the capacity path runs, so no
assignment drops and dense and dispatch agree. The JAX side runs on its XLA
route, and with ``attn_impl="pallas"`` under ``MISTRAL_PALLAS_INTERPRET=1``,
which sends its expert products through the Pallas kernels in interpret mode.

Tolerances: greedy tokens equal; logprobs within 2e-3, the tolerance of
tests/test_torch_quant_generate.py and tests/test_quant.py for an int8 ring
(the ring's rounding of K/V to int8 amplifies fp32 summation-order
differences).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistral_inference_tpu.args import MoeArgs as JaxMoeArgs
from mistral_inference_tpu.args import TransformerArgs as JaxArgs
from mistral_inference_tpu.generate import generate as jax_generate
from mistral_inference_tpu.model import Transformer as JaxTransformer
from mistral_inference_tpu.ops.pallas import moe_matmul as jmm
from mistral_inference_tpu_torch.args import TransformerArgs
from mistral_inference_tpu_torch.convert import params_from_numpy
from mistral_inference_tpu_torch.generate import generate
from mistral_inference_tpu_torch.model import Transformer
from mistral_inference_tpu_torch.models import transformer as ttf
from mistral_inference_tpu_torch.models.registry import get_args

CHUNK = 128
GROUP = 64
LOGPROB_TOL = dict(atol=2e-3, rtol=0)
_rng = np.random.default_rng(0)
# The first chunk is full for every row (4 x 128 = 512 rows); the second is
# ragged and padded to the chunk, as both packages pad it.
PROMPTS = [_rng.integers(1, 512, n).tolist() for n in (150, 128, 131, 140)]
SHORT_PROMPTS = [list(range(1, 14)), [2, 6, 10], [3, 7, 11, 15, 19, 23, 27, 31, 35], [4, 8]]


def jax_args(**overrides) -> JaxArgs:
    kw = dict(dim=256, n_layers=2, head_dim=128, hidden_dim=512, n_heads=2, n_kv_heads=1,
              norm_eps=1e-5, vocab_size=512, max_batch_size=4, rope_theta=10000.0,
              kv_quant="int8", moe=JaxMoeArgs(num_experts=4, num_experts_per_tok=2))
    kw.update(overrides)
    return JaxArgs(**kw)


def port_of(jmodel) -> Transformer:
    args = TransformerArgs.from_dict(dataclasses.asdict(jmodel.args))
    params = params_from_numpy(jax.tree.map(np.asarray, jmodel.params), device="cpu")
    return Transformer(args, params, torch.float32, device="cpu")


def _count(monkeypatch, seen, module, name, key):
    def counted(*a, _fn=getattr(module, name), **kw):
        seen[key] += 1
        return _fn(*a, **kw)

    monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("impl,mode,route", [
    ("dense", None, "xla"),
    ("dense", "int8", "xla"),
    ("dense", "int4", "xla"),
    ("dispatch", None, "xla"),
    ("dispatch", "int8", "xla"),
    ("dispatch", "int4", "xla"),
    ("dispatch", "int8", "pallas-interpret"),
    ("dispatch", "int4", "pallas-interpret"),
])
def test_moe_greedy_matches_jax(monkeypatch, impl, mode, route):
    if route == "pallas-interpret":
        monkeypatch.setenv("MISTRAL_PALLAS_INTERPRET", "1")
    jmodel = JaxTransformer.random(
        jax_args(moe_impl=impl), dtype=jnp.float32, seed=3,
        attn_impl="pallas" if route == "pallas-interpret" else "xla",
    )
    if mode is not None:
        jmodel.quantize(mode, group=GROUP)
    model = port_of(jmodel)
    assert model.args.moe_impl == impl and model.args.quant == (mode or "bf16")
    seen = {"k8": 0, "k5": 0, "jax_k8": 0, "jax_k5": 0}
    _count(monkeypatch, seen, ttf, "moe_matmul_quant", "k8")
    _count(monkeypatch, seen, ttf, "moe_matmul_quant_ragged", "k5")
    _count(monkeypatch, seen, jmm, "moe_matmul_quant_stacked", "jax_k8")
    _count(monkeypatch, seen, jmm, "moe_matmul_quant_ragged", "jax_k5")
    jg, jl = jax_generate(PROMPTS, jmodel, max_tokens=4, temperature=0.0, chunk_size=CHUNK)
    tg, tl = generate(PROMPTS, model, max_tokens=4, temperature=0.0, chunk_size=CHUNK)
    if impl == "dispatch" and mode is not None:
        # 2 chunks x 2 layers x (w13, w2) through K5 with a weight per tile;
        # 4 decode steps x 2 layers x (w13, w2) through K8.
        assert seen["k5"] == 8 and seen["k8"] == 16
    else:
        assert seen["k5"] == 0 and seen["k8"] == 0
    # The JAX side traced its Pallas expert kernels on that route, and only there.
    assert (seen["jax_k8"] > 0 and seen["jax_k5"] > 0) == (route == "pallas-interpret")
    assert tg == jg
    for a, b, p in zip(tl, jl, PROMPTS):
        assert len(a) == len(b) == len(p) - 1 + 4
        np.testing.assert_allclose(a, b, **LOGPROB_TOL)


@pytest.mark.parametrize("mode", [None, "int4"])
def test_moe_dispatch_equals_dense_inside_the_port(mode):
    """tests/test_generate.py's dense-against-dispatch check: with capacity
    for every assignment the two strategies are the same function."""
    jmodel = JaxTransformer.random(jax_args(), dtype=jnp.float32, seed=7)
    dense = port_of(jmodel)
    if mode is not None:
        dense.quantize(mode, group=GROUP)
    disp = Transformer(dataclasses.replace(dense.args, moe_impl="dispatch"), dense.params,
                       torch.float32, device="cpu")
    gen_d, lp_d = generate(PROMPTS, dense, max_tokens=4, temperature=0.0, chunk_size=CHUNK)
    gen_s, lp_s = generate(PROMPTS, disp, max_tokens=4, temperature=0.0, chunk_size=CHUNK)
    assert gen_d == gen_s
    for a, b in zip(lp_d, lp_s):
        np.testing.assert_allclose(a, b, **LOGPROB_TOL)


@pytest.mark.parametrize("impl,mode,window", [
    ("dense", None, None),
    ("dispatch", None, None),
    ("dispatch", "int8", None),
    ("dispatch", "int4", 4),
])
def test_moe_decode_equals_prefill(impl, mode, window):
    """Greedy decode logprobs against the teacher-forced prefill of the same
    tokens: decode routes 4 rows through the capacity buffers (K8's
    decomposition when quantized), the prefill whatever its rows fall in."""
    jmodel = JaxTransformer.random(
        jax_args(moe_impl=impl, moe_capacity_factor=4.0, sliding_window=window),
        dtype=jnp.float32, seed=42)
    model = port_of(jmodel)
    if mode is not None:
        model.quantize(mode, group=GROUP)
    gen, lps = generate(SHORT_PROMPTS, model, max_tokens=6, temperature=0.0, chunk_size=5)
    full = [p + g for p, g in zip(SHORT_PROMPTS, gen)]
    _, lps_ref = generate(full, model, max_tokens=0, temperature=0.0)
    for a, b in zip(lps, lps_ref):
        assert len(a) == len(b)
        np.testing.assert_allclose(a, b, **LOGPROB_TOL)


def test_moe_decode_equals_prefill_across_k8_and_k5():
    """Decode through K8 (4 rows in capacity buffers) against teacher-forced
    prefill through K5 (512 rows, sorted by expert): both are the same
    grouped-dequant product per expert."""
    model = port_of(JaxTransformer.random(jax_args(moe_impl="dispatch"), dtype=jnp.float32, seed=9))
    model.quantize("int4", group=GROUP)
    prompts = [p[:125] for p in PROMPTS]
    gen, lps = generate(prompts, model, max_tokens=3, temperature=0.0, chunk_size=CHUNK)
    full = [p + g for p, g in zip(prompts, gen)]  # 128 tokens each: one K5 chunk
    _, lps_ref = generate(full, model, max_tokens=0, temperature=0.0, chunk_size=CHUNK)
    for a, b in zip(lps, lps_ref):
        np.testing.assert_allclose(a, b, **LOGPROB_TOL)


def test_moe_dispatch_with_drops_matches_jax():
    """A capacity factor that drops assignments in the prefill (12 rows a
    chunk, 8 slots an expert for 24 assignments, every row full so that no pad
    position is routed): the port drops the assignments the JAX package drops."""
    jmodel = JaxTransformer.random(
        jax_args(moe_impl="dispatch", moe_capacity_factor=0.25), dtype=jnp.float32, seed=13)
    model = port_of(jmodel)
    prompts = [_rng.integers(1, 512, 12).tolist() for _ in range(4)]
    jg, jl = jax_generate(prompts, jmodel, max_tokens=3, temperature=0.0, chunk_size=3)
    tg, tl = generate(prompts, model, max_tokens=3, temperature=0.0, chunk_size=3)
    assert tg == jg
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, **LOGPROB_TOL)
    # And the drops are real: the dense strategy gives other logprobs.
    dense = Transformer(dataclasses.replace(model.args, moe_impl="dense"), model.params,
                        torch.float32, device="cpu")
    _, dl = generate(prompts, dense, max_tokens=3, temperature=0.0, chunk_size=3)
    assert max(np.abs(np.array(a) - np.array(b)).max() for a, b in zip(tl, dl)) > 1e-2


@pytest.mark.parametrize("name", ["mixtral-8x7b", "mixtral-8x22b"])
def test_mixtral_presets(name):
    args = get_args(name)
    assert args.moe.num_experts == 8 and args.moe.num_experts_per_tok == 2
    assert args.moe_impl == "dense" and args.moe_capacity_factor == 2.0
    args.moe.num_experts = 2  # a fresh copy: the registry keeps its own
    assert get_args(name).moe.num_experts == 8
    # The kernels' gates open at the published widths.
    assert args.dim % 256 == 0 and args.hidden_dim % 256 == 0
