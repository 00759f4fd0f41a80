"""The port's forward and generate() against the JAX package's, on shared
weights (``convert.params_from_numpy``), in fp32 on the CPU.

Tolerances, as the JAX package's own tests set them: teacher-forced logits
1e-4 (two fp32 implementations of the same function; summation order
differs); greedy logprobs 5e-4 (tests/test_generate.py) with a model-dtype
ring and 2e-3 with an int8 ring (tests/test_quant.py: the ring quantization
amplifies the fp32 differences through the rounding of K/V to int8).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistral_inference_tpu.args import TransformerArgs as JaxArgs
from mistral_inference_tpu.generate import generate as jax_generate
from mistral_inference_tpu.generate import top_p_probs as jax_top_p_probs
from mistral_inference_tpu.model import Transformer as JaxTransformer
from mistral_inference_tpu_torch.args import TransformerArgs
from mistral_inference_tpu_torch.convert import params_from_numpy
from mistral_inference_tpu_torch.generate import generate, top_p_probs
from mistral_inference_tpu_torch.model import Transformer

PROMPTS = [
    list(range(1, 14)),
    [2, 6, 10],
    [3, 7, 11, 15, 19, 23, 27, 31, 35],
    [4, 8],
]


def tiny_jax_args(**overrides) -> JaxArgs:
    kw = dict(dim=128, n_layers=2, head_dim=32, hidden_dim=256, n_heads=4, n_kv_heads=2,
              norm_eps=1e-5, vocab_size=512, max_batch_size=4, rope_theta=10000.0)
    kw.update(overrides)
    return JaxArgs(**kw)


def pair(seed=0, **overrides):
    """The same random weights in both packages."""
    jargs = tiny_jax_args(**overrides)
    jmodel = JaxTransformer.random(jargs, dtype=jnp.float32, seed=seed)
    args = TransformerArgs.from_dict(dataclasses.asdict(jargs))
    params = params_from_numpy(jax.tree.map(np.asarray, jmodel.params), device="cpu")
    return jmodel, Transformer(args, params, torch.float32, device="cpu")


@pytest.mark.parametrize("kv_quant,atol", [("bf16", 1e-4), ("int8", 1e-2)])
def test_teacher_forced_logits_match(kv_quant, atol):
    """Chunked prefill with GQA and a window (6) shorter than the prompt, so
    later chunks attend to a wrapped ring. With an int8 ring an fp32
    difference in K or V can move a value across an int8 rounding boundary:
    one such flip moves a logit by up to one quantization step, about 1% of
    the head's absmax, hence 1e-2 there (the ring values themselves are
    compared exactly in test_torch_cache.py)."""
    jmodel, model = pair(1, sliding_window=6, kv_quant=kv_quant)
    rng = np.random.default_rng(0)
    lens = np.array([17, 11, 5], np.int32)
    B, C, T = len(lens), 4, int(lens.max())
    toks = rng.integers(0, 512, (B, T)).astype(np.int32)
    jcache = jmodel.alloc_cache(B, T)
    cache = model.alloc_cache(B, T)
    for s in range(0, T, C):
        n = np.clip(lens - s, 0, C).astype(np.int32)
        chunk = toks[:, s : s + C]
        jl, jcache = jmodel.forward(jnp.asarray(chunk), jnp.asarray(n), jcache, attend_cache=s > 0)
        tl = model.forward(torch.from_numpy(chunk), torch.from_numpy(n), cache, attend_cache=s > 0)
        valid = np.arange(chunk.shape[1])[None] < n[:, None]
        np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], atol=atol, rtol=atol)
    np.testing.assert_array_equal(cache.kv_len.numpy(), np.asarray(jcache.kv_len))


@pytest.mark.parametrize(
    "kv_quant,window,chunk,atol",
    [("bf16", None, None, 5e-4), ("bf16", 4, 5, 5e-4), ("int8", 4, 5, 2e-3), ("int8", None, 3, 2e-3)],
)
def test_greedy_matches_jax(kv_quant, window, chunk, atol):
    jmodel, model = pair(7, sliding_window=window, kv_quant=kv_quant)
    jg, jl = jax_generate(PROMPTS, jmodel, max_tokens=6, temperature=0.0, chunk_size=chunk)
    tg, tl = generate(PROMPTS, model, max_tokens=6, temperature=0.0, chunk_size=chunk)
    assert tg == jg
    for a, b, p in zip(tl, jl, PROMPTS):
        assert len(a) == len(b) == len(p) - 1 + 6
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)


@pytest.mark.parametrize("kv_quant,atol", [("bf16", 5e-4), ("int8", 2e-3)])
def test_decode_equals_prefill(kv_quant, atol):
    """Greedy decode logprobs equal teacher-forced prefill logprobs of the
    same tokens, inside the port (ring wraps: window 4)."""
    _, model = pair(13, sliding_window=4, kv_quant=kv_quant)
    gen, lps = generate(PROMPTS, model, max_tokens=7, temperature=0.0, chunk_size=5)
    full = [p + g for p, g in zip(PROMPTS, gen)]
    _, lps_ref = generate(full, model, max_tokens=0, temperature=0.0)
    for a, b in zip(lps, lps_ref):
        assert len(a) == len(b)
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)


@pytest.mark.parametrize("p", [0.3, 0.8, 0.95])
def test_top_p_probs_match_jax(p):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((5, 512)).astype(np.float32) * 3
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    ref = np.asarray(jax_top_p_probs(jnp.asarray(probs), p))
    out = top_p_probs(torch.from_numpy(probs.copy()), p).numpy()
    np.testing.assert_array_equal(out > 0, ref > 0)
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_sampling_is_fixed_by_seed():
    _, model = pair(5, sliding_window=4, kv_quant="int8")
    kw = dict(max_tokens=8, temperature=0.7, top_p=0.9, chunk_size=4)
    a, la = generate(PROMPTS, model, seed=11, **kw)
    b, lb = generate(PROMPTS, model, seed=11, **kw)
    c, _ = generate(PROMPTS, model, seed=12, **kw)
    assert a == b and la == lb
    assert a != c
    assert all(0 <= t < 512 for row in a for t in row)


def test_eos_early_exit():
    _, model = pair(42)
    generated, _ = generate(PROMPTS, model, max_tokens=5, temperature=0.0)
    eos = generated[0][2]
    out, lps = generate(PROMPTS, model, max_tokens=5, temperature=0.0, eos_id=eos, decode_block=2)
    finished = [eos in g[:3] for g in generated]
    if all(finished):
        assert all(len(g) < 5 for g in out)
    assert out[0][:2] == generated[0][:2]
    assert all(len(g) == len(out[0]) for g in out)
    assert all(len(lp) == len(p) - 1 + len(g) for lp, p, g in zip(lps, PROMPTS, out))


def test_unported_arguments_raise():
    _, model = pair(0)
    # Images are ported (tests/test_torch_vision_generate.py); a model
    # without a vision encoder refuses them.
    with pytest.raises(ValueError, match="no vision encoder"):
        generate(PROMPTS, model, [[np.zeros((4, 4, 3))]], max_tokens=1, temperature=0.0)
    # Speculation is ported; images beside a draft are refused, and a draft
    # is a Transformer or the name of the draft-free proposer.
    with pytest.raises(ValueError, match="image"):
        generate(PROMPTS, model, [[np.zeros((4, 4, 3))]], max_tokens=1, temperature=0.0,
                 draft_model=model)
    with pytest.raises(ValueError, match="lookup"):
        generate(PROMPTS, model, max_tokens=1, temperature=0.0, draft_model="medusa")
