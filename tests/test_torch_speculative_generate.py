"""The port's greedy speculative generators end to end against its own plain
``generate()`` and against the JAX package's speculative output, on shared
weights (``convert.params_from_numpy``) in fp32 on the CPU, mirroring
tests/test_speculative.py. The pieces, the verify forwards and the sampled
generators are held in tests/test_torch_speculative.py.

Tolerances: greedy speculative tokens equal to the port's plain ``generate()``
AND to the JAX package's speculative tokens; logprobs 2e-3 (an int8 ring
amplifies fp32 summation-order differences through the rounding of K/V, as
tests/test_quant.py allows).
"""

import dataclasses

import numpy as np
import pytest
import torch

from mistral_inference_tpu import speculative as jsp
from mistral_inference_tpu.args import MoeArgs as JaxMoeArgs
from mistral_inference_tpu_torch import speculative as sp
from mistral_inference_tpu_torch.args import TransformerArgs
from mistral_inference_tpu_torch.generate import generate
from mistral_inference_tpu_torch.model import Transformer
from tests.test_torch_speculative import (  # noqa: F401 (the fixture applies here too)
    PROMPTS,
    _one_torch_thread,
    draft_args,
    jax_model,
    port_of,
    target_args,
)


# ---------------------------------------------------------------------------
# End to end, greedy: equal to plain generate() and to JAX's speculation
# ---------------------------------------------------------------------------

CASES = {
    # name: (target kwargs, target quant, draft: "small" | "self" | "int4" | "lookup", spec kwargs)
    "small_draft": (dict(), None, "small", dict(spec_tokens=3)),
    "self_draft": (dict(), None, "self", dict(spec_tokens=4)),
    "wrapping_window": (dict(sliding_window=16), None, "small", dict(spec_tokens=3, max_tokens=32)),
    "int8_ring": (dict(kv_quant="int8"), None, "small", dict(spec_tokens=3)),
    "int4_target": (dict(), "int4", "small", dict(spec_tokens=2)),
    "int4_draft": (dict(), None, "int4", dict(spec_tokens=2, max_tokens=12)),
    "moe_target": (dict(moe=JaxMoeArgs(num_experts=4, num_experts_per_tok=2)), None, "small",
                   dict(spec_tokens=2)),
    "chunked_prefill": (dict(), None, "small", dict(spec_tokens=3, chunk_size=3)),
    "lookup": (dict(), None, "lookup", dict(spec_tokens=4)),
    "lookup_window_int8": (dict(sliding_window=16, kv_quant="int8"), None, "lookup",
                           dict(spec_tokens=3, max_tokens=20)),
}


def _run_case(name, eos_from_plain=False):
    tkw, tquant, dkind, skw = CASES[name]
    skw = dict(skw)
    max_tokens = skw.pop("max_tokens", 16)
    jmodel = jax_model(target_args(**tkw), 0, tquant)
    model = port_of(jmodel)
    if dkind == "lookup":
        jdraft = draft = None
    elif dkind == "self":
        jdraft, draft = jmodel, model
    else:
        jdraft = jax_model(draft_args(), 1, "int4" if dkind == "int4" else None)
        draft = port_of(jdraft)
    chunk = skw.get("chunk_size")
    plain, plain_lps = generate(PROMPTS, model, max_tokens=max_tokens, temperature=0.0,
                                chunk_size=chunk)
    eos = None
    if eos_from_plain:
        flat = [t for row in plain for t in row[2:-2]]
        eos = flat[len(flat) // 2]
        plain, plain_lps = generate(PROMPTS, model, max_tokens=max_tokens, temperature=0.0,
                                    chunk_size=chunk, eos_id=eos)
    if dkind == "lookup":
        out = sp.generate_lookup(PROMPTS, model, max_tokens=max_tokens, eos_id=eos, **skw)
        ref = jsp.generate_lookup(PROMPTS, jmodel, max_tokens=max_tokens, eos_id=eos, **skw)
    else:
        out = sp.generate_speculative(PROMPTS, model, draft, max_tokens=max_tokens, eos_id=eos,
                                      **skw)
        ref = jsp.generate_speculative(PROMPTS, jmodel, jdraft, max_tokens=max_tokens,
                                       eos_id=eos, **skw)
    assert out[0] == plain, "speculation changed the port's greedy tokens"
    assert out[0] == ref[0], "the port's speculative tokens are not the JAX package's"
    for a, b, c, p in zip(out[1], plain_lps, ref[1], PROMPTS):
        assert len(a) == len(b) == len(c) == len(p) - 1 + len(out[0][0])
        np.testing.assert_allclose(a, b, atol=2e-3, rtol=0)
        np.testing.assert_allclose(a, c, atol=2e-3, rtol=0)
    return out, max_tokens


@pytest.mark.parametrize("name", sorted(CASES))
def test_greedy_speculation_matches_plain_and_jax(name):
    out, max_tokens = _run_case(name)
    assert all(len(g) == max_tokens for g in out[0])


@pytest.mark.parametrize("name", ["small_draft", "lookup_window_int8"])
def test_eos_truncation_matches_plain_and_jax(name):
    """``generate()``'s stop rule: tokens per global step until every row has
    emitted EOS; a row that has emitted it keeps generating until then."""
    out, max_tokens = _run_case(name, eos_from_plain=True)
    assert all(len(g) == len(out[0][0]) <= max_tokens for g in out[0])


def test_lookup_repetitive_prompt_accepts(monkeypatch):
    """A periodic prompt must actually get proposals accepted (the point of
    the feature) and stay exactly greedy."""
    model = port_of(jax_model(target_args(), 2))
    loop = [9, 4, 7] * 8
    seen = []
    walk = sp._walk_emits
    monkeypatch.setattr(sp, "_walk_emits", lambda e, l, acc, *r: (seen.append(acc), walk(e, l, acc, *r))[1])
    ref, _ = generate([loop], model, max_tokens=16, temperature=0.0)
    out, _ = sp.generate_lookup([loop], model, max_tokens=16, spec_tokens=4)
    assert out == ref
    assert np.concatenate(seen).sum() > 0, "no lookup proposal was ever accepted"


@pytest.mark.parametrize("draft", ["model", "lookup", "ngram"])
def test_generate_kwarg_dispatches(draft):
    model = port_of(jax_model(target_args(), 0))
    dm = port_of(jax_model(draft_args(), 1)) if draft == "model" else draft
    ref = generate(PROMPTS, model, max_tokens=12, temperature=0.0)
    out = generate(PROMPTS, model, max_tokens=12, temperature=0.0, draft_model=dm, spec_tokens=3)
    assert out[0] == ref[0]
    for p, t, l in zip(PROMPTS, *out):
        assert len(t) == 12 and len(l) == len(p) - 1 + 12


def test_refusals():
    model = port_of(jax_model(target_args(), 0))
    windowed = port_of(jax_model(draft_args(sliding_window=8), 1))
    with pytest.raises(ValueError, match="draft sliding window"):
        sp.generate_speculative(PROMPTS, model, windowed, max_tokens=8)
    other_vocab = port_of(jax_model(draft_args(vocab_size=128), 1))
    with pytest.raises(ValueError, match="vocabulary"):
        sp.generate_speculative(PROMPTS, model, other_vocab, max_tokens=8)
    with pytest.raises(TypeError, match="Transformer"):
        sp.generate_speculative(PROMPTS, model, "lookup", max_tokens=8)
    with pytest.raises(ValueError, match="spec_tokens"):
        sp.generate_lookup(PROMPTS, model, max_tokens=8, spec_tokens=0)
    with pytest.raises(ValueError, match="at least one token"):
        sp.generate_lookup([[1], []], model, max_tokens=8)


@pytest.mark.parametrize("kind,kv_quant", [("draft", "bf16"), ("draft", "int8"), ("lookup", "int8")])
def test_fused_route_forced_on_matches_scatter_route(monkeypatch, kind, kv_quant):
    """``write_cache="spec"`` + rewind (K7's plain version here) must emit
    what no-write verify + scatter_chunk emits, and leave the same ring over
    the committed tokens."""
    model = port_of(jax_model(target_args(kv_quant=kv_quant), 3))
    draft = port_of(jax_model(draft_args(), 1))

    def run():
        if kind == "lookup":
            return sp.generate_lookup(PROMPTS, model, max_tokens=20, spec_tokens=3)
        return sp.generate_speculative(PROMPTS, model, draft, max_tokens=20)

    assert not sp._spec_fused_ok(model, model.alloc_cache(1, 64), 3, 64)  # head_dim 32
    ref = run()
    routes = []
    monkeypatch.setattr(sp, "_spec_fused_ok", lambda *a, **k: True)
    verify = sp._verify
    monkeypatch.setattr(sp, "_verify", lambda *a: (routes.append(a[-1]), verify(*a))[1])
    out = run()
    assert routes and all(routes)
    assert out[0] == ref[0] == generate(PROMPTS, model, max_tokens=20, temperature=0.0)[0]
    for a, b in zip(out[1], ref[1]):
        np.testing.assert_allclose(a, b, atol=2e-3 if kv_quant == "int8" else 1e-4, rtol=0)


def test_spec_fused_gate():
    """The gate: K + 1 <= 8, the kernel's query rows, head_dim 128, a
    128-padded ring that can never wrap, and the fused decode switch."""
    from mistral_inference_tpu_torch.models import transformer as ttf

    args = TransformerArgs(dim=256, n_layers=2, head_dim=128, hidden_dim=256, n_heads=4,
                           n_kv_heads=2, norm_eps=1e-5, vocab_size=64, sliding_window=512)
    model = Transformer.random(args, dtype=torch.float32, seed=0, device="cpu")
    cache = model.alloc_cache(2, 300)
    assert cache.size == 384 and cache.windows == [300, 300]
    assert sp._spec_fused_ok(model, cache, 4, 300)
    assert sp._spec_fused_ok(model, cache, 7, 300)
    assert not sp._spec_fused_ok(model, cache, 8, 300)  # 9 tokens
    assert not sp._spec_fused_ok(model, cache, 4, 301)  # the ring could wrap
    wide = dataclasses.replace(args, n_heads=16)  # 8 query heads per KV head: 8 x 5 rows
    assert not sp._spec_fused_ok(Transformer(wide, model.params, torch.float32, "cpu"), cache, 4, 300)
    assert sp._spec_fused_ok(Transformer(wide, model.params, torch.float32, "cpu"), cache, 3, 300)
    old = ttf.FUSED_DECODE
    ttf.FUSED_DECODE = False
    try:
        assert not sp._spec_fused_ok(model, cache, 4, 300)
    finally:
        ttf.FUSED_DECODE = old
    # With the gate open by itself, the fused route runs and stays greedy.
    prompts = [[5, 17, 2, 9, 33], [7, 3]]
    ref = generate(prompts, model, max_tokens=10, temperature=0.0)
    out = generate(prompts, model, max_tokens=10, temperature=0.0, draft_model="lookup")
    assert out[0] == ref[0]
