"""The port's speculative serving on the CPU, mirroring the speculative
cases of tests/test_engine.py: ``Engine(draft_model=<Transformer> |
"lookup")`` serves each greedy request with the tokens of the port's own
standalone ``generate()``, under staggered admission, EOS at the first
token and mid-block, mixed temperatures, the prefix cache (into the draft's
ring too), staged admission and the fused verify route. One case per mode,
``test_spec_engine_matches_jax_engine[draft|lookup]``, is also held against
the JAX package's ``Engine`` on the same weights. Sampled rows are held to
their contract (fixed by the seed; a near-zero temperature gives the greedy
tokens), not to JAX's random stream.

Tolerances: greedy tokens equal; prompt and generated logprobs within 1e-4
of generate()'s (fp32, the same function in other chunkings).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistral_inference_tpu.args import TransformerArgs as JaxArgs
from mistral_inference_tpu.model import Transformer as JaxTransformer
from mistral_inference_tpu.server.engine import Engine as JaxEngine
from mistral_inference_tpu_torch.args import MambaArgs, TransformerArgs
from mistral_inference_tpu_torch.convert import params_to_numpy
from mistral_inference_tpu_torch.generate import generate
from mistral_inference_tpu_torch.model import Mamba, Transformer
from mistral_inference_tpu_torch.server.engine import Engine
from mistral_inference_tpu_torch.utils.profiling import METRICS

PROMPTS = [
    [1, 5, 9, 13, 17, 21],
    [2, 6, 10],
    [3, 7, 11, 15, 19, 23, 27],
    [4, 8],
    [9, 9, 9, 1],
]
LP_TOL = dict(atol=1e-4, rtol=0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_args(**overrides) -> dict:
    """tests/test_generate.py's tiny_args."""
    kw = dict(dim=128, n_layers=2, head_dim=32, hidden_dim=256, n_heads=4, n_kv_heads=2,
              norm_eps=1e-5, vocab_size=512, max_batch_size=4, rope_theta=10000.0)
    kw.update(overrides)
    return kw


def _pair(seed, **overrides):
    """A tiny model in both packages on the same fp32 weights (drawn by the
    port, carried to the JAX tree by ``params_to_numpy``)."""
    model = Transformer.random(TransformerArgs(**tiny_args(**overrides)), dtype=torch.float32,
                               seed=seed, device="cpu")
    tree = jax.tree.map(jnp.asarray, params_to_numpy(model.params, model.args))
    return JaxTransformer(JaxArgs(**tiny_args(**overrides)), tree, jnp.float32), model


@pytest.fixture(scope="module")
def models():
    """(JAX target, port target, JAX draft, port draft), built once."""
    jt, t = _pair(42)
    jd, d = _pair(99, dim=64, n_layers=1, head_dim=16, hidden_dim=128)
    return jt, t, jd, d


def reference(model, prompts, max_tokens, **kw):
    return [generate([p], model, max_tokens=max_tokens, temperature=0.0, **kw)[0][0]
            for p in prompts]


def counter(name):
    return METRICS.counters.get(name, 0.0)


@pytest.mark.parametrize("mode", ["draft", "lookup"])
def test_spec_engine_matches_jax_engine(models, mode):
    """Both packages' speculative engines on shared weights, three requests
    over two slots: equal tokens, equal to the port's generate(); the
    logprob request's logprobs within 1e-4 of JAX's."""
    jt, t, jd, d = models
    draft = (jd, d) if mode == "draft" else ("lookup", "lookup")
    ref = reference(t, PROMPTS[:3], 6)
    jeng = JaxEngine(jt, batch_size=2, max_seq_len=64, draft_model=draft[0], spec_tokens=2)
    jids = [jeng.submit(p, max_tokens=6, want_logprobs=i == 0) for i, p in enumerate(PROMPTS[:3])]
    jr = jeng.queue[0]  # the logprob request's record, kept past its slot's reuse
    jres = jeng.run_to_completion()
    eng = Engine(t, batch_size=2, max_seq_len=64, draft_model=draft[1], spec_tokens=2)
    ids = [eng.submit(p, max_tokens=6, want_logprobs=i == 0) for i, p in enumerate(PROMPTS[:3])]
    r = eng.queue[0]
    res = eng.run_to_completion()
    assert [res[i] for i in ids] == [jres[i] for i in jids] == ref
    assert len(r.prompt_logprobs) == len(PROMPTS[0]) - 1 and len(r.gen_logprobs) == 6
    np.testing.assert_allclose(r.prompt_logprobs, jr.prompt_logprobs, **LP_TOL)
    np.testing.assert_allclose(r.gen_logprobs, jr.gen_logprobs, **LP_TOL)


@pytest.mark.parametrize("mode", ["draft", "self", "lookup"])
def test_spec_engine_matches_generate(models, mode):
    """Greedy speculative serving gives generate()'s tokens for every
    request, through slot recycling (five requests, two slots), with any
    draft: an independent one, the target itself, prompt lookup."""
    _, t, _, d = models
    draft = {"draft": d, "self": t, "lookup": "lookup"}[mode]
    ref = reference(t, PROMPTS, 7)
    eng = Engine(t, batch_size=2, max_seq_len=64, draft_model=draft, spec_tokens=3)
    ids = [eng.submit(p, max_tokens=7) for p in PROMPTS]
    res = eng.run_to_completion()
    assert [res[i] for i in ids] == ref
    assert METRICS.samples["spec_tokens_per_forward"]


def test_spec_engine_staggered_and_eos(models):
    """Slot recycling and an EOS that falls mid-stream: each request stops
    at, and drops, the EOS."""
    _, t, _, d = models
    ref = reference(t, PROMPTS, 6)
    eos = ref[0][3]
    eng = Engine(t, batch_size=2, max_seq_len=64, eos_id=eos, draft_model=d, spec_tokens=3)
    ids = [eng.submit(p, max_tokens=6) for p in PROMPTS]
    res = eng.run_to_completion()
    assert len(res) == len(PROMPTS)
    for rid, want in zip(ids, ref):
        assert res[rid] == (want[:want.index(eos)] if eos in want else want)


def test_spec_engine_first_token_eos(models):
    """A request whose first token is EOS finishes at admission with no
    tokens; its event comes from that step."""
    _, t, _, d = models
    eos = reference(t, [PROMPTS[0]], 1)[0][0]
    eng = Engine(t, batch_size=2, max_seq_len=64, eos_id=eos, draft_model=d, spec_tokens=2)
    rid = eng.submit(PROMPTS[0], max_tokens=5)
    events = eng.step()
    assert [(e.request_id, e.finished) for e in events] == [(rid, True)]
    assert eng._result(rid) == [] and not eng.has_work


def test_spec_engine_logprobs_and_ttft(models):
    """A lookup engine's logprob request: prompt and generated logprobs equal
    generate()'s; the first token is emitted by the admitting step."""
    _, t, _, _ = models
    prompt = [1 + (i * 7) % 200 for i in range(30)]
    g, lps = generate([prompt], t, max_tokens=9, temperature=0.0)
    eng = Engine(t, batch_size=2, max_seq_len=64, draft_model="lookup", spec_tokens=3,
                 admit_chunk=16)
    rid = eng.submit(prompt, max_tokens=9, want_logprobs=True)
    first = eng.step()
    assert first[0].request_id == rid and first[0].token == g[0][0]
    assert eng._request(rid).t_first_token > 0
    assert eng.run_to_completion()[rid] == g[0]
    r = eng._request(rid)
    np.testing.assert_allclose(r.prompt_logprobs, lps[0][:len(prompt) - 1], **LP_TOL)
    np.testing.assert_allclose(r.gen_logprobs, lps[0][len(prompt) - 1:], **LP_TOL)


def test_spec_engine_mixed_temperatures(models):
    """Greedy and sampled requests in one speculative batch: the greedy rows
    keep generate()'s tokens; sampled rows repeat for a seed and an order of
    arrival, and at a near-zero temperature give the greedy tokens."""
    _, t, _, d = models
    ref = reference(t, PROMPTS[:3], 7)

    def serve(temp, seed):
        eng = Engine(t, batch_size=3, max_seq_len=64, draft_model=d, spec_tokens=2, seed=seed)
        ids = [eng.submit(p, max_tokens=7, temperature=temp if i == 1 else 0.0, top_p=0.9)
               for i, p in enumerate(PROMPTS[:3])]
        res = eng.run_to_completion()
        return [res[i] for i in ids]

    a, b = serve(0.9, 3), serve(0.9, 3)
    assert a == b and a[0] == ref[0] and a[2] == ref[2]
    assert len(a[1]) == 7 and all(0 <= x < 512 for x in a[1])
    assert serve(1e-4, 3) == ref


def test_spec_engine_prefix_cache_fills_the_draft_ring(models):
    """A prefix hit copies the prefix into the target's ring and the
    draft's; the tokens stay generate()'s."""
    _, t, _, d = models
    sys_p = [(7 * k + 1) % 512 for k in range(24)]
    prompts = [sys_p + [1, 2, 3], sys_p + [8, 9]]
    ref = reference(t, prompts, 6)
    for draft in (d, "lookup"):
        eng = Engine(t, batch_size=2, max_seq_len=96, draft_model=draft, spec_tokens=2)
        h0 = counter("prefix_hits")
        r0 = eng.submit(prompts[0], max_tokens=6)
        eng.run_to_completion()
        if draft is d:
            # The source row's draft ring holds the prefix the copy reads.
            src = eng.dcache.k[:, 0, :24].clone()
        r1 = eng.submit(prompts[1], max_tokens=6)
        eng.run_to_completion()
        assert [eng._result(r0), eng._result(r1)] == ref
        assert counter("prefix_hits") >= h0 + 1
        if draft is d:
            assert torch.equal(eng.dcache.k[:, 1, :24], src)


def test_spec_engine_lookup_staged_admission(models):
    """Trickle re-admissions of a lookup engine take the staging path and
    stay greedy-exact; a draft engine never stages."""
    _, t, _, d = models
    ref = reference(t, PROMPTS, 6)
    for draft in ("lookup", d):
        METRICS.counters.pop("staged_admissions", None)
        eng = Engine(t, batch_size=2, max_seq_len=64, draft_model=draft, spec_tokens=2,
                     admit_waterline=1, staging_batch=1, prefix_cache=False)
        ids = [eng.submit(p, max_tokens=6) for p in PROMPTS]
        res = eng.run_to_completion()
        assert [res[i] for i in ids] == ref
        assert (counter("staged_admissions") >= 1) == (draft == "lookup")


def test_spec_engine_defaults():
    """The speculative defaults: a harder admission waterline; a lookup
    engine's staging batch widened to it plus one (explicit values stay);
    the target ring allocated once, span = max_seq_len plus one block's
    overshoot; the fused verify gate on a ring that cannot wrap."""
    model = Transformer.random(TransformerArgs(**tiny_args(head_dim=128, n_heads=2, n_kv_heads=1,
                                                           dim=128)),
                               dtype=torch.float32, seed=1, device="cpu")
    eng = Engine(model, batch_size=8, max_seq_len=64, draft_model="lookup", spec_tokens=2)
    assert eng.admit_waterline == 2 and eng._staging_B == 3
    assert Engine(model, batch_size=8, max_seq_len=64, draft_model="lookup", spec_tokens=2,
                  staging_batch=3)._staging_B == 3
    assert Engine(model, batch_size=8, max_seq_len=64, draft_model=model)._staging_B == 1
    # decode_block 8, K = 2: 2 iterations a block; slack 2 * 3 + 2 + 2.
    assert eng._spec_iters == 2 and eng._span == 64 + 10
    assert eng.cache.windows == [74, 74] and eng._hist.shape == (8, 74)
    assert eng._spec_fused
    windowed = Transformer.random(TransformerArgs(**tiny_args(head_dim=128, n_heads=2,
                                                              n_kv_heads=1, sliding_window=32)),
                                  dtype=torch.float32, seed=1, device="cpu")
    assert not Engine(windowed, batch_size=2, max_seq_len=64, draft_model="lookup")._spec_fused


def test_spec_engine_fused_verify_route():
    """head_dim 128 and a ring that never wraps: the verify forwards write
    the ring (K7's plain version here) and commit by rewinding; the tokens
    stay generate()'s, for a draft and for lookup, and no row's fill passes
    prompt + max_tokens + the block's slack."""
    model = Transformer.random(TransformerArgs(**tiny_args(head_dim=128, n_heads=2, n_kv_heads=1)),
                               dtype=torch.float32, seed=5, device="cpu")
    ref = reference(model, PROMPTS, 6)
    for draft in (model, "lookup"):
        eng = Engine(model, batch_size=2, max_seq_len=48, draft_model=draft, spec_tokens=3)
        assert eng._spec_fused
        ids = [eng.submit(p, max_tokens=6) for p in PROMPTS]
        res = eng.run_to_completion()
        assert [res[i] for i in ids] == ref
        fill = eng.cache.kv_len.tolist()
        for slot, r in enumerate(eng.slots):
            assert fill[slot] <= len(r.prompt) + r.max_tokens + eng._span - eng.max_seq_len


def test_spec_engine_nan_row_fails_alone(models):
    """A row whose verify logits go NaN fails with an error; the other rows
    keep their tokens."""
    _, t, _, _ = models
    ref = reference(t, PROMPTS[:2], 6)
    eng = Engine(t, batch_size=2, max_seq_len=64, draft_model="lookup", spec_tokens=2)
    ids = [eng.submit(p, max_tokens=6) for p in PROMPTS[:2]]
    eng.step()  # admission and the first tokens
    forward = t.forward

    def poisoned(tokens, seqlens, cache, *a, **kw):
        out = forward(tokens, seqlens, cache, *a, **kw)
        if tokens.shape[1] > 1 and kw.get("write_cache", True) is not True:
            logits = out[0] if isinstance(out, tuple) else out
            logits[1] = float("nan")
        return out

    t.forward = poisoned
    try:
        events = eng.step()
    finally:
        t.forward = forward
    failed = [e for e in events if e.token == -1]
    assert [e.request_id for e in failed] == [ids[1]]
    assert eng._request(ids[1]).error is not None
    res = eng.run_to_completion()
    assert res[ids[0]] == ref[0]


def test_spec_engine_refusals(models):
    """An image request to a speculative engine, a draft with another
    vocabulary or a window its span would wrap, and a Mamba model."""
    _, t, _, _ = models
    eng = Engine(t, batch_size=2, max_seq_len=64, draft_model="lookup")
    with pytest.raises(ValueError, match="text-only|vision encoder"):
        eng.submit(PROMPTS[0], max_tokens=2, images=[np.zeros((3, 16, 16), np.float32)])
    with pytest.raises(ValueError, match="draft_model"):
        Engine(t, batch_size=2, max_seq_len=64, draft_model="medusa")
    other = Transformer.random(TransformerArgs(**tiny_args(vocab_size=256, n_layers=1)),
                               dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        Engine(t, batch_size=2, max_seq_len=64, draft_model=other)
    windowed = Transformer.random(TransformerArgs(**tiny_args(n_layers=1, sliding_window=32)),
                                  dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="wrap"):
        Engine(t, batch_size=2, max_seq_len=64, draft_model=windowed)
    mamba = Mamba.random(MambaArgs(dim=64, n_layers=1, vocab_size=256, n_groups=2, rms_norm=True,
                                   residual_in_fp32=True, fused_add_norm=True,
                                   pad_vocab_size_multiple=16, tie_embeddings=False, d_state=16,
                                   headdim=16), dtype=torch.float32, device="cpu")
    with pytest.raises(TypeError, match="MambaEngine"):
        Engine(mamba, batch_size=2, max_seq_len=64)
