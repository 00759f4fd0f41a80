"""The port's serving engine on the CPU, mirroring the non-speculative cases
of tests/test_engine.py: every request's output equals the port's own
standalone ``generate()`` of its prompt, under staggered and mid-run
admission, EOS and stop ids, a wrapping window, per-request sampling
settings, an fp8 ring, the prefix cache, chunked and staged admission, the
waterline, NaN failure, cancel and the pipelined step order. One case,
``test_engine_quantized_fp8_matches_jax_engine``, is also held against the
JAX package's ``Engine`` on the same weights.

Tolerances: greedy tokens equal; prompt and generated logprobs within 1e-4
of generate()'s (fp32, the same function in other chunkings: the JAX
tests' own bound) and 1e-5 between staged and full-batch admission.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistral_inference_tpu.args import TransformerArgs as JaxArgs
from mistral_inference_tpu.model import Transformer as JaxTransformer
from mistral_inference_tpu.server.engine import Engine as JaxEngine
from mistral_inference_tpu_torch.args import TransformerArgs
from mistral_inference_tpu_torch.convert import params_from_numpy
from mistral_inference_tpu_torch.generate import generate
from mistral_inference_tpu_torch.model import Transformer
from mistral_inference_tpu_torch.server.engine import Engine
from mistral_inference_tpu_torch.utils.profiling import METRICS

PROMPTS = [
    [1, 5, 9, 13, 17, 21],
    [2, 6, 10],
    [3, 7, 11, 15, 19, 23, 27],
    [4, 8],
    [9, 9, 9, 1],
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many tiny operations: beside other test workers, thread hand-offs
    cost more than the arithmetic. One thread for the test, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_args(**overrides) -> TransformerArgs:
    """tests/test_generate.py's tiny_args."""
    kw = dict(dim=128, n_layers=2, head_dim=32, hidden_dim=256, n_heads=4, n_kv_heads=2,
              norm_eps=1e-5, vocab_size=512, max_batch_size=4, rope_theta=10000.0)
    kw.update(overrides)
    return TransformerArgs(**kw)


def tiny(seed, **overrides) -> Transformer:
    return Transformer.random(tiny_args(**overrides), dtype=torch.float32, seed=seed,
                              device="cpu")


def reference(model, prompts, max_tokens, **kw):
    return [generate([p], model, max_tokens=max_tokens, temperature=0.0, **kw)[0][0]
            for p in prompts]


def counter(name):
    return METRICS.counters.get(name, 0.0)


def test_engine_matches_generate():
    model = tiny(42)
    ref = reference(model, PROMPTS[:3], 6)
    eng = Engine(model, batch_size=3, max_seq_len=64)
    ids = [eng.submit(p, max_tokens=6) for p in PROMPTS[:3]]
    results = eng.run_to_completion()
    assert [results[i] for i in ids] == ref


def test_engine_staggered_admission():
    """More requests than slots: later ones take recycled slots whose rings
    hold stale bytes."""
    model = tiny(7)
    ref = reference(model, PROMPTS, 5)
    eng = Engine(model, batch_size=2, max_seq_len=64, decode_block=4)
    ids = [eng.submit(p, max_tokens=5) for p in PROMPTS]
    results = eng.run_to_completion()
    assert [results[i] for i in ids] == ref


def test_engine_mid_run_submit():
    model = tiny(3)
    ref = reference(model, PROMPTS[:2], 6)
    eng = Engine(model, batch_size=2, max_seq_len=64, decode_block=2)
    id0 = eng.submit(PROMPTS[0], max_tokens=6)
    eng.step()
    id1 = eng.submit(PROMPTS[1], max_tokens=6)
    results = eng.run_to_completion()
    assert [results[id0], results[id1]] == ref


def test_engine_eos():
    model = tiny(42)
    g = reference(model, [PROMPTS[0]], 8)[0]
    eng = Engine(model, batch_size=1, max_seq_len=64, eos_id=g[3])
    rid = eng.submit(PROMPTS[0], max_tokens=8)
    assert eng.run_to_completion()[rid] == g[:3]  # stops at, and drops, EOS


def test_engine_sliding_window():
    model = tiny(11, sliding_window=4)
    ref = reference(model, PROMPTS[:4], 5)
    eng = Engine(model, batch_size=2, max_seq_len=64)
    ids = [eng.submit(p, max_tokens=5) for p in PROMPTS[:4]]
    results = eng.run_to_completion()
    assert [results[i] for i in ids] == ref


def test_engine_per_request_temperature():
    """A greedy row batched with a sampled row still equals greedy generate()."""
    model = tiny(42)
    ref = reference(model, [PROMPTS[0]], 6)[0]
    eng = Engine(model, batch_size=2, max_seq_len=64)
    greedy = eng.submit(PROMPTS[0], max_tokens=6, temperature=0.0)
    sampled = eng.submit(PROMPTS[1], max_tokens=6, temperature=0.9)
    results = eng.run_to_completion()
    assert results[greedy] == ref
    assert len(results[sampled]) == 6 and all(0 <= t < 512 for t in results[sampled])


def test_engine_per_request_top_p_and_stop_ids():
    """top_p -> 0 keeps the argmax alone: a sampled request with a tiny
    nucleus reproduces greedy decoding. stop_ids end a request like EOS."""
    model = tiny(42)
    ref = reference(model, [PROMPTS[0]], 8)[0]
    eng = Engine(model, batch_size=2, max_seq_len=64)
    tiny_p = eng.submit(PROMPTS[0], max_tokens=8, temperature=0.9, top_p=1e-6)
    stop = eng.submit(PROMPTS[0], max_tokens=8, stop_ids=[ref[3]])
    results = eng.run_to_completion()
    assert results[tiny_p] == ref
    assert results[stop] == ref[:3]


def _jax_pair(seed, **overrides):
    """A tiny model in both packages with the same int8 weights."""
    jargs = JaxArgs(**{**dataclasses.asdict(tiny_args()), **overrides})
    jmodel = JaxTransformer.random(jargs, dtype=jnp.float32, seed=seed).quantize("int8", group=32)
    args = TransformerArgs.from_dict(dataclasses.asdict(jmodel.args))
    params = params_from_numpy(jax.tree.map(np.asarray, jmodel.params), device="cpu")
    return jmodel, Transformer(args, params, torch.float32, device="cpu")


def test_engine_quantized_fp8_matches_jax_engine():
    """Serving the production configuration (int8 weights, an fp8 ring):
    the port's engine gives the JAX package's engine's tokens and the port's
    own generate()'s, staggered over two slots."""
    jmodel, model = _jax_pair(42, kv_quant="fp8")
    assert model.alloc_cache(1, 8).k.dtype == torch.float8_e4m3fn
    ref = reference(model, PROMPTS[:3], 5)
    jeng = JaxEngine(jmodel, batch_size=2, max_seq_len=64, temperature=0.0)
    jids = [jeng.submit(p, max_tokens=5) for p in PROMPTS[:3]]
    jres = jeng.run_to_completion()
    eng = Engine(model, batch_size=2, max_seq_len=64)
    ids = [eng.submit(p, max_tokens=5) for p in PROMPTS[:3]]
    results = eng.run_to_completion()
    assert [results[i] for i in ids] == [jres[i] for i in jids] == ref


def test_engine_chunked_admission_long_prompt():
    """A prompt longer than admit_chunk is admitted in chunks: tokens and
    prompt and generated logprobs equal standalone generate()'s."""
    model = tiny(21)
    long_prompt = [1 + (i * 7) % 200 for i in range(50)]
    gen_ref, lp_ref = generate([long_prompt], model, max_tokens=5, temperature=0.0)
    eng = Engine(model, batch_size=2, max_seq_len=128, admit_chunk=16)
    rid = eng.submit(long_prompt, max_tokens=5, want_logprobs=True)
    assert eng.run_to_completion()[rid] == gen_ref[0]
    req = eng._request(rid)
    assert len(req.prompt_logprobs) == len(long_prompt) - 1
    np.testing.assert_allclose(req.prompt_logprobs, lp_ref[0][:49], atol=1e-4, rtol=0)
    np.testing.assert_allclose(req.gen_logprobs, lp_ref[0][49:], atol=1e-4, rtol=0)


def test_engine_adaptive_block_and_metrics():
    model = tiny(5)
    eng = Engine(model, batch_size=2, max_seq_len=64, decode_block=8)
    eng.submit(PROMPTS[0], max_tokens=3)
    eng._admit()
    assert eng._block_size() == 4  # the smallest power of two covering 3
    eng.submit(PROMPTS[1], max_tokens=30)
    assert len(eng.run_to_completion()) == 2
    for name in ("ttft_s", "request_latency_s", "admission_prefill_s"):
        assert METRICS.samples[name]
    assert METRICS.percentile("ttft_s", 0.99) >= METRICS.percentile("ttft_s", 0.5) > 0
    assert '"p99"' in METRICS.dump()


@pytest.mark.parametrize("kv_quant", ["bf16", "fp8"])
def test_engine_prefix_cache_exact_and_hits(kv_quant):
    """Requests sharing a long prefix reuse a resident row's ring bytes
    (prefix_hits counts them), with outputs equal to standalone generate()."""
    model = tiny(42 if kv_quant == "bf16" else 9, kv_quant=kv_quant)
    sys_p = [(37 * k + 5) % 512 for k in range(32)]
    prompts = [sys_p + [1, 2, 3], sys_p + [7, 8], sys_p + [9, 10, 11, 12]]
    ref = reference(model, prompts, 6)
    eng = Engine(model, batch_size=2, max_seq_len=96)
    h0, t0 = counter("prefix_hits"), counter("prefix_tokens_reused")
    for p, expect in zip(prompts, ref):  # one by one: each sources the one before
        rid = eng.submit(p, max_tokens=6)
        eng.run_to_completion()
        assert eng._result(rid) == expect
    assert counter("prefix_hits") >= h0 + 2
    assert counter("prefix_tokens_reused") >= t0 + 2 * 31


def test_engine_prefix_skipped_for_logprob_requests():
    model = tiny(3)
    sys_p = [(5 * k + 2) % 512 for k in range(24)]
    eng = Engine(model, batch_size=2, max_seq_len=96)
    eng.submit(sys_p + [1, 2], max_tokens=4)
    eng.run_to_completion()
    h0 = counter("prefix_hits")
    rid = eng.submit(sys_p + [3, 4], max_tokens=4, want_logprobs=True)
    eng.run_to_completion()
    assert counter("prefix_hits") == h0
    assert len(eng._request(rid).prompt_logprobs) == 25


def test_engine_prefix_same_wave_sources():
    """Both slots replaced in one wave: a destination may source a same-wave
    row's old ring bytes, which are read before they are overwritten."""
    model = tiny(6)
    sys_p = [(3 * k + 7) % 512 for k in range(24)]
    wave1 = [sys_p + [1], sys_p + [2]]
    wave2 = [sys_p + [3, 4], sys_p + [5, 6]]
    ref = reference(model, wave1 + wave2, 5)
    eng = Engine(model, batch_size=2, max_seq_len=96)
    ids1 = [eng.submit(p, max_tokens=5) for p in wave1]
    res1 = eng.run_to_completion()
    h0 = counter("prefix_hits")
    ids2 = [eng.submit(p, max_tokens=5) for p in wave2]
    res2 = eng.run_to_completion()
    results = {**res1, **res2}
    assert [results[i] for i in ids1 + ids2] == ref
    assert counter("prefix_hits") >= h0 + 1


def test_engine_nan_failure_detection():
    """A row whose logits go NaN fails its request loudly and frees the
    slot; the healthy row goes on."""
    model = tiny(42)
    ref = reference(model, [PROMPTS[1]], 6)[0]
    eng = Engine(model, batch_size=2, max_seq_len=64)
    bad = eng.submit(PROMPTS[0], max_tokens=6)
    ok = eng.submit(PROMPTS[1], max_tokens=6)
    eng._admit()
    carry = eng.carry.clone()  # an inference tensor: change a copy
    carry[0] = float("nan")  # a numerical fault in slot 0
    eng.carry = carry
    n0 = counter("numerical_failures")
    results = eng.run_to_completion()
    assert "NaN" in eng._request(bad).error
    assert results[ok] == ref
    assert counter("numerical_failures") >= n0 + 1


def test_engine_nan_row_among_sampled_rows():
    """A NaN row in a batch that samples does not stop the sampler."""
    model = tiny(42)
    eng = Engine(model, batch_size=2, max_seq_len=64)
    bad = eng.submit(PROMPTS[0], max_tokens=6, temperature=0.8)
    ok = eng.submit(PROMPTS[1], max_tokens=6, temperature=0.8)
    eng._admit()
    carry = eng.carry.clone()
    carry[0] = float("nan")
    eng.carry = carry
    results = eng.run_to_completion()
    assert eng._request(bad).error and len(results[ok]) == 6


def test_engine_cancel():
    model = tiny(42)
    eng = Engine(model, batch_size=1, max_seq_len=64, decode_block=2)
    rid = eng.submit(PROMPTS[0], max_tokens=30)
    queued = eng.submit(PROMPTS[1], max_tokens=30)
    eng.step()
    assert eng.cancel(queued)  # still queued
    assert eng.cancel(rid)  # live
    assert not eng.cancel(rid) and not eng.has_work


def test_engine_admission_waterline():
    """With a waterline of 2, one free slot does not start a sweep while rows
    run and two requests wait; outputs are unaffected by the deferral."""
    model = tiny(11)
    ref = reference(model, PROMPTS, 5)
    eng = Engine(model, batch_size=3, max_seq_len=64, decode_block=2, admit_waterline=2)
    ids = [eng.submit(p, max_tokens=5) for p in PROMPTS]
    results = eng.run_to_completion()
    assert [results[i] for i in ids] == ref
    eng2 = Engine(model, batch_size=3, max_seq_len=64, decode_block=2, admit_waterline=2)
    for p in PROMPTS[:3]:
        eng2.submit(p, max_tokens=5)
    eng2.step()  # the first wave
    eng2.slots[0].done = True
    for p in PROMPTS[3:]:
        eng2.submit(p, max_tokens=5)
    eng2._admit()
    assert len(eng2.queue) == 2  # one free slot < min(2 queued, waterline 2)
    eng2.slots[1].done = True
    eng2._admit()
    assert not eng2.queue


def test_engine_staged_admission_matches_direct():
    """Trickle admissions through the staging cache (cache.adopt_rows) equal
    full-batch sweeps: the same tokens and prompt logprobs, with staged
    sweeps taken; and a staged row's prompt logprobs equal generate()'s."""
    model = tiny(19)
    ref = reference(model, PROMPTS, 5)
    s0 = counter("staged_admissions")
    out = {}
    for staging in (1, 0):
        eng = Engine(model, batch_size=2, max_seq_len=64, decode_block=2,
                     staging_batch=staging, prefix_cache=False)
        ids = [eng.submit(p, max_tokens=5, want_logprobs=True) for p in PROMPTS]
        res = eng.run_to_completion()
        out[staging] = [res[i] for i in ids]
    assert counter("staged_admissions") >= s0 + 1
    assert out[1] == out[0] == ref
    gen_ref, lp_ref = generate([PROMPTS[2]], model, max_tokens=4, temperature=0.0)
    eng = Engine(model, batch_size=2, max_seq_len=64, decode_block=2, staging_batch=1,
                 prefix_cache=False)
    eng.submit(PROMPTS[0], max_tokens=8)
    eng.step()
    rid = eng.submit(PROMPTS[2], max_tokens=4, want_logprobs=True)
    s1 = counter("staged_admissions")
    assert eng.run_to_completion()[rid] == gen_ref[0]
    assert counter("staged_admissions") == s1 + 1
    np.testing.assert_allclose(eng._request(rid).prompt_logprobs, lp_ref[0][:6], atol=1e-5,
                               rtol=0)


def test_engine_pipeline_no_ring_overshoot():
    """The in-block budgets stop a finished row's kv_len at exactly prompt +
    max_tokens although blocks run past its end."""
    model = tiny(11)
    eng = Engine(model, batch_size=2, max_seq_len=64, decode_block=8)
    ids = [eng.submit(p, max_tokens=11) for p in PROMPTS[:2]]  # not a multiple of 8
    results = eng.run_to_completion()
    for i, (rid, p) in enumerate(zip(ids, PROMPTS[:2])):
        assert len(results[rid]) == 11
        assert int(eng.cache.kv_len[i]) == len(p) + 11


def test_engine_pipeline_matches_serial():
    model = tiny(13)
    outs = []
    for pipeline in (True, False):
        eng = Engine(model, batch_size=2, max_seq_len=64, decode_block=4, pipeline=pipeline)
        ids = [eng.submit(p, max_tokens=5) for p in PROMPTS]
        res = eng.run_to_completion()
        outs.append([res[i] for i in ids])
    assert outs[0] == outs[1] == reference(model, PROMPTS, 5)


def test_engine_pipeline_prefix_cache_survives_waves():
    """A second-wave request sharing a first-wave prompt's prefix hits the
    prefix cache under pipelining: finished rings stay unwrapped."""
    model = tiny(17, sliding_window=48)
    eng = Engine(model, batch_size=2, max_seq_len=48, decode_block=4, prefix_min=8,
                 staging_batch=0)
    base = list(range(1, 21))
    ref = reference(model, [base, base + [30]], 4)
    h0 = counter("prefix_hits")
    i1 = eng.submit(base, max_tokens=4)
    r1 = eng.run_to_completion()
    i2 = eng.submit(base + [30], max_tokens=4)
    r2 = eng.run_to_completion()
    assert [r1[i1], r2[i2]] == ref
    assert counter("prefix_hits") > h0


def test_engine_pipeline_stale_block_never_leaks():
    """Staggered lengths force slots to be reused while a block for their
    old request is in flight; every request still equals generate()."""
    model = tiny(23)
    lens = [3, 9, 5, 7, 4]
    refs = [generate([p], model, max_tokens=n, temperature=0.0)[0][0]
            for p, n in zip(PROMPTS, lens)]
    eng = Engine(model, batch_size=2, max_seq_len=64, decode_block=4)
    ids = [eng.submit(p, max_tokens=n) for p, n in zip(PROMPTS, lens)]
    results = eng.run_to_completion()
    assert [results[i] for i in ids] == refs


def test_engine_pipeline_randomized_stress():
    """Random prompts and lengths (under a block to several), an EOS id
    that fires at unpredictable steps, three waves of slot reuse."""
    rng = np.random.default_rng(123)
    model = tiny(31)
    prompts = [rng.integers(1, 512, int(rng.integers(2, 12))).tolist() for _ in range(9)]
    lens = [int(rng.integers(1, 13)) for _ in prompts]
    eos = 7
    refs = [generate([p], model, max_tokens=n, temperature=0.0, eos_id=eos)[0][0]
            for p, n in zip(prompts, lens)]
    eng = Engine(model, batch_size=3, max_seq_len=64, decode_block=4, eos_id=eos)
    ids = [eng.submit(p, max_tokens=n) for p, n in zip(prompts, lens)]
    results = eng.run_to_completion()
    assert [results[i] for i in ids] == refs


def test_engine_refuses_what_is_not_ported():
    """Speculative serving, image requests and a Mamba model wait for a
    later slice: each raises, naming the roadmap item."""
    model = tiny(1)
    with pytest.raises(NotImplementedError, match="Queue 1 item 4b"):
        Engine(model, batch_size=2, max_seq_len=64, draft_model="lookup")
    eng = Engine(model, batch_size=2, max_seq_len=64)
    image = np.zeros((3, 16, 16), np.float32)
    with pytest.raises(NotImplementedError, match="Queue 1 item 4b"):
        eng.submit(PROMPTS[0], max_tokens=2, images=[image])
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit(PROMPTS[0], max_tokens=100)


def test_sample_takes_per_row_temperature_and_top_p():
    """A (B,) temperature: rows at <= 0 take the argmax, the others sample
    with their own nucleus (p -> 0 keeps the argmax alone, so all rows here
    give it); the float 0 is the argmax alone."""
    from mistral_inference_tpu_torch.generate import sample

    logits = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 512)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    temps = torch.tensor([0.0, 0.7, -1.0, 1.3])
    top_ps = torch.tensor([0.9, 1e-6, 0.5, 1e-6])
    out = sample(logits, temps, top_ps, gen)
    assert torch.equal(out, logits.argmax(-1))
    assert torch.equal(sample(logits, 0.0, 0.8, gen), logits.argmax(-1))
    wide = sample(logits, torch.full((4,), 5.0), torch.full((4,), 0.99), gen)
    assert wide.shape == (4,) and not torch.equal(wide, logits.argmax(-1))


def test_profiling_trace_and_step_timer(tmp_path):
    """trace writes a Chrome trace of the block (host activity alone for
    device="cpu"); StepTimer splits prefill and decode time."""
    from mistral_inference_tpu_torch.utils.profiling import StepTimer, trace

    with trace(tmp_path, device="cpu") as prof:
        torch.ones((64, 64)).matmul(torch.ones((64, 64)))
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert any("matmul" in ev.key for ev in prof.key_averages())
    timer = StepTimer()
    timer.start()
    timer.end_prefill()
    timer.start()
    timer.end_decode(8)
    summary = timer.summary()
    assert summary["decode_tokens"] == 8 and timer.ttft == summary["ttft_s"] >= 0
