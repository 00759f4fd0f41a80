"""The port's serving engine on the CPU, mirroring the non-speculative cases
of tests/test_engine.py (tests/test_torch_engine_spec.py holds the
speculative ones): every request's output equals the port's own
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
from mistral_inference_tpu_torch.args import MoeArgs, TransformerArgs
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


def _prefill_rows(monkeypatch, model) -> list:
    """The rows of each prefill forward (T > 1) ``model`` runs from now on."""
    rows, forward = [], model.forward

    def recording(tokens, *a, **kw):
        if tokens.shape[1] > 1:
            rows.append(tokens.shape[0])
        return forward(tokens, *a, **kw)

    monkeypatch.setattr(model, "forward", recording)
    return rows


def quantized(seed, kind="int8", **overrides) -> Transformer:
    """An int8 model at ``tiny_args`` or, with ``kind`` "wide" or "moe", at
    widths whose products all take K5 at 512 rows and more (the "moe" one's
    experts through the ragged route, "dispatch"); "plain" keeps fp32
    weights."""
    if kind in ("wide", "moe"):
        overrides = dict(dim=256, head_dim=64, hidden_dim=512, **overrides)
    if kind == "moe":
        overrides.update(moe=MoeArgs(num_experts=4, num_experts_per_tok=2), moe_impl="dispatch")
    return Transformer.random(tiny_args(**overrides), dtype=torch.float32, seed=seed,
                              device="cpu", quant=None if kind == "plain" else "int8")


# A staged sweep of three prompts spanning 3, 2 and 1 chunks: the model, the
# chunk and the prompt lengths.
STILL_PREFILLING = {"dense_16": ("int8", 16, (10, 40, 20)),
                    "moe_512": ("moe", 512, (300, 1100, 700))}


@pytest.mark.parametrize("case", list(STILL_PREFILLING))
def test_staged_chunks_carry_only_the_rows_still_prefilling(monkeypatch, case):
    """Three prompts spanning 3, 2 and 1 chunks, staged together in a
    staging cache of 4 rows: the chunks run 3, 2 and 1 rows, not 4 each.
    The plain products whose kernel cuBLAS picks by the row count keep the
    staging width: the vocab head's (each chunk's last positions and the
    prompt logprobs' slices) run at 4 rows, and an MoE router's at 4 x the
    chunk. Every quantized product takes one route (K3 at chunks of 16, K5
    at 512)."""
    from mistral_inference_tpu_torch.models import transformer as tf
    from mistral_inference_tpu_torch.ops import linear as lin

    kind, width, lens = STILL_PREFILLING[case]
    model = quantized(29, kind)
    eng = Engine(model, batch_size=8, max_seq_len=1152, admit_chunk=width, staging_batch=4,
                 prefix_cache=False)
    for n in lens:
        eng.submit([(5 * i + n) % 500 + 1 for i in range(n)], max_tokens=2,
                   want_logprobs=n == lens[0])
    rows = _prefill_rows(monkeypatch, model)
    head_rows, router_rows, routes = [], [], set()
    head, route, lin_route = model.head, tf._route, lin._route

    def recording_head(h, *a, **kw):
        head_rows.append(h.shape[0])
        return head(h, *a, **kw)

    def recording_router(x, gate, top_k, padded=None):
        router_rows.append(max(x.shape[0], padded or 0))
        return route(x, gate, top_k, padded)

    def recording_route(n, N, K):
        routes.add(lin_route(n, N, K))
        return lin_route(n, N, K)

    monkeypatch.setattr(model, "head", recording_head)
    monkeypatch.setattr(tf, "_route", recording_router)
    monkeypatch.setattr(lin, "_route", recording_route)
    eng._admit()
    assert rows == [3, 2, 1]
    slices = -(-width // 64)  # the prompt logprobs' head slices a chunk
    assert len(head_rows) == 3 * (1 + slices) and set(head_rows) == {4}
    assert router_rows == ([4 * width] * 3 * model.args.n_layers if kind == "moe" else [])
    assert routes == {"K3" if width == 16 else "K5"}


# Engines and models that decide whether a staged chunk may carry only the
# rows still prefilling: the engine's arguments, the model (``quantized``)
# and the verdict.
COMPACTS = {
    "b64": (dict(batch_size=64), "wide", True),  # 8 staging rows x 512: K5 at every k
    "lookup_b64": (dict(batch_size=64, draft_model="lookup"), "wide", False),  # 17: dequant at 16
    "b128": (dict(batch_size=128), "wide", False),  # 16 x 512 = 8192 rows: dequant at k = 16
    "chunk_256": (dict(batch_size=64, admit_chunk=256), "wide", False),  # K3 at k = 1, then K5
    "chunk_384": (dict(batch_size=64, admit_chunk=384), "wide", False),  # K5 at even k alone
    "chunk_16": (dict(batch_size=64, admit_chunk=16), "int8", True),  # K3 at every k
    "narrow_512": (dict(batch_size=64), "int8", False),  # K % 256 != 0: dequant (cuBLAS)
    "plain_weights": (dict(batch_size=64), "plain", False),  # cuBLAS products
    "moe_512": (dict(batch_size=64), "moe", True),  # the experts through K5's ragged route
    "moe_16": (dict(batch_size=64, admit_chunk=16), "moe", False),  # capacities over k x 16 rows
}


@pytest.mark.parametrize("case", list(COMPACTS))
def test_staged_chunks_compact_only_where_every_row_count_takes_one_route(case):
    """A staged chunk of k rows runs k x admit_chunk rows through each
    product, and ``ops.linear`` routes a product by its rows (cuBLAS, where
    it routes there or the weight is plain, picks its kernel by them too).
    The engine compacts only where every k from 1 to the staging width gives
    every product one hand-written kernel (for MoE experts, K5's ragged
    route above ``MOE_RAGGED_ROWS`` rows); elsewhere each chunk keeps the
    staging width, so a staged row's bits never depend on how many rows are
    beside it."""
    from mistral_inference_tpu_torch.ops.linear import _route
    from mistral_inference_tpu_torch.server.engine import _compacts

    kw, kind, compacts = COMPACTS[case]
    eng = Engine(quantized(3, kind), max_seq_len=64, prefix_cache=False, **kw)
    width, layer = eng.admit_chunk, eng.model.params["layers"][0]
    assert _compacts(eng.model, eng._staging_B, width) is compacts
    if kind != "plain":
        w = layer["wqkv"]
        routes = {_route(k * width, w["scale"].shape[-1], w["q"].shape[-2])
                  for k in range(1, eng._staging_B + 1)}
        assert (len(routes) == 1 and "dequant" not in routes) is (compacts or case == "moe_16")


# A 40-token request (3 chunks of 16) and the prompt lengths beside it.
BESIDE = {"alone": [], "one_shorter": [9], "one_longer": [60],
          "seven": [5, 60, 12, 47, 23, 52, 33], "full_sweep": [9, 60]}


@pytest.mark.parametrize("beside", list(BESIDE))
def test_staged_row_does_not_depend_on_the_rows_beside_it(monkeypatch, beside):
    """A staged request's tokens and prompt logprobs (int8 weights, an fp8
    ring) equal its own generate()'s whether it is staged alone, with one
    shorter or longer prompt, or with seven of both kinds, each chunk
    carrying the rows still prefilling; and through a full sweep, which
    carries all 16 rows in every chunk. The requests beside it equal their
    own generate()'s too."""
    args = tiny_args(kv_quant="fp8")
    model = Transformer.random(args, dtype=torch.float32, seed=37, device="cpu", quant="int8")
    rng = np.random.default_rng(5)
    target = rng.integers(1, 512, 40).tolist()
    others = [rng.integers(1, 512, n).tolist() for n in BESIDE[beside]]
    gen_ref, lp_ref = generate([target], model, max_tokens=5, temperature=0.0, chunk_size=16)
    staging = 0 if beside == "full_sweep" else 8
    eng = Engine(model, batch_size=16, max_seq_len=80, admit_chunk=16, decode_block=4,
                 staging_batch=staging, prefix_cache=False)
    ids = [eng.submit(p, max_tokens=3) for p in others[:len(others) // 2]]
    rid = eng.submit(target, max_tokens=5, want_logprobs=True)
    ids += [eng.submit(p, max_tokens=3) for p in others[len(others) // 2:]]
    rows = _prefill_rows(monkeypatch, model)
    s0 = counter("staged_admissions")
    results = eng.run_to_completion()
    lens = [len(target)] + BESIDE[beside]
    starts = range(0, max(lens), 16)
    if staging:
        assert counter("staged_admissions") == s0 + 1
        assert rows == [sum(n > s for n in lens) for s in starts]
    else:
        assert rows == [16] * len(starts)
    assert results[rid] == gen_ref[0]
    assert [results[i] for i in ids] == reference(model, others, 3, chunk_size=16)
    np.testing.assert_allclose(eng._request(rid).prompt_logprobs, lp_ref[0][:39], atol=1e-5,
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
    """The refusals that remain now that every serving mode is ported: a
    Transformer draft for MambaEngine (a recurrent target has no rewind for
    it), an image request to a speculative engine or to a text-only model,
    a prompt past max_seq_len, and a Mamba given to the Transformer engine
    (MambaEngine serves it)."""
    from mistral_inference_tpu_torch.args import MambaArgs
    from mistral_inference_tpu_torch.model import Mamba
    from mistral_inference_tpu_torch.server.mamba_engine import MambaEngine

    model = tiny(1)
    mamba = Mamba.random(MambaArgs(dim=64, n_layers=1, vocab_size=256, n_groups=2, rms_norm=True,
                                   residual_in_fp32=True, fused_add_norm=True,
                                   pad_vocab_size_multiple=16, tie_embeddings=False,
                                   d_state=16, headdim=16), dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="draft-free"):
        MambaEngine(mamba, batch_size=2, max_seq_len=64, draft_model=model)
    image = np.zeros((3, 16, 16), np.float32)
    vision = Engine(model, batch_size=2, max_seq_len=64, draft_model="lookup")
    vision.model.args = dataclasses.replace(model.args, vision_encoder=object())
    try:
        with pytest.raises(ValueError, match="text-only"):
            vision.submit(PROMPTS[0], max_tokens=2, images=[image])
    finally:
        vision.model.args = dataclasses.replace(model.args, vision_encoder=None)
    eng = Engine(model, batch_size=2, max_seq_len=64)
    with pytest.raises(ValueError, match="vision encoder"):
        eng.submit(PROMPTS[0], max_tokens=2, images=[image])
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit(PROMPTS[0], max_tokens=100)
    with pytest.raises(TypeError, match="MambaEngine"):
        Engine(mamba, batch_size=2, max_seq_len=64)


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
    device="cpu"), with the tracing switch on inside it and restored after.
    (The step timer that this test also held went: the engine's spans time
    a serving step.)"""
    from mistral_inference_tpu_torch.utils import profiling

    with profiling.trace(tmp_path, device="cpu") as prof:
        assert profiling.TRACING
        torch.ones((64, 64)).matmul(torch.ones((64, 64)))
    assert not profiling.TRACING
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert any("matmul" in ev.key for ev in prof.key_averages())
