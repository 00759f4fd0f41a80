"""The port's ``MambaEngine`` on the CPU, mirroring tests/test_mamba_engine.py:
each request's output equals the port's own standalone ``generate_mamba``
of its prompt, with reset state in recycled slots, EOS and stop ids, prompt
logprobs, int8 weights, staggered budgets, the HTTP API, and prompt-lookup
speculation (staggered, EOS mid-block, mixed temperatures). One case per
mode, ``test_mamba_engine_matches_jax_engine[plain|lookup]``, is also held
against the JAX package's ``MambaEngine`` and ``generate_mamba`` on the
same weights (its XLA route). A frozen slot keeps its state's bits through a decode block, with
an fp32 and a bf16 state.

Tolerances: greedy tokens equal; prompt logprobs within 1e-4 of
generate_mamba's (fp32; the SSD's chunk is the only difference) and of the
JAX engine's.
"""

import json
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistral_inference_tpu.args import MambaArgs as JaxMambaArgs
from mistral_inference_tpu.generate import generate_mamba as jax_generate_mamba
from mistral_inference_tpu.model import Mamba as JaxMamba
from mistral_inference_tpu.models import mamba as jmm
from mistral_inference_tpu.server.mamba_engine import MambaEngine as JaxMambaEngine
from mistral_inference_tpu_torch.args import MambaArgs
from mistral_inference_tpu_torch.convert import mamba_params_from_numpy
from mistral_inference_tpu_torch.generate import generate_mamba
from mistral_inference_tpu_torch.model import Mamba, Transformer
from mistral_inference_tpu_torch.server.mamba_engine import MambaEngine, StepEvent

TINY = dict(dim=64, n_layers=2, vocab_size=256, n_groups=2, rms_norm=True,
            residual_in_fp32=True, fused_add_norm=True, pad_vocab_size_multiple=16,
            tie_embeddings=False, d_state=16, d_conv=4, expand=2, headdim=16)
PROMPTS = [
    [1, 5, 9, 13, 17, 21],
    [2, 6, 10],
    [3, 7, 11, 15, 19, 23, 27],
    [4, 8],
]
LP_TOL = dict(atol=1e-4, rtol=0)
ADMIT = 32  # admission chunk: the tests' prompts fit one


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """The JAX model (XLA route) and the port's on one set of fp32 weights."""
    jargs = JaxMambaArgs(**TINY)
    jparams = jax.jit(lambda key: jmm.init_mamba_params(key, jargs, jnp.float32))(
        jax.random.PRNGKey(42))
    jmodel = JaxMamba(jargs, jparams, jnp.float32, pallas=False)
    port = Mamba(MambaArgs(**TINY), mamba_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                                            device="cpu"),
                 torch.float32, device="cpu")
    return jmodel, port


def tiny(seed, **kw) -> Mamba:
    return Mamba.random(MambaArgs(**TINY), dtype=torch.float32, seed=seed, device="cpu", **kw)


def reference(model, prompts, max_tokens, **kw):
    return [generate_mamba([p], model, max_tokens=max_tokens, temperature=0.0, **kw)[0][0]
            for p in prompts]


def serve(model, prompts, max_tokens, **kw):
    eng = MambaEngine(model, batch_size=kw.pop("batch_size", 2), max_seq_len=64,
                      admit_chunk=ADMIT, **kw)
    lens = max_tokens if isinstance(max_tokens, list) else [max_tokens] * len(prompts)
    ids = [eng.submit(p, max_tokens=n) for p, n in zip(prompts, lens)]
    res = eng.run_to_completion()
    return [res[i] for i in ids], eng


@pytest.mark.parametrize("mode", ["plain", "lookup"])
def test_mamba_engine_matches_jax_engine(models, mode):
    """Both packages' engines on shared weights, four requests over two
    slots: equal tokens, equal to generate_mamba alone and to the JAX
    package's generate_mamba; the logprob request's prompt logprobs within
    1e-4 of JAX's."""
    jmodel, port = models
    draft = None if mode == "plain" else "lookup"
    ref = reference(port, PROMPTS, 6)
    assert jax_generate_mamba(PROMPTS, jmodel, max_tokens=6, temperature=0.0)[0] == ref
    jeng = JaxMambaEngine(jmodel, batch_size=2, max_seq_len=64, decode_block=4,
                          draft_model=draft, spec_tokens=3)
    jids = [jeng.submit(p, max_tokens=6, want_logprobs=i == 0) for i, p in enumerate(PROMPTS)]
    jr = jeng.queue[0]
    jres = jeng.run_to_completion()
    eng = MambaEngine(port, batch_size=2, max_seq_len=64, decode_block=4, admit_chunk=ADMIT,
                      draft_model=draft, spec_tokens=3)
    ids = [eng.submit(p, max_tokens=6, want_logprobs=i == 0) for i, p in enumerate(PROMPTS)]
    r = eng.queue[0]
    res = eng.run_to_completion()
    assert [res[i] for i in ids] == [jres[i] for i in jids] == ref
    np.testing.assert_allclose(r.prompt_logprobs, jr.prompt_logprobs, **LP_TOL)
    np.testing.assert_allclose(r.gen_logprobs, jr.gen_logprobs, **LP_TOL)


@pytest.mark.parametrize("draft", [None, "lookup"])
def test_mamba_engine_staggered_and_state_isolation(draft):
    """More requests than slots: a recycled slot starts from a zeroed state
    (and, for lookup, a fresh history)."""
    model = tiny(7)
    got, _ = serve(model, PROMPTS, 5, decode_block=4, draft_model=draft, spec_tokens=2)
    assert got == reference(model, PROMPTS, 5)


def test_mamba_engine_eos_stop_and_logprobs():
    model = tiny(3)
    gen, lps = generate_mamba([PROMPTS[0]], model, max_tokens=8, temperature=0.0)
    eos = gen[0][3]
    eng = MambaEngine(model, batch_size=1, max_seq_len=64, eos_id=eos, admit_chunk=ADMIT)
    rid = eng.submit(PROMPTS[0], max_tokens=8, want_logprobs=True)
    assert eng.run_to_completion()[rid] == gen[0][:3]
    req = eng._request(rid)
    np.testing.assert_allclose(req.prompt_logprobs, lps[0][:len(PROMPTS[0]) - 1], **LP_TOL)
    np.testing.assert_allclose(req.gen_logprobs, lps[0][len(PROMPTS[0]) - 1:][:3], **LP_TOL)
    # A stop id ends the request the same way; a wider admission chunk than
    # the prompt keeps the tokens.
    eng = MambaEngine(model, batch_size=2, max_seq_len=64, admit_chunk=512)
    rid = eng.submit(PROMPTS[0], max_tokens=8, stop_ids=[eos])
    assert eng.run_to_completion()[rid] == gen[0][:3]


def test_mamba_engine_quantized():
    """int8 weights: the engine's tokens equal generate_mamba's on the same
    quantized model."""
    model = tiny(42).quantize("int8", group=32)
    got, _ = serve(model, PROMPTS[:3], 5)
    assert got == reference(model, PROMPTS[:3], 5)


def test_mamba_engine_pipeline_staggered_budgets():
    """Per-row budgets in flight: staggered max_tokens force slot reuse while
    blocks are queued; every request equals isolated generation."""
    model = tiny(29)
    lens = [3, 9, 5, 7]
    refs = [generate_mamba([p], model, max_tokens=n, temperature=0.0)[0][0]
            for p, n in zip(PROMPTS, lens)]
    got, _ = serve(model, PROMPTS, lens, decode_block=4)
    assert got == refs


def test_mamba_engine_cancel():
    model = tiny(11)
    eng = MambaEngine(model, batch_size=1, max_seq_len=64, decode_block=2, admit_chunk=ADMIT)
    a = eng.submit(PROMPTS[0], max_tokens=20)
    b = eng.submit(PROMPTS[1], max_tokens=4)
    for _ in range(3):  # admission, a block queued, that block read back
        eng.step()
    ra = eng._request(a)
    assert eng.cancel(a) and not eng.cancel(12345)
    res = eng.run_to_completion()
    assert ra.done and 0 < len(ra.generated) < 20 and a not in res
    assert res[b] == reference(model, [PROMPTS[1]], 4)[0]


def test_mamba_engine_lookup_eos_mid_block():
    model = tiny(7)
    ref = reference(model, PROMPTS, 5)
    eos = ref[0][2]
    got, _ = serve(model, PROMPTS, 5, draft_model="lookup", spec_tokens=2, eos_id=eos)
    assert got == [r[:r.index(eos)] if eos in r else r for r in ref]


def test_mamba_engine_lookup_mixed_temperatures():
    """Greedy and sampled rows in one lookup batch: the greedy row keeps
    generate_mamba's tokens; the sampled row repeats for a seed, and at a
    near-zero temperature gives the greedy tokens."""
    model = tiny(9)
    ref = reference(model, PROMPTS[:2], 6)

    def run(temp, seed=0):
        eng = MambaEngine(model, batch_size=2, max_seq_len=64, draft_model="lookup",
                          spec_tokens=2, seed=seed, admit_chunk=ADMIT)
        g = eng.submit(PROMPTS[0], max_tokens=6, temperature=0.0)
        s = eng.submit(PROMPTS[1], max_tokens=6, temperature=temp)
        res = eng.run_to_completion()
        return res[g], res[s]

    a, b = run(0.9, 4), run(0.9, 4)
    assert a == b and a[0] == ref[0] and len(a[1]) == 6
    assert list(run(1e-4)) == ref


@pytest.mark.parametrize("ssm_dtype", [torch.float32, torch.bfloat16])
def test_mamba_engine_frozen_slot_keeps_its_bits(ssm_dtype):
    """A slot whose request has ended runs the next decode block at seqlens
    0 (dt = 0, a zeroed conv input): its conv taps and SSD state keep their
    bits, for an fp32 and a bf16 state."""
    model = tiny(5, ssm_dtype=ssm_dtype)
    eng = MambaEngine(model, batch_size=2, max_seq_len=64, decode_block=4, admit_chunk=ADMIT,
                      pipeline=False)
    eng.submit(PROMPTS[0], max_tokens=2)
    eng.submit(PROMPTS[1], max_tokens=12)
    while not eng.slots[0] or not eng.slots[0].done:
        eng.step()
    conv, ssm = eng.state.conv[:, 0].clone(), eng.state.ssm[:, 0].clone()
    live_ssm = eng.state.ssm[:, 1].clone()
    eng.step()  # a block in which slot 0 is frozen
    assert torch.equal(eng.state.conv[:, 0], conv) and torch.equal(eng.state.ssm[:, 0], ssm)
    assert not torch.equal(eng.state.ssm[:, 1], live_ssm)


def test_mamba_engine_http_server():
    """The HTTP API serves a MambaEngine unchanged."""
    from mistral_inference_tpu_torch.server.api import Server, _make_handler

    class DummyTok:
        bos_id, eos_id = 1, 2

        def encode(self, text, bos=True, eos=False):
            ids = [3 + (ord(c) % 100) for c in text][:16] or [5]
            return ([self.bos_id] if bos else []) + ids

        def decode(self, ids):
            return " ".join(map(str, ids))

    model = tiny(42)
    srv = Server(MambaEngine(model, batch_size=2, max_seq_len=64, admit_chunk=ADMIT), DummyTok())
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(srv))
    srv.start()
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    req = urllib.request.Request(url + "/v1/completions",
                                 data=json.dumps({"prompt": "hello", "max_tokens": 5}).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()
    want = reference(model, [DummyTok().encode("hello")], 5)[0]
    assert out["choices"][0]["tokens"] == want


def test_mamba_engine_refusals():
    """A Transformer draft (a recurrent target has no rewind for it), an
    image request, a prompt past max_seq_len, a Transformer to serve."""
    model = tiny(1)
    with pytest.raises(ValueError, match="draft-free"):
        MambaEngine(model, batch_size=2, max_seq_len=64, draft_model=model)
    eng = MambaEngine(model, batch_size=2, max_seq_len=64)
    with pytest.raises(ValueError, match="vision encoder"):
        eng.submit(PROMPTS[0], max_tokens=2, images=[np.zeros((3, 16, 16), np.float32)])
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit(PROMPTS[0], max_tokens=100)
    assert StepEvent(0, 1, False).logprob == 0.0
    from mistral_inference_tpu_torch.args import TransformerArgs

    t = Transformer.random(TransformerArgs(dim=64, n_layers=1, head_dim=16, hidden_dim=128,
                                           n_heads=4, n_kv_heads=2, norm_eps=1e-5,
                                           vocab_size=256), dtype=torch.float32, device="cpu")
    with pytest.raises(TypeError, match="Mamba"):
        MambaEngine(t, batch_size=2, max_seq_len=64)
