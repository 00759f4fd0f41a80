"""The port's speculative decoding against the JAX package's, on shared
weights (``convert.params_from_numpy``) in fp32 on the CPU, mirroring
tests/test_speculative.py: the pieces, the verify forwards and the sampled
generators. The greedy generators are held end to end in
tests/test_torch_speculative_generate.py.

Tolerances: integer results (proposals, history, accept counts, tokens)
equal; probabilities 1e-6; ``forward`` prelogits 2e-3 (an int8 ring amplifies
fp32 summation-order differences through the rounding of K/V, as
tests/test_quant.py allows), its chunk K/V 1e-5, ring scales 1e-5 with at
most one byte in a thousand off by one step (the exact write is held in
test_torch_cache.py and test_torch_fused_verify.py on shared inputs). Sampled
transcripts are fixed per seed inside the port; its random stream is not JAX's, so they are not
compared token for token with JAX's: the rejection sampler is held to the
target's distribution instead (total variation 0.01 over 200,000 draws of 8
bins, sampling noise about 0.003; 0.06 over a few thousand draws of a tiny
model, as the JAX tests size it).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistral_inference_tpu import speculative as jsp
from mistral_inference_tpu.args import TransformerArgs as JaxArgs
from mistral_inference_tpu.model import Transformer as JaxTransformer
from mistral_inference_tpu.models import transformer as jtf
from mistral_inference_tpu_torch import speculative as sp
from mistral_inference_tpu_torch.args import TransformerArgs
from mistral_inference_tpu_torch.convert import params_from_numpy
from mistral_inference_tpu_torch.generate import generate, top_p_probs
from mistral_inference_tpu_torch.model import Transformer

PROMPTS = [[5, 17, 2, 91, 33], [7, 3], [100, 101, 102, 103, 104, 105, 106]]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run many tiny tensor operations; beside other test
    workers, each with a thread per core, the threads' hand-offs cost far
    more than the arithmetic. One thread for the test, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def target_args(**kw) -> JaxArgs:
    base = dict(dim=128, n_layers=3, head_dim=32, hidden_dim=256, n_heads=4, n_kv_heads=2,
                norm_eps=1e-5, vocab_size=256, rope_theta=10000.0)
    base.update(kw)
    return JaxArgs(**base)


def draft_args(**kw) -> JaxArgs:
    base = dict(dim=64, n_layers=2, head_dim=16, hidden_dim=128, n_heads=4, n_kv_heads=2,
                norm_eps=1e-5, vocab_size=256, rope_theta=10000.0)
    base.update(kw)
    return JaxArgs(**base)


def port_of(jmodel) -> Transformer:
    args = TransformerArgs.from_dict(dataclasses.asdict(jmodel.args))
    params = params_from_numpy(jax.tree.map(np.asarray, jmodel.params), device="cpu")
    return Transformer(args, params, torch.float32, device="cpu")


def jax_model(args, seed, quant=None):
    m = JaxTransformer.random(args, dtype=jnp.float32, seed=seed)
    return m.quantize(quant, group=32) if quant else m


# ---------------------------------------------------------------------------
# The pieces
# ---------------------------------------------------------------------------


def test_lookup_propose_matches_jax():
    """The most recent earlier match of the last n-gram; no match proposes t0
    repeated; proposals past the buffer's end clamp."""
    rng = np.random.default_rng(0)
    hist = rng.integers(0, 6, (5, 40)).astype(np.int32)  # a small alphabet repeats often
    hist[0, :9] = [10, 11, 30, 31, 10, 11, 40, 10, 11]
    hist[1, :9] = [1, 2, 3, 4, 5, 6, 7, 8, 9]
    hlen = np.array([9, 9, 40, 17, 3], np.int32)
    t0 = hist[np.arange(5), hlen - 1]
    for K, ngram in ((3, 2), (7, 2), (4, 3), (2, 1)):
        ref = np.asarray(jsp._lookup_propose(jnp.asarray(hist), jnp.asarray(hlen),
                                             jnp.asarray(t0), K, ngram))
        out = sp._lookup_propose(torch.from_numpy(hist).long(), torch.from_numpy(hlen).long(),
                                 torch.from_numpy(t0).long(), K, ngram).numpy()
        np.testing.assert_array_equal(out, ref)
    out = sp._lookup_propose(torch.from_numpy(hist).long(), torch.from_numpy(hlen).long(),
                             torch.from_numpy(t0).long(), 3, 2).numpy()
    assert out[0].tolist() == [40, 10, 11] and out[1].tolist() == [9, 9, 9]


def test_append_hist_matches_jax():
    """Accepted + bonus tokens land at hlen; dead rows and tokens past the
    accepted prefix do not; tokens past the buffer's end are dropped."""
    rng = np.random.default_rng(1)
    B, M, K1 = 4, 12, 5
    hist = rng.integers(1, 99, (B, M)).astype(np.int32)
    hlen = np.array([3, 9, 11, 5], np.int32)  # rows 1 and 2 run off the end
    emit = rng.integers(100, 199, (B, K1)).astype(np.int32)
    a = np.array([0, 4, 2, 3], np.int32)
    live = np.array([True, True, True, False])
    adv = np.where(live, a + 1, 0).astype(np.int32)
    jh, jl = jsp._append_hist(jnp.asarray(hist), jnp.asarray(hlen), jnp.asarray(emit),
                              jnp.asarray(a), jnp.asarray(adv), jnp.asarray(live))
    th, tl = sp._append_hist(*(torch.from_numpy(x).long() for x in (hist, hlen, emit, a, adv)),
                             torch.from_numpy(live))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert th[3].tolist() == hist[3].tolist() and tl[3] == 5  # the dead row froze


def test_residual_dist_matches_jax():
    rng = np.random.default_rng(2)
    p = rng.dirichlet(np.ones(16), (3, 4)).astype(np.float32)
    q = rng.dirichlet(np.ones(16), (3, 4)).astype(np.float32)
    q[0, 0] = p[0, 0]  # p == q: no residual mass, falls back to p
    ref = np.asarray(jsp._residual_dist(jnp.asarray(p), jnp.asarray(q)))
    out = sp._residual_dist(torch.from_numpy(p), torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)
    np.testing.assert_allclose(out[0, 0], p[0, 0], atol=1e-6)
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-5)


def test_onehot_verify_accept_greedy_matches_jax():
    rng = np.random.default_rng(3)
    B, K, V = 6, 4, 32
    vlog = rng.standard_normal((B, K + 1, V)).astype(np.float32)
    g = vlog.argmax(-1)
    drafts = rng.integers(0, V, (B, K)).astype(np.int32)
    drafts[0] = g[0, :K]  # everything accepted
    drafts[1, :2] = g[1, :2]  # a prefix of two
    drafts[2, 1:] = g[2, 1:K]  # a match after a miss does not count
    ja, je, jl, jb = jsp._onehot_verify_accept(
        jnp.asarray(vlog), jnp.asarray(drafts), None, sampled=False,
        greedy_rows=jnp.ones((B,), bool), temp_col=None, p_eff=0.8)
    ta, te, tl, tb = sp._onehot_verify_accept(
        torch.from_numpy(vlog), torch.from_numpy(drafts).long(), None, sampled=False,
        greedy_rows=torch.ones((B,), dtype=torch.bool), temp_col=torch.ones((B, 1)), p_eff=0.8)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6)
    assert ta[:3].tolist() == [4, 2, 0]


def test_onehot_verify_accept_per_row_temperatures():
    """temps mixes the rules per row: a greedy row (temps 0) keeps the argmax
    rule whatever the draws; top_ps gives each row its nucleus."""
    rng = np.random.default_rng(4)
    B, K, V = 4, 3, 16
    vlog = torch.from_numpy(rng.standard_normal((B, K + 1, V)).astype(np.float32) * 3)
    drafts = vlog.argmax(-1)[:, :K].clone()
    drafts[1, 1] = (drafts[1, 1] + 1) % V
    temps = torch.tensor([0.0, 0.0, 0.9, 0.9])
    sampled, temp_col, greedy_rows = sp._row_rules(B, 0.0, temps, torch.device("cpu"))
    assert sampled and greedy_rows.tolist() == [True, True, False, False]
    gen = torch.Generator().manual_seed(0)
    a, emit, lp, bonus = sp._onehot_verify_accept(
        vlog, drafts, gen, sampled=sampled, greedy_rows=greedy_rows, temp_col=temp_col,
        p_eff=torch.tensor([0.8, 0.8, 0.5, 1.0]))
    assert a[:2].tolist() == [3, 1]
    assert bonus[1, 0] == vlog[1, 1].argmax() and bonus[0, 0] == vlog[0, 3].argmax()
    assert torch.isfinite(lp).all() and emit.shape == (B, K + 1)


@pytest.mark.parametrize("kv_quant", ["bf16", "int8"])
def test_verify_forwards_match_jax(kv_quant):
    """``write_cache=False`` leaves the ring and kv_len alone and returns the
    chunk's K/V; ``"spec"`` writes all T candidates and leaves kv_len; both
    give JAX's prelogits, and on a dead row neither writes."""
    jmodel = jax_model(target_args(kv_quant=kv_quant), 0)
    model = port_of(jmodel)
    rng = np.random.default_rng(0)
    B, P, T = 3, 9, 4
    prompt = rng.integers(1, 256, (B, P)).astype(np.int32)
    plens = np.array([9, 4, 6], np.int32)
    chunk = rng.integers(1, 256, (B, T)).astype(np.int32)
    seqlens = np.array([T, T, 0], np.int32)  # a dead row

    def jax_after_prefill():
        c = jmodel.alloc_cache(B, 64)
        _, c = jtf.forward(jmodel.params, jmodel.rope, jnp.asarray(prompt), jnp.asarray(plens),
                           c, jmodel.cfg, attend_cache=False)
        return c

    def port_after_prefill():
        c = model.alloc_cache(B, 64)
        model.forward(torch.from_numpy(prompt), torch.from_numpy(plens), c, attend_cache=False)
        return c

    live = seqlens > 0
    # no-write
    jc = jax_after_prefill()
    jlog, (jk, jv) = jtf.forward(jmodel.params, jmodel.rope, jnp.asarray(chunk),
                                 jnp.asarray(seqlens), jc, jmodel.cfg, attend_cache=True,
                                 write_cache=False)
    tc = port_after_prefill()
    ring = tc.k.clone()
    tlog, (tk_, tv_) = model.forward(torch.from_numpy(chunk), torch.from_numpy(seqlens), tc,
                                     write_cache=False)
    np.testing.assert_allclose(tlog.numpy()[live], np.asarray(jlog)[live], atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(tk_.numpy()[:, live], np.asarray(jk)[:, live], atol=1e-5)
    np.testing.assert_allclose(tv_.numpy()[:, live], np.asarray(jv)[:, live], atol=1e-5)
    assert tuple(tk_.shape) == (3, B, T, 2, 32)
    assert torch.equal(tc.k, ring) and tc.kv_len.tolist() == plens.tolist()
    # spec
    jc = jax_after_prefill()
    jlog2, jc2 = jtf.forward(jmodel.params, jmodel.rope, jnp.asarray(chunk),
                             jnp.asarray(seqlens), jc, jmodel.cfg, attend_cache=True,
                             write_cache="spec")
    tc = port_after_prefill()
    tlog2 = model.forward(torch.from_numpy(chunk), torch.from_numpy(seqlens), tc,
                          write_cache="spec")
    np.testing.assert_allclose(tlog2.numpy()[live], np.asarray(jlog2)[live], atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(tlog2.numpy()[live], tlog.numpy()[live], atol=2e-3, rtol=2e-3)
    assert tc.kv_len.tolist() == plens.tolist() == np.asarray(jc2.kv_len).tolist()
    if kv_quant == "int8":
        # The K/V that are quantized come from two fp32 implementations, so a
        # scale may differ in its last bits and a rare byte by one step; the
        # write itself is held exactly in test_torch_cache.py and
        # test_torch_fused_verify.py.
        np.testing.assert_allclose(tc.k_scale.numpy(), np.asarray(jc2.k_scale), rtol=1e-5)
        assert (tc.k.numpy() != np.asarray(jc2.k)).mean() < 1e-3
        assert np.abs(tc.k.numpy().astype(int) - np.asarray(jc2.k).astype(int)).max() <= 1
    else:
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc2.k), atol=1e-5)
    assert torch.equal(tc.k[:, 2], ring[:, 2]), "the dead row wrote nothing"
    assert not torch.equal(tc.k[:, 0], ring[:, 0])


def test_verify_forward_refusals():
    model = port_of(jax_model(target_args(), 0))
    c = model.alloc_cache(1, 16)
    one = torch.ones((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="T > 1"):
        model.forward(torch.ones((1, 1), dtype=torch.long), one, c, write_cache=False)
    with pytest.raises(ValueError, match="attends to the ring"):
        model.forward(torch.ones((1, 3), dtype=torch.long), one, c, attend_cache=False,
                      write_cache="spec")


# ---------------------------------------------------------------------------
# temperature > 0: rejection sampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["draft", "lookup"])
def test_sampling_fixed_by_seed_and_contract(kind):
    model = port_of(jax_model(target_args(), 0))
    dm = port_of(jax_model(draft_args(), 1)) if kind == "draft" else "lookup"
    kw = dict(max_tokens=12, temperature=0.7, spec_tokens=3, draft_model=dm)
    a = generate(PROMPTS, model, seed=11, **kw)
    b = generate(PROMPTS, model, seed=11, **kw)
    c = generate(PROMPTS, model, seed=12, **kw)
    assert a == b
    assert a[0] != c[0]  # astronomically unlikely to collide
    for p, t, l in zip(PROMPTS, *a):
        assert len(t) == 12 and len(l) == len(p) - 1 + 12
        assert all(0 <= x < 256 for x in t) and np.isfinite(l).all()


@pytest.mark.parametrize("kind", ["draft", "lookup"])
def test_sampling_near_zero_temperature_is_greedy(kind):
    model = port_of(jax_model(target_args(), 0))
    dm = port_of(jax_model(draft_args(), 1)) if kind == "draft" else "lookup"
    ref, _ = generate(PROMPTS, model, max_tokens=12, temperature=0.0)
    out, _ = generate(PROMPTS, model, max_tokens=12, temperature=1e-6, spec_tokens=3,
                      draft_model=dm)
    assert out == ref


def test_rejection_sampling_unbiased():
    """Draw d ~ q, accept with min(1, p(d) / q(d)), else draw from
    ``_residual_dist(p, q)``: the output marginal is p. 200,000 of the port's
    own draws over 8 bins (sampling noise about 0.003 in total variation)."""
    V, n = 8, 200_000
    rng = np.random.default_rng(0)
    p = torch.from_numpy(rng.dirichlet(np.ones(V)).astype(np.float32))
    q = torch.from_numpy(rng.dirichlet(np.ones(V)).astype(np.float32))
    gen = torch.Generator().manual_seed(1)
    d = sp._draw(q.expand(n, V), gen)
    u = torch.rand((n,), generator=gen)
    fallback = sp._draw(sp._residual_dist(p, q).expand(n, V), gen)
    toks = torch.where(u * q[d] < p[d], d, fallback)
    emp = np.bincount(toks.numpy(), minlength=V) / n
    assert 0.5 * np.abs(emp - p.numpy()).sum() < 0.01, (emp, p)


@pytest.mark.parametrize("kind", ["draft", "lookup"])
def test_sampling_exact_distribution_tiny_model(kind):
    """With B identical prompts the first SPECULATIVE token (stream position
    2) follows the target's own sampling distribution given the first token.
    Conditioning on the most frequent first token keeps the test exact."""
    model = port_of(jax_model(target_args(vocab_size=16, n_layers=1), 3))
    dm = port_of(jax_model(draft_args(vocab_size=16, n_layers=1), 4)) if kind == "draft" else "lookup"
    B, reps, temp, top_p = 256, 24, 1.0, 0.95
    prompt = [3, 7, 1]
    counts, seen, t1_star = np.zeros(16), 0, None
    for rep in range(reps):
        toks, _ = generate([prompt] * B, model, max_tokens=2, temperature=temp, spec_tokens=2,
                           top_p=top_p, seed=100 + rep, draft_model=dm)
        arr = np.array(toks)
        if t1_star is None:
            vals, cnts = np.unique(arr[:, 0], return_counts=True)
            t1_star = int(vals[np.argmax(cnts)])
        sel = arr[:, 0] == t1_star
        counts += np.bincount(arr[sel, 1], minlength=16)
        seen += int(sel.sum())
    cache = model.alloc_cache(1, 8)
    logits = model.forward(torch.tensor([prompt + [t1_star]]), torch.tensor([4], dtype=torch.int32),
                           cache, attend_cache=False)
    p_true = top_p_probs(torch.softmax(logits[:, -1].float() / temp, dim=-1), top_p)[0].numpy()
    tv = 0.5 * np.abs(counts / max(seen, 1) - p_true).sum()
    assert seen > 800, seen
    assert tv < 0.06, (tv, counts / seen, p_true)
