"""The Mamba slice as a whole: ``generate_mamba`` of the port, plain and with
prompt-lookup speculation, against the JAX package's on shared weights
(``convert.mamba_params_from_numpy``), in fp32 on the CPU; the JAX side on its
XLA route.

Tolerances: greedy tokens equal; logprobs within 5e-4 (tests/test_mamba.py's
decode == prefill tolerance: fp32 through the chunked SSD in prefill and the
recurrent step in decode). A bf16 SSD state: see ``BF16_STATE_NATS``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistral_inference_tpu.args import MambaArgs as JaxMambaArgs
from mistral_inference_tpu.generate import generate_mamba as jax_generate_mamba
from mistral_inference_tpu.model import Mamba as JaxMamba
from mistral_inference_tpu.models import mamba as jmm
from mistral_inference_tpu.quant.weights import quantize_params as jax_quantize_params
from mistral_inference_tpu.speculative import generate_lookup_mamba as jax_generate_lookup_mamba
from mistral_inference_tpu_torch.args import MambaArgs
from mistral_inference_tpu_torch.convert import mamba_params_from_numpy
from mistral_inference_tpu_torch.generate import generate_mamba
from mistral_inference_tpu_torch.model import Mamba

TINY = dict(dim=64, n_layers=2, vocab_size=256, n_groups=2, rms_norm=True,
            residual_in_fp32=True, fused_add_norm=True, pad_vocab_size_multiple=16,
            tie_embeddings=False, d_state=16, d_conv=4, expand=2, headdim=16)
PROMPTS = [[1, 5, 9, 13, 17, 21], [2, 6, 10], [3, 7, 11, 15, 19, 23, 27, 31, 35], [4, 8]]
# Repeats, so that the n-gram proposer finds matches.
LOOKUP_PROMPTS = [[5, 6, 7, 8, 5, 6, 7, 8, 5, 6], [9, 3, 9, 3, 9], [1, 2, 3]]
LP_TOL = dict(atol=5e-4, rtol=0)
# A bf16 SSD state rounds once per stored token in decode and once per chunk
# in prefill, so decode and prefill store different roundings of the same
# fp32 state: each rounding moves the state by up to 2^-9 of its size, and
# random weights pass that on to the logits. Measured at most 0.0016 nats on
# these prompts over five seeds; the bound leaves a factor of about 6.
BF16_STATE_NATS = 1e-2


def _close(a, b, tol=LP_TOL):
    assert [len(x) for x in a] == [len(x) for x in b]
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, **tol)


@pytest.fixture(scope="module")
def models():
    """The JAX model (XLA route) and the port's, on one set of weights."""
    jargs = JaxMambaArgs(**TINY)
    init = jax.jit(lambda key: jmm.init_mamba_params(key, jargs, jnp.float32))
    jparams = init(jax.random.PRNGKey(42))
    jmodel = JaxMamba(jargs, jparams, jnp.float32, pallas=False)
    port = Mamba(MambaArgs(**TINY), mamba_params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu"),
                 torch.float32, device="cpu")
    return jmodel, port


def test_greedy_matches_jax(models):
    jmodel, port = models
    g, lp = generate_mamba(PROMPTS, port, max_tokens=8, temperature=0.0)
    jg, jlp = jax_generate_mamba(PROMPTS, jmodel, max_tokens=8, temperature=0.0)
    assert g == jg
    _close(lp, jlp)


def test_decode_equals_prefill(models):
    _, port = models
    g, lp = generate_mamba(PROMPTS, port, max_tokens=7, temperature=0.0)
    assert all(len(x) == 7 for x in g)
    full = [p + x for p, x in zip(PROMPTS, g)]
    _, lp_ref = generate_mamba(full, port, max_tokens=0, temperature=0.0)
    _close(lp, lp_ref)


def test_chunked_prefill_equals_whole(models):
    _, port = models
    prompts = [list(range(1, 15)), list(range(2, 10))]
    g_full, lp_full = generate_mamba(prompts, port, max_tokens=4, temperature=0.0)
    g_chunk, lp_chunk = generate_mamba(prompts, port, max_tokens=4, temperature=0.0,
                                       chunk_size=5)
    assert g_full == g_chunk
    _close(lp_full, lp_chunk)


def test_eos_stops_when_every_row_has_it(models):
    _, port = models
    g1, _ = generate_mamba(PROMPTS, port, max_tokens=6, temperature=0.0)
    eos = g1[0][1]
    g2, lp2 = generate_mamba(PROMPTS, port, max_tokens=6, temperature=0.0, eos_id=eos)
    # The stop rule: every row runs until the step on which the last row
    # emits EOS, which is not appended.
    steps = [row.index(eos) if eos in row else None for row in g1]
    cut = max(steps) if None not in steps else 6
    assert g2 == [row[:cut] for row in g1]
    assert [len(x) for x in lp2] == [len(p) - 1 + cut for p in PROMPTS]


def test_top_p_fixed_by_seed(models):
    _, port = models
    kw = dict(max_tokens=8, temperature=0.8, top_p=0.9)
    a, lpa = generate_mamba(PROMPTS, port, seed=3, **kw)
    b, lpb = generate_mamba(PROMPTS, port, seed=3, **kw)
    c, _ = generate_mamba(PROMPTS, port, seed=4, **kw)
    assert a == b and lpa == lpb
    assert a != c


def test_int4_weights_match_jax(models):
    """int4 weights (group 64) quantized in the JAX package and carried over
    byte for byte: greedy tokens and logprobs as JAX's. (The quantization is
    jitted for speed; both sides read the same bytes, so it need not equal
    the eager one that tests/test_torch_mamba.py holds the port's to.)"""
    jmodel, _ = models
    quantize = jax.jit(lambda p: jax_quantize_params(dict(p, layers=dict(p["layers"])), "int4",
                                                     64))
    jq = quantize(jmodel.params)
    jq_model = JaxMamba(jmodel.args, jq, jnp.float32, pallas=False)
    port = Mamba(MambaArgs(**TINY, quant="int4"),
                 mamba_params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu"), torch.float32,
                 device="cpu")
    g, lp = generate_mamba(PROMPTS, port, max_tokens=6, temperature=0.0)
    jg, jlp = jax_generate_mamba(PROMPTS, jq_model, max_tokens=6, temperature=0.0)
    assert g == jg
    _close(lp, jlp)


def test_bf16_state_decode_near_prefill(models):
    _, fp32 = models
    port = Mamba(fp32.args, fp32.params, torch.float32, device="cpu",
                 ssm_dtype=torch.bfloat16)
    g, lp = generate_mamba(PROMPTS, port, max_tokens=7, temperature=0.0)
    full = [p + x for p, x in zip(PROMPTS, g)]
    _, lp_ref = generate_mamba(full, port, max_tokens=0, temperature=0.0)
    _close(lp, lp_ref, dict(atol=BF16_STATE_NATS, rtol=0))


@pytest.mark.parametrize("spec_tokens", [3, 7])
def test_lookup_equals_plain_greedy_and_jax(models, spec_tokens):
    """``draft_model="lookup"``: plain greedy's tokens and logprob count,
    and JAX ``generate_lookup_mamba``'s tokens and logprobs."""
    jmodel, port = models
    plain, plain_lp = generate_mamba(LOOKUP_PROMPTS, port, max_tokens=10, temperature=0.0)
    g, lp = generate_mamba(LOOKUP_PROMPTS, port, max_tokens=10, temperature=0.0,
                           draft_model="lookup", spec_tokens=spec_tokens)
    assert g == plain
    _close(lp, plain_lp)
    jg, jlp = jax_generate_lookup_mamba(LOOKUP_PROMPTS, jmodel, max_tokens=10,
                                        temperature=0.0, spec_tokens=spec_tokens)
    assert g == jg
    _close(lp, jlp)


def test_lookup_sampling_fixed_by_seed(models):
    _, port = models
    kw = dict(max_tokens=8, temperature=0.8, top_p=0.9, draft_model="lookup", spec_tokens=3)
    a, lpa = generate_mamba(LOOKUP_PROMPTS, port, seed=5, **kw)
    b, lpb = generate_mamba(LOOKUP_PROMPTS, port, seed=5, **kw)
    assert a == b and lpa == lpb
    assert [len(x) for x in lpa] == [len(p) - 1 + 8 for p in LOOKUP_PROMPTS]
    with pytest.raises(ValueError, match="draft-free"):
        generate_mamba(PROMPTS, port, max_tokens=2, temperature=0.0, draft_model=port)
