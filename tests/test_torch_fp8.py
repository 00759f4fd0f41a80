"""The float8_e4m3fn KV ring of the port against the JAX package's, on the CPU.

The ring rule: scale = max(absmax / 448, 1e-8) per (token, kv head), the
stored value (x / scale) cast to e4m3 with round to nearest even and no
clip. |x / scale| stays within a rounding of 448, where PyTorch's cast and
XLA's agree bit for bit; above 464 they part (PyTorch saturates to 448, XLA
gives NaN), which the rule never reaches. So bytes and scales compare
exactly, the cast itself is pinned over that range, and everything else is
the int8 tests' (here, test_torch_cache.py and test_torch_fused_verify.py,
the ring kernels' plain versions over an fp8 ring against the Pallas kernels
in interpret mode).

Tolerances: greedy tokens equal; logprobs within 2e-3, the int8 ring's
tolerance (tests/test_quant.py): fp32 summation-order differences that move
a K/V element across a rounding boundary of the ring's type show in the
logits. decode == prefill within the port to the same 2e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mistral_inference_tpu import cache as jcache
from mistral_inference_tpu.args import MoeArgs as JaxMoeArgs
from mistral_inference_tpu.args import TransformerArgs as JaxArgs
from mistral_inference_tpu.generate import generate as jax_generate
from mistral_inference_tpu.model import Transformer as JaxTransformer
from mistral_inference_tpu.models.vision import init_vision_params
from mistral_inference_tpu_torch import cache as tcache
from mistral_inference_tpu_torch.args import TransformerArgs
from mistral_inference_tpu_torch.convert import params_from_numpy
from mistral_inference_tpu_torch.generate import generate
from mistral_inference_tpu_torch.model import Transformer
from test_torch_attention import test_decode_attention_plain_matches_pallas as _k6_case
from test_torch_attention import test_fused_decode_plain_matches_pallas as _k2_case
from test_torch_attention import test_ring_stats_and_merge_match_pallas as _k4_case

FP8 = torch.float8_e4m3fn
LOGPROB_TOL = dict(atol=2e-3, rtol=0)


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.uint8).numpy()


def _crafted_rows() -> np.ndarray:
    """(6, 128) rows at the rule's edges: an extreme exactly at 448 (scale
    1, so the others land as they are: subnormal ties 2^-10 and 3 * 2^-10
    and 5 * 2^-10, and normal ties 1.0625 and 1.1875); an absmax whose
    scale is a power of two (the extreme lands on 448 after the division);
    a tiny row that hits the 1e-8 floor; a row of zeros; a row of -0."""
    x = np.zeros((6, 128), np.float32)
    x[0, :8] = [448.0, -2.0**-10, 3 * 2.0**-10, 5 * 2.0**-10, 1.0625, -1.1875, 7.5, 2.0**-6]
    x[0, 8:] = np.linspace(-440, 440, 120)
    x[1] = np.linspace(-3.5, 3.5, 128)
    x[2] = np.linspace(-3e-6, 2e-6, 128)
    x[4] = -0.0
    x[5, :4] = [1e-20, -1e-30, 2.5e-9, 0.0]
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_ring_fp8_bit_exact(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 5, 3, 128)).astype(np.float32) * rng.uniform(0.01, 30, (4, 5, 3, 1))
    x = np.concatenate([x.reshape(-1, 128), _crafted_rows()]).reshape(-1, 2, 128)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = jcache._quantize_ring(jx, jnp.float8_e4m3fn)
    tq, ts = tcache._quantize_ring(tx, FP8)
    assert tq.dtype == FP8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(_bytes(tq), np.asarray(jq).view(np.uint8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # The crafted rows: 448 lands on 448, the floor holds, zeros stay zeros.
    crafted = tq.view(-1, 128)[-6:]
    assert crafted[0, 0].float() == 448.0 and crafted[1].float().abs().max() == 448.0
    assert ts.view(-1)[-4] == np.float32(1e-8) and (_bytes(crafted[3]) == 0).all()
    np.testing.assert_array_equal(
        tcache.kv_roundtrip(tx, FP8).float().numpy(),
        np.asarray(jcache.kv_roundtrip(jx, jnp.float8_e4m3fn)).astype(np.float32),
    )
    np.testing.assert_array_equal(
        tcache.fp8_roundtrip(tx).float().numpy(),
        np.asarray(jcache.fp8_roundtrip(jx)).astype(np.float32),
    )


def test_fp8_cast_agrees_in_the_rule_range():
    """PyTorch's e4m3 cast gives XLA's and ml_dtypes' bytes for every value
    the rule can produce: each e4m3 value, each midpoint between two (the
    ties, rounded to even), a float either side of each, up to 464 where the
    range of the ring rule ends."""
    grid = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn).astype(np.float32)
    grid = np.unique(grid[np.isfinite(grid) & (grid >= 0)])
    mids = (grid[:-1] + grid[1:]) / 2
    pts = np.concatenate([grid, mids, np.nextafter(mids, 0), np.nextafter(mids, 1e9),
                          [448.0001, 463.9, np.nextafter(np.float32(464), 0)]]).astype(np.float32)
    pts = np.concatenate([pts, -pts])
    ours = _bytes(torch.from_numpy(pts).to(FP8))
    np.testing.assert_array_equal(ours, pts.astype(ml_dtypes.float8_e4m3fn).view(np.uint8))
    np.testing.assert_array_equal(
        ours, np.asarray(jnp.asarray(pts).astype(jnp.float8_e4m3fn)).view(np.uint8))


def test_ring_kernels_plain_over_fp8_match_pallas():
    """K4, K2 and K6's plain versions over an fp8 ring against the Pallas
    kernels in interpret mode and the XLA oracle, as
    tests/test_torch_attention.py holds them over int8 (one of its shapes
    each, to keep this file short): K4 with the chunk merge; K2 with a
    wrapped, a near-full, an empty and a dead row, its ring bytes equal;
    K6 with holes and a window under the ring, and over a wrapped ring with
    a window shorter than its fill. K7's fp8 cases are in
    tests/test_torch_fused_verify.py."""
    _k4_case(40, 5, 2, 4, "fp8")
    _k2_case("fp8", 256, 200, [5, 199, 230, 0], [1, 1, 1, 0])
    _k6_case(40, 2, 4, "fp8", 0)
    _k6_case(300, 2, 4, "fp8", 77)


def test_fp8_ring_args_and_alloc():
    args = TransformerArgs(dim=64, n_layers=2, head_dim=16, hidden_dim=128, n_heads=4,
                           n_kv_heads=2, norm_eps=1e-5, vocab_size=64, kv_quant="fp8")
    assert TransformerArgs.from_dict(dataclasses.asdict(args)).kv_quant == "fp8"
    assert tcache.kv_cache_dtype("fp8", torch.bfloat16) == FP8
    assert tcache.is_scaled_dtype(FP8) and tcache.is_scaled_dtype(torch.int8)
    assert not tcache.is_scaled_dtype(torch.bfloat16)
    cache = Transformer.random(args, dtype=torch.float32, device="cpu").alloc_cache(2, 40)
    assert cache.k.dtype == FP8 and cache.k_scale.shape == (2, 2, 2, 128)
    assert (_bytes(cache.k) == 0).all()


# ---------------------------------------------------------------------------
# generate() over an fp8 ring
# ---------------------------------------------------------------------------

CHUNK = 128
_rng = np.random.default_rng(0)
PROMPTS = [_rng.integers(1, 512, n).tolist() for n in (150, 128, 131, 140)]
SHORT_PROMPTS = [list(range(1, 14)), [2, 6, 10], [3, 7, 11, 15, 19, 23, 27, 31, 35], [4, 8]]


def jax_args(**overrides) -> JaxArgs:
    """tests/test_torch_quant_generate.py's shapes: every prefill linear at
    512 rows, every decode linear at 4, head_dim 128."""
    kw = dict(dim=256, n_layers=2, head_dim=128, hidden_dim=512, n_heads=2, n_kv_heads=1,
              norm_eps=1e-5, vocab_size=512, max_batch_size=4, rope_theta=10000.0,
              kv_quant="fp8")
    kw.update(overrides)
    return JaxArgs(**kw)


def port_of(jmodel) -> Transformer:
    args = TransformerArgs.from_dict(dataclasses.asdict(jmodel.args))
    params = params_from_numpy(jax.tree.map(np.asarray, jmodel.params), device="cpu")
    return Transformer(args, params, torch.float32, device="cpu")


def assert_same_generation(jmodel, model, prompts, max_tokens=4, **kw):
    jg, jl = jax_generate(prompts, jmodel, max_tokens=max_tokens, temperature=0.0, **kw)
    tg, tl = generate(prompts, model, max_tokens=max_tokens, temperature=0.0, **kw)
    assert tg == jg
    for a, b, p in zip(tl, jl, prompts):
        assert len(a) == len(b) == len(p) - 1 + max_tokens
        np.testing.assert_allclose(a, b, **LOGPROB_TOL)


@pytest.mark.parametrize("window", [None, 100])
def test_int4_fp8_greedy_matches_jax(window):
    """The north-star configuration at tiny widths: int4 weights (K3 in
    decode, K5 in prefill) over an fp8 ring; with a window of 100 the ring
    wraps in the second chunk."""
    jmodel = JaxTransformer.random(jax_args(sliding_window=window), dtype=jnp.float32,
                                   seed=3).quantize("int4", group=64)
    model = port_of(jmodel)
    assert model.args.kv_quant == "fp8" and model.alloc_cache(1, 8).k.dtype == FP8
    assert_same_generation(jmodel, model, PROMPTS, chunk_size=CHUNK)


@pytest.mark.parametrize("fused", [True, False])
def test_fp8_decode_equals_prefill(monkeypatch, fused):
    """Greedy decode logprobs equal a teacher-forced prefill's of the same
    tokens inside the port, through both decode routes (K2's and
    update_stacked + K6's plain versions); the ring wraps (window 4)."""
    from mistral_inference_tpu_torch.models import transformer as ttf

    monkeypatch.setattr(ttf, "FUSED_DECODE", fused)
    jmodel = JaxTransformer.random(jax_args(dim=128, head_dim=32, n_heads=4, n_kv_heads=2,
                                            hidden_dim=256, sliding_window=4),
                                   dtype=jnp.float32, seed=13)
    model = port_of(jmodel)
    gen, lps = generate(SHORT_PROMPTS, model, max_tokens=7, temperature=0.0, chunk_size=5)
    full = [p + g for p, g in zip(SHORT_PROMPTS, gen)]
    _, lps_ref = generate(full, model, max_tokens=0, temperature=0.0)
    for a, b in zip(lps, lps_ref):
        assert len(a) == len(b)
        np.testing.assert_allclose(a, b, **LOGPROB_TOL)


def test_moe_fp8_greedy_matches_jax():
    """The flag reaches a sparse-MoE model: int4 experts through the
    dispatch route, an fp8 ring."""
    jmodel = JaxTransformer.random(
        jax_args(moe=JaxMoeArgs(num_experts=4, num_experts_per_tok=2), moe_impl="dispatch"),
        dtype=jnp.float32, seed=3,
    ).quantize("int4", group=64)
    model = port_of(jmodel)
    assert model.args.moe is not None and model.args.kv_quant == "fp8"
    assert_same_generation(jmodel, model, SHORT_PROMPTS, chunk_size=5)


def test_vision_fp8_greedy_matches_jax():
    """The flag reaches a multimodal model: a tiny Pixtral whose image
    features fill its image tokens, over an fp8 ring."""
    from mistral_inference_tpu.args import VisionEncoderArgs as JaxVisionArgs

    img_tok = 2
    vargs = JaxVisionArgs(hidden_size=64, num_channels=3, image_size=64, patch_size=8,
                          intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
                          rope_theta=1e4, image_token_id=img_tok)
    jargs = jax_args(dim=128, head_dim=32, n_heads=4, n_kv_heads=2, hidden_dim=256,
                     vision_encoder=vargs)
    jmodel = JaxTransformer.random(jargs, dtype=jnp.float32, seed=42)
    jmodel.params["vision"] = init_vision_params(jax.random.PRNGKey(43), vargs, jargs.dim,
                                                 jnp.float32)
    model = port_of(jmodel)
    assert model.args.vision_encoder is not None and model.args.kv_quant == "fp8"
    rng = np.random.default_rng(0)
    image = rng.standard_normal((3, 16, 24)).astype(np.float32)  # 2 x 3 patches
    prompts = [[1] + [img_tok] * 6 + [4, 5, 6], [3, 9, 11, 13]]
    images = [[image], []]
    jg, jl = jax_generate(prompts, jmodel, images=images, max_tokens=5, temperature=0.0)
    tg, tl = generate(prompts, model, images=images, max_tokens=5, temperature=0.0)
    assert tg == jg
    for a, b in zip(tl, jl):
        assert len(a) == len(b)
        np.testing.assert_allclose(a, b, **LOGPROB_TOL)


def test_lookup_speculation_over_fp8_equals_greedy():
    """Prompt-lookup speculation over an fp8 ring (the fused verify route:
    K7's plain version writes the candidates with the ring rule) gives plain
    greedy decoding's tokens."""
    jmodel = JaxTransformer.random(jax_args(), dtype=jnp.float32, seed=5).quantize("int4", group=64)
    model = port_of(jmodel)
    prompts = [SHORT_PROMPTS[0] * 3, SHORT_PROMPTS[2]]
    plain, plain_lps = generate(prompts, model, max_tokens=8, temperature=0.0, chunk_size=16)
    spec, spec_lps = generate(prompts, model, max_tokens=8, temperature=0.0, chunk_size=16,
                              draft_model="lookup", spec_tokens=4)
    assert spec == plain
    for a, b in zip(spec_lps, plain_lps):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


def test_ring_kernels_take_only_their_ring_types():
    """A ring kernel's wrapper picks its instantiation by the ring's dtype
    and raises on any other, or on scales that do not match the ring."""
    from mistral_inference_tpu_torch.ops.cuda import attention as tk

    assert tk._ring_kind(torch.zeros(4, dtype=FP8), torch.ones(1)) == "fp8"
    assert tk._ring_kind(torch.zeros(4, dtype=torch.int8), torch.ones(1)) == "int8"
    assert tk._ring_kind(torch.zeros(4, dtype=torch.bfloat16), None) == "bf16"
    with pytest.raises(TypeError, match="float8_e4m3fn"):
        tk._ring_kind(torch.zeros(4, dtype=torch.float16), None)
    with pytest.raises(ValueError, match="scales"):
        tk._ring_kind(torch.zeros(4, dtype=FP8), None)
