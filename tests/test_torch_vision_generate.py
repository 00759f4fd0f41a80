"""The port's multimodal generate() against the JAX package's, on shared
weights, in fp32 on the CPU, on tiny Pixtral-style models as
tests/test_vision.py builds them (a JAX model with ``init_vision_params``,
carried across through numpy).

Tolerances: greedy tokens equal, logprobs within 5e-4 (tests/test_vision.py's
bound: two fp32 implementations of the same function, summation orders
differ); the port's own decode == prefill within 5e-4 as well.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistral_inference_tpu.args import TransformerArgs as JaxArgs
from mistral_inference_tpu.args import VisionEncoderArgs as JaxVisionArgs
from mistral_inference_tpu.generate import generate as jax_generate
from mistral_inference_tpu.model import Transformer as JaxTransformer
from mistral_inference_tpu.models.registry import get_args as jax_get_args
from mistral_inference_tpu.models.vision import init_vision_params
from mistral_inference_tpu_torch.args import TransformerArgs, VisionEncoderArgs
from mistral_inference_tpu_torch.convert import params_from_numpy
from mistral_inference_tpu_torch.generate import generate
from mistral_inference_tpu_torch.model import Transformer

IMG_TOK = 2
PATCH_MERGER = dict(spatial_merge_size=2, adapter_bias=False,
                    add_pre_mm_projector_layer_norm=True, mm_projector_id="patch_merge")


def vision_kw(**over):
    kw = dict(hidden_size=64, num_channels=3, image_size=64, patch_size=8,
              intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
              rope_theta=1e4, image_token_id=IMG_TOK)
    kw.update(over)
    return kw


def pair(seed=42, **vision_over):
    """A tiny Pixtral in both packages, with the same weights."""
    vargs = JaxVisionArgs(**vision_kw(**vision_over))
    jargs = JaxArgs(dim=128, n_layers=2, head_dim=32, hidden_dim=256, n_heads=4, n_kv_heads=2,
                    norm_eps=1e-5, vocab_size=512, max_batch_size=4, rope_theta=10000.0,
                    vision_encoder=vargs)
    jmodel = JaxTransformer.random(jargs, dtype=jnp.float32, seed=seed)
    jmodel.params["vision"] = init_vision_params(
        jax.random.PRNGKey(seed + 1), vargs, jargs.dim, jnp.float32)
    args = TransformerArgs.from_dict(dataclasses.asdict(jargs))
    params = params_from_numpy(jax.tree.map(np.asarray, jmodel.params), device="cpu")
    return jmodel, Transformer(args, params, torch.float32, device="cpu")


def img(rng, h, w):
    return rng.standard_normal((3, h, w)).astype(np.float32)


def prompts_three_rows(vargs):
    """Two rows with images of different sizes and one text-only row
    (tests/test_vision.py's make_multimodal_prompts)."""
    rng = np.random.default_rng(0)
    P, s = vargs.patch_size, vargs.spatial_merge_size
    img1, img2 = img(rng, 2 * P * s, 2 * P * s), img(rng, P * s, 3 * P * s)
    n1, n2 = 4, 3  # tokens after the merge
    return ([[1] + [IMG_TOK] * n1 + [4, 5, 6], [1, 7] + [IMG_TOK] * n2 + [8], [3, 9, 11, 13]],
            [[img1], [img2], []])


def prompts_two_images(vargs):
    """One row with two images (2 x 3 and 4 x 2 patches) between text."""
    rng = np.random.default_rng(3)
    P = vargs.patch_size
    a, b = img(rng, 2 * P, 3 * P), img(rng, 4 * P, 2 * P)
    return ([[1, 5] + [IMG_TOK] * 6 + [7, 9] + [IMG_TOK] * 8 + [11], [4, 6, 8]],
            [[a, b], []])


def assert_same_generation(jmodel, model, prompts, images, atol=5e-4, **kw):
    jg, jl = jax_generate(prompts, jmodel, images=images, max_tokens=6, temperature=0.0, **kw)
    tg, tl = generate(prompts, model, images=images, max_tokens=6, temperature=0.0, **kw)
    assert tg == jg
    for a, b in zip(tl, jl):
        assert len(a) == len(b)
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)


@pytest.mark.parametrize("case,chunk,vision_over", [
    ("three-rows", None, {}),
    ("two-images", None, {}),
    ("three-rows", 3, {}),  # images cross chunk boundaries
    ("three-rows", None, PATCH_MERGER),
])
def test_generate_matches_jax(case, chunk, vision_over):
    jmodel, model = pair(7 if vision_over else 42, **vision_over)
    make = prompts_three_rows if case == "three-rows" else prompts_two_images
    prompts, images = make(model.args.vision_encoder)
    assert_same_generation(jmodel, model, prompts, images, chunk_size=chunk)


@pytest.mark.parametrize("vision_over", [{}, PATCH_MERGER], ids=["plain", "patch-merger"])
def test_decode_equals_prefill_with_images(vision_over):
    """tests/test_vision.py's check_mm_equivalence on the port alone: the
    greedy decode logprobs equal a teacher-forced prefill's of prompt +
    generated tokens with the same images."""
    _, model = pair(7 if vision_over else 42, **vision_over)
    prompts, images = prompts_three_rows(model.args.vision_encoder)
    gen, lps = generate(prompts, model, images=images, max_tokens=6, temperature=0.0)
    full = [p + g for p, g in zip(prompts, gen)]
    _, ref = generate(full, model, images=images, max_tokens=0, temperature=0.0, chunk_size=5)
    for a, b in zip(lps, ref):
        assert len(a) == len(b)
        np.testing.assert_allclose(a, b, atol=5e-4, rtol=0)


def test_speculation_refuses_images():
    _, model = pair()
    prompts, images = prompts_three_rows(model.args.vision_encoder)
    for draft in (model, "lookup"):
        with pytest.raises(ValueError, match="image"):
            generate(prompts, model, images=images, max_tokens=2, temperature=0.0,
                     draft_model=draft)


def test_image_token_count_must_match():
    _, model = pair()
    prompts, images = prompts_three_rows(model.args.vision_encoder)
    prompts[0] = prompts[0][:-3] + [IMG_TOK]  # one image token too many
    with pytest.raises(ValueError, match="image tokens"):
        generate(prompts, model, images=images, max_tokens=1, temperature=0.0)


def test_from_dict_keeps_vision_encoder():
    """A Pixtral params.json builds a multimodal model: from_dict keeps the
    encoder and equals the JAX args field by field."""
    jargs = jax_get_args("pixtral-12b")
    args = TransformerArgs.from_dict(dataclasses.asdict(jargs))
    assert isinstance(args.vision_encoder, VisionEncoderArgs)
    ours, theirs = dataclasses.asdict(args), dataclasses.asdict(jargs)
    assert {k: theirs[k] for k in ours} == ours
    assert ours["vision_encoder"] == theirs["vision_encoder"]


def test_random_pixtral_is_the_whole_model():
    """Transformer.random draws the vision tree for a multimodal preset, and
    weight-only quantization leaves it in the model dtype."""
    args = TransformerArgs.from_dict(dataclasses.asdict(JaxArgs(
        dim=256, n_layers=1, head_dim=128, hidden_dim=512, n_heads=2, n_kv_heads=1,
        norm_eps=1e-5, vocab_size=256, vision_encoder=JaxVisionArgs(**vision_kw()))))
    model = Transformer.random(args, dtype=torch.float32, seed=0, device="cpu")
    assert model.params["vision"]["patch_conv"].shape == (64, 3, 8, 8)
    model.quantize("int8")
    assert all(isinstance(w, torch.Tensor) and w.dtype == torch.float32
               for lw in model.params["vision"]["layers"] for w in lw.values())
    prompts, images = prompts_three_rows(args.vision_encoder)
    gen, _ = generate(prompts, model, images=images, max_tokens=3, temperature=0.0)
    assert all(len(g) == 3 for g in gen)
