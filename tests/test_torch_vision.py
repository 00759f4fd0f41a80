"""The port's vision encoder against the JAX package's, on the same numpy
inputs, in fp32 on the CPU.

Tolerances: the 2-D RoPE tables 1e-6 (fp32 cos/sin of the same angles); the
bucket lengths and the PatchMerger layout exact; K10's plain version against
the stock Pallas flash kernel with ``SegmentIds`` in interpret mode 2e-5
(fp32 inputs, so neither side rounds the probabilities; online against
one-pass softmax); ``image_features`` 2e-4 against both of the JAX package's
routes (tests/test_vision_flash.py's bound: 24-wide stacks of fp32
products in another order); the port's per-image calls against its own
concatenated block-diagonal form 2e-4, as tests/test_vision_flash.py holds
the JAX package's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import (
    BlockSizes,
    SegmentIds,
    flash_attention,
)

from mistral_inference_tpu.args import VisionEncoderArgs as JaxVisionArgs
from mistral_inference_tpu.models import vision as JV
from mistral_inference_tpu.models.registry import PIXTRAL_VISION as JAX_PIXTRAL_VISION
from mistral_inference_tpu.ops.rope import precompute_rope_2d as jax_rope_2d
from mistral_inference_tpu_torch.args import VisionEncoderArgs
from mistral_inference_tpu_torch.convert import params_from_numpy, vision_params_from_numpy
from mistral_inference_tpu_torch.models import vision as V
from mistral_inference_tpu_torch.models.registry import PIXTRAL_VISION
from mistral_inference_tpu_torch.ops.cuda import attention as tk
from mistral_inference_tpu_torch.ops.rope import precompute_rope_2d


def _port_args(jargs: JaxVisionArgs) -> VisionEncoderArgs:
    return VisionEncoderArgs(**dataclasses.asdict(jargs))


def _jax_vision(jargs: JaxVisionArgs, lm_dim: int, seed: int = 0):
    """JAX vision params and the same weights in the port's layout."""
    jp = JV.init_vision_params(jax.random.PRNGKey(seed), jargs, lm_dim, jnp.float32)
    return jp, vision_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("dim,height,width,theta", [(64, 64, 64, 1e4), (16, 8, 5, 1e4),
                                                    (128, 7, 9, 1e6)])
def test_rope_2d_matches_jax(dim, height, width, theta):
    cos, sin = precompute_rope_2d(dim, height, width, theta)
    jcos, jsin = jax_rope_2d(dim, height, width, theta)
    assert cos.shape == (height, width, dim // 2)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6, rtol=0)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6, rtol=0)


def test_bucket_matches_jax():
    assert [V._bucket(n) for n in range(1, 5001)] == [JV._bucket(n) for n in range(1, 5001)]


@pytest.mark.parametrize("h,w,d,s", [(4, 6, 3, 2), (6, 4, 5, 2), (3, 3, 2, 3), (2, 2, 4, 1)])
def test_patch_merge_matches_jax(h, w, d, s):
    x = np.random.default_rng(0).standard_normal((h * w, d)).astype(np.float32)
    out = V._patch_merge_one(torch.from_numpy(x), h, w, s).numpy()
    np.testing.assert_array_equal(out, np.asarray(JV._patch_merge_one(jnp.asarray(x), h, w, s)))


def _stock_flash(q, k, v, seg):
    """The stock Pallas kernel in interpret mode with the block sizes of the
    JAX package's vision encoder; (B, N, H, D) in and out."""
    N, D = q.shape[1], q.shape[3]
    bq, bk = min(N, 512), 1024 if N % 1024 == 0 else 512
    bs = BlockSizes(block_q=bq, block_k_major=bk, block_k=bk, block_b=1,
                    block_q_major_dkv=bq, block_k_major_dkv=bk, block_k_dkv=bk,
                    block_q_dkv=bq, block_k_major_dq=bk, block_k_dq=bk, block_q_dq=bq)
    s = jnp.asarray(seg)
    with pltpu.force_tpu_interpret_mode():
        o = flash_attention(*(jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v)),
                            segment_ids=SegmentIds(s, s), sm_scale=D**-0.5, block_sizes=bs)
    return np.asarray(jnp.swapaxes(o, 1, 2))


@pytest.mark.parametrize("parts", [[(0, 504), (-1, 8)], [(0, 400), (1, 600), (-1, 24)]],
                         ids=["padded-512", "two-segments-1024"])
def test_k10_plain_matches_stock_pallas(parts):
    """K10's plain version against the stock Pallas flash_attention with
    SegmentIds, at Pixtral's 16 heads of 64, padding rows included."""
    rng = np.random.default_rng(0)
    N, H, D = sum(n for _, n in parts), 16, 64
    q, k, v = (rng.standard_normal((1, N, H, D)).astype(np.float32) for _ in range(3))
    seg = np.concatenate([np.full((n,), i, np.int32) for i, n in parts])[None]
    ref = _stock_flash(q, k, v, seg).reshape(1, N, H * D)
    out = tk.segment_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                     torch.from_numpy(seg))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=2e-5)
    # On CPU tensors the wrapper is the plain version and counts nothing.
    tk.segment_flash_attention.launches = 0
    again = tk.segment_flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                       torch.from_numpy(seg))
    assert torch.equal(again, out) and tk.segment_flash_attention.launches == 0


def _clear_jax_vision_caches():
    # The JAX route switches are read at trace time.
    JV._encode_batch.clear_cache()
    JV._vision_blocks.clear_cache()


@pytest.mark.parametrize("flash", ["1", "0"], ids=["jax-flash-route", "jax-xla-route"])
def test_image_features_match_jax(monkeypatch, flash):
    """Pixtral's encoder widths cut to 2 layers, a 384 x 336 image: 504
    patches in the 512 bucket, so 8 padding rows take part."""
    jargs = dataclasses.replace(JAX_PIXTRAL_VISION, num_hidden_layers=2)
    jp, params = _jax_vision(jargs, 64)
    im = np.random.default_rng(0).normal(size=(3, 384, 336)).astype(np.float32)
    monkeypatch.setenv("MISTRAL_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MISTRAL_VISION_FLASH", flash)
    _clear_jax_vision_caches()
    try:
        ref = np.asarray(JV.image_features(jp, jargs, [im], jnp.float32))
    finally:
        _clear_jax_vision_caches()
    args = _port_args(jargs)
    assert args == dataclasses.replace(PIXTRAL_VISION, num_hidden_layers=2)
    out = V.image_features(params, args, [im], torch.float32)
    assert out.shape == ref.shape == (504, 64)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4, rtol=2e-4)


def _tiny_args(**over) -> JaxVisionArgs:
    kw = dict(hidden_size=64, num_channels=3, image_size=64, patch_size=8,
              intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
              rope_theta=1e4, image_token_id=2)
    kw.update(over)
    return JaxVisionArgs(**kw)


@pytest.mark.parametrize("over", [
    {},
    dict(spatial_merge_size=2, adapter_bias=False, add_pre_mm_projector_layer_norm=True,
         mm_projector_id="patch_merge"),
], ids=["adapter", "patch-merger"])
def test_image_features_variants_match_jax(over):
    """Two images of different sizes; with the PatchMerger, the
    pre-projector norm and an adapter without bias."""
    jargs = _tiny_args(**over)
    jp, params = _jax_vision(jargs, 96, seed=3)
    assert ("b" in params["adapter"]["w_in"]) == jargs.adapter_bias
    rng = np.random.default_rng(1)
    ims = [rng.standard_normal((3, 32, 48)).astype(np.float32),
           rng.standard_normal((3, 16, 64)).astype(np.float32)]
    ref = np.asarray(JV.image_features(jp, jargs, ims, jnp.float32))
    out = V.image_features(params, _port_args(jargs), ims, torch.float32)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4, rtol=2e-4)


def test_per_image_equals_concatenated_blockdiag():
    """Per-image calls against the reference's form: ONE concatenated patch
    sequence whose image ids make the attention block-diagonal, run through
    the port's own blocks (tests/test_vision_flash.py's oracle)."""
    args = _port_args(dataclasses.replace(JAX_PIXTRAL_VISION, num_hidden_layers=2))
    _, params = _jax_vision(dataclasses.replace(JAX_PIXTRAL_VISION, num_hidden_layers=2), 64)
    rng = np.random.default_rng(1)
    a = rng.normal(size=(3, 128, 128)).astype(np.float32)
    b = rng.normal(size=(3, 64, 192)).astype(np.float32)
    per_image = V.encode_images(params, args, [a, b], torch.float32)

    P = args.patch_size
    grids, rows, cols, ids = [], [], [], []
    for i, im in enumerate((a, b)):
        patches = torch.nn.functional.conv2d(torch.from_numpy(im)[None], params["patch_conv"],
                                             stride=P)[0]
        h, w = patches.shape[1:]
        grids.append(patches.reshape(patches.shape[0], h * w).T)
        rows.append(torch.arange(h).repeat_interleave(w))
        cols.append(torch.arange(w).repeat(h))
        ids.append(torch.full((h * w,), i, dtype=torch.int32))
    n = sum(g.shape[0] for g in grids)
    N = V._bucket(n)
    pad = N - n
    flat = torch.nn.functional.pad(torch.cat(grids), (0, 0, 0, pad))
    rows = torch.cat(rows + [torch.zeros(pad, dtype=torch.long)])
    cols = torch.cat(cols + [torch.zeros(pad, dtype=torch.long)])
    seg = torch.cat(ids + [torch.full((pad,), -1, dtype=torch.int32)])
    side = args.image_size // P
    cos2d, sin2d = precompute_rope_2d(args.hidden_size // args.num_attention_heads, side, side,
                                      args.rope_theta)
    x = V.rms_norm(flat, params["ln_pre"], V.VISION_NORM_EPS)
    oracle = V._vision_blocks(params, x[None], cos2d[rows, cols], sin2d[rows, cols], seg,
                              args)[0, :n]
    np.testing.assert_allclose(per_image.numpy(), oracle.numpy(), atol=2e-4, rtol=2e-4)


def test_group_max_equals_per_image():
    """Same-size images batched into one call (group_max > 1) give the
    per-image calls' features, mixed sizes and a group cut by the cap."""
    jargs = _tiny_args()
    _, params = _jax_vision(jargs, 64, seed=5)
    args = _port_args(jargs)
    rng = np.random.default_rng(2)
    ims = [rng.standard_normal((3, h, w)).astype(np.float32)
           for h, w in ((32, 48), (16, 64), (32, 48), (32, 48), (16, 64))]
    one = V.encode_images(params, args, ims, torch.float32)
    for gmax in (2, 4):
        grouped = V.encode_images(params, args, ims, torch.float32, group_max=gmax)
        np.testing.assert_allclose(grouped.numpy(), one.numpy(), atol=1e-5, rtol=1e-5)


def test_convert_carries_vision_subtree():
    """params_from_numpy carries the "vision" subtree: each linear
    transposed to (out, in) with q | k | v and w1 | w3 fused, the conv, the
    norms and the adapter biases as they are."""
    from mistral_inference_tpu.args import TransformerArgs as JaxArgs
    from mistral_inference_tpu.model import Transformer as JaxTransformer

    jargs = _tiny_args(spatial_merge_size=2, add_pre_mm_projector_layer_norm=True,
                       mm_projector_id="patch_merge")
    targs = JaxArgs(dim=96, n_layers=1, head_dim=32, hidden_dim=128, n_heads=3, n_kv_heads=1,
                    norm_eps=1e-5, vocab_size=64, vision_encoder=jargs)
    jmodel = JaxTransformer.random(targs, dtype=jnp.float32, seed=0)
    jmodel.params["vision"] = JV.init_vision_params(jax.random.PRNGKey(1), jargs, 96,
                                                    jnp.float32)
    tree = jax.tree.map(np.asarray, jmodel.params)
    jv = tree["vision"]
    pv = params_from_numpy(tree, device="cpu")["vision"]
    np.testing.assert_array_equal(pv["patch_conv"].numpy(), jv["patch_conv"])
    np.testing.assert_array_equal(pv["ln_pre"].numpy(), jv["ln_pre"])
    np.testing.assert_array_equal(pv["pre_mm_projector_norm"].numpy(),
                                  jv["pre_mm_projector_norm"])
    np.testing.assert_array_equal(pv["patch_merger"]["w"].numpy(), jv["patch_merger"]["w"].T)
    att, ffn = jv["layers"]["attention"], jv["layers"]["feed_forward"]
    assert len(pv["layers"]) == jargs.num_hidden_layers
    for i, lw in enumerate(pv["layers"]):
        np.testing.assert_array_equal(lw["attention_norm"].numpy(),
                                      jv["layers"]["attention_norm"][i])
        np.testing.assert_array_equal(
            lw["wqkv"].numpy(), np.concatenate([att[n][i].T for n in ("wq", "wk", "wv")]))
        np.testing.assert_array_equal(lw["wo"].numpy(), att["wo"][i].T)
        np.testing.assert_array_equal(lw["w13"].numpy(),
                                      np.concatenate([ffn["w1"][i].T, ffn["w3"][i].T]))
        np.testing.assert_array_equal(lw["w2"].numpy(), ffn["w2"][i].T)
    for name in ("w_in", "w_out"):
        np.testing.assert_array_equal(pv["adapter"][name]["w"].numpy(),
                                      jv["adapter"][name]["w"].T)
        np.testing.assert_array_equal(pv["adapter"][name]["b"].numpy(),
                                      jv["adapter"][name]["b"])
