"""The port's image preprocessing and multimodal token layout against the
JAX package's (tests/test_images.py's cases, less the serving-engine and
chat tests, which wait for the port's server and tokenizers).

Tolerances: sizes and token ids exact; preprocessed arrays 1e-6 (PIL is
installed, so both packages resample bicubic through it and differ at most
in the last fp32 bit of the normalization).
"""

import base64
import io

import numpy as np
import pytest

from mistral_inference_tpu import images as J
from mistral_inference_tpu.args import VisionEncoderArgs as JaxVisionArgs
from mistral_inference_tpu_torch import images as I
from mistral_inference_tpu_torch.args import VisionEncoderArgs


class MMTok:
    """A stub tokenizer with the multimodal special tokens of Pixtral's
    tekken layout."""

    bos_id, eos_id = 1, 2
    SPECIALS = {"[INST]": 3, "[/INST]": 4, "[IMG]": 10, "[IMG_BREAK]": 12, "[IMG_END]": 13}

    def special(self, name):
        return self.SPECIALS[name]

    def encode(self, text, bos=True, eos=False):
        ids = [20 + (ord(c) % 100) for c in text]
        return ([self.bos_id] if bos else []) + ids + ([self.eos_id] if eos else [])


def both_args(**over):
    kw = dict(hidden_size=64, num_channels=3, image_size=64, patch_size=8,
              intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
              rope_theta=1e4, image_token_id=10)
    kw.update(over)
    return VisionEncoderArgs(**kw), JaxVisionArgs(**kw)


@pytest.mark.parametrize("h,w,patch,longest,merge", [
    (20, 50, 16, 1024, 1), (16, 16, 16, 1024, 1), (2048, 1024, 16, 1024, 1),
    (20, 20, 16, 1024, 2), (1, 3000, 16, 1024, 1), (777, 555, 14, 512, 2),
])
def test_target_size_matches_jax(h, w, patch, longest, merge):
    assert I.target_size(h, w, patch, longest, merge) == J.target_size(h, w, patch, longest, merge)


def test_target_size_contract():
    assert I.target_size(20, 50, 16, 1024) == (32, 64)
    th, tw = I.target_size(2048, 1024, 16, 1024)
    assert th == 1024 and tw % 16 == 0 and tw <= 512 + 16
    assert all(x % 32 == 0 for x in I.target_size(20, 20, 16, 1024, spatial_merge_size=2))


@pytest.mark.parametrize("shape,over", [
    ((24, 40, 3), {}),                     # already patch multiples: no resample
    ((3, 30, 70), dict(image_size=64)),    # CHW in, longest edge 70 > 64: bicubic down
    ((13, 29, 3), dict(spatial_merge_size=2)),  # rounded up to multiples of 16: bicubic up
])
def test_preprocess_image_matches_jax(shape, over):
    raw = np.random.default_rng(0).integers(0, 256, shape, np.uint8)
    ours, theirs = both_args(**over)
    out = I.preprocess_image(raw, ours)
    ref = J.preprocess_image(raw, theirs)
    assert out.dtype == np.float32 and out.shape == ref.shape and out.shape[0] == 3
    assert out.shape[1] % (8 * ours.spatial_merge_size) == 0
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def test_preprocess_image_normalization():
    raw = np.random.default_rng(0).integers(0, 256, (24, 40, 3), np.uint8)
    out = I.preprocess_image(raw, both_args()[0])
    expect = (raw[..., 0].astype(np.float32) / 255.0 - I.DATASET_MEAN[0]) / I.DATASET_STD[0]
    np.testing.assert_allclose(out[0], expect, atol=1e-5)


def test_resize_fallback_matches_jax(monkeypatch):
    """Without PIL both packages fall back to the same numpy bilinear."""
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("PIL blocked")
        return real_import(name, *args, **kwargs)

    raw = np.random.default_rng(4).integers(0, 256, (11, 17, 3), np.uint8)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    np.testing.assert_allclose(I._resize(raw, 16, 24), J._resize(raw, 16, 24), atol=1e-6)


@pytest.mark.parametrize("h,w,over", [(16, 24, {}), (32, 16, dict(spatial_merge_size=2)),
                                      (8, 8, {}), (64, 40, {})])
def test_image_token_layout_matches_jax(h, w, over):
    ours, theirs = both_args(**over)
    ids = I.image_token_layout(h, w, ours, MMTok())
    assert ids == J.image_token_layout(h, w, theirs, MMTok())
    s = ours.spatial_merge_size
    assert ids.count(10) == (h // (8 * s)) * (w // (8 * s)) and ids[-1] == 13


def test_image_token_layout_grid():
    assert I.image_token_layout(16, 24, both_args()[0], MMTok()) == [10, 10, 10, 12, 10, 10,
                                                                     10, 13]
    with pytest.raises(ValueError, match="multiples"):
        I.image_token_layout(12, 24, both_args()[0], MMTok())


def test_encode_user_content_matches_jax():
    rng = np.random.default_rng(0)
    chunks = ["hi", rng.integers(0, 256, (8, 16, 3), np.uint8), "and",
              rng.integers(0, 256, (30, 20, 3), np.uint8), "bye"]
    ours, theirs = both_args()
    ids, ims = I.encode_user_content(MMTok(), ours, chunks)
    jids, jims = J.encode_user_content(MMTok(), theirs, chunks)
    assert ids == jids and len(ims) == len(jims) == 2
    assert ims[0].shape == (3, 8, 16)
    for a, b in zip(ims, jims):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_decode_image_payload_matches_jax(tmp_path):
    from PIL import Image

    raw = np.random.default_rng(2).integers(0, 256, (9, 7, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(raw).save(buf, format="PNG")
    b64 = base64.b64encode(buf.getvalue()).decode()
    path = tmp_path / "im.png"
    path.write_bytes(buf.getvalue())
    for payload in (b64, "data:image/png;base64," + b64, str(path), raw.tolist()):
        ours = np.asarray(I.decode_image_payload(payload))
        np.testing.assert_array_equal(ours, np.asarray(J.decode_image_payload(payload)))
        np.testing.assert_array_equal(I._to_rgb_array(I.decode_image_payload(payload)), raw)
