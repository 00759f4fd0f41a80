"""Image preprocessing and the multimodal token layout, host code
(counterpart of ``mistral_inference_tpu/images.py``).

* ``preprocess_image``: a PIL image or an array -> normalized float32
  (3, H, W) whose sides are multiples of ``patch_size * spatial_merge_size``
  and whose longest edge is at most ``image_size``: scaled down by
  ``ratio = max(h, w) / longest_edge`` when above 1 (floor), each side then
  rounded up to the next multiple, resampled bicubic (PIL; a numpy bilinear
  fallback without it), scaled by 1/255 and normalized with the CLIP
  dataset mean and std.
* ``image_token_layout``: the [IMG] / [IMG_BREAK] / [IMG_END] grid: each row
  of the (merged-)patch grid is ``ncols`` [IMG] tokens and an [IMG_BREAK],
  the last row ending with [IMG_END] instead.
* ``encode_user_content``: text and image chunks of one user message ->
  (token ids, preprocessed images), interleaved in order.

The token helpers take any tokenizer object with ``.special(name)`` and
``.encode(text, bos=..., eos=...)``.
"""

from __future__ import annotations

import base64
import io
import math
import os
from typing import Any, List, Sequence, Tuple

import numpy as np

from mistral_inference_tpu_torch.args import VisionEncoderArgs

# CLIP dataset statistics — the normalization constants every Pixtral-family
# checkpoint was trained with (mistral-common contract).
DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
DATASET_STD = (0.26862954, 0.26130258, 0.27577711)


def _to_rgb_array(image: Any) -> np.ndarray:
    """PIL image | (H, W, 3) uint8/float array | (3, H, W) array → (H, W, 3)
    uint8."""
    try:
        from PIL import Image  # noqa: PLC0415

        if isinstance(image, Image.Image):
            return np.asarray(image.convert("RGB"))
    except ImportError:
        pass
    arr = np.asarray(image)
    if arr.ndim == 3 and arr.shape[0] == 3 and arr.shape[-1] != 3:
        arr = arr.transpose(1, 2, 0)
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"bad image shape {arr.shape}")
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    return arr


def target_size(
    h: int, w: int, patch_size: int, longest_edge: int, spatial_merge_size: int = 1
) -> Tuple[int, int]:
    """Output (H, W): longest edge capped (floor), then rounded UP to
    multiples of patch_size·spatial_merge_size so the token grid is exact."""
    m = patch_size * spatial_merge_size
    ratio = max(h / longest_edge, w / longest_edge)
    if ratio > 1:
        h = int(math.floor(h / ratio))
        w = int(math.floor(w / ratio))
    th = ((max(h, 1) - 1) // m + 1) * m
    tw = ((max(w, 1) - 1) // m + 1) * m
    return th, tw


def _resize(arr: np.ndarray, th: int, tw: int) -> np.ndarray:
    """(H, W, 3) uint8 → (th, tw, 3) float32 in [0, 255]; bicubic via PIL
    when available, else a numpy bilinear fallback."""
    h, w = arr.shape[:2]
    if (h, w) == (th, tw):
        return arr.astype(np.float32)
    try:
        from PIL import Image  # noqa: PLC0415

        im = Image.fromarray(arr).resize((tw, th), Image.BICUBIC)
        return np.asarray(im, np.float32)
    except ImportError:
        ys = np.linspace(0, h - 1, th)
        xs = np.linspace(0, w - 1, tw)
        y0 = np.floor(ys).astype(int)
        x0 = np.floor(xs).astype(int)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        fy = (ys - y0)[:, None, None]
        fx = (xs - x0)[None, :, None]
        a = arr.astype(np.float32)
        top = a[y0][:, x0] * (1 - fx) + a[y0][:, x1] * fx
        bot = a[y1][:, x0] * (1 - fx) + a[y1][:, x1] * fx
        return top * (1 - fy) + bot * fy


def preprocess_image(image: Any, vargs: VisionEncoderArgs) -> np.ndarray:
    """Any image input → normalized float32 (3, H, W) ready for the
    encoder, sides multiples of patch_size (·spatial_merge_size)."""
    arr = _to_rgb_array(image)
    th, tw = target_size(
        arr.shape[0],
        arr.shape[1],
        vargs.patch_size,
        vargs.image_size,
        max(vargs.spatial_merge_size, 1),
    )
    out = _resize(arr, th, tw) / 255.0
    out = (out - np.asarray(DATASET_MEAN, np.float32)) / np.asarray(
        DATASET_STD, np.float32
    )
    return out.transpose(2, 0, 1).astype(np.float32)


def image_token_layout(
    h: int, w: int, vargs: VisionEncoderArgs, tok
) -> List[int]:
    """Token ids spanning one preprocessed (3, h, w) image: per merged-patch
    row, ncols [IMG] then [IMG_BREAK]; the last row ends with [IMG_END]
    (mistral-common's multimodal chat layout; the count must equal the
    number of vision features scattered by models/vision.embed_multimodal)."""
    s = max(vargs.spatial_merge_size, 1)
    m = vargs.patch_size * s
    if h % m or w % m:
        raise ValueError(f"image sides ({h}, {w}) must be multiples of {m}")
    nrows, ncols = h // m, w // m
    img = tok.special("[IMG]")
    brk = tok.special("[IMG_BREAK]")
    end = tok.special("[IMG_END]")
    ids: List[int] = []
    for r in range(nrows):
        ids.extend([img] * ncols)
        ids.append(end if r == nrows - 1 else brk)
    return ids


def decode_image_payload(payload: Any) -> Any:
    """A request's image: a base64 string or data URL, a local file path,
    or a nested-list array. Nothing is fetched over the network."""
    if isinstance(payload, list):
        return np.asarray(payload)
    if not isinstance(payload, str):
        raise TypeError(f"unsupported image payload {type(payload)}")
    if payload.startswith("data:"):
        payload = payload.split(",", 1)[1]
    if os.path.exists(payload):
        from PIL import Image  # noqa: PLC0415

        return Image.open(payload)
    raw = base64.b64decode(payload)
    from PIL import Image  # noqa: PLC0415

    return Image.open(io.BytesIO(raw))


def encode_user_content(
    tok, vargs: VisionEncoderArgs, chunks: Sequence[Any]
) -> Tuple[List[int], List[np.ndarray]]:
    """One user message's content chunks → (token ids, preprocessed images).

    A chunk is a plain string (text) or an image in any form
    ``_to_rgb_array``/``decode_image_payload`` accepts. Images are encoded
    in place, interleaved with the text in input order."""
    ids: List[int] = []
    images: List[np.ndarray] = []
    for chunk in chunks:
        if isinstance(chunk, str):
            ids.extend(tok.encode(chunk, bos=False, eos=False))
        else:
            arr = preprocess_image(chunk, vargs)
            images.append(arr)
            ids.extend(image_token_layout(arr.shape[1], arr.shape[2], vargs, tok))
    return ids, images
