"""Pixtral vision encoder and the multimodal embedding merge (counterpart of
``mistral_inference_tpu/models/vision.py``).

An image (C, H, W), its sides multiples of the patch size, becomes one patch
per P x P square through the patch conv, row-major over the (h, w) patch
grid. The patches of one image are padded to a bucket length N
(``_bucket``), normed and run through pre-norm transformer blocks with 2-D
RoPE (each patch rotated by its row and column) and full attention within
the image: ``segment_flash_attention`` (K10 on the card) with segment id 0
for the image's patches and -1 for the padding, whose rows are dropped after
the blocks. An optional pre-projector norm, PatchMerger and a two-layer GELU
adapter carry the features to the decoder's width, and
``embed_multimodal`` puts them, in order, in the slots of the prompt's image
tokens.

Parameters are a plain dict: ``patch_conv`` in torch's (O, I, P, P) layout,
per-layer dicts whose linears are stored (out, in) and applied with
``F.linear``, q | k | v stacked in ``wqkv`` and w1 | w3 in ``w13`` as in the
decoder. The encoder runs once per prompt, not in the decode loop.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from mistral_inference_tpu_torch.args import PATCH_MERGE, VisionEncoderArgs
from mistral_inference_tpu_torch.ops.cuda.attention import segment_flash_attention
from mistral_inference_tpu_torch.ops.norm import rms_norm
from mistral_inference_tpu_torch.ops.rope import apply_rope, precompute_rope_2d

Params = Dict[str, Any]

VISION_NORM_EPS = 1e-5


def init_vision_params(
    args: VisionEncoderArgs,
    lm_dim: int,
    dtype: torch.dtype,
    generator: torch.Generator,
    device: torch.device,
) -> Params:
    """Random weights with the JAX package's distributions: linear and conv
    weights N(0, 1) / sqrt(fan_in), norms 1, adapter biases 0."""
    Dv, F_, C, P = args.hidden_size, args.intermediate_size, args.num_channels, args.patch_size

    def draw(shape, fan_in: int) -> torch.Tensor:
        w = torch.randn(shape, generator=generator, dtype=dtype, device=device)
        return w.mul_(fan_in**-0.5)

    def ones(n: int) -> torch.Tensor:
        return torch.ones((n,), dtype=dtype, device=device)

    params: Params = {
        "patch_conv": draw((Dv, C, P, P), C * P * P),
        "ln_pre": ones(Dv),
        "layers": [
            {
                "attention_norm": ones(Dv),
                "ffn_norm": ones(Dv),
                "wqkv": draw((3 * Dv, Dv), Dv),  # wq, wk, wv stacked on out
                "wo": draw((Dv, Dv), Dv),
                "w13": draw((2 * F_, Dv), Dv),  # w1, w3 stacked on out
                "w2": draw((Dv, F_), F_),
            }
            for _ in range(args.num_hidden_layers)
        ],
        "adapter": {"w_in": {"w": draw((lm_dim, Dv), Dv)},
                    "w_out": {"w": draw((lm_dim, lm_dim), lm_dim)}},
    }
    if args.adapter_bias:
        params["adapter"]["w_in"]["b"] = torch.zeros((lm_dim,), dtype=dtype, device=device)
        params["adapter"]["w_out"]["b"] = torch.zeros((lm_dim,), dtype=dtype, device=device)
    if args.mm_projector_id == PATCH_MERGE:
        s2 = args.spatial_merge_size**2
        params["patch_merger"] = {"w": draw((Dv, Dv * s2), Dv * s2)}
    if args.add_pre_mm_projector_layer_norm:
        params["pre_mm_projector_norm"] = ones(Dv)
    return params


def _vision_blocks(
    params: Params,
    x: torch.Tensor,  # (G, N, Dv) padded patch sequences, one layout for all rows
    cos: torch.Tensor,  # (N, Dh // 2) fp32
    sin: torch.Tensor,
    seg: torch.Tensor,  # (N,) int32 segment ids: an image id, -1 for padding
    args: VisionEncoderArgs,
) -> torch.Tensor:
    """The encoder's pre-norm blocks: attention within each segment, then a
    SwiGLU feed-forward."""
    G, N, Dv = x.shape
    H = args.num_attention_heads
    Dh = Dv // H
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    segs = seg[None].expand(G, N).contiguous()
    for lw in params["layers"]:
        xn = rms_norm(x, lw["attention_norm"], VISION_NORM_EPS)
        q, k, v = F.linear(xn, lw["wqkv"]).split(Dv, dim=-1)
        q = apply_rope(q.view(G, N, H, Dh), cos, sin)
        k = apply_rope(k.view(G, N, H, Dh), cos, sin)
        attn = segment_flash_attention(q, k, v.reshape(G, N, H, Dh).contiguous(), segs)
        x = x + F.linear(attn, lw["wo"])
        gate, up = F.linear(rms_norm(x, lw["ffn_norm"], VISION_NORM_EPS), lw["w13"]).chunk(2, -1)
        x = x + F.linear(F.silu(gate) * up, lw["w2"])
    return x


def _adapter(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Two linears with exact GELU between them, to the decoder's width."""
    w_in, w_out = params["adapter"]["w_in"], params["adapter"]["w_out"]
    h = F.gelu(F.linear(x, w_in["w"], w_in.get("b")), approximate="none")
    return F.linear(h, w_out["w"], w_out.get("b"))


def _patch_merge_one(x: torch.Tensor, h: int, w: int, s: int) -> torch.Tensor:
    """(h w, d) row-major patch grid -> (h/s w/s, d s^2), each merged patch's
    features in the order (d, ki, kj): the layout of torch's unfold."""
    d = x.shape[-1]
    g = x.reshape(h // s, s, w // s, s, d).permute(0, 2, 4, 1, 3)  # (h/s, w/s, d, ki, kj)
    return g.reshape((h // s) * (w // s), d * s * s)


def _bucket(n: int) -> int:
    """Padded sequence length for an n-patch image: the next power of two
    from 64 up to 512, then the next multiple of 512."""
    if n <= 512:
        b = 64
        while b < n:
            b *= 2
        return b
    return -(-n // 512) * 512


def _encode_batch(
    params: Params,
    ims: torch.Tensor,  # (G, C, h P, w P), one size for the group
    cos2d: torch.Tensor,  # (side, side, Dh // 2)
    sin2d: torch.Tensor,
    h: int,
    w: int,
    args: VisionEncoderArgs,
) -> torch.Tensor:
    """Patch conv, bucket padding, the RoPE gather at each patch's (row,
    column), ln_pre and the blocks for G same-size images; returns (G, h w,
    Dv), the padding rows dropped."""
    P = args.patch_size
    G = ims.shape[0]
    patches = F.conv2d(ims, params["patch_conv"], stride=P)  # (G, Dv, h, w)
    n = h * w
    N = _bucket(n)
    flat = F.pad(patches.reshape(G, -1, n).transpose(1, 2), (0, 0, 0, N - n))
    dev = ims.device
    rows = torch.zeros((N,), dtype=torch.long, device=dev)
    cols = torch.zeros((N,), dtype=torch.long, device=dev)
    rows[:n] = torch.arange(h, device=dev).repeat_interleave(w)
    cols[:n] = torch.arange(w, device=dev).repeat(h)
    seg = torch.full((N,), -1, dtype=torch.int32, device=dev)
    seg[:n] = 0
    x = rms_norm(flat, params["ln_pre"], VISION_NORM_EPS)
    out = _vision_blocks(params, x, cos2d[rows, cols], sin2d[rows, cols], seg, args)
    return out[:, :n]


def encode_images(
    params: Params,
    args: VisionEncoderArgs,
    images: Sequence[np.ndarray],  # each (C, H, W), sides multiples of patch_size
    dtype: torch.dtype,
    group_max: int = 1,
) -> torch.Tensor:
    """(total patches, Dv): the encoder's output for every image, in order,
    before merger and adapter. Images never see each other, so each is
    encoded on its own (the reference's one concatenated sequence under a
    block-diagonal mask computes the same); ``group_max`` > 1 batches up to
    that many same-size images into one call."""
    P = args.patch_size
    H = args.num_attention_heads
    dev = params["patch_conv"].device
    side = args.image_size // P
    cos2d, sin2d = precompute_rope_2d(args.hidden_size // H, side, side, args.rope_theta, dev)
    groups: Dict[tuple, List[List[int]]] = {}
    for i, im in enumerate(images):
        key = (im.shape[1] // P, im.shape[2] // P)
        chunks = groups.setdefault(key, [[]])
        if len(chunks[-1]) >= max(1, group_max):
            chunks.append([])
        chunks[-1].append(i)
    outs: List[torch.Tensor] = [None] * len(images)
    for (h, w), chunks in groups.items():
        for idxs in chunks:
            ims = torch.stack([torch.as_tensor(images[i]) for i in idxs]).to(dev, dtype)
            feats = _encode_batch(params, ims, cos2d, sin2d, h, w, args)
            for j, i in enumerate(idxs):
                outs[i] = feats[j]
    return torch.cat(outs, dim=0)


def image_features(
    params: Params,
    args: VisionEncoderArgs,
    images: Sequence[np.ndarray],
    dtype: torch.dtype,
) -> torch.Tensor:
    """The whole vision path: encoder, [pre-projector norm], [PatchMerger],
    adapter. Returns (image tokens, lm_dim)."""
    feats = encode_images(params, args, images, dtype)
    if args.add_pre_mm_projector_layer_norm:
        feats = rms_norm(feats, params["pre_mm_projector_norm"], VISION_NORM_EPS)
    if args.mm_projector_id == PATCH_MERGE:
        s, P = args.spatial_merge_size, args.patch_size
        merged, off = [], 0
        for im in images:
            h, w = im.shape[1] // P, im.shape[2] // P
            merged.append(_patch_merge_one(feats[off : off + h * w], h, w, s))
            off += h * w
        feats = F.linear(torch.cat(merged, dim=0), params["patch_merger"]["w"])
    return _adapter(params, feats)


def embed_multimodal(
    model,  # model.Transformer
    encoded_prompts: Sequence[Sequence[int]],
    images: Sequence[Sequence[np.ndarray]],
) -> torch.Tensor:
    """(B, max prompt length, dim) input embeddings in the model dtype: the
    token embeddings, with the slots of image tokens replaced in order by
    the row's image features, and rows zero-padded past their prompt."""
    vargs = model.args.vision_encoder
    if vargs is None:
        raise ValueError("the model has no vision encoder")
    emb = model.params["tok_embeddings"]
    max_len = max(len(p) for p in encoded_prompts)
    rows = []
    for i, prompt in enumerate(encoded_prompts):
        toks = np.asarray(prompt, np.int64)
        row = F.embedding(torch.from_numpy(toks).to(emb.device), emb).float()
        slots = np.nonzero(toks == vargs.image_token_id)[0]
        if len(slots):
            row_images = images[i] if i < len(images) else ()
            if not row_images:
                raise ValueError(f"row {i}: {len(slots)} image tokens but no image")
            feats = image_features(model.params["vision"], vargs, row_images, model.dtype)
            if feats.shape[0] != len(slots):
                raise ValueError(
                    f"row {i}: {len(slots)} image tokens vs {feats.shape[0]} image features")
            row[torch.from_numpy(slots).to(emb.device)] = feats.float()
        rows.append(F.pad(row, (0, 0, 0, max_len - len(prompt))))
    return torch.stack(rows).to(model.dtype)
