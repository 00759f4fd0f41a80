"""The plain reference of a Mistral-family configuration: the published
decoder (Mistral-7B, Mixtral-8x7B) written out in plain PyTorch, float32,
TF32 off, over whole sequences, with no kernel, no cache and no batching.

It imports nothing of the program. It takes the benchmark's weights as drawn
(``weights.py``) and works out what the configuration states from them with
its own code: the grouped int4 (or int8) weights, the KV ring's contents
(each token's K after RoPE and its V rounded through the ring's element
type with one scale per token and KV head, which is what every later query
reads), and the routing (top-k of the router's logits, softmax over the
chosen ones).

Departures from the published description: none in the function; the
weights are random and the ring and the weights are quantized as the
configuration's ``assumed`` entry states.

``control`` computes the same one precision below what the configuration
states, where a later change might be tempted to step: "activations_fp8"
rounds every linear's input to float8 e4m3 (one scale a row) below the
activations' bfloat16.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from perfbench import weights as W

FP8_MAX = 448.0


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dequant_grouped(w: torch.Tensor, bits: int, group: int, axis: int) -> torch.Tensor:
    """Symmetric grouped quantization along ``axis`` (the input axis), one
    scale per group of ``group`` inputs and output: scale = max|w| / qmax
    (at least 1e-8), q = round half to even of w / scale, clipped to
    [-qmax, qmax]; returns q * scale in float32."""
    qmax = 7.0 if bits == 4 else 127.0
    w = w.float().movedim(axis, -1)
    K = w.shape[-1]
    g = min(group, K)
    wg = w.reshape(*w.shape[:-1], K // g, g)
    amax = wg.abs().amax(dim=-1, keepdim=True)
    scale = (amax / torch.full_like(amax, qmax)).clamp_min(1e-8)
    q = torch.round(wg / scale).clamp(-qmax, qmax)
    return (q * scale).reshape(w.shape).movedim(-1, axis)


def ring_round(x: torch.Tensor, kind: str) -> torch.Tensor:
    """(..., Dh) through the ring's element type with one scale per
    (token, head): float8 e4m3 (scale max|x| / 448, round to nearest even)
    or int8 (max|x| / 127, round half to even, clip); bf16 rounds alone."""
    if kind == "bf16":
        return x.to(torch.bfloat16).float()
    qmax = {"fp8": FP8_MAX, "int8": 127.0}[kind]
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = (amax / torch.full_like(amax, qmax)).clamp_min(1e-8)
    y = x / scale
    if kind == "fp8":
        y = y.to(torch.float8_e4m3fn).float()
    else:
        y = torch.round(y).clamp(-qmax, qmax)
    return y * scale


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """The control's activation rounding: each row through float8 e4m3 with
    one scale (max|row| / 448)."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = (amax / torch.full_like(amax, FP8_MAX)).clamp_min(1e-12)
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of (T, H, Dh) at positions 0..T-1, adjacent pairs
    (2i, 2i + 1) rotated by pos * theta ** (-2i / Dh); angles in float64."""
    T, _, Dh = x.shape
    inv = theta ** (-torch.arange(0, Dh, 2, dtype=torch.float64, device=x.device) / Dh)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang).float()[:, None, :], torch.sin(ang).float()[:, None, :]
    a, b = x[..., 0::2], x[..., 1::2]
    out = torch.empty_like(x)
    out[..., 0::2] = a * cos - b * sin
    out[..., 1::2] = a * sin + b * cos
    return out


def attention(q, k, v, window, block: int = 512) -> torch.Tensor:
    """Causal GQA attention with a sliding window (key j visible to query i
    iff 0 <= i - j < window), softmax in float32, queries in blocks.
    q (T, H, Dh), k and v (T, Hkv, Dh) -> (T, H Dh)."""
    T, H, Dh = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    kk = k.repeat_interleave(G, dim=1).transpose(0, 1)  # (H, T, Dh)
    vv = v.repeat_interleave(G, dim=1).transpose(0, 1)
    pos = torch.arange(T, device=q.device)
    out = torch.empty((T, H, Dh), dtype=torch.float32, device=q.device)
    for s in range(0, T, block):
        e = min(T, s + block)
        lo = 0 if window is None else max(0, s - window + 1)
        sc = torch.einsum("thd,hsd->hts", q[s:e], kk[:, lo:e]) / math.sqrt(Dh)
        delta = pos[s:e, None] - pos[None, lo:e]
        ok = delta >= 0
        if window is not None:
            ok &= delta < window
        sc = sc.masked_fill(~ok[None], float("-inf"))
        out[s:e] = torch.einsum("hts,hsd->thd", torch.softmax(sc, dim=-1), vv[:, lo:e])
    return out.reshape(T, H * Dh)


def _moe(x, lw, d: W.Dims, act) -> torch.Tensor:
    logits = act(x) @ lw["gate"].float().t()  # (T, E)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    wts = torch.softmax(vals[:, :d.top_k], dim=-1)
    idx = idx[:, :d.top_k]
    out = torch.zeros_like(x)
    for e in range(d.experts):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        w13 = dequant_grouped(lw["w13"][e], d.quant_bits, d.group, axis=0)  # (D, 2F)
        w2 = dequant_grouped(lw["w2"][e], d.quant_bits, d.group, axis=0)  # (F, D)
        h13 = act(x[rows]) @ w13
        g, u = h13.chunk(2, dim=-1)
        y = act(torch.nn.functional.silu(g) * u) @ w2
        out.index_add_(0, rows, y * wts[rows, slot][:, None])
    return out


def logits(config: Dict, seed: int, seqs: Sequence[Tuple[List[int], int]], device,
           control: Optional[str] = None) -> List[torch.Tensor]:
    """For each (tokens, first) the float32 logits (len - first, V) at
    positions first .. len - 1 of ``tokens``: what predicts tokens[first + 1]
    and on; with ``control`` ("activations_fp8") the control's."""
    if control not in (None, "activations_fp8"):
        raise ValueError(f"unknown control {control!r}")
    _no_tf32()
    d = W.dims(config)
    act = fp8_rows if control == "activations_fp8" else (lambda t: t)
    emb = W.embeddings(d, seed, device)
    hs = [emb[torch.tensor(t, device=device)].float() for t, _ in seqs]
    del emb
    Hq, Hkv, Dh = d.n_heads, d.n_kv_heads, d.head_dim
    for li in range(d.n_layers):
        lw = W.layer(d, seed, li, device)
        wqkv = dequant_grouped(lw["wqkv"], d.quant_bits, d.group, axis=1)  # (out, in)
        wo = dequant_grouped(lw["wo"], d.quant_bits, d.group, axis=1)
        if not d.experts:
            w13 = dequant_grouped(lw["w13"], d.quant_bits, d.group, axis=1)
            w2 = dequant_grouped(lw["w2"], d.quant_bits, d.group, axis=1)
        for i, h in enumerate(hs):
            T = h.shape[0]
            x = rms_norm(h, d.norm_eps)
            qkv = act(x) @ wqkv.t()
            q, k, v = qkv.split([Hq * Dh, Hkv * Dh, Hkv * Dh], dim=-1)
            q = rope(q.reshape(T, Hq, Dh), d.rope_theta)
            k = ring_round(rope(k.reshape(T, Hkv, Dh), d.rope_theta), d.kv_quant)
            v = ring_round(v.reshape(T, Hkv, Dh), d.kv_quant)
            h = h + act(attention(q, k, v, d.window)) @ wo.t()
            x = rms_norm(h, d.norm_eps)
            if d.experts:
                h = h + _moe(x, lw, d, act)
            else:
                g, u = (act(x) @ w13.t()).chunk(2, dim=-1)
                h = h + act(torch.nn.functional.silu(g) * u) @ w2.t()
            hs[i] = h
        del lw
        if d.experts == 0:
            del w13, w2
    out_w = W.head(d, seed, device).float()
    res = []
    for (toks, first), h in zip(seqs, hs):
        res.append(act(rms_norm(h[first:], d.norm_eps)) @ out_w.t())
    return res
