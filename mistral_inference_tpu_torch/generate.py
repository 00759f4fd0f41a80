"""Batched generation: chunked prefill, then decode in blocks (counterpart of
``mistral_inference_tpu/generate.py``).

Returns ``(generated_tokens, logprobs)`` where the logprobs of a row are its
teacher-forced prompt transitions followed by one entry per generated token.
Decode runs ``decode_block`` steps between host syncs: the step loop keeps
tokens and logprobs on the device and the host reads them once per block.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mistral_inference_tpu_torch.model import Transformer
from mistral_inference_tpu_torch.models import transformer as tf

DEFAULT_TOP_P = 0.8  # the reference's decode loop uses top_p = 0.8


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def sample(
    prelogits: torch.Tensor,  # (B, V)
    temperature: float,
    top_p: float,
    generator: Optional[torch.Generator],
) -> torch.Tensor:
    """Greedy when temperature <= 0, else temperature-scaled top-p sampling
    drawn from ``generator``. Returns (B,) int64."""
    if temperature <= 0:
        return prelogits.argmax(dim=-1)
    probs = torch.softmax(prelogits.float() / temperature, dim=-1)
    return sample_top_p(probs, top_p, generator)


def _nucleus_threshold(probs: torch.Tensor, p: float) -> torch.Tensor:
    """The largest float t whose strictly-above mass sum(probs[probs > t])
    still exceeds p, found without a sort by a 31-step radix search on the
    fp32 bit pattern (int32 order is float order for non-negative floats;
    bit 31, the sign, is never set). The kept set {probs > t} is the nucleus,
    with tie groups at its edge kept whole. Returns (..., 1) fp32."""
    t = torch.zeros(probs.shape[:-1] + (1,), dtype=torch.int32, device=probs.device)
    for bit in range(30, -1, -1):
        cand = t | (1 << bit)
        above = torch.where(probs > cand.view(torch.float32), probs, 0.0).sum(-1, keepdim=True)
        t = torch.where(above > p, cand, t)
    return t.view(torch.float32)


def top_p_probs(probs: torch.Tensor, p: float) -> torch.Tensor:
    """The renormalized nucleus distribution (highest-probability tokens
    with cumulative mass > p kept, the rest zeroed)."""
    probs = probs.float()
    filtered = torch.where(probs > _nucleus_threshold(probs, p), probs, 0.0)
    return filtered / filtered.sum(-1, keepdim=True)


def sample_top_p(
    probs: torch.Tensor, p: float, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """Nucleus sampling from ``generator``. Returns (B,) int64."""
    probs = probs.float()
    filtered = torch.where(probs > _nucleus_threshold(probs, p), probs, 0.0)
    return torch.multinomial(filtered, 1, generator=generator)[:, 0]


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def _prefill_step(
    model: Transformer,
    tokens: torch.Tensor,  # (B, T)
    seqlens: torch.Tensor,  # (B,)
    cache,
    carry: torch.Tensor,  # (B, V) previous chunk's last prelogits
    attend_cache: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One prompt chunk. Returns (teacher-forced logprobs (B, T), each row's
    last valid prelogits, carried over when the row has no token here)."""
    hidden = model.forward(tokens, seqlens, cache, attend_cache, head="none")
    B = hidden.shape[0]
    rows = torch.arange(B, device=hidden.device)
    last = tf.output_head(model.params, hidden[rows, (seqlens - 1).clamp_min(0).long()])
    last = torch.where((seqlens > 0)[:, None], last, carry)
    logprobs = _sliced_teacher_logprobs(
        hidden, tokens, carry, lambda h: tf.output_head(model.params, h)
    )
    return logprobs, last


def _sliced_teacher_logprobs(hidden, tokens, carry, head_fp32, TS: int = 64):
    """log P(tokens[t] | ... t-1) from final-norm hidden states, with the
    vocab head applied ``TS`` positions at a time, so no (B, T, V) fp32
    tensor exists. Slice boundaries carry the previous slice's last row."""
    T = hidden.shape[1]
    TS = min(T, TS)
    last, out = carry, []
    for s in range(0, T, TS):
        pl = head_fp32(hidden[:, s : s + TS])  # (B, ts, V)
        prev = torch.cat([last[:, None, :], pl[:, :-1, :]], dim=1)
        tok = tokens[:, s : s + TS, None].long()
        out.append(F.log_softmax(prev, dim=-1).gather(-1, tok)[..., 0])
        last = pl[:, -1, :]
    return torch.cat(out, dim=1)


def _decode_block(
    model: Transformer,
    prelogits: torch.Tensor,  # (B, V)
    cache,
    n_steps: int,
    temperature: float,
    top_p: float,
    generator: Optional[torch.Generator],
) -> Tuple[np.ndarray, np.ndarray, torch.Tensor]:
    """n_steps of [sample -> logprob -> forward]; tokens and logprobs stay
    on the device until the one host sync at the end of the block.
    Returns (tokens (n, B), logprobs (n, B), the last prelogits)."""
    B = prelogits.shape[0]
    ones = torch.ones((B,), dtype=torch.int32, device=prelogits.device)
    toks, lps = [], []
    for _ in range(n_steps):
        tok = sample(prelogits, temperature, top_p, generator)
        lps.append(F.log_softmax(prelogits, dim=-1).gather(-1, tok[:, None])[:, 0])
        toks.append(tok)
        prelogits = model.forward(tok[:, None], ones, cache, attend_cache=True)[:, 0]
    return (
        torch.stack(toks).cpu().numpy(),
        torch.stack(lps).cpu().numpy(),
        prelogits,
    )


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


@torch.inference_mode()
def generate(
    encoded_prompts: Sequence[Sequence[int]],
    model: Transformer,
    images: Sequence[Sequence[np.ndarray]] = (),
    *,
    max_tokens: int,
    temperature: float,
    chunk_size: Optional[int] = None,
    eos_id: Optional[int] = None,
    seed: int = 0,
    decode_block: int = 32,
    top_p: float = DEFAULT_TOP_P,
    draft_model: Optional[Transformer] = None,
) -> Tuple[List[List[int]], List[List[float]]]:
    """Generate on the model's device (the card unless the model was made
    with ``device="cpu"``). Returns (generated tokens per row, logprobs per
    row): seqlen - 1 teacher-forced prompt transitions, then one entry per
    generated token. Sampling draws from a ``torch.Generator`` seeded with
    ``seed``, so a seed fixes the tokens on one device."""
    if draft_model is not None:
        raise NotImplementedError("speculative decoding is not ported yet")
    if any(len(im) > 0 for im in images):
        raise NotImplementedError("image inputs are not ported yet")
    B = len(encoded_prompts)
    if B == 0:
        raise ValueError("no prompts")
    seqlens = [len(p) for p in encoded_prompts]
    if min(seqlens) <= 0:
        raise ValueError("every prompt needs at least one token")
    V = model.args.vocab_size
    if any(not 0 <= t < V for p in encoded_prompts for t in p):
        raise ValueError(f"prompt token id out of range [0, {V})")
    max_prompt_len = max(seqlens)
    device = model.device

    cache = model.alloc_cache(B, max_prompt_len + max_tokens)
    if chunk_size is None:
        chunk_size = max_prompt_len

    logprobs: List[List[float]] = [[] for _ in range(B)]
    carry = torch.zeros((B, V), dtype=torch.float32, device=device)
    for s in range(0, max_prompt_len, chunk_size):
        first = s == 0
        chunk_lens = np.array([min(max(n - s, 0), chunk_size) for n in seqlens], np.int32)
        chunk_tok = np.zeros((B, chunk_size), np.int64)
        for i, p in enumerate(encoded_prompts):
            row = p[s : s + chunk_size]
            chunk_tok[i, : len(row)] = row
        lp_d, carry = _prefill_step(
            model, torch.from_numpy(chunk_tok).to(device),
            torch.from_numpy(chunk_lens).to(device), cache, carry, attend_cache=not first,
        )
        lp = lp_d.cpu().numpy()
        for i in range(B):
            n = int(chunk_lens[i])
            if n:
                logprobs[i].extend(lp[i, (1 if first else 0) : n].tolist())

    generator = torch.Generator(device=device).manual_seed(seed)
    generated: List[List[int]] = [[] for _ in range(B)]
    is_finished = np.zeros((B,), bool)
    done = 0
    while done < max_tokens:
        n = max_tokens - done if eos_id is None else min(decode_block, max_tokens - done)
        toks, lps, carry = _decode_block(model, carry, cache, n, temperature, top_p, generator)
        stop = False
        for t in range(n):
            if eos_id is not None:
                is_finished |= toks[t] == eos_id
                if is_finished.all():
                    stop = True
                    break
            for i in range(B):
                generated[i].append(int(toks[t, i]))
                logprobs[i].append(float(lps[t, i]))
        done += n
        if stop:
            break
    return generated, logprobs
