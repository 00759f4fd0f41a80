"""Batched generation: chunked prefill, then decode in blocks (counterpart of
``mistral_inference_tpu/generate.py``), for a ``Transformer`` (``generate``)
and a ``Mamba`` (``generate_mamba``).

Returns ``(generated_tokens, logprobs)`` where the logprobs of a row are its
teacher-forced prompt transitions followed by one entry per generated token.
Decode runs ``decode_block`` steps between host syncs: the step loop keeps
tokens and logprobs on the device and the host reads them once per block.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from mistral_inference_tpu_torch.model import Mamba, Transformer
from mistral_inference_tpu_torch.models import mamba as mm

DEFAULT_TOP_P = 0.8  # the reference's decode loop uses top_p = 0.8


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


TopP = Union[float, torch.Tensor]  # one nucleus size, or one per row (B,)


def sample(
    prelogits: torch.Tensor,  # (B, V)
    temperature: Union[float, torch.Tensor],  # one, or one per row (B,)
    top_p: TopP,
    generator: Optional[torch.Generator],
) -> torch.Tensor:
    """Greedy when temperature <= 0, else temperature-scaled top-p sampling
    drawn from ``generator``. Returns (B,) int64.

    A (B,) ``temperature`` mixes the two in one batch, as the serving engine
    does: rows at <= 0 take the argmax, the others sample with their own
    temperature and nucleus (``top_p`` a float or (B,)). The caller that
    knows every row is greedy passes the float 0 instead, and no sampler
    runs (the JAX package makes that choice on the device with lax.cond)."""
    if not isinstance(temperature, torch.Tensor):
        if temperature <= 0:
            return prelogits.argmax(dim=-1)
        probs = torch.softmax(prelogits.float() / temperature, dim=-1)
        return sample_top_p(probs, top_p, generator)
    greedy = prelogits.argmax(dim=-1)
    # A row with a non-finite logit (which the engine fails on from its
    # logprob) samples from a uniform row instead of stopping the sampler.
    x = prelogits.float()
    x = torch.where(torch.isfinite(x).all(-1, keepdim=True), x, 0.0)
    temp = temperature.float().clamp_min(1e-6)[:, None]
    sampled = sample_top_p(torch.softmax(x / temp, dim=-1), top_p, generator)
    return torch.where(temperature > 0, sampled, greedy)


def _p_col(p: TopP, probs: torch.Tensor) -> TopP:
    """top_p as something that broadcasts against (..., 1) sums: a float
    stays one; a (B,) tensor of per-row nucleus sizes gains trailing axes."""
    if isinstance(p, (int, float)):
        return float(p)
    return p.float().reshape(probs.shape[0], *([1] * (probs.dim() - 1)))


def _nucleus_threshold(probs: torch.Tensor, p: TopP) -> torch.Tensor:
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


def top_p_probs(probs: torch.Tensor, p: TopP) -> torch.Tensor:
    """The renormalized nucleus distribution (highest-probability tokens
    with cumulative mass > p kept, the rest zeroed). Exposed apart from
    sampling because speculative rejection sampling needs the filtered
    distributions of both models, not just a draw. ``p`` is a float or a
    (B,) tensor, one nucleus size per row of ``probs`` (B, ..., V)."""
    probs = probs.float()
    filtered = torch.where(probs > _nucleus_threshold(probs, _p_col(p, probs)), probs, 0.0)
    return filtered / filtered.sum(-1, keepdim=True)


def sample_top_p(
    probs: torch.Tensor, p: TopP, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """Nucleus sampling from ``generator``, ``p`` a float or (B,) one per
    row. Returns (B,) int64."""
    probs = probs.float()
    filtered = torch.where(probs > _nucleus_threshold(probs, _p_col(p, probs)), probs, 0.0)
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
    want_logprobs: bool = True,
    input_embeds: Optional[torch.Tensor] = None,  # (B, T, D) for a multimodal chunk
    pad_rows: int = 0,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """One prompt chunk. Returns (teacher-forced logprobs (B, T), or None
    without ``want_logprobs``; each row's last valid prelogits, carried over
    when the row has no token here). The plain products whose kernel cuBLAS
    picks by the row count, the head's and the MoE router's, run on rows
    zero-padded to ``pad_rows`` where B is fewer: a caller whose chunks
    hold fewer and fewer rows keeps them at one shape, so a row's prelogits
    and logprobs do not depend on how many rows its chunk holds."""
    B, T = tokens.shape
    pad = max(0, pad_rows - B)
    hidden = model.forward(tokens, seqlens, cache, attend_cache, head="none",
                           input_embeds=input_embeds,
                           router_rows=pad_rows * T if pad else None)

    def padded(t: torch.Tensor) -> torch.Tensor:  # (B, ...) -> (B + pad, ...)
        return F.pad(t, (0, 0) * (t.dim() - 1) + (0, pad)) if pad else t

    rows = torch.arange(B, device=hidden.device)
    last = model.head(padded(hidden[rows, (seqlens - 1).clamp_min(0).long()]))[:B]
    last = torch.where((seqlens > 0)[:, None], last, carry)
    if not want_logprobs:
        return None, last
    logprobs = _sliced_teacher_logprobs(
        padded(hidden), padded(tokens), padded(carry), model.head
    )
    return logprobs[:B], last


def prefill_prompts(
    model: Transformer,
    encoded_prompts: Sequence[Sequence[int]],
    cache,
    chunk_size: Optional[int],
    want_logprobs: bool = True,
    input_embeds: Optional[torch.Tensor] = None,
) -> Tuple[List[List[float]], torch.Tensor]:
    """Chunked prefill of ragged prompts into ``cache`` (in place). Returns
    (per-row teacher-forced logprobs, seqlen - 1 each, empty lists without
    ``want_logprobs``; each row's prelogits after its last prompt token).
    ``generate`` and the speculative generators share it; a draft model
    prefills without logprobs. ``input_embeds`` (B, max prompt length, D),
    the multimodal embeddings of the whole prompts, is sliced per chunk and
    zero-padded like the tokens."""
    B = len(encoded_prompts)
    logprobs: List[List[float]] = [[] for _ in range(B)]
    carry = torch.zeros((B, model.args.vocab_size), dtype=torch.float32, device=model.device)
    for s, tokens, chunk_lens in _prompt_chunks(encoded_prompts, chunk_size, model.device):
        embeds = None
        if input_embeds is not None:
            T = tokens.shape[1]
            embeds = input_embeds[:, s : s + T]
            embeds = F.pad(embeds, (0, 0, 0, T - embeds.shape[1]))
        lp_d, carry = _prefill_step(
            model, tokens, chunk_lens, cache, carry, attend_cache=s > 0,
            want_logprobs=want_logprobs, input_embeds=embeds,
        )
        if want_logprobs:
            _extend_logprobs(logprobs, lp_d, chunk_lens, s == 0)
    return logprobs, carry


def _prompt_chunks(encoded_prompts: Sequence[Sequence[int]], chunk_size: Optional[int], device):
    """The prompts cut into chunks of ``chunk_size`` (the longest prompt when
    None), each padded to (B, chunk_size): yields (the chunk's first position,
    tokens, valid tokens per row (B,) int32), on ``device``."""
    seqlens = [len(p) for p in encoded_prompts]
    max_prompt_len = max(seqlens)
    if chunk_size is None:
        chunk_size = max_prompt_len
    for s in range(0, max_prompt_len, chunk_size):
        chunk_lens = np.array([min(max(n - s, 0), chunk_size) for n in seqlens], np.int32)
        chunk_tok = np.zeros((len(encoded_prompts), chunk_size), np.int64)
        for i, p in enumerate(encoded_prompts):
            row = p[s : s + chunk_size]
            chunk_tok[i, : len(row)] = row
        tokens, lens = torch.from_numpy(chunk_tok), torch.from_numpy(chunk_lens)
        yield s, tokens.to(device), lens.to(device)


def _extend_logprobs(logprobs: List[List[float]], lp_d: torch.Tensor, chunk_lens: torch.Tensor,
                     first: bool) -> None:
    """Append a chunk's teacher-forced logprobs (B, T) to each row's list:
    its valid positions, less the first prompt token, which has none."""
    lp, lens = lp_d.cpu().numpy(), chunk_lens.cpu().numpy()
    for i, n in enumerate(lens):
        if n:
            logprobs[i].extend(lp[i, (1 if first else 0) : int(n)].tolist())


def check_prompts(encoded_prompts: Sequence[Sequence[int]], vocab_size: int) -> None:
    """Raise on an empty batch, an empty prompt or a token id out of range."""
    if len(encoded_prompts) == 0:
        raise ValueError("no prompts")
    if min(len(p) for p in encoded_prompts) <= 0:
        raise ValueError("every prompt needs at least one token")
    if any(not 0 <= t < vocab_size for p in encoded_prompts for t in p):
        raise ValueError(f"prompt token id out of range [0, {vocab_size})")


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


Step = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _decode_block(
    step: Step,
    prelogits: torch.Tensor,  # (B, V)
    n_steps: int,
    temperature: float,
    top_p: float,
    generator: Optional[torch.Generator],
    temps: Optional[torch.Tensor] = None,
    live: Optional[torch.Tensor] = None,
    top_ps: Optional[torch.Tensor] = None,
    budget: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """n_steps of [sample -> logprob -> ``step``], where ``step(tokens (B,),
    seqlens (B,))`` is one T = 1 forward returning the next prelogits (B,
    V). Returns (tokens (n, B), logprobs (n, B), the last prelogits), all on
    the device: nothing here waits for the card.

    The serving engine's per-row controls, each (B,) on the device:
    ``temps`` and ``top_ps`` replace ``temperature`` and ``top_p`` row by
    row; a row with ``live`` 0 runs with seqlens 0, so it never writes the
    ring and its ``kv_len`` stays (its bytes stay intact for prefix reuse);
    ``budget`` is each row's remaining tokens, and a row freezes in the
    block (seqlens 0 from then on) once the step count reaches it, so a row
    never writes past prompt + max_tokens even when the host's view of it is
    a block stale. ``generate()`` passes none of them: every row is live."""
    B = prelogits.shape[0]
    base = live if live is not None else torch.ones((B,), dtype=torch.int32, device=prelogits.device)
    toks, lps = [], []
    for i in range(n_steps):
        tok = sample(prelogits, temps if temps is not None else temperature,
                     top_ps if top_ps is not None else top_p, generator)
        lps.append(F.log_softmax(prelogits, dim=-1).gather(-1, tok[:, None])[:, 0])
        toks.append(tok)
        seqlens = base if budget is None else base * (budget > i)
        prelogits = step(tok, seqlens)
    return torch.stack(toks), torch.stack(lps), prelogits


def _decode_loop(
    step: Step,
    carry: torch.Tensor,
    logprobs: List[List[float]],
    *,
    max_tokens: int,
    eos_id: Optional[int],
    decode_block: int,
    temperature: float,
    top_p: float,
    seed: int,
) -> Tuple[List[List[int]], List[List[float]]]:
    """Decode blocks from the prefill's ``carry`` until ``max_tokens``, or
    until every row has emitted ``eos_id`` (the step on which the last row
    finishes is not appended). Sampling draws from a ``torch.Generator``
    seeded with ``seed``. Returns (generated tokens, ``logprobs`` extended)."""
    B = len(logprobs)
    generator = torch.Generator(device=carry.device).manual_seed(seed)
    generated: List[List[int]] = [[] for _ in range(B)]
    is_finished = np.zeros((B,), bool)
    done = 0
    while done < max_tokens:
        n = max_tokens - done if eos_id is None else min(decode_block, max_tokens - done)
        toks_d, lps_d, carry = _decode_block(step, carry, n, temperature, top_p, generator)
        toks, lps = toks_d.cpu().numpy(), lps_d.cpu().numpy()
        for t in range(n):
            if eos_id is not None:
                is_finished |= toks[t] == eos_id
                if is_finished.all():
                    return generated, logprobs
            for i in range(B):
                generated[i].append(int(toks[t, i]))
                logprobs[i].append(float(lps[t, i]))
        done += n
    return generated, logprobs


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
    draft_model: Union[Transformer, str, None] = None,
    spec_tokens: int = 4,
) -> Tuple[List[List[int]], List[List[float]]]:
    """Generate on the model's device (the card unless the model was made
    with ``device="cpu"``). Returns (generated tokens per row, logprobs per
    row): seqlen - 1 teacher-forced prompt transitions, then one entry per
    generated token. Sampling draws from a ``torch.Generator`` seeded with
    ``seed``, so a seed fixes the tokens on one device.

    ``images[i]`` holds row i's preprocessed (C, H, W) images, in the order
    of its image tokens (``images.encode_user_content`` lays both out): their
    features are computed once for the whole prompts and replace the image
    tokens' embeddings in the prefill.

    ``draft_model`` switches decoding to speculative decoding
    (``speculative.py``): the same greedy tokens from fewer target forwards.
    A ``Transformer`` drafts ``spec_tokens`` tokens per verify forward; the
    string "lookup" (or "ngram") proposes them from the row's own history,
    with no draft model. It takes no images."""
    has_images = any(len(im) > 0 for im in images)
    if draft_model is not None:
        if has_images:
            raise ValueError("speculative decoding does not take image inputs")
        from mistral_inference_tpu_torch import speculative

        kw = dict(max_tokens=max_tokens, temperature=temperature, spec_tokens=spec_tokens,
                  chunk_size=chunk_size, eos_id=eos_id, seed=seed, top_p=top_p)
        if isinstance(draft_model, str):
            if draft_model not in ("lookup", "ngram"):
                raise ValueError(f"draft_model must be a Transformer, 'lookup' or 'ngram', "
                                 f"got {draft_model!r}")
            return speculative.generate_lookup(encoded_prompts, model, **kw)
        return speculative.generate_speculative(encoded_prompts, model, draft_model, **kw)
    check_prompts(encoded_prompts, model.args.vocab_size)
    B = len(encoded_prompts)
    max_prompt_len = max(len(p) for p in encoded_prompts)

    input_embeds = None
    if has_images:
        from mistral_inference_tpu_torch.models.vision import embed_multimodal

        input_embeds = embed_multimodal(model, encoded_prompts, images)
    cache = model.alloc_cache(B, max_prompt_len + max_tokens)
    logprobs, carry = prefill_prompts(model, encoded_prompts, cache, chunk_size,
                                      input_embeds=input_embeds)
    return _decode_loop(
        lambda tok, seqlens: model.forward(tok[:, None], seqlens, cache, attend_cache=True)[:, 0],
        carry, logprobs, max_tokens=max_tokens, eos_id=eos_id, decode_block=decode_block,
        temperature=temperature, top_p=top_p, seed=seed,
    )


# ---------------------------------------------------------------------------
# Mamba: the same contract, driving the recurrent state of models/mamba.py
# ---------------------------------------------------------------------------


def _mamba_prefill_step(
    model: Mamba,
    tokens: torch.Tensor,  # (B, T)
    seqlens: torch.Tensor,  # (B,)
    state: mm.MambaState,
    carry: torch.Tensor,  # (B, V)
    chunk: int,
    want_logprobs: bool = True,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """One prompt chunk into ``state`` (in place). Returns (teacher-forced
    logprobs (B, T), or None without ``want_logprobs``; each row's last valid
    prelogits, or ``carry`` for a row with no token here)."""
    hidden = model.forward(tokens, seqlens, state, chunk, head="none")
    rows = torch.arange(hidden.shape[0], device=hidden.device)
    last = model.head(hidden[rows, (seqlens - 1).clamp_min(0).long()])
    last = torch.where((seqlens > 0)[:, None], last, carry)
    if not want_logprobs:
        return None, last
    logprobs = _sliced_teacher_logprobs(
        hidden, tokens, carry, model.head
    )
    return logprobs, last


def prefill_mamba(
    model: Mamba, encoded_prompts: Sequence[Sequence[int]], chunk_size: Optional[int]
) -> Tuple[List[List[float]], torch.Tensor, mm.MambaState]:
    """Chunked prefill of ragged prompts into a new state. Returns (per-row
    teacher-forced logprobs, seqlen - 1 each; each row's prelogits after its
    last prompt token; the state). The SSD's own chunk is min(128,
    chunk_size). ``generate_mamba`` and the lookup generator share it."""
    B = len(encoded_prompts)
    state = model.alloc_state(B)
    logprobs: List[List[float]] = [[] for _ in range(B)]
    carry = torch.zeros((B, model.args.vocab_size), dtype=torch.float32, device=model.device)
    for s, tokens, chunk_lens in _prompt_chunks(encoded_prompts, chunk_size, model.device):
        lp_d, carry = _mamba_prefill_step(
            model, tokens, chunk_lens, state, carry, min(mm.DEFAULT_CHUNK, tokens.shape[1])
        )
        _extend_logprobs(logprobs, lp_d, chunk_lens, s == 0)
    return logprobs, carry, state


@torch.inference_mode()
def generate_mamba(
    encoded_prompts: Sequence[Sequence[int]],
    model: Mamba,
    *,
    max_tokens: int,
    temperature: float,
    chunk_size: Optional[int] = None,
    eos_id: Optional[int] = None,
    seed: int = 0,
    decode_block: int = 32,
    top_p: float = DEFAULT_TOP_P,
    draft_model: Optional[str] = None,
    spec_tokens: int = 8,
) -> Tuple[List[List[int]], List[List[float]]]:
    """``generate`` for a Mamba model, with the same output contract: per row
    the generated tokens, and logprobs of seqlen - 1 teacher-forced prompt
    transitions then one per generated token; sampling from a
    ``torch.Generator`` seeded with ``seed``; EOS stops when every row has
    emitted it.

    ``draft_model="lookup"`` (or "ngram") decodes by prompt-lookup
    speculation (``speculative.generate_lookup_mamba``): the same greedy
    tokens from fewer sequential forwards. A Mamba has no draft-model mode:
    a recurrent draft would need a rewind of its own state."""
    if draft_model is not None:
        if draft_model not in ("lookup", "ngram"):
            raise ValueError(f"Mamba speculation is draft-free: draft_model must be 'lookup' or "
                             f"'ngram', got {draft_model!r}")
        from mistral_inference_tpu_torch.speculative import generate_lookup_mamba

        return generate_lookup_mamba(
            encoded_prompts, model, max_tokens=max_tokens, temperature=temperature,
            spec_tokens=spec_tokens, chunk_size=chunk_size, eos_id=eos_id, seed=seed,
            top_p=top_p,
        )
    check_prompts(encoded_prompts, model.args.vocab_size)
    logprobs, carry, state = prefill_mamba(model, encoded_prompts, chunk_size)
    # Each decode step is one T = 1 forward, whose SSD goes through K9.
    return _decode_loop(
        lambda tok, seqlens: model.forward(tok[:, None], seqlens, state, chunk=1)[:, 0],
        carry, logprobs, max_tokens=max_tokens, eos_id=eos_id, decode_block=decode_block,
        temperature=temperature, top_p=top_p, seed=seed,
    )
