"""Speculative decoding: draft-model speculation and draft-free prompt
lookup, with exact greedy verify (counterpart of
``mistral_inference_tpu/speculative.py``); for a Mamba model, prompt lookup
(``generate_lookup_mamba``, at the end).

A verify forward over K + 1 tokens costs the host about what one decode
step costs and emits up to K + 1 tokens.

  Loop invariant: both caches hold tokens [0 .. n - 1]; ``t0`` is token n,
  known correct, its K/V not yet in either cache.

  1. Draft: forward t0, then K single-token steps on the draft model (its
     normal writing decode path) -> drafts d_1 .. d_K. The lookup variant
     proposes them from the row's own token history instead.
  2. Verify: one target forward over the (B, K + 1) chunk [t0, d_1 .. d_K].
     Wrap-safe route: ``write_cache=False``, which attends [ring ++ chunk]
     like a prefill chunk, leaves the ring untouched and returns the chunk's
     per-layer K/V. Fused route (``_spec_fused_ok``, a ring that can never
     wrap): ``write_cache="spec"``, which writes all K + 1 candidates into
     the ring and attends ring-only in one kernel
     (``fused_verify_chunk_attention``).
  3. Accept: a = longest prefix with d_{j+1} == argmax(target logits_j).
     Emit [d_1 .. d_a, g_a], where g_a is the target's own next token (the
     "bonus" token), so every iteration emits at least one token and the
     output equals plain greedy decoding exactly.
  4. Commit: wrap-safe route, ``cache.scatter_chunk`` writes K/V for
     [t0, d_1 .. d_a] only, so rejected drafts never touch the target ring;
     fused route, ``cache.rewind`` moves ``kv_len`` past the accepted prefix
     and the rejected slots stay hidden until they are overwritten.
  5. Rewind the draft cache to n + a + 1. The draft wrote speculatively, so
     this is only safe on a ring that never wraps: ``generate_speculative``
     allocates the draft cache full-context and refuses a draft model with a
     smaller sliding window.

temperature == 0 gives the tokens of plain greedy ``generate()``;
temperature > 0 uses Leviathan rejection sampling against both models'
nucleus-filtered distributions: lossless (exactly the target's sampling
distribution), fixed per seed, on another random stream than ``generate()``'s.

Where the JAX package runs a block of iterations as one compiled scan, the
block here is a Python loop of ``n_iters`` iterations with fixed shapes and
no host sync inside: accept lengths stay on the device (masks, ``cumprod``,
``gather``, ``where``), and the host reads (emits, logprobs, accepts) once per
block. Every draw takes an explicit ``torch.Generator``. The caches are
updated in place.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from mistral_inference_tpu_torch.cache import KVCache, rewind, scatter_chunk
from mistral_inference_tpu_torch.generate import (
    DEFAULT_TOP_P,
    TopP,
    check_prompts,
    prefill_mamba,
    prefill_prompts,
    sample,
    top_p_probs,
)
from mistral_inference_tpu_torch.model import Mamba, Transformer
from mistral_inference_tpu_torch.models.mamba import MambaState
from mistral_inference_tpu_torch.models import transformer as tf
from mistral_inference_tpu_torch.ops.cuda.attention import VERIFY_MAX_ROWS, VERIFY_MAX_TOKENS

BlockOut = Tuple[np.ndarray, np.ndarray, np.ndarray]  # emits, logprobs (n, B, K+1); accepts (n, B)


def _residual_dist(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The rejection-sampling fallback distribution norm(max(p - q, 0)),
    falling back to p itself when the residual has (numerically) no mass,
    which only happens when p == q, where sampling from p is the correct
    limit. Shapes (..., V)."""
    r = (p - q).clamp_min(0.0)
    s = r.sum(dim=-1, keepdim=True)
    return torch.where(s > 1e-9, r / s.clamp_min(1e-30), p)


def _draw(dist: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row of ``dist`` (B, V), a distribution up to a constant.
    A row without mass (it is then a row whose draw is discarded) is drawn
    uniformly rather than refused. Returns (B,) int64."""
    empty = dist.sum(dim=-1, keepdim=True) <= 0
    return torch.multinomial(dist + empty, 1, generator=generator)[:, 0]


def _row_rules(
    B: int, temperature: float, temps: Optional[torch.Tensor], device: torch.device
) -> Tuple[bool, torch.Tensor, torch.Tensor]:
    """(whether any row may sample; the temperature per row (B, 1) fp32,
    clamped away from 0 for the math; which rows take the argmax rule (B,))."""
    if temps is None:
        temps = torch.full((B,), float(temperature), device=device)
        sampled = temperature > 0
    else:
        sampled = True
    return sampled, temps.float().clamp_min(1e-6)[:, None], temps <= 0


def _emit(
    vlog: torch.Tensor, drafts: torch.Tensor, a: torch.Tensor, bonus: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The emitted tokens (B, K + 1) = [d_1 .. d_a, bonus, 0 ...] and their
    target logprobs."""
    B, K = drafts.shape
    jidx = torch.arange(K + 1, device=drafts.device)[None, :]
    drafts_pad = torch.cat([drafts, drafts.new_zeros((B, 1))], dim=1)
    emit = torch.where(jidx < a[:, None], drafts_pad, 0)
    emit = torch.where(jidx == a[:, None], bonus, emit)
    lp = F.log_softmax(vlog, dim=-1).gather(-1, emit[..., None])[..., 0]
    return emit, lp


def _accepted_prefix(ok: torch.Tensor) -> torch.Tensor:
    """Length of the leading run of True in each row of ``ok`` (B, K)."""
    return ok.long().cumprod(dim=1).sum(dim=1)


def _verify(
    target: Transformer, chunk: torch.Tensor, live_b: torch.Tensor, tcache: KVCache,
    spec_fused: bool,
):
    """The target forward over the verify chunk. Returns (prelogits (B, K + 1,
    V), the chunk's per-layer K/V for ``_commit``, or None on the fused
    route)."""
    seqlens = torch.where(live_b, chunk.shape[1], 0).to(torch.int32)
    if spec_fused:
        return target.forward(chunk, seqlens, tcache, write_cache="spec"), None
    return target.forward(chunk, seqlens, tcache, write_cache=False)


def _commit(tcache: KVCache, chunk_kv, adv: torch.Tensor) -> None:
    """Make the accepted prefix (``adv`` tokens per row) part of the target
    cache: on the fused route the K/V are in the ring already and ``kv_len``
    moves; otherwise the accepted K/V are written now."""
    if chunk_kv is None:
        rewind(tcache, tcache.kv_len + adv)
    else:
        scatter_chunk(tcache, chunk_kv[0], chunk_kv[1], adv)


def _fetch(emits, lps, accepts) -> BlockOut:
    """A block's one transfer to the host."""
    return (
        torch.stack(emits).cpu().numpy(),
        torch.stack(lps).cpu().numpy(),
        torch.stack(accepts).cpu().numpy(),
    )


def _spec_block(
    target: Transformer,
    draft: Transformer,
    t0: torch.Tensor,  # (B,) int64
    tcache: KVCache,
    dcache: KVCache,
    generator: Optional[torch.Generator],
    temps: Optional[torch.Tensor] = None,
    live: Optional[torch.Tensor] = None,
    top_ps: Optional[torch.Tensor] = None,
    *,
    K: int,
    n_iters: int,
    temperature: float,
    top_p: float,
    spec_fused: bool = False,
) -> Tuple[torch.Tensor, BlockOut]:
    """``n_iters`` speculative iterations with a draft model. Returns (the
    next t0, (emitted tokens (n_iters, B, K + 1), their logprobs, accept
    counts (n_iters, B)) on the host); both caches are updated in place.

    temperature == 0: greedy, drafts accepted while they match the target
    argmax; the tokens are those of plain greedy decoding. temperature > 0:
    Leviathan-style rejection sampling against the nucleus-filtered
    distributions of both models: the emitted tokens are distributed EXACTLY
    as sequential sampling from the target's filtered distribution.

    ``temps`` ((B,) tensor) overrides ``temperature`` per row: rows with
    temps == 0 take the greedy rule, rows with temps > 0 the rejection rule;
    both are computed and selected per row. ``top_ps`` ((B,)) likewise
    overrides ``top_p``.

    ``live`` ((B,) int 0/1): dead rows run every forward with seqlens 0 and
    commit 0 tokens: neither ring is written and both kv_lens freeze."""
    B, device = t0.shape[0], t0.device
    if live is None:
        live = torch.ones((B,), dtype=torch.int32, device=device)
    ones = live.to(torch.int32)
    live_b = ones > 0
    sampled, temp_col, greedy_rows = _row_rules(B, temperature, temps, device)
    p_eff: TopP = top_p if top_ps is None else top_ps

    emits, lps, accepts = [], [], []
    for _ in range(n_iters):
        n = tcache.kv_len  # (B,): tokens in both caches; t0 is token n

        # -- draft: t0, then K steps (it writes its own cache) --
        last = draft.forward(t0[:, None], ones, dcache)[:, 0]
        drafts_l, qs_l = [], []
        for _ in range(K):
            d = last.argmax(dim=-1)
            if sampled:
                q = top_p_probs(torch.softmax(last.float() / temp_col, dim=-1), p_eff)
                d = torch.where(greedy_rows, d, _draw(q, generator))
                qs_l.append(q)
            drafts_l.append(d)
            last = draft.forward(d[:, None], ones, dcache)[:, 0]
        drafts = torch.stack(drafts_l, dim=1)  # (B, K)

        # -- verify: one target forward over [t0, d_1 .. d_K] --
        chunk = torch.cat([t0[:, None], drafts], dim=1)  # (B, K + 1)
        vlog, chunk_kv = _verify(target, chunk, live_b, tcache, spec_fused)

        g = vlog.argmax(dim=-1)  # (B, K + 1)
        a = _accepted_prefix(drafts == g[:, :K])
        bonus = g.gather(1, a[:, None])  # (B, 1)
        if sampled:
            qs = torch.stack(qs_l, dim=1)  # (B, K, V)
            p = top_p_probs(torch.softmax(vlog.float() / temp_col[:, :, None], dim=-1), p_eff)
            # Accept d_{j+1} with probability min(1, p_j(d) / q_j(d)): u q_d < p_d.
            p_d = p[:, :K].gather(-1, drafts[..., None])[..., 0]
            q_d = qs.gather(-1, drafts[..., None])[..., 0]
            u = torch.rand((B, K), generator=generator, device=device)
            a = torch.where(greedy_rows, a, _accepted_prefix(u * q_d < p_d))
            # The fallback at the first rejected position a: the residual
            # norm(max(p_a - q_a, 0)); after K acceptances: p_K itself.
            res = torch.cat([_residual_dist(p[:, :K], qs), p[:, K:]], dim=1)  # (B, K + 1, V)
            r_a = res.gather(1, a[:, None, None].expand(-1, 1, res.shape[-1]))[:, 0]
            b_sampled = _draw(r_a, generator)[:, None]
            bonus = torch.where(greedy_rows[:, None], g.gather(1, a[:, None]), b_sampled)

        emit, lp = _emit(vlog, drafts, a, bonus)

        # -- commit the accepted K/V to the target ring; rewind the draft.
        # Dead rows commit 0 tokens and both kv_lens stay frozen at n. --
        adv = torch.where(live_b, a + 1, 0).to(torch.int32)
        _commit(tcache, chunk_kv, adv)
        rewind(dcache, n + adv)
        t0 = bonus[:, 0]
        emits.append(emit)
        lps.append(lp)
        accepts.append(a)
    return t0, _fetch(emits, lps, accepts)


def _lookup_propose(
    hist: torch.Tensor, hlen: torch.Tensor, t0: torch.Tensor, K: int, ngram: int
) -> torch.Tensor:
    """Prompt-lookup proposer: find the most recent earlier occurrence of
    the last ``ngram`` tokens of ``hist`` (which end in t0 at index
    hlen - 1) and propose the K tokens that followed it. Rows with no match
    propose t0 repeated (harmless: verification rejects them). hist (B, M)
    int64, hlen (B,) -> (B, K) proposals."""
    B, M = hist.shape
    idx = torch.arange(M, device=hist.device)[None, :]
    hlen = hlen.long()
    m = (idx >= ngram - 1) & (idx < hlen[:, None] - 1)
    for o in range(ngram):
        tail = hist.gather(1, (hlen - 1 - o).clamp_min(0)[:, None])  # o-th token from the end
        shifted = F.pad(hist, (o, 0))[:, :M]  # hist[j - o] at column j
        m = m & (shifted == tail)
    j_star = torch.where(m, idx, -1).amax(dim=1)  # (B,) most recent match
    steps = torch.arange(K, device=hist.device)[None, :]
    prop = hist.gather(1, (j_star[:, None] + 1 + steps).clamp(0, M - 1))
    return torch.where((j_star >= 0)[:, None], prop, t0[:, None])


def _onehot_verify_accept(
    vlog: torch.Tensor,  # (B, K + 1, V) target logits over [t0, d_1 .. d_K]
    drafts: torch.Tensor,  # (B, K) one-hot (n-gram) proposals
    generator: Optional[torch.Generator],
    *,
    sampled: bool,
    greedy_rows: torch.Tensor,  # (B,) bool
    temp_col: torch.Tensor,  # (B, 1) fp32
    p_eff: TopP,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Accept and emit for one-hot proposals. Returns (a, emit, lp, bonus):
    the accepted-prefix length a in [0, K] per row, the emitted tokens
    (B, K + 1) = [d_1 .. d_a, bonus, 0 ...], their target logprobs, and the
    bonus token (B, 1). For a one-hot proposal distribution Leviathan
    acceptance reduces to u < p(d) and the rejection fallback to p with d's
    mass removed, still exactly lossless; ``greedy_rows`` selects the argmax
    rule per row."""
    B, K = drafts.shape
    g = vlog.argmax(dim=-1)  # (B, K + 1)
    a = _accepted_prefix(drafts == g[:, :K])
    bonus = g.gather(1, a[:, None])
    if sampled:
        p = top_p_probs(torch.softmax(vlog.float() / temp_col[:, :, None], dim=-1), p_eff)
        p_d = p[:, :K].gather(-1, drafts[..., None])[..., 0]
        u = torch.rand((B, K), generator=generator, device=vlog.device)
        a = torch.where(greedy_rows, a, _accepted_prefix(u < p_d))
        # Fallback: p with the proposed token's mass removed (the residual of
        # a one-hot proposal); after K acceptances, p_K itself.
        res_k = p[:, :K].scatter(-1, drafts[..., None], 0.0)
        res_k = res_k / res_k.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        res = torch.cat([res_k, p[:, K:]], dim=1)
        r_a = res.gather(1, a[:, None, None].expand(-1, 1, res.shape[-1]))[:, 0]
        b_sampled = _draw(r_a, generator)[:, None]
        bonus = torch.where(greedy_rows[:, None], g.gather(1, a[:, None]), b_sampled)
    emit, lp = _emit(vlog, drafts, a, bonus)
    return a, emit, lp, bonus


def _append_hist(
    hist: torch.Tensor,  # (B, M)
    hlen: torch.Tensor,  # (B,)
    emit: torch.Tensor,  # (B, K + 1)
    a: torch.Tensor,  # (B,)
    adv: torch.Tensor,  # (B,)
    live_b: torch.Tensor,  # (B,) bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Append each live row's accepted + bonus tokens to the lookup history
    at hlen; tokens that would land past the buffer's end are dropped.
    Written as a gather over the buffer's columns, so the shape is fixed and
    no slot is written twice. Returns (hist, hlen + adv)."""
    K1 = emit.shape[1]
    t = torch.arange(hist.shape[1], device=hist.device)[None, :] - hlen[:, None]  # (B, M)
    ok = (t >= 0) & (t <= a[:, None]) & live_b[:, None]
    hist = torch.where(ok, emit.gather(1, t.clamp(0, K1 - 1)), hist)
    return hist, hlen + adv


def _lookup_block(
    target: Transformer,
    t0: torch.Tensor,  # (B,) int64
    tcache: KVCache,
    hist: torch.Tensor,
    hlen: torch.Tensor,
    generator: Optional[torch.Generator],
    temps: Optional[torch.Tensor] = None,
    live: Optional[torch.Tensor] = None,
    top_ps: Optional[torch.Tensor] = None,
    *,
    K: int,
    n_iters: int,
    temperature: float,
    top_p: float,
    ngram: int,
    spec_fused: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, BlockOut]:
    """Draft-FREE speculative iterations: the proposer is an n-gram lookup
    over the row's own token history (prompt-lookup decoding), strong on
    repetitive continuations (code, quoting, retrieval) and free of draft
    forwards. The same verify and accepted-only commit as ``_spec_block``;
    greedy output equals plain greedy decoding. The history buffer stays on
    the device. Returns (t0, hist, hlen, (emits, logprobs, accepts) on the
    host); the cache is updated in place.

    For temperature > 0 the proposal distribution is the one-hot at the
    proposed token (``_onehot_verify_accept``). ``temps`` / ``live`` /
    ``top_ps``: per-row overrides, the contracts of ``_spec_block``."""
    B, device = t0.shape[0], t0.device
    live_b = torch.ones((B,), dtype=torch.bool, device=device) if live is None else live > 0
    sampled, temp_col, greedy_rows = _row_rules(B, temperature, temps, device)
    p_eff: TopP = top_p if top_ps is None else top_ps

    emits, lps, accepts = [], [], []
    for _ in range(n_iters):
        drafts = _lookup_propose(hist, hlen, t0, K, ngram)  # (B, K)
        chunk = torch.cat([t0[:, None], drafts], dim=1)  # (B, K + 1)
        vlog, chunk_kv = _verify(target, chunk, live_b, tcache, spec_fused)
        a, emit, lp, bonus = _onehot_verify_accept(
            vlog, drafts, generator, sampled=sampled, greedy_rows=greedy_rows,
            temp_col=temp_col, p_eff=p_eff,
        )
        adv = torch.where(live_b, a + 1, 0).to(torch.int32)
        _commit(tcache, chunk_kv, adv)
        hist, hlen = _append_hist(hist, hlen, emit, a, adv, live_b)
        t0 = bonus[:, 0]
        emits.append(emit)
        lps.append(lp)
        accepts.append(a)
    return t0, hist, hlen, _fetch(emits, lps, accepts)


def _spec_fused_ok(model: Transformer, tcache: KVCache, K: int, span: int) -> bool:
    """Gate for the fused in-ring verify route (``write_cache="spec"``):
    verify chunks of K + 1 <= 8 tokens whose query rows per KV head fit the
    kernel, head_dim 128, a 128-padded ring buffer, the fused decode switch
    on, and a ring that can NEVER wrap: every layer's window must cover
    ``span``, the caller's bound on reachable positions (including a block's
    overshoot past max_tokens). When False the blocks keep the wrap-safe
    no-write verify + scatter commit."""
    args = model.args
    return (
        tf.FUSED_DECODE
        and K + 1 <= VERIFY_MAX_TOKENS
        and (args.n_heads // args.n_kv_heads) * (K + 1) <= VERIFY_MAX_ROWS
        and args.head_dim == 128
        and tcache.size % 128 == 0
        and min(tcache.windows) >= span
    )


def _walk_emits(
    emits: np.ndarray, lps_h: np.ndarray, acc: np.ndarray, streams, stream_lps, eos_step,
    eos_id: Optional[int],
) -> None:
    """Append each iteration's accepted + bonus tokens to the host streams,
    recording each row's first EOS position."""
    for it in range(emits.shape[0]):
        for i in range(emits.shape[1]):
            for j in range(int(acc[it, i]) + 1):
                tok = int(emits[it, i, j])
                streams[i].append(tok)
                stream_lps[i].append(float(lps_h[it, i, j]))
                if eos_id is not None and eos_step[i] is None and tok == eos_id:
                    eos_step[i] = len(streams[i]) - 1


def _finalize_streams(streams, stream_lps, logprobs, eos_step, eos_id, max_tokens):
    """``generate()``'s stop rule: tokens are appended per GLOBAL step until
    every row has emitted EOS; the step on which the last row finishes is not
    appended. The streams here are those of sequential decoding, so cutting
    them to that step count reproduces plain ``generate()`` exactly."""
    if eos_id is not None and all(e is not None for e in eos_step):
        cut = min(max_tokens, max(eos_step))
    else:
        cut = max_tokens
    generated = [s[:cut] for s in streams]
    for lp, s in zip(logprobs, stream_lps):
        lp.extend(s[:cut])
    return generated, logprobs


def _first_token(carry: torch.Tensor, temperature: float, top_p: float, generator, eos_id):
    """The first token comes straight from the prefill carry (the loop's
    invariant needs t0 = a correct token whose K/V is not yet cached).
    Returns (t0 (B,) int64, the host streams, their logprobs, eos_step)."""
    t0 = sample(carry, float(temperature), top_p, generator)
    lp0 = F.log_softmax(carry, dim=-1).gather(-1, t0[:, None])[:, 0]
    streams: List[List[int]] = [[int(t)] for t in t0.cpu()]
    stream_lps: List[List[float]] = [[float(x)] for x in lp0.cpu()]
    eos_step: List[Optional[int]] = [
        0 if eos_id is not None and s[0] == eos_id else None for s in streams
    ]
    return t0, streams, stream_lps, eos_step


def _lookup_start(model, carry, encoded_prompts, temperature, top_p, max_tokens, K, n_iters,
                  generator, eos_id):
    """Startup of the lookup generator: the first token from the prefill
    carry, the per-row output streams, and the device history buffer (prompt
    + first token) that the n-gram proposer searches."""
    t0, streams, stream_lps, eos_step = _first_token(carry, temperature, top_p, generator, eos_id)
    B = len(encoded_prompts)
    max_prompt_len = max(len(p) for p in encoded_prompts)
    M = max_prompt_len + max_tokens + n_iters * (K + 1) + 4
    hist_np = np.zeros((B, M), np.int64)
    for i, p in enumerate(encoded_prompts):
        hist_np[i, : len(p)] = p
        hist_np[i, len(p)] = streams[i][0]
    hist = torch.from_numpy(hist_np).to(model.device)
    hlen = torch.tensor([len(p) + 1 for p in encoded_prompts], dtype=torch.int64,
                        device=model.device)
    return t0, streams, stream_lps, hist, hlen, eos_step


def _check_spec_args(encoded_prompts, model: Union[Transformer, Mamba],
                     spec_tokens: int) -> Tuple[int, int]:
    K = int(spec_tokens)
    if K < 1:
        raise ValueError(f"spec_tokens must be at least 1, got {spec_tokens}")
    check_prompts(encoded_prompts, model.args.vocab_size)
    return K, max(len(p) for p in encoded_prompts)


def _live_rows(streams, max_tokens: int, device) -> torch.Tensor:
    """Rows freeze only at max_tokens (their tail is always cut): a row that
    has emitted EOS must KEEP generating real tokens, since the stop rule
    returns its continuation up to the last row's finish. Freezing bounds
    the ring positions to ``span``."""
    return torch.tensor([0 if len(s) >= max_tokens else 1 for s in streams],
                        dtype=torch.int32, device=device)


def _all_done(streams, eos_step, max_tokens: int) -> bool:
    return all(len(s) >= max_tokens or e is not None for s, e in zip(streams, eos_step))


@torch.inference_mode()
def generate_lookup(
    encoded_prompts: Sequence[Sequence[int]],
    model: Transformer,
    *,
    max_tokens: int,
    temperature: float = 0.0,
    spec_tokens: int = 8,
    ngram: int = 2,
    chunk_size: Optional[int] = None,
    eos_id: Optional[int] = None,
    block_iters: int = 8,
    top_p: float = DEFAULT_TOP_P,
    seed: int = 0,
) -> Tuple[List[List[int]], List[List[float]]]:
    """Draft-free speculative decoding by prompt-lookup (n-gram) proposals.
    The output contract of ``generate``; greedy output tokens are the same.
    Gains where continuations repeat earlier text (code edits, quoting,
    structured data), and never does worse than one token per verify
    forward."""
    K, max_prompt_len = _check_spec_args(encoded_prompts, model, spec_tokens)
    n_iters = int(block_iters)
    # The span covers the worst overshoot past max_tokens inside a block (a
    # row that finishes in a block's first iteration keeps verifying until
    # the block ends; done rows freeze BETWEEN blocks through ``live``), so
    # on a model without a window the ring never wraps and the fused verify
    # route applies.
    span = max_prompt_len + max_tokens + n_iters * (K + 1) + K + 2
    tcache = model.alloc_cache(len(encoded_prompts), span)
    spec_fused = _spec_fused_ok(model, tcache, K, span)
    logprobs, carry = prefill_prompts(model, encoded_prompts, tcache, chunk_size)

    generator = torch.Generator(device=model.device).manual_seed(seed)
    t0, streams, stream_lps, hist, hlen, eos_step = _lookup_start(
        model, carry, encoded_prompts, temperature, top_p, max_tokens, K, n_iters, generator,
        eos_id,
    )
    while not _all_done(streams, eos_step, max_tokens):
        t0, hist, hlen, out = _lookup_block(
            model, t0, tcache, hist, hlen, generator, None,
            _live_rows(streams, max_tokens, model.device),
            K=K, n_iters=n_iters, temperature=float(temperature), top_p=top_p, ngram=ngram,
            spec_fused=spec_fused,
        )
        _walk_emits(*out, streams, stream_lps, eos_step, eos_id)
    return _finalize_streams(streams, stream_lps, logprobs, eos_step, eos_id, max_tokens)


@torch.inference_mode()
def generate_speculative(
    encoded_prompts: Sequence[Sequence[int]],
    model: Transformer,
    draft_model: Transformer,
    *,
    max_tokens: int,
    temperature: float = 0.0,
    spec_tokens: int = 4,
    chunk_size: Optional[int] = None,
    eos_id: Optional[int] = None,
    block_iters: int = 8,
    top_p: float = DEFAULT_TOP_P,
    seed: int = 0,
) -> Tuple[List[List[int]], List[List[float]]]:
    """The output contract of ``generate``, and for temperature == 0 the SAME
    OUTPUT TOKENS: speculation only changes how many target forwards it takes
    to produce them. temperature > 0 uses rejection sampling against both
    models' nucleus-filtered distributions: lossless (tokens distributed
    exactly as sequential sampling from the target), fixed per seed, on
    another random stream than ``generate()``'s."""
    if not isinstance(draft_model, Transformer):
        raise TypeError("the draft must be a Transformer")
    if model.args.vocab_size != draft_model.args.vocab_size:
        raise ValueError("draft and target must share a vocabulary")
    if draft_model.device != model.device:
        raise ValueError(f"draft on {draft_model.device}, target on {model.device}")
    K, max_prompt_len = _check_spec_args(encoded_prompts, model, spec_tokens)
    B = len(encoded_prompts)
    n_iters = int(block_iters)

    # Target ring: sized for the worst overshoot past max_tokens inside a
    # block (done rows freeze between blocks through ``live``), so that on a
    # model without a window it never wraps and the fused verify applies; the
    # scatter-commit route stays wrap-safe regardless. Draft ring: must
    # NEVER wrap (rewind safety): full-context with the same slack.
    overshoot = n_iters * (K + 1) + K + 2
    span = max_prompt_len + max_tokens + overshoot
    tcache = model.alloc_cache(B, span)
    spec_fused = _spec_fused_ok(model, tcache, K, span)
    draft_span = max_prompt_len + max_tokens + K + 1 + overshoot
    dw: Union[int, List[Optional[int]], None] = draft_model.args.sliding_window
    dws = [w for w in (dw if isinstance(dw, list) else [dw]) if w is not None]
    if dws and min(dws) < draft_span:
        raise ValueError(
            f"draft sliding window {dws} < {draft_span}: the draft cache would wrap, "
            "making speculative rewind unsafe; use a full-context draft"
        )
    dcache = draft_model.alloc_cache(B, draft_span)

    # Prompt prefill: the target keeps the teacher-forced logprobs (the API's
    # contract); the draft only needs its cache filled.
    logprobs, carry = prefill_prompts(model, encoded_prompts, tcache, chunk_size)
    prefill_prompts(draft_model, encoded_prompts, dcache, chunk_size, want_logprobs=False)

    generator = torch.Generator(device=model.device).manual_seed(seed)
    t0, streams, stream_lps, eos_step = _first_token(carry, temperature, top_p, generator, eos_id)
    while not _all_done(streams, eos_step, max_tokens):
        t0, out = _spec_block(
            model, draft_model, t0, tcache, dcache, generator, None,
            _live_rows(streams, max_tokens, model.device),
            K=K, n_iters=n_iters, temperature=float(temperature), top_p=top_p,
            spec_fused=spec_fused,
        )
        _walk_emits(*out, streams, stream_lps, eos_step, eos_id)
    return _finalize_streams(streams, stream_lps, logprobs, eos_step, eos_id, max_tokens)


def _mamba_lookup_block(
    model: Mamba,
    t0: torch.Tensor,  # (B,) int64
    state: MambaState,
    hist: torch.Tensor,
    hlen: torch.Tensor,
    generator: Optional[torch.Generator],
    temps: Optional[torch.Tensor] = None,
    live: Optional[torch.Tensor] = None,
    top_ps: Optional[torch.Tensor] = None,
    *,
    K: int,
    n_iters: int,
    temperature: float,
    top_p: float,
    ngram: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, BlockOut]:
    """``_lookup_block`` for a Mamba. A recurrent state has no ring to
    scatter into, so the commit differs: the verify forward scores the
    whole (B, K + 1) chunk with ``write_state=False``, and a second forward
    over the same chunk with ``seqlens = a + 1`` absorbs exactly the accepted
    prefix. Tokens past ``seqlens`` enter with dt = 0 and zeroed conv inputs,
    so they neither decay nor write the state: the committed state is that of
    decoding the accepted tokens one by one. Both forwards go through the
    chunked SSD, not K9. Returns (t0, hist, hlen, (emits, logprobs, accepts)
    on the host); the state is updated in place. ``temps`` / ``live`` /
    ``top_ps``: the contracts of ``_spec_block`` (dead rows verify with
    seqlens 0 and commit nothing)."""
    B, device = t0.shape[0], t0.device
    live_b = torch.ones((B,), dtype=torch.bool, device=device) if live is None else live > 0
    sampled, temp_col, greedy_rows = _row_rules(B, temperature, temps, device)
    p_eff: TopP = top_p if top_ps is None else top_ps
    verify_lens = torch.where(live_b, K + 1, 0).to(torch.int32)

    emits, lps, accepts = [], [], []
    for _ in range(n_iters):
        drafts = _lookup_propose(hist, hlen, t0, K, ngram)  # (B, K)
        chunk = torch.cat([t0[:, None], drafts], dim=1)  # (B, K + 1)
        vlog = model.forward(chunk, verify_lens, state, chunk=K + 1, write_state=False)
        a, emit, lp, bonus = _onehot_verify_accept(
            vlog, drafts, generator, sampled=sampled, greedy_rows=greedy_rows,
            temp_col=temp_col, p_eff=p_eff,
        )
        adv = torch.where(live_b, a + 1, 0).to(torch.int32)
        model.forward(chunk, adv, state, chunk=K + 1, head="none")  # commit [t0, d_1 .. d_a]
        hist, hlen = _append_hist(hist, hlen, emit, a, adv, live_b)
        t0 = bonus[:, 0]
        emits.append(emit)
        lps.append(lp)
        accepts.append(a)
    return t0, hist, hlen, _fetch(emits, lps, accepts)


@torch.inference_mode()
def generate_lookup_mamba(
    encoded_prompts: Sequence[Sequence[int]],
    model: Mamba,
    *,
    max_tokens: int,
    temperature: float = 0.0,
    spec_tokens: int = 8,
    ngram: int = 2,
    chunk_size: Optional[int] = None,
    eos_id: Optional[int] = None,
    block_iters: int = 8,
    top_p: float = DEFAULT_TOP_P,
    seed: int = 0,
) -> Tuple[List[List[int]], List[List[float]]]:
    """Prompt-lookup speculative decoding for a Mamba model: the output
    contract of ``generate_mamba``, and its greedy tokens. Each iteration
    streams the weights and the state twice (verify, commit) for up to
    K + 1 tokens, where plain decoding streams them once per token."""
    K, _ = _check_spec_args(encoded_prompts, model, spec_tokens)
    n_iters = int(block_iters)
    logprobs, carry, state = prefill_mamba(model, encoded_prompts, chunk_size)

    generator = torch.Generator(device=model.device).manual_seed(seed)
    t0, streams, stream_lps, hist, hlen, eos_step = _lookup_start(
        model, carry, encoded_prompts, temperature, top_p, max_tokens, K, n_iters, generator,
        eos_id,
    )
    while not _all_done(streams, eos_step, max_tokens):
        t0, hist, hlen, out = _mamba_lookup_block(
            model, t0, state, hist, hlen, generator, None,
            _live_rows(streams, max_tokens, model.device),
            K=K, n_iters=n_iters, temperature=float(temperature), top_p=top_p, ngram=ngram,
        )
        _walk_emits(*out, streams, stream_lps, eos_step, eos_id)
    return _finalize_streams(streams, stream_lps, logprobs, eos_step, eos_id, max_tokens)
