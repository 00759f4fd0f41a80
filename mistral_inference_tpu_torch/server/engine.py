"""Continuous-batching serving engine for a ``Transformer`` (counterpart of
``mistral_inference_tpu/server/engine.py``, without its speculative modes).

A fixed batch of B slots; each owns one row of the ring KV cache, whose
per-row ``kv_len`` already says how full it is.

* **Admission** runs the prefill of ``generate.py`` over the new rows in
  chunks of ``admit_chunk`` tokens, with seqlens 0 for every other
  row: those rows neither write the ring nor move their ``kv_len``, and their
  carried prelogits pass through. A reclaimed slot only resets its
  ``kv_len``: the stale ring bytes become invisible. A sweep waits until
  ``admit_waterline`` slots are free (its cost hardly depends on how many rows
  are new); a sweep of at most ``staging_batch`` rows prefills in a narrow
  staging cache and adopts the rows (``cache.adopt_rows``); a request whose
  prompt shares a prefix with a resident row's prompt copies those ring slots
  (``cache.copy_prefix_rows``) instead of prefilling them.
* **Decode** is ``generate._decode_block`` with per-row temperatures, top-p,
  liveness and token budgets. A finished or empty slot runs with seqlens 0,
  so its ring stays intact as a prefix source. With ``pipeline`` (the
  default) the next block is queued on the card before the previous block's
  tokens are read back and fanned out, so the host's bookkeeping overlaps the
  card's work; per-row request ids make sure a block never emits into a slot
  that a newer request took.

The engine is host-side control; every O(model) operation is a forward of
``models/transformer.py``, on the model's device, in inference mode (the
cache and carry are inference tensors: change them only inside it).
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mistral_inference_tpu_torch.cache import KVCache, adopt_rows, copy_prefix_rows
from mistral_inference_tpu_torch.generate import DEFAULT_TOP_P, _decode_block, _prefill_step
from mistral_inference_tpu_torch.model import Transformer
from mistral_inference_tpu_torch.utils.profiling import METRICS

LATER = "ROADMAP.md Queue 1 item 4b"


@dataclass
class Request:
    request_id: int
    prompt: List[int]
    max_tokens: int
    temperature: float = 0.0
    top_p: float = DEFAULT_TOP_P
    # Any of these token ids finishes the request, like an extra EOS id; the
    # matched token is not appended.
    stop_ids: Tuple[int, ...] = ()
    generated: List[int] = field(default_factory=list)
    # The generate() logprob contract: len(prompt) - 1 teacher-forced prompt
    # transitions (only for want_logprobs), then one per generated token.
    prompt_logprobs: List[float] = field(default_factory=list)
    gen_logprobs: List[float] = field(default_factory=list)
    # Prompt logprobs cost a vocab-head pass over every prefill position; an
    # admission sweep pays it when any of its rows asks.
    want_logprobs: bool = False
    t_submit: float = 0.0
    t_first_token: float = 0.0
    done: bool = False
    # Set when the row's logits went NaN: the request fails loudly instead of
    # streaming garbage, and its slot is freed.
    error: Optional[str] = None


@dataclass
class StepEvent:
    request_id: int
    token: int
    finished: bool
    logprob: float = 0.0


@dataclass
class _Block:
    """A decode block queued on the card: its tokens and logprobs, copied to
    the host behind it (``ready`` marks the copy's end on the card), its
    width and the request id each row was decoding for (None: a dead row)."""

    toks: torch.Tensor  # (n, B)
    lps: torch.Tensor  # (n, B)
    ready: Optional[torch.cuda.Event]
    n: int
    rids: List[Optional[int]]


class Engine:
    def __init__(
        self,
        model: Transformer,
        batch_size: int,
        max_seq_len: int,
        *,
        temperature: float = 0.0,
        eos_id: Optional[int] = None,
        decode_block: int = 8,
        admit_chunk: int = 512,
        seed: int = 0,
        draft_model=None,
        prefix_cache: bool = True,
        prefix_min: int = 16,
        admit_waterline: Optional[int] = None,
        staging_batch: Optional[int] = None,
        pipeline: bool = True,
    ):
        if draft_model is not None:
            raise NotImplementedError(f"speculative serving is not ported yet ({LATER})")
        if not isinstance(model, Transformer):
            raise NotImplementedError(f"the engine serves a Transformer; mamba_engine is not "
                                      f"ported yet ({LATER})")
        self.model = model
        self.device = model.device
        self.B = batch_size
        self.max_seq_len = max_seq_len
        self.temperature = temperature
        self.eos_id = eos_id
        self.decode_block = decode_block
        self.admit_chunk = admit_chunk
        self.pipeline = pipeline
        # Wait for min(queued, waterline) free slots before a sweep while
        # other rows run (1 admits eagerly).
        self.admit_waterline = (
            max(1, batch_size // 8) if admit_waterline is None else max(1, admit_waterline)
        )
        # Sweeps of at most this many rows prefill in a staging cache of this
        # width, allocated at the first such sweep; 0 turns it off.
        self._staging_B = (
            max(1, batch_size // 8) if staging_batch is None else max(0, staging_batch)
        )
        if self._staging_B >= batch_size:
            self._staging_B = 0
        self._stage_cache: Optional[KVCache] = None

        self.cache: KVCache = model.alloc_cache(batch_size, max_seq_len)
        V = model.args.vocab_size
        self.carry = torch.zeros((batch_size, V), dtype=torch.float32, device=self.device)
        # Sampling settings per row, on the host (the all-greedy choice is
        # made there) and on the card.
        self._temps_h = np.zeros((batch_size,), np.float32)
        self._top_ps_h = np.full((batch_size,), DEFAULT_TOP_P, np.float32)
        self._temps = self._to_device(self._temps_h)
        self._top_ps = self._to_device(self._top_ps_h)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.slots: List[Optional[Request]] = [None] * batch_size
        self.queue: Deque[Request] = deque()
        self._ids = itertools.count()
        self._pending: Optional[_Block] = None
        # Finished requests whose slot this step's admission reused: a
        # pipelined step admits before the caller reads the step's events.
        self._evicted: Dict[int, Request] = {}
        self.prefix_cache = prefix_cache
        self.prefix_min = prefix_min
        self._slot_prompt: List[Optional[List[int]]] = [None] * batch_size
        self._min_window = min(self.cache.windows)

    # -- client API ---------------------------------------------------------

    def submit(
        self,
        prompt: Sequence[int],
        max_tokens: int = 256,
        temperature: Optional[float] = None,
        images: Sequence = (),
        want_logprobs: bool = False,
        top_p: Optional[float] = None,
        stop_ids: Sequence[int] = (),
    ) -> int:
        """Queue a request; returns its id. ``temperature`` and ``top_p`` of
        None take the engine's defaults; each request keeps its own inside
        one batched decode. ``stop_ids`` are stop tokens beside ``eos_id``."""
        if len(images):
            raise NotImplementedError(f"image requests are not ported yet ({LATER})")
        if not prompt:
            raise ValueError("a request needs at least one prompt token")
        if len(prompt) + max_tokens > self.max_seq_len:
            raise ValueError(f"prompt + max_tokens = {len(prompt) + max_tokens} exceeds "
                             f"max_seq_len {self.max_seq_len}")
        if any(not 0 <= t < self.model.args.vocab_size for t in prompt):
            raise ValueError(f"prompt token id out of range [0, {self.model.args.vocab_size})")
        req = Request(
            next(self._ids), list(prompt), max_tokens,
            temperature=self.temperature if temperature is None else float(temperature),
            top_p=DEFAULT_TOP_P if top_p is None else float(top_p),
            stop_ids=tuple(stop_ids), want_logprobs=want_logprobs,
            t_submit=time.perf_counter(),
        )
        self.queue.append(req)
        return req.request_id

    def cancel(self, request_id: int) -> bool:
        """Finish a request early: a queued one leaves the queue, a live one
        frees its slot. False if it is neither."""
        for i, r in enumerate(self.queue):
            if r.request_id == request_id:
                del self.queue[i]
                return True
        for s in self.slots:
            if s is not None and s.request_id == request_id and not s.done:
                s.done = True
                return True
        return False

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(self._live_rows())

    def run_to_completion(self) -> Dict[int, List[int]]:
        """Drain the queue and the slots; returns {request_id: generated tokens}."""
        results: Dict[int, List[int]] = {}
        while self.has_work:
            for ev in self.step():
                if ev.finished:
                    results[ev.request_id] = self._result(ev.request_id)
        return results

    @torch.inference_mode()
    def step(self) -> List[StepEvent]:
        """Admit waiting requests, decode one block, emit each row's tokens.

        Pipelined: queue the next block first (with liveness one block
        stale), then read back and fan out the previous block while the card
        runs this one, then admit with fresh slot states (the admission's
        prefill queues behind the block on the card). A row that finished in
        the previous block decodes one extra block, frozen by its budget or
        dropped at the fan-out by its request id. No block is queued when no
        row can outlive the one in flight (max_tokens bounds every row; EOS
        only ends rows earlier)."""
        self._evicted.clear()
        if not self.pipeline:
            self._admit()
            if any(self._live_rows()):
                self._dispatch_block(None)
            block, self._pending = self._pending, None
            return self._drain(block)
        prev, self._pending = self._pending, None
        if any(r > 0 for r in self._remaining(prev)):
            self._dispatch_block(prev)
        events = self._drain(prev)
        self._admit()
        return events

    # -- engine internals ---------------------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A small host array on the model's device without waiting for the
        card: from pinned memory, asynchronously (a pageable copy would
        synchronize the stream, and with it the block in flight)."""
        t = torch.from_numpy(np.array(a))  # a copy: the host array may change
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _result(self, request_id: int) -> List[int]:
        return self._request(request_id).generated

    def _request(self, request_id: int) -> Request:
        for s in self.slots:
            if s is not None and s.request_id == request_id:
                return s
        # A finished request's slot may have been reused by this step's
        # admission before the caller read the step's events.
        if request_id in self._evicted:
            return self._evicted[request_id]
        raise KeyError(request_id)

    def _live_rows(self) -> List[bool]:
        return [s is not None and not s.done for s in self.slots]

    @torch.inference_mode()
    def _admit(self) -> None:
        """Fill free slots from the queue and prefill the new rows in chunks
        of ``admit_chunk`` tokens (the other rows ride along with seqlens 0).
        Prompt logprobs are gathered per chunk for the rows that want them:
        the numbers generate() returns."""
        free = [i for i in range(self.B) if self.slots[i] is None or self.slots[i].done]
        # Batched admission: while rows run, wait for enough free slots to
        # share one sweep; with nothing running, waiting would stall.
        if (self.queue and any(self._live_rows())
                and len(free) < min(len(self.queue), self.admit_waterline)):
            return
        new: List[Tuple[int, Request]] = []
        while free and self.queue:
            r = self.queue.popleft()
            empties = [i for i in free if self.slots[i] is None]
            if empties:
                i = empties[0]
            else:
                # Reusing a finished slot destroys it as a prefix source:
                # take the one least useful to this request.
                i = min(free, key=lambda j: _common_prefix(self._slot_prompt[j] or [], r.prompt))
            free.remove(i)
            if self.slots[i] is not None:
                self._evicted[self.slots[i].request_id] = self.slots[i]
            self.slots[i] = r
            new.append((i, r))
        if not new:
            return
        # The block in flight precedes this admission on the card; wait for it
        # before the clock starts, so that decode time is not charged to
        # admission (and the prefix planning below reads settled fills).
        self._sync()
        t_admit = time.perf_counter()

        offs, copies = self._plan_prefix_reuse(new)
        maxT = max(len(r.prompt) - offs.get(i, 0) for i, r in new)
        rows = [i for i, _ in new]
        for i, r in new:
            self._temps_h[i] = r.temperature
            self._top_ps_h[i] = r.top_p
        self._temps = self._to_device(self._temps_h)
        self._top_ps = self._to_device(self._top_ps_h)
        # Reclaimed rows start empty: their stale ring bytes become invisible.
        self.cache.kv_len[self._to_device(np.array(rows, np.int64))] = 0
        self._apply_prefix_copies(copies)
        for i, r in new:  # after the planning: a wave cannot source itself
            self._slot_prompt[i] = list(r.prompt)

        if self._staging_B and len(new) <= self._staging_B and not copies:
            self._admit_staged(new, maxT)
            self._sync()
            METRICS.observe("admission_staged_s", time.perf_counter() - t_admit)
            METRICS.inc("staged_admissions")
        else:
            prompts: List[Sequence[int]] = [()] * self.B
            for i, r in new:
                prompts[i] = r.prompt[offs.get(i, 0):]
            # The first chunk of a sweep without prefix copies attends to
            # itself alone: every new row's ring is empty.
            self.carry = self._prefill(new, prompts, self.cache, self.carry, maxT,
                                       attend_first=bool(offs))
            self._sync()
        METRICS.observe("admission_prefill_s", time.perf_counter() - t_admit)
        METRICS.inc("requests_admitted", len(new))

    def _prefill(self, new, prompts, cache, carry, maxT: int,
                 attend_first: bool) -> torch.Tensor:
        """Chunks of ``admit_chunk`` of each row's ``prompts`` entry (empty: a
        row that rides along) into ``cache``; returns the new carry. Prompt
        logprobs go to the requests of ``new`` that want them (their rows in
        ``prompts`` are whole prompts: no prefix was copied).

        Every chunk is ``admit_chunk`` wide, however short the prompts: a
        row's prefill then runs the chunks of ``generate(chunk_size=
        admit_chunk)`` and its linears the same route (which ``ops/linear``
        picks by the row count, K5 for B x admit_chunk rows while that stays
        under 8192), whatever it is admitted with. So a request's tokens do
        not depend on its batch: a narrower chunk would send a sweep of short
        prompts through K3, whose other rounding an fp8 ring turns into
        another token far from a near-tie (seen on the card). Narrow chunks
        (the JAX engine's powers of two, which bound its compiled programs)
        cost short prompts less."""
        width = self.admit_chunk
        want_lp = any(r.want_logprobs for _, r in new)
        n_rows = len(prompts)
        for s in range(0, maxT, width):
            tokens = np.zeros((n_rows, width), np.int64)
            seqlens = np.zeros((n_rows,), np.int32)
            for b, p in enumerate(prompts):
                chunk = p[s:s + width]
                tokens[b, :len(chunk)] = chunk
                seqlens[b] = len(chunk)
            lp_d, carry = _prefill_step(
                self.model, self._to_device(tokens), self._to_device(seqlens), cache, carry,
                attend_cache=s > 0 or attend_first, want_logprobs=want_lp,
            )
            if want_lp:
                lp = lp_d.cpu().numpy()
                for b, r in new:
                    if r.want_logprobs and seqlens[b]:
                        r.prompt_logprobs.extend(lp[b, (1 if s == 0 else 0):seqlens[b]].tolist())
        return carry

    def _admit_staged(self, new, maxT: int) -> None:
        """Prefill the few new rows in a staging cache of ``staging_batch``
        rows, then adopt them whole into the main cache: ring bytes, scales,
        fills and carry rows move exactly, so the adopted rows hold what
        their own prefill wrote. Only the vocab head's product sees another
        row count than a full sweep's, which may move a carried logit by an
        ulp on the card."""
        Bs = self._staging_B
        if self._stage_cache is None:
            # The main cache's max_seq_len: the same windows, the same slots.
            self._stage_cache = self.model.alloc_cache(Bs, self.max_seq_len)
        sc = self._stage_cache
        sc.kv_len.zero_()  # fresh rows: stale staging bytes are invisible
        scarry = torch.zeros((Bs, self.carry.shape[1]), dtype=torch.float32, device=self.device)
        staged = [(j, r) for j, (_, r) in enumerate(new)]
        prompts = [r.prompt for _, r in new] + [()] * (Bs - len(new))
        scarry = self._prefill(staged, prompts, sc, scarry, maxT, attend_first=False)
        self.cache, self.carry = adopt_rows(
            self.cache, self.carry, sc, scarry, list(range(len(new))), [i for i, _ in new])

    def _plan_prefix_reuse(self, new) -> Tuple[Dict[int, int], List[Tuple[int, int, int]]]:
        """For each new request, the resident row whose prompt shares the
        longest prefix and whose ring still holds it. Returns ({row: prefix
        length}, [(src, dst, q)] in an order safe to apply).

        A source's positions [0, q) are in slots [0, q) only if its ring
        never wrapped: its fill must not exceed the smallest window (finished
        rows are frozen, so they stay usable). Rows that want prompt
        logprobs take no prefix: those positions' logprobs were never
        computed for them."""
        offs: Dict[int, int] = {}
        copies: List[Tuple[int, int, int]] = []
        if not self.prefix_cache:
            return offs, copies
        kvlen = self.cache.kv_len.cpu().numpy()
        dsts = {i for i, _ in new}
        for i, r in new:
            if r.want_logprobs:
                continue
            best_j, best_q = -1, 0
            for j in range(self.B):
                if j == i or self._slot_prompt[j] is None or kvlen[j] > self._min_window:
                    continue
                src = self._slot_prompt[j]
                q = _common_prefix(src, r.prompt, min(len(src), len(r.prompt) - 1,
                                                      self._min_window))
                # Prefer a source outside this wave (no ordering constraint).
                if q > best_q or (q == best_q and best_j in dsts and j not in dsts):
                    best_j, best_q = j, q
            if best_q >= self.prefix_min:
                offs[i] = best_q
                copies.append((best_j, i, best_q))
        # A same-wave source's old bytes must be read before a copy overwrites
        # them: a copy runs once no pending copy still reads its destination.
        # A cycle is broken by dropping its shortest copy (that row then
        # prefills its whole prompt).
        ordered: List[Tuple[int, int, int]] = []
        pending = list(copies)
        while pending:
            reads = {s for s, _, _ in pending}
            ready = [c for c in pending if c[1] not in reads]
            if not ready:
                drop = min(pending, key=lambda c: c[2])
                pending.remove(drop)
                offs.pop(drop[1], None)
                continue
            for c in ready:
                ordered.append(c)
                pending.remove(c)
        return offs, ordered

    def _apply_prefix_copies(self, copies) -> None:
        if not copies:
            return
        srcs, dsts, qs = zip(*copies)
        copy_prefix_rows(self.cache, srcs, dsts, qs)
        METRICS.inc("prefix_hits", len(copies))
        METRICS.inc("prefix_tokens_reused", sum(qs))

    def _block_size(self) -> int:
        """Adaptive block width: the smallest power of two that covers the
        longest remaining live request, at most ``decode_block``, so a batch
        near its end stops decoding whole blocks for nothing."""
        max_rem = max(s.max_tokens - len(s.generated) for s in self.slots
                      if s is not None and not s.done)
        n = 1
        while n < min(self.decode_block, max_rem):
            n *= 2
        return min(n, self.decode_block)

    def _remaining(self, prev: Optional[_Block]) -> List[int]:
        """Each row's token budget for the next block: its request's tokens
        still to come, less those the block in flight decodes for that same
        request (a row admitted since that block was queued has nothing in
        flight: the block's output for it is dropped at the fan-out)."""
        out = []
        for i, s in enumerate(self.slots):
            if s is None or s.done:
                out.append(0)
                continue
            ahead = prev.n if prev is not None and prev.rids[i] == s.request_id else 0
            out.append(max(0, s.max_tokens - len(s.generated) - ahead))
        return out

    def _dispatch_block(self, prev: Optional[_Block]) -> None:
        """Queue one decode block on the card and the copy of its tokens and
        logprobs to the host behind it; nothing waits for the card. Each row's
        budget freezes it in the block once its request has all its tokens,
        so a row never writes past prompt + max_tokens (its ring cannot wrap
        past it: finished rows stay valid prefix sources)."""
        n = self._block_size()
        live_rows = self._live_rows()
        live = self._to_device(np.array(live_rows, np.int32))
        budget = self._to_device(np.array(self._remaining(prev), np.int32))
        # Every live row greedy: the float temperature 0 takes the argmax
        # alone, and no sampler runs.
        greedy = all(t <= 0 for t, on in zip(self._temps_h, live_rows) if on)

        def step(tok: torch.Tensor, seqlens: torch.Tensor) -> torch.Tensor:
            return self.model.forward(tok[:, None], seqlens, self.cache, attend_cache=True)[:, 0]

        toks, lps, self.carry = _decode_block(
            step, self.carry, n, 0.0, DEFAULT_TOP_P, self.generator,
            temps=None if greedy else self._temps, live=live,
            top_ps=None if greedy else self._top_ps, budget=budget,
        )
        ready = None
        if self.device.type == "cuda":
            toks = toks.to("cpu", non_blocking=True)
            lps = lps.to("cpu", non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        rids = [s.request_id if on else None for s, on in zip(self.slots, live_rows)]
        self._pending = _Block(toks, lps, ready, n, rids)

    def _drain(self, block: Optional[_Block]) -> List[StepEvent]:
        """Read back a block and turn it into events: tokens, EOS and stop
        ids, max_tokens, NaN failures."""
        if block is None:
            return []
        if block.ready is not None:
            block.ready.synchronize()
        toks, lps = block.toks.numpy(), block.lps.numpy()  # (n, B) each
        now = time.perf_counter()
        # A row counts only while its slot still holds the request the block
        # was queued for: a slot freed and reused since gets none of it.
        valid = np.array([rid is not None and s is not None and s.request_id == rid
                          for rid, s in zip(block.rids, self.slots)])
        events = self._fail_nan_rows(np.isnan(lps).any(axis=0) & valid, now)
        for t in range(block.n):
            for i, slot in enumerate(self.slots):
                if slot is None or slot.done or not valid[i]:
                    continue
                tok, lp = int(toks[t, i]), float(lps[t, i])
                if not slot.generated and not slot.t_first_token:
                    slot.t_first_token = now
                    METRICS.observe("ttft_s", now - slot.t_submit)
                hit_stop = tok == self.eos_id or tok in slot.stop_ids
                if not hit_stop:
                    slot.generated.append(tok)
                    slot.gen_logprobs.append(lp)
                if hit_stop or len(slot.generated) >= slot.max_tokens:
                    slot.done = True
                    METRICS.observe("request_latency_s", now - slot.t_submit)
                    events.append(StepEvent(slot.request_id, tok, True, lp))
                else:
                    events.append(StepEvent(slot.request_id, tok, False, lp))
        return events

    def _fail_nan_rows(self, bad: np.ndarray, now: float) -> List[StepEvent]:
        """Finish, with an error, every live request whose block produced NaN
        logprobs; its slot's carry is prefilled anew when the slot is reused."""
        events: List[StepEvent] = []
        for i, slot in enumerate(self.slots):
            if slot is None or slot.done or not bad[i]:
                continue
            slot.done = True
            slot.error = "numerical failure: NaN logits in decode"
            METRICS.inc("numerical_failures")
            METRICS.observe("request_latency_s", now - slot.t_submit)
            events.append(StepEvent(slot.request_id, -1, True, 0.0))
        return events


def _common_prefix(a: Sequence[int], b: Sequence[int], limit: Optional[int] = None) -> int:
    """Length of the common prefix of a and b, at most ``limit``."""
    n = min(len(a), len(b)) if limit is None else limit
    q = 0
    while q < n and a[q] == b[q]:
        q += 1
    return q
