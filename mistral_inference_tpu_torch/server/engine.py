"""Continuous-batching serving engine for a ``Transformer``, text and image
requests, plain or speculative (counterpart of
``mistral_inference_tpu/server/engine.py``). ``server/mamba_engine.py``
serves a ``Mamba`` on the same base class and client contract.

A fixed batch of B slots; each owns one row of the ring KV cache, whose
per-row ``kv_len`` already says how full it is.

* **Admission** runs the prefill of ``generate.py`` over the new rows in
  chunks of ``admit_chunk`` tokens, with seqlens 0 for every other
  row: those rows neither write the ring nor move their ``kv_len``, and their
  carried prelogits pass through. A reclaimed slot only resets its
  ``kv_len``: the stale ring bytes become invisible. A sweep waits until
  ``admit_waterline`` slots are free (its cost hardly depends on how many rows
  are new); a sweep of at most ``staging_batch`` rows prefills in a narrow
  staging cache, each chunk over the new rows whose prompts reach it, and
  adopts the rows (``cache.adopt_rows``); a request whose
  prompt shares a prefix with a resident row's prompt copies those ring slots
  (``cache.copy_prefix_rows``) instead of prefilling them. A sweep that
  holds an image request computes the multimodal embeddings of its whole
  prompts once (``models.vision.embed_multimodal``) and each chunk slices
  them; such a sweep takes no prefix reuse and no staging.
* **Decode** is ``generate._decode_block`` with per-row temperatures, top-p,
  liveness and token budgets. A finished or empty slot runs with seqlens 0,
  so its ring stays intact as a prefix source. With ``pipeline`` (the
  default) the next block is queued on the card before the previous block's
  tokens are read back and fanned out, so the host's bookkeeping overlaps the
  card's work; per-row request ids make sure a block never emits into a slot
  that a newer request took.
* **Speculative decode** (``draft_model`` a ``Transformer``, or "lookup" /
  "ngram" for prompt lookup): each step is one block of
  ``speculative._spec_block`` / ``_lookup_block`` iterations, every live row
  emitting 1 .. K + 1 tokens per iteration. The first token of a request is
  sampled from the prefill's carry at admission and emitted then, so TTFT is
  an admission-time quantity. The block is queued first, admission runs
  behind it, and the block is read back once. The target ring is allocated
  ``span`` = max_seq_len + the slack of one block's overshoot wide, so it
  never wraps when no window is shorter, and the fused verify kernel serves
  it (``speculative._spec_fused_ok``). A draft model keeps a ring of its own
  (reset, prefix-copied and prefilled with the target's); lookup keeps each
  row's token history on the device. Speculative serving is text-only.

The engine is host-side control; every O(model) operation is a forward of
``models/``, on the model's device, in inference mode (the cache and carry
are inference tensors: change them only inside it).

Under a mesh every rank runs an engine on the same requests in the same
order (``server/api.py`` replays the primary's calls): its forwards gather
every output before sampling, so every host decision is the same on every
rank. Under ``data`` a slot's ring row lives on the data rank that holds
global rows [d b, (d + 1) b) (``parallel/multihost.py``); fills, carries
and the host loop stay global, and a prefix copy or a staged row whose two
rows live on two data ranks moves over ``data`` (``multihost.copy_rows``).
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mistral_inference_tpu_torch.cache import KVCache, adopt_rows, copy_prefix_rows
from mistral_inference_tpu_torch.generate import (
    DEFAULT_TOP_P,
    _decode_block,
    _prefill_step,
    sample,
)
from mistral_inference_tpu_torch.model import Transformer
from mistral_inference_tpu_torch.models.transformer import MOE_RAGGED_ROWS, ragged_kernel_gate
from mistral_inference_tpu_torch.ops.linear import is_quantized, rows_alike
from mistral_inference_tpu_torch.utils import profiling
from mistral_inference_tpu_torch.utils.profiling import METRICS, Span

LOOKUP = ("lookup", "ngram")


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
    # Preprocessed (C, H, W) images, in the order of the prompt's image
    # tokens (``images.encode_user_content`` lays both out).
    images: List[np.ndarray] = field(default_factory=list)
    generated: List[int] = field(default_factory=list)
    # The generate() logprob contract: len(prompt) - 1 teacher-forced prompt
    # transitions (only for want_logprobs), then one per generated token.
    prompt_logprobs: List[float] = field(default_factory=list)
    gen_logprobs: List[float] = field(default_factory=list)
    # Prompt logprobs cost a vocab-head pass over every prefill position; an
    # admission sweep pays it when any of its rows asks.
    want_logprobs: bool = False
    t_submit: float = 0.0
    t_admit: float = 0.0  # the start of the sweep that took it
    t_first_token: float = 0.0
    done: bool = False
    # Set when the row's logits went NaN: the request fails loudly instead of
    # streaming garbage, and its slot is freed.
    error: Optional[str] = None
    # Its latest span: "request.queued" from submit to the sweep that takes
    # it, then "request.decode" from its first token to its end.
    span: Optional[Span] = field(default=None, repr=False, compare=False)


@dataclass
class StepEvent:
    request_id: int
    token: int
    finished: bool
    logprob: float = 0.0


@dataclass
class _Block:
    """A block queued on the card: its outputs, copied to the host behind it
    (``ready`` marks the copy's end on the card), its width in steps and the
    request id each row was decoding for (None: a dead row). A decode block's
    outputs are (tokens, logprobs), each (n, B); a speculative block's
    (emits, logprobs, accepts), (n, B, K + 1) twice and (n, B). With
    ``counted``, one more output: the counts kept on the card
    (``METRICS.take_on_device``) by those names, snapshot behind the block."""

    out: Tuple[torch.Tensor, ...]
    ready: Optional[torch.cuda.Event]
    n: int
    rids: List[Optional[int]]
    counted: Tuple[str, ...] = ()


class _EngineBase:
    """The client contract and the host loop that both engines share:
    ``submit``, ``cancel``, ``step``, ``run_to_completion``; the slots and
    the queue, the per-row sampling settings, the admission's waits, the
    pipelined decode block and its fan-out, the speculative step's ragged
    emission, and the engine's spans (``utils.profiling``). A subclass owns
    the model's state (a ring KV cache, a Mamba state) and provides
    ``_take`` and ``_sweep`` (admission), ``_decode_step`` and, for
    speculation, ``_spec_dispatch``."""

    lookup = False
    _spec = False

    def __init__(self, model, batch_size: int, max_seq_len: int, *, temperature: float,
                 eos_id: Optional[int], decode_block: int, admit_chunk: int, seed: int,
                 pipeline: bool):
        self.model = model
        self.device = model.device
        self.B = batch_size
        self.max_seq_len = max_seq_len
        self.temperature = temperature
        self.eos_id = eos_id
        self.decode_block = decode_block
        self.admit_chunk = admit_chunk
        self.pipeline = pipeline
        V = model.args.vocab_size
        self.carry = torch.zeros((batch_size, V), dtype=torch.float32, device=self.device)
        # Sampling settings per row, on the host (the all-greedy choice is
        # made there) and on the card.
        self._temps_h = np.zeros((batch_size,), np.float32)
        self._top_ps_h = np.full((batch_size,), DEFAULT_TOP_P, np.float32)
        self._temps = self._to_device(self._temps_h)
        self._top_ps = self._to_device(self._top_ps_h)
        # One generator per engine: sampled rows repeat for a seed and an
        # order of arrival.
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.slots: List[Optional[Request]] = [None] * batch_size
        self.queue: Deque[Request] = deque()
        self._ids = itertools.count()
        self._pending: Optional[_Block] = None
        # Finished requests whose slot this step's admission reused: a
        # pipelined step admits before the caller reads the step's events.
        self._evicted: Dict[int, Request] = {}
        # First tokens emitted at a speculative admission, returned by the step.
        self._pending_events: List[StepEvent] = []

    def _init_spec(self, spec_tokens: int) -> int:
        """The speculative block's iterations and the slack it needs past
        max_seq_len: a row that finishes in a block's first iteration keeps
        verifying to the block's end. Returns the span every per-row buffer
        covers."""
        self.K = int(spec_tokens)
        if self.K < 1:
            raise ValueError(f"spec_tokens must be at least 1, got {spec_tokens}")
        # At least one iteration per block; about decode_block tokens a row.
        self._spec_iters = max(1, self.decode_block // (self.K + 1))
        span = self.max_seq_len + self._spec_iters * (self.K + 1) + self.K + 2
        self._t0 = torch.zeros((self.B,), dtype=torch.int64, device=self.device)
        if self.lookup:
            self._hist = torch.zeros((self.B, span), dtype=torch.int64, device=self.device)
            self._hlen = torch.zeros((self.B,), dtype=torch.int64, device=self.device)
        return span

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
        one batched decode. ``stop_ids`` are stop tokens beside ``eos_id``.
        ``images`` are the request's preprocessed (C, H, W) arrays, one per
        image-token grid of the prompt, for a model with a vision encoder."""
        if len(images):
            if getattr(self.model.args, "vision_encoder", None) is None:
                raise ValueError("image inputs need a model with a vision encoder")
            if self._spec:
                raise ValueError("speculative serving is text-only: no image inputs")
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
            stop_ids=tuple(stop_ids), images=list(images), want_logprobs=want_logprobs,
            t_submit=time.perf_counter(),
        )
        req.span = METRICS.open_span("request.queued", (req.request_id,), start=req.t_submit)
        self.queue.append(req)
        return req.request_id

    def cancel(self, request_id: int) -> bool:
        """Finish a request early: a queued one leaves the queue, a live one
        frees its slot. False if it is neither."""
        for i, r in enumerate(self.queue):
            if r.request_id == request_id:
                del self.queue[i]
                METRICS.close_span(r.span)
                return True
        for s in self.slots:
            if s is not None and s.request_id == request_id and not s.done:
                s.done = True
                self._end_decode_span(s, time.perf_counter())
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
        only ends rows earlier). A speculative engine takes ``_step_spec``.

        The step is the span ``engine.step``; it sets the gauges
        ``queue_depth`` and ``live_rows`` as it leaves them."""
        with METRICS.span("engine.step"):
            events = self._step()
        METRICS.set("queue_depth", len(self.queue))
        METRICS.set("live_rows", sum(s is not None and not s.done for s in self.slots))
        return events

    def _step(self) -> List[StepEvent]:
        self._evicted.clear()
        if self._spec:
            return self._step_spec()
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

    # -- shared internals ---------------------------------------------------

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

    def _set_sampling(self, new) -> torch.Tensor:
        """Record the new rows' sampling settings on the host and the card;
        returns the rows' indices on the device."""
        for i, r in new:
            self._temps_h[i] = r.temperature
            self._top_ps_h[i] = r.top_p
        self._temps = self._to_device(self._temps_h)
        self._top_ps = self._to_device(self._top_ps_h)
        return self._to_device(np.array([i for i, _ in new], np.int64))

    def _sampling(self, live_rows: List[bool]):
        """(temps, top_ps) for a block: None, None when every live row is
        greedy (the float temperature 0 takes the argmax alone, and no
        sampler runs)."""
        if all(t <= 0 for t, on in zip(self._temps_h, live_rows) if on):
            return None, None
        return self._temps, self._top_ps

    def _to_host(self, out: Sequence[torch.Tensor], n: int, rids: List[Optional[int]]) -> _Block:
        """Queue the copy of a block's outputs to the host, with the counts
        kept on the card so far (``METRICS.take_on_device``); the block
        (``ready`` None on the CPU)."""
        out = list(out)
        taken = METRICS.take_on_device(self.carry.device)
        counted = ()
        if taken is not None:
            counted = taken[0]
            out.append(taken[1])
        if self.device.type != "cuda":
            return _Block(tuple(out), None, n, rids, counted)
        host = tuple(t.to("cpu", non_blocking=True) for t in out)
        ready = torch.cuda.Event()
        ready.record()
        return _Block(host, ready, n, rids, counted)

    @staticmethod
    def _read(block: _Block) -> Tuple[np.ndarray, ...]:
        """A block's outputs on the host, once its copy has landed (the span
        ``engine.drain.wait``); its counts are folded into ``METRICS``."""
        with METRICS.span("engine.drain.wait"):
            if block.ready is not None:
                block.ready.synchronize()
        out = tuple(t.numpy() for t in block.out)
        if block.counted:
            METRICS.fold(block.counted, out[-1])
            out = out[:-1]
        return out

    def _valid(self, rids: List[Optional[int]]) -> np.ndarray:
        """A row counts only while its slot still holds the request the block
        was queued for: a slot freed and reused since gets none of it."""
        return np.array([rid is not None and s is not None and s.request_id == rid
                         for rid, s in zip(rids, self.slots)])

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
        so a row never writes past prompt + max_tokens. The span
        ``engine.dispatch`` holds the host's whole time here: the block's n
        forwards are enqueued, one after another."""
        with METRICS.span("engine.dispatch") as sp:
            n = self._block_size()
            live_rows = self._live_rows()
            remaining = self._remaining(prev)
            sp.rids = rids = [s.request_id if on else None for s, on in zip(self.slots, live_rows)]
            sp.attrs.update(n=n, live=sum(live_rows), B=self.B)
            live = self._to_device(np.array(live_rows, np.int32))
            budget = self._to_device(np.array(remaining, np.int32))
            temps, top_ps = self._sampling(live_rows)
            if profiling.TRACING:  # step i decodes the rows whose budget exceeds i
                METRICS.expect_tokens([sum(r > i for r in remaining) for i in range(n)])
            toks, lps, self.carry = _decode_block(
                self._decode_step, self.carry, n, 0.0, DEFAULT_TOP_P, self.generator,
                temps=temps, live=live, top_ps=top_ps, budget=budget,
            )
            self._pending = self._to_host((toks, lps), n, rids)

    def _emit(self, slot: Request, tok: int, lp: float, now: float) -> StepEvent:
        """One token of a live request: EOS and stop ids end it (the token
        is not appended), as does reaching max_tokens."""
        hit_stop = tok == self.eos_id or tok in slot.stop_ids
        if not hit_stop:
            slot.generated.append(tok)
            slot.gen_logprobs.append(lp)
        if hit_stop or len(slot.generated) >= slot.max_tokens:
            slot.done = True
            METRICS.observe("request_latency_s", now - slot.t_submit)
            self._end_decode_span(slot, now)
            return StepEvent(slot.request_id, tok, True, lp)
        return StepEvent(slot.request_id, tok, False, lp)

    @staticmethod
    def _first_token(slot: Request, now: float) -> None:
        """A request's first token reached the host: its ``request.decode``
        span opens, under the sweep that admitted it."""
        slot.t_first_token = now
        METRICS.observe("ttft_s", now - slot.t_submit)
        sweep = slot.span.parent if slot.span is not None else 0
        slot.span = METRICS.open_span("request.decode", (slot.request_id,), start=now)
        slot.span.parent = sweep

    @staticmethod
    def _end_decode_span(slot: Request, now: float) -> None:
        if slot.span is not None and slot.span.name == "request.decode":
            METRICS.close_span(slot.span, now)

    def _drain(self, block: Optional[_Block]) -> List[StepEvent]:
        """Read back a decode block and turn it into events: tokens, EOS and
        stop ids, max_tokens, NaN failures. The span ``engine.drain`` counts
        the tokens handed to requests against the block's B x n slots."""
        if block is None:
            return []
        with METRICS.span("engine.drain", block.rids, slots=self.B * block.n) as sp:
            toks, lps = self._read(block)  # (n, B) each
            with METRICS.span("engine.fanout"):
                now = time.perf_counter()
                valid = self._valid(block.rids)
                events = self._fail_nan_rows(np.isnan(lps).any(axis=0) & valid, now)
                failed = len(events)
                for t in range(block.n):
                    for i, slot in enumerate(self.slots):
                        if slot is None or slot.done or not valid[i]:
                            continue
                        if not slot.generated and not slot.t_first_token:
                            self._first_token(slot, now)
                        events.append(self._emit(slot, int(toks[t, i]), float(lps[t, i]), now))
            sp.attrs["tokens"] = len(events) - failed
        return events

    def _fail_nan_rows(self, bad: np.ndarray, now: float) -> List[StepEvent]:
        """Finish, with an error, every live request whose block produced NaN
        logprobs; its slot's state is prefilled anew when the slot is reused."""
        events: List[StepEvent] = []
        for i, slot in enumerate(self.slots):
            if slot is None or slot.done or not bad[i]:
                continue
            slot.done = True
            slot.error = "numerical failure: NaN logits in decode"
            METRICS.inc("numerical_failures")
            METRICS.observe("request_latency_s", now - slot.t_submit)
            self._end_decode_span(slot, now)
            events.append(StepEvent(slot.request_id, -1, True, 0.0))
        return events

    # -- admission ----------------------------------------------------------

    @torch.inference_mode()
    def _admit(self) -> None:
        """Take waiting requests into free slots (``_take``) and prefill them
        in one sweep (``_sweep``). Spans: ``engine.admit`` holds it all,
        ``engine.admit.wait`` is the wait for the block in flight, and
        ``engine.admit.sweep``, the admission's clock (its length is the
        sample ``admission_prefill_s``), ends each new request's
        ``request.queued`` where it starts."""
        if not self.queue:
            return
        with METRICS.span("engine.admit") as sp:
            new = self._take()
            if not new:
                return
            sp.rids = tuple(r.request_id for _, r in new)
            # The block in flight precedes this admission on the card; wait for
            # it before the clock starts, so that decode time is not charged to
            # admission (and the sweep's planning reads settled fills).
            with METRICS.span("engine.admit.wait"):
                self._sync()
            with METRICS.span("engine.admit.sweep", sp.rids, sample="admission_prefill_s") as sweep:
                for _, r in new:
                    r.t_admit = sweep.start
                    METRICS.close_span(r.span, sweep.start, sweep.id)
                self._sweep(new, sweep)
            METRICS.inc("requests_admitted", len(new))

    def _sweep_attrs(self, sweep: Span, kind: str, new, chunk_rows: Sequence[int], real: int,
                     copied: int = 0) -> None:
        """A sweep's attributes: its kind ("staged", "full", "images",
        "speculative"), the new rows, the rows its first chunk carries, its
        chunks, the real prompt tokens it prefills, the tokens it carries
        (each chunk's rows x ``admit_chunk``, summed) and the prefix tokens
        it copies. ``chunk_rows`` holds each chunk's row count."""
        sweep.attrs.update(kind=kind, new=len(new), rows=chunk_rows[0], chunks=len(chunk_rows),
                           real=real, carried=sum(chunk_rows) * self.admit_chunk, copied=copied)

    # -- speculative serving ------------------------------------------------

    def _first_tokens(self, new, rows: torch.Tensor) -> None:
        """The speculative admission's tail: sample each new row's first
        token from the prefill's carry (the speculative loop's invariant
        needs t0 = a correct token whose state is not yet written), load
        each new row's history (prompt + t0) for lookup, and emit the first
        tokens as pending events. One read-back for the sweep."""
        carry = self.carry[rows]
        greedy = all(r.temperature <= 0 for _, r in new)
        t0 = sample(carry, 0.0 if greedy else self._temps[rows], self._top_ps[rows],
                    self.generator)
        lp = F.log_softmax(carry, dim=-1).gather(-1, t0[:, None])[:, 0]
        self._t0[rows] = t0
        t0_h, lp_h = t0.cpu().numpy(), lp.cpu().numpy()
        if self.lookup:
            hist = np.zeros((len(new), self._hist.shape[1]), np.int64)
            for j, (_, r) in enumerate(new):
                hist[j, :len(r.prompt)] = r.prompt
                hist[j, len(r.prompt)] = t0_h[j]
            self._hist[rows] = self._to_device(hist)
            self._hlen[rows] = self._to_device(np.array([len(r.prompt) + 1 for _, r in new]))
        now = time.perf_counter()
        for j, (_, r) in enumerate(new):
            self._first_token(r, now)
            self._pending_events.append(self._emit(r, int(t0_h[j]), float(lp_h[j]), now))

    def _take_pending(self) -> List[StepEvent]:
        events, self._pending_events = self._pending_events, []
        return events

    def _step_spec(self) -> List[StepEvent]:
        """One block of ``_spec_iters`` [propose -> verify -> commit]
        iterations; each live row emits its accepted drafts and the target's
        own next token per iteration. The block is queued first; admission
        runs behind it on the card and its first tokens join this step's
        events; then the block is read back once. Rows dead at dispatch run
        frozen (seqlens 0), and the request-id tags keep a slot reused since
        from taking the block's tokens."""
        live_rows = self._live_rows()
        if not any(live_rows):
            self._admit()
            return self._take_pending()
        with METRICS.span("engine.dispatch") as sp:
            sp.rids = rids = [s.request_id if on else None for s, on in zip(self.slots, live_rows)]
            sp.attrs.update(n=self._spec_iters, live=sum(live_rows), B=self.B)
            live = self._to_device(np.array(live_rows, np.int32))
            temps, top_ps = self._sampling(live_rows)
            self._t0, out = self._spec_dispatch(live, temps, top_ps)
            block = self._to_host(out, self._spec_iters, rids)
        self._admit()
        events = self._take_pending()
        with METRICS.span("engine.drain", sp.rids,
                          slots=self.B * self._spec_iters * (self.K + 1)) as drain:
            emits, lps, accepts = self._read(block)  # (n, B, K + 1) x 2, (n, B)
            with METRICS.span("engine.fanout"):
                now = time.perf_counter()
                valid = self._valid(rids)
                events.extend(self._fail_nan_rows(np.isnan(lps).any(axis=(0, 2)) & valid, now))
                emitted = iter_rows = 0
                for it in range(emits.shape[0]):
                    for i, slot in enumerate(self.slots):
                        if slot is None or slot.done or not valid[i]:
                            continue
                        iter_rows += 1
                        for j in range(int(accepts[it, i]) + 1):
                            emitted += 1
                            events.append(self._emit(slot, int(emits[it, i, j]),
                                                     float(lps[it, i, j]), now))
                            if slot.done:
                                break
            drain.attrs["tokens"] = emitted
        if iter_rows:
            METRICS.observe("spec_tokens_per_forward", emitted / iter_rows)
        return events


class Engine(_EngineBase):
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
        spec_tokens: int = 4,
        prefix_cache: bool = True,
        prefix_min: int = 16,
        admit_waterline: Optional[int] = None,
        staging_batch: Optional[int] = None,
        pipeline: bool = True,
    ):
        if not isinstance(model, Transformer):
            raise TypeError(f"Engine serves a Transformer, got {type(model).__name__}; serve a "
                            "Mamba with server.mamba_engine.MambaEngine")
        super().__init__(model, batch_size, max_seq_len, temperature=temperature, eos_id=eos_id,
                         decode_block=decode_block, admit_chunk=admit_chunk, seed=seed,
                         pipeline=pipeline)
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

        self.lookup = isinstance(draft_model, str)
        if self.lookup and draft_model not in LOOKUP:
            raise ValueError(f"draft_model must be a Transformer, 'lookup' or 'ngram', "
                             f"got {draft_model!r}")
        self.draft: Optional[Transformer] = None if self.lookup else draft_model
        self._spec = self.lookup or self.draft is not None
        self._spec_fused = False
        self._span = max_seq_len
        if self._spec:
            # Speculative rows finish at staggered times: batch their
            # re-admissions harder. A lookup engine stages a sweep of up to
            # one more than that (a block often frees waterline + 1 rows); a
            # draft engine never stages (its draft ring would need the same).
            if admit_waterline is None:
                self.admit_waterline = max(2, batch_size // 4)
            if self.lookup and staging_batch is None and self._staging_B:
                self._staging_B = min(batch_size - 1, self.admit_waterline + 1)
            # The span before the ring: it is allocated once, at its width.
            self._span = self._init_spec(spec_tokens)

        self.cache: KVCache = model.alloc_cache(batch_size, self._span)
        self.prefix_cache = prefix_cache
        self.prefix_min = prefix_min
        self._slot_prompt: List[Optional[List[int]]] = [None] * batch_size
        self._min_window = min(self.cache.windows)

        if self._spec:
            from mistral_inference_tpu_torch.speculative import _spec_fused_ok

            self._spec_fused = _spec_fused_ok(model, self.cache, self.K, self._span)
        if self.draft is not None:
            self._check_draft(self.draft)
            self.dcache: KVCache = self.draft.alloc_cache(batch_size, self._span)
            self.dcarry = torch.zeros_like(self.carry)

    def _check_draft(self, draft) -> None:
        if not isinstance(draft, Transformer):
            raise TypeError(f"the draft must be a Transformer, got {type(draft).__name__}")
        if draft.args.vocab_size != self.model.args.vocab_size:
            raise ValueError("draft and target must share a vocabulary")
        if draft.device != self.device:
            raise ValueError(f"draft on {draft.device}, target on {self.device}")
        dw = draft.args.sliding_window
        dws = [w for w in (dw if isinstance(dw, list) else [dw]) if w is not None]
        if dws and min(dws) < self._span:
            raise ValueError(f"draft sliding window {dws} < {self._span}: the draft ring would "
                             "wrap, making speculative rewind unsafe; use a full-context draft")

    # -- engine internals ---------------------------------------------------

    def _decode_step(self, tok: torch.Tensor, seqlens: torch.Tensor) -> torch.Tensor:
        return self.model.forward(tok[:, None], seqlens, self.cache, attend_cache=True)[:, 0]

    def _spec_dispatch(self, live, temps, top_ps):
        from mistral_inference_tpu_torch import speculative as sp

        kw = dict(K=self.K, n_iters=self._spec_iters, temperature=0.0, top_p=DEFAULT_TOP_P,
                  spec_fused=self._spec_fused)
        if self.lookup:
            t0, self._hist, self._hlen, out = sp._lookup_block(
                self.model, self._t0, self.cache, self._hist, self._hlen, self.generator,
                temps, live, top_ps, ngram=2, **kw)
            return t0, out
        return sp._spec_block(self.model, self.draft, self._t0, self.cache, self.dcache,
                              self.generator, temps, live, top_ps, **kw)

    def _take(self) -> List[Tuple[int, Request]]:
        """Fill free slots from the queue: (row, request) of each new one."""
        free = [i for i in range(self.B) if self.slots[i] is None or self.slots[i].done]
        # Batched admission: while rows run, wait for enough free slots to
        # share one sweep; with nothing running, waiting would stall.
        if (self.queue and any(self._live_rows())
                and len(free) < min(len(self.queue), self.admit_waterline)):
            return []
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
        return new

    def _sweep(self, new, sweep: Span) -> None:
        """Prefill the new rows in chunks of ``admit_chunk`` tokens, staged
        (each chunk carries the new rows still prefilling) or in the full
        batch (the other rows ride along with seqlens 0), after their prefix
        copies. Prompt logprobs are gathered per chunk for the
        rows that want them: the numbers generate() returns. A speculative
        engine then prefills the draft's ring too and emits each new row's
        first token. Spans: ``engine.admit.prefill`` (a staged one's length
        is the sample ``admission_staged_s``) ending in its wait for the
        card, ``engine.admit.prefill.wait``; ``engine.admit.spec``
        (``admission_spec_s``)."""
        offs, copies = self._plan_prefix_reuse(new)
        maxT = max(len(r.prompt) - offs.get(i, 0) for i, r in new)
        rows = self._set_sampling(new)
        # Reclaimed rows start empty: their stale ring bytes become invisible.
        self.cache.kv_len[rows] = 0
        if self.draft is not None:
            self.dcache.kv_len[rows] = 0
        self._apply_prefix_copies(copies)
        for i, r in new:  # after the planning: a wave cannot source itself
            self._slot_prompt[i] = list(r.prompt)
        prompts: List[Sequence[int]] = [()] * self.B
        for i, r in new:
            prompts[i] = r.prompt[offs.get(i, 0):]

        with_images = any(r.images for _, r in new)
        staged = bool(self._staging_B and len(new) <= self._staging_B and not copies
                      and not with_images and self.draft is None)
        kind = ("staged" if staged else "images" if with_images
                else "speculative" if self._spec else "full")
        starts = range(0, maxT, self.admit_chunk)
        staged_new = new
        if staged and _compacts(self.model, self._staging_B, self.admit_chunk):
            # Longest prompt first: the rows chunk c carries lead the cache.
            staged_new = sorted(new, key=lambda e: -len(e[1].prompt))  # stable
            chunk_rows = [sum(len(r.prompt) > s for _, r in new) for s in starts]
        else:
            chunk_rows = [self._staging_B if staged else self.B] * len(starts)
        self._sweep_attrs(sweep, kind, new, chunk_rows, sum(len(prompts[i]) for i, _ in new),
                          sum(q for _, _, q in copies))
        with METRICS.span("engine.admit.prefill", sample="admission_staged_s" if staged else None):
            if staged:
                self._admit_staged(staged_new, chunk_rows)
            else:
                embeds = None
                if with_images:  # the whole prompts' embeddings, sliced per chunk
                    from mistral_inference_tpu_torch.models.vision import embed_multimodal

                    images = [[] for _ in range(self.B)]
                    for i, r in new:
                        images[i] = r.images
                    embeds = embed_multimodal(self.model, prompts, images)
                # The first chunk of a sweep without prefix copies attends to
                # itself alone: every new row's ring is empty.
                self.carry = self._prefill(self.model, new, prompts, self.cache, self.carry,
                                           chunk_rows, attend_first=bool(offs), embeds=embeds)
            with METRICS.span("engine.admit.prefill.wait"):
                self._sync()
        if staged:
            METRICS.inc("staged_admissions")
        if self._spec:
            with METRICS.span("engine.admit.spec", sample="admission_spec_s"):
                if self.draft is not None:  # the draft's ring from the same offsets
                    self.dcarry = self._prefill(self.draft, [], prompts, self.dcache,
                                                self.dcarry, chunk_rows, attend_first=bool(offs))
                self._first_tokens(new, rows)

    def _prefill(self, model, new, prompts, cache, carry, chunk_rows: Sequence[int],
                 attend_first: bool, embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Chunks of ``admit_chunk`` of each row's ``prompts`` entry (empty: a
        row that rides along) through ``model`` into ``cache``; returns the
        new carry. Prompt logprobs go to the requests of ``new`` that want
        them (their rows in ``prompts`` are whole prompts: no prefix was
        copied). ``embeds`` (rows, max prompt length, dim), the input
        embeddings of the whole prompts, is sliced per chunk and zero-padded
        like the tokens. Chunk c carries the leading ``chunk_rows[c]`` rows:
        where that is fewer than ``prompts`` holds (a staged sweep, its
        prompts longest first, on a cache that holds every row), the rows
        whose prompt reaches the chunk, through ``KVCache.leading`` (no copy)
        and the leading rows of ``carry``; a row that has left keeps its
        carry.

        Every chunk is ``admit_chunk`` wide, however short the prompts: a
        row's prefill then runs the chunks of ``generate(chunk_size=
        admit_chunk)`` and its linears the same route (which ``ops/linear``
        picks by the row count, K5 for rows x admit_chunk while that stays
        under 8192), whatever it is admitted with. So a request's tokens do
        not depend on its batch: a narrower chunk would send a sweep of short
        prompts through K3, whose other rounding an fp8 ring turns into
        another token far from a near-tie (seen on the card). Narrow chunks
        (the JAX engine's powers of two, which bound its compiled programs)
        cost short prompts less. The head's products of every chunk run at
        ``len(prompts)`` rows, so a row's carry and prompt logprobs do not
        depend on how many rows its chunks hold; the layers' products take
        one route at every row count a compacted chunk has (``_compacts``)."""
        width = self.admit_chunk
        want_lp = any(r.want_logprobs for _, r in new)
        n_rows = len(prompts)
        for c, k in enumerate(chunk_rows):
            s = c * width
            tokens = np.zeros((k, width), np.int64)
            seqlens = np.zeros((k,), np.int32)
            for b, p in enumerate(prompts[:k]):
                chunk = p[s:s + width]
                tokens[b, :len(chunk)] = chunk
                seqlens[b] = len(chunk)
            if profiling.TRACING:
                METRICS.expect_tokens([int(seqlens.sum())])
            chunk_embeds = None
            if embeds is not None:
                chunk_embeds = embeds[:k, s:s + width]
                chunk_embeds = F.pad(chunk_embeds, (0, 0, 0, width - chunk_embeds.shape[1]))
            chunk_cache = cache if k == n_rows else cache.leading(k)
            lp_d, last = _prefill_step(
                model, self._to_device(tokens), self._to_device(seqlens), chunk_cache,
                carry[:k], attend_cache=s > 0 or attend_first, want_logprobs=want_lp,
                input_embeds=chunk_embeds, pad_rows=n_rows,
            )
            if k == n_rows:
                carry = last
            else:
                cache.kv_len[:k] = chunk_cache.kv_len
                carry = torch.cat([last, carry[k:]])
            if want_lp:
                _gather_prompt_logprobs(new, lp_d, seqlens, s == 0)
        return carry

    def _admit_staged(self, new, chunk_rows: Sequence[int]) -> None:
        """Prefill the few new rows in a staging cache of ``staging_batch``
        rows, in the order of ``new``, chunk c over the leading
        ``chunk_rows[c]`` rows (where the sweep compacts, ``new`` runs
        longest prompt first and those are the rows still prefilling), then
        adopt them whole into the main cache: ring bytes,
        scales, fills and carry rows move exactly, so the adopted rows hold
        what their own prefill wrote. Only the plain products, the vocab
        head's and an MoE router's, see another row count than a full
        sweep's (``staging_batch`` rows, in every staged sweep), which may
        move a carried logit by an ulp on the card."""
        Bs = self._staging_B
        if self._stage_cache is None:
            # The main cache's span: the same windows, the same slots.
            self._stage_cache = self.model.alloc_cache(Bs, self._span)
        sc = self._stage_cache
        sc.kv_len.zero_()  # fresh rows: stale staging bytes are invisible
        scarry = torch.zeros((Bs, self.carry.shape[1]), dtype=torch.float32, device=self.device)
        staged = [(j, r) for j, (_, r) in enumerate(new)]
        prompts = [r.prompt for _, r in new] + [()] * (Bs - len(new))
        scarry = self._prefill(self.model, staged, prompts, sc, scarry, chunk_rows,
                               attend_first=False)
        self.cache, self.carry = adopt_rows(
            self.cache, self.carry, sc, scarry, list(range(len(new))), [i for i, _ in new],
            self.model.mesh)

    def _plan_prefix_reuse(self, new) -> Tuple[Dict[int, int], List[Tuple[int, int, int]]]:
        """For each new request, the resident row whose prompt shares the
        longest prefix and whose ring still holds it. Returns ({row: prefix
        length}, [(src, dst, q)] in an order safe to apply).

        A source's positions [0, q) are in slots [0, q) only if its ring
        never wrapped: its fill must not exceed the smallest window (finished
        rows are frozen, so they stay usable). Rows that want prompt
        logprobs take no prefix: those positions' logprobs were never
        computed for them. A wave with images takes none: its chunks slice
        one embedding matrix of the whole prompts."""
        offs: Dict[int, int] = {}
        copies: List[Tuple[int, int, int]] = []
        if not self.prefix_cache or any(r.images for _, r in new):
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
        """Copy the planned prefixes, into the draft's ring too."""
        if not copies:
            return
        srcs, dsts, qs = zip(*copies)
        copy_prefix_rows(self.cache, srcs, dsts, qs, self.model.mesh)
        if self.draft is not None:
            copy_prefix_rows(self.dcache, srcs, dsts, qs, self.draft.mesh)
        METRICS.inc("prefix_hits", len(copies))
        METRICS.inc("prefix_tokens_reused", sum(qs))


def _compacts(model: Transformer, staging_B: int, width: int) -> bool:
    """Whether a staged chunk may carry only the rows still prefilling, k of
    the ``staging_B`` staging rows: only where each product of the chunk's
    ``k x width`` rows takes one hand-written kernel at every k, so that a
    row's bits do not depend on the rows staged beside it. ``ops.linear``
    routes a quantized product by its row count, and cuBLAS picks a plain
    product's kernel by it: so every layer weight is quantized and
    ``rows_alike``, no adapter is live, and an MoE layer's experts take K5's
    ragged route ("dispatch" above ``MOE_RAGGED_ROWS`` rows; its capacities
    below, and the "dense" oracle's plain products, depend on the rows). The
    head's and the router's plain products run at the staging width
    (``_prefill_step``). Never under data parallelism: each data rank holds
    a fixed share of the staging rows."""
    if model.mesh is not None and model.mesh.data > 1:
        return False
    counts = [k * width for k in range(1, staging_B + 1)]
    args, layers = model.args, model.params["layers"]
    keys = ("wqkv", "wo") if args.moe else ("wqkv", "wo", "w13", "w2")
    if any("lora" in lw or not all(is_quantized(lw[key]) and rows_alike(lw[key], counts)
                                   for key in keys) for lw in layers):
        return False
    if args.moe is None:
        return True
    x = torch.empty((0, args.dim))  # the gate reads the width alone
    return (args.moe_impl == "dispatch" and width > MOE_RAGGED_ROWS
            and all(ragged_kernel_gate(x, lw) for lw in layers))


def _gather_prompt_logprobs(new, lp_d: torch.Tensor, seqlens: np.ndarray, first: bool) -> None:
    """A prefill chunk's teacher-forced logprobs (rows, T) to the requests of
    ``new`` [(row, request)] that want them: each row's valid positions, less
    a prompt's first token, which has none. A row past the chunk's rows (a
    compacted chunk's) has none here."""
    lp = lp_d.cpu().numpy()
    for b, r in new:
        if r.want_logprobs and b < len(seqlens) and seqlens[b]:
            r.prompt_logprobs.extend(lp[b, (1 if first else 0):seqlens[b]].tolist())


def _common_prefix(a: Sequence[int], b: Sequence[int], limit: Optional[int] = None) -> int:
    """Length of the common prefix of a and b, at most ``limit``."""
    n = min(len(a), len(b)) if limit is None else limit
    q = 0
    while q < n and a[q] == b[q]:
        q += 1
    return q
