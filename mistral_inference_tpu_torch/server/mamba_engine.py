"""Continuous-batching engine for a Mamba2 model (Codestral-Mamba),
counterpart of ``mistral_inference_tpu/server/mamba_engine.py``.

The client contract of ``server.engine.Engine`` (``submit``, ``cancel``,
``step``, ``run_to_completion``, ``StepEvent``) on the same base class, so
``server.api.Server`` serves a Mamba unchanged. What differs follows from a
recurrent state in place of the ring KV cache:

* a slot's state is one batch row of a ``MambaState`` (conv taps and SSD
  state). Admission zeroes the reclaimed rows and prefills the new ones in
  chunks with per-row seqlens; the other rows ride along at seqlens 0, and
  the masked mixer leaves their state as it was;
* decode blocks run ``generate._decode_block`` over T = 1 forwards, whose SSD
  goes through K9; a dead or budget-spent row runs at seqlens 0, a step with
  dt = 0 and a zeroed conv input that keeps its state's bits;
* no prefix cache: a slot's state is that after its prompt and its
  generation, and the state after a shared prefix no longer exists to copy;
* speculation is prompt lookup only (``draft_model="lookup"``) over
  ``speculative._mamba_lookup_block``, whose seqlens-masked commit absorbs
  the accepted prefix instead of rolling the state back. A draft model would
  need a rewind of its own recurrent state, and is refused.

Admission chunks are ``admit_chunk`` wide, whatever the prompts' lengths, with
the SSD's own chunk min(128, admit_chunk): a row's prefill then takes the
kernels of ``generate_mamba(chunk_size=admit_chunk)`` (the quantized linears'
route follows the row count) and rounds a bf16 state at the same positions.
The dense products ``dt_proj`` and the head run on fixed row blocks
(``ops.linear.fixed_rows_linear``), so a row's bits do not depend on the B
rows beside it: a plain request's tokens equal ``generate_mamba``'s of its
prompt alone, on the card too. The JAX engine's power-of-two widths, which
bound its compiled programs, would cost short prompts less.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from mistral_inference_tpu_torch.generate import DEFAULT_TOP_P, _mamba_prefill_step
from mistral_inference_tpu_torch.model import Mamba
from mistral_inference_tpu_torch.models.mamba import DEFAULT_CHUNK, MambaState
from mistral_inference_tpu_torch.server.engine import (
    LOOKUP,
    Request,
    StepEvent,
    _EngineBase,
    _gather_prompt_logprobs,
)
from mistral_inference_tpu_torch.utils import profiling
from mistral_inference_tpu_torch.utils.profiling import METRICS, Span

__all__ = ["MambaEngine", "StepEvent"]


def _reset_rows(state: MambaState, rows: torch.Tensor) -> None:
    """Zero the global batch rows ``rows`` of the state in place: conv taps,
    SSD state and tokens seen. Under data parallelism the conv taps and SSD
    state hold this rank's rows from ``state.row0``, of which those rows
    it holds are zeroed."""
    state.seen[rows] = 0
    if state.row0 is not None:
        rows = rows - state.row0
        rows = rows[(rows >= 0) & (rows < state.conv.shape[1])]
    state.conv[:, rows] = 0
    state.ssm[:, rows] = 0


class MambaEngine(_EngineBase):
    def __init__(
        self,
        model: Mamba,
        batch_size: int,
        max_seq_len: int,
        *,
        temperature: float = 0.0,
        eos_id: Optional[int] = None,
        decode_block: int = 8,
        admit_chunk: int = 512,
        seed: int = 0,
        draft_model: Optional[str] = None,
        spec_tokens: int = 8,
        pipeline: bool = True,
    ):
        if not isinstance(model, Mamba):
            raise TypeError(f"MambaEngine serves a Mamba, got {type(model).__name__}")
        if draft_model is not None and (not isinstance(draft_model, str)
                                        or draft_model not in LOOKUP):
            raise ValueError("Mamba speculation is draft-free: draft_model must be 'lookup' or "
                             f"'ngram', got {type(draft_model).__name__} {draft_model!r}")
        super().__init__(model, batch_size, max_seq_len, temperature=temperature, eos_id=eos_id,
                         decode_block=decode_block, admit_chunk=admit_chunk, seed=seed,
                         pipeline=pipeline)
        self.state = model.alloc_state(batch_size)
        self.lookup = self._spec = draft_model is not None
        if self._spec:
            self._init_spec(spec_tokens)

    def _decode_step(self, tok: torch.Tensor, seqlens: torch.Tensor) -> torch.Tensor:
        return self.model.forward(tok[:, None], seqlens, self.state, chunk=1)[:, 0]

    def _spec_dispatch(self, live, temps, top_ps):
        from mistral_inference_tpu_torch.speculative import _mamba_lookup_block

        t0, self._hist, self._hlen, out = _mamba_lookup_block(
            self.model, self._t0, self.state, self._hist, self._hlen, self.generator, temps,
            live, top_ps, K=self.K, n_iters=self._spec_iters, temperature=0.0,
            top_p=DEFAULT_TOP_P, ngram=2)
        return t0, out

    def _take(self) -> List[Tuple[int, Request]]:
        """Fill every free slot from the queue: (row, request) of each new one."""
        new: List[Tuple[int, Request]] = []
        for i in range(self.B):
            if (self.slots[i] is None or self.slots[i].done) and self.queue:
                if self.slots[i] is not None:
                    self._evicted[self.slots[i].request_id] = self.slots[i]
                self.slots[i] = self.queue.popleft()
                new.append((i, self.slots[i]))
        return new

    def _sweep(self, new, sweep: Span) -> None:
        """Zero the new rows' state and prefill them in ``admit_chunk``-wide
        chunks (the other rows ride along at seqlens 0). Prompt logprobs go
        to the requests that want them. Lookup mode then emits each new row's
        first token. Spans as ``Engine._sweep``'s."""
        rows = self._set_sampling(new)
        _reset_rows(self.state, rows)
        width = self.admit_chunk
        want_lp = any(r.want_logprobs for _, r in new)
        maxT = max(len(r.prompt) for _, r in new)
        self._sweep_attrs(sweep, "speculative" if self._spec else "full", new,
                          [self.B] * -(-maxT // width), sum(len(r.prompt) for _, r in new))
        with METRICS.span("engine.admit.prefill"):
            for s in range(0, maxT, width):
                tokens = np.zeros((self.B, width), np.int64)
                seqlens = np.zeros((self.B,), np.int32)
                for i, r in new:
                    chunk = r.prompt[s:s + width]
                    tokens[i, :len(chunk)] = chunk
                    seqlens[i] = len(chunk)
                if profiling.TRACING:
                    METRICS.expect_tokens([int(seqlens.sum())])
                lp_d, self.carry = _mamba_prefill_step(
                    self.model, self._to_device(tokens), self._to_device(seqlens), self.state,
                    self.carry, min(DEFAULT_CHUNK, width), want_logprobs=want_lp)
                if want_lp:
                    _gather_prompt_logprobs(new, lp_d, seqlens, s == 0)
            with METRICS.span("engine.admit.prefill.wait"):
                self._sync()
        if self._spec:
            with METRICS.span("engine.admit.spec", sample="admission_spec_s"):
                self._first_tokens(new, rows)
