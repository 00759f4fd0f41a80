"""CPU tests of the readers of the program's spans, on synthetic span lists
(no engine runs): each takes only the spans of the run's host span, and a
program that records no spans gives None. ``python -m pytest perfbench/tests
-q`` from the checkout's root."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

import tiny  # noqa: F401  (puts the checkout on sys.path)
from perfbench import drive, stats
from perfbench.spec import metric_reader

from mistral_inference_tpu_torch.utils import profiling


def _span(name, start, end, **attrs):
    return SimpleNamespace(name=name, start=start, end=end, id=0, parent=0, rids=(), attrs=attrs)


def _run(spans, monkeypatch, host_span=(10.0, 20.0), end=25.0):
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    log = drive.RunLog([], [], 0.0, 10.0, 20.0, end, end, "open")
    return stats.Run(log, 5.0, host_span)


def test_queue_wait_is_the_p90_of_the_requests_submitted_in_the_host_span(monkeypatch):
    spans = [_span("request.queued", 10.0 + i, 10.5 + i + 0.1 * i) for i in range(9)]
    spans.append(_span("request.queued", 19.0, None))  # never taken: waits to the drain's end
    spans += [_span("request.queued", 9.0, 19.0),  # submitted before the host span
              _span("request.queued", 20.0, 21.0),  # after it
              _span("engine.admit.sweep", 12.0, 13.0, real=1, carried=2)]
    read = metric_reader("queue_wait_p90_s")
    # Waits 0.5 .. 1.3 and 6.0: the ceil(0.9 x 10) = 9th smallest is 1.3.
    assert read(_run(spans, monkeypatch)) == pytest.approx(1.3)
    assert read(_run(spans[:9], monkeypatch)) == pytest.approx(1.3)
    assert read(_run(spans[9:10], monkeypatch)) == pytest.approx(6.0)
    assert read(_run([], monkeypatch)) is None


@pytest.mark.parametrize("name", ["admission_token_share", "admission_token_share.tput"])
def test_admission_token_share_is_real_over_carried_tokens(name, monkeypatch):
    spans = [_span("engine.admit.sweep", 11.0, 12.0, real=2100, carried=12288),
             _span("engine.admit.sweep", 13.0, 15.0, real=900, carried=32768),
             _span("engine.admit.sweep", 19.5, 20.5, real=1, carried=1),  # ends past the span
             _span("engine.admit.sweep", 16.0, None, real=1, carried=1),  # still open
             _span("engine.drain", 12.0, 13.0, tokens=5, slots=8)]
    read = metric_reader(name)
    assert read(_run(spans, monkeypatch)) == pytest.approx(100.0 * 3000 / 45056)
    assert read(_run(spans[4:], monkeypatch)) is None


def test_decode_row_share_is_tokens_handed_over_slots(monkeypatch):
    spans = [_span("engine.drain", 11.0, 11.1, tokens=500, slots=512),
             _span("engine.drain", 12.0, 12.1, tokens=100, slots=512),
             _span("engine.drain", 9.0, 10.5, tokens=0, slots=512),  # starts before the span
             _span("engine.dispatch", 11.1, 11.6, n=8, live=64, B=64)]
    read = metric_reader("decode_row_share")
    assert read(_run(spans, monkeypatch)) == pytest.approx(100.0 * 600 / 1024)
    assert read(_run(spans[2:], monkeypatch)) is None


def test_decode_enqueue_is_dispatch_time_per_forward(monkeypatch):
    spans = [_span("engine.dispatch", 11.0, 11.5, n=8, live=64, B=64),
             _span("engine.dispatch", 12.0, 12.1, n=2, live=3, B=64),
             _span("engine.dispatch", 19.9, 20.4, n=8, live=64, B=64),  # ends past the span
             _span("engine.drain", 11.5, 11.6, tokens=500, slots=512)]
    read = metric_reader("decode_enqueue_ms")
    assert read(_run(spans, monkeypatch)) == pytest.approx(1e3 * 0.6 / 10)
    assert read(_run(spans[2:], monkeypatch)) is None


@pytest.mark.parametrize("name", ["queue_wait_p90_s", "admission_token_share",
                                  "admission_token_share.tput", "decode_row_share",
                                  "decode_enqueue_ms"])
def test_a_program_without_spans_reads_none(name, monkeypatch):
    """A program older than its spans (the parent of the change that added
    them) has no ``spans`` to import: the reader gives None, and raises
    nothing."""
    run = _run([_span("engine.drain", 11.0, 11.1, tokens=1, slots=1)], monkeypatch)
    monkeypatch.delattr(profiling, "spans")
    assert metric_reader(name)(run) is None


def test_the_program_records_the_spans_the_readers_read():
    """The names and attributes the readers take are those the engine
    records (its own CPU tests hold their values)."""
    import torch

    from mistral_inference_tpu_torch.args import TransformerArgs
    from mistral_inference_tpu_torch.model import Transformer
    from mistral_inference_tpu_torch.server.engine import Engine

    args = TransformerArgs(dim=64, n_layers=1, head_dim=16, hidden_dim=128, n_heads=4,
                           n_kv_heads=2, norm_eps=1e-5, vocab_size=128, max_batch_size=2)
    eng = Engine(Transformer.random(args, dtype=torch.float32, seed=0, device="cpu"),
                 batch_size=2, max_seq_len=32, admit_chunk=8)
    start = len(profiling.METRICS.spans)
    eng.submit([1, 2, 3], max_tokens=3)
    eng.run_to_completion()
    new = list(profiling.METRICS.spans)[start:]
    keys = {s.name: set(s.attrs) for s in new}
    assert {"real", "carried"} <= keys["engine.admit.sweep"]
    assert {"tokens", "slots"} <= keys["engine.drain"]
    assert "n" in keys["engine.dispatch"] and "request.queued" in keys
