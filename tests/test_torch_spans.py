"""The port's spans (``utils/profiling``) on the CPU: a request's spans share
its id and follow one another (queued, then the sweep that took it, then its
decode); a sweep's counts equal a hand count; a drain hands over the tokens
the step returns; ``admission_prefill_s`` is the sweep spans' lengths; the
call tier opens no profiler range while the switch is off, and with it on
records its sites in call order, each under a range; the buffer is bounded;
the MoE drop count rides the block's copy back to the host."""

import pytest
import torch

from mistral_inference_tpu_torch.args import MambaArgs, MoeArgs, TransformerArgs
from mistral_inference_tpu_torch.model import Mamba, Transformer
from mistral_inference_tpu_torch.models import transformer as tf
from mistral_inference_tpu_torch.server.engine import Engine
from mistral_inference_tpu_torch.server.mamba_engine import MambaEngine
from mistral_inference_tpu_torch.utils import profiling
from mistral_inference_tpu_torch.utils.profiling import SPAN_CAPACITY, Metrics

PROMPTS = [[1, 5, 9, 13, 17, 21], [2, 6, 10], [3, 7, 11, 15, 19, 23, 27], [4, 8]]
CALL_TIER = ("model.forward", "ops.linear", "attn.decode", "attn.prefill", "attn.verify",
             "moe.dispatch", "moe.ragged")


@pytest.fixture(autouse=True)
def _fresh_metrics(monkeypatch):
    """Every test reads a registry of its own, one torch thread, the switch off."""
    monkeypatch.setattr(profiling, "METRICS", Metrics())
    for mod in ("server.engine", "server.mamba_engine", "models.transformer", "ops.linear",
                "model"):
        m = __import__(f"mistral_inference_tpu_torch.{mod}", fromlist=["METRICS"])
        monkeypatch.setattr(m, "METRICS", profiling.METRICS)
    monkeypatch.setattr(profiling, "TRACING", False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def metrics() -> Metrics:
    return profiling.METRICS


def tiny(seed=0, quant=None, **overrides) -> Transformer:
    kw = dict(dim=128, n_layers=2, head_dim=32, hidden_dim=256, n_heads=4, n_kv_heads=2,
              norm_eps=1e-5, vocab_size=512, max_batch_size=4, rope_theta=10000.0)
    kw.update(overrides)
    return Transformer.random(TransformerArgs(**kw), dtype=torch.float32, seed=seed,
                              device="cpu", quant=quant)


def named(name, spans=None):
    return [s for s in (metrics().spans if spans is None else spans) if s.name == name]


def by_id():
    return {s.id: s for s in metrics().spans}


def test_request_spans_share_an_id_and_follow_one_another():
    eng = Engine(tiny(1), batch_size=2, max_seq_len=64, decode_block=2)
    rid = eng.submit(PROMPTS[0], max_tokens=5)
    req = eng.queue[0]
    eng.run_to_completion()
    mine = [s for s in metrics().spans if rid in s.rids]
    assert {"request.queued", "engine.admit", "engine.admit.sweep", "engine.dispatch",
            "engine.drain", "request.decode"} <= {s.name for s in mine}
    (queued,), (sweep,), (decode,) = (named(n, mine) for n in
                                      ("request.queued", "engine.admit.sweep", "request.decode"))
    ids = by_id()
    # Queued from its submit to the start of the sweep that took it, under it.
    assert queued.start == req.t_submit and queued.end == sweep.start == req.t_admit
    assert queued.parent == sweep.id and decode.parent == sweep.id
    # The sweep inside the admission inside a step; the first token after it.
    admit = ids[sweep.parent]
    assert admit.name == "engine.admit" and ids[admit.parent].name == "engine.step"
    assert sweep.start <= sweep.end <= decode.start == req.t_first_token <= decode.end
    assert all(s.end is not None for s in metrics().spans)


@pytest.mark.parametrize("staging,rows", [(8, 8), (0, 16)])
def test_sweep_counts_equal_a_hand_count(staging, rows):
    """Prompts of 100, 700 and 1300 tokens at admit_chunk 512: 3 chunks and
    2100 real tokens in a cache of ``rows`` rows. A staged sweep's chunks
    carry the rows still prefilling, 3, 2 and 1 of the staging cache's 8:
    (3 + 2 + 1) x 512 = 3072 carried, 3 rows in its first chunk; a full
    sweep's carry all 16, 16 x 512 x 3 = 24576. The layers are int8 at
    widths whose products take K5 at every k x 512 rows, as a staged chunk
    carries only the rows still prefilling where they do."""
    eng = Engine(tiny(2, quant="int8", dim=256, head_dim=64, hidden_dim=512), batch_size=16,
                 max_seq_len=1400, admit_chunk=512,
                 staging_batch=staging, prefix_cache=False)
    for n in (100, 700, 1300):
        eng.submit([(7 * i + n) % 500 + 1 for i in range(n)], max_tokens=1)
    eng.step()
    (sweep,) = named("engine.admit.sweep")
    chunk_rows = [3, 2, 1] if staging else [rows] * 3
    assert sweep.attrs == dict(kind="staged" if staging else "full", new=3, rows=chunk_rows[0],
                               chunks=3, real=2100, carried=sum(chunk_rows) * 512, copied=0)
    assert len(named("model.forward")) == 0  # the call tier is off


def test_sweep_counts_a_prefix_copy():
    """A prompt whose first 32 tokens a finished row holds copies them and
    prefills the rest, in a full sweep (a copy is never staged)."""
    eng = Engine(tiny(3), batch_size=2, max_seq_len=128, admit_chunk=16, staging_batch=1)
    shared = list(range(1, 33))
    eng.submit(shared + [40, 41, 42], max_tokens=2)
    eng.run_to_completion()
    eng.submit(shared + [50, 51, 52, 53], max_tokens=2)
    eng.run_to_completion()
    first, second = named("engine.admit.sweep")
    assert first.attrs["kind"] == "staged" and first.attrs["real"] == 35
    assert second.attrs == dict(kind="full", new=1, rows=2, chunks=1, real=4, carried=2 * 16,
                                copied=32)


@pytest.mark.parametrize("pipeline", [True, False])
def test_drain_hands_over_the_tokens_the_step_returns(pipeline):
    eng = Engine(tiny(4), batch_size=3, max_seq_len=64, decode_block=4, pipeline=pipeline)
    for p, m in zip(PROMPTS, (5, 9, 3, 6)):
        eng.submit(p, max_tokens=m)
    while eng.has_work:
        step_start = len(metrics().spans)
        events = eng.step()
        new = list(metrics().spans)[step_start:]
        (step,) = named("engine.step", new)
        drains = [s for s in named("engine.drain", new) if s.parent == step.id]
        assert sum(d.attrs["tokens"] for d in drains) == sum(e.token >= 0 for e in events)
        for d in drains:
            assert 0 <= d.attrs["tokens"] <= d.attrs["slots"]
            (wait,) = [s for s in new if s.parent == d.id and s.name == "engine.drain.wait"]
        for disp in named("engine.dispatch", new):
            assert disp.attrs["B"] == 3 and 1 <= disp.attrs["live"] <= 3
        assert metrics().gauges["queue_depth"] == len(eng.queue)
        assert metrics().gauges["live_rows"] == sum(eng._live_rows())
    blocks = sum(d.attrs["n"] for d in named("engine.dispatch"))
    assert sum(d.attrs["slots"] for d in named("engine.drain")) == 3 * blocks
    assert sum(d.attrs["tokens"] for d in named("engine.drain")) == 5 + 9 + 3 + 6


def test_admission_samples_are_the_sweep_spans():
    eng = Engine(tiny(5), batch_size=2, max_seq_len=64, staging_batch=1, decode_block=2)
    for p, m in zip(PROMPTS, (2, 9, 3, 5)):  # rows free one at a time: staged sweeps
        eng.submit(p, max_tokens=m)
    eng.run_to_completion()
    sweeps = named("engine.admit.sweep")
    assert len(sweeps) >= 2
    assert metrics().samples["admission_prefill_s"] == [s.end - s.start for s in sweeps]
    staged = [s for s in named("engine.admit.prefill")
              if by_id()[s.parent].attrs["kind"] == "staged"]
    assert staged and metrics().samples["admission_staged_s"] == [s.end - s.start
                                                                 for s in staged]
    assert metrics().counters["staged_admissions"] == len(staged)
    assert metrics().counters["requests_admitted"] == len(PROMPTS)


def test_mamba_engine_records_the_base_spans():
    args = MambaArgs(dim=64, n_layers=2, vocab_size=256, n_groups=2, rms_norm=True,
                     residual_in_fp32=True, fused_add_norm=True, pad_vocab_size_multiple=16,
                     tie_embeddings=False, d_state=16, d_conv=4, expand=2, headdim=16)
    model = Mamba.random(args, dtype=torch.float32, seed=6, device="cpu")
    eng = MambaEngine(model, batch_size=2, max_seq_len=64, admit_chunk=32, decode_block=2)
    ids = [eng.submit(p, max_tokens=3) for p in PROMPTS[:2]]
    eng.run_to_completion()
    (sweep,) = named("engine.admit.sweep")
    assert sweep.attrs == dict(kind="full", new=2, rows=2, chunks=1, real=9, carried=2 * 32,
                               copied=0)
    for rid in ids:
        (queued,) = [s for s in named("request.queued") if s.rids == (rid,)]
        (decode,) = [s for s in named("request.decode") if s.rids == (rid,)]
        assert queued.parent == decode.parent == sweep.id and queued.end == sweep.start
    assert sum(d.attrs["tokens"] for d in named("engine.drain")) == 6


def _no_range(name):
    raise AssertionError(f"a profiler range opened for {name} with the switch off")


def test_call_tier_off_opens_no_range(monkeypatch):
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _no_range)
    eng = Engine(tiny(7, quant="int8"), batch_size=2, max_seq_len=64, decode_block=2)
    eng.submit(PROMPTS[0], max_tokens=3)
    eng.run_to_completion()
    names = {s.name for s in metrics().spans}
    assert "engine.step" in names and not names & set(CALL_TIER)


def test_call_tier_on_records_in_call_order(monkeypatch):
    """With the switch on, one decode step of an int8 model records its
    forward, then per layer the fused projection, the attention, its output
    projection and the feed-forward's two products, in that order, each
    under the forward and each with a profiler range of its name."""
    opened = []

    class Range:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Range)
    model = tiny(8, quant="int8")
    eng = Engine(model, batch_size=2, max_seq_len=64, decode_block=1)
    eng.submit(PROMPTS[1], max_tokens=2)
    eng.step()  # admission, no block in flight yet
    profiling.set_tracing(True)
    start = len(metrics().spans)
    eng.step()
    profiling.set_tracing(False)
    new = list(metrics().spans)[start:]
    assert [s.name for s in new] == opened
    calls = [s for s in new if s.name in CALL_TIER]
    assert [s.id for s in calls] == sorted(s.id for s in calls)
    layer = ["ops.linear", "attn.decode", "ops.linear", "ops.linear", "ops.linear"]
    assert [s.name for s in calls] == ["model.forward"] + 2 * layer
    fwd = calls[0]
    assert fwd.attrs == dict(kind="decode", rows=2, T=1, real=1)
    assert fwd.parent == named("engine.dispatch", new)[0].id
    assert all(s.parent == fwd.id for s in calls[1:])
    wqkv = calls[1].attrs
    assert wqkv == dict(K=128, N=256, bits=8, group=128, rows=2, route="K3")
    assert calls[2].attrs == dict(layer=0, rows=2, T=1)


def test_call_tier_moe_spans(monkeypatch):
    monkeypatch.setattr(profiling, "TRACING", True)
    model = tiny(9, moe=MoeArgs(num_experts=4, num_experts_per_tok=2), moe_impl="dispatch")
    x = torch.randn(300, 128)
    lw = model.params["layers"][0]
    tf._moe_ffn_dispatch(x[:20], lw, 2, 2.0)
    tf._moe_ffn_dispatch(x, lw, 2, 2.0)  # above MOE_RAGGED_ROWS: the ragged route
    assert [(s.name, s.attrs) for s in metrics().spans] == [
        ("moe.dispatch", dict(rows=20, E=4)), ("moe.ragged", dict(rows=300, E=4))]


def test_span_buffer_is_bounded():
    m = Metrics()
    for i in range(SPAN_CAPACITY + 10):
        with m.span("s", i=i):
            pass
    assert len(m.spans) == SPAN_CAPACITY
    assert m.spans[0].attrs["i"] == 10 and m.spans[-1].attrs["i"] == SPAN_CAPACITY + 9
    assert not m._stack


def test_moe_drops_ride_the_block_copy(monkeypatch):
    """Under MISTRAL_MOE_DEBUG the dispatch counts its drops on the tensors'
    device; the engine folds them in with each block it reads back, and
    ``dump()`` folds what is left (the last admission's)."""
    monkeypatch.setattr(tf, "_MOE_DEBUG", True)
    model = tiny(10, moe=MoeArgs(num_experts=4, num_experts_per_tok=2), moe_impl="dispatch",
                 moe_capacity_factor=0.5)
    # 16 rows a decode forward, 8 slots an expert: an expert chosen by more
    # than 8 of the 32 assignments drops some.
    eng = Engine(model, batch_size=16, max_seq_len=64, decode_block=2, admit_chunk=16)
    for p in PROMPTS:
        eng.submit(p, max_tokens=4)
    folded = []
    while eng.has_work:
        eng.step()
        if eng._pending is not None:
            assert eng._pending.counted == ("moe_dropped_assignments",)
        folded.append(metrics().counters.get("moe_dropped_assignments", 0.0))
    assert folded[-1] > 0 and folded == sorted(folded)
    left = int(metrics()._on_device["moe_dropped_assignments", torch.device("cpu")])
    metrics().dump()
    assert metrics().counters["moe_dropped_assignments"] == folded[-1] + left


def test_counts_on_device_survive_concurrent_folds():
    """The engine's thread adds to a count kept on the device while another
    thread (``/health``'s ``dump()``) folds it: no addition is lost."""
    import sys
    import threading

    m = Metrics()
    one = torch.ones((), dtype=torch.int64)
    stop = threading.Event()

    def add():
        for _ in range(500):
            m.add_on_device("n", one)

    def fold():
        while not stop.is_set():
            m.fold_on_device()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        adders = [threading.Thread(target=add) for _ in range(6)]
        folder = threading.Thread(target=fold)
        folder.start()
        for t in adders:
            t.start()
        for t in adders:
            t.join(timeout=60)
        stop.set()
        folder.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not folder.is_alive() and not any(t.is_alive() for t in adders)
    m.fold_on_device()
    assert m.counters["n"] == 6 * 500
