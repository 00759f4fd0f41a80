#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing one JSON line:

1. card: the card's name and power limit (nvidia-smi) and the published
   peaks (``utils/chip.py``, by the card's name) every bound derives from; TF32 off.
2. build: every kernel of ``mistral_inference_tpu_torch/ops/cuda/csrc`` is
   compiled from the checkout with nvcc (sm_90a).
3. kernels: each of the ten CUDA kernels against its plain PyTorch version
   on the same inputs on the card (K4, K2, K6 and K7 over an int8 ring, and
   again, each a row of its own, over a float8_e4m3fn ring, where K2's and
   K7's written bytes and scales equal cache._quantize_ring's), at the
   Mistral-7B and Mixtral-8x7B shapes (H=32, Hkv=8, D=128; the four linears
   of a layer at 4, 8, 20, 32, 256 and 2048 rows, and a layer's eight
   experts at a capacity of 4 and 128 and at 6144 sorted
   rows, int8 and int4; a speculative verify chunk of 5 and of 8 tokens), the
   Codestral-Mamba SSD step (B=4, a 64-layer fp32 and bf16 state) and the
   Pixtral encoder's segment-masked attention (16 heads of 64 at N = 4096,
   a padded 512 bucket, a 256 bucket, two images in one 3584 row, and a
   1600 + 1984 pair whose boundary falls inside a 128-row tile). K4 is also
   checked where its tiles are mixed (a 1000-token window, invalid slots
   inside tiles, T = 200), K1 at T = 200 over S = 333 and T = S = 77 with
   holes, K6 at fills that end inside a cluster slice and under a window
   shorter than the fill, K2 and K7 at writes to the first and last slot of
   a cluster slice and of a warp's part, a verify chunk across a slice, 32
   query rows and 8 query heads per KV head, K2 against K6 over the ring K2
   has written (equal bits), and K1, K2, K4, K6, K7 and K10 for batch
   invariance (a row's bits alone equal its bits in the batch; an image
   alone equals itself beside another; a K2 row over a smaller ring its
   bits over the whole). K5 also at a group of 64 and at row tiles of 128,
   and a 256-row tile alone against the same rows among 2048 and in the
   E = 8 launch (equal bits); K8 a row at C = 4 against C = 128 (equal bits)
   and zeros from the experts that hold no row. The rows of K2, K6 and K7 also carry their
   kernels' device time by symbol (``split_ms``). Each kernel row carries
   its time (CUDA-event median), the plain
   version's time, the time of one PyTorch library call for the same function
   where one exists, and the card's least time for the work (bytes or flops,
   from this run's inputs), and K4's and K10's ``ms_over_library``.
4. main paths: ``generate()`` at full width with random bf16 weights from a
   seed and an int8 KV ring, over 4 prompts of ragged length, one longer than
   the 4096 window so the ring wraps. Four paths, each with the launch counts
   set to 0 before it and read after it. On ``mistral-7b-v0.1``, 8 layers
   each: bf16 weights; weights quantized to int4, every linear through the
   quantized-matmul kernels; int8 weights with the non-fused decode route. On
   ``mixtral-8x7b``, all 32 layers: int4 weights, ``moe_impl="dispatch"``,
   the experts through K5 (prefill, a weight per tile) and K8 (decode). Two
   more over an fp8 ring on ``mistral-7b-v0.1`` with int4 weights:
   ``int4-fp8`` at all 32 layers (the north-star configuration: K1, K4-fp8,
   K5, K3, K2-fp8) and ``fp8-nonfused-decode`` at 8 layers (K6-fp8). Each
   checks that greedy tokens repeat, the decode == prefill invariant, that
   top-p sampling is fixed by its seed, and that every kernel of the path was
   launched. Beside them the ``MISTRAL_MOE_DEBUG`` drop line: one
   ``mixtral-8x7b`` layer's dispatch over 256 rows at capacity factor 0.5,
   its ``METRICS`` count equal to the plain count of slots past capacity
   (above 0), nothing counted with the switch off, K8 launched.
5. speculation: a probe that the verify forward's operations give a row the
   same bits among 20 or 32 rows as among 4 (K3 also among 128 and 256),
   then four paths of
   ``generate(..., draft_model=...)`` on ``mistral-7b-v0.1`` with int4 weights
   and an int8 ring, each beside plain greedy ``generate()`` on the same model
   in the same run: the target as its own draft at all 32 layers (every draft
   accepted), an independent 2-layer draft at 8 layers (none accepted), prompt
   lookup at 8 layers with 8-token verify chunks, all three on a ring that
   never wraps and so through the fused verify kernel; and the 2-layer draft
   again with a prompt longer than the window, where the ring wraps, the
   verify forward writes nothing and ``scatter_chunk`` commits; and
   ``lookup-fp8``, the lookup path over an fp8 ring (K7-fp8). Each checks the
   fused verify kernel's launches (layers x verify forwards, or 0), that greedy
   tokens repeat and equal plain greedy decoding's (on the wrapping path: may
   differ only at a near-tie of the target's two best logits), the logprob
   count, the emitted logprobs against a teacher-forced prefill, and that
   top-p speculation is fixed by its seed; and prints accepted drafts, target
   forwards per token and tokens/s beside plain decoding's.

6. Mamba2: ``generate_mamba`` on ``codestral-mamba-7b`` (dim 4096, d_inner
   8192, 128 SSD heads of 64, 8 groups, d_state 128, vocab 32768) with random
   bf16 weights from a seed, over the prompts of phase 4 with chunk 512.
   ``mamba-bf16``: all 64 layers, bf16 weights, fp32 SSD state, every decode
   step's SSD through K9 (64 launches per decode forward), the linears
   through cuBLAS. ``mamba-int4-bf16-state``: 8 layers, int4 weights (K3 in
   decode, K5 in prefill), bf16 state. Each checks that greedy tokens repeat,
   K9's launches, decode == prefill, top-p per seed and the path's kernels.
   ``mamba-lookup``: 8 layers int4, ``draft_model="lookup"`` with K = 7 beside
   plain greedy (verify and commit through the chunked SSD and K3 at
   B x (K + 1) rows, K9 not launched), tokens equal to plain greedy's but at
   a near-tie, the logprob count, speculation == prefill, top-p per seed.

7. vision: ``generate(images=...)`` on ``pixtral-12b`` at full width and
   depth (40 decoder layers, 24 encoder layers), random bf16 weights from a
   seed, an int8 ring (no window), chunk 512, four rows: 12 text tokens, a
   1024 x 1024 image and 40 more (4212 tokens); two images of 512 x 768 and
   384 x 336 between text (2132); a 256 x 256 image and 30 tokens (302); 45
   text tokens. Image tokens are laid out by ``images.image_token_layout``.
   Checks greedy tokens repeat, K10's 96 launches per greedy call (24 layers
   x 4 images), K1, K4 and K2 launched, decode == prefill with the same
   images, top-p per seed, and that speculation with images is refused;
   prints TTFT, the encoder's time for the four images beside it, decode
   tokens/s and peak memory.

8. serving: the continuous-batching ``Engine`` (batch 8, max_seq_len 4608,
   admit_chunk 512) on ``mistral-7b-v0.1`` with int4 weights and an fp8
   ring, all 32 layers, serving 24 requests from seed 0: prompts of the
   lengths above, 8 sharing a 1024-token prefix, max_tokens 32-128, 16
   submitted at the start and 8 after the fourth step, 20 greedy and 4 at
   T = 0.7, p = 0.9, one cancelled mid-run, one ended by a stop id, one with
   logprobs. Checks every greedy request against ``generate()`` of its
   prompt alone (leaving it only at a near-tie of the two best logits), the
   prefix hits, that no row writes past prompt + max_tokens and K2-fp8's
   launches (layers x decode forwards); prints requests/s, output tokens/s,
   TTFT p50 / p99, admission's share of the wall time and peak memory.
   Then the staged-rows check (``staged_rows_check``), on ``mistral-7b-v0.1``
   (fp8 ring) and ``mixtral-8x7b`` (int8 ring, capacities), int4, 32 layers
   each: a 1100-token request staged alone, beside 2 and beside 7 requests
   of other lengths (each chunk over the rows still prefilling), its carried
   prelogits, ring row, prompt logprobs and served tokens equal in bits.

9. front door: a reference folder of ``mistral-7b-v0.1`` at 8 layers on
   disk through ``from_folder``, ``main quantize``, ``main demo`` and
   ``Server(Engine(...))`` over HTTP, and a Pixtral image chat request.

10. speculative serving: 16 requests (prompts of 45-1537 tokens, half of
    them a repeated block, 4 sharing a 512-token prefix, max_tokens 32-96, 4
    sampled, 8 arriving after the third step, one cancelled, one ended by a
    stop id, one with logprobs) served by ``Engine(batch_size=8,
    max_seq_len=2048)`` on ``mistral-7b-v0.1`` (int4, an fp8 ring, window
    4096, 32 layers) with prompt lookup (K = 7), with the target as its own
    draft, and plainly, the Pixtral model resident. Checks each greedy
    request against ``generate()`` alone (but at a near-tie), K7-fp8's
    launches (layers x verify forwards) and K2-fp8's (layers x T = 1
    forwards: none for lookup), prefix hits into both rings, no row past
    prompt + max_tokens + the block's slack, sampled requests repeating for
    a seed, and the logprob request against a teacher-forced prefill;
    prints requests/s, tokens/s, TTFT, admission's share and accepted tokens
    per verify for each engine.

11. Mamba serving: ``MambaEngine(batch_size=4)`` on ``codestral-mamba-7b``
    (8 layers, int4) with an fp32 and a bf16 SSD state, 12 requests, plainly
    and with prompt lookup (K = 7): each greedy request against
    ``generate_mamba`` alone (equal tokens plainly; lookup at near-ties),
    K9's launches (layers x decode forwards; 0 for lookup), a finished
    request's state rows unchanged in bits through every block; one HTTP
    completion through ``Server(MambaEngine(...))``, equal tokens. Then the
    rows probe (``mamba_rows_probe``): no op of a Mamba forward gives a row
    other bits at B = 1 or 2 than at B = 4, and ``fixed_rows_linear`` keeps
    a row's bits among 4-2048 rows.

12. LoRA: a rank-16 adapter on phase 9's folder: ``main quantize
    --lora_path`` exports quantize(merge_lora(dense)) in bits, ``main demo
    --lora_path`` prints the merged model's text, a ``lora`` block in
    params.json gives live pairs (a zero adapter changes no bit; with the
    adapter decode == prefill, lookup through K7-fp8 keeps plain greedy's
    tokens, live against merged within the dense bound); ``mixtral-8x7b`` at
    2 layers with live expert adapters (dispatch: K8 and K5 launched).

13. many GPUs (``parallel``): an NCCL world of one (the rule of
    ``parallel.distributed`` gives one rank with one GPU NCCL): the 8-layer
    int4 path of phase 4 with a mesh of one, equal in bits to no mesh, and
    NCCL's all_reduce and all_gather probed. Then two ranks spawned on the
    one card over gloo (NCCL refuses two ranks on one device; gloo stages
    each collective's CUDA tensors through the host, so the phase shows the
    sharded math and the kernels at their shard shapes on the card, not
    NCCL's speed), each path against the single-device port on the same
    seed and inputs (computed first here, one run a model, its models freed
    before the ranks start), in bits: (a) ``mistral-7b-v0.1`` int4 over an
    fp8 ring, all 32 layers, tensor = 2, with an ``Engine`` (batch 4)
    serving 8 requests and lookup speculation; (b) ``mixtral-8x7b`` int4,
    32 layers, expert = 2; (c) ``codestral-mamba-7b`` int4, 8 layers,
    tensor = 2; (d) ``mistral-7b-v0.1`` int4, 8 layers, data = 2; (e) (a)'s
    model at seq = 2: 256-token chunks split, one unchunked 77-token
    prefill that seq does not divide, and the ``Engine``; (f) at data = 2,
    (d)'s model serving 8 staggered requests through ``Engine(4)``, two of
    them copying a prefix and one staged into a row of the other data rank,
    and an 8-layer int4 ``codestral-mamba-7b`` through ``MambaEngine(4)``;
    (g) 8 layers with live LoRA pairs of rank 16 at tensor = 2; (h)
    ``mixtral-8x7b`` int4, 2 layers, tensor = 2, the experts' stacks on
    their columns (K5 in prefill, K8 in decode). Each checks
    that both ranks return the same tokens, the tokens and logprobs (and the
    engines', lookup's and the odd chunk's) against one device's bits,
    beside a wrong shard on one device (``wo`` and ``w2`` output halves
    swapped) that must leave them; decode == prefill on the shards, each
    rank's launches (K2-fp8 and K9 = layers x decode forwards, K7-fp8 =
    layers x lookup's verify forwards on (a)), the
    collectives of one decode forward (0 all-reduces and 129 all-gathers on
    (a); a seq prefill chunk's are printed), and prints each rank's weight
    bytes, peak memory and seconds; rank 0 replays the first calls of every
    kernel wrapper against its plain version at the shard shapes
    (``kernel_shard`` lines), and a K3, K5 or K8 call on a column shard
    also against the matching columns of the whole weight's product, in
    bits (on every tensor path, each of them that ran at least once).

Then a ``total`` line (the seconds since the start, and each phase's), a
``kernels`` line, the nvidia-smi line, and last the device line.
Any failure raises and the script exits non-zero. Without a CUDA device,
or without the package beside it, it exits non-zero and prints no result.
nvcc's build logs (``-Xptxas -v``: registers, shared memory) go to stderr.
``--profile`` adds to the lines of the quantized paths (8 layers, the
32-layer fp8 path, Mixtral, and the two non-fused decode paths, whose step
runs K6), the two Mamba
main paths and the Pixtral path a torch.profiler breakdown of the prefill
(on Pixtral: the encoder's linears, K10, the decoder's linears, K1 + K4,
other) and of one decode step, with the decode step's aten calls and the
host's time to enqueue it, and to the serving line the same for one
engine decode block (a serial engine, 8 rows). ``--kernels=k2,k7_fp8`` runs phases 1 and
2 and only the named kernels' checks, and prints no result line; so does
``--phases=spec_serving,mamba_serving,lora,parallel`` after phases 1 and 2
for the named phases of 10-13, ``--phases=staged_rows`` for the staged-rows
check, ``--phases=mamba_rows`` for the rows probe
and ``--phases=moe_drops`` for the drop line.
"""

from __future__ import annotations

import json
import math
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

ROOT = Path(__file__).resolve().parent

SPIN_CYCLES = 20_000_000  # about 10 ms at the H100's 1.98 GHz boost clock

# The card's published peaks (``utils/chip.py``, looked up by the card's
# name in main()): each kernel's least time derives from them.
SPEC = None

MODEL = "mistral-7b-v0.1"
MOE_MODEL = "mixtral-8x7b"
PROMPT_LENS = (4300, 1537, 700, 45)  # the first is longer than the 4096 window
WINDOW = 4096
CHUNK = 512
GREEDY_TOKENS = 32
TOPP_TOKENS = 16
REPEATS = 3  # timed generate() calls per median

K1, K2, K4 = "flash_attention", "fused_update_decode_attention", "ring_attention_stats"
K3, K5, K6 = "matmul_quant", "moe_matmul_quant_ragged", "decode_attention"
K8 = "moe_matmul_quant"
K7 = "fused_verify_chunk_attention"
K9 = "fused_ssd_step_stacked"
# The float8_e4m3fn ring instantiations of the ring kernels, counted apart.
K2F, K4F, K6F, K7F = (k + "_fp8" for k in (K2, K4, K6, K7))
# decode == prefill: the greedy decode logprobs and the teacher-forced
# prefill logprobs of the same tokens go through the same int8 ring bytes
# (the fused decode kernel's write is bit-identical to the prefill's), but
# with bf16 weights and activations the two paths round at different
# places: T=1 against T=512 GEMMs (other cuBLAS kernels and summation
# orders), K2 against K4+K1+merge. With quantized weights the linears are K3
# (fp32 FMAs) in decode and K5 (tensor cores) in prefill, the experts K8 and
# K5: the same rounding points, other summation orders. Random weights pass
# those bf16 differences through the layers, so the bound is on the bf16
# scale, not fp32.
INVARIANT_MAX_NATS = 0.25
INVARIANT_MEAN_NATS = 0.05
# A sparse-MoE path adds a discontinuity: where a token's second and third
# router logits nearly tie, those bf16 differences send it to another expert
# in one pass than in the other, and the logits that step predicts are then
# another function of the weights (random experts are uncorrelated, so a swap
# at a near-even routing weight moves them far). So the MoE path splits its
# generated tokens: a logprob whose decode step routed as the prefill did in
# every layer is held to the dense bound above; all of them together to the
# bound below; and at most MOE_FLIP_SHARE of the (token, layer) routings may
# differ.
MOE_INVARIANT_MAX_NATS = 2.5
MOE_INVARIANT_MEAN_NATS = 0.2
MOE_FLIP_SHARE = 0.1


class MainPath(NamedTuple):
    label: str
    model: str
    layers: int
    quant: Optional[str]  # weight quantization
    fused: bool  # decode route: K2, or update_stacked + K6
    expected: Tuple[str, ...]  # kernels the path must launch
    bound: Tuple[float, float] = (INVARIANT_MAX_NATS, INVARIANT_MEAN_NATS)
    ring: str = "int8"  # the KV ring's type: "int8" | "fp8"


# The Mixtral path is the full model; the dense paths are cut in depth, never
# in width, to keep the run short.
PATHS = (
    MainPath("bf16", MODEL, 8, None, True, (K1, K4, K2)),
    MainPath("int4", MODEL, 8, "int4", True, (K1, K4, K2, K3, K5)),
    MainPath("int8-nonfused-decode", MODEL, 8, "int8", False, (K1, K4, K6, K3, K5)),
    # The north-star configuration: int4 weights over an fp8 ring, all 32
    # layers; and the non-fused decode route over an fp8 ring (K6).
    MainPath("int4-fp8", MODEL, 32, "int4", True, (K1, K4F, K2F, K3, K5), ring="fp8"),
    MainPath("fp8-nonfused-decode", MODEL, 8, "int4", False, (K1, K4F, K6F, K3, K5), ring="fp8"),
    MainPath("mixtral-int4", MOE_MODEL, 32, "int4", True, (K1, K4, K2, K3, K5, K8),
             (MOE_INVARIANT_MAX_NATS, MOE_INVARIANT_MEAN_NATS)),
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def close(a, b, atol: float, rtol: float):
    """(ok, max abs error) for a against b in fp32."""
    a, b = a.float(), b.float()
    err = (a - b).abs()
    ok = bool((err <= atol + rtol * b.abs()).all()) and bool(torch.isfinite(a).all())
    return ok, float(err.max()) if err.numel() else 0.0


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def timed_ms(fn, reps: int = 10) -> float:
    """Median of per-call CUDA-event times of the card's work alone. Before
    each call a 64 MB write evicts the inputs from the 50 MB L2 (the main
    path finds them cold: each layer reads its own weights and ring), and a
    10 ms spin kernel holds the stream while the host queues the call, so
    the host's own time per call does not count."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 10) -> float:
    """Device time per call of the kernels ``fn`` launches (torch.profiler),
    each call after the same 64 MB write as ``timed_ms`` (its fill kernel not
    counted): the kernels' own run, without the event and launch floor."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    return sum(getattr(ev, "self_device_time_total", 0.0) for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and "FillFunctor" not in ev.key) / 1e3 / reps


def floor_ms() -> float:
    """``timed_ms`` of a one-element kernel: what that timing adds to any kernel."""
    one = torch.zeros(1, device="cuda")
    return timed_ms(lambda: one.add_(1), reps=20)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(flops: float, bytes_: float, dtype: torch.dtype = torch.bfloat16):
    """The card's least time in ms for ``flops`` operations on ``dtype``
    inputs and ``bytes_`` moved, and which of the two bounds it."""
    t_ops, t_bytes = SPEC.flop_seconds(flops, dtype), SPEC.hbm_seconds(bytes_)
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def kernel_split_ms(fn, calls: int = 10) -> dict:
    """Device time per call of each kernel that ``fn`` launches, by symbol
    (torch.profiler over ``calls`` calls in a row, L2 not flushed)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {ev.key[:72]: getattr(ev, "self_device_time_total", 0.0) / 1e3 / calls
            for ev in prof.key_averages() if ev.device_type == torch.autograd.DeviceType.CUDA}


def sdpa_ms(q, k, v, mask) -> float:
    """One PyTorch call for masked GQA attention: the yardstick only."""
    import torch.nn.functional as F

    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    m = mask[:, None].contiguous()
    return timed_ms(
        lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=m, enable_gqa=True))


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

H, HKV, D = 32, 8, 128


def randn(gen, *shape, dtype=None):
    x = torch.randn(shape, generator=gen, device="cuda")
    return x.to(dtype) if dtype is not None else x


# The scaled ring types; a "bf16" ring has no scales.
RINGS = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def make_ring(gen, ring: str, *lead):
    """A random stored ring (*lead, HKV, D) of type ``ring`` with its scales
    (*lead[:-1], HKV, S), quantized by the port's ring rule; or bf16 and None."""
    from mistral_inference_tpu_torch.cache import _quantize_ring

    x = randn(gen, *lead, HKV, D)
    if ring == "bf16":
        return x.to(torch.bfloat16), None
    q, scale = _quantize_ring(x, RINGS[ring])
    return q, scale.transpose(-1, -2).contiguous()


def bits(t):
    """The tensor's elements as integers of its width: equal bits compare
    equal (a float8 tensor has no comparison kernels of its own)."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()])


def same_bits(a, b) -> bool:
    return torch.equal(bits(a), bits(b))


def differ(a, b) -> int:
    return int((bits(a) != bits(b)).sum())


def check_k1(gen):
    from mistral_inference_tpu_torch.ops.attention import sliding_window_mask
    from mistral_inference_tpu_torch.ops.cuda.attention import attend_stats_plain, flash_attention

    bf = torch.bfloat16
    worst = 0.0
    # (B, T, S, window, ragged validity): the main path's chunk shape; ragged
    # T and S with window < S and invalid rows (the causal diagonal and the
    # holes fall inside tiles); a chunk of 77 tokens alone, T = S.
    for B, T, S, window, ragged in ((4, 512, 512, 4096, False), (2, 200, 333, 100, True),
                                    (3, 77, 77, 4096, True)):
        q = randn(gen, B, T, H, D, dtype=bf)
        k, v = randn(gen, B, S, HKV, D, dtype=bf), randn(gen, B, S, HKV, D, dtype=bf)
        kv_pos = torch.arange(S, device="cuda", dtype=torch.int32)[None].repeat(B, 1)
        q_pos = kv_pos[:, S - T:].contiguous()
        q_valid = torch.ones((B, T), dtype=torch.bool, device="cuda")
        kv_valid = torch.ones((B, S), dtype=torch.bool, device="cuda")
        if ragged:
            q_valid[:, -7:] = False
            kv_valid = torch.rand((B, S), generator=gen, device="cuda") > 0.2
        args = (q, k, v, q_pos, kv_pos, q_valid, kv_valid, window)
        ref, m_ref, l_ref = attend_stats_plain(q, k, v, None, None, *args[3:])
        out = flash_attention(*args)
        o, m, l = flash_attention(*args, return_stats=True)
        torch.cuda.synchronize()
        for name, (ok, err) in {
            "out": close(out.view(B, T, H, D), ref, 1e-2, 1e-2),
            "out_stats": close(o, ref, 1e-2, 1e-2),
            "m": close(m, m_ref, 1e-4, 1e-4),
            "l": close(l, l_ref, 1e-4, 1e-4),
        }.items():
            require(ok, f"K1 {name} disagrees with its plain version (B={B} T={T} S={S}): {err}")
            if name.startswith("out"):
                worst = max(worst, err)
        # A row's (out, m, l) bits alone equal its bits in the batch.
        one = tuple(x[1:2].contiguous() if torch.is_tensor(x) else x for x in args)
        got_one = flash_attention(*one, return_stats=True)
        torch.cuda.synchronize()
        require(all(same_bits(a[1:2], b) for a, b in zip((o, m, l), got_one)),
                f"K1: a row's (out, m, l) bits alone differ from its bits at B={B} (T={T})")
        if not ragged:
            main = args
    q, k, v, q_pos, kv_pos, q_valid, kv_valid, window = main
    mask = sliding_window_mask(q_pos, kv_pos, q_valid, kv_valid, window)
    flops = 4.0 * D * H * float(mask.sum())
    b_ms, b_by = bound(flops, nbytes(q, k, v, q_pos, kv_pos, q_valid, kv_valid) + nbytes(q))
    return {
        "name": "flash_attention", "kernel": "K1", "route": "cuda",
        "source": "mistral_inference_tpu_torch/ops/cuda/csrc/flash_attention.cu",
        "loop": "mistral_inference_tpu_torch/ops/cuda/csrc/flash_hopper.cuh",
        "replaces": "mistral_inference_tpu/ops/pallas/attention.py:146",
        "max_abs_err": worst,
        "ms": timed_ms(lambda: flash_attention(*main)),
        "plain_ms": timed_ms(lambda: attend_stats_plain(q, k, v, None, None, *main[3:])),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": sdpa_ms(q, k, v, mask),
        "shape": "B=4 T=S=512 H=32 Hkv=8 D=128 bf16, causal",
        "cases": "main; T=200 over S=333 with window 100 and holes; T=S=77 with holes; "
                 "in each, row 1's (out, m, l) bits alone equal its bits in the batch",
        "tolerance": "abs 1e-2 + rel 1e-2 on bf16 outputs (one bf16 ulp of |out| < 4 "
                     "is 1.6e-2 at most; both sides round p to bf16 at the same point), "
                     "1e-4 on the fp32 stats",
    }


def ring_case(gen, B, T, S, window, ring: str, kv_len, holes: bool = False):
    """A stored ring of one layer (wrapped when kv_len > window) and a chunk
    of T queries after it; with ``holes``, invalid slots inside tiles that
    are otherwise full."""
    from mistral_inference_tpu_torch.cache import slot_positions

    bf = torch.bfloat16
    kq, ks = make_ring(gen, ring, B, S)
    vq, vs = make_ring(gen, ring, B, S)
    kv_len = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    slot_pos, slot_valid = slot_positions(kv_len, window, S)
    if holes:
        slot_valid = slot_valid.clone()
        slot_valid[:, 100:140] = False  # across a tile boundary
        slot_valid[:, 7::509] = False  # single slots in many tiles
    q_pos = kv_len[:, None] + torch.arange(T, dtype=torch.int32, device="cuda")[None]
    q_valid = torch.ones((B, T), dtype=torch.bool, device="cuda")
    q_valid[-1, T // 2:] = False  # a short row in the chunk
    q = randn(gen, B, T, H, D, dtype=bf)
    return (q, kq.reshape(B, S, HKV * D), vq.reshape(B, S, HKV * D), ks, vs,
            q_pos, slot_pos, q_valid, slot_valid, window)


def check_k4(gen, scaled: str = "int8"):
    """K4 over a ``scaled`` ring ("int8", which also checks the bf16 ring, or
    "fp8"): one row of the kernels line."""
    from mistral_inference_tpu_torch.cache import kv_roundtrip
    from mistral_inference_tpu_torch.ops.attention import attend_scaled, sliding_window_mask
    from mistral_inference_tpu_torch.ops.cuda.attention import (
        attend_stats_plain, flash_attention, merge_attention_parts, ring_attention_stats,
    )

    B, T, S, window = 4, 512, 4096, 4096
    kv_len = [4300 - 512, 4096 + 700, 1537, 2000]  # rows 0 and 1 have wrapped
    # (label, B, T, window, kv_len, holes): the main shape first (full tiles,
    # the wrap's mixed tiles, skipped invalid slots), then mixed tiles at the
    # edge of a 1000-token window, invalid slots inside tiles, and T = 200
    # (a ragged last query tile).
    cases = (("main", B, T, window, kv_len, False),
             ("window 1000", 2, T, 1000, [3000, 4096 + 1500], False),
             ("invalid slots", 2, T, window, [4096 + 300, 3500], True),
             ("T=200", 2, 200, window, [4096 + 900, 2500], False))
    worst, bf16_main = 0.0, None
    for ring in (scaled, "bf16") if scaled == "int8" else (scaled,):
        for label, b_, t_, w_, lens, holes in cases:
            case = ring_case(gen, b_, t_, S, w_, ring, lens, holes)
            q, kq, vq, ks, vs, q_pos, slot_pos, q_valid, slot_valid, _ = case
            o, m, l = ring_attention_stats(*case)
            ref, m_ref, l_ref = attend_stats_plain(
                q, kq.view(b_, S, HKV, D), vq.view(b_, S, HKV, D), ks, vs, *case[5:]
            )
            torch.cuda.synchronize()
            vis = q_valid[..., None, None]
            for name, (ok, err) in {
                "out": close(o * vis, ref * vis, 1e-2, 1e-2),
                "m": close(m, m_ref, 1e-4, 1e-4),
                "l": close(l, l_ref, 1e-4, 1e-4),
            }.items():
                require(ok, f"K4 {name} disagrees with its plain version ({ring} ring, "
                            f"{label}): {err}")
                if name == "out":
                    worst = max(worst, err)
            if label == "main" and ring == scaled:
                main = case
            elif label == "main":
                bf16_main = case
    # Batch invariance: a row's (out, m, l) bits alone equal its bits among 8.
    wide = ring_case(gen, 8, T, S, window, scaled, kv_len * 2)
    one = tuple(x[3:4].contiguous() if torch.is_tensor(x) else x for x in wide)
    got_wide, got_one = ring_attention_stats(*wide), ring_attention_stats(*one)
    torch.cuda.synchronize()
    require(all(same_bits(a[3:4], b) for a, b in zip(got_wide, got_one)),
            "K4: a row's (out, m, l) bits at B=1 differ from its bits at B=8")
    # Merge with K1 over the chunk against attend_scaled over ring ++ chunk.
    q, kq, vq, ks, vs, q_pos, slot_pos, q_valid, slot_valid, _ = main
    ck, cv = (kv_roundtrip(randn(gen, B, T, HKV, D, dtype=torch.bfloat16), RINGS[scaled])
              for _ in range(2))
    o_r, m_r, l_r = ring_attention_stats(*main)
    o_c, m_c, l_c = flash_attention(q, ck, cv, q_pos, q_pos, q_valid, q_valid, window,
                                    return_stats=True)
    merged = merge_attention_parts(o_r, m_r, l_r, o_c, m_c, l_c)
    keys = torch.cat([kq.view(B, S, HKV, D).float(), ck.float()], 1)
    vals = torch.cat([vq.view(B, S, HKV, D).float(), cv.float()], 1)
    ones = torch.ones((B, HKV, T), device="cuda")
    kvp = torch.cat([slot_pos, q_pos], 1)
    kvv = torch.cat([slot_valid, q_valid], 1)
    mask = sliding_window_mask(q_pos, kvp, q_valid, kvv, window)
    oracle = attend_scaled(
        q.float(), keys, vals, torch.cat([ks, ones], 2).permute(0, 2, 1),
        torch.cat([vs, ones], 2).permute(0, 2, 1), mask,
    ).view(B, T, H, D)
    torch.cuda.synchronize()
    vis = q_valid[..., None, None]
    ok, merge_err = close(merged * vis, oracle * vis, 2e-2, 2e-2)
    require(ok, f"K4 + K1 merge disagrees with attend_scaled over ring ++ chunk: {merge_err}")

    ring_mask = sliding_window_mask(q_pos, slot_pos, q_valid, slot_valid, window)
    flops = 4.0 * D * H * float(ring_mask.sum())
    out_bytes = 2 * B * T * H * D + 2 * 4 * B * T * H
    b_ms, b_by = bound(flops, nbytes(*[x for x in main[:9]]) + out_bytes)
    deq_k = (kq.view(B, S, HKV, D).float() * ks.permute(0, 2, 1)[..., None]).to(torch.bfloat16)
    deq_v = (vq.view(B, S, HKV, D).float() * vs.permute(0, 2, 1)[..., None]).to(torch.bfloat16)
    ms = timed_ms(lambda: ring_attention_stats(*main))
    library_ms = sdpa_ms(q, deq_k, deq_v, ring_mask)
    extra = {}
    if bf16_main is not None:  # the bf16 ring at the same shape and positions
        extra["bf16_ms"] = timed_ms(lambda: ring_attention_stats(*bf16_main))
        extra["bf16_ms_over_library"] = extra["bf16_ms"] / library_ms
    return {
        "name": K4 + ("_fp8" if scaled == "fp8" else ""), "kernel": "K4", "route": "cuda",
        "ring": scaled,
        "source": "mistral_inference_tpu_torch/ops/cuda/csrc/ring_attention.cu",
        "replaces": "mistral_inference_tpu/ops/pallas/attention.py:501",
        "max_abs_err": worst, "merge_max_abs_err": merge_err,
        "ms": ms,
        "plain_ms": timed_ms(lambda: attend_stats_plain(
            q, kq.view(B, S, HKV, D), vq.view(B, S, HKV, D), ks, vs, *main[5:])),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": library_ms, "ms_over_library": ms / library_ms, **extra,
        "shape": f"B=4 T=512 over an {scaled} ring of S=4096 (two rows wrapped) H=32 Hkv=8 "
                 "D=128" + ("; also checked: a bf16 ring" if scaled == "int8" else ""),
        "cases": "main; window 1000 (mixed tiles at the window's edge); invalid slots "
                 "inside tiles; T=200 (a ragged query tile); a row's bits at B=1 equal "
                 "its bits at B=8",
        "tolerance": "kernel vs plain: abs 1e-2 + rel 1e-2 on bf16 outputs, 1e-4 on "
                     "stats; merge vs fp32 oracle: 2e-2, since the oracle keeps the "
                     "probabilities in fp32 where the kernels round them to bf16",
    }


def check_k2(gen, scaled: str = "int8"):
    """K2 over a ``scaled`` ring ("int8", which also checks the bf16 ring, or
    "fp8"): one row of the kernels line."""
    import torch.nn.functional as F

    from mistral_inference_tpu_torch.cache import dequant_layer, slot_positions
    from mistral_inference_tpu_torch.ops.attention import sliding_window_mask
    from mistral_inference_tpu_torch.ops.cuda.attention import (
        decode_attention, fused_update_decode_attention, fused_update_decode_attention_plain,
    )

    bf = torch.bfloat16
    L, B, S, window = 32, 4, 4096, 4096
    worst, main, checked = 0.0, None, []
    # (fills, live rows, query heads): row 0 wrapped and row 3 dead (the timed
    # case); no row wrapped, a dead row with a fill of 3000 slots, not a
    # multiple of the tile, and a write to slot 256; writes to the last and
    # the first slot of a cluster slice (511, 512; 512 slots a slice) and of a
    # warp's part (63 in a wrapped row, 64; 64 slots a part); and 8 query heads
    # per KV head.
    cases = (([4300, 1000, 37, 2999], [1, 1, 1, 0], H),
             ([1000, 37, 2999, 256], [1, 1, 0, 1], H),
             ([511, 512, 4096 + 63, 64], [1, 1, 1, 1], H),
             ([1023, 4096 + 700, 64, 1], [1, 1, 0, 1], 64))
    for kv_len, live, heads in cases:
        kv_len = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
        live = torch.tensor(live, dtype=torch.int32, device="cuda")
        new_total = kv_len + live
        pos = kv_len
        should = (live > 0) & (pos >= new_total - window)
        write_slot = torch.where(should, pos % window, -1).to(torch.int32)
        slot_pos, slot_valid = slot_positions(new_total, window, S)
        for ring in (scaled, "bf16") if scaled == "int8" else (scaled,):
            CK, KS = make_ring(gen, ring, L, B, S)
            CV, VS = make_ring(gen, ring, L, B, S)
            CK, CV = CK.reshape(L, B, S, HKV * D), CV.reshape(L, B, S, HKV * D)
            xq = randn(gen, B, 1, heads, D, dtype=bf)
            xk, xv = randn(gen, B, 1, HKV, D, dtype=bf) * 3, randn(gen, B, 1, HKV, D, dtype=bf)
            li = 5
            stacks = [CK, CV, KS, VS]
            start = [None if t is None else t.clone() for t in stacks]
            plain_stacks = [None if t is None else t.clone() for t in stacks]
            tail = (li, window, write_slot, pos, slot_pos, slot_valid)
            out = fused_update_decode_attention(xq, xk, xv, *stacks, *tail)
            # The plain version writes with cache._quantize_ring, so equal
            # bytes here are the ring rule's bytes.
            ref = fused_update_decode_attention_plain(xq, xk, xv, *plain_stacks, *tail)
            # K6 over the ring K2 has written, with the same q, positions and
            # window: one loop, one function, the same bits.
            o6 = decode_attention(xq, *stacks, li, pos, slot_pos, slot_valid, window)
            # Row 2 alone, from the same start: the bits it has in the batch.
            one = [None if t is None else t[:, 2:3].contiguous() for t in start]
            alone = fused_update_decode_attention(
                *(x[2:3].contiguous() for x in (xq, xk, xv)), *one, li, window,
                *(x[2:3].contiguous() for x in (write_slot, pos, slot_pos, slot_valid)))
            # The rows whose slots fit in 1024, over layer li's first 1024
            # slots alone: the bits they have over 4096 (no sum depends on S).
            fit = new_total <= 1024
            small = [None if t is None else
                     (t[li:li + 1, ..., :1024] if t.dtype == torch.float32
                      else t[li:li + 1, :, :1024]).contiguous() for t in start]
            sp_small, sv_small = slot_positions(new_total, window, 1024)
            o_small = fused_update_decode_attention(
                xq, xk, xv, *small, 0, window, torch.where(fit, write_slot, -1).to(torch.int32),
                pos, sp_small, sv_small)
            torch.cuda.synchronize()
            case = f"{ring} ring, kv_len={kv_len.tolist()}, live={live.tolist()}, H={heads}"
            for name, a, b in zip(("CK", "CV", "KS", "VS"), stacks, plain_stacks):
                if a is not None:
                    require(same_bits(a, b), f"K2 ring {name} after the write is not "
                                             f"bit-identical to _quantize_ring's ({case}): "
                                             f"{differ(a, b)} elements differ")
            ok, err = close(out, ref, 1e-2, 1e-2)
            require(ok, f"K2 output disagrees with its plain version ({case}): {err}")
            require(same_bits(out, o6), f"K2 differs in bits from K6 over its ring ({case}): "
                                        f"{differ(out, o6)} elements differ")
            require(same_bits(out[2:3], alone), f"K2: row 2's bits alone differ from its bits "
                                                f"at B={B} ({case})")
            require(same_bits(out[fit], o_small[fit]),
                    f"K2: a row's bits over 1024 slots differ from its bits over {S} ({case})")
            for a, b in zip(stacks, one):
                require(a is None or same_bits(a[:, 2:3], b),
                        f"K2: row 2 alone wrote another ring ({case})")
            worst = max(worst, err)
            checked.append(case)
            if ring == scaled and main is None:
                main = (xq, xk, xv, *stacks, *tail)
            del CK, CV, KS, VS, stacks, start, plain_stacks, one, small

    xq, xk, xv, CK, CV, KS, VS, li, window, write_slot, pos, slot_pos, slot_valid = main
    ones = torch.ones((B, 1), dtype=torch.bool, device="cuda")
    # (row, slot) pairs this step's data makes visible: each is read once,
    # one-byte K and V for every KV head plus their fp32 scales.
    mask = sliding_window_mask(pos[:, None], slot_pos, ones, slot_valid, window)
    visible = float(mask.sum())
    ring_bytes = visible * HKV * (2 * D + 2 * 4)
    small = nbytes(xq, xk, xv, write_slot, pos, slot_pos, slot_valid) + 2 * B * H * D
    b_ms, b_by = bound(4.0 * D * H * visible, ring_bytes + small + 2 * B * HKV * (D + 4))
    layer = [0]

    def cycle_layers():
        # Each call takes the next layer of the 32-layer stack, as a decode
        # step does, so the timed ring is never the one just read.
        layer[0] = (layer[0] + 1) % L
        args = list(main)
        args[7] = layer[0]
        return fused_update_decode_attention(*args)

    plain_stacks = [t.clone() for t in main[3:7]]
    kh = dequant_layer(CK[li], KS[li], bf, HKV).transpose(1, 2).contiguous()
    vh = dequant_layer(CV[li], VS[li], bf, HKV).transpose(1, 2).contiguous()
    qh, m = xq.transpose(1, 2).contiguous(), mask[:, None].contiguous()
    return {
        "name": K2 + ("_fp8" if scaled == "fp8" else ""), "kernel": "K2", "route": "cuda",
        "ring": scaled,
        "source": "mistral_inference_tpu_torch/ops/cuda/csrc/fused_decode.cu",
        "loop": "mistral_inference_tpu_torch/ops/cuda/csrc/decode_hopper.cuh",
        "replaces": "mistral_inference_tpu/ops/pallas/attention.py:1089",
        "max_abs_err": worst, "ring_bytes_equal_quantize_ring": True,
        "ms": timed_ms(cycle_layers),
        "split_ms": kernel_split_ms(cycle_layers),
        "plain_ms": timed_ms(lambda: fused_update_decode_attention_plain(
            *main[:3], *plain_stacks, *main[7:])),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timed_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=m, enable_gqa=True)),
        "library": "SDPA with a mask on one layer's ring dequantized to bf16 before the call, "
                   "after the write: no one PyTorch call writes the ring and attends",
        "shape": f"B=4 over a 32-layer {scaled} ring stack of S=4096 (one row wrapped, one "
                 "dead) H=32 Hkv=8 D=128",
        "checked": checked,
        "cases": "no row wrapped, fill 3000, a write at slot 256; writes at the last and first "
                 "slot of a cluster slice (511, 512) and of a warp's part (63 wrapped, 64); "
                 "H=64 (8 query heads per KV head)" + ("; bf16 rings" if scaled == "int8" else "")
                 + "; in each, the output equals K6's over the written ring, row 2's bits "
                   "alone equal its bits in the batch, and the rows that fit in 1024 slots "
                   "give their bits over a 1024-slot ring",
        "tolerance": "ring bytes and scales bit-identical to cache._quantize_ring's (the plain "
                     "write); output abs 1e-2 + rel 1e-2 (bf16 output, fp32 sums in another "
                     "order); K6 over the same ring, a row alone and a smaller ring: equal bits",
    }


# The four linears of one mistral-7b layer as (name, K = in, N = out).
LINEARS = (("wqkv", 4096, 6144), ("wo", 4096, 4096), ("w13", 4096, 28672), ("w2", 14336, 4096))
# The two expert stacks of one mixtral-8x7b layer, eight experts each.
EXPERT_LINEARS = (("w13", 4096, 28672), ("w2", 14336, 4096))
EXPERTS = 8
GROUP = 128


def quant_stack(gen, L, K, N, bits):
    """A stack of L quantized weights (true quantization of N(0, 1) / sqrt(K)),
    made one weight at a time: only one is ever held in fp32."""
    from mistral_inference_tpu_torch.ops.linear import quantize_weight

    qs = [quantize_weight(randn(gen, K, N) * K**-0.5, bits, GROUP) for _ in range(L)]
    return (torch.stack([qw["q4" if bits == 4 else "q"] for qw in qs]),
            torch.stack([qw["scale"] for qw in qs]))


def linear_library_ms(x, leaf):
    """F.linear on the dequantized weight: the yardstick only. Returns (with
    the dequantization inside the timed call, with a bf16 weight made before)."""
    import torch.nn.functional as F

    from mistral_inference_tpu_torch.ops.linear import dequant

    w = dequant(leaf, x.dtype).t().contiguous()
    pre = timed_ms(lambda: F.linear(x, w))
    del w
    return timed_ms(lambda: F.linear(x, dequant(leaf, x.dtype).t()), reps=5), pre


# Row counts K3 is timed at: the decode step (4), the engine's batch (8), a
# verify forward of B = 4 x (k + 1) (20) and of 32 rows, a prefill chunk (256).
K3_ROWS = (4, 8, 20, 32, 256)


def check_k3(gen):
    from mistral_inference_tpu_torch.ops.cuda.matmul_quant import (
        matmul_quant, matmul_quant_plain, matmul_quant_stacked,
    )
    from mistral_inference_tpu_torch.ops.linear import quantize_weight

    # The card's quantizer against the CPU's on one fp32 input: equal bytes
    # and scales (it divides by a tensor, not by a host scalar).
    w = torch.randn((1024, 768), generator=torch.Generator().manual_seed(0)) * 0.02
    for bits in (8, 4):
        cpu, card = quantize_weight(w, bits), quantize_weight(w.cuda(), bits)
        for key in cpu:
            require(torch.equal(cpu[key], card[key].cpu()),
                    f"quantize_weight int{bits} {key} on the card differs from the CPU's")

    L, li = 2, 1
    worst, shapes = 0.0, {}
    total = {k: 0.0 for k in ("ms", "plain_ms", "bound_ms", "library_ms", "library_predequant_ms",
                              "device_ms", "stream_device_ms")}
    sums = {f"int{bits}": {str(rows): 0.0 for rows in K3_ROWS} for bits in (4, 8)}
    by = set()
    # The rows at 8, 20 and 32 come from a generator of their own, so that
    # later checks draw what they drew before.
    own = torch.Generator(device="cuda").manual_seed(12)
    for bits in (4, 8):
        for name, K, N in LINEARS:
            q, scale = quant_stack(gen, L, K, N, bits)
            rec = {}
            for rows in K3_ROWS:
                x = randn(gen if rows in (4, 256) else own, rows, K, dtype=torch.bfloat16)
                ref = matmul_quant_plain(x, q[li], scale[li])
                out = matmul_quant_stacked(x, q, scale, li)
                one = matmul_quant(x, q[li], scale[li])
                again = matmul_quant_stacked(x, q, scale, li)
                torch.cuda.synchronize()
                case = f"int{bits} {name} {K}x{N} rows={rows}"
                ok, err = close(out, ref, 1e-2, 1e-2)
                require(ok, f"K3 disagrees with its plain version ({case}): {err}")
                require(torch.equal(out, one), f"K3 stacked and unstacked forms differ ({case})")
                require(torch.equal(out, again), f"K3 is not the same bits on a second run ({case})")
                worst = max(worst, err)
                ms = timed_ms(lambda: matmul_quant_stacked(x, q, scale, li))
                rec[f"rows{rows}_ms"] = ms
                sums[f"int{bits}"][str(rows)] += ms
                if rows != 4:
                    continue
                # The main path's decode shape: B = 4 rows.
                b_ms, b_by = bound(2.0 * rows * K * N, nbytes(x, q[li], scale[li]) + 2 * rows * N)
                lib, lib_pre = linear_library_ms(x, {("q4" if bits == 4 else "q"): q[li],
                                                     "scale": scale[li]})
                rec.update(bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                           library_predequant_ms=lib_pre,
                           plain_ms=timed_ms(lambda: matmul_quant_plain(x, q[li], scale[li]), reps=5),
                           device_ms=device_ms(lambda: matmul_quant_stacked(x, q, scale, li)),
                           stream_device_ms=device_ms(lambda: q[li].view(torch.int32).amax()))
                if bits == 4:
                    by.add(b_by)
                    for k in total:
                        total[k] += ms if k == "ms" else rec[k]
            shapes[f"int{bits}_{name}"] = rec
            del q, scale
    return {
        "name": K3, "kernel": "K3", "route": "cuda",
        "source": "mistral_inference_tpu_torch/ops/cuda/csrc/matmul_quant.cu",
        "replaces": "mistral_inference_tpu/ops/pallas/matmul_quant.py:354",
        "max_abs_err": worst, **total,
        "bound_by": by.pop() if len(by) == 1 else "bytes",
        "sums_by_rows_ms": sums, "floor_ms": floor_ms(),
        "design": "mma.sync m16n8k16 on dequant_mma.cuh (K8's loop): the weight as A from byte "
                  "permutes, up to 128 rows as n-tiles of 8 in one block (the weight read once; "
                  "129-256 rows a second row block), a three-stage cp.async ring with the "
                  "block's scales staged, a split of at most 8 from K, N, groups and bits alone "
                  "(never the rows), summed in split order over a cluster; K8's launcher, "
                  "row-count table and shape rule",
        "shape": "the sums over one layer's four int4 linears (wqkv 4096x6144, wo 4096x4096, "
                 "w13 4096x28672, w2 14336x4096; group 128) at B=4 rows, read from layer 1 of "
                 "a 2-layer stack; by_shape has each linear, int4 and int8, at 4, 8, 20, 32 and "
                 "256 rows (sums_by_rows_ms the sums); device_ms is the kernels' own device "
                 "time after the same L2 flush, stream_device_ms that of one PyTorch reduction "
                 "(amax) reading the same stored weight bytes, floor_ms what the event timing "
                 "adds to a one-element kernel",
        "library": "F.linear(x, dequant(w).T): library_ms dequantizes inside the timed call "
                   "(the same inputs), library_predequant_ms takes a bf16 weight made before",
        "by_shape": shapes,
        "tolerance": "abs 1e-2 + rel 1e-2 on bf16 outputs (fp32 sums in another order, one "
                     "rounding to bf16); stacked, unstacked and repeated launches equal bits; "
                     "quantize_weight on the card equal to the CPU's bytes and scales",
    }


def check_k5(gen):
    import torch.nn.functional as F

    from mistral_inference_tpu_torch.ops.cuda.moe_matmul import (
        moe_matmul_quant_ragged, moe_matmul_quant_ragged_plain,
    )
    from mistral_inference_tpu_torch.ops.linear import dequant

    rows, TM = 2048, 256
    tiles = rows // TM
    zeros = torch.zeros((tiles,), dtype=torch.int32, device="cuda")
    worst, shapes = 0.0, {}
    total = {k: 0.0 for k in ("ms", "plain_ms", "bound_ms", "library_ms", "library_predequant_ms")}
    by = set()
    for bits in (4, 8):
        for name, K, N in LINEARS:
            q, scale = quant_stack(gen, 1, K, N, bits)
            x = randn(gen, rows, K, dtype=torch.bfloat16)
            out = moe_matmul_quant_ragged(x, q, scale, zeros)
            ref = moe_matmul_quant_ragged_plain(x, q, scale, zeros)
            torch.cuda.synchronize()
            ok, err = close(out, ref, 1e-2, 1e-2)
            require(ok, f"K5 disagrees with its plain version (int{bits} {name} {K}x{N}): {err}")
            worst = max(worst, err)
            b_ms, b_by = bound(2.0 * rows * K * N, nbytes(x, q, scale, zeros) + 2 * rows * N)
            lib, lib_pre = linear_library_ms(x, {("q4" if bits == 4 else "q"): q[0],
                                                 "scale": scale[0]})
            rec = {
                "ms": timed_ms(lambda: moe_matmul_quant_ragged(x, q, scale, zeros), reps=5),
                "plain_ms": timed_ms(
                    lambda: moe_matmul_quant_ragged_plain(x, q, scale, zeros), reps=3),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
                "library_predequant_ms": lib_pre,
            }
            shapes[f"int{bits}_{name}"] = rec
            if bits == 4:
                by.add(b_by)
                for k in total:
                    total[k] += rec[k]
            del q, scale, x
    # Four weights in a two-layer stack, a mixed tile_group, layer 1.
    E, K, N = 4, 4096, 4096
    tg = torch.tensor([2, 0, 3, 3, 1, 0, 2, 1], dtype=torch.int32, device="cuda")
    for bits in (4, 8):
        q, scale = quant_stack(gen, 2 * E, K, N, bits)
        q, scale = q.view(2, E, -1, N), scale.view(2, E, -1, N)
        x = randn(gen, rows, K, dtype=torch.bfloat16)
        out = moe_matmul_quant_ragged(x, q, scale, tg, 1)
        ref = moe_matmul_quant_ragged_plain(x, q, scale, tg, 1)
        torch.cuda.synchronize()
        ok, err = close(out, ref, 1e-2, 1e-2)
        require(ok, f"K5 disagrees with its plain version (int{bits}, E=4, layer 1 of 2): {err}")
        worst = max(worst, err)
        del q, scale, x
    # The smaller cases the wrapper keeps: a group of 64, and row tiles of
    # 128 (16 tiles over four weights). These and the invariance cases below
    # draw from a generator of their own, so that every later check sees the
    # inputs it had before them.
    own = torch.Generator(device="cuda").manual_seed(5)
    K, N = 4096, 4096
    for bits in (4, 8):
        for group, TMc, Ec in ((64, 256, 1), (128, 128, 4)):
            from mistral_inference_tpu_torch.ops.linear import quantize_weight

            qws = [quantize_weight(randn(own, K, N) * K**-0.5, bits, group) for _ in range(Ec)]
            q = torch.stack([qw["q4" if bits == 4 else "q"] for qw in qws])
            scale = torch.stack([qw["scale"] for qw in qws])
            tgc = torch.tensor([(5 * t + 2) % Ec for t in range(rows // TMc)], dtype=torch.int32,
                               device="cuda")
            x = randn(own, rows, K, dtype=torch.bfloat16)
            out = moe_matmul_quant_ragged(x, q, scale, tgc)
            ref = moe_matmul_quant_ragged_plain(x, q, scale, tgc)
            torch.cuda.synchronize()
            ok, err = close(out, ref, 1e-2, 1e-2)
            require(ok, f"K5 disagrees with its plain version (int{bits}, group {group}, "
                        f"TM {TMc}, E={Ec}): {err}")
            worst = max(worst, err)
            del q, scale, x, qws
    # A Mixtral layer's eight experts over one chunk's sorted assignments:
    # 4 x 512 tokens, top-2, in (16 + 8) tiles of 256. The last five tiles
    # lie past the last expert's rows and carry the clamped index E - 1.
    E, rows8 = 8, 6144
    tg8 = torch.tensor([0, 0, 0, 1, 1, 2, 2, 2, 3, 3, 4, 4, 5, 5, 5, 6, 6, 7, 7] + [7] * 5,
                       dtype=torch.int32, device="cuda")
    # Batch invariance: a 256-row tile alone (E = 1), the same rows as tile 5
    # of 2048 (E = 1), and as tile 9 of the mixed E = 8 launch, whose weight
    # 3 is the same weight: equal bits, and again on a second launch.
    name, K, N = LINEARS[0]
    for bits in (4, 8):
        q, scale = quant_stack(own, E, K, N, bits)
        x8 = randn(own, rows8, K, dtype=torch.bfloat16)
        x = randn(own, rows, K, dtype=torch.bfloat16)
        x[5 * TM:6 * TM] = x8[9 * TM:10 * TM]
        alone = moe_matmul_quant_ragged(x8[9 * TM:10 * TM].contiguous(), q[3:4], scale[3:4],
                                        zeros[:1])
        dense = moe_matmul_quant_ragged(x, q[3:4], scale[3:4], zeros)
        mixed = moe_matmul_quant_ragged(x8, q, scale, tg8)
        again = moe_matmul_quant_ragged(x8, q, scale, tg8)
        torch.cuda.synchronize()
        require(tg8[9].item() == 3, "the invariance tile must carry weight 3")
        require(same_bits(alone, dense[5 * TM:6 * TM]),
                f"K5: a tile's bits alone differ from its bits among 2048 rows (int{bits})")
        require(same_bits(alone, mixed[9 * TM:10 * TM]),
                f"K5: a tile's bits alone differ from its bits in the E=8 launch (int{bits})")
        require(same_bits(mixed, again), f"K5 is not the same bits on a second run (int{bits})")
        del q, scale, x8, x, alone, dense, mixed, again
    e8 = {"ms": 0.0, "bound_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
          "library_predequant_ms": 0.0}
    for name, K, N in EXPERT_LINEARS:
        q, scale = quant_stack(gen, E, K, N, 4)
        x = randn(gen, rows8, K, dtype=torch.bfloat16)
        out = moe_matmul_quant_ragged(x, q, scale, tg8)
        ref = moe_matmul_quant_ragged_plain(x, q, scale, tg8)
        torch.cuda.synchronize()
        ok, err = close(out, ref, 1e-2, 1e-2)
        require(ok, f"K5 disagrees with its plain version (int4, E=8, {name} {K}x{N}): {err}")
        worst = max(worst, err)
        e8[f"{name}_ms"] = timed_ms(lambda: moe_matmul_quant_ragged(x, q, scale, tg8), reps=5)
        e8["ms"] += e8[f"{name}_ms"]
        e8["bound_ms"] += bound(2.0 * rows8 * K * N, nbytes(x, q, scale, tg8) + 2 * rows8 * N)[0]
        e8["plain_ms"] += timed_ms(
            lambda: moe_matmul_quant_ragged_plain(x, q, scale, tg8), reps=3)
        # The yardstick: no one call takes a weight per tile, so one F.linear
        # per expert on its own rows, all eight inside the timed call.
        spans = [(e, [t for t, g in enumerate(tg8.tolist()) if g == e]) for e in range(E)]
        spans = [(e, ts[0] * TM, (ts[-1] + 1) * TM) for e, ts in spans]
        leaves = [{"q4": q[e], "scale": scale[e]} for e in range(E)]

        def per_expert(ws):
            return [F.linear(x[a:b], w) for (e, a, b), w in zip(spans, ws)]

        e8["library_ms"] += timed_ms(
            lambda: per_expert([dequant(l, x.dtype).t() for l in leaves]), reps=3)
        ws = [dequant(l, x.dtype).t().contiguous() for l in leaves]
        e8["library_predequant_ms"] += timed_ms(lambda: per_expert(ws), reps=5)
        del q, scale, x, out, ref, ws, leaves
    return {
        "name": K5, "kernel": "K5", "route": "cuda",
        "source": "mistral_inference_tpu_torch/ops/cuda/csrc/moe_matmul.cu",
        "replaces": "mistral_inference_tpu/ops/pallas/moe_matmul.py:129",
        "design": "wgmma m64n128k16 from 128-byte-swizzled shared memory (x K-major, the "
                  "dequantized weight MN-major through the transpose bit), two warpgroups of "
                  "64 x 128 rows x columns; a six-stage cp.async ring four chunks ahead; chunk "
                  "c + 1's weight dequantized by the same warps while chunk c's products run, "
                  "into one of three bf16 buffers; one block barrier per 64-step chunk; 128 x "
                  "128 tiles, row blocks fastest (hopper.cuh)",
        "max_abs_err": worst, **total,
        "bound_by": by.pop() if len(by) == 1 else "operations",
        "shape": "the sums over one layer's four int4 linears (as K3) at 2048 rows = 4 x 512 in "
                 "8 tiles of 256, E=1; by_shape has each linear, int4 and int8; also checked: "
                 "E=4 in a 2-layer stack with a mixed tile_group and layer 1; experts_e8 is the "
                 "sum over a Mixtral layer's int4 w13 and w2 at E=8, 6144 sorted rows in 24 tiles "
                 "of 256, the last five past the last expert's rows, with its plain version's "
                 "time and, as library time, one F.linear per expert on its own rows; also "
                 "checked: group 64, row tiles of 128 over four weights, and a 256-row tile "
                 "alone, among 2048 rows and in the E=8 launch (equal bits, int4 and int8, "
                 "and on a second launch)",
        "experts_e8": e8,
        "library": "F.linear(x, dequant(w).T): library_ms dequantizes inside the timed call "
                   "(the same inputs), library_predequant_ms takes a bf16 weight made before",
        "by_shape": shapes,
        "tolerance": "abs 1e-2 + rel 1e-2 on bf16 outputs (fp32 sums in another order, one "
                     "rounding to bf16); a tile alone, among 2048 rows, in the E=8 launch and "
                     "on a second launch equal bits",
    }


def dispatch_buffers(gen, C, K, tokens=4, top_k=2):
    """Capacity buffers (E, C, K) as a decode step of ``tokens`` rows fills
    them: each token in the next free slot of ``top_k`` distinct random
    experts. Returns the buffers and the experts that hold a row."""
    x = torch.zeros((EXPERTS, C, K), dtype=torch.bfloat16, device="cuda")
    fill = [0] * EXPERTS
    for _ in range(tokens):
        row = randn(gen, K, dtype=torch.bfloat16)
        for e in torch.randperm(EXPERTS, generator=gen, device="cuda")[:top_k].tolist():
            x[e, fill[e]] = row
            fill[e] += 1
    return x, [e for e in range(EXPERTS) if fill[e]]


def check_k8(gen):
    from mistral_inference_tpu_torch.ops.cuda.moe_matmul import (
        moe_matmul_quant, moe_matmul_quant_plain, moe_matmul_quant_stacked,
    )
    from mistral_inference_tpu_torch.ops.linear import dequant

    E, L, li = EXPERTS, 2, 1
    worst, shapes = 0.0, {}
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "library_predequant_ms")
    total = {k: 0.0 for k in keys}
    live_counts = []
    for bits in (4, 8):
        for name, K, N in EXPERT_LINEARS:
            q, scale = quant_stack(gen, L * E, K, N, bits)
            q, scale = q.view(L, E, -1, N), scale.view(L, E, -1, N)
            ql, sl = q[li].contiguous(), scale[li].contiguous()
            rec = {}
            # The main path's decode buffers (B = 4, top-2: C = 4, some
            # experts empty); every slot of every expert full; C = 128.
            routed, live = dispatch_buffers(gen, 4, K)
            # The decode rows again among 124 more of every expert (all live),
            # drawn apart so that the later cases see the inputs they had.
            wide = randn(torch.Generator(device="cuda").manual_seed(bits * K), E, 128, K,
                         dtype=torch.bfloat16)
            wide[:, :4] = routed
            outs = {}
            for case, x in (("decode", routed), ("full", randn(gen, E, 4, K, dtype=torch.bfloat16)),
                            ("c128", randn(gen, E, 128, K, dtype=torch.bfloat16)), ("wide", wide)):
                ref = moe_matmul_quant_plain(x, ql, sl)
                out = moe_matmul_quant_stacked(x, q, scale, li)
                one = moe_matmul_quant(x, ql, sl)
                again = moe_matmul_quant_stacked(x, q, scale, li)
                torch.cuda.synchronize()
                what = f"int{bits} {name} {K}x{N} {case}"
                ok, err = close(out, ref, 1e-2, 1e-2)
                require(ok, f"K8 disagrees with its plain version ({what}): {err}")
                require(torch.equal(out, one), f"K8 stacked and unstacked forms differ ({what})")
                require(torch.equal(out, again), f"K8 is not the same bits on a second run ({what})")
                worst = max(worst, err)
                outs[case] = out
                if case != "wide":
                    rec[f"{case}_ms"] = timed_ms(
                        lambda: moe_matmul_quant_stacked(x, q, scale, li),
                        reps=5 if case == "c128" else 10)
            require(same_bits(outs["wide"][:, :4], outs["decode"]),
                    f"K8: a row's bits at C=4 differ from its bits at C=128 (int{bits} {name})")
            empty = [e for e in range(E) if e not in live]
            require(not bool(outs["decode"][empty].any()),
                    f"K8: an expert with no row did not give zeros (int{bits} {name})")
            del wide, outs
            x = routed
            # Least time: the stored bytes and scales of the experts that hold
            # a row, the buffers in and out.
            live_bytes = len(live) * (nbytes(ql, sl) // E)
            b_ms, b_by = bound(2.0 * 4 * len(live) * K * N, live_bytes + nbytes(x) + 2 * E * 4 * N)
            leaf = {("q4" if bits == 4 else "q"): ql, "scale": sl}
            w = dequant(leaf, x.dtype)
            lib_pre = timed_ms(lambda: torch.bmm(x, w))
            del w
            rec.update(
                live_experts=len(live), bound_ms=b_ms, bound_by=b_by,
                library_ms=timed_ms(lambda: torch.bmm(x, dequant(leaf, x.dtype)), reps=5),
                library_predequant_ms=lib_pre,
                plain_ms=timed_ms(lambda: moe_matmul_quant_plain(x, ql, sl), reps=5))
            shapes[f"int{bits}_{name}"] = rec
            if bits == 4:
                live_counts.append(len(live))
                for k in keys:
                    total[k] += rec["decode_ms"] if k == "ms" else rec[k]
            del q, scale, ql, sl
    return {
        "name": K8, "kernel": "K8", "route": "cuda",
        "source": "mistral_inference_tpu_torch/ops/cuda/csrc/moe_expert_matmul.cu",
        "replaces": "mistral_inference_tpu/ops/pallas/moe_matmul.py:56",
        "design": "mma.sync m16n8k16 with the weight as A (fragments assembled from the "
                  "stored bytes by byte permutes) and the capacity rows as n-tiles of 8; "
                  "each live expert's weight read once through a three-stage cp.async ring "
                  "(dequant_mma.cuh, the loop, launcher and row-count table K3 shares); a "
                  "fixed split of about 1024 stored rows, summed in order over a cluster",
        "max_abs_err": worst, **total, "bound_by": "bytes",
        "shape": "the sums over one Mixtral layer's two int4 expert stacks (E=8; w13 4096x28672, "
                 "w2 14336x4096; group 128) at the decode buffers of B=4, top-2 (C=4; "
                 f"{live_counts} experts hold a row), read from layer 1 of a 2-layer stack; "
                 "by_shape has each stack, int4 and int8, also with every slot full and at "
                 "C=128; also checked: the decode rows among 124 more rows of every expert "
                 "(equal bits) and zeros from the experts that hold no row",
        "library": "torch.bmm(x, dequant(w)) over all 8 experts: library_ms dequantizes inside "
                   "the timed call (the same inputs), library_predequant_ms takes a bf16 weight "
                   "made before",
        "by_shape": shapes,
        "tolerance": "abs 1e-2 + rel 1e-2 on bf16 outputs (fp32 sums in another order, one "
                     "rounding to bf16); stacked, unstacked and repeated launches equal bits; "
                     "a row at C=4 and at C=128 equal bits",
    }


def check_k6(gen, scaled: str = "int8"):
    """K6 over a ``scaled`` ring ("int8", which also checks the bf16 ring, or
    "fp8"): one row of the kernels line."""
    import torch.nn.functional as F

    from mistral_inference_tpu_torch.cache import dequant_layer, slot_positions
    from mistral_inference_tpu_torch.ops.attention import sliding_window_mask
    from mistral_inference_tpu_torch.ops.cuda.attention import (
        decode_attention, decode_attention_plain,
    )

    bf = torch.bfloat16
    B, S, window = 4, 4096, 4096
    worst, main, checked = 0.0, None, []
    # Rings after a decode step's write, (fills, attention window, layers):
    # the timed case (row 0 wrapped) over a 32-layer stack; short fills, so
    # that most cluster slices hold no visible slot; fills that end inside a
    # cluster slice (512 slots), inside a warp's part (64) and inside a
    # step, and a wrapped row that ends inside one; an attention window
    # shorter than the fill.
    cases = (([4301, 1001, 38, 3000], window, 32), ([1001, 38, 2999, 257], window, 4),
             ([1500, 515, 4096 + 77, 130], window, 4), ([3000, 4301, 1001, 38], 1000, 4))
    for kv_len, w_, L in cases:
        kv_len = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
        slot_pos, slot_valid = slot_positions(kv_len, window, S)
        q_pos = (kv_len - 1)[:, None].contiguous()
        for ring in (scaled, "bf16") if scaled == "int8" else (scaled,):
            CK, KS = make_ring(gen, ring, L, B, S)
            CV, VS = make_ring(gen, ring, L, B, S)
            CK, CV = CK.reshape(L, B, S, HKV * D), CV.reshape(L, B, S, HKV * D)
            q = randn(gen, B, 1, H, D, dtype=bf)
            li = L - 3
            before = [None if t is None else t[li].clone() for t in (CK, CV, KS, VS)]
            out = decode_attention(q, CK, CV, KS, VS, li, q_pos, slot_pos, slot_valid, w_)
            ref = decode_attention_plain(q, CK, CV, KS, VS, li, q_pos, slot_pos, slot_valid, w_)
            # Row 2 alone: the same bits as in the batch.
            one = [None if t is None else t[:, 2:3].contiguous() for t in (CK, CV, KS, VS)]
            alone = decode_attention(q[2:3].contiguous(), *one, li, q_pos[2:3].contiguous(),
                                     slot_pos[2:3].contiguous(), slot_valid[2:3].contiguous(), w_)
            torch.cuda.synchronize()
            case = f"{ring} ring, kv_len={kv_len.tolist()}, window={w_}"
            for t, b in zip((CK, CV, KS, VS), before):
                require(t is None or same_bits(t[li], b), f"K6 wrote the ring ({case})")
            ok, err = close(out, ref, 1e-2, 1e-2)
            require(ok, f"K6 disagrees with its plain version ({case}): {err}")
            require(same_bits(out[2:3], alone),
                    f"K6: row 2's bits alone differ from its bits at B={B} ({case})")
            worst = max(worst, err)
            checked.append(case)
            if ring == scaled and main is None:
                main = (q, CK, CV, KS, VS, li, q_pos, slot_pos, slot_valid, w_)
            del CK, CV, KS, VS, one

    q, CK, CV, KS, VS, li, q_pos, slot_pos, slot_valid, window = main
    L = CK.shape[0]
    ones = torch.ones((B, 1), dtype=torch.bool, device="cuda")
    mask = sliding_window_mask(q_pos, slot_pos, ones, slot_valid, window)
    visible = float(mask.sum())
    ring_bytes = visible * HKV * (2 * D + 2 * 4)
    b_ms, b_by = bound(4.0 * D * H * visible,
                       ring_bytes + nbytes(q, q_pos, slot_pos, slot_valid) + 2 * B * H * D)
    layer = [0]

    def cycle_layers():
        # The next layer of the stack on each call, as a decode step takes them.
        layer[0] = (layer[0] + 1) % L
        return decode_attention(q, CK, CV, KS, VS, layer[0], q_pos, slot_pos, slot_valid, window)

    kh = dequant_layer(CK[li], KS[li], bf, HKV).transpose(1, 2).contiguous()
    vh = dequant_layer(CV[li], VS[li], bf, HKV).transpose(1, 2).contiguous()
    qh, m = q.transpose(1, 2).contiguous(), mask[:, None].contiguous()
    return {
        "name": K6 + ("_fp8" if scaled == "fp8" else ""), "kernel": "K6", "route": "cuda",
        "ring": scaled,
        "source": "mistral_inference_tpu_torch/ops/cuda/csrc/decode_attention.cu",
        "loop": "mistral_inference_tpu_torch/ops/cuda/csrc/decode_hopper.cuh",
        "replaces": "mistral_inference_tpu/ops/pallas/attention.py:619",
        "max_abs_err": worst,
        "ms": timed_ms(cycle_layers),
        "split_ms": kernel_split_ms(cycle_layers),
        "plain_ms": timed_ms(lambda: decode_attention_plain(*main)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timed_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=m, enable_gqa=True)),
        "shape": f"B=4 over a 32-layer {scaled} ring stack of S=4096 (one row wrapped, fills "
                 "1001, 38 and 3000) H=32 Hkv=8 D=128",
        "checked": checked,
        "cases": "short fills; fills ending inside a cluster slice, a warp's part and a step; "
                 "a window of 1000 under fills of 3000 and a wrap"
                 + ("; bf16 rings" if scaled == "int8" else "")
                 + "; in each, row 2's bits alone equal its bits in the batch",
        "library": "SDPA with a mask on one layer's ring dequantized to bf16 before the call",
        "tolerance": "abs 1e-2 + rel 1e-2 (bf16 output, fp32 sums in another order); the ring "
                     "is unchanged",
    }


def check_k7(gen, scaled: str = "int8"):
    """K7 over a ``scaled`` ring ("int8", which also checks the bf16 ring, or
    "fp8"): one row of the kernels line."""
    import torch.nn.functional as F

    from mistral_inference_tpu_torch.cache import dequant_layer, slot_positions
    from mistral_inference_tpu_torch.ops.attention import sliding_window_mask
    from mistral_inference_tpu_torch.ops.cuda.attention import (
        fused_update_decode_attention, fused_verify_chunk_attention,
        fused_verify_chunk_attention_plain,
    )

    bf = torch.bfloat16
    L, B, S, window, li = 32, 4, 4096, 4096, 5
    worst, main, checked = 0.0, None, []

    def make(ring_type):
        CK, KS = make_ring(gen, ring_type, L, B, S)
        CV, VS = make_ring(gen, ring_type, L, B, S)
        return [CK.reshape(L, B, S, HKV * D), CV.reshape(L, B, S, HKV * D), KS, VS]

    def clones(stacks):
        return [None if t is None else t.clone() for t in stacks]

    # (T, fills, live rows, ring, query heads): T = 5 with slots 126..130
    # across a warp's part (64 slots) and a dead row (the timed case); T = 8,
    # 32 query rows, with slots 124..131 across a part and a chunk that ends
    # in the ring's last slot; T = 5 across a cluster slice (509..513; 512
    # slots a slice) and from the first slot of a part (64); 8 query heads per
    # KV head at T = 4 (32 rows), from the first slot of a slice and to the
    # last of a part; with the int8 ring, a bf16 ring.
    cases = [(5, [126, 1000, 2999, 4000], [1, 1, 1, 0], scaled, H),
             (8, [3000, 124, 4088, 37], [1, 1, 1, 1], scaled, H),
             (5, [509, 64, 2000, 7], [1, 1, 0, 1], scaled, H),
             (4, [512, 60, 1021, 3000], [1, 1, 1, 1], scaled, 64)]
    if scaled == "int8":
        cases.append((5, [126, 1000, 2999, 4000], [1, 1, 1, 0], "bf16", H))
    for T, kv_len, live, ring, heads in cases:
        kv_len = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
        live = torch.tensor(live, dtype=torch.int32, device="cuda")
        steps = torch.arange(T, dtype=torch.int32, device="cuda")
        q_pos = kv_len[:, None] + steps[None]
        write_slot0 = torch.where(live > 0, kv_len % window, -1).to(torch.int32)
        slot_pos, slot_valid = slot_positions(kv_len + live * T, window, S)
        stacks = make(ring)
        start = clones(stacks)
        xq = randn(gen, B, T, heads, D, dtype=bf)
        xk, xv = randn(gen, B, T, HKV, D, dtype=bf) * 3, randn(gen, B, T, HKV, D, dtype=bf)
        case = f"T={T}, {ring} ring, kv_len={kv_len.tolist()}, live={live.tolist()}, H={heads}"
        tail = (li, window, write_slot0, q_pos, slot_pos, slot_valid)
        out = fused_verify_chunk_attention(xq, xk, xv, *stacks, *tail)
        plain_stacks = clones(start)
        ref = fused_verify_chunk_attention_plain(xq, xk, xv, *plain_stacks, *tail)
        torch.cuda.synchronize()
        for name, a, b in zip(("CK", "CV", "KS", "VS"), stacks, plain_stacks):
            if a is not None:
                require(same_bits(a, b), f"K7 ring {name} after the write is not bit-identical "
                                         f"to _quantize_ring's, the plain write ({case}): "
                                         f"{differ(a, b)} elements differ")
        ok, err = close(out, ref, 1e-2, 1e-2)
        require(ok, f"K7 output disagrees with its plain version ({case}): {err}")
        worst = max(worst, err)
        # A second launch on the ring it has written: the same bits.
        again = fused_verify_chunk_attention(xq, xk, xv, *stacks, *tail)
        require(torch.equal(again, out), f"K7 is not the same bits on a second run ({case})")
        # Row 0 alone, from the same start: its bits and ring in the batch.
        one = [None if t is None else t[:, :1].contiguous() for t in start]
        alone = fused_verify_chunk_attention(
            *(x[:1].contiguous() for x in (xq, xk, xv)), *one, li, window,
            *(x[:1].contiguous() for x in (write_slot0, q_pos, slot_pos, slot_valid)))
        torch.cuda.synchronize()
        require(same_bits(out[:1], alone),
                f"K7: row 0's bits alone differ from its bits at B={B} ({case})")
        for a, b in zip(stacks, one):
            require(a is None or same_bits(a[:, :1], b),
                    f"K7: row 0 alone wrote another ring ({case})")
        del one
        # T sequential K2 steps from the same start give query t's bits and
        # the same ring: what lets greedy speculation equal greedy decoding.
        seq = clones(start)
        for t in range(T):
            sp, sv = slot_positions(kv_len + live * (t + 1), window, S)
            ws = torch.where(live > 0, (kv_len + t) % window, -1).to(torch.int32)
            o = fused_update_decode_attention(
                xq[:, t:t + 1].contiguous(), xk[:, t:t + 1].contiguous(),
                xv[:, t:t + 1].contiguous(), *seq, li, window, ws, q_pos[:, t].contiguous(),
                sp, sv)
            rows = live > 0
            require(torch.equal(o[rows, 0], out[rows, t]),
                    f"K7 query {t} differs in bits from a K2 step at its position ({case})")
        torch.cuda.synchronize()
        for a, b in zip(stacks, seq):
            require(a is None or same_bits(a, b), f"K7's ring differs from T K2 steps' ({case})")
        # T = 1 is K2: the same output bits and ring.
        one, two = clones(start), clones(start)
        sp, sv = slot_positions(kv_len + live, window, S)
        o7 = fused_verify_chunk_attention(
            xq[:, :1].contiguous(), xk[:, :1].contiguous(), xv[:, :1].contiguous(), *one, li,
            window, write_slot0, q_pos[:, :1].contiguous(), sp, sv)
        o2 = fused_update_decode_attention(
            xq[:, :1].contiguous(), xk[:, :1].contiguous(), xv[:, :1].contiguous(), *two, li,
            window, write_slot0, q_pos[:, 0].contiguous(), sp, sv)
        torch.cuda.synchronize()
        require(torch.equal(o7, o2), f"K7 at T = 1 differs in bits from K2 ({case})")
        for a, b in zip(one, two):
            require(a is None or same_bits(a, b), f"K7 at T = 1 wrote another ring than K2 ({case})")
        checked.append(case)
        if main is None:
            main = (xq, xk, xv, *stacks, *tail)
            main_live = live
        del stacks, start, plain_stacks, seq, one, two

    xq, xk, xv, CK, CV, KS, VS, li, window, write_slot0, q_pos, slot_pos, slot_valid = main
    T = xq.shape[1]
    ones = torch.ones((B, T), dtype=torch.bool, device="cuda")
    mask = sliding_window_mask(q_pos, slot_pos, ones, slot_valid, window)
    # Bytes: each (row, slot) pair that any query of the row sees, once
    # (one-byte K and V for every KV head plus their fp32 scales); the T slots a live
    # row writes; the small operands in and the output out.
    seen = float(mask.any(dim=1).sum())
    ring_bytes = seen * HKV * (2 * D + 2 * 4)
    write_bytes = float(main_live.sum()) * T * HKV * (2 * D + 2 * 4)
    small = nbytes(xq, xk, xv, write_slot0, q_pos, slot_pos, slot_valid) + 2 * B * T * H * D
    b_ms, b_by = bound(4.0 * D * H * float(mask.sum()), ring_bytes + write_bytes + small)
    layer = [0]

    def cycle_layers():
        # The next layer of the 32-layer stack on each call, as a verify
        # forward takes them, so the timed ring is never the one just read.
        layer[0] = (layer[0] + 1) % L
        args = list(main)
        args[7] = layer[0]
        return fused_verify_chunk_attention(*args)

    plain_stacks = [t.clone() for t in (CK, CV, KS, VS)]
    kh = dequant_layer(CK[li], KS[li], bf, HKV).transpose(1, 2).contiguous()
    vh = dequant_layer(CV[li], VS[li], bf, HKV).transpose(1, 2).contiguous()
    qh, m = xq.transpose(1, 2).contiguous(), mask[:, None].contiguous()
    xs = [[x[:, t:t + 1].contiguous() for x in (xq, xk, xv)] for t in range(T)]
    qps = [q_pos[:, t].contiguous() for t in range(T)]

    def k2_loop():
        # The same chunk as T single-token launches, which read the ring T times.
        layer[0] = (layer[0] + 1) % L
        for t in range(T):
            fused_update_decode_attention(*xs[t], CK, CV, KS, VS, layer[0], window, write_slot0,
                                          qps[t], slot_pos, slot_valid)

    return {
        "name": K7 + ("_fp8" if scaled == "fp8" else ""), "kernel": "K7", "route": "cuda",
        "ring": scaled, "ring_bytes_equal_quantize_ring": True,
        "source": "mistral_inference_tpu_torch/ops/cuda/csrc/fused_decode.cu",
        "loop": "mistral_inference_tpu_torch/ops/cuda/csrc/decode_hopper.cuh",
        "replaces": "mistral_inference_tpu/ops/pallas/attention.py:1552",
        "max_abs_err": worst,
        "ms": timed_ms(cycle_layers),
        "split_ms": kernel_split_ms(cycle_layers),
        "plain_ms": timed_ms(lambda: fused_verify_chunk_attention_plain(
            xq, xk, xv, *plain_stacks, *main[7:])),
        "bound_ms": b_ms, "bound_by": b_by,
        "bound": "each (row, slot) pair that any query of the row sees, once (one-byte K and V "
                 "of every KV head and their fp32 scales), plus the T slots a live row writes, "
                 "the small operands in and the output out, over the card's memory rate",
        "library_ms": timed_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=m, enable_gqa=True)),
        "k2_loop_ms": timed_ms(k2_loop),
        "shape": f"B=4 T=5 over a 32-layer {scaled} ring stack of S=4096 (fills 126, 1000, 2999 "
                 "and a dead row at 4000; row 0's slots 126..130 cross a warp's part) H=32 Hkv=8 "
                 "D=128",
        "checked": checked,
        "library": "SDPA with a mask on one layer's ring dequantized to bf16 before the call, "
                   "after the write: no one PyTorch call writes the ring and attends",
        "k2_loop": "the same chunk as T launches of K2, which read the ring T times",
        "tolerance": "ring bytes and scales bit-identical to the plain write; output abs 1e-2 + "
                     "rel 1e-2 (bf16 output, fp32 sums in another order); a second launch, T "
                     "sequential K2 steps (outputs and ring), K2 at T = 1 and row 0 alone "
                     "(output and ring) equal bits",
    }


def check_k4_fp8(gen):
    return check_k4(gen, "fp8")


def check_k2_fp8(gen):
    return check_k2(gen, "fp8")


def check_k6_fp8(gen):
    return check_k6(gen, "fp8")


def check_k7_fp8(gen):
    return check_k7(gen, "fp8")


# Codestral-Mamba-7B's SSD widths: 128 heads of 64, d_state 128, 8 groups, 64 layers.
SSD_L, SSD_NH, SSD_HD, SSD_DS, SSD_NG = 64, 128, 64, 128, 8


def check_k9(gen):
    """K9 at Codestral-Mamba's shapes, B = 4, on layer 37 of a 64-layer
    stack, fp32 and bf16 states: the state's bits against the plain
    version's, a dead row, the other layers, a second launch."""
    from mistral_inference_tpu_torch.ops.cuda.ssd_step import (
        fused_ssd_step_stacked, fused_ssd_step_stacked_plain,
    )

    B, li, dead = 4, 37, 3
    L, NH, HD, DS, NG = SSD_L, SSD_NH, SSD_HD, SSD_DS, SSD_NG
    out = {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        ssm = randn(gen, L, B, NH, HD, DS, dtype=dtype)
        start = ssm.clone()
        # dt as the model makes it (softplus'ed, in [1e-3, 0.1]); A in [-16, -1].
        dt = torch.rand((B, NH), generator=gen, device="cuda") * 0.099 + 1e-3
        dt[dead] = 0.0  # a dead row: a = 1, dtx = 0
        A = -(1.0 + 15.0 * torch.rand((NH,), generator=gen, device="cuda"))
        a = torch.exp(dt * A)
        dtx = dt[..., None] * randn(gen, B, NH, HD)
        Bm, Cm = randn(gen, B, NG, DS), randn(gen, B, NG, DS)
        y = fused_ssd_step_stacked(a, dtx, Bm, Cm, ssm, li)
        plain = start[li : li + 1].clone()
        y_ref = fused_ssd_step_stacked_plain(a, dtx, Bm, Cm, plain, 0)
        torch.cuda.synchronize()
        case = f"{name} state, B={B}, layer {li} of {L}"
        require(torch.equal(ssm[li], plain[0]),
                f"K9 state bits differ from the plain version's ({case}): "
                f"{int((ssm[li] != plain[0]).sum())} elements")
        require(torch.equal(ssm[li, dead], start[li, dead]), f"K9 changed a dead row ({case})")
        require(torch.equal(ssm[:li], start[:li]) and torch.equal(ssm[li + 1 :], start[li + 1 :]),
                f"K9 touched another layer ({case})")
        ok, err = close(y, y_ref, 1e-5, 1e-5)
        require(ok, f"K9 y disagrees with its plain version ({case}): {err}")
        ssm[li] = start[li]
        again = fused_ssd_step_stacked(a, dtx, Bm, Cm, ssm, li)
        torch.cuda.synchronize()
        require(torch.equal(again, y) and torch.equal(ssm[li], plain[0]),
                f"K9 is not the same bits on a second run ({case})")
        del start, plain
        state_bytes = 2 * B * NH * HD * DS * ssm.element_size()  # layer li read once, written once
        b_ms, b_by = bound(5.0 * B * NH * HD * DS, state_bytes + nbytes(a, dtx, Bm, Cm, y),
                           torch.float32)
        out[name] = {
            "max_abs_err": err,
            "ms": timed_ms(lambda: fused_ssd_step_stacked(a, dtx, Bm, Cm, ssm, li)),
            "plain_ms": timed_ms(lambda: fused_ssd_step_stacked_plain(a, dtx, Bm, Cm, ssm, li)),
            "bound_ms": b_ms, "bound_by": b_by,
            "device_ms": device_ms(lambda: fused_ssd_step_stacked(a, dtx, Bm, Cm, ssm, li)),
        }
        copy = torch.empty_like(ssm[li])
        out[name]["copy_device_ms"] = device_ms(lambda: copy.copy_(ssm[li]))
        del copy
        del ssm
    f32, b16 = out["fp32"], out["bf16"]
    return {
        "name": K9, "kernel": "K9", "route": "cuda",
        "source": "mistral_inference_tpu_torch/ops/cuda/csrc/ssd_step.cu",
        "replaces": "mistral_inference_tpu/ops/pallas/ssd_step.py:78",
        "max_abs_err": max(o["max_abs_err"] for o in out.values()),
        "ms": f32["ms"], "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"], "library_ms": None,
        "bf16_ms": b16["ms"], "bf16_bound_ms": b16["bound_ms"], "bf16_state": b16,
        "device_ms": f32["device_ms"], "copy_device_ms": f32["copy_device_ms"],
        "floor_ms": floor_ms(),
        "design": "one block of 128 threads per (head, row), 512 at this shape, all resident; "
                  "the head's state as a run of 16-byte pieces (4 fp32 or 8 bf16 columns), "
                  "thread t taking pieces t, t + 128, ... and issuing every load of its share "
                  "(16 or 8 pieces) before its first store; h'.C reduced over the threads of a "
                  "row by shuffles, every row's sum at once",
        "shape": f"B={B} nh={NH} hd={HD} ds={DS} ng={NG}, layer {li} of a {L}-layer fp32 "
                 "state stack (bf16_state: the same on a bf16 stack); row 3 dead; device_ms "
                 "the kernel's own device time after the same L2 flush, copy_device_ms that "
                 "of one PyTorch copy reading and writing the layer's state, floor_ms what the "
                 "event timing adds to a one-element kernel",
        "bound": "the layer's state read once and written once, the small operands in and y "
                 "out, over the card's memory rate; 5 fp32 operations per state element over "
                 "the 67 TFLOP/s fp32 peak",
        "library": "none: no one PyTorch call updates the state and reduces it",
        "tolerance": "state bit-identical to the plain version (fp32 and bf16), dead row and the "
                     "other 63 layers bit-unchanged, a second launch equal bits; y abs 1e-5 + "
                     "rel 1e-5 (fp32 sums in another order)",
    }


# Pixtral's vision encoder: 16 heads of 64 over a 4096-patch image.
VIS_H, VIS_D = 16, 64


def check_k10(gen):
    """K10 at Pixtral's encoder shapes: a full 1024 x 1024 image (N = 4096,
    no padding, the timed case), a 504-patch image in its 512 bucket (8
    padding rows of id -1), a 256-patch bucket, two images of 1536 and 2048
    patches in one N = 3584 row with ids 0 and 1 (the concatenated
    block-diagonal form), and images of 1600 and 1984 patches (a boundary
    inside a tile), whose first alone must give its bits in the pair."""
    from mistral_inference_tpu_torch.ops.cuda.attention import (
        segment_attention_plain, segment_flash_attention,
    )

    bf = torch.bfloat16
    # The last case puts an image boundary inside a 128-row tile (1536 is a
    # whole number of tiles; 1600 is not): the straddling tiles are masked.
    cases = (("image 4096", [(0, 4096)]), ("bucket 512, 8 padding", [(0, 504), (-1, 8)]),
             ("bucket 256", [(0, 256)]), ("two images 1536 + 2048", [(0, 1536), (1, 2048)]),
             ("two images 1600 + 1984", [(0, 1600), (1, 1984)]))
    worst, rows = 0.0, []
    for label, parts in cases:
        N = sum(n for _, n in parts)
        seg = torch.cat([torch.full((n,), i, dtype=torch.int32, device="cuda")
                         for i, n in parts])[None]
        q, k, v = (randn(gen, 1, N, VIS_H, VIS_D, dtype=bf) for _ in range(3))
        out = segment_flash_attention(q, k, v, seg)
        ref = segment_attention_plain(q, k, v, seg)
        torch.cuda.synchronize()
        ok, err = close(out, ref, 1e-2, 1e-2)
        require(ok, f"K10 disagrees with its plain version ({label}, N={N}): {err}")
        worst = max(worst, err)
        if len(parts) == 2 and parts[0][1] % 128:
            # Batch invariance: the first image alone has the bits it has
            # beside the second (encode_images with group_max > 1).
            n0 = parts[0][1]
            alone = segment_flash_attention(*(x[:, :n0].contiguous() for x in (q, k, v, seg)))
            torch.cuda.synchronize()
            require(same_bits(alone, out[:, :n0]),
                    f"K10: an image alone differs in its bits from the same image in a "
                    f"group ({label})")
        mask = seg[:, :, None] == seg[:, None, :]
        b_ms, b_by = bound(4.0 * VIS_D * VIS_H * float(mask.sum()),
                           nbytes(q, k, v, seg) + nbytes(q))
        ms = timed_ms(lambda: segment_flash_attention(q, k, v, seg))
        library_ms = sdpa_ms(q, k, v, mask)
        rows.append({
            "case": label, "N": N, "max_abs_err": err, "ms": ms,
            "plain_ms": timed_ms(lambda: segment_attention_plain(q, k, v, seg), reps=3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "ms_over_library": ms / library_ms,
        })
        del q, k, v, out, ref, mask
    main = rows[0]
    return {
        "name": "segment_flash_attention", "kernel": "K10", "route": "cuda",
        "source": "mistral_inference_tpu_torch/ops/cuda/csrc/segment_attention.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:140 (stock "
                    "flash_attention with SegmentIds, called at "
                    "mistral_inference_tpu/models/vision.py:161-197)",
        "max_abs_err": worst, "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"], "ms_over_library": main["ms_over_library"],
        "cases": rows,
        "shape": f"B=1 N=4096 H={VIS_H} D={VIS_D} bf16, one segment (a 1024 x 1024 image); "
                 "cases: each of the five shapes; the 1600-patch image alone has the bits "
                 "it has beside the 1984-patch one",
        "bound": "4 D H flops per visible (query, key) pair over the bf16 tensor-core peak; "
                 "q, k, v, seg in and out once over the memory rate",
        "library": "F.scaled_dot_product_attention with the (N, N) boolean segment mask",
        "tolerance": "abs 1e-2 + rel 1e-2 on bf16 outputs (both sides round p to bf16 before "
                     "the PV product; fp32 sums in another order)",
    }


# ---------------------------------------------------------------------------
# Phase 4: the main paths
# ---------------------------------------------------------------------------


class RouteLog:
    """Records the experts every router call picks while it is entered."""

    def __init__(self):
        self.picks = []

    def __enter__(self):
        from mistral_inference_tpu_torch.models import transformer as tf

        self._tf, self._route = tf, tf._route

        def logged(x, gate, top_k, *rest):
            idx, w = self._route(x, gate, top_k, *rest)
            self.picks.append(idx)
            return idx, w

        tf._route = logged
        return self

    def __exit__(self, *exc):
        self._tf._route = self._route


def routing_flips(run, prompts, gen, n_layers: int):
    """For each generated token, in how many layers it chose another set of
    experts in the decode step that made it than in the teacher-forced prefill
    of prompt + generated tokens: (B, steps) int. A router near-tie that falls
    the other way sends a token through other experts in the two passes, which
    the decode == prefill gap then shows."""
    B, steps = len(prompts), len(gen[0])
    with RouteLog() as dec:
        (again, _), _ = run(prompts, max_tokens=steps, temperature=0.0)
    require(again == gen, "greedy tokens differ between two runs")
    with RouteLog() as pre:
        run([p + g for p, g in zip(prompts, gen)], max_tokens=0, temperature=0.0)
    # Decode: the last steps * layers calls, step-major, each (B, k).
    d = torch.stack(dec.picks[-steps * n_layers:]).view(steps, n_layers, B, -1)
    # Prefill: chunk-major calls of (B * CHUNK, k) -> (layers, B, positions, k).
    chunks = len(pre.picks) // n_layers
    f = torch.stack(pre.picks).view(chunks, n_layers, B, CHUNK, -1)
    f = f.permute(1, 2, 0, 3, 4).reshape(n_layers, B, chunks * CHUNK, -1)
    flips = []
    for b, p in enumerate(prompts):
        teacher = f[:, b, len(p): len(p) + steps]  # (layers, steps, k)
        same = (d[:, :, b].transpose(0, 1).sort(-1).values == teacher.sort(-1).values).all(-1)
        flips.append((~same).sum(0))
    return torch.stack(flips).cpu().numpy()


def timed_run(generate_fn, model, **fixed):
    """``generate_fn`` on ``model`` with chunk CHUNK and ``fixed`` keywords,
    timed on the host between two synchronizations: (result, seconds)."""

    def run(p, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = generate_fn(p, model, chunk_size=CHUNK, **fixed, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t
    return run


def launch_counts():
    from mistral_inference_tpu_torch.ops import cuda as kern

    return {fn.__name__: fn.launches for fn in kern.all_kernels()}


def greedy_phase(run, prompts, vocab_size: int, counts, repeats: int = REPEATS):
    """What every main path runs first: the greedy calls. Returns (tokens,
    logprobs, TTFT s, greedy generate(32) s, the launches of one greedy
    call). The first call of a process also pays cuBLAS and allocator
    set-up; the timed calls come after it. Decode time is the difference of
    two medians (32 tokens less 1), and the host, which bounds decode, shares
    its cores, so each is the median of ``repeats`` calls."""
    run(prompts, max_tokens=2, temperature=0.0)
    ttft_s = statistics.median(
        run(prompts, max_tokens=1, temperature=0.0)[1] for _ in range(repeats))
    before = counts()
    (gen, lps), t0 = run(prompts, max_tokens=GREEDY_TOKENS, temperature=0.0)
    per_greedy = {k: n - before[k] for k, n in counts().items()}
    totals = [t0]
    for _ in range(repeats - 1):
        (again, _), t = run(prompts, max_tokens=GREEDY_TOKENS, temperature=0.0)
        require(again == gen, "greedy tokens differ between two runs")
        totals.append(t)
    require(all(len(g) == GREEDY_TOKENS for g in gen), "wrong number of generated tokens")
    require(all(0 <= t < vocab_size for g in gen for t in g), "token out of range")
    require(all(len(lp) == len(p) - 1 + GREEDY_TOKENS for lp, p in zip(lps, prompts)),
            "wrong number of logprobs")
    require(all(math.isfinite(x) for lp in lps for x in lp), "non-finite logprob")
    return gen, lps, ttft_s, statistics.median(totals), per_greedy


def prefill_gap(run, prompts, gen, lps):
    """decode == prefill: the |gap| (B, steps) between each generated
    token's logprob and a teacher-forced prefill's of prompt + tokens."""
    import numpy as np

    full = [p + g for p, g in zip(prompts, gen)]
    (_, lps_tf), _ = run(full, max_tokens=0, temperature=0.0)
    return np.stack([
        np.abs(np.array(a[-len(g):]) - np.array(b[-len(g):])) for a, b, g in zip(lps, lps_tf, gen)
    ])


def topp_phase(run, prompts, **kw) -> float:
    """top-p sampling, twice with one seed: the same tokens. Returns the
    first call's seconds."""
    (s1, l1), topp_s = run(prompts, max_tokens=TOPP_TOKENS, temperature=0.7, top_p=0.9, seed=1,
                           **kw)
    (s2, _), _ = run(prompts, max_tokens=TOPP_TOKENS, temperature=0.7, top_p=0.9, seed=1, **kw)
    require(s1 == s2, "top-p tokens differ between two runs with one seed")
    require(all(len(g) == TOPP_TOKENS for g in s1)
            and all(len(lp) == len(p) - 1 + TOPP_TOKENS for lp, p in zip(l1, prompts)),
            "wrong number of sampled tokens or logprobs")
    return topp_s


MOE_DROP_ROWS, MOE_DROP_FACTOR = 256, 0.5
MOE_DROPS = "moe_dropped_assignments"


def moe_drop_line(card: str) -> dict:
    """The ``MISTRAL_MOE_DEBUG`` drop counter on one ``mixtral-8x7b`` layer at
    full width (int4, random weights from seed 0): ``_moe_ffn_dispatch`` over
    256 rows at capacity factor 0.5 with the switch on, then off (set
    in-process, so that no other phase counts). On: the count kept on the
    card, folded into ``METRICS``, equals the assignments past an expert's capacity, counted by a host loop
    over the same routing, and is above 0; off: nothing is counted. Both
    outputs are equal in bits, and each launches K8 twice (w13, w2)."""
    from mistral_inference_tpu_torch.model import Transformer
    from mistral_inference_tpu_torch.models import transformer as tf
    from mistral_inference_tpu_torch.models.registry import get_args
    from mistral_inference_tpu_torch.ops import cuda as kern
    from mistral_inference_tpu_torch.utils.profiling import METRICS

    t0 = time.perf_counter()
    args = get_args(MOE_MODEL)
    args.n_layers, args.moe_impl = 1, "dispatch"
    model = Transformer.random(args, dtype=torch.bfloat16, seed=0, quant="int4")
    lw = model.params["layers"][0]
    k, E = args.moe.num_experts_per_tok, args.moe.num_experts
    x = randn(torch.Generator(device="cuda").manual_seed(23), MOE_DROP_ROWS, args.dim,
              dtype=torch.bfloat16)
    C = tf.moe_capacity(MOE_DROP_ROWS, k, E, MOE_DROP_FACTOR)
    filled, plain = [0] * E, 0
    for e in tf._route(x, lw["gate"], k)[0].reshape(-1).tolist():
        plain += filled[e] >= C
        filled[e] += 1
    runs, saved = {}, tf._MOE_DEBUG
    try:
        for on in (True, False):
            tf._MOE_DEBUG = on
            METRICS.__init__()
            kern.reset_launch_counts()
            y = tf._moe_ffn_dispatch(x, lw, k, MOE_DROP_FACTOR, args)
            torch.cuda.synchronize()
            METRICS.fold_on_device()  # the count is kept on the card until folded
            runs[on] = (y, METRICS.counters.get(MOE_DROPS), launch_counts()[K8])
    finally:
        tf._MOE_DEBUG = saved
        METRICS.__init__()
    (y_on, counted, k8_on), (y_off, off, k8_off) = runs[True], runs[False]
    out = {"phase": "moe_drops", "card": card, "model": MOE_MODEL, "layer": "one, full width",
           "weights": "int4 (seed 0)", "rows": MOE_DROP_ROWS, "top_k": k, "experts": E,
           "capacity_factor": MOE_DROP_FACTOR, "capacity": C, "assignments": MOE_DROP_ROWS * k,
           "counted_on": counted, "plain_count": plain, "counted_off": off,
           "k8_launches": [k8_on, k8_off], "outputs_equal_bits": same_bits(y_on, y_off),
           "finite": bool(torch.isfinite(y_on).all())}
    del model
    torch.cuda.empty_cache()
    require(plain > 0 and counted == plain, f"moe drops: counted {counted}, plain {plain}")
    require(off is None, f"moe drops: {off} counted with the switch off")
    require(k8_on == k8_off == 2, f"moe drops: K8 launched {k8_on}, {k8_off} times, not 2")
    require(out["outputs_equal_bits"] and out["finite"], "moe drops: the counter changed "
                                                         "the output, or it is not finite")
    out["seconds"] = time.perf_counter() - t0
    return out


def main_path(card: str, profile: bool, path: MainPath):
    """Drive one path of PATHS; returns (its summary line, its launch counts)."""
    import numpy as np

    from mistral_inference_tpu_torch.generate import generate
    from mistral_inference_tpu_torch.model import Transformer
    from mistral_inference_tpu_torch.models import transformer as tf
    from mistral_inference_tpu_torch.models.registry import get_args
    from mistral_inference_tpu_torch.ops import cuda as kern

    label, quant, repeats = path.label, path.quant, REPEATS
    args = get_args(path.model)
    args.kv_quant = path.ring
    args.n_layers = path.layers
    args.sliding_window = WINDOW  # the 7B preset's own; given to Mixtral so that its ring wraps too
    if args.moe:
        args.moe_impl = "dispatch"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # True quantization of weights drawn in bf16, so the logits keep their
    # scale; each weight is quantized as it is drawn, so the dense form of the
    # model (93 GB for Mixtral) never exists.
    model = Transformer.random(args, dtype=torch.bfloat16, seed=0, quant=quant)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    weights_gb = torch.cuda.memory_allocated() / 1e9
    tf.FUSED_DECODE = path.fused
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, args.vocab_size, n).tolist() for n in PROMPT_LENS]

    run = timed_run(generate, model)
    kern.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    gen, lps, ttft_s, total_s, per_greedy = greedy_phase(run, prompts, args.vocab_size,
                                                         launch_counts, repeats)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    diffs = prefill_gap(run, prompts, gen, lps)
    invariant = {"phase": "invariant", "path": label, "max_nats": float(diffs.max()),
                 "mean_nats": float(diffs.mean()), "bound": path.bound}
    if args.moe:
        flips = routing_flips(run, prompts, gen, path.layers)
        # Logprob t comes from the forward of token t - 1 (the first from the
        # prefill in both passes): it is "same-routed" if that step chose the
        # prefill's experts in every layer.
        same = np.concatenate([np.ones((len(prompts), 1), bool), flips[:, :-1] == 0], axis=1)
        invariant.update(
            routings_differing=int(flips.sum()), routings_compared=flips.size * path.layers,
            flip_share_bound=MOE_FLIP_SHARE,
            same_routed_logprobs=int(same.sum()), logprobs=same.size,
            same_routed_max_nats=float(diffs[same].max()),
            same_routed_mean_nats=float(diffs[same].mean()),
            same_routed_bound=(INVARIANT_MAX_NATS, INVARIANT_MEAN_NATS),
            rerouted_max_nats=float(diffs[~same].max()) if (~same).any() else 0.0,
            rerouted_mean_nats=float(diffs[~same].mean()) if (~same).any() else 0.0)
    emit(invariant)
    require(float(diffs.max()) <= path.bound[0] and float(diffs.mean()) <= path.bound[1],
            f"decode != prefill: max {diffs.max()} mean {diffs.mean()} nats")
    if args.moe:
        require(invariant["same_routed_max_nats"] <= INVARIANT_MAX_NATS
                and invariant["same_routed_mean_nats"] <= INVARIANT_MEAN_NATS,
                "decode != prefill on logprobs whose step routed as the prefill did")
        require(flips.sum() <= MOE_FLIP_SHARE * flips.size * path.layers,
                f"{int(flips.sum())} of {flips.size * path.layers} routings differ")

    topp_s = topp_phase(run, prompts)
    launches = launch_counts()
    for name in path.expected:
        require(launches[name] > 0, f"{name} was not launched on the {label} path")
    require(path.fused or launches[K2] == 0,
            "the non-fused decode route launched the fused kernel")
    if path.ring == "fp8":
        for name in (K4, K2, K6, K7):
            require(launches[name + "_fp8"] == launches[name],
                    f"{name} launched another instantiation than fp8 on the {label} path")
    breakdown = profile_generate(model, prompts, generate) if profile else None
    if breakdown is not None and path.ring == "fp8":
        # The same step over an int8 ring, then the fp8 one again, in turns
        # in this call: what the ring's type does to a host-bound step.
        model.args.kv_quant = "int8"
        breakdown["decode_step_int8_ring"] = decode_step_probe(model, len(prompts))
        model.args.kv_quant = "fp8"
        breakdown["decode_step_fp8_again"] = decode_step_probe(model, len(prompts))
    tf.FUSED_DECODE = True

    decode_s = total_s - ttft_s
    return {
        "phase": "main_path", "path": label, "model": path.model, "layers": path.layers,
        "params": tf.param_count(model.params),
        "weights": "bf16 random (seed 0)" + (f", quantized to {quant} (group 128)" if quant else ""),
        "moe": f"{args.moe.num_experts} experts, top-{args.moe.num_experts_per_tok}, "
               f"moe_impl={args.moe_impl}" if args.moe else None,
        "decode_route": "fused (K2)" if path.fused else "update_stacked + decode_attention (K6)",
        "kv_ring": path.ring, "prompt_lens": PROMPT_LENS,
        "chunk_size": CHUNK, "window": args.sliding_window, "init_s": init_s,
        "init_peak_mem_gb": init_peak_gb, "weights_gb": weights_gb,
        "ttft_s": ttft_s,
        "ttft_note": f"median of {repeats} warm generate(max_tokens=1): chunked prefill "
                     "of all prompts plus one step",
        "greedy_total_s": total_s,
        "decode_tokens_per_s": len(PROMPT_LENS) * (GREEDY_TOKENS - 1) / decode_s,
        "decode_note": "B*(32-1) tokens over median generate(32) time less median "
                       f"generate(1) time, medians of {repeats}",
        "peak_mem_gb": peak_gb, "launches": launches,
        "launches_per_greedy_generate": per_greedy,
        "invariant_max_nats": float(diffs.max()), "invariant_mean_nats": float(diffs.mean()),
        "invariant_bound": path.bound,
        "invariant_moe": {k: v for k, v in invariant.items()
                          if k not in ("phase", "path", "max_nats", "mean_nats", "bound")} or None,
        "topp_s": topp_s, "topp_identical": True, "card": card, "profile": breakdown,
    }, launches


# ---------------------------------------------------------------------------
# Phase 4, continued: the speculation paths
# ---------------------------------------------------------------------------


class SpecPath(NamedTuple):
    label: str
    layers: int
    draft: str  # "self" | "small" (an independent 2-layer model) | "lookup"
    K: int  # spec_tokens: a verify chunk is K + 1 tokens
    prompt_lens: Tuple[int, ...]
    fused: bool  # the gate opens: verify through K7; else K4 + K1, scatter_chunk
    ring: str = "int8"  # the KV ring's type: "int8" | "fp8"


# Two bf16 ulps of a logit between 4 and 8: how close the target's two best
# logits must be where the wrap-safe verify route may pick the other one.
NEAR_TIE_GAP = 0.0625
SPEC_PROMPT_LENS = (1537, 700, 45)  # span < 4096: the ring never wraps
REPEATED_BLOCK = 50  # the lookup path's 700-token prompt repeats a block of this length
SPEC_PATHS = (
    SpecPath("spec-self-draft", 32, "self", 4, SPEC_PROMPT_LENS, True),
    SpecPath("spec-small-draft", 8, "small", 4, SPEC_PROMPT_LENS, True),
    SpecPath("lookup", 8, "lookup", 7, SPEC_PROMPT_LENS, True),
    SpecPath("spec-small-draft-wrapping", 8, "small", 4, PROMPT_LENS, False),
    SpecPath("lookup-fp8", 8, "lookup", 7, SPEC_PROMPT_LENS, True, ring="fp8"),
)


class AcceptLog:
    """Records every block's accept counts while it is entered."""

    def __init__(self):
        self.accepts = []  # one (n_iters, B) array per block

    def __enter__(self):
        from mistral_inference_tpu_torch import speculative as sp

        self._sp, self._walk = sp, sp._walk_emits

        def logged(emits, lps, acc, *rest):
            self.accepts.append(acc)
            return self._walk(emits, lps, acc, *rest)

        sp._walk_emits = logged
        return self

    def __exit__(self, *exc):
        self._sp._walk_emits = self._walk

    @property
    def verify_forwards(self) -> int:
        return sum(a.shape[0] for a in self.accepts)


def transformer_carry(model, tokens):
    """The prelogits after a teacher-forced prefill of ``tokens`` (1, V)."""
    from mistral_inference_tpu_torch.generate import prefill_prompts

    cache = model.alloc_cache(1, len(tokens))
    with torch.inference_mode():
        return prefill_prompts(model, [tokens], cache, CHUNK, want_logprobs=False)[1]


def divergences(model, prompts, spec, plain, carry_of=transformer_carry):
    """Where greedy speculation left plain greedy decoding: for each row that
    did, the step, the two tokens, and the target's top-2 logits at that step
    as a teacher-forced prefill of the row's prompt and plain tokens gives
    them (``carry_of(model, tokens)``). ``top2_tokens`` are the tokens whose
    logit is one of the two best values: the best, the second, and every
    token whose bf16 logit equals the second (``topk`` keeps one of equal
    values, whichever it meets first)."""
    found = []
    for row, (a, b) in enumerate(zip(spec, plain)):
        if a == b:
            continue
        step = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        carry = carry_of(model, prompts[row] + b[:step])
        logits = carry[0]
        top = logits.topk(2)
        best = (logits >= top.values[1]).nonzero().flatten()
        best = best[logits[best].argsort(descending=True, stable=True)]
        found.append({"row": row, "step": step, "spec_token": a[step], "plain_token": b[step],
                      "top2_tokens": best.tolist(), "top2_logits": top.values.tolist(),
                      "top2_gap": float(top.values[0] - top.values[1]),
                      "spec_gap": float(top.values[0] - logits[a[step]]),
                      "plain_gap": float(top.values[0] - logits[b[step]])})
    return found


def near_ties(label, diverged) -> None:
    """Each divergence must fall where the reference's best logits nearly
    tie: both tokens within NEAR_TIE_GAP of the best. Where two logits tie
    that is the top-2 rule of the earlier phases; random weights also give
    three-way ties a bf16 ulp apart, where the other rounding picks the
    third."""
    for d in diverged:
        emit({"phase": "divergence", "path": label, **d})
        require(d["spec_gap"] <= NEAR_TIE_GAP and d["plain_gap"] <= NEAR_TIE_GAP,
                f"{label}: a request left its reference away from a near-tie: {d}")


def spec_path(card: str, path: SpecPath):
    """Drive one path of SPEC_PATHS; returns (its summary line, its launch
    counts per greedy speculative generate())."""
    import numpy as np

    from mistral_inference_tpu_torch.generate import generate
    from mistral_inference_tpu_torch.model import Transformer
    from mistral_inference_tpu_torch.models.registry import get_args
    from mistral_inference_tpu_torch.ops import cuda as kern

    def preset(layers, window):
        args = get_args(MODEL)
        args.kv_quant, args.n_layers, args.sliding_window = path.ring, layers, window
        return args

    args = preset(path.layers, WINDOW)
    model = Transformer.random(args, dtype=torch.bfloat16, seed=0, quant="int4")
    if path.draft == "self":
        draft = model
    elif path.draft == "small":
        # A draft whose window is under the span it must hold is refused (its
        # rewind needs a ring that never wraps): on the wrapping path the
        # draft is made without a window.
        draft = Transformer.random(preset(2, WINDOW if path.fused else None),
                                   dtype=torch.bfloat16, seed=1, quant="int4")
    else:
        draft = "lookup"
    torch.cuda.synchronize()
    weights_gb = torch.cuda.memory_allocated() / 1e9
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, args.vocab_size, n).tolist() for n in path.prompt_lens]
    if path.draft == "lookup":
        block = prompts[1][:REPEATED_BLOCK]
        prompts[1] = (block * (len(prompts[1]) // REPEATED_BLOCK + 1))[:len(prompts[1])]
    B = len(prompts)
    spec = timed_run(generate, model, draft_model=draft, spec_tokens=path.K)
    plain_run = timed_run(generate, model)

    kern.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    spec(prompts, max_tokens=2, temperature=0.0)  # first-call set-up
    before = launch_counts()
    with AcceptLog() as log:
        (gen, lps), spec_s = spec(prompts, max_tokens=GREEDY_TOKENS, temperature=0.0)
    per_greedy = {k: n - before[k] for k, n in launch_counts().items()}
    forwards = log.verify_forwards
    accepts = np.concatenate(log.accepts)  # (iterations, B)
    (again, _), t = spec(prompts, max_tokens=GREEDY_TOKENS, temperature=0.0)
    require(again == gen, f"{path.label}: greedy tokens differ between two runs")
    spec_s = min(spec_s, t)
    spec1_s = min(spec(prompts, max_tokens=1, temperature=0.0)[1] for _ in range(2))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    lens = path.prompt_lens
    require(all(len(g) == GREEDY_TOKENS for g in gen), "wrong number of generated tokens")
    require(all(len(lp) == n - 1 + GREEDY_TOKENS for lp, n in zip(lps, lens)),
            "wrong number of logprobs")
    require(all(math.isfinite(x) for lp in lps for x in lp), "non-finite logprob")
    want = path.layers * forwards if path.fused else 0
    require(per_greedy[K7] == want,
            f"{path.label}: K7 launched {per_greedy[K7]} times, expected {want} "
            f"({path.layers} layers x {forwards} verify forwards)")
    expected = [K1, K4, K5, K3] + ([K7] if path.fused else []) + (
        [] if path.draft == "lookup" else [K2])
    for name in expected:
        require(per_greedy[name] > 0, f"{name} was not launched on the {path.label} path")
    if path.ring == "fp8":
        for name in (K4, K2, K6, K7):
            require(per_greedy[name + "_fp8"] == per_greedy[name],
                    f"{name} launched another instantiation than fp8 on the {path.label} path")

    # Plain greedy generate() on the same model, in the same call.
    (plain, plain_lps), plain_s = plain_run(prompts, max_tokens=GREEDY_TOKENS, temperature=0.0)
    plain_s = min(plain_s, plain_run(prompts, max_tokens=GREEDY_TOKENS, temperature=0.0)[1])
    plain1_s = min(plain_run(prompts, max_tokens=1, temperature=0.0)[1] for _ in range(2))
    diverged = divergences(model, prompts, gen, plain)
    for d in diverged:
        emit({"phase": "divergence", "path": path.label, **d})
    if path.fused:
        # Every operation of the verify forward gives a row the bits a decode
        # step gives it (row_count_probe, check_k7): the tokens are equal.
        require(not diverged,
                f"{path.label}: greedy speculation left plain greedy generate(): {diverged}")
    else:
        # The no-write verify attends through K4 + K1 + merge (tensor cores,
        # the chunk's K/V not yet in the ring) where a decode step attends
        # through K2: the same function, other sums, as prefill against
        # decode. Its logits differ in their last bf16 bit, so it may leave
        # plain greedy, but only at a step where the target's two best logits
        # nearly tie, and only for the other of the two.
        for d in diverged:
            require(d["top2_gap"] <= NEAR_TIE_GAP and d["spec_token"] in d["top2_tokens"]
                    and d["plain_token"] in d["top2_tokens"],
                    f"{path.label}: greedy speculation left plain greedy generate() away "
                    f"from a near-tie: {d}")
    same = {d["row"]: d["step"] for d in diverged}
    lp_gap = max(abs(a - b) for i, (x, y) in enumerate(zip(lps, plain_lps))
                 for a, b in list(zip(x, y))[:len(x) - GREEDY_TOKENS + same.get(i, GREEDY_TOKENS)])

    # The emitted logprobs against a teacher-forced prefill of prompt + output.
    diffs = prefill_gap(plain_run, prompts, gen, lps)
    require(float(diffs.max()) <= INVARIANT_MAX_NATS and float(diffs.mean()) <= INVARIANT_MEAN_NATS,
            f"{path.label}: speculation != prefill: max {diffs.max()} mean {diffs.mean()} nats")
    topp_s = topp_phase(spec, prompts)
    launches = launch_counts()
    require(path.fused or launches[K7] == 0, "the wrap-safe route launched the fused verify kernel")

    emitted = B * (GREEDY_TOKENS - 1)  # the first token comes from the prefill
    return {
        "phase": "spec_path", "path": path.label, "model": MODEL, "layers": path.layers,
        "weights": "bf16 random (seed 0), quantized to int4 (group 128)",
        "draft": {"self": "the target itself", "lookup": "prompt lookup (n-gram 2)",
                  "small": "2 layers of the same widths (seed 1, int4)"}[path.draft],
        "spec_tokens": path.K, "verify_route": "fused (K7)" if path.fused
        else "no-write verify (K4 + K1) + scatter_chunk", "kv_ring": path.ring,
        "prompt_lens": lens, "chunk_size": CHUNK, "window": WINDOW, "weights_gb": weights_gb,
        "verify_forwards": forwards,
        "mean_accepted_drafts": float(accepts.mean()),
        "accepted_drafts_by_row": accepts.mean(axis=0).tolist(),
        "target_forwards_per_emitted_token": forwards * B / emitted,
        "forwards_note": f"{forwards} verify forwards of {B} rows for {emitted} tokens after "
                         "the first; a block runs 8 iterations, so rows that are done ride along",
        "tokens_equal_plain_greedy": not diverged, "divergences_at_near_ties": diverged,
        "near_tie_gap": None if path.fused else NEAR_TIE_GAP,
        "max_logprob_gap_to_plain_greedy": lp_gap,
        "logprob_gap_note": "over the prompt and the tokens up to a row's first divergence",
        "spec_greedy_s": spec_s, "spec_first_token_s": spec1_s,
        "spec_tokens_per_s": emitted / (spec_s - spec1_s),
        "plain_greedy_s": plain_s, "plain_first_token_s": plain1_s,
        "plain_tokens_per_s": emitted / (plain_s - plain1_s),
        "timing_note": "each the faster of 2 warm calls; tokens/s is B*(32-1) over generate(32) "
                       "less generate(1), which holds the prefills (the draft's too)",
        "invariant_max_nats": float(diffs.max()), "invariant_mean_nats": float(diffs.mean()),
        "invariant_bound": (INVARIANT_MAX_NATS, INVARIANT_MEAN_NATS),
        "peak_mem_gb": peak_gb, "launches": launches,
        "launches_per_greedy_generate": per_greedy,
        "topp_s": topp_s, "topp_identical": True, "card": card,
    }, per_greedy


# ---------------------------------------------------------------------------
# Phase 6: the Mamba2 paths
# ---------------------------------------------------------------------------

MAMBA_MODEL = "codestral-mamba-7b"


class MambaPath(NamedTuple):
    label: str
    layers: int
    quant: Optional[str]  # weight quantization
    bf16_state: bool  # the SSD state stored in bf16, else fp32
    expected: Tuple[str, ...]  # kernels the path must launch
    bound: Tuple[float, float] = (INVARIANT_MAX_NATS, INVARIANT_MEAN_NATS)


# The full model in bf16 is the path that counts; the int4 path with a bf16
# state is cut in depth, never in width. A bf16 state rounds once per token in
# decode and once per 512-token chunk in prefill, so decode and prefill store
# different roundings of one fp32 state. Measured on that path: 0.0626 max /
# 0.0120 mean nats, the same in every run (greedy tokens repeat), well inside
# the dense bound, which it therefore keeps.
MAMBA_PATHS = (
    MambaPath("mamba-bf16", 64, None, False, (K9,)),
    MambaPath("mamba-int4-bf16-state", 8, "int4", True, (K9, K3, K5)),
)
MAMBA_LOOKUP_LAYERS = 8
MAMBA_LOOKUP_K = 7


def mamba_model(layers: int, quant: Optional[str], bf16_state: bool):
    from mistral_inference_tpu_torch.model import Mamba
    from mistral_inference_tpu_torch.models.registry import get_args

    args = get_args(MAMBA_MODEL)
    args.n_layers = layers
    return Mamba.random(args, dtype=torch.bfloat16, seed=0, quant=quant,
                        ssm_dtype=torch.bfloat16 if bf16_state else torch.float32)


def mamba_path(card: str, profile: bool, path: MambaPath):
    """Drive one path of MAMBA_PATHS through ``generate_mamba``: the greedy
    repeat, K9's launches (layers x decode forwards), decode == prefill,
    top-p per seed. Returns (its summary line, its launch counts)."""
    import numpy as np

    from mistral_inference_tpu_torch.generate import generate_mamba
    from mistral_inference_tpu_torch.models import transformer as tf
    from mistral_inference_tpu_torch.ops import cuda as kern

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = mamba_model(path.layers, path.quant, path.bf16_state)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    weights_gb = torch.cuda.memory_allocated() / 1e9
    args = model.args
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, args.vocab_size, n).tolist() for n in PROMPT_LENS]
    run = timed_run(generate_mamba, model)

    kern.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    gen, lps, ttft_s, total_s, per_greedy = greedy_phase(run, prompts, args.vocab_size,
                                                         launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = path.layers * GREEDY_TOKENS
    require(per_greedy[K9] == want,
            f"{path.label}: K9 launched {per_greedy[K9]} times in a greedy generate_mamba, "
            f"expected {want} ({path.layers} layers x {GREEDY_TOKENS} decode forwards)")
    diffs = prefill_gap(run, prompts, gen, lps)
    emit({"phase": "invariant", "path": path.label, "max_nats": float(diffs.max()),
          "mean_nats": float(diffs.mean()), "bound": path.bound})
    require(float(diffs.max()) <= path.bound[0] and float(diffs.mean()) <= path.bound[1],
            f"{path.label}: decode != prefill: max {diffs.max()} mean {diffs.mean()} nats")
    topp_s = topp_phase(run, prompts)
    launches = launch_counts()
    for name in path.expected:
        require(launches[name] > 0, f"{name} was not launched on the {path.label} path")
    breakdown = profile_generate(model, prompts, generate_mamba) if profile else None

    decode_s = total_s - ttft_s
    return {
        "phase": "mamba_path", "path": path.label, "model": MAMBA_MODEL, "layers": path.layers,
        "params": tf.param_count(model.params),
        "weights": "bf16 random (seed 0)" + (f", quantized to {path.quant} (group 128)"
                                              if path.quant else ""),
        "ssm_state": "bf16" if path.bf16_state else "fp32",
        "prompt_lens": PROMPT_LENS, "chunk_size": CHUNK, "ssd_chunk": min(128, CHUNK),
        "init_s": init_s, "init_peak_mem_gb": init_peak_gb, "weights_gb": weights_gb,
        "ttft_s": ttft_s,
        "ttft_note": "median of 3 warm generate_mamba(max_tokens=1): chunked prefill of all "
                     "prompts plus one step",
        "greedy_total_s": total_s,
        "decode_tokens_per_s": len(PROMPT_LENS) * (GREEDY_TOKENS - 1) / decode_s,
        "decode_note": "B*(32-1) tokens over median generate_mamba(32) time less median "
                       "generate_mamba(1) time, medians of 3",
        "peak_mem_gb": peak_gb, "launches": launches,
        "launches_per_greedy_generate": per_greedy,
        "invariant_max_nats": float(diffs.max()), "invariant_mean_nats": float(diffs.mean()),
        "invariant_bound": path.bound,
        "topp_s": topp_s, "topp_identical": True, "card": card, "profile": breakdown,
    }, launches


def mamba_carry(model, tokens):
    from mistral_inference_tpu_torch.generate import prefill_mamba

    with torch.inference_mode():
        return prefill_mamba(model, [tokens], CHUNK)[1]


def mamba_lookup_path(card: str):
    """``generate_mamba(draft_model="lookup")`` on the int4 Codestral-Mamba
    cut to MAMBA_LOOKUP_LAYERS, beside plain greedy ``generate_mamba`` on the
    same model. Its verify and commit forwards take T = K + 1 through the
    chunked SSD, so K9 must read 0 on the speculative call, and K3 runs at
    B x (K + 1) rows. Plain decoding goes through K9, so the tokens may leave
    plain greedy only at a near-tie. Returns (its summary line, the launches
    of one greedy speculative call)."""
    import numpy as np

    from mistral_inference_tpu_torch.generate import generate_mamba

    model = mamba_model(MAMBA_LOOKUP_LAYERS, "int4", False)
    torch.cuda.synchronize()
    weights_gb = torch.cuda.memory_allocated() / 1e9
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, model.args.vocab_size, n).tolist() for n in SPEC_PROMPT_LENS]
    block = prompts[1][:REPEATED_BLOCK]
    prompts[1] = (block * (len(prompts[1]) // REPEATED_BLOCK + 1))[:len(prompts[1])]
    B = len(prompts)
    spec = timed_run(generate_mamba, model, draft_model="lookup", spec_tokens=MAMBA_LOOKUP_K)
    plain_run = timed_run(generate_mamba, model)

    spec(prompts, max_tokens=2, temperature=0.0)  # first-call set-up
    before = launch_counts()
    with AcceptLog() as log:
        (gen, lps), spec_s = spec(prompts, max_tokens=GREEDY_TOKENS, temperature=0.0)
    per_greedy = {k: n - before[k] for k, n in launch_counts().items()}
    forwards = log.verify_forwards
    accepts = np.concatenate(log.accepts)
    (again, _), t = spec(prompts, max_tokens=GREEDY_TOKENS, temperature=0.0)
    require(again == gen, "mamba-lookup: greedy tokens differ between two runs")
    spec_s = min(spec_s, t)
    spec1_s = min(spec(prompts, max_tokens=1, temperature=0.0)[1] for _ in range(2))
    require(all(len(g) == GREEDY_TOKENS for g in gen), "wrong number of generated tokens")
    require(all(len(lp) == n - 1 + GREEDY_TOKENS for lp, n in zip(lps, SPEC_PROMPT_LENS)),
            "wrong number of logprobs")
    require(all(math.isfinite(x) for lp in lps for x in lp), "non-finite logprob")
    require(per_greedy[K9] == 0, f"mamba-lookup: K9 launched {per_greedy[K9]} times, expected 0")
    for name in (K3, K5):
        require(per_greedy[name] > 0, f"{name} was not launched on the mamba-lookup path")

    (plain, plain_lps), plain_s = plain_run(prompts, max_tokens=GREEDY_TOKENS, temperature=0.0)
    plain_s = min(plain_s, plain_run(prompts, max_tokens=GREEDY_TOKENS, temperature=0.0)[1])
    plain1_s = min(plain_run(prompts, max_tokens=1, temperature=0.0)[1] for _ in range(2))
    diverged = divergences(model, prompts, gen, plain, mamba_carry)
    for d in diverged:
        emit({"phase": "divergence", "path": "mamba-lookup", **d})
        # Verify and commit run the chunked SSD over K + 1 tokens where a
        # decode step runs K9: other fp32 sums, so the logits may differ in
        # their last bf16 bit. A row may leave plain greedy only where its two
        # best logits nearly tie, and only for the other of the two.
        require(d["top2_gap"] <= NEAR_TIE_GAP and d["spec_token"] in d["top2_tokens"]
                and d["plain_token"] in d["top2_tokens"],
                f"mamba-lookup: greedy speculation left plain greedy away from a near-tie: {d}")
    same = {d["row"]: d["step"] for d in diverged}
    lp_gap = max(abs(a - b) for i, (x, y) in enumerate(zip(lps, plain_lps))
                 for a, b in list(zip(x, y))[:len(x) - GREEDY_TOKENS + same.get(i, GREEDY_TOKENS)])
    diffs = prefill_gap(plain_run, prompts, gen, lps)
    require(float(diffs.max()) <= INVARIANT_MAX_NATS and float(diffs.mean()) <= INVARIANT_MEAN_NATS,
            f"mamba-lookup: speculation != prefill: max {diffs.max()} mean {diffs.mean()} nats")
    topp_s = topp_phase(spec, prompts)

    emitted = B * (GREEDY_TOKENS - 1)  # the first token comes from the prefill
    return {
        "phase": "mamba_lookup_path", "path": "mamba-lookup", "model": MAMBA_MODEL,
        "layers": MAMBA_LOOKUP_LAYERS,
        "weights": "bf16 random (seed 0), quantized to int4 (group 128)", "ssm_state": "fp32",
        "draft": "prompt lookup (n-gram 2)", "spec_tokens": MAMBA_LOOKUP_K,
        "prompt_lens": SPEC_PROMPT_LENS, "chunk_size": CHUNK, "weights_gb": weights_gb,
        "verify_forwards": forwards, "mean_accepted_drafts": float(accepts.mean()),
        "accepted_drafts_by_row": accepts.mean(axis=0).tolist(),
        "forwards_per_emitted_token": 2 * forwards * B / emitted,
        "forwards_note": f"{forwards} verify and {forwards} commit forwards of {B} rows for "
                         f"{emitted} tokens after the first",
        "tokens_equal_plain_greedy": not diverged, "divergences_at_near_ties": diverged,
        "near_tie_gap": NEAR_TIE_GAP, "max_logprob_gap_to_plain_greedy": lp_gap,
        "spec_greedy_s": spec_s, "spec_first_token_s": spec1_s,
        "spec_tokens_per_s": emitted / (spec_s - spec1_s),
        "plain_greedy_s": plain_s, "plain_first_token_s": plain1_s,
        "plain_tokens_per_s": emitted / (plain_s - plain1_s),
        "timing_note": "each the faster of 2 warm calls; tokens/s is B*(32-1) over "
                       "generate_mamba(32) less generate_mamba(1)",
        "invariant_max_nats": float(diffs.max()), "invariant_mean_nats": float(diffs.mean()),
        "invariant_bound": (INVARIANT_MAX_NATS, INVARIANT_MEAN_NATS),
        "launches_per_greedy_generate": per_greedy, "topp_s": topp_s, "topp_identical": True,
        "card": card,
    }, per_greedy


# ---------------------------------------------------------------------------
# Phase 7: the multimodal path
# ---------------------------------------------------------------------------

PIXTRAL_MODEL = "pixtral-12b"
K10 = "segment_flash_attention"
# Pixtral's tekken has [IMG] = 10, [IMG_BREAK] = 12, [IMG_END] = 13.
IMG_SPECIALS = {"[IMG]": 10, "[IMG_BREAK]": 12, "[IMG_END]": 13}
# Each row: text runs (a token count) and images ((H, W) pixels), in order.
PIXTRAL_ROWS = (
    (12, (1024, 1024), 40),                    # 4096 patches, N = 4096 -> 4160 tokens
    (8, (512, 768), 8, (384, 336), 20),        # 1536 patches -> 1568; 504, N = 512 -> 528
    ((256, 256), 30),                          # 256 patches, N = 256 -> 272
    (45,),                                     # text only
)
PIXTRAL_PROMPT_LENS = (4212, 2132, 302, 45)


class ImageTokens:
    """The token ids ``images.image_token_layout`` needs: a tokenizer's
    ``special`` for Pixtral's three image ids, without a vocabulary."""

    @staticmethod
    def special(name: str) -> int:
        return IMG_SPECIALS[name]


def pixtral_prompts(vargs, vocab_size: int, rng):
    """PIXTRAL_ROWS as token ids laid out by ``image_token_layout``, with
    random text ids clear of the special ids, and random preprocessed
    (3, H, W) float32 images (preprocessing is host code the CPU tests hold)."""
    import numpy as np

    from mistral_inference_tpu_torch.images import image_token_layout

    prompts, images = [], []
    for row in PIXTRAL_ROWS:
        ids, ims = [], []
        for part in row:
            if isinstance(part, int):
                ids += rng.integers(16, vocab_size, part).tolist()
            else:
                ims.append(rng.standard_normal((3, *part)).astype(np.float32))
                ids += image_token_layout(*part, vargs, ImageTokens)
        prompts.append(ids)
        images.append(ims)
    require(tuple(len(p) for p in prompts) == PIXTRAL_PROMPT_LENS, "wrong Pixtral prompt lengths")
    return prompts, images


def pixtral_path(card: str, profile: bool):
    """``generate(images=...)`` on ``pixtral-12b`` at full width and depth
    (40 decoder layers, 24 encoder layers), random bf16 weights from seed 0,
    an int8 ring (no window: it holds the whole context) and chunk 512, over
    PIXTRAL_ROWS. Returns (its summary line, its launch counts, the model,
    which the front door's image request reuses)."""
    import numpy as np

    from mistral_inference_tpu_torch.generate import generate
    from mistral_inference_tpu_torch.model import Transformer
    from mistral_inference_tpu_torch.models import transformer as tf
    from mistral_inference_tpu_torch.models.registry import get_args
    from mistral_inference_tpu_torch.models.vision import image_features
    from mistral_inference_tpu_torch.ops import cuda as kern

    args = get_args(PIXTRAL_MODEL)
    args.kv_quant = "int8"
    vargs = args.vision_encoder
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Transformer.random(args, dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = torch.cuda.memory_allocated() / 1e9
    vision_params = tf.param_count(model.params["vision"])
    prompts, images = pixtral_prompts(vargs, args.vocab_size, np.random.default_rng(0))
    n_images = sum(len(ims) for ims in images)
    run = timed_run(generate, model, images=images)

    kern.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    gen, lps, ttft_s, total_s, per_greedy = greedy_phase(run, prompts, args.vocab_size,
                                                         launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = vargs.num_hidden_layers * n_images
    require(per_greedy[K10] == want,
            f"pixtral: K10 launched {per_greedy[K10]} times in a greedy generate(), expected "
            f"{want} ({vargs.num_hidden_layers} encoder layers x {n_images} images)")
    diffs = prefill_gap(run, prompts, gen, lps)
    bound_ = (INVARIANT_MAX_NATS, INVARIANT_MEAN_NATS)
    emit({"phase": "invariant", "path": "pixtral", "max_nats": float(diffs.max()),
          "mean_nats": float(diffs.mean()), "bound": bound_})
    require(float(diffs.max()) <= bound_[0] and float(diffs.mean()) <= bound_[1],
            f"pixtral: decode != prefill: max {diffs.max()} mean {diffs.mean()} nats")
    topp_s = topp_phase(run, prompts)
    launches = launch_counts()
    for name in (K10, K1, K4, K2):
        require(launches[name] > 0, f"{name} was not launched on the pixtral path")
    try:
        generate(prompts, model, images=images, max_tokens=2, temperature=0.0,
                 draft_model="lookup")
        refused = False
    except ValueError:
        refused = True
    require(refused, "pixtral: speculation with images was not refused")

    # The vision encoder's share of TTFT: image_features for the four images,
    # one call each as embed_multimodal makes them, median of 3.
    def encode_all():
        for ims in images:
            if ims:
                image_features(model.params["vision"], vargs, ims, model.dtype)

    encode_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        encode_all()
        torch.cuda.synchronize()
        encode_s.append(time.perf_counter() - t)
    big = [images[0][0]]
    big_ms = timed_ms(lambda: image_features(model.params["vision"], vargs, big, model.dtype),
                      reps=5)
    breakdown = pixtral_profile(model, prompts, images, encode_all) if profile else None

    decode_s = total_s - ttft_s
    return {
        "phase": "pixtral_path", "path": "pixtral", "model": PIXTRAL_MODEL,
        "layers": args.n_layers, "encoder_layers": vargs.num_hidden_layers,
        "params": tf.param_count(model.params), "vision_params": vision_params,
        "weights": "bf16 random (seed 0), decoder and vision encoder",
        "kv_ring": "int8", "window": None, "chunk_size": CHUNK,
        "prompt_lens": PIXTRAL_PROMPT_LENS,
        "images": [[list(im.shape[1:]) for im in ims] for ims in images],
        "init_s": init_s, "weights_gb": weights_gb, "ttft_s": ttft_s,
        "ttft_note": "median of 3 warm generate(max_tokens=1): the four images through the "
                     "encoder, then chunked prefill of all prompts plus one step",
        "vision_encode_s": statistics.median(encode_s),
        "vision_share_of_ttft": statistics.median(encode_s) / ttft_s,
        "vision_note": "image_features for the four images, host clock between "
                       "synchronizations, median of 3",
        "image_1024x1024_ms": big_ms,
        "greedy_total_s": total_s,
        "decode_tokens_per_s": len(prompts) * (GREEDY_TOKENS - 1) / decode_s,
        "decode_note": "B*(32-1) tokens over median generate(32) time less median "
                       "generate(1) time, medians of 3",
        "peak_mem_gb": peak_gb, "launches": launches,
        "launches_per_greedy_generate": per_greedy,
        "invariant_max_nats": float(diffs.max()), "invariant_mean_nats": float(diffs.mean()),
        "invariant_bound": bound_, "speculation_with_images_refused": refused,
        "topp_s": topp_s, "topp_identical": True, "card": card, "profile": breakdown,
    }, launches, model


def pixtral_profile(model, prompts, images, encode_all):
    """Kernel time of the multimodal prefill (``generate(max_tokens=0)``)
    and of the encoder alone (``encode_all``) under torch.profiler; the
    decoder's linears are the prefill's cuBLAS time less the encoder's."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from mistral_inference_tpu_torch.generate import generate

    def prof(fn):
        fn()
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CUDA]) as p:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t)
        return wall, kernel_ms(p)

    wall, (busy, cats, top) = prof(lambda: generate(
        prompts, model, images=images, chunk_size=CHUNK, temperature=0.0, max_tokens=0))
    enc_wall, (enc_busy, enc_cats, _) = prof(encode_all)
    k10 = cats.get("K10 segment flash", 0.0)
    k1_k4 = cats.get("K1 flash_hopper", 0.0) + cats.get("K4 flash_hopper", 0.0)
    return {
        "prefill_all_prompts": {
            "wall_ms": wall, "kernel_ms": busy, "device_idle_share": 1.0 - busy / wall,
            "encoder_linears_ms": enc_cats.get("matmul", 0.0), "K10_ms": k10,
            "decoder_linears_ms": cats.get("matmul", 0.0) - enc_cats.get("matmul", 0.0),
            "K1_K4_ms": k1_k4, "K4_ms": cats.get("K4 flash_hopper", 0.0),
            "K1_ms": cats.get("K1 flash_hopper", 0.0),
            "other_ms": busy - cats.get("matmul", 0.0) - k10 - k1_k4,
            "kernel_ms_by_category": cats,
            "top_kernels_ms": [[round(ms, 3), k] for ms, k in top[:12]],
        },
        "encoder_four_images": {"wall_ms": enc_wall, "kernel_ms": enc_busy,
                                "device_idle_share": 1.0 - enc_busy / enc_wall,
                                "kernel_ms_by_category": enc_cats},
        "decode_step": decode_step_probe(model, len(prompts)),
    }


# ---------------------------------------------------------------------------
# Phase 8: serving
# ---------------------------------------------------------------------------

SERVING_B, SERVING_MAX_SEQ, SERVING_CHUNK = 8, 4608, 512
SERVING_REQUESTS, SERVING_FIRST = 24, 16  # 16 submitted at the start, 8 after step 4
SERVING_LATE_STEP = 4
SERVING_CANCEL_STEP = 12
SHARED_PREFIX = 1024


def serving_requests(vocab_size: int):
    """The 24 requests, from seed 0: prompt lengths drawn from PROMPT_LENS;
    8 share a 1024-token prefix (those draw from 4300 and 1537, the lengths
    that hold it, and the first request is one of them at 1537, so a source
    that never wraps is resident from the first sweep); max_tokens 32-128; 4
    sample at T = 0.7, p = 0.9, the rest are greedy; one greedy request is
    cancelled mid-run, one carries a stop id and one asks for logprobs."""
    import numpy as np

    rng = np.random.default_rng(0)
    n = SERVING_REQUESTS
    lens = rng.choice(PROMPT_LENS, n).tolist()
    shared = [0] + sorted(rng.choice(np.arange(1, n), 7, replace=False).tolist())
    for i in shared:
        lens[i] = int(rng.choice(PROMPT_LENS[:2]))
    lens[0] = PROMPT_LENS[1]
    prefix = rng.integers(1, vocab_size, SHARED_PREFIX).tolist()
    prompts = [rng.integers(1, vocab_size, m).tolist() for m in lens]
    for i in shared:
        prompts[i][:SHARED_PREFIX] = prefix
    max_tokens = rng.integers(32, 129, n).tolist()
    others = [i for i in range(1, n) if i not in shared]
    sampled = sorted(rng.choice(others, 4, replace=False).tolist())
    greedy_others = [i for i in others if i not in sampled]
    # The cancelled request is in the first sweep (the first 8 submitted) and
    # long enough to be live when it is cancelled; the first request, the
    # prefix source, lives as long as any.
    cancel = min(greedy_others)
    stop, logprobs = greedy_others[1], greedy_others[2]
    max_tokens[cancel] = max_tokens[0] = 128
    return prompts, max_tokens, set(shared), set(sampled), cancel, stop, logprobs


def serving_phase(card: str, profile: bool, resident: int = 0):
    """The continuous-batching ``Engine`` on the north-star model
    (``mistral-7b-v0.1``, int4 weights, an fp8 ring, all 32 layers):
    Engine(batch_size=8, max_seq_len=4608, admit_chunk=512) serving the 24
    requests of ``serving_requests``, driven step by step. Checks each greedy
    request against ``generate([prompt])`` alone on the same model (a
    request may leave it only at a near-tie of the two best logits, for the
    other of the two), the prefix hits, that no row writes past prompt +
    max_tokens, and K2-fp8's launches against the decode forwards; reports
    requests/s, output tokens/s, TTFT p50 / p99, admission's share of the
    wall time and peak memory, less ``resident`` bytes that other phases
    hold. Returns its summary line."""
    from mistral_inference_tpu_torch.generate import generate
    from mistral_inference_tpu_torch.model import Transformer
    from mistral_inference_tpu_torch.models.registry import get_args
    from mistral_inference_tpu_torch.ops import cuda as kern
    from mistral_inference_tpu_torch.server.engine import Engine
    from mistral_inference_tpu_torch.utils.profiling import METRICS

    args = get_args(MODEL)
    args.kv_quant, args.sliding_window = "fp8", WINDOW
    model = Transformer.random(args, dtype=torch.bfloat16, seed=0, quant="int4")
    prompts, max_tokens, shared, sampled, cancel, stop, want_lp = serving_requests(args.vocab_size)
    n = len(prompts)
    greedy = [i for i in range(n) if i not in sampled]

    # The references first: each greedy request alone. The stop id is the
    # first token of the stop request's reference, after its first 8, that
    # has not come before.
    t_ref = time.perf_counter()
    ref, ref_lps = {}, {}
    for i in greedy:
        g, lp = generate([prompts[i]], model, max_tokens=max_tokens[i], temperature=0.0,
                         chunk_size=SERVING_CHUNK)
        ref[i], ref_lps[i] = g[0], lp[0]
    ref_s = time.perf_counter() - t_ref
    stop_at = next(t for t in range(8, len(ref[stop])) if ref[stop][t] not in ref[stop][:t])
    stop_id = ref[stop][stop_at]

    # Count the decode forwards (T = 1) the engine runs.
    forward, decode_forwards = model.forward, [0]

    def counting_forward(tokens, *a, **kw):
        if tokens.shape[1] == 1:
            decode_forwards[0] += 1
        return forward(tokens, *a, **kw)

    model.forward = counting_forward
    METRICS.__init__()
    kern.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(model, batch_size=SERVING_B, max_seq_len=SERVING_MAX_SEQ,
                 admit_chunk=SERVING_CHUNK)
    # No row writes past prompt + max_tokens: a row's fill is read when its
    # slot goes to a new request (admission has waited for the card by then)
    # and for the rows resident at the end.
    occupant, overshoot = [None] * SERVING_B, []
    plan = eng._plan_prefix_reuse

    def checked_plan(new):
        kv = eng.cache.kv_len.cpu().tolist()
        for slot, _ in new:
            r = occupant[slot]
            if r is not None and kv[slot] > len(r.prompt) + r.max_tokens:
                overshoot.append((r.request_id, kv[slot], len(r.prompt) + r.max_tokens))
        return plan(new)

    eng._plan_prefix_reuse = checked_plan
    reqs, rid = {}, {}

    def submit(i):
        rid[i] = eng.submit(prompts[i], max_tokens=max_tokens[i],
                            temperature=0.7 if i in sampled else 0.0,
                            top_p=0.9 if i in sampled else None,
                            stop_ids=[stop_id] if i == stop else (),
                            want_logprobs=i == want_lp)
        reqs[i] = eng.queue[-1]  # the engine's own record, updated as it runs

    t0 = time.perf_counter()
    for i in range(SERVING_FIRST):
        submit(i)
    steps, eligible = 0, 0
    while eng.has_work or steps < SERVING_LATE_STEP:
        live_before = {r.request_id for r in eng.slots if r is not None and not r.done}
        eng.step()
        steps += 1
        live_after = {r.request_id for r in eng.slots if r is not None and not r.done}
        for slot, r in enumerate(eng.slots):
            if r is not None and r is not occupant[slot]:
                # Admitted in this step: a shared-prefix request that wants no
                # logprobs, with a shared-prefix source live across the step,
                # must have copied its prefix.
                i = next(k for k in reqs if reqs[k] is r)
                # A source's ring must never wrap: prompt + max_tokens within the window.
                sources = {rid[j] for j in shared if j in rid and j != i
                           and len(prompts[j]) + max_tokens[j] <= WINDOW}
                if i in shared and not r.want_logprobs and sources & live_before & live_after:
                    eligible += 1
            occupant[slot] = r
        if steps == SERVING_LATE_STEP:
            for i in range(SERVING_FIRST, n):
                submit(i)
        if steps == SERVING_CANCEL_STEP:
            require(any(r is reqs[cancel] and not r.done for r in eng.slots),
                    "the request to cancel is not live")
            eng.cancel(rid[cancel])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = (torch.cuda.max_memory_allocated() - resident) / 1e9
    model.forward = forward
    launches = launch_counts()
    kv = eng.cache.kv_len.cpu().tolist()
    for slot, r in enumerate(eng.slots):
        if r is not None and kv[slot] > len(r.prompt) + r.max_tokens:
            overshoot.append((r.request_id, kv[slot], len(r.prompt) + r.max_tokens))
    require(not overshoot, f"rows wrote past prompt + max_tokens: {overshoot}")

    # Each greedy request against its reference; the cancelled one as far as
    # it went; the stop request up to and with its stop token, which ended it
    # and was not appended.
    out = {i: reqs[i].generated for i in range(n)}
    got = dict(out)
    if len(out[stop]) < max_tokens[stop]:
        got[stop] = out[stop] + [stop_id]
    want = {i: ref[i][:len(out[i])] if i == cancel else ref[i] for i in greedy}
    want[stop] = ref[stop][:stop_at + 1]
    diverged = divergences(model, [prompts[i] for i in greedy], [got[i] for i in greedy],
                           [want[i] for i in greedy])
    for d in diverged:
        d["request"] = greedy[d.pop("row")]
        emit({"phase": "divergence", "path": "serving", **d})
        require(d["top2_gap"] <= NEAR_TIE_GAP and d["spec_token"] in d["top2_tokens"]
                and d["plain_token"] in d["top2_tokens"],
                f"serving: a request left generate() alone away from a near-tie: {d}")
    differ_at = {d["request"] for d in diverged}
    for i in greedy:
        if i not in differ_at:
            require(got[i] == want[i], f"serving: request {i} has {len(got[i])} tokens, "
                                       f"generate() alone {len(want[i])}")
    require(reqs[cancel].done and 0 < len(out[cancel]) < max_tokens[cancel],
            "the cancelled request did not stop early")
    for i in sampled:
        require(len(out[i]) == max_tokens[i] and all(0 <= t < args.vocab_size for t in out[i]),
                f"sampled request {i}: wrong tokens")
    r = reqs[want_lp]
    require(len(r.prompt_logprobs) == len(prompts[want_lp]) - 1
            and len(r.gen_logprobs) == len(out[want_lp])
            and all(math.isfinite(x) for x in r.prompt_logprobs + r.gen_logprobs),
            "the logprob request's logprobs are wrong in number or not finite")
    lp_gap = max(abs(a - b) for a, b in zip(r.prompt_logprobs, ref_lps[want_lp]))
    require(lp_gap <= INVARIANT_MAX_NATS,
            f"the logprob request's prompt logprobs are {lp_gap} nats from generate()'s")
    require(all(r.error is None for r in reqs.values()), "a request failed")
    hits = METRICS.counters.get("prefix_hits", 0)
    require(hits >= eligible, f"{hits} prefix hits for {eligible} eligible admissions")
    layers = args.n_layers
    require(launches[K2F] == launches[K2] == layers * decode_forwards[0],
            f"K2-fp8 launched {launches[K2F]} times for {decode_forwards[0]} decode forwards "
            f"of {layers} layers")
    for name in (K1, K4F, K3, K5):
        require(launches[name] > 0, f"{name} was not launched on the serving path")

    tokens_out = sum(len(o) for o in out.values())
    admission_s = sum(METRICS.samples["admission_prefill_s"])
    summary = {
        "phase": "serving", "model": MODEL, "layers": layers, "card": card,
        "weights": "bf16 random (seed 0), quantized to int4 (group 128)", "kv_ring": "fp8",
        "engine": f"Engine(batch_size={SERVING_B}, max_seq_len={SERVING_MAX_SEQ}, "
                  f"admit_chunk={SERVING_CHUNK}), pipelined, decode_block 8",
        "requests": n, "prompt_lens": [len(p) for p in prompts], "max_tokens": max_tokens,
        "shared_prefix": {"tokens": SHARED_PREFIX, "requests": sorted(shared)},
        "sampled": sorted(sampled), "cancelled": cancel, "stop_request": stop,
        "logprob_request": want_lp, "steps": steps, "wall_s": wall,
        "requests_per_s": n / wall, "output_tokens": tokens_out,
        "output_tokens_per_s": tokens_out / wall,
        "ttft_p50_s": METRICS.percentile("ttft_s", 0.5),
        "ttft_p99_s": METRICS.percentile("ttft_s", 0.99),
        "ttft_note": "submit to the first token on the host, METRICS ttft_s; 8 requests are "
                     f"submitted after step {SERVING_LATE_STEP}",
        "admission_s": admission_s, "admission_share": admission_s / wall,
        "admission_sweeps": len(METRICS.samples["admission_prefill_s"]),
        "staged_admissions": METRICS.counters.get("staged_admissions", 0),
        "prefix_hits": hits, "prefix_hits_eligible": eligible,
        "prefix_tokens_reused": METRICS.counters.get("prefix_tokens_reused", 0),
        "decode_forwards": decode_forwards[0], "peak_mem_gb": peak_gb,
        "peak_mem_note": "less the other phases' resident bytes",
        "resident_gb": resident / 1e9,
        "greedy_requests": len(greedy), "divergences_at_near_ties": len(diverged),
        "near_tie_gap": NEAR_TIE_GAP, "logprob_request_prompt_gap_nats": lp_gap,
        "reference_s": ref_s, "launches": launches, "metrics": json.loads(METRICS.dump()),
    }
    if profile:
        summary["engine_block"] = engine_block_probe(model)
    return summary


# The staged-rows check: a 1100-token request (3 chunks of 512) alone, then
# beside rows of other lengths, shorter and longer, in one staged sweep.
STAGED_TARGET = 1100
STAGED_BESIDE = {0: [], 2: [300, 2000], 7: [40, 300, 700, 1050, 1500, 2000, 3000]}
STAGED_TOKENS = 48


class StagedPath(NamedTuple):
    model: str
    ring: str  # the KV ring's type
    window: Optional[int]
    moe_impl: str = "dense"
    capacity: float = 1.0  # moe_capacity_factor


# The benchmark's two configurations at full depth: Mistral-7B over an fp8
# ring, and Mixtral-8x7B over an int8 ring with capacities ("dispatch", whose
# staged chunks of 512 rows and more take the ragged route).
STAGED_PATHS = (StagedPath(MODEL, "fp8", WINDOW),
                StagedPath(MOE_MODEL, "int8", None, "dispatch", 4.0))


def staged_rows_check(card: str, path: StagedPath) -> dict:
    """A staged row's bits do not move with the rows staged beside it. On
    ``path.model`` (int4 weights, all 32 layers), an ``Engine(batch_size=16,
    max_seq_len=4608, admit_chunk=512, staging_batch=8)``, which compacts,
    admits a 1100-token greedy request that wants its prompt logprobs in one
    staged sweep alone, beside 2 and beside 7 other requests
    (``STAGED_BESIDE``), each chunk over the rows still prefilling. Its
    carried prelogits after the sweep, its ring row (bytes and scales up to
    its fill), its prompt logprobs and its ``STAGED_TOKENS`` served tokens
    must equal the lone sweep's in bits. Returns the line: each sweep's
    prefill forwards' rows and seconds."""
    from mistral_inference_tpu_torch.model import Transformer
    from mistral_inference_tpu_torch.models.registry import get_args
    from mistral_inference_tpu_torch.server.engine import Engine, _compacts

    args = get_args(path.model)
    args.kv_quant, args.sliding_window = path.ring, path.window
    if args.moe:
        args.moe_impl, args.moe_capacity_factor = path.moe_impl, path.capacity
    model = Transformer.random(args, dtype=torch.bfloat16, seed=0, quant="int4")
    gen = torch.Generator().manual_seed(1)

    def prompt(n: int) -> list:
        return torch.randint(1, args.vocab_size, (n,), generator=gen).tolist()

    target = prompt(STAGED_TARGET)
    beside = {k: [prompt(n) for n in lens] for k, lens in STAGED_BESIDE.items()}
    forward, rows = model.forward, []

    def recording(tokens, *a, **kw):
        if tokens.shape[1] > 1:
            rows.append(tokens.shape[0])
        return forward(tokens, *a, **kw)

    model.forward = recording
    runs, first = {}, None
    for k, others in beside.items():
        eng = Engine(model, batch_size=16, max_seq_len=SERVING_MAX_SEQ, admit_chunk=SERVING_CHUNK,
                     staging_batch=8, prefix_cache=False)
        require(_compacts(model, 8, SERVING_CHUNK), f"staged rows {path.model}: no compaction")
        half = len(others) // 2
        for p in others[:half]:
            eng.submit(p, max_tokens=4)
        rid = eng.submit(target, max_tokens=STAGED_TOKENS, want_logprobs=True)
        for p in others[half:]:
            eng.submit(p, max_tokens=4)
        del rows[:]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._admit()
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        slot = next(i for i, r in enumerate(eng.slots) if r is not None and r.request_id == rid)
        fill = int(eng.cache.kv_len[slot])
        c = eng.cache
        state = [eng.carry[slot].clone()] + [t[:, slot, :fill].clone() for t in (c.k, c.v)] + [
            t[:, slot, :, :fill].clone() for t in (c.k_scale, c.v_scale)]
        prompt_lp = torch.tensor(eng._request(rid).prompt_logprobs, dtype=torch.float32)  # exact
        tokens = eng.run_to_completion()[rid]
        del eng
        torch.cuda.empty_cache()
        runs[k] = {"prefill_rows": list(rows), "sweep_s": sweep_s, "fill": fill,
                   "tokens": len(tokens), "prompt_logprobs": len(prompt_lp)}
        require(fill == STAGED_TARGET and len(tokens) == STAGED_TOKENS
                and len(prompt_lp) == STAGED_TARGET - 1,
                f"staged {path.model} beside {k}: fill {fill}, {len(tokens)} tokens, "
                f"{len(prompt_lp)} prompt logprobs")
        if first is None:
            first = state, prompt_lp, tokens
            continue
        runs[k].update(carry_same_bits=same_bits(state[0], first[0][0]),
                       ring_same_bits=all(same_bits(a, b) for a, b in zip(state[1:], first[0][1:])),
                       prompt_logprobs_same_bits=same_bits(prompt_lp, first[1]),
                       tokens_equal=tokens == first[2])
        require(runs[k]["carry_same_bits"] and runs[k]["ring_same_bits"]
                and runs[k]["prompt_logprobs_same_bits"] and runs[k]["tokens_equal"],
                f"staged {path.model} beside {k}: the row's bits moved with the rows beside it: "
                f"{runs[k]}")
    model.forward = forward
    del model
    return {"phase": "staged_rows", "model": path.model, "layers": args.n_layers, "card": card,
            "weights": "bf16 random (seed 0), quantized to int4 (group 128)",
            "kv_ring": path.ring, "window": path.window,
            "moe": None if args.moe is None else f"{path.moe_impl}, capacity {path.capacity}",
            "engine": f"Engine(batch_size=16, max_seq_len={SERVING_MAX_SEQ}, admit_chunk="
                      f"{SERVING_CHUNK}, staging_batch=8)",
            "target_prompt": STAGED_TARGET, "beside": STAGED_BESIDE, "runs": runs}


def engine_block_probe(model, B: int = SERVING_B, steps: int = 10):
    """One engine decode block under step_probe: a serial engine with B
    live greedy requests of 45-token prompts, each step() one block of 8
    decode forwards and its read-back."""
    from mistral_inference_tpu_torch.server.engine import Engine

    eng = Engine(model, batch_size=B, max_seq_len=512, pipeline=False)
    for i in range(B):
        eng.submit(list(range(1 + i, 46 + i)), max_tokens=400)
    eng.step()  # the admission and the first block
    return {"prompt_len": 45, "decode_block": eng.decode_block,
            **step_probe(eng.step, lambda: None, B, steps)}


# ---------------------------------------------------------------------------
# Phase 9: the front door
# ---------------------------------------------------------------------------

FRONT_LAYERS = 8
# The v3 SentencePiece layout: the controls at ids 0..13, then byte fallback.
V3_SPECIALS = ("<unk>", "<s>", "</s>", "[INST]", "[/INST]", "[AVAILABLE_TOOLS]",
               "[/AVAILABLE_TOOLS]", "[TOOL_RESULTS]", "[/TOOL_RESULTS]", "[TOOL_CALLS]",
               "[IMG]", "[PREFIX]", "[MIDDLE]", "[SUFFIX]")
TEKKEN_PATTERN = (r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]*[\p{Ll}\p{Lm}\p{Lo}\p{M}]+|"
                  r"[^\r\n\p{L}\p{N}]?[\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]+[\p{Ll}\p{Lm}\p{Lo}\p{M}]*|"
                  r"\p{N}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+")
TEKKEN_SPECIALS = 1000
FRONT_MAX_TOKENS = 24
FRONT_IMAGE = (512, 768)


def _varint(v: int) -> bytes:
    out = b""
    while True:
        b, v = v & 0x7F, v >> 7
        if not v:
            return out + bytes([b])
        out += bytes([b | 0x80])


def _spm_piece(piece: str, score: float, ptype: int) -> bytes:
    """One ModelProto piece: {piece = 1, score = 2, type = 3}, as field 1."""
    p = piece.encode()
    body = b"\x0a" + _varint(len(p)) + p + b"\x15" + struct.pack("<f", score)
    body += b"\x18" + _varint(ptype)
    return b"\x0a" + _varint(len(body)) + body


def _merged_strings(rng, base, n: int, max_len: int):
    """``n`` distinct strings beyond ``base``, each the concatenation of an
    earlier one and a short one, so that a BPE merge loop reaches each."""
    out, seen = list(base), set(base)
    short = list(base)
    while len(out) < len(base) + n:
        s = rng.choice(out) + rng.choice(short)
        if len(s) <= max_len and s not in seen:
            seen.add(s)
            out.append(s)
            if len(s) <= 3:
                short.append(s)
    return out[len(base):]


def synthetic_spm(vocab_size: int, seed: int) -> bytes:
    """A SentencePiece BPE ``tokenizer.model`` of ``vocab_size`` pieces: the
    v3 controls at their ids, 256 byte-fallback pieces, then characters and
    merged pieces from seeded random strings, earlier merges scoring higher."""
    import random

    chars = ["▁"] + list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789.,!?'-")
    n_merged = vocab_size - len(V3_SPECIALS) - 256 - len(chars)
    merged = _merged_strings(random.Random(seed), chars, n_merged, 12)
    blob = _spm_piece(V3_SPECIALS[0], 0.0, 2)  # UNKNOWN
    blob += b"".join(_spm_piece(p, 0.0, 3) for p in V3_SPECIALS[1:])  # CONTROL
    blob += b"".join(_spm_piece(f"<0x{b:02X}>", 0.0, 6) for b in range(256))  # BYTE
    blob += b"".join(_spm_piece(c, -1e6, 1) for c in chars)
    blob += b"".join(_spm_piece(p, -float(i), 1) for i, p in enumerate(merged))
    return blob


def synthetic_tekken(vocab_size: int, seed: int) -> dict:
    """A tekken.json covering ``vocab_size`` ids: the pre-v7 specials at
    their ids in a prefix of TEKKEN_SPECIALS, then 256 byte ranks and merged
    byte strings from seeded random text."""
    import base64
    import random

    singles = [bytes([i]) for i in range(256)]
    merged = _merged_strings(random.Random(seed), singles, vocab_size - TEKKEN_SPECIALS - 256, 10)
    vocab = [{"rank": r, "token_bytes": base64.b64encode(b).decode()}
             for r, b in enumerate(singles + merged)]
    return {"config": {"pattern": TEKKEN_PATTERN, "default_vocab_size": vocab_size,
                       "default_num_special_tokens": TEKKEN_SPECIALS, "version": "v3"},
            "vocab": vocab}


def reference_state_dict(args, gen):
    """Random bf16 weights under the reference's key names, (out, in)
    layouts, at the port's init scale: linears N(0, 1) / sqrt(fan_in), the
    embedding N(0, 1), norms 1."""
    D, F, V = args.dim, args.hidden_dim, args.vocab_size
    q, kv = args.n_heads * args.head_dim, args.n_kv_heads * args.head_dim

    def draw(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.bfloat16, device=gen.device)

    def lin(out_f, in_f):
        return draw(out_f, in_f).mul_(in_f ** -0.5)

    def ones(n):
        return torch.ones(n, dtype=torch.bfloat16, device=gen.device)

    sd = {"tok_embeddings.weight": draw(V, D), "norm.weight": ones(D),
          "output.weight": lin(V, D)}
    for i in range(args.n_layers):
        p = f"layers.{i}"
        sd.update({
            f"{p}.attention.wq.weight": lin(q, D), f"{p}.attention.wk.weight": lin(kv, D),
            f"{p}.attention.wv.weight": lin(kv, D), f"{p}.attention.wo.weight": lin(D, q),
            f"{p}.feed_forward.w1.weight": lin(F, D), f"{p}.feed_forward.w2.weight": lin(D, F),
            f"{p}.feed_forward.w3.weight": lin(F, D),
            f"{p}.attention_norm.weight": ones(D), f"{p}.ffn_norm.weight": ones(D),
        })
    return sd


def same_tree(a, b, path: str = "params") -> None:
    """Two trees of tensors equal in structure, dtype and bits."""
    if isinstance(a, dict):
        require(isinstance(b, dict) and a.keys() == b.keys(), f"{path}: keys differ")
        for k in a:
            same_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        require(isinstance(b, list) and len(a) == len(b), f"{path}: lengths differ")
        for i, (x, y) in enumerate(zip(a, b)):
            same_tree(x, y, f"{path}[{i}]")
    else:
        require(a.dtype == b.dtype and a.shape == b.shape and same_bits(a, b.to(a.device)),
                f"{path}: differs")


def _http(url: str, path: str, body=None, stream: bool = False):
    """(response, seconds to the first byte of the body, seconds in all)."""
    import urllib.request

    t0 = time.perf_counter()
    req = urllib.request.Request(url + path, data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        if not stream:
            return json.loads(r.read()), None, time.perf_counter() - t0
        events, first = [], None
        for line in r:
            if line.startswith(b"data: "):
                first = first or time.perf_counter() - t0
                events.append(line[6:].strip().decode())
    return events, first, time.perf_counter() - t0


class HttpServing:
    """``Server(engine, tok)`` on a ThreadingHTTPServer at 127.0.0.1:0."""

    def __init__(self, engine, tok):
        import threading
        from http.server import ThreadingHTTPServer

        from mistral_inference_tpu_torch.server.api import Server, _make_handler

        self.srv = Server(engine, tok)
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(self.srv))
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    def __enter__(self):
        self.srv.start()
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.srv.stop()
        self.thread.join(timeout=10)
        require(self.srv.healthy, "the serving device loop failed")


def concurrent(calls):
    """Run the zero-argument ``calls`` in threads at once; their results in
    order (an exception in one is raised here)."""
    import threading

    results, errors = [None] * len(calls), []

    def run(i):
        try:
            results[i] = calls[i]()
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(calls))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors:
        raise errors[0]
    return results


def held_to_alone(label, model, prompts, got, want, eos_id, carry_of=transformer_carry):
    """Each greedy request's tokens ``got`` against ``generate()`` alone,
    ``want`` (run without EOS, to max_tokens): a request that ended early
    ended on EOS, so its tokens and EOS equal generate()'s, or leave them only at a near-tie of the two best logits, for the other of
    the two. Returns the divergences."""
    ext = [g + [eos_id] if len(g) < len(w) else g for g, w in zip(got, want)]
    cut = [w[:len(e)] for e, w in zip(ext, want)]
    diverged = divergences(model, prompts, ext, cut, carry_of)
    for d in diverged:
        emit({"phase": "divergence", "path": label, **d})
        require(d["top2_gap"] <= NEAR_TIE_GAP and d["spec_token"] in d["top2_tokens"]
                and d["plain_token"] in d["top2_tokens"],
                f"{label}: a request left generate() alone away from a near-tie: {d}")
    rows = {d["row"] for d in diverged}
    for r, (e, c) in enumerate(zip(ext, cut)):
        if r not in rows:
            require(e == c, f"{label}: request {r} has {len(e)} tokens, generate() alone {len(c)}")
    return diverged


def front_args():
    from mistral_inference_tpu_torch.models.registry import get_args

    args = get_args(MODEL)
    args.n_layers = FRONT_LAYERS
    return args


def write_front_folder(ref: Path, args, extra: Optional[dict] = None) -> dict:
    """The reference folder of phase 9 (random bf16 weights from seed 13, a
    synthetic SentencePiece tokenizer), written by the port's own
    safetensors writer; ``extra`` joins params.json. Returns the state
    dict, on the card."""
    from mistral_inference_tpu_torch.io.safetensors import save_file

    ref.mkdir(parents=True, exist_ok=True)
    sd = reference_state_dict(args, torch.Generator(device="cuda").manual_seed(13))
    (ref / "params.json").write_text(json.dumps({
        "dim": args.dim, "n_layers": args.n_layers, "head_dim": args.head_dim,
        "hidden_dim": args.hidden_dim, "n_heads": args.n_heads,
        "n_kv_heads": args.n_kv_heads, "norm_eps": args.norm_eps,
        "vocab_size": args.vocab_size, "rope_theta": args.rope_theta,
        "sliding_window": args.sliding_window, **(extra or {})}))
    (ref / "tokenizer.model").write_bytes(synthetic_spm(args.vocab_size, seed=0))
    save_file(sd, ref / "consolidated.safetensors")
    return sd


def front_door_phase(card: str, pix_model, workdir: Path) -> dict:
    """A reference checkpoint folder at mistral-7b-v0.1 widths (8 layers,
    random bf16 weights from a seed, a synthetic 32000-piece SentencePiece
    tokenizer) on disk under ``workdir`` (phase 12 reads it again), through
    the steps a user takes: ``from_folder``, ``main quantize`` then ``main
    demo``, and ``Server(Engine(...))`` answering eight concurrent HTTP
    requests; then one Pixtral image chat request over HTTP on
    ``pix_model``, the Pixtral phase's model. Returns its summary line."""
    import contextlib
    import io

    from mistral_inference_tpu_torch import native
    from mistral_inference_tpu_torch.generate import generate
    from mistral_inference_tpu_torch.main import DEMO_PROMPTS
    from mistral_inference_tpu_torch.main import main as cli
    from mistral_inference_tpu_torch.model import from_folder
    from mistral_inference_tpu_torch.quant import weights as qw
    from mistral_inference_tpu_torch.tokenizers import load_tokenizer

    t_phase = time.perf_counter()
    out: dict = {"phase": "front_door", "model": MODEL, "layers": FRONT_LAYERS, "card": card}
    args = front_args()
    ref, exp = workdir / "reference", workdir / "int4"
    # 1. The reference folder, written by the port's own safetensors writer.
    t = time.perf_counter()
    sd = write_front_folder(ref, args)
    out["write_s"] = time.perf_counter() - t
    out["checkpoint_gb"] = (ref / "consolidated.safetensors").stat().st_size / 1e9

    # 2. from_folder: every leaf equal in bits to the drawn tensors after relayout.
    torch.cuda.synchronize()
    t = time.perf_counter()
    model = from_folder(ref)
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t
    require(model.args.n_layers == FRONT_LAYERS and model.dtype == torch.bfloat16,
            "from_folder: wrong args or dtype")
    w = {"tok_embeddings": sd["tok_embeddings.weight"], "norm": sd["norm.weight"],
         "output": sd["output.weight"], "layers": []}
    for i in range(FRONT_LAYERS):
        p = f"layers.{i}"
        w["layers"].append({
            "attention_norm": sd[f"{p}.attention_norm.weight"],
            "ffn_norm": sd[f"{p}.ffn_norm.weight"],
            "wqkv": torch.cat([sd[f"{p}.attention.{k}.weight"] for k in ("wq", "wk", "wv")]),
            "wo": sd[f"{p}.attention.wo.weight"],
            "w13": torch.cat([sd[f"{p}.feed_forward.{k}.weight"] for k in ("w1", "w3")]),
            "w2": sd[f"{p}.feed_forward.w2.weight"],
        })
    same_tree(w, model.params)
    del model, w, sd
    torch.cuda.empty_cache()

    # 3. main quantize: the export's leaves are from_folder(quant="int4")'s
    # bytes, and loading it quantizes nothing.
    t = time.perf_counter()
    cli(["quantize", str(ref), str(exp), "--quant", "int4", "--kv_quant", "fp8"])
    out["quantize_s"] = time.perf_counter() - t
    out["export_gb"] = (exp / "consolidated.safetensors").stat().st_size / 1e9
    want = from_folder(ref, quant="int4")
    calls = [0]
    quantize = qw.quantize_params

    def counted(*a, **kw):
        calls[0] += 1
        return quantize(*a, **kw)

    qw.quantize_params = counted
    try:
        t = time.perf_counter()
        got = from_folder(exp, quant="int4")
        torch.cuda.synchronize()
        out["export_load_s"] = time.perf_counter() - t
    finally:
        qw.quantize_params = quantize
    require(calls[0] == 0 and got.args.quant == "int4" and got.args.kv_quant == "fp8",
            "from_folder re-quantized the export or lost its modes")
    same_tree(want.params, got.params)
    del want, got
    torch.cuda.empty_cache()

    # 4. main demo on the export, through the native BPE.
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli(["demo", str(exp), "--max_tokens", "8"])
    out["demo_s"] = time.perf_counter() - t
    tok = load_tokenizer(exp)
    require(native._LIB is not None and tok.merge == "native",
            "the demo did not run the native BPE")
    model = from_folder(exp, max_batch_size=8)
    encoded = [tok.encode(p, bos=True, eos=False) for p in DEMO_PROMPTS]
    gen, _ = generate(encoded, model, max_tokens=8, temperature=0.0)
    want_text = "".join(p + tok.decode(g) + "\n" + "=" * 40 + "\n"
                        for p, g in zip(DEMO_PROMPTS, gen))
    require(buf.getvalue() == want_text, "demo: the printed text is not generate()'s")
    out["demo"] = buf.getvalue().split("\n" + "=" * 40 + "\n")[:3]

    # 5. Serving over HTTP: seven requests and /health at once.
    out["serving"] = front_door_serving(model, tok)
    del model
    torch.cuda.empty_cache()
    out["image"] = front_door_image(pix_model)
    out["native_bpe"] = str(native.build().name)
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _text_of(tok, rng, n_tokens: int) -> str:
    """Text of random vocabulary words whose encoding is about ``n_tokens``."""
    words = [p.replace("▁", "") for p, _, t in tok.pieces[400:] if t == 1]
    words = [w for w in words if w.isalnum()]
    text = ""
    while len(tok.encode(text, bos=False)) < n_tokens:
        text += " " + " ".join(rng.choice(words, 16).tolist())
    return text.strip()


def front_door_serving(model, tok) -> dict:
    """Seven requests over HTTP to Engine(batch 8, max_seq_len 4608,
    admit_chunk 512, eos_id = the tokenizer's) on the export, and /health:
    completions by text and by token ids with logprobs, two chat
    completions, a streamed completion, one with a multi-token stop string
    and a top-p request. Every greedy request's tokens (the engine's record,
    which the HTTP replies must carry) are held to generate() alone."""
    import numpy as np

    from mistral_inference_tpu_torch.generate import generate
    from mistral_inference_tpu_torch.ops import cuda as kern
    from mistral_inference_tpu_torch.server.engine import Engine
    from mistral_inference_tpu_torch.tokenizers import ChatRequest, Message, encode_chat
    from mistral_inference_tpu_torch.utils.profiling import METRICS

    rng = np.random.default_rng(5)
    V = model.args.vocab_size

    def ids(n):
        return [tok.bos_id] + rng.integers(len(V3_SPECIALS) + 256, V, n - 1).tolist()

    system = _text_of(tok, rng, 300)
    chat_a = [{"role": "user", "content": _text_of(tok, rng, 30)}]
    chat_b = [{"role": "system", "content": system},
              {"role": "user", "content": _text_of(tok, rng, 60)}]
    M = FRONT_MAX_TOKENS
    bodies = {
        "text_logprobs": ("/v1/completions", {"prompt": _text_of(tok, rng, 300), "max_tokens": M,
                                              "logprobs": True}),
        "ids_logprobs": ("/v1/completions", {"prompt": ids(1500), "max_tokens": M,
                                             "logprobs": True}),
        "chat": ("/v1/chat/completions", {"messages": chat_a, "max_tokens": M}),
        "chat_system": ("/v1/chat/completions", {"messages": chat_b, "max_tokens": M}),
        "stream": ("/v1/completions", {"prompt": ids(700), "max_tokens": M, "stream": True}),
        "stop": ("/v1/completions", {"prompt": _text_of(tok, rng, 120), "max_tokens": M}),
        "top_p": ("/v1/completions", {"prompt": ids(1000), "max_tokens": M,
                                      "temperature": 0.7, "top_p": 0.9}),
    }

    def prompt_of(body):
        if "messages" in body:
            return encode_chat(tok, ChatRequest([Message(m["role"], m["content"])
                                                 for m in body["messages"]]))
        p = body["prompt"]
        return p if isinstance(p, list) else tok.encode(p, bos=True, eos=False)

    prompts = {k: prompt_of(b) for k, (_, b) in bodies.items()}
    greedy = [k for k in bodies if k != "top_p"]
    ref, ref_lps = {}, {}
    for k in greedy:
        g, lp = generate([prompts[k]], model, max_tokens=M, temperature=0.0, chunk_size=CHUNK)
        ref[k], ref_lps[k] = g[0], lp[0]
    # A multi-token stop string from the middle of the reference's text.
    stop = tok.decode(ref["stop"][6:10])
    require(stop and len(tok.encode(stop, bos=False)) > 1, "no multi-token stop string")
    bodies["stop"][1]["stop"] = stop

    engine = Engine(model, batch_size=SERVING_B, max_seq_len=SERVING_MAX_SEQ,
                    admit_chunk=SERVING_CHUNK, eos_id=tok.eos_id)
    METRICS.__init__()
    kern.reset_launch_counts()
    torch.cuda.synchronize()
    with HttpServing(engine, tok) as http:
        calls = [lambda: _http(http.url, "/health")]
        calls += [lambda p=p, b=b: _http(http.url, p, b, stream=bool(b.get("stream")))
                  for p, b in bodies.values()]
        t0 = time.perf_counter()
        results = concurrent(calls)
        wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = launch_counts()
    require(results[0][0]["status"] == "ok", "/health is not ok")
    resp = dict(zip(bodies, results[1:]))
    # The engine's record of each request; the HTTP replies must carry it.
    record = {k: next(r for r in engine.slots if r is not None and r.prompt == prompts[k])
              for k in bodies}
    got = {k: record[k].generated for k in bodies}
    for k in bodies:
        reply = resp[k][0]
        if k == "stream":
            require(reply[-1] == "[DONE]", "the stream did not end with [DONE]")
            streamed = [json.loads(e)["token"] for e in reply[:-1]]
            ended = got[k] + [tok.eos_id] if len(got[k]) < M else got[k]
            require(streamed == ended, "the stream's tokens are not the engine's")
        elif "messages" in bodies[k][1]:
            require(reply["choices"][0]["message"]["content"] == tok.decode(got[k]),
                    f"{k}: the reply is not the decode of the engine's tokens")
        else:
            require(reply["choices"][0]["tokens"] == got[k], f"{k}: wrong tokens in the reply")
    diverged = held_to_alone("front_door", model, [prompts[k] for k in greedy],
                             [got[k] for k in greedy], [ref[k] for k in greedy], tok.eos_id)
    text = tok.decode(got["stop"])
    cut = text.find(stop)
    require(resp["stop"][0]["choices"][0]["text"] == (text[:cut] if cut >= 0 else text),
            "the stop string did not truncate the text")
    lp_gaps = {}
    for k in ("text_logprobs", "ids_logprobs"):
        lp = resp[k][0]["choices"][0]["logprobs"]
        n = len(prompts[k]) - 1
        require(len(lp["prompt_logprobs"]) == n, f"{k}: wrong prompt logprob count")
        gap = np.abs(np.array(lp["prompt_logprobs"]) - np.array(ref_lps[k][:n]))
        lp_gaps[k] = {"max": float(gap.max()), "mean": float(gap.mean())}
        require(gap.max() <= INVARIANT_MAX_NATS and gap.mean() <= INVARIANT_MEAN_NATS,
                f"{k}: prompt logprobs {lp_gaps[k]} nats from generate()'s")
    sampled = got["top_p"]
    require(len(sampled) <= M and all(0 <= t < model.args.vocab_size for t in sampled),
            "the top-p request's tokens are wrong")
    for name in (K1, K4F, K2F, K3, K5):
        require(launches[name] > 0, f"{name} was not launched on the front door's serving")
    return {
        "requests": len(bodies), "prompt_lens": {k: len(p) for k, p in prompts.items()},
        "max_tokens": M, "wall_s": wall, "requests_per_s": len(bodies) / wall,
        "ttft_p50_s": METRICS.percentile("ttft_s", 0.5),
        "ttft_p99_s": METRICS.percentile("ttft_s", 0.99),
        "stream_first_event_s": resp["stream"][1],
        "ttft_note": "ttft: submit to first token in the engine (METRICS ttft_s); the stream's "
                     "first event is the client's clock from sending to the first SSE line",
        "stop_string": stop, "prompt_logprob_gaps": lp_gaps,
        "divergences_at_near_ties": len(diverged),
        "launches": {k: launches[k] for k in (K1, K4F, K2F, K3, K5)},
    }


def front_door_image(model) -> dict:
    """One Pixtral chat request with a 512 x 768 image as a nested-list array
    and one text request, over HTTP, on the Pixtral phase's model with a
    synthetic tekken.json of 131072 ids; tokens held to generate(images=...)
    alone, K10 launched once per encoder layer."""
    import numpy as np

    from mistral_inference_tpu_torch.generate import generate, prefill_prompts
    from mistral_inference_tpu_torch.ops import cuda as kern
    from mistral_inference_tpu_torch.server.engine import Engine
    from mistral_inference_tpu_torch.models.vision import embed_multimodal
    from mistral_inference_tpu_torch.tokenizers import ChatRequest, Message, encode_chat
    from mistral_inference_tpu_torch.tokenizers.chat import encode_chat_multimodal
    from mistral_inference_tpu_torch.tokenizers.tekken import Tekken

    vargs = model.args.vision_encoder
    with tempfile.TemporaryDirectory(prefix="tekken_") as tmp:
        path = Path(tmp) / "tekken.json"
        path.write_text(json.dumps(synthetic_tekken(model.args.vocab_size, seed=0)))
        tok = Tekken.from_file(path)
    require(tok.vocab_size == model.args.vocab_size and tok.special("[IMG]") == vargs.image_token_id,
            "the synthetic tekken.json does not fit pixtral-12b")
    image = np.random.default_rng(7).integers(0, 256, (*FRONT_IMAGE, 3), np.uint8)
    question = "Describe the picture in three words."
    content = [{"type": "text", "text": question}, {"type": "image", "image": image.tolist()}]
    ids, images = encode_chat_multimodal(tok, ChatRequest([Message("user", [question, image])]),
                                         vargs)
    text_ids = encode_chat(tok, ChatRequest([Message("user", "And now a poem, please.")]))
    M = FRONT_MAX_TOKENS
    ref = generate([ids], model, images=[images], max_tokens=M, temperature=0.0,
                   chunk_size=CHUNK)[0][0]
    ref_text = generate([text_ids], model, max_tokens=M, temperature=0.0, chunk_size=CHUNK)[0][0]
    engine = Engine(model, batch_size=2, max_seq_len=len(ids) + M + 64,
                    admit_chunk=SERVING_CHUNK, eos_id=tok.eos_id)
    kern.reset_launch_counts()
    torch.cuda.synchronize()
    with HttpServing(engine, tok) as http:
        t0 = time.perf_counter()
        (img_resp, _, img_s), (txt_resp, _, _) = concurrent([
            lambda: _http(http.url, "/v1/chat/completions",
                          {"messages": [{"role": "user", "content": content}], "max_tokens": M}),
            lambda: _http(http.url, "/v1/chat/completions",
                          {"messages": [{"role": "user", "content": "And now a poem, please."}],
                           "max_tokens": M})])
        wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = launch_counts()
    require(launches[K10] == vargs.num_hidden_layers,
            f"K10 launched {launches[K10]} times for one image, expected {vargs.num_hidden_layers}")
    for name in (K1, K4, K2):
        require(launches[name] > 0, f"{name} was not launched on the image request")

    def image_carry(m, tokens):
        emb = embed_multimodal(m, [tokens], [images])
        cache = m.alloc_cache(1, len(tokens))
        with torch.inference_mode():
            return prefill_prompts(m, [tokens], cache, CHUNK, want_logprobs=False,
                                   input_embeds=emb)[1]

    got = {}
    for label, resp, prompt, want, carry_of in (
            ("image", img_resp, ids, ref, image_carry),
            ("text", txt_resp, text_ids, ref_text, transformer_carry)):
        rec = next(r for r in engine.slots if r is not None and r.prompt == prompt)
        require(resp["choices"][0]["message"]["content"] == tok.decode(rec.generated),
                f"{label}: the reply is not the decode of the engine's tokens")
        got[label] = held_to_alone(f"front_door {label}", model, [prompt], [rec.generated],
                                   [want], tok.eos_id, carry_of)
    return {"model": PIXTRAL_MODEL, "image": list(FRONT_IMAGE), "prompt_len": len(ids),
            "text_prompt_len": len(text_ids), "payload": "nested-list array",
            "payload_mb": len(json.dumps(content)) / 1e6, "wall_s": wall, "image_request_s": img_s,
            "divergences_at_near_ties": {k: len(v) for k, v in got.items()}, "launches": {k: launches[k] for k in (K10, K1, K4, K2)}}


# ---------------------------------------------------------------------------
# Phases 10-12: speculative serving, Mamba serving, LoRA
# ---------------------------------------------------------------------------

SPEC_SERVING_B, SPEC_SERVING_MAX_SEQ = 8, 2048  # span < 4096: the ring never wraps
SPEC_SERVING_REQUESTS, SPEC_SERVING_FIRST = 16, 8
SPEC_SERVING_LATE_STEP, SPEC_SERVING_CANCEL_STEP = 3, 6
SPEC_SERVING_LENS = (1537, 700, 300, 45)
SPEC_SHARED_PREFIX = 512
SPEC_SERVING_K = 7  # the lookup engine's spec_tokens; the self-draft engine keeps 4


class Workload(NamedTuple):
    """A stream of requests for an engine: per request its prompt, budget,
    sampling settings and stop ids; which requests share a prefix; which one
    is cancelled (at ``cancel_step``), ended by a stop id, asks for
    logprobs; how many are submitted at the start (the rest after
    ``late_step`` steps)."""

    prompts: list
    max_tokens: list
    sampled: set
    shared: set
    cancel: int
    stop: int
    logprobs: int
    first: int
    late_step: int
    cancel_step: int
    stop_ids: Tuple[int, ...] = ()  # the stop request's, from its reference


def spec_serving_workload(vocab_size: int) -> Workload:
    """16 requests from seed 10: prompts of 45-1537 tokens, half of them a
    50-token block repeated (lookup finds its continuations there), 4 sharing
    a 512-token prefix (the first request among them), max_tokens 32-96,
    4 sampled at T = 0.7, p = 0.9, the rest greedy; 8 submitted at the
    start, 8 after the third step."""
    import numpy as np

    rng = np.random.default_rng(10)
    n = SPEC_SERVING_REQUESTS
    lens = rng.choice(SPEC_SERVING_LENS, n).tolist()
    shared = [0] + sorted(rng.choice(np.arange(1, n), 3, replace=False).tolist())
    for i in shared:
        lens[i] = int(rng.choice(SPEC_SERVING_LENS[:2]))
    prompts = []
    for i, m in enumerate(lens):
        if i % 2:  # a repeated block: the n-gram proposer's case
            block = rng.integers(1, vocab_size, REPEATED_BLOCK).tolist()
            prompts.append((block * (m // REPEATED_BLOCK + 1))[:m])
        else:
            prompts.append(rng.integers(1, vocab_size, m).tolist())
    prefix = rng.integers(1, vocab_size, SPEC_SHARED_PREFIX).tolist()
    for i in shared:
        prompts[i][:SPEC_SHARED_PREFIX] = prefix
    max_tokens = rng.integers(32, 97, n).tolist()
    others = [i for i in range(1, n) if i not in shared]
    sampled = set(rng.choice(others, 4, replace=False).tolist())
    greedy_first = [i for i in others if i not in sampled and i < SPEC_SERVING_FIRST]
    cancel, stop, logprobs = greedy_first[0], greedy_first[1], greedy_first[2]
    max_tokens[cancel] = max_tokens[0] = 96
    return Workload(prompts, max_tokens, sampled, set(shared), cancel, stop, logprobs,
                    SPEC_SERVING_FIRST, SPEC_SERVING_LATE_STEP, SPEC_SERVING_CANCEL_STEP)


def stop_token(ref):
    """The first token of a reference, after its first 8, not seen before it:
    (its step, the token)."""
    at = next(t for t in range(8, len(ref)) if ref[t] not in ref[:t])
    return at, ref[at]


class ForwardCount:
    """Counts a model's forwards while entered: T = 1 steps (decode, or a
    draft's steps), fused verify chunks (``write_cache="spec"``) and
    no-write verify chunks."""

    def __init__(self, model):
        self.model, self.step, self.spec, self.nowrite = model, 0, 0, 0

    def __enter__(self):
        forward = self._forward = self.model.forward

        def counted(tokens, *a, **kw):
            wc = kw.get("write_cache", True)
            if wc == "spec":
                self.spec += 1
            elif wc is False:
                self.nowrite += 1
            elif tokens.shape[1] == 1:
                self.step += 1
            return forward(tokens, *a, **kw)

        self.model.forward = counted
        return self

    def __exit__(self, *exc):
        self.model.forward = self._forward


def fills(eng):
    """Each row's fill: the ring's kv_len, or the Mamba state's tokens seen."""
    return (eng.cache.kv_len if hasattr(eng, "cache") else eng.state.seen).cpu().tolist()


def serve_workload(eng, w: Workload, slack: int = 0):
    """Drive ``eng`` through ``w`` step by step. Checks that no row's fill
    passes prompt + max_tokens + ``slack`` (read when a slot goes to a new
    request, after admission has waited for the card, and at the end) and,
    for an engine with a prefix cache, counts the shared-prefix admissions
    that had a source live across their step. Returns (each request's
    record, steps, wall seconds, those admissions)."""
    from mistral_inference_tpu_torch.server import mamba_engine as me

    occupant, overshoot = [None] * eng.B, []

    def check(rows):
        kv = fills(eng)
        for slot in rows:
            r = occupant[slot]
            if r is not None and kv[slot] > len(r.prompt) + r.max_tokens + slack:
                overshoot.append((r.request_id, kv[slot], len(r.prompt) + r.max_tokens + slack))

    if hasattr(eng, "_plan_prefix_reuse"):
        plan = eng._plan_prefix_reuse

        def checked_plan(new):
            check([slot for slot, _ in new])
            return plan(new)

        eng._plan_prefix_reuse = checked_plan
        restore = None
    else:
        reset, restore = me._reset_rows, me._reset_rows

        def checked_reset(state, rows):
            check(rows.tolist())
            return reset(state, rows)

        me._reset_rows = checked_reset
    reqs, rid = {}, {}

    def submit(i):
        rid[i] = eng.submit(w.prompts[i], max_tokens=w.max_tokens[i],
                            temperature=0.7 if i in w.sampled else 0.0,
                            top_p=0.9 if i in w.sampled else None,
                            stop_ids=w.stop_ids if i == w.stop else (),
                            want_logprobs=i == w.logprobs)
        reqs[i] = eng.queue[-1]  # the engine's own record, updated as it runs

    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(w.first):
            submit(i)
        steps, eligible = 0, 0
        while eng.has_work or steps < w.late_step:
            live_before = {r.request_id for r in eng.slots if r is not None and not r.done}
            eng.step()
            steps += 1
            live_after = {r.request_id for r in eng.slots if r is not None and not r.done}
            for slot, r in enumerate(eng.slots):
                if r is not None and r is not occupant[slot]:
                    i = next(k for k in reqs if reqs[k] is r)
                    sources = {rid[j] for j in w.shared if j in rid and j != i}
                    if i in w.shared and not r.want_logprobs and sources & live_before & live_after:
                        eligible += 1
                occupant[slot] = r
            if steps == w.late_step:
                for i in range(w.first, len(w.prompts)):
                    submit(i)
            if steps == w.cancel_step:
                require(any(r is reqs[w.cancel] and not r.done for r in eng.slots),
                        "the request to cancel is not live")
                eng.cancel(rid[w.cancel])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        if restore is not None:
            me._reset_rows = restore
    check(range(eng.B))
    require(not overshoot, f"rows wrote past prompt + max_tokens + {slack}: {overshoot}")
    if hasattr(eng, "dcache"):
        kv = eng.dcache.kv_len.cpu().tolist()
        require(all(kv[s] <= len(r.prompt) + r.max_tokens + slack
                    for s, r in enumerate(eng.slots) if r is not None),
                "a draft ring row wrote past prompt + max_tokens + slack")
    return reqs, steps, wall, eligible


def held_to_references(label, model, w: Workload, reqs, ref, stop_at, carry_of):
    """Each greedy request of ``w`` against generate() alone, ``ref``: the
    cancelled one as far as it went, the stop request up to and with its
    stop token; a request may leave its reference only at a near-tie of the
    two best logits, for the other of the two. The cancelled request stopped
    early, the sampled ones hold in-range tokens, no request failed.
    Returns the divergences."""
    n = len(w.prompts)
    greedy = [i for i in range(n) if i not in w.sampled]
    out = {i: reqs[i].generated for i in range(n)}
    got = dict(out)
    if len(out[w.stop]) < w.max_tokens[w.stop]:
        got[w.stop] = out[w.stop] + [w.stop_ids[0]]
    want = {i: ref[i][:len(out[i])] if i == w.cancel else ref[i] for i in greedy}
    want[w.stop] = ref[w.stop][:stop_at + 1]
    diverged = divergences(model, [w.prompts[i] for i in greedy], [got[i] for i in greedy],
                           [want[i] for i in greedy], carry_of)
    for d in diverged:
        d["request"] = greedy[d.pop("row")]
    near_ties(label, diverged)
    differ_at = {d["request"] for d in diverged}
    for i in greedy:
        if i not in differ_at:
            require(got[i] == want[i], f"{label}: request {i} has {len(got[i])} tokens, "
                                       f"generate() alone {len(want[i])}")
    require(reqs[w.cancel].done and 0 < len(out[w.cancel]) < w.max_tokens[w.cancel],
            f"{label}: the cancelled request did not stop early")
    V = model.args.vocab_size
    for i in w.sampled:
        require(len(out[i]) == w.max_tokens[i] and all(0 <= t < V for t in out[i]),
                f"{label}: sampled request {i}: wrong tokens")
    require(all(r.error is None for r in reqs.values()), f"{label}: a request failed")
    return diverged


def logprob_gap(label, teacher, r):
    """The logprob request's prompt and emitted logprobs against a
    teacher-forced prefill of its prompt + tokens (``teacher(tokens)`` ->
    its seqlen - 1 logprobs): within INVARIANT_MAX_NATS / _MEAN_NATS."""
    import numpy as np

    tf_lps = np.array(teacher(r.prompt + r.generated))
    n = len(r.prompt) - 1
    require(len(r.prompt_logprobs) == n and len(r.gen_logprobs) == len(r.generated),
            f"{label}: wrong logprob counts")
    got = np.array(r.prompt_logprobs + r.gen_logprobs)
    gap = np.abs(got - tf_lps[:len(got)])
    out = {"prompt_max": float(gap[:n].max()), "generated_max": float(gap[n:].max()),
           "mean": float(gap.mean())}
    require(gap.max() <= INVARIANT_MAX_NATS and gap.mean() <= INVARIANT_MEAN_NATS,
            f"{label}: logprobs {out} nats from a teacher-forced prefill")
    return out


def serving_metrics(reqs, wall):
    from mistral_inference_tpu_torch.utils.profiling import METRICS

    tokens = sum(len(r.generated) for r in reqs.values())
    admission = sum(METRICS.samples.get("admission_prefill_s", []))
    per_forward = METRICS.samples.get("spec_tokens_per_forward", [])
    return {
        "wall_s": wall, "requests_per_s": len(reqs) / wall, "output_tokens": tokens,
        "output_tokens_per_s": tokens / wall,
        "ttft_p50_s": METRICS.percentile("ttft_s", 0.5),
        "ttft_p99_s": METRICS.percentile("ttft_s", 0.99),
        "admission_s": admission, "admission_share": admission / wall,
        "tokens_per_row_verify": statistics.mean(per_forward) if per_forward else None,
        "accepted_per_row_verify": statistics.mean(per_forward) - 1 if per_forward else None,
        "prefix_hits": METRICS.counters.get("prefix_hits", 0),
    }


def spec_serving_phase(card: str, resident: int = 0) -> dict:
    """Phase 10: the workload of ``spec_serving_workload`` served three
    times by ``Engine(batch_size=8, max_seq_len=2048, admit_chunk=512)`` on
    ``mistral-7b-v0.1`` (int4 weights, an fp8 ring, window 4096, all 32
    layers): prompt lookup with K = 7, the target as its own draft (K = 4,
    every draft accepted), and the plain engine. Checks every greedy request
    against generate() of its prompt alone, the fused verify kernel's
    launches (layers x verify forwards) and K2-fp8's (layers x T = 1
    forwards: 0 for lookup, the draft's steps for the self-draft engine, the
    decode steps for the plain one), the prefix hits (into the draft's ring
    too), that no row writes past prompt + max_tokens + the block's slack,
    that sampled requests repeat for a seed, and the logprob request against
    a teacher-forced prefill. ``resident``: bytes other phases hold."""
    import numpy as np

    from mistral_inference_tpu_torch.generate import generate
    from mistral_inference_tpu_torch.model import Transformer
    from mistral_inference_tpu_torch.models.registry import get_args
    from mistral_inference_tpu_torch.ops import cuda as kern
    from mistral_inference_tpu_torch.server import engine as engine_mod
    from mistral_inference_tpu_torch.server.engine import Engine
    from mistral_inference_tpu_torch.utils.profiling import METRICS

    t_phase = time.perf_counter()
    args = get_args(MODEL)
    args.kv_quant, args.sliding_window = "fp8", WINDOW
    model = Transformer.random(args, dtype=torch.bfloat16, seed=0, quant="int4")
    layers = args.n_layers
    w = spec_serving_workload(args.vocab_size)
    n = len(w.prompts)
    t = time.perf_counter()
    ref = {i: generate([w.prompts[i]], model, max_tokens=w.max_tokens[i], temperature=0.0,
                       chunk_size=CHUNK)[0][0] for i in range(n) if i not in w.sampled}
    ref_s = time.perf_counter() - t
    stop_at, stop_id = stop_token(ref[w.stop])
    w = w._replace(stop_ids=(stop_id,))

    def teacher(tokens):
        return generate([tokens], model, max_tokens=0, temperature=0.0, chunk_size=CHUNK)[1][0]

    out = {"phase": "spec_serving", "model": MODEL, "layers": layers, "card": card,
           "weights": "bf16 random (seed 0), quantized to int4 (group 128)", "kv_ring": "fp8",
           "window": WINDOW, "requests": n, "prompt_lens": [len(p) for p in w.prompts],
           "max_tokens": w.max_tokens, "sampled": sorted(w.sampled), "shared": sorted(w.shared),
           "cancelled": w.cancel, "stop_request": w.stop, "logprob_request": w.logprobs,
           "reference_s": ref_s, "engines": {}}
    copies = []
    copy = engine_mod.copy_prefix_rows

    def counted_copy(cache, *a):
        copies.append(id(cache))
        return copy(cache, *a)

    engine_mod.copy_prefix_rows = counted_copy
    try:
        for label, kw in (("lookup", dict(draft_model="lookup", spec_tokens=SPEC_SERVING_K)),
                          ("self_draft", dict(draft_model=model)), ("plain", {})):
            METRICS.__init__()
            kern.reset_launch_counts()
            copies.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            eng = Engine(model, batch_size=SPEC_SERVING_B, max_seq_len=SPEC_SERVING_MAX_SEQ,
                         admit_chunk=CHUNK, **kw)
            slack = eng._span - eng.max_seq_len
            with ForwardCount(model) as fwd:
                reqs, steps, wall, eligible = serve_workload(eng, w, slack)
            peak_gb = (torch.cuda.max_memory_allocated() - resident) / 1e9
            launches = launch_counts()
            diverged = held_to_references(f"spec_serving {label}", model, w, reqs, ref, stop_at,
                                          transformer_carry)
            hits = METRICS.counters.get("prefix_hits", 0)
            require(hits >= eligible, f"{label}: {hits} prefix hits for {eligible} eligible "
                                      "admissions")
            require(fwd.nowrite == 0, f"{label}: {fwd.nowrite} verify forwards off the fused route")
            if label == "plain":
                require(fwd.spec == 0 and launches[K7F] == 0, "plain: a verify forward ran")
            else:
                require(eng._spec_fused and fwd.spec > 0
                        and launches[K7F] == layers * fwd.spec,
                        f"{label}: K7-fp8 launched {launches[K7F]} times for {fwd.spec} verify "
                        f"forwards of {layers} layers")
            require(launches[K2F] == layers * fwd.step,
                    f"{label}: K2-fp8 launched {launches[K2F]} times for {fwd.step} T = 1 "
                    f"forwards of {layers} layers")
            if label == "lookup":
                require(launches[K2F] == 0, "lookup: K2-fp8 was launched")
            if label == "self_draft":
                ring = [c for c in copies if c == id(eng.cache)]
                dring = [c for c in copies if c == id(eng.dcache)]
                require(len(dring) == len(ring) == hits,
                        f"self_draft: {len(ring)} prefix copies into the ring, {len(dring)} "
                        f"into the draft's, {hits} hits")
            for name in (K1, K4F, K3, K5):
                require(launches[name] > 0, f"{name} was not launched by the {label} engine")
            lp = logprob_gap(label, teacher, reqs[w.logprobs])
            out["engines"][label] = {
                "engine": f"Engine(batch_size={SPEC_SERVING_B}, max_seq_len="
                          f"{SPEC_SERVING_MAX_SEQ}, admit_chunk={CHUNK}"
                          + {"lookup": f", draft_model='lookup', spec_tokens={SPEC_SERVING_K})",
                             "self_draft": ", draft_model=<the target>, spec_tokens=4)",
                             "plain": ")"}[label],
                "steps": steps, **serving_metrics(reqs, wall),
                "prefix_hits_eligible": eligible, "verify_forwards": fwd.spec,
                "t1_forwards": fwd.step, "span": eng._span, "peak_mem_gb": peak_gb,
                "logprob_request_gaps": lp, "divergences_at_near_ties": len(diverged),
                "launches": {k: launches[k] for k in (K1, K4F, K2F, K7F, K3, K5)},
            }
            del eng
            torch.cuda.empty_cache()
    finally:
        engine_mod.copy_prefix_rows = copy

    # Sampled requests repeat for a seed and an order of arrival.
    def sampled_run():
        eng = Engine(model, batch_size=SPEC_SERVING_B, max_seq_len=SPEC_SERVING_MAX_SEQ,
                     admit_chunk=CHUNK, draft_model="lookup", spec_tokens=SPEC_SERVING_K, seed=1)
        ids = [eng.submit(w.prompts[i], max_tokens=w.max_tokens[i], temperature=0.7, top_p=0.9)
               for i in sorted(w.sampled)]
        res = eng.run_to_completion()
        return [res[i] for i in ids]

    first = sampled_run()
    require(first == sampled_run(), "sampled speculative requests differ between two runs "
                                    "with one seed")
    out["sampled_repeat"] = True
    out["resident_gb"] = resident / 1e9
    out["peak_mem_note"] = "each engine's peak less the other phases' resident bytes"
    out["seconds"] = time.perf_counter() - t_phase
    return out


MAMBA_SERVING_B, MAMBA_SERVING_MAX_SEQ = 4, 2048
MAMBA_SERVING_REQUESTS = 12


def mamba_serving_workload(vocab_size: int) -> Workload:
    """12 greedy requests from seed 11, all submitted at the start to 4
    slots: prompts of 45-1537 tokens (half a repeated block), staggered
    max_tokens 16-64; request 1 is cancelled after the third step, request 2
    ends on a stop id, request 3 asks for logprobs."""
    import numpy as np

    rng = np.random.default_rng(11)
    n = MAMBA_SERVING_REQUESTS
    prompts = []
    for i, m in enumerate(rng.choice(SPEC_SERVING_LENS, n).tolist()):
        if i % 2:
            block = rng.integers(1, vocab_size, REPEATED_BLOCK).tolist()
            prompts.append((block * (m // REPEATED_BLOCK + 1))[:m])
        else:
            prompts.append(rng.integers(1, vocab_size, m).tolist())
    max_tokens = rng.integers(16, 65, n).tolist()
    max_tokens[1] = 64
    return Workload(prompts, max_tokens, set(), set(), 1, 2, 3, n, 0, 3)


class FrozenRows:
    """While entered, checks that a block leaves the state rows of finished
    requests as they were: their conv taps and SSD state are copied when the
    block is queued (the copies are ordered before it on the stream) and
    compared once it has run, before admission may reset those rows."""

    def __init__(self, eng):
        self.eng, self.pending, self.checked, self.changed = eng, [], 0, []

    def __enter__(self):
        eng = self.eng
        self._names = ("_dispatch_block", "_spec_dispatch", "_admit")
        dispatch, spec, admit = (getattr(eng, n) for n in self._names)

        def snap():
            for i, s in enumerate(eng.slots):
                if s is not None and s.done:
                    self.pending.append((i, eng.state.conv[:, i].clone(),
                                         eng.state.ssm[:, i].clone()))

        def compare():
            for i, conv, ssm in self.pending:
                self.checked += 1
                if not (same_bits(eng.state.conv[:, i], conv)
                        and same_bits(eng.state.ssm[:, i], ssm)):
                    self.changed.append(i)
            self.pending.clear()

        eng._dispatch_block = lambda prev: (snap(), dispatch(prev))[1]
        eng._spec_dispatch = lambda *a: (snap(), spec(*a))[1]
        eng._admit = lambda: (compare(), admit())[1]
        return self

    def __exit__(self, *exc):
        for name in self._names:
            delattr(self.eng, name)


def mamba_serving_phase(card: str) -> dict:
    """Phase 11: ``MambaEngine(batch_size=4, max_seq_len=2048,
    admit_chunk=512)`` on ``codestral-mamba-7b`` at full width, 8 layers,
    int4 weights, once with an fp32 and once with a bf16 SSD state, serving
    ``mamba_serving_workload`` plainly and with prompt lookup (K = 7).
    Checks every greedy request against generate_mamba of its prompt alone
    (chunk 512): equal tokens plainly and over HTTP, near-ties allowed only
    for lookup, whose verify runs the chunked SSD; K9's launches (layers x decode forwards plainly, 0 for
    lookup), that every block leaves a finished request's state rows in
    bits, and no row past prompt + max_tokens (+ a lookup block's slack);
    then one HTTP completion through ``Server(MambaEngine(...))`` with a
    synthetic 32768-piece SentencePiece tokenizer."""
    import numpy as np

    from mistral_inference_tpu_torch.generate import generate_mamba
    from mistral_inference_tpu_torch.ops import cuda as kern
    from mistral_inference_tpu_torch.server.mamba_engine import MambaEngine
    from mistral_inference_tpu_torch.tokenizers import load_tokenizer
    from mistral_inference_tpu_torch.utils.profiling import METRICS

    t_phase = time.perf_counter()
    out = {"phase": "mamba_serving", "model": MAMBA_MODEL, "layers": MAMBA_LOOKUP_LAYERS,
           "card": card, "weights": "bf16 random (seed 0), quantized to int4 (group 128)",
           "states": {}}
    for bf16_state in (False, True):
        model = mamba_model(MAMBA_LOOKUP_LAYERS, "int4", bf16_state)
        layers = model.args.n_layers
        w = mamba_serving_workload(model.args.vocab_size)
        t = time.perf_counter()
        ref = {i: generate_mamba([p], model, max_tokens=w.max_tokens[i], temperature=0.0,
                                 chunk_size=CHUNK)[0][0] for i, p in enumerate(w.prompts)}
        ref_s = time.perf_counter() - t
        stop_at, stop_id = stop_token(ref[w.stop])
        w = w._replace(stop_ids=(stop_id,))
        state = "bf16" if bf16_state else "fp32"
        runs = {"reference_s": ref_s}
        for label, kw in (("plain", {}),
                          ("lookup", dict(draft_model="lookup", spec_tokens=MAMBA_LOOKUP_K))):
            METRICS.__init__()
            kern.reset_launch_counts()
            eng = MambaEngine(model, batch_size=MAMBA_SERVING_B,
                              max_seq_len=MAMBA_SERVING_MAX_SEQ, admit_chunk=CHUNK, **kw)
            slack = eng._spec_iters * (eng.K + 1) + eng.K + 2 if eng._spec else 0
            with ForwardCount(model) as fwd, FrozenRows(eng) as frozen:
                reqs, steps, wall, _ = serve_workload(eng, w, slack)
            launches = launch_counts()
            name = f"mamba_serving {state} {label}"
            diverged = held_to_references(name, model, w, reqs, ref, stop_at, mamba_carry)
            # Plain serving runs generate_mamba's products with a row's bits
            # its own: equal tokens. Lookup verifies through the chunked SSD
            # where decode runs K9 (other sums): near-ties only.
            require(label == "lookup" or not diverged,
                    f"{name}: {len(diverged)} requests left generate_mamba alone")
            want_k9 = layers * fwd.step if label == "plain" else 0
            require(launches[K9] == want_k9 and (label == "lookup") == (fwd.step == 0),
                    f"{name}: K9 launched {launches[K9]} times for {fwd.step} decode forwards "
                    f"of {layers} layers")
            require(frozen.checked > 0 and not frozen.changed,
                    f"{name}: {len(frozen.changed)} of {frozen.checked} frozen rows changed "
                    "in a block")
            for k in (K3, K5):
                require(launches[k] > 0, f"{name}: {k} was not launched")
            runs[label] = {"steps": steps, **serving_metrics(reqs, wall),
                           "decode_forwards": fwd.step, "frozen_rows_checked": frozen.checked,
                           "divergences_at_near_ties": len(diverged),
                           "launches": {k: launches[k] for k in (K9, K3, K5)}}
            del eng
        out["states"][state] = runs
        if bf16_state:
            del model
            torch.cuda.empty_cache()
            continue
        # One HTTP completion through Server(MambaEngine(...)), fp32 state.
        with tempfile.TemporaryDirectory(prefix="mamba_tok_") as tmp:
            (Path(tmp) / "tokenizer.model").write_bytes(
                synthetic_spm(model.args.vocab_size, seed=0))
            tok = load_tokenizer(tmp)
        text = _text_of(tok, np.random.default_rng(11), 300)
        prompt = tok.encode(text, bos=True, eos=False)
        want = generate_mamba([prompt], model, max_tokens=FRONT_MAX_TOKENS, temperature=0.0,
                              chunk_size=CHUNK)[0][0]
        engine = MambaEngine(model, batch_size=2, max_seq_len=MAMBA_SERVING_MAX_SEQ,
                             admit_chunk=CHUNK, eos_id=tok.eos_id)
        with HttpServing(engine, tok) as http:
            reply, _, http_s = _http(http.url, "/v1/completions",
                                     {"prompt": text, "max_tokens": FRONT_MAX_TOKENS})
        rec = next(r for r in engine.slots if r is not None and r.prompt == prompt)
        require(reply["choices"][0]["tokens"] == rec.generated,
                "mamba http: the reply's tokens are not the engine's")
        got = rec.generated + [tok.eos_id] if len(rec.generated) < len(want) else rec.generated
        diverged = divergences(model, [prompt], [got], [want[:len(got)]], mamba_carry)
        for d in diverged:
            emit({"phase": "divergence", "path": "mamba_serving http", **d})
        require(not diverged and got == want[:len(got)],
                "mamba http: the tokens are not generate_mamba's")
        out["http"] = {"prompt_len": len(prompt), "tokens": len(rec.generated), "wall_s": http_s,
                       "divergences_at_near_ties": len(diverged)}
        del model, engine
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


LORA_RANK, LORA_SCALING = 16, 2.0
MAMBA_PROBE_LENS = (1537, 700, 300, 45)  # four rows of phase 11's prompt lengths


class _OpLog:
    """While entered, records the output of every product and step of
    ``models.mamba``'s forward, in call order: the quantized linears
    (``linear``), the dense ``dt_proj`` and head products
    (``fixed_rows_linear``), the conv, the chunked SSD, K9, the gated norm,
    the RMS norms and the head."""

    NAMES = ("linear", "fixed_rows_linear", "_conv", "_ssd_chunked",
             "fused_ssd_step_stacked", "_gated_norm", "rms_norm", "apply_head")

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from mistral_inference_tpu_torch.models import mamba as mm

        self._saved = [(n, getattr(mm, n)) for n in self.NAMES]
        for n, fn in self._saved:
            setattr(mm, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        from mistral_inference_tpu_torch.models import mamba as mm

        for n, fn in self._saved:
            setattr(mm, n, fn)

    def _wrap(self, name, fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            first = out[0] if isinstance(out, tuple) else out
            self.calls.append((name, first.detach().clone()))
            return out
        return call


def fixed_rows_check(model) -> dict:
    """``fixed_rows_linear`` on layer 0's ``dt_proj`` and on the head: a row
    alone against the same row at the first, middle and last place among 4,
    16, 300 and 2048 rows: the differing elements of each, beside plain
    ``F.linear`` compared the same way (for the record)."""
    import torch.nn.functional as F

    from mistral_inference_tpu_torch.ops.linear import ROW_BLOCK, fixed_rows_linear

    gen = torch.Generator(device="cuda").manual_seed(17)
    weights = {"dt_proj": model.params["layers"][0]["dt_proj"], "head": model.params["lm_head"]}
    D = model.args.dim
    x = randn(gen, 2048, D).to(torch.bfloat16)
    out = {"row_block": ROW_BLOCK, "rows": [4, 16, 300, 2048]}
    for name, w in weights.items():
        fixed, plain = {}, {}
        alone = {p: (fixed_rows_linear(x[p:p + 1], w), F.linear(x[p:p + 1], w))
                 for n in out["rows"] for p in (0, n // 2, n - 1)}
        for n in out["rows"]:
            got_f, got_p = fixed_rows_linear(x[:n], w), F.linear(x[:n], w)
            fixed[n] = sum(differ(got_f[p:p + 1], alone[p][0]) for p in (0, n // 2, n - 1))
            plain[n] = sum(differ(got_p[p:p + 1], alone[p][1]) for p in (0, n // 2, n - 1))
        out[name] = {"shape": list(w.shape), "fixed_rows_differing": fixed,
                     "plain_F_linear_differing": plain}
    return out


def mamba_rows_probe(card: str) -> None:
    """Which product of a Mamba forward gives a row other bits in another
    batch, where ``MambaEngine`` would leave ``generate_mamba``: the forwards
    the engine runs for an admission (one 512-wide chunk, the SSD's chunk
    128) and a decode step (T = 1), on the 8-layer int4 ``codestral-mamba-7b``
    of phase 11 with an fp32 state, at B = 4; then row 0 alone (B = 1, as
    ``generate_mamba`` of one prompt runs it) and rows 0-1 alone (B = 2, a
    data rank's rows at data = 2). Every recorded output's rows are compared
    in bits, in call order; the first op that differs, and every op name
    that does, are reported; then ``fixed_rows_check``. Prints its line, then
    requires that no op differ and that fixed_rows_linear keep every row's
    bits."""
    from mistral_inference_tpu_torch.generate import _prompt_chunks

    t0 = time.perf_counter()
    model = mamba_model(8, "int4", False)
    prompts = par_prompts(model.args.vocab_size, MAMBA_PROBE_LENS)

    def run(rows):
        state = model.alloc_state(len(rows))
        logs = []
        for s, tokens, lens in _prompt_chunks([prompts[r] for r in rows], 512, model.device):
            with _OpLog() as log:
                model.forward(tokens, lens, state, chunk=128)
            logs.append(("prefill", s, log.calls))
        ones = torch.ones((len(rows),), dtype=torch.int32, device=model.device)
        with _OpLog() as log:  # one decode step on token 1
            model.forward(ones[:, None], ones, state, chunk=1)
        logs.append(("decode", 0, log.calls))
        return logs

    whole = run([0, 1, 2, 3])
    out = {"phase": "mamba_rows_probe", "card": card, "model": MAMBA_MODEL, "layers": 8,
           "weights": "int4 (seed 0)", "state": "fp32", "prompt_lens": MAMBA_PROBE_LENS,
           "admission_chunk": 512, "ssd_chunk": 128, "compared": {}}
    problems = []
    for label, rows in (("B1_row0_vs_B4", [0]), ("B2_rows01_vs_B4", [0, 1])):
        part = run(rows)
        res = []
        for (kind, s, calls), (_, _, wcalls) in zip(part, whole):
            layer, first, differing = -1, None, {}
            for (name, t), (_, w) in zip(calls, wcalls):
                if name == "rms_norm" and first is None:
                    layer += 1  # each layer starts with its norm; 8 is the final norm
                n = differ(t, w[:len(rows)])
                if n:
                    differing[name] = differing.get(name, 0) + 1
                    if first is None:
                        first = {"op": name, "layer": layer, "elements": n,
                                 "of": t.numel()}
            res.append({"forward": kind, "chunk_start": s, "first_differing": first,
                        "ops_differing": differing, "calls": len(calls)})
            if first is not None:
                problems.append(f"{label} {kind} chunk {s}: {first}")
        out["compared"][label] = res
    out["fixed_rows"] = fixed = fixed_rows_check(model)
    for name in ("dt_proj", "head"):
        if any(fixed[name]["fixed_rows_differing"].values()):
            problems.append(f"fixed_rows_linear on {name}: {fixed[name]}")
    out["seconds"] = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    emit(out)  # printed before the check, so that a failure shows the ops
    require(not problems, "mamba rows: a row's bits moved with the rows beside it: "
                          + "; ".join(problems))


LORA_FAMILIES = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")
LORA_TOKENS = 24


def lora_adapter(args, path: Path, seed: int, experts: int = 0) -> Path:
    """A rank-16 adapter file from ``seed`` for wq, wk, wv, wo, w1, w2 and w3
    of every layer (each expert's w1, w2, w3 with ``experts``): lora_A
    N(0, 1) / sqrt(in), lora_B N(0, 0.025^2), so that the scaled delta is
    about a fifth of a weight."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    D, F, q, kv = args.dim, args.hidden_dim, args.n_heads * args.head_dim, \
        args.n_kv_heads * args.head_dim
    shapes = {"wq": (D, q), "wk": (D, kv), "wv": (D, kv), "wo": (q, D), "w1": (D, F),
              "w2": (F, D), "w3": (D, F)}
    sd = {}
    for i in range(args.n_layers):
        for name in LORA_FAMILIES:
            din, dout = shapes[name]
            attention = name in ("wq", "wk", "wv", "wo")
            bases = ([f"layers.{i}.{'attention' if attention else 'feed_forward'}.{name}"]
                     if attention or not experts else
                     [f"layers.{i}.feed_forward.experts.{e}.{name}" for e in range(experts)])
            for base in bases:
                sd[base + ".lora_A.weight"] = randn(gen, LORA_RANK, din).float() * din ** -0.5
                sd[base + ".lora_B.weight"] = randn(gen, dout, LORA_RANK).float() * 0.025
    from mistral_inference_tpu_torch.io.safetensors import save_file

    save_file(sd, path)
    return path


def lora_phase(card: str, workdir: Path) -> dict:
    """Phase 12: LoRA on phase 9's 8-layer mistral-7b-v0.1 folder with a
    rank-16 adapter from seed 14: ``main quantize --quant int4 --lora_path``
    exports quantize(merge_lora(dense)) in bits; ``main demo --lora_path``
    prints generate()'s text of the merged model; a folder whose params.json
    has ``lora`` (live pairs, int4, an fp8 ring) gives with a zero adapter the
    bits of the model without them, and with the adapter loaded decode ==
    prefill and prompt-lookup speculation through K7-fp8 with plain greedy's
    tokens (but at a near-tie); live against merged on a bf16 base; then
    ``mixtral-8x7b`` at 2 layers, int4, ``moe_impl="dispatch"``, with live
    expert adapters: decode == prefill and K8 and K5 launched."""
    import contextlib
    import io
    import os

    import numpy as np

    from mistral_inference_tpu_torch.args import LoraArgs
    from mistral_inference_tpu_torch.generate import generate
    from mistral_inference_tpu_torch.lora import load_lora
    from mistral_inference_tpu_torch.main import DEMO_PROMPTS
    from mistral_inference_tpu_torch.main import main as cli
    from mistral_inference_tpu_torch.model import Transformer, from_folder
    from mistral_inference_tpu_torch.models.registry import get_args
    from mistral_inference_tpu_torch.ops import cuda as kern
    from mistral_inference_tpu_torch.tokenizers import load_tokenizer

    t_phase = time.perf_counter()
    args = front_args()
    ref = workdir / "reference"
    if not (ref / "consolidated.safetensors").is_file():
        write_front_folder(ref, args)
    out = {"phase": "lora", "model": MODEL, "layers": FRONT_LAYERS, "card": card,
           "adapter": f"rank {LORA_RANK}, scaling {LORA_SCALING}, {', '.join(LORA_FAMILIES)} "
                      "of every layer, seed 14"}
    adapter = lora_adapter(args, workdir / "adapter.safetensors", seed=14)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, args.vocab_size, n).tolist() for n in SPEC_PROMPT_LENS]
    block = prompts[1][:REPEATED_BLOCK]
    prompts[1] = (block * (len(prompts[1]) // REPEATED_BLOCK + 1))[:len(prompts[1])]

    def run(p, model, **kw):
        return generate(p, model, temperature=0.0, chunk_size=CHUNK, **kw)

    # 1. The merged bf16 model; main demo --lora_path prints its text.
    merged = from_folder(ref)
    load_lora(merged, adapter, scaling=LORA_SCALING)
    tok = load_tokenizer(ref)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli(["demo", str(ref), "--max_tokens", "8", "--lora_path", str(adapter)])
    encoded = [tok.encode(p, bos=True, eos=False) for p in DEMO_PROMPTS]
    gen, _ = generate(encoded, merged, max_tokens=8, temperature=0.0)
    require(buf.getvalue() == "".join(p + tok.decode(g) + "\n" + "=" * 40 + "\n"
                                      for p, g in zip(DEMO_PROMPTS, gen)),
            "demo --lora_path: the printed text is not generate()'s of the merged model")

    # 2. Live against merged, on a bf16 base.
    live_dir = workdir / "live"
    live_dir.mkdir(exist_ok=True)
    params = json.loads((ref / "params.json").read_text())
    params["lora"] = {"rank": LORA_RANK, "scaling": LORA_SCALING}
    (live_dir / "params.json").write_text(json.dumps(params))
    for name in ("consolidated.safetensors", "tokenizer.model"):
        if not (live_dir / name).exists():
            os.symlink(ref / name, live_dir / name)
    live = from_folder(live_dir)
    load_lora(live, adapter)
    (g_merged, lp_merged) = run(prompts, merged, max_tokens=LORA_TOKENS)
    (g_live, _) = run(prompts, live, max_tokens=LORA_TOKENS)
    diverged = divergences(merged, prompts, g_live, g_merged)
    near_ties("lora live-vs-merged", diverged)
    full = [p + g for p, g in zip(prompts, g_merged)]
    tf_m = run(full, merged, max_tokens=0)[1]
    tf_l = run(full, live, max_tokens=0)[1]
    gap = np.concatenate([np.abs(np.array(a) - np.array(b)) for a, b in zip(tf_m, tf_l)])
    out["live_vs_merged"] = {"max_nats": float(gap.max()), "mean_nats": float(gap.mean()),
                             "divergences_at_near_ties": len(diverged)}
    require(gap.max() <= INVARIANT_MAX_NATS and gap.mean() <= INVARIANT_MEAN_NATS,
            f"lora: live and merged teacher-forced logprobs {out['live_vs_merged']}")
    del live
    torch.cuda.empty_cache()

    # 3. main quantize --lora_path: quantize(merge_lora(dense)) in bits.
    exp = workdir / "lora_int4"
    t = time.perf_counter()
    cli(["quantize", str(ref), str(exp), "--quant", "int4", "--lora_path", str(adapter)])
    out["quantize_s"] = time.perf_counter() - t
    merged.quantize("int4")
    same_tree(merged.params, from_folder(exp).params)
    del merged
    torch.cuda.empty_cache()

    # 4. Live pairs, int4, an fp8 ring: zero pairs change no bit.
    plain_q = from_folder(ref, quant="int4", kv_quant="fp8")
    live_q = from_folder(live_dir, quant="int4", kv_quant="fp8")
    require(live_q.args.lora == LoraArgs(LORA_RANK, LORA_SCALING)
            and "lora" in live_q.params["layers"][0], "the live folder has no live pairs")
    g0, lp0 = run(prompts, plain_q, max_tokens=LORA_TOKENS)
    g1, lp1 = run(prompts, live_q, max_tokens=LORA_TOKENS)
    require(g0 == g1 and lp0 == lp1, "a zero adapter changed the tokens or logprobs")
    del plain_q
    torch.cuda.empty_cache()

    # 5. The adapter live: decode == prefill; lookup speculation through K7-fp8.
    load_lora(live_q, adapter)
    (g, lps) = run(prompts, live_q, max_tokens=LORA_TOKENS)
    require(g != g1, "the live adapter did not change the tokens")
    tf_q = run([p + x for p, x in zip(prompts, g)], live_q, max_tokens=0)[1]
    gap = np.concatenate([np.abs(np.array(a[-len(x):]) - np.array(b[-len(x):]))
                          for a, b, x in zip(lps, tf_q, g)])
    out["live_int4_invariant"] = {"max_nats": float(gap.max()), "mean_nats": float(gap.mean())}
    require(gap.max() <= INVARIANT_MAX_NATS and gap.mean() <= INVARIANT_MEAN_NATS,
            f"lora: live int4 decode != prefill: {out['live_int4_invariant']}")
    kern.reset_launch_counts()
    with AcceptLog() as log:
        (spec, _) = run(prompts, live_q, max_tokens=LORA_TOKENS, draft_model="lookup",
                        spec_tokens=SPEC_SERVING_K)
    launches = launch_counts()
    require(log.verify_forwards > 0
            and launches[K7F] == FRONT_LAYERS * log.verify_forwards,
            f"lora lookup: K7-fp8 launched {launches[K7F]} times for {log.verify_forwards} "
            f"verify forwards")
    # The adapters' products are cuBLAS's, whose kernel follows the row
    # count: a verify chunk's B x (K + 1) rows round them otherwise than a
    # decode step's B.
    spec_div = divergences(live_q, prompts, spec, g)
    near_ties("lora lookup", spec_div)
    out["live_lookup"] = {"verify_forwards": log.verify_forwards,
                          "mean_accepted_drafts": float(np.concatenate(log.accepts).mean()),
                          "divergences_at_near_ties": len(spec_div),
                          "launches": {k: launches[k] for k in (K7F, K2F, K3, K5)}}
    del live_q
    torch.cuda.empty_cache()

    # 6. Mixtral, 2 layers, int4, dispatch, live expert adapters.
    margs = get_args(MOE_MODEL)
    margs.n_layers, margs.moe_impl = 2, "dispatch"
    margs.lora = LoraArgs(LORA_RANK, LORA_SCALING)
    moe = Transformer.random(margs, dtype=torch.bfloat16, seed=0, quant="int4")
    load_lora(moe, lora_adapter(margs, workdir / "moe_adapter.safetensors", seed=15,
                                experts=margs.moe.num_experts))
    require(bool(moe.params["layers"][0]["lora"]["w2"]["b"].abs().sum() > 0),
            "the expert adapters did not load")
    moe_prompts = [rng.integers(1, margs.vocab_size, n).tolist() for n in (700, 45)]
    kern.reset_launch_counts()
    (g, lps) = run(moe_prompts, moe, max_tokens=16)
    launches = launch_counts()
    tf_moe = run([p + x for p, x in zip(moe_prompts, g)], moe, max_tokens=0)[1]
    gap = np.concatenate([np.abs(np.array(a[-len(x):]) - np.array(b[-len(x):]))
                          for a, b, x in zip(lps, tf_moe, g)])
    out["mixtral_live_experts"] = {
        "layers": 2, "moe_impl": "dispatch", "max_nats": float(gap.max()),
        "mean_nats": float(gap.mean()),
        "bound": (MOE_INVARIANT_MAX_NATS, MOE_INVARIANT_MEAN_NATS),
        "launches": {k: launches[k] for k in (K8, K5, K3)}}
    require(gap.max() <= MOE_INVARIANT_MAX_NATS and gap.mean() <= MOE_INVARIANT_MEAN_NATS,
            f"lora mixtral: decode != prefill: {out['mixtral_live_experts']}")
    require(launches[K8] > 0 and launches[K5] > 0,
            f"lora mixtral: K8 {launches[K8]}, K5 {launches[K5]} launches")
    del moe
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


def row_count_probe(gen):
    """Does an operation of the verify forward give a row the same bits among
    20 rows (B = 4 x T = 5) or 32 as among 4 (a decode step)? Greedy
    speculation equals greedy decoding token for token only if every one
    does. K3 must (its split over K follows the shape alone), also among 128
    and 256 rows (a prefill chunk); the others are PyTorch's and are
    reported."""
    import torch.nn.functional as F

    from mistral_inference_tpu_torch.ops.cuda.matmul_quant import matmul_quant
    from mistral_inference_tpu_torch.ops.norm import rms_norm

    bf = torch.bfloat16
    same = {}
    k3_ms = {n: 0.0 for n in (4, 8, 20, 32, 128, 256)}  # sums over one layer's four int4 linears
    # The rows past 32 come from a generator of their own, so that later
    # phases draw what they drew before.
    own = torch.Generator(device="cuda").manual_seed(128)
    for name, K, N in LINEARS:
        q, scale = quant_stack(gen, 1, K, N, 4)
        x = torch.cat([randn(gen, 32, K, dtype=bf), randn(own, 224, K, dtype=bf)])
        few = matmul_quant(x[:4].contiguous(), q[0], scale[0])
        for rows in (20, 32, 128, 256):
            many = matmul_quant(x[:rows].contiguous(), q[0], scale[0])
            same[f"K3 int4 {name} rows4==rows{rows}"] = bool(torch.equal(few, many[:4]))
        for rows in k3_ms:
            xr = x[:rows].contiguous()
            k3_ms[rows] += timed_ms(lambda: matmul_quant(xr, q[0], scale[0]), reps=5)
        del q, scale
    x = randn(gen, 32, 4096, dtype=bf)
    head = randn(gen, 32000, 4096, dtype=bf) * 4096**-0.5
    w = torch.ones((4096,), dtype=bf, device="cuda")
    for rows in (15, 20, 32):
        n = rows // 5  # the decode step of that batch
        same[f"cuBLAS head rows{n}==rows{rows}"] = bool(torch.equal(
            F.linear(x[:n], head), F.linear(x[:rows], head)[:n]))
        same[f"rms_norm rows{n}==rows{rows}"] = bool(torch.equal(
            rms_norm(x[:n], w, 1e-5), rms_norm(x[:rows], w, 1e-5)[:n]))
    torch.cuda.synchronize()
    for key, ok in same.items():
        require(ok or not key.startswith("K3"), f"{key}: K3's bits depend on the row count")
    return {"phase": "row_count_probe", "same_bits": same,
            "k3_layer_ms_by_rows": {str(k): v for k, v in k3_ms.items()},
            "k3_note": "K3 over one layer's four int4 linears: up to 128 rows read each "
                       "weight once, 129-256 twice"}


def kernel_ms(prof, calls: int = 1):
    """Kernel time per call by category from a torch.profiler run, and in
    all (kernel events only: an operator's entry repeats its kernels')."""
    cats, top = {}, []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = getattr(ev, "self_device_time_total", 0.0) / 1e3 / calls
        name = ev.key.lower()
        # K1, K4 and K10 are instantiations of flash_hopper_kernel<KT,
        # kScaled, D, kSegment, kChunk>: K10 at D = 64 with kSegment, K1 with
        # kChunk.
        if "flash_hopper" in name:
            cat = ("K10 segment flash" if ", 64, true" in name
                   else "K1 flash_hopper" if "false, true>" in name else "K4 flash_hopper")
            cats[cat] = cats.get(cat, 0.0) + ms
            top.append((ms, ev.key[:80]))
            continue
        # K2, K7 and K6 are instantiations of decode_hopper_kernel<KT,
        # kScaled, kWrite, kRG, kNT>: K2 and K7 with the ring write.
        if "decode_hopper_kernel<" in name:
            write = name.split("decode_hopper_kernel<", 1)[1].split(", ")[2] == "true"
            cat = "K2/K7 fused_decode" if write else "K6 decode_hopper"
            cats[cat] = cats.get(cat, 0.0) + ms
            top.append((ms, ev.key[:80]))
            continue
        # K3 and K8 are instantiations of dequant_mma_kernel<kMode, kNTW, kRG,
        # kStrips, kSkipEmpty>: K8 with the empty-expert skip.
        if "dequant_mma_kernel<" in name:
            skip = name.split("dequant_mma_kernel<", 1)[1].split(">", 1)[0].endswith("true")
            cat = "K8 moe_expert_matmul" if skip else "K3 matmul_quant"
            cats[cat] = cats.get(cat, 0.0) + ms
            top.append((ms, ev.key[:80]))
            continue
        cat = next((c for k, c in (("moe_matmul", "K5 moe_matmul"),
                                   ("ssd_step", "K9 ssd_step"),
                                   ("gemm", "matmul"),
                                   ("gemv", "matmul"), ("xmma", "matmul"), ("cutlass", "matmul"),
                                   ("nvjet", "matmul"), ("splitkreduce", "matmul")) if k in name),
                   "other")
        cats[cat] = cats.get(cat, 0.0) + ms
        top.append((ms, ev.key[:80]))
    return sum(cats.values()), dict(sorted(cats.items(), key=lambda kv: -kv[1])), sorted(top)[::-1]


def profile_generate(model, prompts, generate_fn):
    """Where the time goes. Prefill: ``generate_fn(max_tokens=0)`` over all
    prompts under torch.profiler, its wall time, kernel time by category and
    the card's idle share (1 - kernel time / wall; one stream, kernels do not
    overlap). Decode: decode_step_probe."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    generate_fn(prompts, model, chunk_size=CHUNK, temperature=0.0, max_tokens=0)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        generate_fn(prompts, model, chunk_size=CHUNK, temperature=0.0, max_tokens=0)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    busy, cats, top = kernel_ms(prof)
    return {
        "prefill_all_prompts": {
            "wall_ms": wall, "kernel_ms": busy, "device_idle_share": 1.0 - busy / wall,
            "kernel_ms_by_category": cats,
            "top_kernels_ms": [[round(ms, 3), k] for ms, k in top[:12]],
        },
        "decode_step": decode_step_probe(model, len(prompts)),
    }


def decode_step_probe(model, B: int, fill: int = 3000, steps: int = 10):
    """One decode step (model.forward, T=1) at B rows: over rings holding
    ``fill`` tokens for a Transformer; for a Mamba over the state a 512-token
    prefill leaves (its step's work does not depend on how many tokens are
    behind it). step_probe measures it."""
    dev = model.device
    # A token of its own for each row, so that an MoE layer routes them apart.
    tok = torch.arange(1, B + 1, dtype=torch.long, device=dev)[:, None]
    ones = torch.ones((B,), dtype=torch.int32, device=dev)
    if hasattr(model, "alloc_state"):
        state = model.alloc_state(B)
        prompt = torch.randint(1, model.args.vocab_size, (B, CHUNK), device=dev)
        model.forward(prompt, torch.full((B,), CHUNK, device=dev), state, chunk=128)
        return {"state_after_prefill_of": CHUNK, **step_probe(
            lambda: model.forward(tok, ones, state, chunk=1), lambda: None, B, steps)}
    cache = model.alloc_cache(B, fill + 2 * steps + 16)
    start = torch.full((B,), fill, dtype=torch.int32, device=dev)
    cache.kv_len = start
    return {"fill": fill, **step_probe(lambda: model.forward(tok, ones, cache),
                                       lambda: setattr(cache, "kv_len", start), B, steps)}


def step_probe(step, reset, B: int, steps: int):
    """A decode step's aten calls; the host's time to enqueue it (median of
    ``steps``, each started with the card idle); the wall time per step of
    ``steps`` steps in a row; and its kernel time by category
    (torch.profiler). ``reset`` rewinds what the steps advanced. Enqueue time
    above kernel time means the host bounds decode, and the card idles for
    the difference."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        calls = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.calls += 1
            return func(*args, **(kwargs or {}))

    for _ in range(3):
        step()
    with Count():
        step()
    enqueue = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step()
        enqueue.append(1e3 * (time.perf_counter() - t))
    reset()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t) / steps
    reset()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    busy, cats, _ = kernel_ms(prof, steps)
    return {"rows": B, "aten_calls": Count.calls,
            "host_enqueue_ms": statistics.median(enqueue), "wall_ms": wall, "kernel_ms": busy,
            "device_idle_share": 1.0 - busy / wall, "kernel_ms_by_category": cats}


# ---------------------------------------------------------------------------
# Phase 13: many GPUs (parallel/): an NCCL world of one, then two gloo ranks
# sharing the one card
# ---------------------------------------------------------------------------

PAR_PROMPT_LENS = (600, 300, 77, 20)  # the first two take more than one chunk: K4 runs
PAR_ODD_LENS = (77, 45, 20)  # one unchunked prefill of 77 tokens, which seq = 2 does not divide
PAR_CHUNK = 256
PAR_TOKENS = 12
# Every path is held to the single-device port's tokens and logprobs in
# bits: a tensor-sharded linear keeps its whole K and gathers activations,
# never partial sums (K3 with the whole weight's split), a seq rank runs its
# queries through K1 and K4 against the whole chunk, a data rank its rows,
# an expert rank adds exact zeros for the experts it does not hold. A wrong
# shard, one device with each layer's ``wo`` and ``w2`` output halves
# swapped (what tensor = 2 computes if each rank held the other's shard),
# is the negative control: it must leave those bits.
PAR_ENGINE_LENS = (300, 180, 120, 90, 64, 40, 24, 12)
PAR_ENGINE_TOKENS = 10
PAR_LOOKUP_K = 7
PAR_LORA_RANK = 16
PAR_TIMEOUT_S = 900
PAR_SHAPES_PER_KERNEL = 4  # distinct shapes of one wrapper kept for replay per path


class ParPath(NamedTuple):
    label: str
    model: str
    layers: int
    ring: Optional[str]  # the KV ring's type; None for a Mamba
    mesh: Tuple[int, int, int, int]  # (data, seq, expert, tensor)
    expected: Tuple[str, ...]  # kernels each rank must launch
    per_decode: Tuple[str, ...]  # kernels launched exactly layers x decode forwards
    # What the path runs beside greedy generate() ("generate"): an Engine
    # on PAR_ENGINE_LENS, lookup speculation, the odd-chunk prompts, a
    # staggered Engine and MambaEngine (``par_engine_workload``).
    runs: Tuple[str, ...] = ("generate",)
    lora: bool = False  # live LoRA pairs of rank PAR_LORA_RANK, filled from seed 1
    ref: Optional[str] = None  # the path whose model (and one-device run) this one shares


PAR_PATHS = (
    # the north-star configuration, all 32 layers, tensor = 2
    ParPath("a", MODEL, 32, "fp8", (1, 1, 1, 2), (K1, K4F, K5, K3, K2F, K7F), (K2F,),
            ("generate", "engine", "lookup")),
    ParPath("b", MOE_MODEL, 32, "int8", (1, 1, 2, 1), (K5, K8), ()),
    # the experts' stacks sharded on their columns: w13 on F, w2 on D
    ParPath("h", MOE_MODEL, 2, "int8", (1, 1, 1, 2), (K1, K4, K5, K8, K3, K2), (K2,)),
    ParPath("c", MAMBA_MODEL, 8, None, (1, 1, 1, 2), (K9,), (K9,)),
    ParPath("d", MODEL, 8, "int8", (2, 1, 1, 1), (K1, K4, K2, K3, K5), (K2,)),
    # the same model as (a), its prefill chunks split over seq = 2
    ParPath("e", MODEL, 32, "fp8", (1, 2, 1, 1), (K1, K4F, K5, K3, K2F), (K2F,),
            ("generate", "odd", "engine"), ref="a"),
    # the serving engines over data = 2: (d)'s model, and an 8-layer Mamba
    ParPath("f", MODEL, 8, "int8", (2, 1, 1, 1), (K1, K4, K2, K3, K5, K9), (),
            ("staggered",), ref="d"),
    ParPath("g", MODEL, 8, "fp8", (1, 1, 1, 2), (K1, K4F, K5, K3, K2F), (K2F,), lora=True),
)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _par_args(path: ParPath, layers: Optional[int] = None):
    from mistral_inference_tpu_torch.args import LoraArgs
    from mistral_inference_tpu_torch.models.registry import get_args

    args = get_args(MAMBA_MODEL if path.ring is None else path.model)
    args.n_layers = path.layers if layers is None else layers
    if path.ring is not None:
        args.kv_quant = path.ring
        if args.moe:
            args.moe_impl = "dispatch"
        if path.lora:
            args.lora = LoraArgs(rank=PAR_LORA_RANK, scaling=2.0)
    return args


def par_model(path: ParPath, mesh=None, layers: Optional[int] = None):
    """The path's model, int4 weights drawn in bf16 from seed 0 (under a
    mesh: this rank's shard of it; with ``layers``, cut to that depth: its
    first layers are the full model's); live LoRA pairs filled from seed 1."""
    from mistral_inference_tpu_torch.model import Mamba, Transformer

    args = _par_args(path, layers)
    if path.ring is None:
        return Mamba.random(args, dtype=torch.bfloat16, seed=0, quant="int4", mesh=mesh)
    model = Transformer.random(args, dtype=torch.bfloat16, seed=0, quant="int4", mesh=mesh)
    if path.lora:
        g = torch.Generator(device=model.device).manual_seed(1)
        for lw in model.params["layers"]:
            for name in sorted(lw["lora"]):
                for leaf in ("a", "b"):
                    t = lw["lora"][name][leaf]
                    t.copy_(0.05 * torch.randn(t.shape, generator=g, device=t.device,
                                               dtype=torch.float32))
    return model


def par_prompts(vocab_size: int, lens=PAR_PROMPT_LENS):
    import numpy as np

    rng = np.random.default_rng(13)
    return [rng.integers(1, vocab_size, n).tolist() for n in lens]


def par_generate(model, prompts, max_tokens: int = PAR_TOKENS, **kw):
    from mistral_inference_tpu_torch.generate import generate, generate_mamba

    run = generate_mamba if hasattr(model, "alloc_state") else generate
    return run(prompts, model, max_tokens=max_tokens, temperature=0.0,
               chunk_size=kw.pop("chunk_size", PAR_CHUNK), **kw)


def par_engine_workload(vocab_size: int):
    """(prompt, max_tokens) of eight requests for four slots: two long rows
    (data rank 0's), two short ones, then two sharing 600 and 520 tokens
    with the long rows (prefix copies from rank 0 into rank 1's rows) and
    two alone (a staged row each)."""
    base = par_prompts(vocab_size, (700, 640, 300, 90, 40, 30))
    return [(base[0], 24), (base[1], 24), (base[2], 4), (base[3], 4),
            (base[0][:600] + base[4], 6), (base[1][:520] + base[5], 6),
            (base[4], 5), (base[5], 5)]


def par_staggered(engine, workload) -> list:
    """Four requests, two more after a step, the last two after one more
    each; every request's tokens."""
    ids, done = [], {}
    for i, (p, n) in enumerate(workload):
        if i in (4, 6, 7):
            done.update({ev.request_id: engine._result(ev.request_id)
                         for ev in engine.step() if ev.finished})
        ids.append(engine.submit(p, max_tokens=n))
    done.update(engine.run_to_completion())
    return [done[i] for i in ids]


def par_runs(path: ParPath, model, mesh=None) -> dict:
    """Everything ``path.runs`` asks of ``model``: the same on one device and
    on a rank."""
    from mistral_inference_tpu_torch.model import Mamba
    from mistral_inference_tpu_torch.server.engine import Engine
    from mistral_inference_tpu_torch.server.mamba_engine import MambaEngine
    from mistral_inference_tpu_torch.utils.profiling import METRICS

    out, V = {}, model.args.vocab_size
    if "engine" in path.runs:
        eng = Engine(model, batch_size=4, max_seq_len=max(PAR_ENGINE_LENS) + PAR_ENGINE_TOKENS + 8)
        ids = [eng.submit(p, max_tokens=PAR_ENGINE_TOKENS)
               for p in par_prompts(V, PAR_ENGINE_LENS)]
        t = time.perf_counter()
        done = eng.run_to_completion()
        out["engine"] = {"tokens": [done[i] for i in ids], "s": time.perf_counter() - t}
        del eng
    if "lookup" in path.runs:
        k7, before = K7F if path.ring == "fp8" else K7, launch_counts()
        with AcceptLog() as log:
            out["lookup"] = par_generate(model, par_prompts(V), draft_model="lookup",
                                         spec_tokens=PAR_LOOKUP_K)
        out["lookup_k7"] = {"verify_forwards": log.verify_forwards,
                            "launches": launch_counts()[k7] - before[k7]}
    if "odd" in path.runs:
        out["odd"] = par_generate(model, par_prompts(V, PAR_ODD_LENS), chunk_size=None)
    if "staggered" in path.runs:
        work = par_engine_workload(V)
        hits, staged = METRICS.counters["prefix_hits"], METRICS.counters["staged_admissions"]
        t = time.perf_counter()
        tokens = par_staggered(Engine(model, batch_size=4, max_seq_len=800, decode_block=4,
                                      admit_waterline=1, staging_batch=2), work)
        out["engine"] = {"tokens": tokens, "s": time.perf_counter() - t,
                         "prefix_hits": METRICS.counters["prefix_hits"] - hits,
                         "staged": METRICS.counters["staged_admissions"] - staged}
        mamba = Mamba.random(_par_args(next(p for p in PAR_PATHS if p.ring is None), 8), dtype=torch.bfloat16, seed=0,
                             quant="int4", mesh=mesh)
        t = time.perf_counter()
        tokens = par_staggered(MambaEngine(mamba, batch_size=4, max_seq_len=800,
                                           decode_block=4), work)
        out["mamba_engine"] = {"tokens": tokens, "s": time.perf_counter() - t}
        del mamba
    return out


def teacher_logits(model, prompts, gen, chunk: int = PAR_CHUNK) -> torch.Tensor:
    """(B, steps, V) fp32 on the host: the logits that predict each generated
    token in a teacher-forced prefill of prompt + generated tokens."""
    from mistral_inference_tpu_torch.generate import _prompt_chunks

    seqs = [p + g for p, g in zip(prompts, gen)]
    steps = len(gen[0])
    out = torch.zeros((len(seqs), steps, model.args.vocab_size))
    mamba = hasattr(model, "alloc_state")
    state = model.alloc_state(len(seqs)) if mamba else model.alloc_cache(
        len(seqs), max(len(s) for s in seqs))
    for s, tokens, lens in _prompt_chunks(seqs, chunk, model.device):
        T = tokens.shape[1]
        if mamba:
            hidden = model.forward(tokens, lens, state, chunk=min(128, T), head="none")
        else:
            hidden = model.forward(tokens, lens, state, attend_cache=s > 0, head="none")
        for b, p in enumerate(prompts):
            for step in range(steps):
                pos = len(p) - 1 + step
                if s <= pos < s + T:
                    out[b, step] = model.head(hidden[b, pos - s]).float().cpu()
    return out


def par_logprob_gap(got_lps, ref_lps):
    """max and mean |sharded - single-device| over every logprob of rows
    whose lengths agree."""
    gaps = [abs(x - y) for a, b in zip(got_lps, ref_lps) for x, y in zip(a, b)]
    return max(gaps), sum(gaps) / len(gaps)


def param_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(param_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if isinstance(tree, torch.Tensor) else 0


def nccl_world_of_one(card: str) -> dict:
    """A world of one rank over NCCL on the card (the backend the rule of
    ``parallel.distributed`` gives one rank with one GPU), at ``tensor=1``:
    the 8-layer int4 path of phase 4 with and without the mesh, equal in
    bits. An axis of one issues no collective, so the forward's count is 0;
    the NCCL calls themselves are probed on the world group."""
    import os

    import torch.distributed as dist

    from mistral_inference_tpu_torch.parallel.distributed import init_distributed
    from mistral_inference_tpu_torch.parallel.mesh import make_mesh

    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
               MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()))
    os.environ.update(env)
    t0 = time.perf_counter()
    try:
        require(init_distributed(timeout_s=120), "the world of one did not start")
        backend = dist.get_backend()
        require(backend == "nccl", f"one rank with one GPU took {backend}, not NCCL")
        mesh = make_mesh(1, 1, 1)
        path = ParPath("nccl1", MODEL, 8, "int8", (1, 1, 1, 1), (), ())
        plain, meshed = par_model(path), par_model(path, mesh)
        prompts = par_prompts(plain.args.vocab_size)
        want = par_generate(plain, prompts)
        mesh.reset_counts()
        got = par_generate(meshed, prompts)
        require(got == want, "the mesh of one changed the tokens or the logprobs")
        forward_collectives = dict(mesh.counts)
        x = torch.full((1024,), 3.0, dtype=torch.bfloat16, device=mesh.device)
        dist.all_reduce(x)
        parts = [torch.empty(8, device=mesh.device)]
        dist.all_gather(parts, torch.full((8,), 2.0, device=mesh.device))
        torch.cuda.synchronize()
        require(bool((x == 3).all()) and bool((parts[0] == 2).all()),
                "NCCL's all_reduce or all_gather in a world of one changed its input")
        del plain, meshed
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
    torch.cuda.empty_cache()
    return {"phase": "parallel_nccl_world_of_one", "backend": backend, "model": MODEL,
            "layers": 8, "weights": "int4 (seed 0)", "ring": "int8", "mesh": [1, 1, 1, 1],
            "equal_bits_to_no_mesh": True, "forward_collectives": forward_collectives,
            "probe": "dist.all_reduce (bf16) and dist.all_gather (fp32) on the NCCL world "
                     "group: unchanged values",
            "seconds": time.perf_counter() - t0, "card": card}


# The wrappers a sharded forward calls, by module and name, and the plain
# version each is held to (called with the wrapper's arguments).
def _plain_versions():
    from mistral_inference_tpu_torch.ops.cuda import attention as att
    from mistral_inference_tpu_torch.ops.cuda import matmul_quant as mq
    from mistral_inference_tpu_torch.ops.cuda import moe_matmul as mm
    from mistral_inference_tpu_torch.ops.cuda import ssd_step as ss

    def flash(q, k, v, qp, kp, qv, kvv, window, return_stats=False):
        o, m, l = att.attend_stats_plain(q, k, v, None, None, qp, kp, qv, kvv, int(window))
        return (o, m, l) if return_stats else o.reshape(*o.shape[:2], -1)

    def ring(q, kq, vq, ks, vs, qp, kp, qv, kvv, window):
        B, S, D = q.shape[0], kq.shape[1], q.shape[-1]
        Hkv = kq.shape[2] // D
        return att.attend_stats_plain(q, kq.reshape(B, S, Hkv, D), vq.reshape(B, S, Hkv, D),
                                      ks, vs, qp, kp, qv, kvv, int(window))

    return {
        "flash_attention": flash,
        "ring_attention_stats": ring,
        "fused_update_decode_attention": att.fused_update_decode_attention_plain,
        "fused_verify_chunk_attention": att.fused_verify_chunk_attention_plain,
        "matmul_quant": lambda x, q, s, split_n=None: mq.matmul_quant_plain(x, q, s),
        "matmul_quant_stacked": lambda x, q, s, li: mq.matmul_quant_plain(x, q[li], s[li]),
        "moe_matmul_quant_ragged": mm.moe_matmul_quant_ragged_plain,
        "moe_matmul_quant": mm.moe_matmul_quant_plain,
        "moe_matmul_quant_stacked": lambda x, q, s, li: mm.moe_matmul_quant_plain(
            x, q[li], s[li]),
        "fused_ssd_step_stacked": ss.fused_ssd_step_stacked_plain,
    }


# (module, wrapper name) pairs a forward resolves its kernels through
SHARD_CALL_SITES = (
    ("models.transformer", "flash_attention"), ("models.transformer", "ring_attention_stats"),
    ("models.transformer", "fused_update_decode_attention"),
    ("models.transformer", "fused_verify_chunk_attention"),
    ("models.transformer", "moe_matmul_quant"), ("models.transformer", "moe_matmul_quant_ragged"),
    ("models.transformer", "moe_matmul_quant_stacked"),
    ("ops.linear", "matmul_quant"), ("ops.linear", "matmul_quant_stacked"),
    ("ops.linear", "moe_matmul_quant_ragged"), ("models.mamba", "fused_ssd_step_stacked"),
)
# wrappers whose column-shard outputs are held to the whole weight's columns
SHARD_WHOLE = ("matmul_quant", "moe_matmul_quant_ragged", "moe_matmul_quant")
# wrapper -> the arguments it writes in place (ring stacks and scales; the SSD state)
SHARD_WRITES = {"fused_update_decode_attention": (3, 4, 5, 6),
                "fused_verify_chunk_attention": (3, 4, 5, 6), "fused_ssd_step_stacked": (4,)}


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    return x


def _sig(args) -> str:
    return " ".join(f"{tuple(a.shape)}:{str(a.dtype).removeprefix('torch.')}"
                    for a in args if isinstance(a, torch.Tensor))


def whole_leaves(path: ParPath, mesh) -> list:
    """(whole leaf, its fused part sizes, its shard on this rank) of every
    tensor-sharded quantized linear (or expert stack) of layer 0 of the
    path's model, drawn on one device from the same seed (a one-layer
    model's layer is the first layer of the deep one)."""
    from mistral_inference_tpu_torch.parallel.sharding import shard_columns

    if mesh.tensor == 1 or mesh.expert > 1:
        return []
    args = _par_args(path, 1)
    lw = par_model(path, layers=1).params["layers"][0]
    if path.ring is None:
        di, gd = args.d_inner, args.n_groups * args.d_state
        parts = {"in_proj": [di, di, gd, gd], "out_proj": [args.dim]}
    else:
        q, kv, F_ = args.n_heads * args.head_dim, args.n_kv_heads * args.head_dim, args.hidden_dim
        parts = {"wqkv": [q, kv, kv], "wo": [args.dim], "w13": [F_, F_], "w2": [args.dim]}
    return [(lw[k], sizes, shard_columns(lw[k], sizes, mesh.t, mesh.tensor))
            for k, sizes in parts.items()]


class ShardRecorder:
    """While entered, keeps a copy of the inputs of the first calls of each
    kernel wrapper that the sharded forwards make (up to
    PAR_SHAPES_PER_KERNEL shapes each), to hold each kernel against its
    plain version at those shard shapes afterwards (``replay``), and the
    quantized linears' shard products against the matching columns of the
    whole weight's product (``whole``: ``whole_leaves``)."""

    def __init__(self, whole=()):
        self.records, self._saved, self.whole = [], [], list(whole)

    def __enter__(self):
        import importlib

        for mod_name, name in SHARD_CALL_SITES:
            mod = importlib.import_module(f"mistral_inference_tpu_torch.{mod_name}")
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, self._recording(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        self._saved = []

    def _recording(self, name, fn):
        def call(*args, **kw):
            sig = _sig(args)
            seen = [r for r in self.records if r[0] == name]
            if len(seen) < PAR_SHAPES_PER_KERNEL and all(r[1] != sig for r in seen):
                self.records.append((name, sig, fn, _clone(args), _clone(kw)))
            return fn(*args, **kw)
        return call

    def _whole_columns(self, name, fn, args, got):
        """For a K3, K5 or K8 record on a column shard (a dense linear or an
        expert stack): whether the shard's output equals the matching
        columns of the whole weight's product, in bits (None where the
        weight is no such shard)."""
        from mistral_inference_tpu_torch.parallel.sharding import _part_slices

        if name not in SHARD_WHOLE:
            return None
        q = args[1]
        for leaf, sizes, shard in self.whole:
            sq = shard["q4"] if "q4" in shard else shard["q"]
            lead = sq.dim() < q.dim()  # a dense weight as K5's one-weight stack
            sq = sq[None] if lead else sq
            if sq.shape != q.shape or not torch.equal(sq, q):
                continue
            wq, ws = (leaf["q4"] if "q4" in leaf else leaf["q"]), leaf["scale"]
            wq, ws = (wq[None], ws[None]) if lead else (wq, ws)
            rest = args[3:] if name == "moe_matmul_quant_ragged" else ()
            full = fn(args[0], wq, ws, *rest)  # K3: the whole weight's own split
            T, t = leaf["scale"].shape[-1] // shard["scale"].shape[-1], self.t
            cols = torch.cat([torch.arange(full.shape[-1], device=full.device)[s]
                              for s in _part_slices(sizes, t, T)])
            torch.cuda.synchronize()
            return same_bits(full[..., cols], got)
        return None

    def replay(self, path: str, card: str, t: int = 0) -> list:
        """One ``kernel_shard`` line per record: the kernel and its plain
        version on copies of the recorded inputs; the in-place writes (ring
        bytes and scales, the SSD state) must equal in bits, and a linear's
        shard output the whole weight's columns. K6 is held to its plain
        version over the ring each K2 record wrote."""
        from mistral_inference_tpu_torch.ops.cuda import attention as att

        plain, self.t = _plain_versions(), t
        lines = []
        for name, sig, fn, args, kw in self.records:
            ka, pa = _clone(args), _clone(args)
            got, want = fn(*ka, **_clone(kw)), plain[name](*pa, **_clone(kw))
            torch.cuda.synchronize()
            lines.append(self._line(path, name, sig, got, want, ka, pa, card))
            whole = self._whole_columns(name, fn, args, got)
            require(whole is not False, f"{name}: the shard's output at {sig} is not the whole "
                                        "weight's columns in bits")
            lines[-1]["whole_columns_equal_bits"] = whole
            lines[-1]["ms"] = timed_ms(lambda: fn(*ka, **kw))  # after the comparison
            if name == "fused_update_decode_attention":
                xq, _, _, CK, CV, KS, VS, li, window, _, q_pos, kv_pos, kv_valid = pa
                k6 = (xq, CK, CV, KS, VS, li, q_pos[:, None], kv_pos, kv_valid, window)
                lines.append(self._line(
                    path, "decode_attention", sig, att.decode_attention(*k6),
                    att.decode_attention_plain(*k6), (), (), card))
                lines[-1]["ms"] = timed_ms(lambda: att.decode_attention(*k6))
        self.records = []
        return lines

    @staticmethod
    def _line(path, name, sig, got, want, ka, pa, card) -> dict:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        worst, ok = 0.0, True
        for g, w in zip(got, want):
            tol = 1e-2 if g.dtype == torch.bfloat16 else 1e-4
            good, err = close(g, w, tol, tol)
            ok, worst = ok and good, max(worst, err)
        writes = SHARD_WRITES.get(name, ())
        same_writes = all(same_bits(ka[i], pa[i]) for i in writes if ka[i] is not None)
        require(ok, f"{name} disagrees with its plain version at the shard shape {sig}: {worst}")
        require(same_writes, f"{name} wrote other bits than its plain version at {sig}")
        return {"phase": "kernel_shard", "path": path, "kernel": name, "shape": sig,
                "max_abs_err": worst, "writes_equal_bits": bool(writes) or None,
                "tolerance": "abs 1e-2 + rel 1e-2 on bf16 outputs, 1e-4 on fp32 outputs "
                             "(stats, K9's y); in-place writes and a shard's columns of the "
                             "whole product equal bits",
                "card": card}


def wrong_shard(model, prompts):
    """``par_generate`` on one device with each layer's ``wo`` and ``w2``
    outputs' two column halves swapped: what tensor = 2 computes if each rank
    held the other rank's output shard."""
    from mistral_inference_tpu_torch.models import transformer as tf

    saved = tf._wo, tf._dense_ffn

    def swap(y):
        D = y.shape[-1]
        return torch.cat([y[..., D // 2:], y[..., :D // 2]], -1)

    tf._wo = lambda out, w, args, mesh, rows=None: swap(saved[0](out, w, args, mesh, rows))
    tf._dense_ffn = lambda x, w, args, mesh=None, rows=None: swap(saved[1](x, w, args, mesh, rows))
    try:
        return par_generate(model, prompts)
    finally:
        tf._wo, tf._dense_ffn = saved


def _expected_collectives(path: ParPath) -> dict:
    """The collectives of one decode forward: 4 all-gathers a transformer
    layer and 2 a Mamba layer under tensor, one for the vocab head, one for
    the rows under data; one all-reduce a layer under expert; nothing over
    seq."""
    data, _, expert, tensor = path.mesh
    per_layer = (2 if path.ring is None else 4) if tensor > 1 else 0
    gathers = per_layer * path.layers + (tensor > 1) + (data > 1)
    return {"all_reduce": path.layers if expert > 1 else 0, "all_gather": gathers}


def par_reference(path: ParPath) -> dict:
    """The single-device run of a path, in this process: greedy tokens,
    logprobs and the teacher-forced logits of the generated tokens, the
    weight bytes, everything ``path.runs`` asks; on (a) the wrong shard."""
    from mistral_inference_tpu_torch.models import transformer as tf

    t0 = time.perf_counter()
    model = par_model(path)
    ref = {"weight_bytes": param_bytes(model.params), "params": tf.param_count(model.params)}
    if "generate" in path.runs:
        prompts = par_prompts(model.args.vocab_size)
        gen, lps = par_generate(model, prompts)
        ref.update(tokens=gen, logprobs=lps, logits=teacher_logits(model, prompts, gen))
    if path.label == "a":
        wrong, wrong_lps = wrong_shard(model, prompts)
        ref["wrong_shard"] = {"equal_bits": wrong == gen and wrong_lps == lps,
                              "rows_diverged": sum(a != b for a, b in zip(wrong, gen))}
    ref.update(par_runs(path, model))
    ref["seconds"] = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    return ref


def par_rank_path(path: ParPath, rank: int, card: str) -> dict:
    """One path on this rank: the sharded model, its greedy run, decode ==
    prefill, the launches and collectives, what ``path.runs`` asks; rank 0
    also replays the kernels at their shard shapes."""
    import contextlib

    from mistral_inference_tpu_torch.ops import cuda as kern
    from mistral_inference_tpu_torch.parallel.inspect import (
        decode_collective_inventory,
        prefill_collective_inventory,
    )
    from mistral_inference_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(**dict(zip(("data", "seq", "expert", "tensor"), path.mesh)))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = par_model(path, mesh)
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0, "weight_bytes": param_bytes(model.params)}
    recorder = (ShardRecorder(whole_leaves(path, mesh)) if rank == 0
                else contextlib.nullcontext())
    t = time.perf_counter()
    with recorder:
        if "generate" in path.runs:
            prompts = par_prompts(model.args.vocab_size)
            kern.reset_launch_counts()
            gen, lps = par_generate(model, prompts)
            out.update(tokens=gen, logprobs=lps, launches=launch_counts())
        kern.reset_launch_counts()
        out.update(par_runs(path, model, mesh))
        out["runs_launches"] = launch_counts()
    torch.cuda.synchronize()
    out["run_s"] = time.perf_counter() - t
    if "generate" in path.runs:
        _, tf_lps = par_generate(model, [p + g for p, g in zip(prompts, gen)], max_tokens=0)
        gaps = [abs(a - b) for lp, tl, g in zip(lps, tf_lps, gen)
                for a, b in zip(lp[-len(g):], tl[-len(g):])]
        out["decode_prefill_max_nats"], out["decode_prefill_mean_nats"] = (
            max(gaps), sum(gaps) / len(gaps))
        out["decode_collectives"] = decode_collective_inventory(model)
        if mesh.seq > 1:
            out["prefill_collectives"] = prefill_collective_inventory(model, 4, PAR_CHUNK)
    out["kernel_shard"] = recorder.replay(path.label, card, mesh.t) if rank == 0 else []
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["seconds"] = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    return out


def par_rank(rank: int, port: int, workdir: str, card: str) -> None:
    """One of two ranks on the one card. They share cuda:0, which NCCL
    refuses ("Duplicate GPU detected"), so they join over gloo, which stages
    the CUDA tensors of each collective through the host: the sharded math
    and the kernels at shard shapes run on the card, at none of NCCL's
    speed. Writes rank<r>.json (or rank<r>.err) into ``workdir``."""
    import os
    import traceback

    sys.path.insert(0, str(ROOT))
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from mistral_inference_tpu_torch.parallel.distributed import init_distributed

    try:
        init_distributed(backend="gloo", timeout_s=180)
        results = {p.label: par_rank_path(p, rank, card) for p in PAR_PATHS}
        (Path(workdir) / f"rank{rank}.json").write_text(json.dumps(results))
    except Exception:
        (Path(workdir) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _first_divergence(got, want) -> list:
    return [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), len(b))
            for a, b in zip(got, want)]


def _par_line(path: ParPath, ref: dict, r0: dict, r1: dict):
    """Phase 13's line for one path, holding both ranks to each other and
    to one device in bits; returns (the line, what failed)."""
    label = f"{path.label} {path.model} x{path.layers} mesh{list(path.mesh)}"
    problems = []

    def require(ok: bool, what: str) -> None:
        if not ok:
            problems.append(what)

    keys = [k for k in ("tokens", "logprobs", "engine", "lookup", "odd", "mamba_engine")
            if k in r0]
    same = [k for k in keys if (r0[k]["tokens"] == r1[k]["tokens"] if isinstance(r0[k], dict)
                                else r0[k] == r1[k])]
    require(same == keys, f"{label}: the two ranks returned other {set(keys) - set(same)}")
    line = {"path": path.label, "model": path.model, "layers": path.layers,
            "mesh": dict(zip(("data", "seq", "expert", "tensor"), path.mesh)),
            "ring": path.ring, "weights": "int4 (group 128), drawn in bf16 from seed 0",
            "live_lora_rank": PAR_LORA_RANK if path.lora else None,
            "params": ref["params"], "equal_ranks": same == keys}
    for k in keys:
        got, want = r0[k], ref[k]
        if k in ("engine", "mamba_engine"):
            equal = got["tokens"] == want["tokens"]
            line[k] = {"equal_bits_to_one_device": equal,
                       "rows_diverged": sum(a != b for a, b in zip(got["tokens"], want["tokens"])),
                       "seconds_per_rank": [r0[k]["s"], r1[k]["s"]],
                       "one_device_s": want["s"]}
            if "prefix_hits" in got:
                line[k].update(prefix_hits=got["prefix_hits"], staged_rows=got["staged"])
                require(got["prefix_hits"] == want["prefix_hits"] >= 1
                        and got["staged"] == want["staged"] >= 1,
                        f"{label}: {got['prefix_hits']} prefix copies and {got['staged']} "
                        f"staged rows ({want['prefix_hits']} and {want['staged']} on one "
                        "device; at least one each)")
        elif k in ("lookup", "odd"):
            equal = list(got) == list(want)  # (tokens, logprobs); a rank's came through JSON
            line[k] = {"equal_bits_to_one_device": equal,
                       **({"k7_launches_verify_forwards": [
                           [r["lookup_k7"]["launches"], r["lookup_k7"]["verify_forwards"]]
                           for r in (r0, r1)]} if k == "lookup" else {}),
                       "first_divergence": _first_divergence(got[0], want[0]),
                       "logprob_max_mean_nats": par_logprob_gap(got[1], want[1])}
        else:
            continue
        require(equal, f"{label}: {k} is not one device's in bits")
    if "tokens" in r0:
        equal = r0["tokens"] == ref["tokens"] and r0["logprobs"] == ref["logprobs"]
        line["first_divergence"] = _first_divergence(r0["tokens"], ref["tokens"])
        max_nats, mean_nats = par_logprob_gap(r0["logprobs"], ref["logprobs"])
        require(equal, f"{label}: the tokens or logprobs are not one device's bits "
                       f"({max_nats} max, {mean_nats} mean nats)")
        moe = path.model == MOE_MODEL
        inv = ((MOE_INVARIANT_MAX_NATS, MOE_INVARIANT_MEAN_NATS) if moe
               else (INVARIANT_MAX_NATS, INVARIANT_MEAN_NATS))
        for r in (r0, r1):
            require(r["decode_prefill_max_nats"] <= inv[0]
                    and r["decode_prefill_mean_nats"] <= inv[1],
                    f"{label}: decode != prefill on the sharded model")
            for name in path.per_decode:
                require(r["launches"][name] == path.layers * PAR_TOKENS,
                        f"{label}: {name} launched {r['launches'][name]} times, not "
                        f"{path.layers} x {PAR_TOKENS}")
            require(r["decode_collectives"] == _expected_collectives(path),
                    f"{label}: one decode forward issued {r['decode_collectives']}, not "
                    f"{_expected_collectives(path)}")
            if "lookup_k7" in r:
                k7 = r["lookup_k7"]
                require(k7["verify_forwards"] > 0
                        and k7["launches"] == path.layers * k7["verify_forwards"],
                        f"{label}: lookup launched K7 {k7['launches']} times for "
                        f"{k7['verify_forwards']} verify forwards of {path.layers} layers")
        line.update(equal_bits_to_one_device=equal,
                    logprob_max_nats=max_nats, logprob_mean_nats=mean_nats,
                    decode_prefill_max_nats=[r0["decode_prefill_max_nats"],
                                             r1["decode_prefill_max_nats"]],
                    decode_prefill_mean_nats=[r0["decode_prefill_mean_nats"],
                                              r1["decode_prefill_mean_nats"]],
                    decode_prefill_bound=list(inv),
                    decode_collectives=[r0["decode_collectives"], r1["decode_collectives"]])
        if "prefill_collectives" in r0:
            line["prefill_collectives_chunk_256_b4"] = r0["prefill_collectives"]
    for r in (r0, r1):
        for name in path.expected:
            require(r.get("launches", {}).get(name, 0) + r["runs_launches"][name] > 0,
                    f"{label}: {name} was not launched on a rank")
    if path.mesh[3] > 1 and path.mesh[2] == 1:  # column shards: each quantized kernel once
        quant = {x["kernel"] for x in r0["kernel_shard"] if x["kernel"] in SHARD_WHOLE}
        whole = {x["kernel"] for x in r0["kernel_shard"] if x.get("whole_columns_equal_bits")}
        require(quant and quant <= whole, f"{label}: no kernel_shard line held "
                                          f"{sorted(quant - whole)} to the whole weight's columns")
    line.update(
        launches_rank0={k: v for k, v in r0.get("launches", {}).items() if v},
        launches_rank1={k: v for k, v in r1.get("launches", {}).items() if v},
        runs_launches_rank0={k: v for k, v in r0["runs_launches"].items() if v},
        kernel_shard_lines=len(r0["kernel_shard"]),
        whole_columns_lines=sum(bool(x.get("whole_columns_equal_bits"))
                                for x in r0["kernel_shard"]),
        weight_bytes_per_rank=[r0["weight_bytes"], r1["weight_bytes"]],
        weight_bytes_one_device=ref["weight_bytes"],
        peak_mem_gb_per_rank=[r0["peak_mem_gb"], r1["peak_mem_gb"]],
        seconds_per_rank=[r0["seconds"], r1["seconds"]],
        run_s_per_rank=[r0["run_s"], r1["run_s"]], reference_s=ref["seconds"])
    return line, problems


def parallel_phase(card: str) -> dict:
    """Phase 13: an NCCL world of one, then paths (a)-(h) over two gloo
    ranks on the card, each against the single-device port on the same seed
    and inputs in this run, in bits."""
    import multiprocessing as mp

    t0 = time.perf_counter()
    emit(nccl_world_of_one(card))
    refs = {}
    for p in PAR_PATHS:  # one single-device run a model, for every path on it
        if p.ref is None:
            runs = [r for q in PAR_PATHS if p.label in (q.label, q.ref) for r in q.runs]
            refs[p.label] = par_reference(p._replace(runs=tuple(dict.fromkeys(runs))))
    for p in PAR_PATHS:
        refs[p.label] = refs[p.ref or p.label]
    wrong = refs["a"]["wrong_shard"]
    require(not wrong["equal_bits"], "a wrong shard (wo and w2 output halves swapped) gave one "
                                     "device's bits: the check cannot tell it")
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_par_") as tmp:
        port = _free_port()
        ranks = [ctx.Process(target=par_rank, args=(r, port, tmp, card)) for r in range(2)]
        t_ranks = time.perf_counter()
        for p in ranks:
            p.start()
        deadline = time.monotonic() + PAR_TIMEOUT_S
        for p in ranks:
            p.join(max(1.0, deadline - time.monotonic()))
        for p in ranks:
            if p.is_alive():
                p.kill()
                p.join()
        errors = [(Path(tmp) / f"rank{r}.err") for r in range(2)]
        for r, err in enumerate(errors):
            require(not err.exists(), f"rank {r} failed:\n" + (err.read_text()
                                                                if err.exists() else ""))
        require(all(p.exitcode == 0 for p in ranks),
                f"the ranks exited {[p.exitcode for p in ranks]} (killed after "
                f"{PAR_TIMEOUT_S} s if negative)")
        res = [json.loads((Path(tmp) / f"rank{r}.json").read_text()) for r in range(2)]
        ranks_s = time.perf_counter() - t_ranks

    summary = {"phase": "parallel", "card": card, "ranks": 2, "backend": "gloo",
               "device": "cuda:0 for both ranks", "prompt_lens": PAR_PROMPT_LENS,
               "odd_prompt_lens": PAR_ODD_LENS, "chunk_size": PAR_CHUNK,
               "max_tokens": PAR_TOKENS, "held_to": "one device's tokens and logprobs in bits",
               "wrong_shard": wrong, "paths": {}}
    problems = []
    for path in PAR_PATHS:
        ref, r0, r1 = refs[path.label], res[0][path.label], res[1][path.label]
        for line in r0["kernel_shard"]:
            emit(line)
        line, failed = _par_line(path, ref, r0, r1)
        problems += failed
        summary["paths"][path.label] = line
        emit({"phase": "parallel_path", "card": card, **line})
    require(not problems, "phase 13: " + "; ".join(problems))
    summary.update(kernel_shard_lines=sum(len(res[0][p.label]["kernel_shard"]) for p in PAR_PATHS),
                   ranks_s=ranks_s, seconds=time.perf_counter() - t0)
    return summary


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "mistral_inference_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    global SPEC
    import dataclasses

    from mistral_inference_tpu_torch.utils.chip import spec_for_device

    card = nvidia_smi()
    SPEC = spec_for_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "chip_spec": dataclasses.asdict(SPEC)})

    from mistral_inference_tpu_torch.ops.cuda import _build

    built = _build.build_all(force=True)
    for name, text in built["logs"].items():
        print(f"== nvcc {name}\n{text}", file=sys.stderr, flush=True)
    emit({"phase": "build", "seconds": built["seconds"], "sources": sorted(built["logs"])})

    phases = [a.split("=", 1)[1].split(",") for a in sys.argv[1:] if a.startswith("--phases=")]
    if phases:  # a part of the run, for work on the serving phases: no result line
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            for name, run in (("staged_rows", lambda: [staged_rows_check(card, p)
                                                       for p in STAGED_PATHS]),
                              ("spec_serving", lambda: spec_serving_phase(card)),
                              ("mamba_serving", lambda: mamba_serving_phase(card)),
                              ("lora", lambda: lora_phase(card, Path(tmp))),
                              ("parallel", lambda: parallel_phase(card)),
                              ("mamba_rows", lambda: mamba_rows_probe(card)),
                              ("moe_drops", lambda: moe_drop_line(card))):
                if name in phases[0]:
                    got = run()
                    for line in got if isinstance(got, list) else [got]:
                        if line is not None:  # the rows probe prints its own line
                            emit(line)
                    torch.cuda.empty_cache()
        print(card, flush=True)
        return 0

    laps, last = {}, [t_start]

    def lap(name: str) -> None:  # each phase's seconds, for the total line
        now = time.perf_counter()
        laps[name], last[0] = now - last[0], now

    lap("1-2 card and build")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    checks = (check_k1, check_k4, check_k2, check_k3, check_k5, check_k8, check_k6, check_k7,
              check_k9, check_k10, check_k4_fp8, check_k2_fp8, check_k6_fp8, check_k7_fp8)
    only = [a.split("=", 1)[1].split(",") for a in sys.argv[1:] if a.startswith("--kernels=")]
    for check in checks:
        if only and check.__name__.removeprefix("check_") not in only[0]:
            continue
        rows.append(check(gen))
        emit({"phase": "kernel", "card": card, **rows[-1]})
        torch.cuda.empty_cache()
    if only:  # a part of the run, for work on one kernel: no result line
        print(card, flush=True)
        return 0
    lap("3 kernels")

    # Each kernel's launches on the path that runs it at the greatest depth:
    # the full Mixtral model for all but K6, which only the non-fused route runs.
    launches, depth = {}, {}
    for path in PATHS:
        summary, counted = main_path(
            card, "--profile" in sys.argv[1:] and path.quant is not None, path)
        emit(summary)
        for name in path.expected:
            if path.layers > depth.get(name, 0):
                launches[name], depth[name] = counted[name], path.layers
        torch.cuda.empty_cache()
    lap("4 main paths")
    emit(moe_drop_line(card))  # beside the Mixtral path: the drop counter
    torch.cuda.empty_cache()
    lap("4 moe drops")
    emit(row_count_probe(gen))
    for spath in SPEC_PATHS:
        summary, counted = spec_path(card, spath)
        emit(summary)
        k7 = K7F if spath.ring == "fp8" else K7
        if spath.fused and spath.layers > depth.get(k7, 0):
            launches[k7], depth[k7] = counted[k7], spath.layers
        torch.cuda.empty_cache()
    lap("5 speculation")
    # K9's launches per greedy generate_mamba on the full 64-layer model.
    for mpath in MAMBA_PATHS:
        summary, counted = mamba_path(card, "--profile" in sys.argv[1:], mpath)
        emit(summary)
        if mpath.layers > depth.get(K9, 0):
            launches[K9], depth[K9] = counted[K9], mpath.layers
        torch.cuda.empty_cache()
    emit(mamba_lookup_path(card)[0])
    torch.cuda.empty_cache()
    lap("6 mamba")
    # The multimodal path: K10's launches, and K1, K4 and K2 at 40 layers.
    summary, counted, pix_model = pixtral_path(card, "--profile" in sys.argv[1:])
    emit(summary)
    for name in (K10, K1, K4, K2):
        if summary["layers"] > depth.get(name, 0):
            launches[name], depth[name] = counted[name], summary["layers"]
    torch.cuda.empty_cache()
    lap("7 vision")
    # The serving engine over the north-star model, the Pixtral model resident.
    emit(serving_phase(card, "--profile" in sys.argv[1:], torch.cuda.memory_allocated()))
    torch.cuda.empty_cache()
    lap("8 serving")
    for staged in STAGED_PATHS:
        emit(staged_rows_check(card, staged))
        torch.cuda.empty_cache()
    lap("8 staged rows")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # The front door: a checkpoint folder on disk through the CLI and the HTTP API.
        emit(front_door_phase(card, pix_model, Path(tmp)))
        torch.cuda.empty_cache()
        lap("9 front door")
        # Speculative serving, the Pixtral model still resident (its lookup
        # engine runs K7-fp8 at 32 layers); then Mamba serving, and LoRA on
        # the front door's folder.
        spec = spec_serving_phase(card, torch.cuda.memory_allocated())
        emit(spec)
        if spec["layers"] > depth.get(K7F, 0):
            launches[K7F] = spec["engines"]["lookup"]["launches"][K7F]
            depth[K7F] = spec["layers"]
        del pix_model
        torch.cuda.empty_cache()
        lap("10 speculative serving")
        emit(mamba_serving_phase(card))
        torch.cuda.empty_cache()
        lap("11 mamba serving")
        mamba_rows_probe(card)
        torch.cuda.empty_cache()
        lap("11 mamba rows probe")
        emit(lora_phase(card, Path(tmp)))
        torch.cuda.empty_cache()
        lap("12 lora")
    # Many GPUs: an NCCL world of one, then two gloo ranks sharing the card.
    emit(parallel_phase(card))
    torch.cuda.empty_cache()
    lap("13 parallel")
    emit({"phase": "total", "seconds": time.perf_counter() - t_start, "phase_seconds": laps,
          "note": "from the start of main(): the build, every check and path; not the "
                  "interpreter's start and the import of torch"})
    emit({"kernels": [
        {"name": r["name"], "route": r["route"], "source": r["source"],
         "replaces": r["replaces"], "launches": launches[r["name"]],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]}
        for r in rows
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
