"""The configurations of tests/test_torch_parallel_mp.py, and the rank
program that runs them.

Each case is a mesh shape and a function of the mesh: it builds its model
(``mesh=None``: the single-device model of the same seed, on the CPU) and
returns what it generated, as lists. The test's process runs every case
with ``mesh=None`` for its reference; ``WORLD`` ranks run each case under
its mesh, started once as

    RANK=r WORLD_SIZE=4 MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_parallel_cases.py <work dir>

each writing ``rank<r>.json`` into the work directory, where the test wrote
the stacked export a case reads. This module imports no JAX.
"""

from __future__ import annotations

import json
import sys
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Tuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from mistral_inference_tpu_torch.args import (  # noqa: E402
    LoraArgs,
    MambaArgs,
    MoeArgs,
    TransformerArgs,
    VisionEncoderArgs,
)
from mistral_inference_tpu_torch.generate import generate, generate_mamba  # noqa: E402
from mistral_inference_tpu_torch.model import Mamba, Transformer  # noqa: E402

WORLD = 4
F32 = torch.float32
PROMPTS = [list(range(1, 14)), [2, 6, 10], [3, 7, 11, 15, 19, 23, 27, 31, 35], [4, 8]]
THREE = PROMPTS[:3]  # under data = 2, the batch pads with an empty row
LOOKUP_PROMPTS = [[5, 6, 7, 8, 5, 6, 7, 8, 5, 6], [9, 3, 9, 3, 9], [1, 2, 3]]
LONG = [[(7 * i + 3 * j) % 500 + 1 for j in range(70)] for i in range(4)]  # 280 prefill rows
# (prompt, max_tokens) for a four-slot engine at data 2, rows 0-1 on data
# rank 0 and 2-3 on rank 1. The first two run long; the next two finish
# first and free rows 2 and 3 for the two after them, which share a
# prefix of 20 and 24 tokens with rows 0 and 1: two prefix copies across
# data ranks. The last shares nothing and comes alone: a staged row,
# staged on rank 0 and adopted into row 2 or 3.
SHARED = [[(5 * j + 11) % 400 + 1 for j in range(20)], [(9 * j + 2) % 400 + 1 for j in range(24)]]
ENGINE_REQUESTS = [(SHARED[0] + [7, 8], 10), (SHARED[1] + [3], 10), ([4, 9, 14, 19], 2),
                   ([6, 12], 2), (SHARED[0] + [21, 22, 23], 2), (SHARED[1] + [31, 32], 2),
                   ([40, 41, 42], 3)]


def targs(**over) -> TransformerArgs:
    kw = dict(dim=128, n_layers=2, head_dim=32, hidden_dim=256, n_heads=4, n_kv_heads=2,
              norm_eps=1e-5, vocab_size=512, max_batch_size=4, rope_theta=10000.0)
    kw.update(over)
    return TransformerArgs(**kw)


def qargs(**over) -> TransformerArgs:
    """A model whose quantized shards at tensor = 2 keep the kernels'
    shapes: every K and N of a shard a multiple of 128 (``wo`` and ``w2``
    keep their K and take D / 2 = 128 output columns)."""
    return targs(**{**dict(dim=256, head_dim=64), **over})


def margs(**over) -> MambaArgs:
    kw = dict(dim=64, n_layers=2, vocab_size=256, n_groups=2, rms_norm=True,
              residual_in_fp32=True, fused_add_norm=True, pad_vocab_size_multiple=16,
              tie_embeddings=False, d_state=16, d_conv=4, expand=2, headdim=16)
    kw.update(over)
    return MambaArgs(**kw)


def _out(gen_lp) -> Dict:
    gen, lp = gen_lp
    return {"tokens": gen, "logprobs": lp}


def _tf(args, seed, mesh, quant=None, group=128, **kw) -> Transformer:
    return Transformer.random(args, dtype=F32, seed=seed, device="cpu", quant=quant,
                              group=group, mesh=mesh, **kw)


def _greedy(model, prompts=PROMPTS, max_tokens=6, **kw) -> Dict:
    run = generate_mamba if isinstance(model, Mamba) else generate
    return _out(run(prompts, model, max_tokens=max_tokens, temperature=0.0, **kw))


# -- the cases -------------------------------------------------------------------


def _with_lora(model, seed: int):
    """Fill a live-LoRA model's zero pairs from ``seed`` (the same values on
    every rank: the pairs are whole)."""
    gen = torch.Generator().manual_seed(seed)
    for lw in model.params["layers"]:
        for name in sorted(lw["lora"]):
            for leaf in ("a", "b"):
                t = lw["lora"][name][leaf]
                t.copy_(0.2 * torch.randn(t.shape, generator=gen, dtype=t.dtype))
    return model


LORA = LoraArgs(rank=4, scaling=2.0)

# The configurations the test also runs in the JAX package under the same
# mesh, (data, seq, expert, tensor) as in ``JAX_MESHES``, on these models'
# weights, each generated with ``JAX_CHUNKS`` as its chunk size.
JAX_MODELS = {
    "dense_dp_tp": lambda mesh: _tf(targs(), 42, mesh),
    "int4_fp8": lambda mesh: _tf(qargs(kv_quant="fp8"), 43, mesh).quantize("int4", group=64),
    "mamba_tp": lambda mesh: Mamba.random(margs(), dtype=F32, seed=44, device="cpu", mesh=mesh),
    "seq_tp": lambda mesh: _tf(targs(), 21, mesh),
    "lora_dp_tp": lambda mesh: _with_lora(_tf(targs(lora=LORA), 24, mesh), 1),
}
JAX_MESHES = {"seq_tp": dict(seq=2, tensor=2)}  # the rest: data 2 x tensor 2
JAX_CHUNKS = {"seq_tp": 4}


def dense_dp_tp(mesh, work: Path) -> Dict:
    return _greedy(JAX_MODELS["dense_dp_tp"](mesh))


def dense_window(mesh, work: Path) -> Dict:
    return _greedy(_tf(targs(sliding_window=4), 7, mesh), THREE, chunk_size=4)


def tp_every_kv_head(mesh, work: Path) -> Dict:
    return _greedy(_tf(targs(n_heads=8, n_kv_heads=4), 8, mesh))


def moe_dense(mesh, work: Path) -> Dict:
    return _greedy(_tf(targs(moe=MoeArgs(4, 2)), 9, mesh))


def moe_dispatch(mesh, work: Path) -> Dict:
    args = targs(moe=MoeArgs(4, 2), moe_impl="dispatch", moe_capacity_factor=4.0)
    return _greedy(_tf(args, 10, mesh))


def moe_quant_kernels(mesh, work: Path) -> Dict:
    """int8 experts: the ragged grouped product (K5's plain version) on the
    280-row prefill, K8's on every decode step."""
    args = targs(dim=256, hidden_dim=512, head_dim=64, moe=MoeArgs(4, 2), moe_impl="dispatch")
    return _greedy(_tf(args, 11, mesh, quant="int8", group=64), LONG, max_tokens=4)


def int8_dp_tp(mesh, work: Path) -> Dict:
    """Shard, then quantize."""
    return _greedy(_tf(qargs(), 12, mesh).quantize("int8", group=32))


def int4_fp8(mesh, work: Path) -> Dict:
    """int4, quantized after sharding, over an fp8 ring."""
    return _greedy(JAX_MODELS["int4_fp8"](mesh))


def int4_born_quantized(mesh, work: Path) -> Dict:
    """Quantized as drawn, then sharded (``random(quant=...)``)."""
    return _greedy(_tf(qargs(), 13, mesh, quant="int4", group=64))


def draft_speculation(mesh, work: Path) -> Dict:
    target = _tf(targs(), 1, mesh)
    draft = _tf(targs(dim=64, n_layers=1, hidden_dim=128), 2, mesh)
    return _greedy(target, draft_model=draft, spec_tokens=2)


def lookup_speculation(mesh, work: Path) -> Dict:
    return _greedy(_tf(targs(), 3, mesh), LOOKUP_PROMPTS, max_tokens=8, draft_model="lookup",
                   spec_tokens=3)


def stacked_export(mesh, work: Path) -> Dict:
    """The int8 stacked export the test wrote (``stacked/``), loaded under
    the mesh."""
    from mistral_inference_tpu_torch.model import from_folder

    return _greedy(from_folder(work / "stacked", dtype=F32, device="cpu", mesh=mesh),
                   max_tokens=5)


def seq_tp(mesh, work: Path) -> Dict:
    """Chunks of 4 tokens split over seq = 2 (prefill), decode replicated."""
    return _greedy(JAX_MODELS["seq_tp"](mesh), chunk_size=4)


def seq_quant_rows(mesh, work: Path) -> Dict:
    """int8 at seq 2 x tensor 2, three rows in chunks of 256: one device's
    768 rows take the tiled product (K5), so each seq rank's 384 take it
    too, padded to whole 256-row tiles; decode takes K3 on whole columns."""
    prompts = [[(11 * i + 5 * j) % 500 + 1 for j in range(n)] for i, n in enumerate((300, 260, 40))]
    model = _tf(qargs(), 26, mesh).quantize("int8", group=64)
    return _greedy(model, prompts, max_tokens=3, chunk_size=256)


def data_seq(mesh, work: Path) -> Dict:
    """data 2 x seq 2: a batch of 3 padded to 4 rows, each data rank's two
    rows split over seq in chunks of 4."""
    return _greedy(_tf(targs(), 22, mesh), THREE, chunk_size=4)


def seq_indivisible(mesh, work: Path) -> Dict:
    """One unchunked prefill of width 13, which seq = 2 does not divide: it
    replicates over seq."""
    return _greedy(_tf(targs(), 22, mesh), max_tokens=5)


def moe_dispatch_dp_seq(mesh, work: Path) -> Dict:
    """Capacity-bounded MoE dispatch at data 2 x seq 2 with a capacity
    factor of 1, which drops assignments: a chunk one device dispatches is
    gathered whole over data and seq, so capacities and slots are one
    device's."""
    args = targs(moe=MoeArgs(4, 2), moe_impl="dispatch", moe_capacity_factor=1.0)
    return _greedy(_tf(args, 27, mesh), THREE, chunk_size=4)


def seq4_window_fp8(mesh, work: Path) -> Dict:
    """seq = 4 over a 4-token window and an fp8 ring, chunks of 8: the ring
    replicates over seq while the chunk splits (tests/test_sharding.py's
    test_sp_sliding_window_and_fp8)."""
    return _greedy(_tf(targs(sliding_window=4, kv_quant="fp8"), 23, mesh), chunk_size=8)


def engine_seq_tp(mesh, work: Path) -> Dict:
    """``Engine`` (plain and lookup) at seq 2 x tensor 2: admission chunks
    split over seq, verify chunks of 4 too, decode replicated
    (tests/test_engine.py's test_engine_under_mesh)."""
    from mistral_inference_tpu_torch.server.engine import Engine

    model = _tf(targs(), 31, mesh)
    return {
        "engine": _engine_outputs(Engine(model, batch_size=2, max_seq_len=64, decode_block=4),
                                  PROMPTS, 5),
        "engine_lookup": _engine_outputs(
            Engine(model, batch_size=2, max_seq_len=64, draft_model="lookup", spec_tokens=3),
            LOOKUP_PROMPTS, 6),
    }


def engines_dp_tp(mesh, work: Path) -> Dict:
    """``Engine`` over an int8 ring (plain with prefix copies and staged
    rows, and lookup) and ``MambaEngine`` at data 2 x tensor 2, four slots,
    requests arriving while others run."""
    from mistral_inference_tpu_torch.server.engine import Engine
    from mistral_inference_tpu_torch.server.mamba_engine import MambaEngine

    model = _tf(targs(kv_quant="int8"), 32, mesh)
    mamba = Mamba.random(margs(), dtype=F32, seed=33, device="cpu", mesh=mesh)
    engine = Engine(model, batch_size=4, max_seq_len=64, decode_block=2, admit_waterline=1)
    hits, staged = _metric("prefix_hits"), _metric("staged_admissions")
    return {
        "engine": _staggered(engine),
        "prefix_hits": _metric("prefix_hits") - hits,
        "staged_admissions": _metric("staged_admissions") - staged,
        "engine_lookup": _engine_outputs(
            Engine(model, batch_size=4, max_seq_len=64, draft_model="lookup", spec_tokens=3),
            LOOKUP_PROMPTS, 6),
        "mamba_engine": _staggered(MambaEngine(mamba, batch_size=4, max_seq_len=64,
                                               decode_block=2)),
    }


def lora_dp_tp(mesh, work: Path) -> Dict:
    """Live LoRA pairs at data 2 x tensor 2: whole on every rank, each rank
    adding its shard's columns of the whole delta."""
    return _greedy(JAX_MODELS["lora_dp_tp"](mesh))


def lora_ep_tp(mesh, work: Path) -> Dict:
    """Live LoRA on an MoE's attention and experts at expert 2 x tensor 2:
    each rank's experts take their pairs' delta."""
    args = targs(moe=MoeArgs(4, 2), moe_impl="dispatch", moe_capacity_factor=4.0, lora=LORA)
    return _greedy(_with_lora(_tf(args, 25, mesh), 2))


def mamba_dp(mesh, work: Path) -> Dict:
    return _greedy(Mamba.random(margs(), dtype=F32, seed=4, device="cpu", mesh=mesh))


def mamba_tp(mesh, work: Path) -> Dict:
    return _greedy(JAX_MODELS["mamba_tp"](mesh))


def mamba_tied_tp(mesh, work: Path) -> Dict:
    return _greedy(Mamba.random(margs(tie_embeddings=True), dtype=F32, seed=5, device="cpu",
                                mesh=mesh), THREE)


def mamba_quant_tp(mesh, work: Path) -> Dict:
    return _greedy(Mamba.random(margs(), dtype=F32, seed=6, device="cpu", mesh=mesh)
                   .quantize("int8", group=32))


def mamba_lookup(mesh, work: Path) -> Dict:
    return _greedy(Mamba.random(margs(), dtype=F32, seed=4, device="cpu", mesh=mesh),
                   LOOKUP_PROMPTS, max_tokens=8, draft_model="lookup", spec_tokens=3)


def _engine_outputs(engine, prompts, max_tokens) -> List[List[int]]:
    ids = [engine.submit(p, max_tokens=max_tokens) for p in prompts]
    out = engine.run_to_completion()
    return [out[i] for i in ids]


def _staggered(engine) -> List[List[int]]:
    """``ENGINE_REQUESTS``: four, two more after a step, the last after
    another."""
    ids, done = [], {}
    for i, (p, n) in enumerate(ENGINE_REQUESTS):
        if i in (4, 6):
            done.update({ev.request_id: engine._result(ev.request_id)
                         for ev in engine.step() if ev.finished})
        ids.append(engine.submit(p, max_tokens=n))
    done.update(engine.run_to_completion())
    return [done[i] for i in ids]


def _metric(name: str) -> float:
    from mistral_inference_tpu_torch.utils.profiling import METRICS

    return METRICS.counters.get(name, 0)


def engines_tp(mesh, work: Path) -> Dict:
    """``Engine`` (plain and lookup) and ``MambaEngine`` at tensor = 2."""
    from mistral_inference_tpu_torch.server.engine import Engine
    from mistral_inference_tpu_torch.server.mamba_engine import MambaEngine

    model = _tf(targs(), 14, mesh)
    mamba = Mamba.random(margs(), dtype=F32, seed=15, device="cpu", mesh=mesh)
    return {
        "engine": _engine_outputs(Engine(model, batch_size=2, max_seq_len=64), PROMPTS, 6),
        "engine_lookup": _engine_outputs(
            Engine(model, batch_size=2, max_seq_len=64, draft_model="lookup", spec_tokens=3),
            LOOKUP_PROMPTS, 6),
        "mamba_engine": _engine_outputs(MambaEngine(mamba, batch_size=2, max_seq_len=64),
                                        PROMPTS, 6),
    }


def server_tp(mesh, work: Path) -> Dict:
    """``server.api.Server`` at tensor = 2: the primary submits, the other
    rank replays its calls (``Server.follow``). The first request is one
    the engine refuses (prompt + max_tokens over max_seq_len); both ranks
    must then serve the valid ones."""
    from mistral_inference_tpu_torch.server.api import Server
    from mistral_inference_tpu_torch.server.engine import Engine

    srv = Server(Engine(_tf(targs(), 16, mesh), batch_size=2, max_seq_len=64), tokenizer=None)
    if mesh is not None and mesh.rank != 0:
        done = srv.follow()  # the same requests, replayed: the tokens are this rank's own
        return {"tokens": [done[i].generated for i in range(len(PROMPTS))]}
    srv.start()
    try:
        srv.submit(list(range(1, 70)), max_tokens=5, temperature=0.0)
    except ValueError:
        pass
    else:
        raise AssertionError("the engine took a prompt longer than max_seq_len")
    futs = [srv.submit(p, max_tokens=5, temperature=0.0) for p in PROMPTS]
    tokens = [f.result(timeout=60).generated for f in futs]
    srv.stop()
    return {"tokens": tokens}


def pixtral_tp(mesh, work: Path) -> Dict:
    """A Pixtral-shaped model: the encoder replicated, the decoder sharded."""
    vargs = VisionEncoderArgs(hidden_size=64, num_channels=3, image_size=64, patch_size=8,
                              intermediate_size=128, num_hidden_layers=2,
                              num_attention_heads=4, image_token_id=2)
    model = _tf(targs(vision_encoder=vargs), 17, mesh)
    rng = np.random.default_rng(0)
    image = rng.standard_normal((3, 16, 24)).astype(np.float32)  # 2 x 3 patches
    prompts = [[1] + [2] * 6 + [4, 5], [3, 9, 11]]
    return _greedy(model, prompts, images=[[image], []], chunk_size=4)


def budgets(mesh, work: Path) -> Dict:
    """The collectives of one decode forward on each mesh (``mesh`` is
    (data, tensor) = (2, 2) here; the rest are made inside), and of one
    prefill chunk of 8 at seq 2 x tensor 2."""
    from mistral_inference_tpu_torch.parallel.inspect import (
        decode_collective_inventory,
        prefill_collective_inventory,
    )
    from mistral_inference_tpu_torch.parallel.mesh import make_mesh

    if mesh is None:
        return {}
    out = {"dp_tp": decode_collective_inventory(_tf(targs(), 18, mesh))}
    out["mamba_dp_tp"] = decode_collective_inventory(
        Mamba.random(margs(), dtype=F32, seed=18, device="cpu", mesh=mesh))
    meshes = {"tp4": (1, 1, 4), "ep4": (1, 4, 1), "ep2_tp2": (1, 2, 2)}
    for name, (d, e, t) in meshes.items():
        m = make_mesh(d, e, t, device="cpu")
        args = targs(n_heads=8, n_kv_heads=4) if name == "tp4" else targs(
            moe=MoeArgs(8, 2) if e == 4 else MoeArgs(4, 2), moe_impl="dispatch")
        out[name] = decode_collective_inventory(_tf(args, 19, m))
    model = _tf(targs(), 19, make_mesh(seq=2, tensor=2, device="cpu"))
    out["seq2_tp2_prefill"] = prefill_collective_inventory(model, chunk=8)
    out["seq2_tp2_decode"] = decode_collective_inventory(model)
    return out


def to_global(mesh, work: Path) -> Dict:
    """``multihost.to_global`` passes what every rank holds alike and raises
    on a rank whose value differs from rank 0's."""
    from mistral_inference_tpu_torch.parallel.multihost import to_global as check

    if mesh is None:
        return {"same": True, "raised_where_it_differs": True}
    same = torch.equal(check(torch.arange(4), mesh), torch.arange(4))
    try:
        check(torch.tensor([mesh.rank]), mesh)
        raised = False
    except ValueError:
        raised = True
    return {"same": same, "raised_where_it_differs": raised == (mesh.rank != 0)}


class Case(NamedTuple):
    mesh: Tuple[int, int, int, int]  # (data, seq, expert, tensor)
    run: Callable


CASES: Dict[str, Case] = {
    "dense_window": Case((2, 1, 1, 2), dense_window),
    "tp_every_kv_head": Case((1, 1, 1, 4), tp_every_kv_head),
    "moe_dense": Case((1, 1, 2, 2), moe_dense),
    "moe_dispatch": Case((1, 1, 2, 2), moe_dispatch),
    "moe_quant_kernels": Case((1, 1, 2, 2), moe_quant_kernels),
    "int8_dp_tp": Case((2, 1, 1, 2), int8_dp_tp),
    "int4_born_quantized": Case((2, 1, 1, 2), int4_born_quantized),
    "draft_speculation": Case((2, 1, 1, 2), draft_speculation),
    "lookup_speculation": Case((2, 1, 1, 2), lookup_speculation),
    "stacked_export": Case((2, 1, 1, 2), stacked_export),
    "mamba_dp": Case((4, 1, 1, 1), mamba_dp),
    "mamba_tied_tp": Case((1, 1, 1, 2), mamba_tied_tp),
    "mamba_quant_tp": Case((2, 1, 1, 2), mamba_quant_tp),
    "mamba_lookup": Case((2, 1, 1, 2), mamba_lookup),
    "engines_tp": Case((1, 1, 1, 2), engines_tp),
    "server_tp": Case((1, 1, 1, 2), server_tp),
    "pixtral_tp": Case((2, 1, 1, 2), pixtral_tp),
    "budgets": Case((2, 1, 1, 2), budgets),
    "to_global": Case((2, 1, 1, 2), to_global),
    "dense_dp_tp": Case((2, 1, 1, 2), dense_dp_tp),
    "int4_fp8": Case((2, 1, 1, 2), int4_fp8),
    "mamba_tp": Case((2, 1, 1, 2), mamba_tp),
    "seq_tp": Case((1, 2, 1, 2), seq_tp),
    "seq_quant_rows": Case((1, 2, 1, 2), seq_quant_rows),
    "data_seq": Case((2, 2, 1, 1), data_seq),
    "seq_indivisible": Case((1, 2, 1, 2), seq_indivisible),
    "seq4_window_fp8": Case((1, 4, 1, 1), seq4_window_fp8),
    "moe_dispatch_dp_seq": Case((2, 2, 1, 1), moe_dispatch_dp_seq),
    "engine_seq_tp": Case((1, 2, 1, 2), engine_seq_tp),
    "engines_dp_tp": Case((2, 1, 1, 2), engines_dp_tp),
    "lora_dp_tp": Case((2, 1, 1, 2), lora_dp_tp),
    "lora_ep_tp": Case((1, 1, 2, 2), lora_ep_tp),
}


def mesh_sizes(name: str) -> Dict[str, int]:
    return dict(zip(("data", "seq", "expert", "tensor"), CASES[name].mesh))


def main(work: Path) -> None:
    """One rank: every case under its mesh, in order, the results (or the
    error) to ``rank<r>.json``."""
    import torch.distributed as dist

    from mistral_inference_tpu_torch.parallel.distributed import init_distributed
    from mistral_inference_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    init_distributed(device="cpu", timeout_s=120)
    rank = dist.get_rank()
    results: Dict[str, Dict] = {}
    for name, case in CASES.items():
        t0 = time.perf_counter()
        mesh = make_mesh(**mesh_sizes(name), device="cpu")
        if mesh is None:  # this rank sits the case out
            dist.barrier()
            continue
        try:
            results[name] = case.run(mesh, work)
        except Exception:  # the test reports it; the other ranks hit it too
            results[name] = {"error": traceback.format_exc()}
        results[name]["seconds"] = time.perf_counter() - t0
        dist.barrier()
    (work / f"rank{rank}.json").write_text(json.dumps(results))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(Path(sys.argv[1]))
