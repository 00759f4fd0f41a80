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


def targs(**over) -> TransformerArgs:
    kw = dict(dim=128, n_layers=2, head_dim=32, hidden_dim=256, n_heads=4, n_kv_heads=2,
              norm_eps=1e-5, vocab_size=512, max_batch_size=4, rope_theta=10000.0)
    kw.update(over)
    return TransformerArgs(**kw)


def qargs(**over) -> TransformerArgs:
    """A model whose quantized shards at tensor = 2 keep the kernels'
    shapes: every K and N of a shard a multiple of 128."""
    return targs(**{**dict(head_dim=64), **over})


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


# The three configurations the test also runs in the JAX package under the
# same mesh, on these models' weights.
JAX_MODELS = {
    "dense_dp_tp": lambda mesh: _tf(targs(), 42, mesh),
    "int4_fp8": lambda mesh: _tf(qargs(kv_quant="fp8"), 43, mesh).quantize("int4", group=64),
    "mamba_tp": lambda mesh: Mamba.random(margs(), dtype=F32, seed=44, device="cpu", mesh=mesh),
}


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
    (data, tensor) = (2, 2) here; the rest are made inside)."""
    from mistral_inference_tpu_torch.parallel.inspect import decode_collective_inventory
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
    mesh: Tuple[int, int, int]  # (data, expert, tensor)
    run: Callable


CASES: Dict[str, Case] = {
    "dense_window": Case((2, 1, 2), dense_window),
    "tp_every_kv_head": Case((1, 1, 4), tp_every_kv_head),
    "moe_dense": Case((1, 2, 2), moe_dense),
    "moe_dispatch": Case((1, 2, 2), moe_dispatch),
    "moe_quant_kernels": Case((1, 2, 2), moe_quant_kernels),
    "int8_dp_tp": Case((2, 1, 2), int8_dp_tp),
    "int4_born_quantized": Case((2, 1, 2), int4_born_quantized),
    "draft_speculation": Case((2, 1, 2), draft_speculation),
    "lookup_speculation": Case((2, 1, 2), lookup_speculation),
    "stacked_export": Case((2, 1, 2), stacked_export),
    "mamba_dp": Case((4, 1, 1), mamba_dp),
    "mamba_tied_tp": Case((1, 1, 2), mamba_tied_tp),
    "mamba_quant_tp": Case((2, 1, 2), mamba_quant_tp),
    "mamba_lookup": Case((2, 1, 2), mamba_lookup),
    "engines_tp": Case((1, 1, 2), engines_tp),
    "server_tp": Case((1, 1, 2), server_tp),
    "pixtral_tp": Case((2, 1, 2), pixtral_tp),
    "budgets": Case((2, 1, 2), budgets),
    "to_global": Case((2, 1, 2), to_global),
    "dense_dp_tp": Case((2, 1, 2), dense_dp_tp),
    "int4_fp8": Case((2, 1, 2), int4_fp8),
    "mamba_tp": Case((2, 1, 2), mamba_tp),
}


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
        mesh = make_mesh(*case.mesh, device="cpu")
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
