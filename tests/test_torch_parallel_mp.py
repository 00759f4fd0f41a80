"""The port under a mesh, four gloo ranks on the CPU, against the port on one
device and, for five configurations, against the JAX package under the
same mesh (counterpart of tests/test_sharding.py and
tests/test_multiprocess.py).

The ranks are started once for the module (``tests/torch_parallel_cases.py``
holds the configurations and the rank program), and at the same time
``torchrun`` runs ``main demo --tensor 2`` over two more. While they run,
this process computes every configuration on one device and the JAX
package's runs. Each test reads one configuration's results: every rank of
its mesh returns the same tokens and logprobs, and the tokens and logprobs
equal the single-device port's in bits: every sharded linear keeps its
whole K and the ranks gather activations, never partial sums, so a rank
does one device's arithmetic. Against the JAX package the logprobs agree
within 2e-3 in fp32, the tolerance of tests/test_sharding.py.
"""

import contextlib
import dataclasses
import io
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_tokenizers as tiny
import torch_parallel_cases as cases
from mistral_inference_tpu.args import LoraArgs as JaxLoraArgs
from mistral_inference_tpu.args import MambaArgs as JaxMambaArgs
from mistral_inference_tpu.args import TransformerArgs as JaxArgs
from mistral_inference_tpu.generate import generate as jax_generate
from mistral_inference_tpu.generate import generate_mamba as jax_generate_mamba
from mistral_inference_tpu.model import Mamba as JaxMamba
from mistral_inference_tpu.model import Transformer as JaxTransformer
from mistral_inference_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mistral_inference_tpu_torch.convert import params_to_numpy
from mistral_inference_tpu_torch.loading import save_stacked
from mistral_inference_tpu_torch.main import main as port_main
from mistral_inference_tpu_torch.model import Transformer
from test_torch_loading import write_reference_folder

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 240
ATOL = 2e-3  # against the JAX package
# Against the single-device port where the CPU GEMM does not give bits: the
# largest gap measured over these cases was 1.9e-6 (draft speculation and
# data 2 x seq 2); tokens are always equal.
CPU_GEMM = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_args(port_args, cls=JaxArgs):
    d = dataclasses.asdict(port_args)
    if d.get("lora") is not None:
        d["lora"] = JaxLoraArgs(**d["lora"])
    return cls(**{k: v for k, v in d.items() if k in {f.name for f in dataclasses.fields(cls)}})


def _jax_runs() -> dict:
    """The JAX package under (data, tensor) = (2, 2), or the mesh of
    ``cases.JAX_MESHES``, on the weights of the configurations of
    ``cases.JAX_MODELS`` (one device's, carried over by
    ``convert.params_to_numpy``; quantized bytes and live pairs as they
    are)."""
    out = {}
    for name, make in cases.JAX_MODELS.items():
        mesh = jax_make_mesh(**cases.JAX_MESHES.get(name, dict(data=2, tensor=2)))
        port = make(None)
        tree = params_to_numpy(port.params, port.args)
        if name == "mamba_tp":
            jmodel = JaxMamba(_jax_args(port.args, JaxMambaArgs), tree, jnp.float32, mesh)
            run = jax_generate_mamba
        else:
            jmodel = JaxTransformer(_jax_args(port.args), tree, jnp.float32, mesh)
            run = jax_generate
        gen, lp = run(cases.PROMPTS, jmodel, max_tokens=6, temperature=0.0,
                      chunk_size=cases.JAX_CHUNKS.get(name))
        out[name] = {"tokens": gen, "logprobs": lp}
    return out


def _cli_folder(work: Path) -> Path:
    folder = work / "cli"
    write_reference_folder(folder, "dense", seed=1)
    cfg = tiny.tiny_tekken_cfg()
    cfg["config"]["default_vocab_size"] = 256
    cfg["vocab"] = cfg["vocab"][:236]
    (folder / "tekken.json").write_text(json.dumps(cfg))
    return folder


def _stacked_export(work: Path) -> None:
    model = Transformer.random(cases.qargs(kv_quant="fp8"), dtype=torch.float32, seed=13,
                               device="cpu")
    model.quantize("int8", group=32)
    save_stacked(work / "stacked", model)


def _start(work: Path, cli: Path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT)] + sys.path[1:]),
               OMP_NUM_THREADS="1", MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(cases.WORLD), LOCAL_WORLD_SIZE=str(cases.WORLD))
    ranks = [
        subprocess.Popen([sys.executable, "-S", str(ROOT / "tests" / "torch_parallel_cases.py"),
                          str(work)], env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)
        for r in range(cases.WORLD)
    ]
    cli_env = {k: v for k, v in env.items() if k not in ("WORLD_SIZE", "LOCAL_WORLD_SIZE",
                                                         "MASTER_ADDR", "MASTER_PORT")}
    torchrun = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-addr", "localhost", "--master-port", str(_free_port()),
         "-m", "mistral_inference_tpu_torch.main", "demo", str(cli), "--max_tokens", "5",
         "--tensor", "2", "--device", "cpu"],
        env=cli_env, cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    return ranks, torchrun


def _wait(procs, deadline: float):
    """Each process's (stdout, stderr); past the deadline every process
    group started is killed (torchrun's workers with it) and the test fails."""
    outs = []
    for p in procs:
        try:
            out = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(q.pid, signal.SIGKILL)
            pytest.fail(f"the ranks did not finish within {TIMEOUT_S} s")
        outs.append(out)
    return outs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = tmp_path_factory.mktemp("parallel")
    _stacked_export(work)
    cli = _cli_folder(work)
    deadline = time.monotonic() + TIMEOUT_S
    ranks, torchrun = _start(work, cli)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks have the other cores
    try:
        refs = {name: case.run(None, work) for name, case in cases.CASES.items()}
        jax_out = _jax_runs()
        demo = io.StringIO()
        with contextlib.redirect_stdout(demo):
            port_main(["demo", str(cli), "--max_tokens", "5", "--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
        *rank_outs, cli_out = _wait([*ranks, torchrun], deadline)
    for p, (out, _) in zip(ranks, rank_outs):
        assert p.returncode == 0, out[-4000:]
    results = [json.loads((work / f"rank{r}.json").read_text()) for r in range(cases.WORLD)]
    return dict(refs=refs, jax=jax_out, results=results, demo=demo.getvalue(),
                cli=(torchrun.returncode, *cli_out))


def _sharded(run, name: str) -> dict:
    """The configuration's result on its mesh's ranks, after checking that
    every one of them returned the same."""
    outs = [r[name] for r in run["results"][:int(np.prod(cases.CASES[name].mesh))]]
    for o in outs:
        assert "error" not in o, o["error"]
    first = {k: v for k, v in outs[0].items() if k != "seconds"}
    for o in outs[1:]:
        assert {k: v for k, v in o.items() if k != "seconds"} == first
    return first


def _close(got: dict, want: dict, atol: float = ATOL) -> None:
    assert got["tokens"] == want["tokens"]
    assert [len(x) for x in got["logprobs"]] == [len(x) for x in want["logprobs"]]
    for a, b in zip(got["logprobs"], want["logprobs"]):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0)


def _same_as_one_device(run, name: str, atol: float = 0.0) -> dict:
    """The configuration's tokens and logprobs on its mesh against the
    single-device port's: equal in bits, or with ``atol`` (``CPU_GEMM``)
    where a rank's products have other row or column counts than one
    device's, which the CPU's fp32 GEMM may round otherwise."""
    got = _sharded(run, name)
    if atol:
        _close(got, run["refs"][name], atol)
    else:
        assert got == run["refs"][name]
    return got


def test_dense_dp_tp(run):
    """tests/test_sharding.py::test_tp_dp_dense, and the JAX package under
    the same mesh on the same weights."""
    got = _same_as_one_device(run, "dense_dp_tp")
    _close(got, run["jax"]["dense_dp_tp"])


def test_dense_dp_tp_sliding_window(run):
    """A 4-token window over chunks of 4 and a batch of 3 that data = 2
    pads with an empty row."""
    _same_as_one_device(run, "dense_window", CPU_GEMM)


def test_tp_over_every_kv_head(run):
    _same_as_one_device(run, "tp_every_kv_head")


def test_ep_tp_moe_dense_route(run):
    _same_as_one_device(run, "moe_dense", CPU_GEMM)


def test_ep_tp_moe_dispatch_route(run):
    _same_as_one_device(run, "moe_dispatch")


def test_ep_tp_moe_quantized_ragged_and_expert_kernels(run):
    """int8 experts: a 280-row prefill through the ragged grouped product
    and decode through the per-expert product, on each rank's experts."""
    _same_as_one_device(run, "moe_quant_kernels", CPU_GEMM)


def test_tp_dp_int8(run):
    _same_as_one_device(run, "int8_dp_tp", CPU_GEMM)


def test_tp_int4_fp8_ring(run):
    """int4 shards quantized after sharding (column shards over the whole
    K, each carrying its whole N), an fp8 ring, and the JAX package under
    the same mesh."""
    got = _same_as_one_device(run, "int4_fp8", CPU_GEMM)
    _close(got, run["jax"]["int4_fp8"])


def test_int4_born_quantized_then_sharded(run):
    _same_as_one_device(run, "int4_born_quantized", CPU_GEMM)


def test_draft_speculation_under_mesh(run):
    """Target and draft on the same mesh: plain greedy's tokens."""
    got = _same_as_one_device(run, "draft_speculation", CPU_GEMM)
    assert got["tokens"] == run["refs"]["draft_speculation"]["tokens"]


def test_lookup_speculation_under_mesh(run):
    _same_as_one_device(run, "lookup_speculation", CPU_GEMM)


def test_stacked_export_load_under_mesh(run):
    _same_as_one_device(run, "stacked_export", CPU_GEMM)


def test_mamba_data_parallel(run):
    _same_as_one_device(run, "mamba_dp", CPU_GEMM)


def test_mamba_tensor_parallel(run):
    """Heads and groups on tensor, the gated activation gathered over it
    before the norm; and the JAX package under the same mesh."""
    got = _same_as_one_device(run, "mamba_tp", CPU_GEMM)
    _close(got, run["jax"]["mamba_tp"])


def test_mamba_tied_head_tensor_parallel(run):
    _same_as_one_device(run, "mamba_tied_tp")


def test_mamba_quantized_tensor_parallel(run):
    _same_as_one_device(run, "mamba_quant_tp", CPU_GEMM)


def test_mamba_lookup_under_mesh(run):
    _same_as_one_device(run, "mamba_lookup")


def test_engines_under_tensor_2(run):
    got = _sharded(run, "engines_tp")
    assert got == run["refs"]["engines_tp"]


def test_server_follows_the_primary(run):
    """The other rank replays the primary's engine calls, but never one the
    engine refused, and both serve the requests after it."""
    got = _sharded(run, "server_tp")
    assert got["tokens"] == run["refs"]["server_tp"]["tokens"]


def test_pixtral_decoder_under_mesh(run):
    _same_as_one_device(run, "pixtral_tp", CPU_GEMM)


def test_collective_budgets(run):
    """The collectives of one decode forward: no all-reduce under tensor;
    four all-gathers a transformer layer (the heads before ``wo``, its
    columns, the FFN hidden, ``w2``'s columns), two a Mamba layer (the
    gated activation, ``out_proj``'s columns; ``dt_proj`` under data
    issues none), one for the vocab head and one for the rows over data;
    one all-reduce a layer over expert. A seq 2 prefill chunk
    (``head="none"``) adds one gather of K/V a layer and one of the final
    hidden states; decode issues nothing over seq."""
    got = _sharded(run, "budgets")
    L = cases.targs().n_layers
    assert got["dp_tp"] == {"all_reduce": 0, "all_gather": 4 * L + 2}
    assert got["mamba_dp_tp"] == {"all_reduce": 0, "all_gather": 2 * L + 2}
    assert got["tp4"] == {"all_reduce": 0, "all_gather": 4 * L + 1}
    assert got["ep4"] == {"all_reduce": L, "all_gather": 0}
    assert got["ep2_tp2"] == {"all_reduce": L, "all_gather": 4 * L + 1}
    assert got["seq2_tp2_prefill"] == {"all_reduce": 0, "all_gather": 5 * L + 1}
    assert got["seq2_tp2_decode"] == {"all_reduce": 0, "all_gather": 4 * L + 1}


def test_sequence_parallel_prefill_and_decode(run):
    """seq 2 x tensor 2, chunks of 4 split over seq, decode replicated; and
    the JAX package on ``make_mesh(seq=2, tensor=2)``
    (tests/test_sharding.py's test_sp_prefill_matches_single_device)."""
    got = _same_as_one_device(run, "seq_tp", CPU_GEMM)
    _close(got, run["jax"]["seq_tp"])


def test_sequence_parallel_routes_by_one_devices_rows(run):
    _same_as_one_device(run, "seq_quant_rows", CPU_GEMM)


def test_data_and_sequence_parallel(run):
    _same_as_one_device(run, "data_seq", CPU_GEMM)


def test_chunk_that_seq_does_not_divide_replicates(run):
    _same_as_one_device(run, "seq_indivisible")


def test_seq_4_over_a_windowed_fp8_ring(run):
    _same_as_one_device(run, "seq4_window_fp8", CPU_GEMM)


def test_moe_dispatch_under_data_and_seq(run):
    _same_as_one_device(run, "moe_dispatch_dp_seq", CPU_GEMM)


def test_engine_under_seq_and_tensor(run):
    """tests/test_engine.py's test_engine_under_mesh on seq 2 x tensor 2,
    plain and lookup."""
    assert _sharded(run, "engine_seq_tp") == run["refs"]["engine_seq_tp"]


def test_engines_under_data_and_tensor(run):
    """``Engine`` and ``MambaEngine`` on data 2 x tensor 2 give one device's
    engines' tokens, prefix copies and staged rows across data ranks
    included."""
    got = _sharded(run, "engines_dp_tp")
    assert got == run["refs"]["engines_dp_tp"]
    assert got["prefix_hits"] == 2 and got["staged_admissions"] == 1


def test_live_lora_under_data_and_tensor(run):
    """Whole pairs on every rank, each adding its shard's columns of the
    delta: one device's live LoRA in bits, and the JAX package's under the
    same mesh."""
    got = _same_as_one_device(run, "lora_dp_tp")
    _close(got, run["jax"]["lora_dp_tp"])


def test_live_lora_under_expert_and_tensor(run):
    _same_as_one_device(run, "lora_ep_tp")


def test_to_global_checks_every_rank_holds_the_same(run):
    assert _sharded(run, "to_global") == {"same": True, "raised_where_it_differs": True}


def test_cli_demo_under_torchrun(run):
    """``torchrun --nproc-per-node 2 -m mistral_inference_tpu_torch.main demo
    --tensor 2 --device cpu``: the primary rank alone prints the
    single-device demo's text."""
    rc, out, err = run["cli"]
    assert rc == 0, err[-4000:]
    assert out == run["demo"]
