"""The port's mesh and shard rules in one process, with no ranks
(``parallel/``): each rule against slices of the full leaf, quantize-then-
shard against shard-then-quantize, each output shard's product against the
matching columns of the whole product, live LoRA deltas cut to a shard,
``auto_factorize`` and the rank layout against the JAX package's, and every
refusal. The sharded runs themselves are in tests/test_torch_parallel_mp.py."""

import dataclasses

import pytest
import torch

from mistral_inference_tpu.parallel.mesh import auto_factorize as jax_auto_factorize
from mistral_inference_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mistral_inference_tpu_torch.args import LoraArgs, MoeArgs
from mistral_inference_tpu_torch.main import main
from mistral_inference_tpu_torch.model import Mamba, Transformer
from mistral_inference_tpu_torch.models import transformer as tf
from mistral_inference_tpu_torch.ops.linear import dequant, linear, quantize_weight
from mistral_inference_tpu_torch.parallel import distributed, sharding
from mistral_inference_tpu_torch.parallel.mesh import (
    Mesh,
    auto_factorize,
    coords,
    make_mesh,
)
from torch_parallel_cases import margs, qargs, targs

F32 = torch.float32


def _w(*shape, seed=0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed), dtype=F32)


def _meshes(**sizes):
    """Every rank of a mesh of these sizes."""
    n = 1
    for v in sizes.values():
        n *= v
    return [Mesh(**sizes, rank=r) for r in range(n)]


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, int):  # a shard's "n_whole"
        assert a == b
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


# -- the mesh ------------------------------------------------------------------------


@pytest.mark.parametrize("n,kv,experts", [(8, 8, 0), (8, 2, 4), (1, 8, 0), (4, 8, 0),
                                          (8, 4, 8), (6, 4, 0), (16, 8, 8), (2, 1, 0)])
def test_auto_factorize_matches_jax(n, kv, experts):
    assert auto_factorize(n, n_kv_heads=kv, n_experts=experts) == jax_auto_factorize(
        n, n_kv_heads=kv, n_experts=experts)


@pytest.mark.parametrize("data,expert,tensor", [(2, 1, 2), (1, 2, 2), (2, 2, 2), (1, 1, 4),
                                                (4, 1, 1), (2, 4, 1)])
def test_rank_coordinates_match_jax_layout(data, expert, tensor):
    """rank = ((d S + s) E + e) T + t, the device order of the JAX package's
    mesh; here with S = 1."""
    devices = jax_make_mesh(data=data, expert=expert, tensor=tensor).devices
    for r in range(data * expert * tensor):
        d, s, e, t = coords(r, 1, expert, tensor)
        assert s == 0 and (d * expert + e) * tensor + t == r
        assert devices[d, 0, e, t].id == r
        assert Mesh(data, expert, tensor, rank=r).coords == (d, 0, e, t)


@pytest.mark.parametrize("data,seq,expert,tensor", [(1, 2, 1, 2), (2, 2, 1, 2), (1, 4, 1, 2),
                                                    (2, 2, 2, 1)])
def test_rank_coordinates_with_seq_match_jax_layout(data, seq, expert, tensor):
    devices = jax_make_mesh(data=data, seq=seq, expert=expert, tensor=tensor).devices
    for r in range(data * seq * expert * tensor):
        d, s, e, t = coords(r, seq, expert, tensor)
        assert ((d * seq + s) * expert + e) * tensor + t == r
        assert devices[d, s, e, t].id == r
        assert Mesh(data, expert, tensor, seq=seq, rank=r).coords == (d, s, e, t)


def test_mesh_without_groups_refuses_a_collective():
    mesh = Mesh(tensor=2, rank=1)
    with pytest.raises(RuntimeError, match="make_mesh"):
        mesh.all_reduce(torch.ones(2), "tensor")
    x = torch.ones(2)
    assert mesh.all_reduce(x, "data") is x  # an axis of one issues nothing
    assert not mesh.counts


def test_make_mesh_needs_a_process_group_and_refuses_seq():
    """A mesh needs the process group, with or without seq; a seq rank
    splits a chunk only where seq divides it (the JAX package's
    ``seq_axis``), never a decode step."""
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh(tensor=2, seq=2)
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh(tensor=2)
    mesh = Mesh(tensor=2, seq=2, rank=3)
    assert (mesh.size, mesh.s, mesh.t) == (4, 1, 1)
    assert mesh.seq_split(8) and not mesh.seq_split(9) and not mesh.seq_split(1)
    assert not Mesh(tensor=2).seq_split(8)


# -- the leaf rules -----------------------------------------------------------------------


def test_column_shard_slices_each_fused_part():
    """wqkv (out, in) with q, k, v of 8, 4 and 4 rows: rank t of 2 takes
    rows [4t, 4t + 4) of q, [2t, 2t + 2) of k and of v."""
    w = _w(16, 6)
    for t in range(2):
        got = sharding.shard_columns(w, [8, 4, 4], t, 2)
        want = torch.cat([w[4 * t:4 * t + 4], w[8 + 2 * t:10 + 2 * t], w[12 + 2 * t:14 + 2 * t]])
        assert torch.equal(got, want)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_column_shard_is_the_shard_of_the_dequantized(bits):
    leaf = quantize_weight(_w(256, 3 * 128), bits, group=64)
    full = dequant(leaf, F32)
    for t in range(2):
        got = dequant(sharding.shard_columns(leaf, [256, 64, 64], t, 2), F32)
        cols = [slice(128 * t, 128 * t + 128), slice(256 + 32 * t, 288 + 32 * t),
                slice(320 + 32 * t, 352 + 32 * t)]
        assert torch.equal(got, torch.cat([full[:, c] for c in cols], 1))


def test_expert_and_vocab_shards():
    stack = _w(8, 4, 6)
    assert torch.equal(sharding.shard_experts(stack, 1, 4), stack[2:4])
    head = _w(10, 3)
    assert torch.equal(sharding.shard_vocab(head, 1, 2), head[5:])


# (seed, K, N) of each output-sharded weight: a layer's wo and w2, an expert
# stack's w2, Mamba's out_proj
OUTPUT_LEAVES = {"wo": (1, 256, 256), "w2": (2, 512, 256), "experts_w2": (3, 512, 256),
                 "out_proj": (4, 512, 256)}


def _output_leaf(which: str, quant):
    """(the whole weight of ``which``, its input width K), dense or
    quantized as a model holds it."""
    seed, K, N = OUTPUT_LEAVES[which]
    gen = torch.Generator().manual_seed(seed)
    bits = {None: 0, "int8": 8, "int4": 4}[quant]
    if which == "experts_w2":
        w = torch.randn((3, K, N), generator=gen)  # (E, in, out), applied as x @ w
        return (quantize_weight(w, bits, 64) if bits else w), K
    w = torch.randn((N, K), generator=gen)  # (out, in)
    return (quantize_weight(w.t(), bits, 64) if bits else w), K


def _apply(w, x):
    if isinstance(w, dict) and w["scale"].dim() == 3:  # an expert stack, per expert
        return torch.stack([linear(x, {k: v[e] for k, v in w.items()})
                            for e in range(w["scale"].shape[0])])
    if not isinstance(w, dict) and w.dim() == 3:
        return torch.matmul(x, w)
    return linear(x, w)


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("which", ["wo", "w2", "experts_w2", "out_proj"])
def test_output_shard_is_the_columns_of_the_whole_product(which, quant):
    """wo, w2, the experts' w2 and Mamba's out_proj shard their output
    axis: each rank's product on the whole input is the matching D / T
    columns of the whole product, in bits; a quantized two-dimensional
    shard carries its whole N for K3's split."""
    w, K = _output_leaf(which, quant)
    x = _w(5, K, seed=9)
    whole = _apply(w, x)
    N = whole.shape[-1]
    for t in range(2):
        shard = sharding.mark_whole_n({"w": sharding.shard_columns(w, [N], t, 2)}, 2)["w"]
        assert torch.equal(_apply(shard, x), whole[..., t * N // 2:(t + 1) * N // 2])
        if quant is not None and which != "experts_w2":
            assert shard["n_whole"] == N and shard["scale"].shape[-1] == N // 2
        else:
            assert not isinstance(shard, dict) or "n_whole" not in shard


# -- whole models -------------------------------------------------------------------


def _full_and_shards(cls, args, seed, meshes, **kw):
    full = cls.random(dataclasses.replace(args), dtype=F32, seed=seed, device="cpu", **kw)
    shards = [cls.random(dataclasses.replace(args), dtype=F32, seed=seed, device="cpu",
                         mesh=m, **kw) for m in meshes]
    return full, shards


@pytest.mark.parametrize("moe", [False, True])
def test_random_under_mesh_is_the_shard_of_the_full_model(moe):
    args = targs(moe=MoeArgs(4, 2)) if moe else targs()
    meshes = _meshes(expert=2, tensor=2) if moe else _meshes(data=2, tensor=2)
    full, shards = _full_and_shards(Transformer, args, 5, meshes)
    for m, shd in zip(meshes, shards):
        _equal(shd.params, sharding.shard_params(
            {**full.params, "layers": list(full.params["layers"])}, full.args, m))
    lw, s0 = full.params["layers"][0], shards[0].params["layers"][0]
    assert s0["wqkv"].shape[0] * 2 == lw["wqkv"].shape[0]
    assert s0["wo"].shape[0] * 2 == lw["wo"].shape[0] and s0["wo"].shape[1] == lw["wo"].shape[1]
    if moe:
        assert s0["w13"].shape[0] * 2 == lw["w13"].shape[0]


@pytest.mark.parametrize("family,mode", [("transformer", "int8"), ("transformer", "int4"),
                                         ("mamba", "int8"), ("mamba", "int4")])
def test_quantize_then_shard_equals_shard_then_quantize(family, mode):
    """The groups align with the shards, so quantizing a shard gives the
    bytes of the shard of the quantized full model."""
    cls, args, group = ((Transformer, qargs(), 64) if family == "transformer"
                        else (Mamba, margs(dim=256, n_groups=4, d_state=32, headdim=32), 32))
    meshes = _meshes(tensor=2)
    full, shards = _full_and_shards(cls, args, 6, meshes)
    full.quantize(mode, group=group)
    shard = sharding.shard_params if family == "transformer" else sharding.shard_mamba_params
    for m, shd in zip(meshes, shards):
        shd.quantize(mode, group=group)
        _equal(shd.params["layers"], shard(
            {**full.params, "layers": list(full.params["layers"])}, full.args, m)["layers"])


def test_born_quantized_under_mesh_is_the_shard_of_the_quantized_model():
    meshes = _meshes(tensor=2)
    full, shards = _full_and_shards(Transformer, qargs(), 7, meshes, quant="int4", group=64)
    for m, shd in zip(meshes, shards):
        _equal(shd.params["layers"], sharding.shard_params(
            {**full.params, "layers": list(full.params["layers"])}, full.args, m)["layers"])


def test_mamba_shard_takes_its_heads_of_each_part():
    args = margs()
    meshes = _meshes(tensor=2)
    full, shards = _full_and_shards(Mamba, args, 8, meshes)
    lw = full.params["layers"][0]
    di, gd, nh, D = args.d_inner, args.n_groups * args.d_state, args.n_ssm_heads, args.dim
    for t, shd in enumerate(shards):
        s = shd.params["layers"][0]
        rows = torch.cat([lw["in_proj"][part * di + t * di // 2:part * di + (t + 1) * di // 2]
                          for part in range(2)]
                         + [lw["in_proj"][2 * di + part * gd + t * gd // 2:
                                          2 * di + part * gd + (t + 1) * gd // 2]
                            for part in range(2)])
        assert torch.equal(s["in_proj"], rows)
        assert torch.equal(s["A_log"], lw["A_log"][t * nh // 2:(t + 1) * nh // 2])
        assert torch.equal(s["out_proj"], lw["out_proj"][t * D // 2:(t + 1) * D // 2])
        assert torch.equal(s["dt_proj"], lw["dt_proj"]) and torch.equal(s["mixer_norm"],
                                                                       lw["mixer_norm"])


def test_cache_and_state_hold_local_heads_and_rows():
    mesh = Mesh(data=2, tensor=2, rank=3)  # d = 1, t = 1
    model = Transformer.random(targs(kv_quant="int8"), dtype=F32, device="cpu", mesh=mesh)
    cache = model.alloc_cache(3, 16)
    assert cache.k.shape[1] == 2 and cache.row0 == 2 and cache.kv_len.shape == (3,)
    assert cache.k.shape[-1] == targs().n_kv_heads // 2 * targs().head_dim
    assert cache.k_scale.shape[2] == 1
    mamba = Mamba.random(margs(), dtype=F32, device="cpu", mesh=mesh)
    state = mamba.alloc_state(3)
    assert state.ssm.shape[1:3] == (2, margs().n_ssm_heads // 2) and state.row0 == 2
    assert state.conv.shape[-1] == margs().conv_dim // 2


# -- refusals ---------------------------------------------------------------------------


@pytest.mark.parametrize("args,sizes,match", [
    (targs(n_heads=6, n_kv_heads=2), dict(tensor=4), "n_heads"),
    (targs(n_heads=4, n_kv_heads=1), dict(tensor=2), "n_kv_heads"),
    (targs(vocab_size=501), dict(tensor=2), "vocab_size"),
    (targs(moe=MoeArgs(6, 2)), dict(expert=4), "n_experts"),
    (targs(), dict(expert=2), "needs an MoE model"),
])
def test_an_axis_that_does_not_divide_raises(args, sizes, match):
    with pytest.raises(ValueError, match=match):
        Transformer.random(args, dtype=F32, device="cpu", mesh=Mesh(**sizes))


def test_mamba_axis_that_does_not_divide_raises():
    with pytest.raises(ValueError, match="n_groups"):
        Mamba.random(margs(), dtype=F32, device="cpu", mesh=Mesh(tensor=4))


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_a_shard_the_kernels_refuse_raises(quant):
    """wo's N = 128 splits to 64 at tensor = 2, which K3 refuses: the mesh is
    refused, at the quantization of the shard and for a model born
    quantized, and the shard never routes to a plain product."""
    shd = Transformer.random(targs(), dtype=F32, device="cpu", mesh=Mesh(tensor=2))
    with pytest.raises(ValueError, match="kernels refuse"):
        shd.quantize(quant, group=32)
    with pytest.raises(ValueError, match="kernels refuse"):
        Transformer.random(targs(), dtype=F32, device="cpu", mesh=Mesh(tensor=2), quant=quant,
                           group=32)


def test_misaligned_groups_raise():
    """A group of 256 puts ``wo``'s whole K = 256 in one group; at dim =
    128 its shard, 256 x 64, is refused, and the refusal names the shard's
    quantization groups (a shard keeps its whole K, so its groups are the
    whole weight's)."""
    with pytest.raises(ValueError, match="256 x 64 in 1 quantization groups"):
        Transformer.random(qargs(dim=128), dtype=F32, device="cpu",
                           mesh=Mesh(tensor=2)).quantize("int8", group=256)


def test_live_lora_under_a_mesh_raises():
    """Live pairs under a mesh: whole on every rank (the JAX package
    replicates them, zero until an adapter is loaded), and each rank's delta
    of every adapted linear is its shard's columns of the whole delta, piece
    t of each fused part."""
    args = targs(lora=LoraArgs(rank=4, scaling=2.0))
    full = Transformer.random(args, dtype=F32, device="cpu")
    lw = full.params["layers"][0]
    shards = [Transformer.random(args, dtype=F32, device="cpu", mesh=m) for m in _meshes(tensor=2)]
    for shd in shards:
        _equal(shd.params["layers"][0]["lora"], lw["lora"])
    gen = torch.Generator().manual_seed(0)
    for pair in lw["lora"].values():
        for t_ in pair.values():
            t_.copy_(torch.randn(t_.shape, generator=gen))
    for key, names in tf.LORA_PARTS.items():
        x = _w(3, lw["lora"][names[0]]["a"].shape[0], seed=5)
        whole = tf._lora_delta(x, lw, key, args)
        sizes = [lw["lora"][n]["b"].shape[-1] for n in names]
        for m in _meshes(tensor=2):
            want = torch.cat([whole[..., s] for s in sharding._part_slices(sizes, m.t, 2)], -1)
            assert torch.equal(tf._lora_delta(x, lw, key, args, mesh=m), want)


def test_engines_under_data_raise():
    """The engines serve under data: a slot's ring row or state row lives on
    its data rank (rows [d b, (d + 1) b)), its fill and carry on every rank."""
    from mistral_inference_tpu_torch.server.engine import Engine
    from mistral_inference_tpu_torch.server.mamba_engine import MambaEngine

    mesh = Mesh(data=2, rank=1)
    eng = Engine(Transformer.random(targs(), dtype=F32, device="cpu", mesh=mesh), 3, 32)
    assert (eng.cache.k.shape[1], eng.cache.row0, eng.cache.kv_len.shape) == (2, 2, (3,))
    assert eng.carry.shape[0] == 3
    meng = MambaEngine(Mamba.random(margs(), dtype=F32, device="cpu", mesh=mesh), 3, 32)
    assert (meng.state.ssm.shape[1], meng.state.row0, meng.state.seen.shape) == (2, 2, (3,))


def test_ranks_sharing_a_gpu_need_gloo(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="backend='gloo'"):
        distributed._backend(None, "cuda")
    with pytest.raises(ValueError, match="duplicate GPU"):
        distributed._backend("nccl", "cuda")
    assert distributed._backend("gloo", "cuda") == "gloo"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert distributed._backend(None, "cuda") == "nccl"
    assert distributed._backend(None, "cpu") == "gloo"


def test_cli_seq_and_tensor_without_ranks_raise(tmp_path):
    from test_torch_parallel_mp import _cli_folder

    tmp_path = _cli_folder(tmp_path)
    with pytest.raises(ValueError, match="--tensor 2 x --seq 2 needs 4 ranks, found 1"):
        main(["demo", str(tmp_path), "--seq", "2", "--tensor", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="needs 4 ranks, found 1"):
        main(["demo", str(tmp_path), "--tensor", "4", "--device", "cpu"])


def test_mamba_under_seq_raises_as_the_jax_cli_does(tmp_path):
    from test_torch_cli import _tekken
    from test_torch_loading import write_reference_folder

    write_reference_folder(tmp_path, "mamba", seed=3)
    _tekken(tmp_path)
    with pytest.raises(ValueError, match="--seq applies to transformer models only"):
        main(["demo", str(tmp_path), "--seq", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="--seq applies to transformer models only"):
        Mamba.random(margs(), dtype=F32, device="cpu", mesh=Mesh(seq=2))
