"""The port's mesh and shard rules in one process, with no ranks
(``parallel/``): each rule against slices of the full leaf, the int4 repack
in bits, quantize-then-shard against shard-then-quantize, row-parallel
partial sums against the full product, ``auto_factorize`` and the rank
layout against the JAX package's, and every refusal. The sharded runs
themselves are in tests/test_torch_parallel_mp.py."""

import dataclasses

import pytest
import torch

from mistral_inference_tpu.parallel.mesh import auto_factorize as jax_auto_factorize
from mistral_inference_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mistral_inference_tpu_torch.args import LoraArgs, MoeArgs
from mistral_inference_tpu_torch.main import main
from mistral_inference_tpu_torch.model import Mamba, Transformer
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
    n = sizes.get("data", 1) * sizes.get("expert", 1) * sizes.get("tensor", 1)
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
    """rank = (d E + e) T + t, the device order of the JAX package's mesh."""
    devices = jax_make_mesh(data=data, expert=expert, tensor=tensor).devices
    for r in range(data * expert * tensor):
        d, e, t = coords(r, expert, tensor)
        assert (d * expert + e) * tensor + t == r
        assert devices[d, 0, e, t].id == r
        assert Mesh(data, expert, tensor, rank=r).coords == (d, e, t)


def test_mesh_without_groups_refuses_a_collective():
    mesh = Mesh(tensor=2, rank=1)
    with pytest.raises(RuntimeError, match="make_mesh"):
        mesh.all_reduce(torch.ones(2), "tensor")
    x = torch.ones(2)
    assert mesh.all_reduce(x, "data") is x  # an axis of one issues nothing
    assert not mesh.counts


def test_make_mesh_needs_a_process_group_and_refuses_seq():
    with pytest.raises(NotImplementedError, match="item 6b"):
        make_mesh(tensor=2, seq=2)
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh(tensor=2)


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


@pytest.mark.parametrize("bits,T", [(8, 2), (4, 2), (4, 4), (8, 8)])
def test_row_shard_repacks_in_bits(bits, T):
    """dequant(shard) == dequant(full)[rows] bit for bit: the int4 shard is
    repacked as split halves of its own K, its scale groups follow."""
    leaf = quantize_weight(_w(1024, 128, seed=1), bits, group=128)
    full = dequant(leaf, F32)
    K = 1024 // T
    for t in range(T):
        shard = sharding.shard_rows(leaf, t, T)
        key = "q4" if bits == 4 else "q"
        assert shard[key].shape[0] == (K // 2 if bits == 4 else K)
        assert torch.equal(dequant(shard, F32), full[t * K:(t + 1) * K])


def test_int4_repack_of_known_rows():
    """Logical rows r and r + K/2 share byte row r: a shard of K/2 rows
    packs its own first and second quarters of the full K."""
    K, N = 8, 2
    q = torch.arange(-4, 4).repeat_interleave(N).reshape(K, N).to(torch.int8)  # rows -4 .. 3
    lo, hi = q[:K // 2].to(torch.int32), q[K // 2:].to(torch.int32)
    packed = ((lo & 0xF) | (hi << 4)).to(torch.int8)
    got = sharding._repack_int4(packed, 1, 2)  # logical rows 4 .. 7 = values 0 .. 3
    want = ((torch.tensor([[0, 0], [1, 1]]) & 0xF) | (torch.tensor([[2, 2], [3, 3]]) << 4))
    assert torch.equal(got, want.to(torch.int8))


def test_expert_and_vocab_shards():
    stack = _w(8, 4, 6)
    assert torch.equal(sharding.shard_experts(stack, 1, 4), stack[2:4])
    head = _w(10, 3)
    assert torch.equal(sharding.shard_vocab(head, 1, 2), head[5:])


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_row_parallel_partials_sum_to_the_full_product(quant):
    """wo and w2 are row-parallel: the ranks' products on their slices of
    the input add up to the full product."""
    w = _w(512, 256, seed=2)  # (out, in)
    x = _w(3, 256, seed=3)
    full = w if quant is None else quantize_weight(w.t(), {"int8": 8, "int4": 4}[quant], 64)
    want = linear(x, full)
    got = sum(linear(x[:, 128 * t:128 * (t + 1)], sharding.shard_rows(full, t, 2))
              for t in range(2))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


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
    assert s0["wo"].shape[1] * 2 == lw["wo"].shape[1]
    if moe:
        assert s0["w13"].shape[0] * 2 == lw["w13"].shape[0]


@pytest.mark.parametrize("family,mode", [("transformer", "int8"), ("transformer", "int4"),
                                         ("mamba", "int8"), ("mamba", "int4")])
def test_quantize_then_shard_equals_shard_then_quantize(family, mode):
    """The groups align with the shards, so quantizing a shard gives the
    bytes of the shard of the quantized full model."""
    cls, args, group = ((Transformer, qargs(), 64) if family == "transformer"
                        else (Mamba, margs(dim=128, n_groups=4, d_state=32, headdim=32), 32))
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
    di, gd, nh = args.d_inner, args.n_groups * args.d_state, args.n_ssm_heads
    for t, shd in enumerate(shards):
        s = shd.params["layers"][0]
        rows = torch.cat([lw["in_proj"][part * di + t * di // 2:part * di + (t + 1) * di // 2]
                          for part in range(2)]
                         + [lw["in_proj"][2 * di + part * gd + t * gd // 2:
                                          2 * di + part * gd + (t + 1) * gd // 2]
                            for part in range(2)])
        assert torch.equal(s["in_proj"], rows)
        assert torch.equal(s["A_log"], lw["A_log"][t * nh // 2:(t + 1) * nh // 2])
        assert torch.equal(s["out_proj"], lw["out_proj"][:, t * di // 2:(t + 1) * di // 2])


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
    """wo's K = 128 splits to 64 at tensor = 2, which K3 refuses: the mesh is
    refused, at the quantization of the shard and for a model born
    quantized, and the shard never routes to a plain product."""
    shd = Transformer.random(targs(), dtype=F32, device="cpu", mesh=Mesh(tensor=2))
    with pytest.raises(ValueError, match="kernels refuse"):
        shd.quantize(quant, group=32)
    with pytest.raises(ValueError, match="kernels refuse"):
        Transformer.random(targs(), dtype=F32, device="cpu", mesh=Mesh(tensor=2), quant=quant,
                           group=32)


def test_misaligned_groups_raise():
    with pytest.raises(ValueError, match="quantization groups"):
        Transformer.random(qargs(), dtype=F32, device="cpu", mesh=Mesh(tensor=2)).quantize(
            "int8", group=256)


def test_live_lora_under_a_mesh_raises():
    args = targs(lora=LoraArgs(rank=4, scaling=2.0))
    with pytest.raises(NotImplementedError, match="item 6b"):
        Transformer.random(args, dtype=F32, device="cpu", mesh=Mesh(tensor=2))


def test_engines_under_data_raise():
    from mistral_inference_tpu_torch.server.engine import Engine
    from mistral_inference_tpu_torch.server.mamba_engine import MambaEngine

    mesh = Mesh(data=2, rank=0)
    with pytest.raises(NotImplementedError, match="item 6b"):
        Engine(Transformer.random(targs(), dtype=F32, device="cpu", mesh=mesh), 2, 32)
    with pytest.raises(NotImplementedError, match="item 6b"):
        MambaEngine(Mamba.random(margs(), dtype=F32, device="cpu", mesh=mesh), 2, 32)


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
    with pytest.raises(NotImplementedError, match="item 6b"):
        main(["demo", str(tmp_path), "--seq", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="needs 4 ranks, found 1"):
        main(["demo", str(tmp_path), "--tensor", "4", "--device", "cpu"])
