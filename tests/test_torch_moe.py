"""The sparse-MoE feed-forward of the port against the JAX package's, module
by module, in fp32 on the CPU with inputs from a numpy seed.

* K8's plain version (``moe_matmul_quant`` / ``moe_matmul_quant_stacked``)
  against the Pallas kernels in interpret mode at tests/test_pallas.py's
  shapes: atol = rtol = 1e-4, that file's own tolerance (both sides sum each
  group's dot in fp32 and scale after it, in another order).
* ``_moe_ffn``, ``_moe_ffn_ragged`` (kernel engine and fallback engine) and
  ``_moe_ffn_dispatch`` against their JAX counterparts on one layer's weights:
  2e-5, tests/test_pallas.py's tolerance for the dispatch oracle (fp32 sums in
  another order through two products and a SiLU). The JAX kernel engines run
  with ``fused_quant=True`` under ``MISTRAL_PALLAS_INTERPRET=1``.
* ``quantize_params`` and ``convert.params_from_numpy`` on MoE trees: the
  bytes and scales are equal to the JAX package's.

The CUDA kernel itself needs the card: tests/test_torch_cuda.py holds it
against the plain version there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistral_inference_tpu.args import MoeArgs as JaxMoeArgs
from mistral_inference_tpu.args import TransformerArgs as JaxArgs
from mistral_inference_tpu.model import Transformer as JaxTransformer
from mistral_inference_tpu.models import transformer as jtf
from mistral_inference_tpu.ops.linear import quantize_weight
from mistral_inference_tpu.ops.pallas import moe_matmul as jmm
from mistral_inference_tpu_torch.args import TransformerArgs
from mistral_inference_tpu_torch.convert import params_from_numpy
from mistral_inference_tpu_torch.model import Transformer
from mistral_inference_tpu_torch.models import transformer as ttf
from mistral_inference_tpu_torch.ops import linear as tlin
from mistral_inference_tpu_torch.ops.cuda import moe_matmul as mm
from mistral_inference_tpu_torch.quant.weights import init_quantized_params

FFN_TOL = dict(atol=2e-5, rtol=2e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# K8's plain version against the Pallas kernels
# ---------------------------------------------------------------------------


def _expert_case(seed, lead, C, K, N, bits, group):
    rng = np.random.default_rng(seed)
    E = lead[-1]
    x = rng.standard_normal((E, C, K)).astype(np.float32) * 0.3
    w = jnp.asarray(rng.standard_normal((*lead, K, N)).astype(np.float32) * 0.1)
    qw = quantize_weight(w, bits=bits, group=group)
    return x, qw["q4" if bits == 4 else "q"], qw["scale"]


@pytest.mark.parametrize("bits,E,C,K,N,group", [
    (8, 4, 8, 256, 512, 128),
    (4, 4, 8, 256, 512, 128),
    (8, 2, 16, 512, 256, 128),
    (4, 8, 8, 256, 384, 256),  # one group; the Pallas side falls to its 128-wide tile
])
def test_moe_matmul_quant_plain_matches_pallas(bits, E, C, K, N, group):
    x, q, scale = _expert_case(bits + E + K, (E,), C, K, N, bits, group)
    x[-1] = 0  # an expert with an empty buffer gives zeros
    ref = jmm.moe_matmul_quant(jnp.asarray(x), q, scale, interpret=True)
    out = mm.moe_matmul_quant_plain(_t(x), _t(q), _t(scale))
    assert out.dtype == torch.float32 and out.shape == (E, C, N)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    assert not bool(out[-1].any())
    # On CPU tensors the wrapper runs the plain version and counts nothing.
    before = mm.moe_matmul_quant.launches
    assert torch.equal(mm.moe_matmul_quant(_t(x), _t(q), _t(scale)), out)
    assert mm.moe_matmul_quant.launches == before
    # Each expert is its weight's K3 product: the parity decode == prefill leans on.
    from mistral_inference_tpu_torch.ops.cuda.matmul_quant import matmul_quant_plain

    for e in range(E):
        assert torch.equal(out[e], matmul_quant_plain(_t(x)[e], _t(q)[e], _t(scale)[e]))


@pytest.mark.parametrize("bits", [8, 4])
def test_moe_matmul_quant_stacked_plain_matches_pallas(bits):
    L, E, C, K, N, group = 3, 4, 8, 256, 512, 128
    x, q, scale = _expert_case(bits, (L, E), C, K, N, bits, group)
    for li in range(L):
        ref = jmm.moe_matmul_quant_stacked(jnp.asarray(x), q, scale, jnp.int32(li), interpret=True)
        out = mm.moe_matmul_quant_stacked(_t(x), _t(q), _t(scale), li)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4,
                                   err_msg=f"layer {li}")
        assert torch.equal(out, mm.moe_matmul_quant_plain(_t(x), _t(q)[li], _t(scale)[li]))


def test_moe_matmul_quant_wrappers_check_ranks():
    x, q, scale = _expert_case(0, (2, 2), 4, 128, 128, 8, 64)
    with pytest.raises(ValueError, match="takes x"):
        mm.moe_matmul_quant(_t(x), _t(q), _t(scale))
    with pytest.raises(ValueError, match="stacked takes"):
        mm.moe_matmul_quant_stacked(_t(x), _t(q)[0], _t(scale)[0], 0)
    with pytest.raises(ValueError, match="neither int8 nor packed int4"):
        mm.moe_matmul_quant(_t(x)[..., :96], _t(q)[0], _t(scale)[0])


# ---------------------------------------------------------------------------
# The three feed-forwards against the JAX package's
# ---------------------------------------------------------------------------


def _layer(seed, N, D, F, E, bits=None, group=128, gate_scale=0.1):
    """One MoE layer's weights in the JAX layout, and x (N, D)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32) * 0.2
    w = {"gate": jnp.asarray(rng.standard_normal((D, E)).astype(np.float32) * gate_scale)}
    for name, shape in (("w1", (E, D, F)), ("w3", (E, D, F)), ("w2", (E, F, D))):
        dense = jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 0.05)
        w[name] = dense if bits is None else quantize_weight(dense, bits=bits, group=group)
    return x, w


def _port_layer(w):
    """The port's leaves of one JAX MoE layer: the rules of convert.py."""
    def fuse(*leaves):
        if isinstance(leaves[0], dict):
            return {k: _t(np.concatenate([np.asarray(leaf[k]) for leaf in leaves], -1))
                    for k in leaves[0]}
        return _t(np.concatenate([np.asarray(leaf) for leaf in leaves], -1))

    return {"gate": _t(np.asarray(w["gate"]).T), "w13": fuse(w["w1"], w["w3"]),
            "w2": fuse(w["w2"])}


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_moe_ffn_matches_jax(bits):
    x, w = _layer(1, 24, 256, 512, 8, bits)
    ref = jtf._moe_ffn(jnp.asarray(x), w, 2)
    out = ttf._moe_ffn(_t(x), _port_layer(w), 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FFN_TOL)


@pytest.mark.parametrize("bits,F,engine", [
    (8, 512, "kernel"),
    (4, 512, "kernel"),
    (None, 512, "fallback"),  # plain weights
    (4, 384, "fallback"),  # hidden % 256 != 0 closes the kernel's gate on both sides
])
def test_moe_ffn_ragged_matches_jax(monkeypatch, bits, F, engine):
    """300 rows, top-2 of 4 experts: 600 assignments in (3 + 4) tiles of 256."""
    monkeypatch.setenv("MISTRAL_PALLAS_INTERPRET", "1")
    x, w = _layer(2, 300, 256, F, 4, bits)
    seen = {"port": 0, "jax": 0}
    for module, key in ((ttf, "port"), (jmm, "jax")):
        def counted(*a, _fn=module.moe_matmul_quant_ragged, _key=key, **kw):
            seen[_key] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(module, "moe_matmul_quant_ragged", counted)
    ref = jtf._moe_ffn_ragged(jnp.asarray(x), w, 2, fused_quant=True)
    out = ttf._moe_ffn_ragged(_t(x), _port_layer(w), 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FFN_TOL)
    # Both sides took the same engine: w13 and w2 in the port (one fused
    # launch for w1 | w3), w1, w3 and w2 in the JAX package.
    assert seen == ({"port": 2, "jax": 3} if engine == "kernel" else {"port": 0, "jax": 0})
    # Drop-free: equal to the dense oracle.
    oracle = ttf._moe_ffn(_t(x), _port_layer(w), 2)
    np.testing.assert_allclose(out.numpy(), oracle.numpy(), **FFN_TOL)


def test_moe_ffn_ragged_tiles_stay_in_bounds(monkeypatch):
    """The padded layout: every tile's expert index lies in [0, E), trailing
    tiles carry the clamped E - 1, and the row count depends on N alone."""
    x, w = _layer(3, 300, 256, 512, 4, 8)
    seen = []

    def spy(inp, q, scale, tile_group, li=None):
        seen.append((inp.shape[0], tile_group.clone()))
        return mm.moe_matmul_quant_ragged(inp, q, scale, tile_group, li)

    monkeypatch.setattr(ttf, "moe_matmul_quant_ragged", spy)
    ttf._moe_ffn_ragged(_t(x), _port_layer(w), 2)
    rows, tg = seen[0]
    assert rows == (3 + 4) * 256 and tg.dtype == torch.int32 and tg.shape == (7,)
    assert int(tg.min()) >= 0 and int(tg.max()) == 3 and bool((tg[1:] >= tg[:-1]).all())


@pytest.mark.parametrize("bits", [None, 8, 4])
@pytest.mark.parametrize("N,E,factor,drops", [
    (16, 4, 4.0, False),  # full capacity: equal to the dense oracle
    (16, 4, 0.25, True),  # 8 slots an expert for 32 assignments: some drop
    (40, 8, 1.0, True),
])
def test_moe_ffn_dispatch_matches_jax(monkeypatch, bits, N, E, factor, drops):
    monkeypatch.setenv("MISTRAL_PALLAS_INTERPRET", "1")
    x, w = _layer(4 + N, N, 256, 512, E, bits, gate_scale=1.0)
    calls = []
    monkeypatch.setattr(ttf, "moe_matmul_quant",
                        lambda *a, _fn=ttf.moe_matmul_quant: calls.append(1) or _fn(*a))
    ref = jtf._moe_ffn_dispatch(jnp.asarray(x), w, 2, factor, fused_quant=True)
    pw = _port_layer(w)
    out = ttf._moe_ffn_dispatch(_t(x), pw, 2, factor)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FFN_TOL)
    assert len(calls) == (0 if bits is None else 2)  # K8's route: w13, w2
    oracle = ttf._moe_ffn(_t(x), pw, 2)
    same = np.allclose(out.numpy(), oracle.numpy(), **FFN_TOL)
    assert same != drops, "a dropped assignment contributes zero; a kept one all it has"


def test_moe_ffn_dispatch_routes_pad_rows_like_jax():
    """Ragged rows: forward() hands every position of (B, T) to the router,
    pad positions included, and they take slots in token-major order. A pad
    row's input here is the embedding of token 0 after a norm, like any
    other; what matters is that both sides rank the same rows the same way,
    so that the drops fall on the same assignments."""
    B, T, D, E = 3, 12, 256, 4
    x, w = _layer(9, B * T, D, 512, E, gate_scale=1.0)
    x = x.reshape(B, T, D)
    x[1, 5:] = x[0, 0]  # a short row padded with one repeated vector
    x[2, 2:] = x[0, 0]
    x = x.reshape(B * T, D)
    ref = jtf._moe_ffn_dispatch(jnp.asarray(x), w, 2, 0.5)
    out = ttf._moe_ffn_dispatch(_t(x), _port_layer(w), 2, 0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FFN_TOL)
    # The repeated pad vector fills its experts' 9 slots: later pads drop.
    assert not np.allclose(out.numpy(), ttf._moe_ffn(_t(x), _port_layer(w), 2).numpy(), **FFN_TOL)


@pytest.mark.parametrize("impl", ["dense", "ragged", "dispatch"])
def test_router_tie_goes_to_the_lower_expert(impl):
    """Experts 1, 3 and 5 share one gate column, so their logits tie exactly
    on every token; where the tie is in the top two, ``jax.lax.top_k`` takes
    the lower index first and so must the port. The experts' own weights
    differ, so a wrong choice changes the output."""
    N = 300 if impl == "ragged" else 20
    x, w = _layer(11, N, 256, 512, 6, gate_scale=1.0)
    gate = np.array(w["gate"])
    gate[:, 3] = gate[:, 5] = gate[:, 1]
    w["gate"] = jnp.asarray(gate)
    pw = _port_layer(w)
    idx, top_w = ttf._route(_t(x), pw["gate"], 2)
    logits = np.asarray(jnp.asarray(x) @ w["gate"])
    jidx = np.asarray(jax.lax.top_k(jnp.asarray(logits), 2)[1])
    np.testing.assert_array_equal(idx.numpy(), jidx)
    tied_first = (idx[:, 0] == 1) & (idx[:, 1] == 3)
    tied_second = (idx[:, 0] != 1) & (idx[:, 1] == 1)
    assert bool(tied_first.any()) and bool(tied_second.any())
    assert not bool(((idx == 5).any(dim=1)).any()), "expert 5 never wins a tie"
    if impl == "dense":
        ref, out = jtf._moe_ffn(jnp.asarray(x), w, 2), ttf._moe_ffn(_t(x), pw, 2)
    elif impl == "ragged":
        ref = jtf._moe_ffn_ragged(jnp.asarray(x), w, 2)
        out = ttf._moe_ffn_ragged(_t(x), pw, 2)
    else:
        ref = jtf._moe_ffn_dispatch(jnp.asarray(x), w, 2, 2.0)
        out = ttf._moe_ffn_dispatch(_t(x), pw, 2, 2.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FFN_TOL)


def test_route_orders_constructed_ties():
    gate = torch.eye(4)
    x = torch.tensor([[1.0, 2.0, 2.0, 0.0], [3.0, 3.0, 3.0, 3.0], [0.0, 1.0, 0.0, 1.0]])
    idx, top_w = ttf._route(x, gate, 2)
    assert idx.tolist() == [[1, 2], [0, 1], [1, 3]]
    np.testing.assert_allclose(top_w.numpy(), np.full((3, 2), 0.5), atol=1e-7)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("N", [12, 300])
def test_layer_stacked_expert_leaves(monkeypatch, bits, N):
    """A leaf may hold a whole (L, E, ...) stack plus ``"li"``, the layer to
    use (ops/linear.py): the dispatch path then reads it in place through
    ``moe_matmul_quant_stacked`` (12 rows) or K5's layer argument (300 rows),
    and gives the per-layer leaf's result."""
    x, w = _layer(6 + N, N, 256, 512, 4, bits)
    pw = _port_layer(w)
    other = _port_layer(_layer(7, N, 256, 512, 4, bits)[1])
    li = 1
    stacked = {"gate": pw["gate"]}
    for name in ("w13", "w2"):
        pair = [other[name], pw[name]]
        stacked[name] = {k: torch.stack([leaf[k] for leaf in pair]) for k in pw[name]}
        stacked[name]["li"] = li
    calls = []
    monkeypatch.setattr(ttf, "moe_matmul_quant_stacked",
                        lambda *a, _fn=ttf.moe_matmul_quant_stacked: calls.append(a[-1]) or _fn(*a))
    out = ttf._moe_ffn_dispatch(_t(x), stacked, 2, 2.0)
    assert torch.equal(out, ttf._moe_ffn_dispatch(_t(x), pw, 2, 2.0))
    assert calls == ([li, li] if N <= 256 else [])
    np.testing.assert_allclose(out.numpy(), ttf._moe_ffn(_t(x), stacked, 2).numpy(), **FFN_TOL)


@pytest.mark.parametrize("N,k,E,factor,expect", [
    (4, 2, 8, 2.0, 4),  # decode at B = 4: max(8, 2) capped by N
    (16, 2, 4, 0.25, 8),
    (200, 2, 8, 2.0, 100),
    (256, 2, 8, 1.25, 80),
])
def test_moe_capacity_is_the_jax_rule(N, k, E, factor, expect):
    C = max(8, int(-(-N * k * factor // E)))  # models/transformer.py of the JAX package
    assert ttf.moe_capacity(N, k, E, factor) == min(C, N) == expect


def test_dispatch_hands_over_to_ragged_above_256_rows(monkeypatch):
    x, w = _layer(5, 257, 256, 512, 4, 8)
    called = []
    monkeypatch.setattr(ttf, "_moe_ffn_ragged", lambda *a: called.append(a[0].shape) or a[0])
    ttf._moe_ffn_dispatch(_t(x), _port_layer(w), 2, 2.0)
    ttf._moe_ffn_dispatch(_t(x)[:256], _port_layer(w), 2, 2.0)
    assert called == [(257, 256)]


# ---------------------------------------------------------------------------
# Quantization and conversion of MoE trees
# ---------------------------------------------------------------------------


def jax_moe_args(**overrides) -> JaxArgs:
    kw = dict(dim=256, n_layers=2, head_dim=128, hidden_dim=512, n_heads=2, n_kv_heads=1,
              norm_eps=1e-5, vocab_size=512, max_batch_size=4, rope_theta=10000.0,
              kv_quant="int8", moe=JaxMoeArgs(num_experts=4, num_experts_per_tok=2))
    kw.update(overrides)
    return JaxArgs(**kw)


def port_of(jmodel) -> Transformer:
    args = TransformerArgs.from_dict(dataclasses.asdict(jmodel.args))
    params = params_from_numpy(jax.tree.map(np.asarray, jmodel.params), device="cpu")
    return Transformer(args, params, torch.float32, device="cpu")


def _leaves(params):
    for i, lw in enumerate(params["layers"]):
        for name, w in lw.items():
            if tlin.is_quantized(w):
                for key, t in w.items():
                    yield f"layers[{i}].{name}.{key}", t
            else:
                yield f"layers[{i}].{name}", w


def test_args_carry_the_moe_fields():
    jargs = jax_moe_args(moe_impl="dispatch", moe_capacity_factor=1.5)
    args = TransformerArgs.from_dict(dataclasses.asdict(jargs))
    assert args.moe.num_experts == 4 and args.moe.num_experts_per_tok == 2
    assert args.moe_impl == "dispatch" and args.moe_capacity_factor == 1.5
    assert TransformerArgs.from_dict(dataclasses.asdict(jax_moe_args(moe=None))).moe is None
    with pytest.raises(ValueError, match="moe_impl"):
        TransformerArgs.from_dict({**dataclasses.asdict(jargs), "moe_impl": "ragged"})
    with pytest.raises(ValueError, match="LoRA"):
        TransformerArgs.from_dict({**dataclasses.asdict(jargs), "lora": {"rank": 4, "scaling": 2.0}})


def test_convert_plain_moe_tree():
    jmodel = JaxTransformer.random(jax_moe_args(), dtype=jnp.float32, seed=5)
    model = port_of(jmodel)
    moe = jax.tree.map(np.asarray, jmodel.params["layers"]["moe"])
    for i, lw in enumerate(model.params["layers"]):
        assert sorted(lw) == ["attention_norm", "ffn_norm", "gate", "w13", "w2", "wo", "wqkv"]
        assert lw["gate"].shape == (4, 256) and lw["w13"].shape == (4, 256, 1024)
        assert lw["w2"].shape == (4, 512, 256)
        np.testing.assert_array_equal(lw["gate"].numpy(), moe["gate"][i].T)
        np.testing.assert_array_equal(lw["w13"][..., :512].numpy(), moe["w1"][i])
        np.testing.assert_array_equal(lw["w13"][..., 512:].numpy(), moe["w3"][i])
        np.testing.assert_array_equal(lw["w2"].numpy(), moe["w2"][i])
        assert all(t.is_contiguous() for t in lw.values())


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_port_quantize_gives_the_converted_moe_bytes(mode):
    """Quantizing converted MoE weights in the port == converting the tree the
    JAX package quantized: an (E, in, out) stack quantizes in one call, and
    the fused w13 leaf is the exact concatenation of w1's and w3's."""
    jmodel = JaxTransformer.random(jax_moe_args(), dtype=jnp.float32, seed=5)
    model = port_of(jmodel)
    dense_count = ttf.param_count(model.params)
    assert model.quantize(mode, group=64) is model and model.args.quant == mode
    ref = port_of(jmodel.quantize(mode, group=64))
    ours, theirs = dict(_leaves(model.params)), dict(_leaves(ref.params))
    assert sorted(ours) == sorted(theirs)
    for name, t in ours.items():
        assert t.dtype == theirs[name].dtype and t.is_contiguous(), name
        assert torch.equal(t, theirs[name]), name
    key = "q4" if mode == "int4" else "q"
    lw = model.params["layers"][0]
    assert lw["w13"][key].shape == (4, 256 // (2 if mode == "int4" else 1), 1024)
    assert lw["w2"]["scale"].shape == (4, 512 // 64, 256)
    assert not tlin.is_quantized(lw["gate"]), "the router stays in the model dtype"
    assert ttf.param_count(model.params) == dense_count
    with pytest.raises(ValueError, match="already quantized"):
        model.quantize(mode)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_born_quantized_moe_equals_quantized_after(mode):
    """``Transformer.random(quant=...)`` quantizes each weight as it is drawn,
    one expert at a time: the same model as ``random().quantize()``."""
    args = TransformerArgs.from_dict(dataclasses.asdict(jax_moe_args()))
    after = Transformer.random(dataclasses.replace(args), torch.float32, seed=3, device="cpu")
    after.quantize(mode, group=64)
    born = Transformer.random(dataclasses.replace(args), torch.float32, seed=3, device="cpu",
                              quant=mode, group=64)
    assert born.args.quant == mode
    ours, theirs = dict(_leaves(born.params)), dict(_leaves(after.params))
    assert sorted(ours) == sorted(theirs)
    for name, t in ours.items():
        assert torch.equal(t, theirs[name]), name
    with pytest.raises(ValueError, match="quant"):
        Transformer.random(args, torch.float32, device="cpu", quant="fp8")


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_init_quantized_params_moe(mode):
    args = TransformerArgs.from_dict(dataclasses.asdict(jax_moe_args(n_layers=3)))
    gen = torch.Generator().manual_seed(0)
    params = init_quantized_params(args, torch.float32, mode, gen, torch.device("cpu"))
    key = "q4" if mode == "int4" else "q"
    stored = (lambda k: k // 2 if mode == "int4" else k)
    assert len(params["layers"]) == 3
    for lw in params["layers"]:
        assert lw["w13"][key].shape == (4, stored(256), 1024) and lw["w13"][key].dtype == torch.int8
        assert lw["w2"][key].shape == (4, stored(512), 256)
        assert lw["w2"]["scale"].shape == (4, 4, 256) and bool((lw["w2"]["scale"] == 0.01).all())
        assert lw["wqkv"][key].shape == (stored(256), 512)
        assert lw["gate"].shape == (4, 256) and not tlin.is_quantized(lw["gate"])
    assert not torch.equal(params["layers"][0]["w2"][key], params["layers"][1]["w2"][key])


def test_convert_refuses_lora_on_experts():
    jmodel = JaxTransformer.random(jax_moe_args(n_layers=1), dtype=jnp.float32, seed=0)
    tree = jax.tree.map(np.asarray, jmodel.params)
    tree["layers"]["moe"]["w1_lora"] = {"a": np.zeros((1, 4, 256, 2), np.float32),
                                        "b": np.zeros((1, 4, 2, 512), np.float32)}
    with pytest.raises(ValueError, match="LoRA"):
        params_from_numpy(tree, device="cpu")
    del tree["layers"]["moe"]
    with pytest.raises(ValueError, match="neither"):
        params_from_numpy(tree, device="cpu")
