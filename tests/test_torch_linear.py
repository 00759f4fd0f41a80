"""The port's quantized-weight format and ``linear`` routing against the JAX
package's ``ops/linear.py``, in fp32 on the CPU.

Tolerances: ``quantize_weight`` gives the JAX function's bytes and scales bit
for bit (both are IEEE fp32: absmax / qmax, round-half-even, clip), since the
two packages load one stored format. ``dequant`` is one fp32 product of exact
operands, so it is equal to 0 ulp. ``linear`` is held to the JAX ``linear``
on its XLA path at 1e-4, the JAX tests' own tolerance for these products
(tests/test_pallas.py): the port sums per group in fp32 and scales after the
dot, XLA scales the weight first.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistral_inference_tpu.ops import linear as jlin
from mistral_inference_tpu_torch.ops import linear as tlin
from mistral_inference_tpu_torch.ops.cuda import matmul_quant as mq
from mistral_inference_tpu_torch.ops.cuda import moe_matmul as mm


def _t(x):
    return torch.from_numpy(np.array(x))


def _weight(seed, shape, scale):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale


QUANT_CASES = [
    # tests/test_quant.py's round-trip shapes
    (8, (2, 64, 32), 16, 0.1),
    (4, (64, 32), 32, 1.0),
    # a layer stack, and in < group (one group of in elements)
    (8, (3, 256, 128), 128, 0.05),
    (4, (3, 256, 128), 128, 0.05),
    (8, (48, 64), 128, 0.1),
    (4, (48, 64), 128, 0.1),
]


@pytest.mark.parametrize("bits,shape,group,scale", QUANT_CASES)
def test_quantize_weight_bit_identical(bits, shape, group, scale):
    w = _weight(bits + shape[-1], shape, scale)
    w[..., :3, 0] = 0.0  # a group whose absmax is small but not zero
    w[..., :, 1] = 0.0  # an all-zero column: the scale floor
    ref = jlin.quantize_weight(jnp.asarray(w), bits=bits, group=group)
    out = tlin.quantize_weight(_t(w), bits, group)
    assert sorted(out) == sorted(ref)
    for key in ref:
        got, want = out[key].numpy(), np.asarray(ref[key])
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert out[key].is_contiguous()


def test_quantize_weight_of_a_transposed_view_is_contiguous():
    """The model's plain weights are (out, in); quantizing their transposed
    view must still store (in, out) row-major bytes."""
    w = _weight(0, (96, 256), 0.1)
    ref = tlin.quantize_weight(_t(w.T.copy()), 4, 64)
    out = tlin.quantize_weight(_t(w).t(), 4, 64)
    for key in ref:
        assert out[key].is_contiguous()
        assert torch.equal(out[key], ref[key])


def test_quantize_weight_rejects_bad_arguments():
    with pytest.raises(ValueError, match="bits"):
        tlin.quantize_weight(torch.zeros(8, 8), 3)
    with pytest.raises(ValueError, match="multiple"):
        tlin.quantize_weight(torch.zeros(200, 8), 8, 128)


@pytest.mark.parametrize("bits,shape,group,scale", QUANT_CASES)
def test_dequant_equal(bits, shape, group, scale):
    w = _weight(1 + bits + shape[-1], shape, scale)
    jq = jlin.quantize_weight(jnp.asarray(w), bits=bits, group=group)
    tq = {k: _t(v) for k, v in jq.items()}
    ref = np.asarray(jlin.dequant(jq, jnp.float32))
    np.testing.assert_array_equal(tlin.dequant(tq, torch.float32).numpy(), ref)
    if len(shape) == 3:  # a stacked leaf with its layer index
        li = shape[0] - 1
        got = tlin.dequant({**tq, "li": li}, torch.float32).numpy()
        np.testing.assert_array_equal(got, ref[li])
    unpacked = tlin._unpack_int4(tq["q4"]).numpy() if bits == 4 else None
    if unpacked is not None:
        np.testing.assert_array_equal(unpacked, np.asarray(jlin._unpack_int4(jq["q4"])))
        assert unpacked.min() >= -8 and unpacked.max() <= 7


def test_dequant_and_linear_of_a_plain_weight():
    w = _t(_weight(3, (24, 16), 0.1))  # the port's plain layout: (out, in)
    x = _t(_weight(4, (5, 16), 1.0))
    assert not tlin.is_quantized(w) and tlin.is_quantized({"q": w, "scale": w})
    assert torch.equal(tlin.dequant(w, torch.float32), w)
    np.testing.assert_allclose(tlin.linear(x, w).numpy(), x.numpy() @ w.numpy().T, atol=1e-6)


def _count_routes(monkeypatch):
    """Count which of linear's three routes a call takes."""
    seen = {"k3": 0, "k5": 0, "dequant": 0}

    def wrap(module_attr, key, fn):
        def counted(*a, **kw):
            seen[key] += 1
            return fn(*a, **kw)

        monkeypatch.setattr(tlin, module_attr, counted)

    wrap("matmul_quant", "k3", mq.matmul_quant)
    wrap("matmul_quant_stacked", "k3", mq.matmul_quant_stacked)
    wrap("moe_matmul_quant_ragged", "k5", mm.moe_matmul_quant_ragged)
    wrap("dequant", "dequant", tlin.dequant)
    return seen


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize(
    "lead,K,N,group,route",
    [
        ((4,), 256, 256, 128, "k3"),  # a decode step
        ((2, 128), 256, 128, 64, "k3"),  # 256 rows: the last of the decode band
        ((2, 256), 256, 128, 128, "k5"),  # 512 rows: mid-band prefill
        ((2, 150), 256, 128, 128, "dequant"),  # 300 rows: a ragged last chunk
        ((4,), 192, 128, 64, "dequant"),  # in % 128 != 0
        ((8192,), 256, 128, 128, "dequant"),  # the large-prefill band
    ],
)
def test_linear_routes_by_shape_and_matches_jax(monkeypatch, bits, lead, K, N, group, route):
    w = _weight(bits + K + N, (K, N), 0.1)
    x = _weight(len(lead) + K, (*lead, K), 1.0)
    jq = jlin.quantize_weight(jnp.asarray(w), bits=bits, group=group)
    ref = np.asarray(jlin.linear(jnp.asarray(x), jq))  # the XLA dequant path
    seen = _count_routes(monkeypatch)
    out = tlin.linear(_t(x), {k: _t(v) for k, v in jq.items()})
    assert seen == {**{k: 0 for k in seen}, route: 1}
    assert out.shape == (*lead, N) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("rows,route", [(4, "k3"), (512, "k5"), (300, "dequant")])
def test_linear_of_a_stacked_leaf(monkeypatch, bits, rows, route):
    """A leaf holding the whole (L, ...) stack plus ``li`` takes the same
    routes and reads layer li."""
    L, K, N, li = 3, 256, 128, 2
    w = _weight(bits + rows, (L, K, N), 0.1)
    x = _weight(rows, (rows, K), 1.0)
    jq = jlin.quantize_weight(jnp.asarray(w), bits=bits, group=128)
    ref = np.asarray(jlin.linear(jnp.asarray(x), {k: v[li] for k, v in jq.items()}))
    seen = _count_routes(monkeypatch)
    out = tlin.linear(_t(x), {**{k: _t(v) for k, v in jq.items()}, "li": li})
    assert seen == {**{k: 0 for k in seen}, route: 1}
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)
