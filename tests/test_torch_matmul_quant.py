"""The plain versions of the port's quantized-matmul kernels (K3
``matmul_quant`` / ``matmul_quant_stacked``, K5 ``moe_matmul_quant_ragged``)
against the JAX package's Pallas kernels, run in interpret mode on the CPU as
tests/test_pallas.py runs them, at that file's shapes.

Tolerances: in fp32, 1e-4 (tests/test_pallas.py's own: both sides sum each
group's dot in fp32 and scale after it, in another order). In bf16, one bf16
ulp of the result (2^-7 relative, on top of the fp32 tolerance): both sides
round one fp32 sum to bf16, and fp32 sums taken in another order can land on
either side of a rounding boundary.

The CUDA kernels themselves need the card: tests/test_torch_cuda.py holds
them against these plain versions and skips without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistral_inference_tpu.ops.linear import quantize_weight
from mistral_inference_tpu.ops.pallas import matmul_quant as jmq
from mistral_inference_tpu.ops.pallas import moe_matmul as jmm
from mistral_inference_tpu_torch.ops.cuda import matmul_quant as mq
from mistral_inference_tpu_torch.ops.cuda import moe_matmul as mm

BF16_ULP = 2.0**-7


def _t(x):
    return torch.from_numpy(np.array(x))


def _case(seed, x_shape, w_shape, bits, group):
    rng = np.random.default_rng(seed)
    w = jnp.asarray(rng.standard_normal(w_shape).astype(np.float32) * 0.1)
    x = rng.standard_normal(x_shape).astype(np.float32)
    qw = quantize_weight(w, bits=bits, group=group)
    return x, qw["q4" if bits == 4 else "q"], qw["scale"]


def _check(out: torch.Tensor, ref, dtype):
    ref = np.asarray(ref.astype(jnp.float32))
    assert out.dtype == (torch.float32 if dtype == "fp32" else torch.bfloat16)
    assert out.shape == ref.shape
    got = out.float().numpy()
    if dtype == "fp32":
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    else:
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=BF16_ULP)


def _cast(x, dtype):
    """(jax array, torch tensor) of x in fp32 or bf16 (the same bf16 values)."""
    jx = jnp.asarray(x)
    if dtype == "fp32":
        return jx, _t(x)
    jx = jx.astype(jnp.bfloat16)
    return jx, _t(np.asarray(jx.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("bits,B,K,N,group", [
    (8, 4, 256, 256, 128),
    (8, 1, 512, 256, 64),
    (4, 4, 256, 512, 128),
    (4, 2, 128, 256, 32),  # group < 128, K / 2 = 64 stored rows
    (4, 3, 2048, 512, 128),  # the 2-D int4 tiling (split halves, no concat)
    (8, 3, 2048, 512, 128),  # the 2-D int8 tiling
])
def test_matmul_quant_plain_matches_pallas(bits, B, K, N, group, dtype):
    x, q, scale = _case(bits + K, (B, K), (K, N), bits, group)
    jx, tx = _cast(x, dtype)
    if K == 2048:  # matmul_quant's 2-D tilings, entered as tests/test_pallas.py enters them
        tiled = jmq._matmul_quant_2d_int4 if bits == 4 else jmq._matmul_quant_2d
        ref = tiled(jx, q, scale, TN=512, TK=1024 if bits == 4 else 2048, interpret=True)
    else:
        ref = jmq.matmul_quant(jx, q, scale, interpret=True)
    _check(mq.matmul_quant_plain(tx, _t(q), _t(scale)), ref, dtype)
    # On CPU tensors the wrapper runs the plain version and counts nothing.
    before = mq.matmul_quant.launches
    assert torch.equal(mq.matmul_quant(tx, _t(q), _t(scale)),
                       mq.matmul_quant_plain(tx, _t(q), _t(scale)))
    assert mq.matmul_quant.launches == before


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("bits,K,N,group", [
    (4, 2048, 512, 128),
    (8, 2048, 512, 128),
    (4, 256, 384, 128),  # K / 2 = 128 stored rows: the 1-D tiling
    (8, 512, 384, 64),
])
def test_matmul_quant_stacked_plain_matches_pallas(bits, K, N, group, dtype):
    L, B = 3, 4
    x, q, scale = _case(bits + K + N, (B, K), (L, K, N), bits, group)
    jx, tx = _cast(x, dtype)
    tq, ts = _t(q), _t(scale)
    for li in range(L):
        ref = jmq.matmul_quant_stacked(jx, q, scale, jnp.int32(li), interpret=True)
        out = mq.matmul_quant_stacked(tx, tq, ts, li)
        _check(out, ref, dtype)
        assert torch.equal(out, mq.matmul_quant_plain(tx, tq[li], ts[li]))


def test_matmul_quant_wrappers_check_ranks():
    x, q, scale = _case(0, (2, 128), (2, 128, 128), 8, 64)
    with pytest.raises(ValueError, match="one layer"):
        mq.matmul_quant(_t(x), _t(q), _t(scale))
    with pytest.raises(ValueError, match="stacked"):
        mq.matmul_quant_stacked(_t(x), _t(q)[0], _t(scale)[0], 0)
    with pytest.raises(ValueError, match="neither int8 nor packed int4"):
        mq.matmul_quant_plain(_t(x)[:, :96], _t(q)[0], _t(scale)[0])


def test_nibbles_sign_extend():
    """Low nibble (v << 28) >> 28, high nibble v >> 4, both arithmetic."""
    v = torch.arange(-128, 128, dtype=torch.int32).to(torch.int8)
    lo, hi = mq.nibbles(v)
    i = v.to(torch.int32).numpy()
    np.testing.assert_array_equal(lo.numpy(), ((i << 28).astype(np.int32)) >> 28)
    np.testing.assert_array_equal(hi.numpy(), i >> 4)
    assert int(lo.min()) == -8 and int(lo.max()) == 7 and int(hi.min()) == -8 and int(hi.max()) == 7


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("E,tile_group,stacked", [
    (1, [0, 0], False),  # dense prefill: one weight
    (3, [2, 0, 0, 1], False),  # mixed tile_group
    (3, [1, 2, 0], True),  # (L, E, ...) stack with a layer index
    (1, [0, 0], True),
])
def test_moe_matmul_ragged_plain_matches_pallas(bits, E, tile_group, stacked, dtype):
    TM, K, N, group, L, li = 128, 256, 256, 64, 2, 1
    lead = (L, E) if stacked else (E,)
    rows = TM * len(tile_group)
    x, q, scale = _case(bits + E + rows, (rows, K), (*lead, K, N), bits, group)
    jx, tx = _cast(x, dtype)
    tg = np.asarray(tile_group, np.int32)
    ref = jmm.moe_matmul_quant_ragged(
        jx, q, scale, jnp.asarray(tg), jnp.int32(li) if stacked else None, interpret=True)
    args = (tx, _t(q), _t(scale), _t(tg), li if stacked else None)
    out = mm.moe_matmul_quant_ragged_plain(*args)
    _check(out, ref, dtype)
    before = mm.moe_matmul_quant_ragged.launches
    assert torch.equal(mm.moe_matmul_quant_ragged(*args), out)
    assert mm.moe_matmul_quant_ragged.launches == before
    # Each tile is its weight's K3 product: the parity decode == prefill leans on.
    tq, ts = (_t(q)[li], _t(scale)[li]) if stacked else (_t(q), _t(scale))
    for t, e in enumerate(tile_group):
        assert torch.equal(out[t * TM:(t + 1) * TM],
                           mq.matmul_quant_plain(tx[t * TM:(t + 1) * TM], tq[e], ts[e]))


def test_moe_matmul_ragged_checks_ranks_and_tiles():
    x, q, scale = _case(0, (256, 128), (2, 128, 128), 8, 64)
    tg = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="stacks"):
        mm.moe_matmul_quant_ragged(_t(x), _t(q)[0], _t(scale)[0], tg)
    with pytest.raises(ValueError, match="stacks"):
        mm.moe_matmul_quant_ragged(_t(x), _t(q), _t(scale), tg, 0)
    with pytest.raises(ValueError, match="do not divide"):
        mm.moe_matmul_quant_ragged(_t(x)[:255], _t(q), _t(scale), tg)
