"""K7's plain version (``fused_verify_chunk_attention`` on CPU tensors)
against the JAX package's Pallas kernel in interpret mode and against the
two-op oracle (``update_stacked`` over the whole T-token chunk, then ring-only
attention under the sliding-window mask), on the cases of
tests/test_fused_verify.py: int8, float8_e4m3fn and model-dtype rings; fills empty, mid and
near the ring's end; a dead row; slot runs that straddle a 128-slot span on a
non-zero layer; T = 8 over several spans; T = 1.

Tolerances: ring bytes equal; scales rtol 2e-7 (the JAX kernel's own bound:
one fp32 ulp); outputs 3e-5 (fp32 sums in another order). At T = 1 the
function is K2's: equal to ``fused_update_decode_attention`` on the same
inputs, bytes and output; and K2's output equals ``decode_attention``'s (K6)
over the ring K2 has written, to the bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistral_inference_tpu import cache as jcache
from mistral_inference_tpu.ops.attention import attend, attend_scaled, sliding_window_mask
from mistral_inference_tpu.ops.pallas import attention as jpal
from mistral_inference_tpu_torch import cache as tcache
from mistral_inference_tpu_torch.ops import cuda as cuda_ops
from mistral_inference_tpu_torch.ops.cuda import attention as tk


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run many tiny tensor operations; beside other test
    workers, each with a thread per core, the threads' hand-offs cost far
    more than the arithmetic. One thread for the test, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RING = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}


def _t(x):
    a = np.array(x)
    if a.dtype == jnp.float8_e4m3fn:  # numpy holds it as ml_dtypes' type: move the bytes
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(a)


def _np(t):
    """A port tensor as numpy; a one-byte ring as its bytes."""
    return t.view(torch.uint8).numpy() if t.element_size() == 1 else t.numpy()


def _setup(kv_quant, rng, L, B, T, S, Hkv, H, D):
    kf = rng.standard_normal((L, B, S, Hkv, D)).astype(np.float32)
    vf = rng.standard_normal((L, B, S, Hkv, D)).astype(np.float32)
    if kv_quant == "bf16":  # the model dtype (fp32 here) ring, no scales
        CK, CV, KS, VS = kf.reshape(L, B, S, -1), vf.reshape(L, B, S, -1), None, None
    else:
        CKq, KSs = jcache._quantize_ring(jnp.asarray(kf), RING[kv_quant])
        CVq, VSs = jcache._quantize_ring(jnp.asarray(vf), RING[kv_quant])
        CK, CV = np.array(CKq).reshape(L, B, S, -1), np.array(CVq).reshape(L, B, S, -1)
        KS, VS = np.moveaxis(np.asarray(KSs), 2, 3).copy(), np.moveaxis(np.asarray(VSs), 2, 3).copy()
    xq = rng.standard_normal((B, T, H, D)).astype(np.float32)
    xk = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    xv = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    return CK, CV, KS, VS, xq, xk, xv


def _case(kv_quant, kv_len, live, L=2, B=4, T=5, S=256, Hkv=2, H=4, D=128, window=None, li=0):
    """Runs the three: returns (the port's stacks after the call, its output,
    the oracle's stacks and output, the Pallas kernel's stacks and output,
    the live rows, and the inputs for a rerun)."""
    rng = np.random.default_rng(11)
    window = S if window is None else window
    kv_len, live = np.asarray(kv_len, np.int32), np.asarray(live, np.int32)
    CK, CV, KS, VS, xq, xk, xv = _setup(kv_quant, rng, L, B, T, S, Hkv, H, D)
    seqlens = np.where(live > 0, T, 0).astype(np.int32)
    positions = kv_len[:, None] + np.arange(T, dtype=np.int32)[None]
    token_valid = np.arange(T)[None] < seqlens[:, None]
    new_total = kv_len + seqlens
    slot_pos, slot_valid = (np.asarray(a) for a in jcache.slot_positions(
        jnp.asarray(new_total), jnp.int32(window), S))
    write_slot0 = np.where(live > 0, positions[:, 0] % window, -1).astype(np.int32)

    empty = jnp.ones((L, 0, 0, 0), jnp.float32)
    jstacks = (jnp.asarray(CK), jnp.asarray(CV), empty if KS is None else jnp.asarray(KS),
               empty if VS is None else jnp.asarray(VS))
    O = jcache.update_stacked(
        *jstacks, jnp.int32(li), jnp.asarray(xk), jnp.asarray(xv), jnp.asarray(positions),
        jnp.asarray(token_valid), jnp.asarray(new_total), jnp.int32(window),
    )
    mask = sliding_window_mask(jnp.asarray(positions), jnp.asarray(slot_pos),
                               jnp.asarray(token_valid), jnp.asarray(slot_valid), window)
    ring_k, ring_v = O[0][li].reshape(B, S, Hkv, D), O[1][li].reshape(B, S, Hkv, D)
    if KS is None:
        ref = attend(jnp.asarray(xq), ring_k, ring_v, mask)
    else:
        ref = attend_scaled(jnp.asarray(xq), ring_k, ring_v, jnp.moveaxis(O[2][li], 1, 2),
                            jnp.moveaxis(O[3][li], 1, 2), mask)
    jout, *P = jpal.fused_verify_chunk_attention(
        jnp.asarray(xq), jnp.asarray(xk), jnp.asarray(xv), jnp.asarray(CK), jnp.asarray(CV),
        None if KS is None else jnp.asarray(KS), None if VS is None else jnp.asarray(VS),
        jnp.int32(li), jnp.int32(window), jnp.asarray(write_slot0), jnp.asarray(positions),
        jnp.asarray(slot_pos), jnp.asarray(slot_valid), interpret=True,
    )

    stacks = [None if a is None else _t(a) for a in (CK, CV, KS, VS)]
    args = (li, window, _t(write_slot0), _t(positions), _t(slot_pos), _t(slot_valid))
    cuda_ops.reset_launch_counts()
    out = tk.fused_verify_chunk_attention(_t(xq), _t(xk), _t(xv), *stacks, *args).numpy()
    assert tk.fused_verify_chunk_attention.launches == 0  # CPU tensors: the plain version
    inputs = ((CK, CV, KS, VS), (xq, xk, xv), args)
    return stacks, out, O, np.asarray(ref), P, np.asarray(jout), live > 0, inputs


def _check(stacks, out, O, ref, P, jout, rows, _inputs):
    B, T = out.shape[:2]
    for i, ours in enumerate(stacks):
        if ours is None:
            continue
        for theirs in (O[i], P[i]):
            if i < 2:
                theirs = np.asarray(theirs)
                if theirs.itemsize == 1:
                    theirs = theirs.view(np.uint8)
                np.testing.assert_array_equal(_np(ours), theirs)
            else:
                np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=2e-7)
    np.testing.assert_allclose(out[rows], ref.reshape(B, T, -1)[rows], atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(out[rows], jout[rows], atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("kv_quant", ["int8", "bf16", "fp8"])
def test_fused_verify_plain_matches_oracle_and_pallas(kv_quant):
    # fills: empty, mid, near the end, and a dead row
    _check(*_case(kv_quant, kv_len=[0, 100, 251, 40], live=[1, 1, 1, 0]))


@pytest.mark.parametrize("kv_quant", ["int8", "bf16", "fp8"])
def test_fused_verify_plain_span_straddle_and_layer(kv_quant):
    # slots that straddle a 128-slot span, on a non-zero layer of the stack
    stacks, out, O, *rest = _case(kv_quant, kv_len=[6, 126, 127, 250], live=[1, 1, 1, 1], li=1)
    _check(stacks, out, O, *rest)
    (CK, _, _, _), _, _ = rest[-1]
    assert np.array_equal(_np(stacks[0][0]), _np(_t(CK[0]))), "layer 0 must not be written"


def test_fused_verify_plain_t8_multi_span():
    # T = 8 (the most), several spans, a window smaller than the buffer
    old = jpal._FUSED_BS, jpal._FUSED_RB
    jpal._FUSED_BS, jpal._FUSED_RB = 256, 2
    try:
        case = _case("int8", kv_len=[0, 300, 631, 200], live=[1, 1, 1, 1], T=8, S=640, window=640)
    finally:
        jpal._FUSED_BS, jpal._FUSED_RB = old
    _check(*case)


@pytest.mark.parametrize("kv_quant", ["int8", "bf16", "fp8"])
def test_fused_verify_plain_t1_equals_fused_decode(kv_quant):
    stacks, out, *rest = _case(kv_quant, kv_len=[0, 17, 255, 128], live=[1, 1, 1, 0], T=1)
    _check(stacks, out, *rest)
    (CK, CV, KS, VS), (xq, xk, xv), (li, window, ws, pos, slot_pos, slot_valid) = rest[-1]
    k2_stacks = [None if a is None else _t(a) for a in (CK, CV, KS, VS)]
    k2 = tk.fused_update_decode_attention(
        _t(xq), _t(xk), _t(xv), *k2_stacks, li, window, ws, pos[:, 0], slot_pos, slot_valid)
    assert np.array_equal(k2.numpy(), out)
    for a, b in zip(stacks, k2_stacks):
        assert a is None or torch.equal(a, b)


@pytest.mark.parametrize("kv_quant", ["int8", "bf16", "fp8"])
def test_fused_decode_plain_equals_decode_over_its_ring(kv_quant):
    """K2's plain version gives K6's plain output, to the bit, over the ring
    it has just written, with the same q, positions and window: the contract
    the kernels keep on the card, where the two run one loop."""
    L, B, T, S, Hkv, H, D, li = 2, 4, 1, 256, 2, 4, 128, 1
    CK, CV, KS, VS, xq, xk, xv = _setup(kv_quant, np.random.default_rng(5), L, B, T, S, Hkv, H, D)
    kv_len = torch.tensor([0, 17, 255, 128], dtype=torch.int32)
    live = torch.tensor([1, 1, 1, 0], dtype=torch.int32)
    ws = torch.where(live > 0, kv_len, -1).to(torch.int32)
    slot_pos, slot_valid = tcache.slot_positions(kv_len + live, S, S)
    stacks = [None if a is None else _t(a) for a in (CK, CV, KS, VS)]
    k2 = tk.fused_update_decode_attention(_t(xq), _t(xk), _t(xv), *stacks, li, S, ws, kv_len,
                                          slot_pos, slot_valid)
    k6 = tk.decode_attention(_t(xq), *stacks, li, kv_len, slot_pos, slot_valid, S)
    assert torch.equal(k2, k6)


def test_fused_verify_rejects_long_chunks():
    L, B, T, S, Hkv, H, D = 1, 1, 9, 128, 1, 2, 128
    CK, CV, KS, VS, xq, xk, xv = _setup("int8", np.random.default_rng(0), L, B, T, S, Hkv, H, D)
    pos = torch.arange(T, dtype=torch.int32)[None]
    slot_pos, slot_valid = torch.arange(S, dtype=torch.int32)[None], torch.ones((1, S), dtype=torch.bool)
    with pytest.raises(ValueError, match="tokens"):
        tk.fused_verify_chunk_attention(
            _t(xq), _t(xk), _t(xv), _t(CK), _t(CV), _t(KS), _t(VS), 0, S,
            torch.zeros((1,), dtype=torch.int32), pos, slot_pos, slot_valid)


def test_query_sees_no_later_candidate():
    """Query t must not see candidates u > t although they are in the ring
    when it attends: changing a later candidate leaves its output alone."""
    stacks, out, _, _, _, _, _, inputs = _case("int8", kv_len=[0, 100, 251, 40],
                                               live=[1, 1, 1, 1])
    (CK, CV, KS, VS), (xq, xk, xv), args = inputs
    xk2, xv2 = xk.copy(), xv.copy()
    xk2[:, 3:] += 5.0
    xv2[:, 3:] -= 3.0
    again = [_t(a) for a in (CK, CV, KS, VS)]
    out2 = tk.fused_verify_chunk_attention(_t(xq), _t(xk2), _t(xv2), *again, *args).numpy()
    np.testing.assert_array_equal(out2[:, :3], out[:, :3])
    assert not np.allclose(out2[:, 3:], out[:, 3:])
