"""The port's ring KV cache against the JAX package's, on the CPU.

Everything here is exact: the int8 rule (fp32 absmax / 127 with a 1e-8
floor, IEEE division, round half to even, clip to +-127) is integer-valued
once the scale is fixed, and slot arithmetic is integer arithmetic. The
port stores rings and scales in the JAX package's layouts, so the buffers
compare element for element.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistral_inference_tpu import cache as jcache
from mistral_inference_tpu_torch import cache as tcache


RING = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}


def _np(x):
    return np.array(x.float() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32))


def _t(a):
    """numpy -> torch; a float8 array (ml_dtypes' type) moves as its bytes."""
    a = np.array(a)
    if a.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(a)


def _equal(ours, theirs):
    """Element for element; one-byte rings compare as their bytes."""
    theirs = np.asarray(theirs)
    if ours.element_size() == 1:
        np.testing.assert_array_equal(ours.view(torch.uint8).numpy(), theirs.view(np.uint8))
    else:
        np.testing.assert_array_equal(ours.numpy(), theirs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_ring_int8_bit_exact(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 5, 3, 128)).astype(np.float32) * rng.uniform(0.01, 30, (6, 5, 3, 1))
    x[0, 0, 0] = 0.0  # an all-zero head hits the 1e-8 floor
    x[1, 0, 0, :4] = [127.0, -127.0, 63.5, 0.5]  # exact halves round to even
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = jcache._quantize_ring(jx, jnp.int8)
    tq, ts = tcache._quantize_ring(tx, torch.int8)
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tcache.kv_roundtrip(tx, torch.int8).float().numpy(), _np(jcache.kv_roundtrip(jx, jnp.int8))
    )


@pytest.mark.parametrize("window", [4, 7, 16])
def test_slot_positions_match(window):
    kv_len = np.array([0, 1, 3, 7, 8, 9, 23, 100], np.int32)
    W = -(-window // 128) * 128
    jp, jv = jcache.slot_positions(jnp.asarray(kv_len), jnp.int32(window), W)
    tp, tv = tcache.slot_positions(torch.from_numpy(kv_len), window, W)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("sliding_window", [None, 6, [3, None]])
@pytest.mark.parametrize("kv_quant", ["bf16", "int8", "fp8"])
def test_alloc_matches(sliding_window, kv_quant):
    kw = dict(n_layers=4, batch=3, max_seq_len=20, n_kv_heads=2, head_dim=8,
              sliding_window=sliding_window, kv_quant=kv_quant)
    jc = jcache.KVCache.alloc(dtype=jnp.float32, **kw)
    tc = tcache.KVCache.alloc(dtype=torch.float32, device="cpu", **kw)
    assert tuple(tc.k.shape) == jc.k.shape and tc.size == jc.size == 128
    assert tc.windows == np.asarray(jc.windows).tolist()
    assert str(tc.k.dtype).split(".")[-1] == str(jc.k.dtype)
    if kv_quant != "bf16":
        assert tuple(tc.k_scale.shape) == jc.k_scale.shape
    else:
        assert tc.k_scale is None and jc.k_scale.size == 0


def _ring(kv_quant, rng, L=3, B=3, W=128, Hkv=2, Dh=8):
    """A random stored ring (stacks, scales) in both frameworks' form."""
    kf = rng.standard_normal((L, B, W, Hkv, Dh)).astype(np.float32)
    vf = rng.standard_normal((L, B, W, Hkv, Dh)).astype(np.float32)
    if kv_quant == "bf16":
        return kf.reshape(L, B, W, -1), vf.reshape(L, B, W, -1), None, None
    kq, ks = jcache._quantize_ring(jnp.asarray(kf), RING[kv_quant])
    vq, vs = jcache._quantize_ring(jnp.asarray(vf), RING[kv_quant])
    return (np.array(kq).reshape(L, B, W, -1), np.array(vq).reshape(L, B, W, -1),
            np.moveaxis(np.asarray(ks), 2, 3).copy(), np.moveaxis(np.asarray(vs), 2, 3).copy())


@pytest.mark.parametrize("kv_quant", ["bf16", "int8", "fp8"])
def test_update_stacked_matches(kv_quant):
    """A chunk longer than the window (same-chunk overwrites are dropped), a
    ring that wraps, a short row and an idle row, into layer 1 of 3."""
    rng = np.random.default_rng(1)
    L, B, W, Hkv, Dh, T, window = 3, 3, 128, 2, 8, 9, 5
    CK, CV, KS, VS = _ring(kv_quant, rng, L, B, W, Hkv, Dh)
    xk = rng.standard_normal((B, T, Hkv, Dh)).astype(np.float32)
    xv = rng.standard_normal((B, T, Hkv, Dh)).astype(np.float32)
    kv_len = np.array([3, 0, 11], np.int32)
    seqlens = np.array([9, 2, 0], np.int32)
    positions = kv_len[:, None] + np.arange(T, dtype=np.int32)[None]
    valid = np.arange(T)[None] < seqlens[:, None]
    new_total = kv_len + seqlens

    jks = jnp.asarray(KS) if KS is not None else jnp.ones((L, 0, 0, 0), jnp.float32)
    jvs = jnp.asarray(VS) if VS is not None else jnp.ones((L, 0, 0, 0), jnp.float32)
    jout = jcache.update_stacked(
        jnp.asarray(CK), jnp.asarray(CV), jks, jvs, jnp.int32(1), jnp.asarray(xk),
        jnp.asarray(xv), jnp.asarray(positions), jnp.asarray(valid),
        jnp.asarray(new_total), jnp.int32(window),
    )
    t = [None if a is None else _t(a) for a in (CK, CV, KS, VS)]
    writes = tcache.ring_writes(
        torch.from_numpy(positions), torch.from_numpy(valid),
        torch.from_numpy(new_total), window,
    )
    tcache.update_stacked(*t, 1, torch.from_numpy(xk), torch.from_numpy(xv), writes)
    for ours, theirs in zip(t, jout):
        if ours is not None:
            _equal(ours, theirs)
    # Row 0 wrote positions 3..11 into a 5-slot ring: only 7..11 landed.
    b_idx, t_idx, slot = writes
    assert positions[0, t_idx[b_idx == 0].numpy()].tolist() == [7, 8, 9, 10, 11]
    assert sorted(slot[b_idx == 0].tolist()) == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_dequant_layer_matches(kv_quant):
    rng = np.random.default_rng(2)
    CK, _, KS, _ = _ring(kv_quant, rng)
    ref = jcache.dequant_layer(jnp.asarray(CK[1]), jnp.asarray(KS[1]), jnp.float32, 2)
    out = tcache.dequant_layer(_t(CK[1]), _t(KS[1]), torch.float32, 2)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_kv_quant_rejects_unknown():
    with pytest.raises(ValueError):
        tcache.kv_cache_dtype("fp4", torch.bfloat16)


def _caches(kv_quant, rng, kv_len, L=3, B=3, W=128, Hkv=2, Dh=8, windows=(5, 5, 5)):
    """The same stored ring as a KVCache of each package."""
    CK, CV, KS, VS = _ring(kv_quant, rng, L, B, W, Hkv, Dh)
    empty = jnp.ones((L, 0, 0, 0), jnp.float32)
    jc = jcache.KVCache(
        k=jnp.asarray(CK), v=jnp.asarray(CV), kv_len=jnp.asarray(kv_len),
        windows=jnp.asarray(windows, jnp.int32),
        k_scale=empty if KS is None else jnp.asarray(KS),
        v_scale=empty if VS is None else jnp.asarray(VS),
    )
    t = [None if a is None else _t(a) for a in (CK, CV, KS, VS)]
    tc = tcache.KVCache(k=t[0], v=t[1], kv_len=torch.from_numpy(kv_len.copy()),
                        windows=list(windows), k_scale=t[2], v_scale=t[3])
    return jc, tc


def _same_cache(tc, jc):
    _equal(tc.k, jc.k)
    _equal(tc.v, jc.v)
    np.testing.assert_array_equal(tc.kv_len.numpy(), np.asarray(jc.kv_len))
    if tc.k_scale is not None:
        np.testing.assert_array_equal(tc.k_scale.numpy(), np.asarray(jc.k_scale))
        np.testing.assert_array_equal(tc.v_scale.numpy(), np.asarray(jc.v_scale))


@pytest.mark.parametrize("kv_quant", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("T,windows", [
    (4, (5, 5, 5)),   # a wrapping ring, the chunk shorter than the window: the fixed-shape write
    (4, (5, 7, 128)),  # per-layer windows
    (9, (5, 5, 5)),   # a chunk longer than the window overwrites itself: the write plan
])
def test_scatter_chunk_matches(kv_quant, T, windows):
    """The speculative commit on a ring that wraps, with accept = 0, part and
    all of T: ring bytes, scales and kv_len equal the JAX package's, and what
    was not accepted is not written."""
    rng = np.random.default_rng(4)
    L, B, Hkv, Dh = 3, 3, 2, 8
    kv_len = np.array([3, 11, 8], np.int32)
    jc, tc = _caches(kv_quant, rng, kv_len, L, B, 128, Hkv, Dh, windows)
    before = tc.k.clone()
    ck = rng.standard_normal((L, B, T, Hkv, Dh)).astype(np.float32)
    cv = rng.standard_normal((L, B, T, Hkv, Dh)).astype(np.float32)
    accept = np.array([0, 2, T], np.int32)
    jout = jcache.scatter_chunk(jc, jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(accept))
    out = tcache.scatter_chunk(tc, torch.from_numpy(ck), torch.from_numpy(cv),
                               torch.from_numpy(accept))
    assert out is tc  # in place
    _same_cache(tc, jout)
    assert tc.kv_len.tolist() == [3, 13, 8 + T]
    assert torch.equal(tc.k[:, 0], before[:, 0]), "a row that accepted nothing is untouched"


def test_rewind_matches():
    rng = np.random.default_rng(5)
    kv_len = np.array([9, 4, 0], np.int32)
    jc, tc = _caches("int8", rng, kv_len, windows=(128, 128, 128))
    new_len = np.array([6, 4, 0], np.int32)
    jout = jcache.rewind(jc, jnp.asarray(new_len))
    assert tcache.rewind(tc, torch.from_numpy(new_len)) is tc
    _same_cache(tc, jout)
    # On a ring that never wrapped the slots past new_len are invalid again.
    jp, jv = jcache.slot_positions(jout.kv_len, jnp.int32(128), 128)
    tp, tv = tcache.slot_positions(tc.kv_len, 128, 128)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv[0].sum() == 6 and not tv[0, 6:].any()


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_copy_prefix_rows_matches(kv_quant):
    """Prefix-cache copies in array order, a same-wave chain among them (row 1
    is written by the first copy, then read by the second) and a q = 0 no-op:
    ring bytes, scales and kv_len equal the JAX package's."""
    rng = np.random.default_rng(6)
    kv_len = np.array([40, 9, 17, 3], np.int32)
    jc, tc = _caches(kv_quant, rng, kv_len, L=2, B=4, windows=(128, 128))
    srcs, dsts, qs = [0, 1, 2], [1, 3, 0], [30, 12, 0]
    jout = jcache.copy_prefix_rows(jc, *(jnp.asarray(a, jnp.int32) for a in (srcs, dsts, qs)))
    assert tcache.copy_prefix_rows(tc, srcs, dsts, qs) is tc
    _same_cache(tc, jout)
    assert tc.kv_len.tolist() == [40, 30, 17, 12]


@pytest.mark.parametrize("kv_quant", ["int8", "fp8"])
def test_adopt_rows_matches(kv_quant):
    """Whole-row adoption from a staging cache: ring bytes, scales, kv_len
    and carry rows move; a destination >= B is dropped."""
    rng = np.random.default_rng(8)
    jc, tc = _caches(kv_quant, rng, np.array([5, 6, 7, 8], np.int32), L=2, B=4,
                     windows=(128, 128))
    js, ts = _caches(kv_quant, rng, np.array([21, 33], np.int32), L=2, B=2, windows=(128, 128))
    carry = rng.standard_normal((4, 16)).astype(np.float32)
    src_carry = rng.standard_normal((2, 16)).astype(np.float32)
    src_rows, dst_rows = [0, 1], [2, 4]  # row 1 goes nowhere: 4 >= B
    jout, jcarry = jcache.adopt_rows(jc, jnp.asarray(carry), js, jnp.asarray(src_carry),
                                     jnp.asarray(src_rows), jnp.asarray(dst_rows))
    tcarry = torch.from_numpy(carry.copy())
    out, out_carry = tcache.adopt_rows(tc, tcarry, ts, torch.from_numpy(src_carry),
                                       src_rows, dst_rows)
    assert out is tc and out_carry is tcarry
    _same_cache(tc, jout)
    np.testing.assert_array_equal(tcarry.numpy(), np.asarray(jcarry))
    assert tc.kv_len.tolist() == [5, 6, 21, 8]
