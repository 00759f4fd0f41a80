"""The plain versions of the port's four attention kernels against the JAX
package's Pallas kernels (run in interpret mode on the CPU, as
tests/test_pallas.py and tests/test_fused_decode.py run them) and against
the XLA oracle, at those files' shapes, in fp32, over int8 and model-dtype
rings (tests/test_torch_fp8.py runs the same tests over a float8_e4m3fn ring).

Tolerances: 2e-5 for flash attention and 3e-4 for the ring + chunk merge
(those files' own tolerances against the same oracle); for the fused decode
kernel the updated ring and scales are equal and the output agrees within
3e-5; for the read-only decode kernel 2e-4, tests/test_pallas.py's own
tolerance against the XLA oracle. Rows that see no key are junk in the Pallas kernels; the port returns
0 with m = -1e30 and l = 0 there, checked separately.

The CUDA kernels themselves need the card: tests/test_torch_cuda.py holds
them against these plain versions and skips without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistral_inference_tpu import cache as jcache
from mistral_inference_tpu.ops.attention import attend, attend_scaled, sliding_window_mask
from mistral_inference_tpu.ops.pallas import attention as jpal
from mistral_inference_tpu_torch.ops import cuda as cuda_ops
from mistral_inference_tpu_torch.ops.cuda import attention as tk


RING = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}


def _t(x):
    a = np.array(x)
    if a.dtype == jnp.float8_e4m3fn:  # numpy holds it as ml_dtypes' type: move the bytes
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(a)


def _bytes_equal(ours, theirs):
    """A port tensor and a JAX array hold the same elements: the same bytes
    for one-byte rings (a float8 tensor has no numpy form), else equal."""
    theirs = np.asarray(theirs)
    if ours.element_size() == 1:
        np.testing.assert_array_equal(ours.view(torch.uint8).numpy(), theirs.view(np.uint8))
    else:
        np.testing.assert_array_equal(ours.numpy(), theirs)


def _attention_case(B, T, S, H, Hkv, D, seed=0):
    """tests/test_pallas.py's inputs: queries at the end of a longer context."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    kv_pos = np.stack([np.arange(S) + rng.integers(0, 3) for _ in range(B)]).astype(np.int32)
    q_pos = kv_pos[:, -T:] if T <= S else np.tile(np.arange(T, dtype=np.int32)[None], (B, 1))
    q_valid = np.ones((B, T), bool)
    kv_valid = rng.random((B, S)) > 0.2
    return q, k, v, q_pos, kv_pos, q_valid, kv_valid


@pytest.mark.parametrize(
    "B,T,S,H,Hkv,D,window",
    [
        (2, 16, 16, 4, 2, 128, 1 << 20),
        (2, 16, 24, 4, 2, 128, 8),
        (1, 7, 40, 8, 2, 128, 16),
        (2, 8, 1200, 4, 2, 128, 1 << 20),
    ],
)
def test_flash_attention_plain_matches_pallas(B, T, S, H, Hkv, D, window):
    q, k, v, q_pos, kv_pos, q_valid, kv_valid = _attention_case(B, T, S, H, Hkv, D)
    j = [jnp.asarray(a) for a in (q, k, v, q_pos, kv_pos, q_valid, kv_valid)]
    mask = sliding_window_mask(*j[3:], jnp.int32(window))
    visible = np.asarray(mask.any(-1))
    oracle = np.asarray(attend(*j[:3], mask))
    jo, jm, jl = jpal.flash_attention(*j, jnp.int32(window), interpret=True, return_stats=True)
    t = [_t(a) for a in (q, k, v, q_pos, kv_pos, q_valid, kv_valid)]
    out = tk.flash_attention(*t, window).numpy()
    o, m, l = (x.numpy() for x in tk.flash_attention(*t, window, return_stats=True))
    np.testing.assert_allclose(out[visible], oracle[visible], atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(o.reshape(out.shape), out, atol=0)
    np.testing.assert_allclose(o[visible], np.asarray(jo)[visible], atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(m[visible], np.asarray(jm)[visible], atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(l[visible], np.asarray(jl)[visible], atol=2e-5, rtol=2e-5)


def test_empty_rows_return_zero_with_neutral_stats():
    q, k, v, q_pos, kv_pos, q_valid, kv_valid = _attention_case(2, 5, 9, 4, 2, 128)
    q_valid[1, 2] = False
    kv_valid[0] = False
    t = [_t(a) for a in (q, k, v, q_pos, kv_pos, q_valid, kv_valid)]
    o, m, l = tk.flash_attention(*t, 4, return_stats=True)
    for b, tt in ((0, slice(None)), (1, 2)):
        assert torch.all(o[b, tt] == 0) and torch.all(m[b, tt] == -1e30) and torch.all(l[b, tt] == 0)
    merged = tk.merge_attention_parts(o, m, l, o, m, l)
    assert torch.all(merged[0] == 0) and torch.isfinite(merged).all()


def _scaled_ring(rng, B, S, Hkv, D, kv_quant):
    kf = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    vf = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    if kv_quant == "bf16":
        ones = np.ones((B, Hkv, S), np.float32)
        return kf.reshape(B, S, -1), vf.reshape(B, S, -1), ones, ones, None, None
    kq, ks = jcache._quantize_ring(jnp.asarray(kf), RING[kv_quant])
    vq, vs = jcache._quantize_ring(jnp.asarray(vf), RING[kv_quant])
    ks = np.moveaxis(np.asarray(ks), 1, 2).copy()  # stored (B, Hkv, S)
    vs = np.moveaxis(np.asarray(vs), 1, 2).copy()
    kq = np.asarray(kq).reshape(B, S, -1)
    vq = np.asarray(vq).reshape(B, S, -1)
    return kq, vq, ks, vs, ks, vs


@pytest.mark.parametrize("kv_quant", ["int8", "bf16"])
@pytest.mark.parametrize("S,T,Hkv,H", [(40, 5, 2, 4), (700, 130, 2, 8)])
def test_ring_stats_and_merge_match_pallas(S, T, Hkv, H, kv_quant):
    """ring_attention_stats + flash_attention(return_stats) + merge against
    the Pallas kernels and against one XLA attend over [ring ++ chunk]
    (tests/test_pallas.py::test_ring_chunk_merge_matches_oracle's case)."""
    rng = np.random.default_rng(S + T)
    B, D = 2, 128
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    kq, vq, ks, vs, t_ks, t_vs = _scaled_ring(rng, B, S, Hkv, D, kv_quant)
    ck = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    cv = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    slot_pos = np.tile(np.arange(S, dtype=np.int32)[None], (B, 1))
    slot_valid = rng.random((B, S)) > 0.2
    q_pos = S + np.tile(np.arange(T, dtype=np.int32)[None], (B, 1))
    q_valid = np.tile(np.arange(T)[None] < T - 1, (B, 1))
    w = S + T - 3

    ring = (q, kq, vq, ks, vs, q_pos, slot_pos, q_valid, slot_valid)
    jr = jpal.ring_attention_stats(*map(jnp.asarray, ring), jnp.int32(w), interpret=True)
    tr = tk.ring_attention_stats(
        _t(q), _t(kq), _t(vq), None if t_ks is None else _t(t_ks),
        None if t_vs is None else _t(t_vs), *map(_t, ring[5:]), w,
    )
    vis = np.asarray(sliding_window_mask(*map(jnp.asarray, ring[5:]), jnp.int32(w)).any(-1))
    for ours, theirs in zip(tr, jr):
        np.testing.assert_allclose(ours.numpy()[vis], np.asarray(theirs)[vis], atol=2e-5, rtol=2e-5)

    tc = tk.flash_attention(_t(q), _t(ck), _t(cv), _t(q_pos), _t(q_pos), _t(q_valid),
                            _t(q_valid), w, return_stats=True)
    out = tk.merge_attention_parts(*tr, *tc).numpy()

    k_deq = kq.reshape(B, S, Hkv, D).astype(np.float32) * np.moveaxis(ks, 1, 2)[..., None]
    v_deq = vq.reshape(B, S, Hkv, D).astype(np.float32) * np.moveaxis(vs, 1, 2)[..., None]
    keys = jnp.concatenate([k_deq, ck], axis=1)
    vals = jnp.concatenate([v_deq, cv], axis=1)
    kv_pos = jnp.concatenate([slot_pos, q_pos], axis=1)
    kv_valid = jnp.concatenate([slot_valid, q_valid], axis=1)
    mask = sliding_window_mask(jnp.asarray(q_pos), kv_pos, jnp.asarray(q_valid), kv_valid, w)
    ref = np.asarray(attend(jnp.asarray(q), keys, vals, mask)).reshape(B, T, H, D)
    valid = q_valid[..., None, None]
    np.testing.assert_allclose(out * valid, ref * valid, atol=3e-4, rtol=3e-4)


def _decode_setup(kv_quant, rng, L=3, B=4, S=256, Hkv=2, H=4, D=128):
    """tests/test_fused_decode.py's setup."""
    kf = rng.standard_normal((L, B, S, Hkv, D)).astype(np.float32)
    vf = rng.standard_normal((L, B, S, Hkv, D)).astype(np.float32)
    if kv_quant == "bf16":  # the model dtype (fp32 here) ring, no scales
        CK, CV, KS, VS = kf.reshape(L, B, S, -1), vf.reshape(L, B, S, -1), None, None
    else:
        CKq, KSs = jcache._quantize_ring(jnp.asarray(kf), RING[kv_quant])
        CVq, VSs = jcache._quantize_ring(jnp.asarray(vf), RING[kv_quant])
        CK, CV = np.array(CKq).reshape(L, B, S, -1), np.array(CVq).reshape(L, B, S, -1)
        KS, VS = np.moveaxis(np.asarray(KSs), 2, 3).copy(), np.moveaxis(np.asarray(VSs), 2, 3).copy()
    xq = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    xk = rng.standard_normal((B, 1, Hkv, D)).astype(np.float32)
    xv = rng.standard_normal((B, 1, Hkv, D)).astype(np.float32)
    return CK, CV, KS, VS, xq, xk, xv


@pytest.mark.parametrize("kv_quant", ["int8", "bf16"])
@pytest.mark.parametrize(
    "S,window,kv_len,live",
    [
        (256, 200, [5, 199, 230, 0], [1, 1, 1, 0]),  # near-full, wrapped, empty, dead
        (384, 384, [3, 60, 370, 17], [1, 1, 1, 1]),  # fills that end mid-tile
    ],
)
def test_fused_decode_plain_matches_pallas(kv_quant, S, window, kv_len, live):
    rng = np.random.default_rng(7)
    L, B, Hkv, H, D, li = 3, 4, 2, 4, 128, 1
    CK, CV, KS, VS, xq, xk, xv = _decode_setup(kv_quant, rng, L, B, S, Hkv, H, D)
    kv_len, live = np.asarray(kv_len, np.int32), np.asarray(live, np.int32)
    positions = kv_len[:, None]
    new_total = kv_len + live
    should = (live > 0) & (kv_len >= new_total - window)
    write_slot = np.where(should, kv_len % window, -1).astype(np.int32)
    slot_pos, slot_valid = (np.asarray(a) for a in jcache.slot_positions(
        jnp.asarray(new_total), jnp.int32(window), S))

    # The two-op XLA oracle: update_stacked, then ring-only attention.
    empty = jnp.ones((L, 0, 0, 0), jnp.float32)
    J = jcache.update_stacked(
        jnp.asarray(CK), jnp.asarray(CV), empty if KS is None else jnp.asarray(KS),
        empty if VS is None else jnp.asarray(VS), jnp.int32(li), jnp.asarray(xk),
        jnp.asarray(xv), jnp.asarray(positions), jnp.asarray(live[:, None] > 0),
        jnp.asarray(new_total), jnp.int32(window),
    )
    mask = sliding_window_mask(jnp.asarray(positions), jnp.asarray(slot_pos),
                               jnp.asarray(live[:, None] > 0), jnp.asarray(slot_valid), window)
    ring_k, ring_v = J[0][li].reshape(B, S, Hkv, D), J[1][li].reshape(B, S, Hkv, D)
    if KS is None:
        ref = attend(jnp.asarray(xq), ring_k, ring_v, mask)
    else:
        ref = attend_scaled(jnp.asarray(xq), ring_k, ring_v, jnp.moveaxis(J[2][li], 1, 2),
                            jnp.moveaxis(J[3][li], 1, 2), mask)
    jout = jpal.fused_update_decode_attention(
        jnp.asarray(xq), jnp.asarray(xk), jnp.asarray(xv), jnp.asarray(CK), jnp.asarray(CV),
        None if KS is None else jnp.asarray(KS), None if VS is None else jnp.asarray(VS),
        jnp.int32(li), jnp.int32(window), jnp.asarray(write_slot), jnp.asarray(kv_len),
        jnp.asarray(slot_pos), jnp.asarray(slot_valid), interpret=True,
    )[0]

    stacks = [None if a is None else _t(a) for a in (CK, CV, KS, VS)]
    out = tk.fused_update_decode_attention(
        _t(xq), _t(xk), _t(xv), *stacks, li, window, _t(write_slot), _t(kv_len),
        _t(slot_pos), _t(slot_valid),
    ).numpy()
    for ours, theirs in zip(stacks, J):
        if ours is not None:
            _bytes_equal(ours, theirs)
    rows = live > 0
    np.testing.assert_allclose(out[rows], np.asarray(ref)[rows], atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(out[rows], np.asarray(jout)[rows], atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("kv_quant", ["int8", "bf16"])
@pytest.mark.parametrize("S,Hkv,H,wrap", [(40, 2, 4, 0), (1100, 2, 8, 0), (300, 2, 4, 77)],
                         ids=["40-2-4", "1100-2-8", "wrapped-300-2-4"])
def test_decode_attention_plain_matches_pallas(S, Hkv, H, kv_quant, wrap):
    """K6's plain version against the Pallas decode kernel (interpret mode)
    and the XLA oracle, at tests/test_pallas.py::
    test_decode_attention_matches_oracle's shapes: the real ring at layer 1 of
    a 3-layer stack, holes in kv_valid, a window shorter than the ring. The
    ring is not written. With ``wrap``, the ring has wrapped: S + wrap tokens
    were written, so its first ``wrap`` slots hold the newest positions (not
    monotonic over the slots), and the window, 50 shorter than the ring,
    hides the oldest slots in the middle of the ring."""
    rng = np.random.default_rng(S)
    B, D, L, li = 2, 128, 3, 1
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    kq, vq, ks, vs, t_ks, t_vs = _scaled_ring(rng, B, S, Hkv, D, kv_quant)
    kv_pos = np.tile(np.arange(S, dtype=np.int32)[None], (B, 1))
    kv_pos[:, :wrap] += S
    q_pos = np.full((B, 1), S + wrap - 1, np.int32)
    kv_valid = rng.random((B, S)) > 0.2
    w = S - 50 if wrap else S - 3

    def stack3(x):
        return None if x is None else np.stack([np.zeros_like(x), x, np.zeros_like(x) + 1])

    CK, CV, KS, VS = stack3(kq), stack3(vq), stack3(t_ks), stack3(t_vs)
    jout = jpal.decode_attention(
        jnp.asarray(q), jnp.asarray(CK), jnp.asarray(CV),
        None if KS is None else jnp.asarray(KS), None if VS is None else jnp.asarray(VS),
        jnp.int32(li), jnp.asarray(q_pos), jnp.asarray(kv_pos), jnp.asarray(kv_valid),
        jnp.int32(w), interpret=True,
    )
    k_deq = kq.reshape(B, S, Hkv, D).astype(np.float32) * np.moveaxis(ks, 1, 2)[..., None]
    v_deq = vq.reshape(B, S, Hkv, D).astype(np.float32) * np.moveaxis(vs, 1, 2)[..., None]
    mask = sliding_window_mask(jnp.asarray(q_pos), jnp.asarray(kv_pos), jnp.ones((B, 1), bool),
                               jnp.asarray(kv_valid), jnp.int32(w))
    oracle = np.asarray(attend(jnp.asarray(q), jnp.asarray(k_deq), jnp.asarray(v_deq), mask))

    stacks = [None if a is None else _t(a) for a in (CK, CV, KS, VS)]
    before = [None if t is None else t.clone() for t in stacks]
    args = (_t(q), *stacks, li, _t(q_pos), _t(kv_pos), _t(kv_valid), w)
    out = tk.decode_attention_plain(*args)
    assert out.shape == (B, 1, H * D)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout).reshape(B, 1, H * D),
                               atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(out.numpy(), oracle.reshape(B, 1, H * D), atol=2e-4, rtol=2e-4)
    # On CPU tensors the wrapper is the plain version; (B,) positions too.
    assert torch.equal(tk.decode_attention(*args), out)
    assert torch.equal(tk.decode_attention(*args[:6], _t(q_pos[:, 0]), *args[7:]), out)
    for a, b in zip(stacks, before):
        assert a is None or torch.equal(a, b)


def test_wrappers_count_only_kernel_launches():
    """On CPU tensors a wrapper runs its plain version and counts nothing."""
    cuda_ops.reset_launch_counts()
    q, k, v, q_pos, kv_pos, q_valid, kv_valid = _attention_case(1, 4, 4, 2, 1, 128)
    tk.flash_attention(*(_t(a) for a in (q, k, v, q_pos, kv_pos, q_valid, kv_valid)), 8)
    assert len(tk.KERNELS) == 10 and len(cuda_ops.all_kernels()) == 14
    assert [fn.launches for fn in cuda_ops.all_kernels()] == [0] * 14
