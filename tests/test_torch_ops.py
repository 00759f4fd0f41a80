"""The port's plain ops against the JAX package's, in fp32 on the CPU.

Tolerance 1e-5: both sides compute the same fp32 expressions; only the
order of summation (mean of squares, einsum contractions) and libm
differences (pow, cos, sin, exp) separate them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistral_inference_tpu.ops import attention as jattn
from mistral_inference_tpu.ops import norm as jnorm
from mistral_inference_tpu.ops import rope as jrope
from mistral_inference_tpu_torch.ops import attention as tattn
from mistral_inference_tpu_torch.ops import norm as tnorm
from mistral_inference_tpu_torch.ops import rope as trope

TOL = 1e-5


def _np(x):
    return np.array(x, np.float32)


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 128)])
def test_rms_norm_matches_jax(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    ref = jnorm.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    out = tnorm.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    B, T, H, Dh = 2, 7, 3, 32
    pos = rng.integers(0, 5000, (B, T)).astype(np.int32)
    x = rng.standard_normal((B, T, H, Dh)).astype(np.float32)
    jc, js = jrope.rope_for_positions(jnp.asarray(pos), Dh, theta)
    tc, ts = trope.rope_for_positions(torch.from_numpy(pos), Dh, theta)
    # Angles reach 5000 rad: an ulp of the angle is ~5e-4 rad, so cos/sin are
    # compared at that scale; the rotation itself at 1e-5 on shared tables.
    np.testing.assert_allclose(tc.numpy(), _np(jc), atol=2e-3)
    np.testing.assert_allclose(ts.numpy(), _np(js), atol=2e-3)
    ref = jrope.apply_rope(jnp.asarray(x), jc, js)
    out = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(_np(jc)), torch.from_numpy(_np(js)))
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=TOL, rtol=TOL)


def test_rope_small_positions_match_jax():
    """At prompt-sized positions the angle tables themselves agree to 1e-5."""
    pos = np.arange(64, dtype=np.int32).reshape(2, 32)
    jc, js = jrope.rope_for_positions(jnp.asarray(pos), 128, 1e4)
    tc, ts = trope.rope_for_positions(torch.from_numpy(pos), 128, 1e4)
    np.testing.assert_allclose(tc.numpy(), _np(jc), atol=TOL)
    np.testing.assert_allclose(ts.numpy(), _np(js), atol=TOL)


def _attention_inputs(B, T, S, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    kv_pos = np.stack([np.arange(S) + rng.integers(0, 3) for _ in range(B)]).astype(np.int32)
    q_pos = kv_pos[:, -T:]
    q_valid = np.ones((B, T), bool)
    q_valid[0, -1] = False
    kv_valid = rng.random((B, S)) > 0.2
    return q, k, v, q_pos, kv_pos, q_valid, kv_valid


@pytest.mark.parametrize("window", [1 << 20, 6])
def test_sliding_window_mask_matches_jax(window):
    _, _, _, q_pos, kv_pos, q_valid, kv_valid = _attention_inputs(2, 9, 20, 4, 2, 8, 2)
    ref = jattn.sliding_window_mask(*map(jnp.asarray, (q_pos, kv_pos, q_valid, kv_valid)), window)
    out = tattn.sliding_window_mask(
        *map(torch.from_numpy, (q_pos, kv_pos, q_valid, kv_valid)), window
    )
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("B,T,S,H,Hkv,window", [(2, 9, 20, 4, 2, 6), (1, 1, 33, 8, 2, 1 << 20)])
def test_attend_matches_jax(B, T, S, H, Hkv, window):
    q, k, v, q_pos, kv_pos, q_valid, kv_valid = _attention_inputs(B, T, S, H, Hkv, 32, 3)
    jm = jattn.sliding_window_mask(*map(jnp.asarray, (q_pos, kv_pos, q_valid, kv_valid)), window)
    ref = jattn.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm)
    out = tattn.attend(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(np.array(jm)),
    )
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=TOL, rtol=TOL)


def test_attend_scaled_matches_jax():
    q, k, v, q_pos, kv_pos, q_valid, kv_valid = _attention_inputs(2, 5, 24, 4, 2, 32, 4)
    rng = np.random.default_rng(5)
    kq = np.round(k * 40).clip(-127, 127).astype(np.int8)
    vq = np.round(v * 40).clip(-127, 127).astype(np.int8)
    ks = (rng.random((2, 24, 2)) * 0.05 + 0.01).astype(np.float32)
    vs = (rng.random((2, 24, 2)) * 0.05 + 0.01).astype(np.float32)
    jm = jattn.sliding_window_mask(*map(jnp.asarray, (q_pos, kv_pos, q_valid, kv_valid)), 10)
    ref = jattn.attend_scaled(*map(jnp.asarray, (q, kq, vq, ks, vs)), jm)
    out = tattn.attend_scaled(
        *map(torch.from_numpy, (q, kq, vq, ks, vs)), torch.from_numpy(np.array(jm))
    )
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=TOL, rtol=TOL)


def test_jax_runs_on_cpu():
    assert jax.devices()[0].platform == "cpu"
