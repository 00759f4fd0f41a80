"""K9's plain version (``ops/cuda/ssd_step.py``), the formula the CUDA kernel
computes, against the JAX package's Pallas kernel in interpret mode and its
chunked-SSD oracle at T = 1, on tests/test_ssd_step.py's shapes.

Tolerances: y 1e-5 and the fp32 state 1e-6 against the Pallas kernel and the
oracle (fp32, the same products summed in another order); a bf16 state
exactly (it computes in fp32 and rounds once, at the store, as the JAX
kernel does); a dead row's state and the layers other than ``li`` keep their
bits, and the stack is written in place.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistral_inference_tpu.models.mamba import _ssd_chunked as jax_ssd_chunked
from mistral_inference_tpu.ops.pallas.ssd_step import fused_ssd_step_stacked as jax_step_stacked
from mistral_inference_tpu_torch.models.mamba import _ssd_chunked
from mistral_inference_tpu_torch.ops.cuda import ssd_step as k9

L, B, NH, HD, DS, NG = 3, 2, 8, 16, 32, 4


def _case(seed=0, dead_row=None):
    """numpy inputs: x (B, 1, nh, hd), dt (B, 1, nh), A, Bm / Cm (B, 1, ng,
    ds), a stack (L, B, nh, hd, ds); and a = exp(dt A), dtx = dt x."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 1, NH, HD)).astype(np.float32)
    dt = rng.uniform(0.1, 1.0, (B, 1, NH)).astype(np.float32)
    if dead_row is not None:
        dt[dead_row] = 0.0
    A = -rng.uniform(0.5, 2.0, (NH,)).astype(np.float32)
    Bm = rng.normal(size=(B, 1, NG, DS)).astype(np.float32)
    Cm = rng.normal(size=(B, 1, NG, DS)).astype(np.float32)
    ssm = rng.normal(size=(L, B, NH, HD, DS)).astype(np.float32)
    a = np.exp(dt[:, 0] * A[None, :])
    dtx = dt[:, 0, :, None] * x[:, 0]
    return x, dt, A, Bm, Cm, ssm, a, dtx


def _t(a):
    return torch.from_numpy(np.array(a))  # a copy: the step writes its stack in place


def _port_step(a, dtx, Bm, Cm, ssm, li, dtype=torch.float32):
    stack = _t(ssm).to(dtype)
    y = k9.fused_ssd_step_stacked(_t(a), _t(dtx), _t(Bm[:, 0]), _t(Cm[:, 0]), stack, li)
    return y, stack


@pytest.mark.parametrize("li", [0, 1, 2])
def test_plain_matches_pallas_interpret(monkeypatch, li):
    monkeypatch.setenv("MISTRAL_PALLAS_INTERPRET", "1")
    _, _, _, Bm, Cm, ssm, a, dtx = _case(seed=li)
    y_ref, ssm_ref = jax_step_stacked(
        jnp.asarray(a), jnp.asarray(dtx), jnp.asarray(Bm[:, 0]), jnp.asarray(Cm[:, 0]),
        jnp.asarray(ssm), jnp.int32(li), interpret=True,
    )
    y, stack = _port_step(a, dtx, Bm, Cm, ssm, li)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(stack.numpy(), np.asarray(ssm_ref), atol=1e-6, rtol=1e-6)


def test_plain_matches_chunked_oracle():
    """Against the JAX package's ``_ssd_chunked`` at T = 1, and the port's."""
    x, dt, A, Bm, Cm, ssm, a, dtx = _case(seed=4)
    li = 1
    y_ref, h_ref = jax_ssd_chunked(*(jnp.asarray(v) for v in (x, dt, A, Bm, Cm, ssm[li])), 1)
    y, stack = _port_step(a, dtx, Bm, Cm, ssm, li)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref[:, 0]), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(stack[li].numpy(), np.asarray(h_ref), atol=1e-6, rtol=1e-6)
    y_port, h_port = _ssd_chunked(*(_t(v) for v in (x, dt, A, Bm, Cm, ssm[li])), 1)
    np.testing.assert_allclose(y.numpy(), y_port[:, 0].numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(stack[li].numpy(), h_port.numpy(), atol=1e-6, rtol=1e-6)


def test_bf16_state_rounds_at_store_only(monkeypatch):
    """A bf16 state computes in fp32 and rounds once, at the store: its bits
    are those of the JAX kernel's (interpret mode) on the same bf16 stack."""
    monkeypatch.setenv("MISTRAL_PALLAS_INTERPRET", "1")
    _, _, _, Bm, Cm, ssm, a, dtx = _case(seed=2)
    li = 2
    stack_bf16 = jnp.asarray(ssm).astype(jnp.bfloat16)
    y_ref, ssm_ref = jax_step_stacked(
        jnp.asarray(a), jnp.asarray(dtx), jnp.asarray(Bm[:, 0]), jnp.asarray(Cm[:, 0]),
        stack_bf16, jnp.int32(li), interpret=True,
    )
    y, stack = _port_step(a, dtx, Bm, Cm, ssm, li, torch.bfloat16)
    assert stack.dtype == torch.bfloat16
    np.testing.assert_array_equal(stack.float().numpy(), np.asarray(ssm_ref.astype(jnp.float32)))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dead_row_state_bit_unchanged(dtype):
    """dt = 0 (a dead slot or a padding token): a = 1 and dtx = 0 leave the
    state's bits as they were."""
    _, _, _, Bm, Cm, ssm, a, dtx = _case(seed=3, dead_row=1)
    _, stack = _port_step(a, dtx, Bm, Cm, ssm, 0, dtype)
    assert torch.equal(stack[0, 1], _t(ssm[0, 1]).to(dtype))
    assert not torch.equal(stack[0, 0], _t(ssm[0, 0]).to(dtype))


def test_stacked_updates_only_li_in_place():
    _, _, _, Bm, Cm, ssm, a, dtx = _case(seed=5)
    li = 1
    stack = _t(ssm)
    ptr = stack.data_ptr()
    before = k9.fused_ssd_step_stacked.launches
    y = k9.fused_ssd_step_stacked(_t(a), _t(dtx), _t(Bm[:, 0]), _t(Cm[:, 0]), stack, li)
    assert stack.data_ptr() == ptr
    for other in (0, 2):
        assert torch.equal(stack[other], _t(ssm[other]))
    one = _t(ssm[li])
    y1 = k9.fused_ssd_step(_t(a), _t(dtx), _t(Bm[:, 0]), _t(Cm[:, 0]), one)
    assert torch.equal(y1, y) and torch.equal(one, stack[li])
    # CPU tensors run the plain version: no kernel launch is counted.
    assert k9.fused_ssd_step_stacked.launches == before
