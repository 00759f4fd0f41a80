"""The Mamba2 SSD decode step: wrapper, launch counter and plain PyTorch
version (counterpart of ``mistral_inference_tpu/ops/pallas/ssd_step.py``).

One hand-written CUDA kernel for Hopper (K9, ``csrc/ssd_step.cu``) serves both
entry names: ``fused_ssd_step_stacked(a, dtx, Bm, Cm, ssm, li)`` updates layer
``li`` of the ``(L, B, nh, hd, ds)`` state stack in place through a pointer
offset, and ``fused_ssd_step(a, dtx, Bm, Cm, h)`` is its depth-1 case. Per
row b, head h (group g = h // (nh // ng)):

    h' = a[b, h] * h + dtx[b, h, :, None] * Bm[b, g, None, :]
    y[b, h, :] = (h' * Cm[b, g, None, :]).sum(-1)

in fp32. A bf16 state computes in fp32 and rounds once, at the store. The
state's new bits are those of the plain version, evaluated op by op; y may
differ from it by summation order only. A dead row (dt = 0: a = 1, dtx = 0)
keeps its state's bits, and layers other than ``li`` are never touched.

The wrappers launch the kernel for CUDA tensors and for nothing else: on CPU
tensors they run ``fused_ssd_step_stacked_plain``. There is no fallback from a
CUDA tensor to the plain version. ``fused_ssd_step_stacked.launches`` counts
the kernel's launches through either entry name.
"""

from __future__ import annotations

import functools

import torch

from mistral_inference_tpu_torch.ops.cuda import _call

_P, _I = _call.P, _call.I
_SIGS = {("ssd_step", "ssd_step"): [_P] * 6 + [_I] * 6 + [_P]}
_launch = functools.partial(_call.launch, _SIGS)
_need = _call.need


def fused_ssd_step_stacked_plain(
    a: torch.Tensor, dtx: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
    ssm: torch.Tensor, li: int,
) -> torch.Tensor:
    """Plain version of K9, the kernel's formula in PyTorch: writes layer
    ``li`` of ``ssm`` in place and returns y (B, nh, hd) fp32."""
    nh, ng = a.shape[1], Bm.shape[1]
    rep = nh // ng
    Bh = Bm.float().repeat_interleave(rep, dim=1)[:, :, None, :]  # (B, nh, 1, ds)
    Ch = Cm.float().repeat_interleave(rep, dim=1)[:, :, None, :]
    hn = ssm[li].float() * a.float()[:, :, None, None] + dtx.float()[..., None] * Bh
    ssm[li] = hn.to(ssm.dtype)
    return (hn * Ch).sum(-1)


def _run(a, dtx, Bm, Cm, ssm, li: int) -> torch.Tensor:
    L, B, nh, hd, ds = ssm.shape
    ng = Bm.shape[1]
    dev = ssm.device
    f32 = torch.float32
    if ssm.dtype not in (f32, torch.bfloat16):
        raise TypeError(f"the state must be fp32 or bf16, got {ssm.dtype}")
    _need(ssm, "ssm", ssm.dtype, (L, B, nh, hd, ds), dev)
    _need(a, "a", f32, (B, nh), dev)
    _need(dtx, "dtx", f32, (B, nh, hd), dev)
    _need(Bm, "Bm", f32, (B, ng, ds), dev)
    _need(Cm, "Cm", f32, (B, ng, ds), dev)
    if ds % 4 or ng < 1 or nh % ng:
        raise ValueError(f"the kernel takes ds % 4 == 0 and n_groups dividing the heads; "
                         f"got ds={ds} heads={nh} groups={ng}")
    if not 0 <= li < L:
        raise ValueError(f"layer index {li} out of range for {L} layers")
    y = torch.empty((B, nh, hd), dtype=f32, device=dev)
    layer = ssm.data_ptr() + li * B * nh * hd * ds * ssm.element_size()
    _launch(
        "ssd_step", "ssd_step", dev, a.data_ptr(), dtx.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), layer, y.data_ptr(), B, nh, hd, ds, ng, int(ssm.dtype == torch.bfloat16),
    )
    fused_ssd_step_stacked.launches += 1
    return y


def fused_ssd_step_stacked(
    a: torch.Tensor,  # (B, nh) fp32: exp(dt A)
    dtx: torch.Tensor,  # (B, nh, hd) fp32: dt x
    Bm: torch.Tensor,  # (B, ng, ds) fp32
    Cm: torch.Tensor,  # (B, ng, ds) fp32
    ssm: torch.Tensor,  # (L, B, nh, hd, ds) fp32 | bf16, updated in place
    li: int,
) -> torch.Tensor:
    """K9: one decode step of layer ``li``. Returns y (B, nh, hd) fp32."""
    if ssm.dim() != 5:
        raise ValueError("fused_ssd_step_stacked takes the (L, B, nh, hd, ds) state stack")
    if not ssm.is_cuda:
        return fused_ssd_step_stacked_plain(a, dtx, Bm, Cm, ssm, int(li))
    return _run(a, dtx, Bm, Cm, ssm, int(li))


fused_ssd_step_stacked.launches = 0


def fused_ssd_step(
    a: torch.Tensor, dtx: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, h: torch.Tensor,
) -> torch.Tensor:
    """K9 on one layer's state h (B, nh, hd, ds), updated in place: a stack
    of depth 1. Returns y (B, nh, hd) fp32."""
    if h.dim() != 4:
        raise ValueError("fused_ssd_step takes one layer's (B, nh, hd, ds) state")
    return fused_ssd_step_stacked(a, dtx, Bm, Cm, h[None], 0)


KERNELS = (fused_ssd_step_stacked,)
