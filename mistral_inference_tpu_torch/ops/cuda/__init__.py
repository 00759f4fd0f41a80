"""The port's hand-written CUDA kernels: wrappers, plain versions, sources.

``all_kernels()`` lists every launch counter: each wrapper that launches a
kernel, counting its launches in its ``launches`` attribute, and the fp8 ring
instantiation of each ring kernel (``attention.FP8_LAUNCHES``), counted
apart, so a run can show which kernels its path went through.
"""

from __future__ import annotations

from typing import Callable, Tuple


def all_kernels() -> Tuple[Callable, ...]:
    from mistral_inference_tpu_torch.ops.cuda import attention, matmul_quant, moe_matmul, ssd_step

    return attention.KERNELS + matmul_quant.KERNELS + moe_matmul.KERNELS + ssd_step.KERNELS


def reset_launch_counts() -> None:
    for fn in all_kernels():
        fn.launches = 0
