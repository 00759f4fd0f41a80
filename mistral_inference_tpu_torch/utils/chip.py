"""The card's published peaks, from which every roofline bound derives
(counterpart of ``mistral_inference_tpu/utils/chip.py``).

Numbers are NVIDIA's H100 Tensor Core GPU data sheet, SXM part, dense rates
(without sparsity), stated at the part's full 700 W power limit: 989
TFLOP/s bf16, 67 TFLOP/s fp32 outside the tensor cores, 1979 TFLOP/s fp8,
1979 TOP/s int8; 80 GB of HBM3 at 3.35 TB/s; 132 SMs. A card set below its
full limit (``nvidia-smi --query-gpu=power.limit``) runs slower under load,
so state a bound beside the card's limit.

A card is looked up by the name ``torch.cuda.get_device_name()`` gives, by
its longest matching prefix. There is no default entry: a bound taken from
another card's sheet would be a wrong number, so an unknown card raises
``KeyError``.

The TPU module's ``MXU_TILE``, ``clock_hz`` and ``tile_load_seconds`` (the
systolic array's tile-load floor) have no counterpart: a Hopper SM has no
systolic array whose tile loads bound a product.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch


@dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_gbps: float  # HBM bandwidth, GB/s
    hbm_gb: float  # HBM capacity, GB
    bf16_tflops: float  # peak dense bf16 (and fp16), tensor cores
    fp32_tflops: float  # peak fp32 outside the tensor cores
    fp8_tflops: float  # peak dense fp8, tensor cores
    int8_tops: float  # peak dense int8, tensor cores
    sm_count: int
    power_w: float  # the power limit the peaks are stated at

    def hbm_seconds(self, nbytes: float) -> float:
        """The least time to move ``nbytes`` to or from HBM."""
        return nbytes / (self.hbm_gbps * 1e9)

    def flop_seconds(self, flops: float, dtype: torch.dtype = torch.bfloat16) -> float:
        """The least time for ``flops`` operations on inputs of ``dtype``."""
        if dtype in (torch.bfloat16, torch.float16):
            peak = self.bf16_tflops
        elif dtype == torch.float32:
            peak = self.fp32_tflops
        elif dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
            peak = self.fp8_tflops
        elif dtype == torch.int8:
            peak = self.int8_tops
        else:
            raise ValueError(f"no published peak for {dtype}")
        return flops / (peak * 1e12)


# Keyed by torch.cuda.get_device_name() prefixes (longest prefix wins).
CHIP_SPECS = {
    "NVIDIA H100 80GB HBM3": ChipSpec("H100 SXM", 3350.0, 80.0, 989.0, 67.0, 1979.0, 1979.0,
                                      132, 700.0),
}


def spec_for_device_name(name: str) -> ChipSpec:
    """The spec of the longest prefix of ``name`` in ``CHIP_SPECS``; raises
    ``KeyError`` for a card the table does not hold."""
    best = None
    for prefix, spec in CHIP_SPECS.items():
        if name.startswith(prefix) and (best is None or len(prefix) > best[0]):
            best = (len(prefix), spec)
    if best is None:
        raise KeyError(f"no published peaks for the card {name!r}: add its data sheet's "
                       "numbers to utils/chip.py")
    return best[1]


def spec_for_device(device: Optional[Union[int, str, torch.device]] = None) -> ChipSpec:
    """The spec of a CUDA device (the current one when None)."""
    return spec_for_device_name(torch.cuda.get_device_name(device))
