"""What every kernel wrapper needs around a launch: the ctypes binding of a
built library's functions, the launch on PyTorch's current stream with its
error check, and the operand checks. A kernel reads its operands through raw
pointers, so a wrapper checks device, dtype, shape, contiguity and alignment
first and raises on what the kernel does not take.

Each wrapper module keeps one table of signatures, ``{(library, function):
[argument types]}`` with the stream pointer last: a wrong arity corrupts
silently, so the table sits beside the calls it describes.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from mistral_inference_tpu_torch.ops.cuda import _build

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

Sigs = Dict[Tuple[str, str], List[type]]

_FNS: Dict[Tuple[str, str], object] = {}


def kernel(sigs: Sigs, lib: str, name: str):
    """The C function ``name`` of ``csrc/<lib>.cu``, built and bound at first use."""
    fn = _FNS.get((lib, name))
    if fn is None:
        fn = getattr(_build.load(lib), name)
        fn.argtypes = sigs[(lib, name)]
        fn.restype = ctypes.c_int
        _FNS[(lib, name)] = fn
    return fn


def launch(sigs: Sigs, lib: str, name: str, device: torch.device, *args) -> None:
    """Call ``name`` with ``args`` and the current stream of ``device``; raise
    if the launch was refused (it returns the CUDA error code)."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = kernel(sigs, lib, name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def need(t: torch.Tensor, name: str, dtype, shape, device) -> torch.Tensor:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    return t
