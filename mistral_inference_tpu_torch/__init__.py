"""PyTorch + CUDA port of ``mistral_inference_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference each module is held
against. This package imports ``torch`` and numpy only: it never imports
``jax`` or anything of ``mistral_inference_tpu``.

Entry points (``model.Transformer.random``, ``from_folder``,
``generate.generate``, the console scripts of ``main``) run on ``cuda``
unless the caller passes ``device="cpu"``; on the CPU every CUDA kernel
wrapper runs its plain PyTorch version.

The top level gives the JAX package's names: the argument classes and
``load_args`` at once, and ``Transformer``, ``Mamba``, ``from_folder``,
``get_model_cls`` and ``load_tokenizer`` on first use, so that a config-only
import loads no model code. ``generate`` is not re-exported: the name is the
``generate`` submodule's.
"""

import importlib

from mistral_inference_tpu_torch.args import (  # noqa: F401
    LoraArgs,
    MambaArgs,
    MoeArgs,
    TransformerArgs,
    VisionEncoderArgs,
    load_args,
)

__version__ = "0.1.0"

__all__ = ["LoraArgs", "MambaArgs", "MoeArgs", "TransformerArgs", "VisionEncoderArgs",
           "load_args", "Transformer", "Mamba", "from_folder", "get_model_cls",
           "load_tokenizer"]


def __getattr__(name):
    # importlib, so that a submodule of the same name does not re-enter here.
    if name in ("Transformer", "Mamba", "from_folder", "get_model_cls"):
        return getattr(importlib.import_module("mistral_inference_tpu_torch.model"), name)
    if name == "load_tokenizer":
        return importlib.import_module("mistral_inference_tpu_torch.tokenizers").load_tokenizer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
