"""PyTorch + CUDA port of ``mistral_inference_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference each module is held
against. This package imports ``torch`` and numpy only: it never imports
``jax`` or anything of ``mistral_inference_tpu``.

Entry points (``model.Transformer.random``, ``generate.generate``) run on
``cuda`` unless the caller passes ``device="cpu"``; on the CPU every CUDA
kernel wrapper runs its plain PyTorch version.
"""

from mistral_inference_tpu_torch.args import TransformerArgs

__all__ = ["TransformerArgs"]
