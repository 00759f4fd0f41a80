"""Host handles around the forwards: ``Transformer`` (dense or sparse-MoE)
and ``Mamba`` (Mamba2), with bf16 or weight-only quantized linears
(counterpart of ``mistral_inference_tpu/model.py::Transformer`` and
``::Mamba``)."""

from __future__ import annotations

from typing import Optional, Union

import torch

from mistral_inference_tpu_torch.args import MambaArgs, TransformerArgs
from mistral_inference_tpu_torch.cache import KVCache
from mistral_inference_tpu_torch.models import mamba as mm
from mistral_inference_tpu_torch.models import transformer as tf

MAX_SEQ_LEN = 128_000  # positions the reference's RoPE table covers


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The card by default. Without one this raises: the port never runs on
    the CPU unless the caller asks for it with ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU"
            )
        device = "cuda"
    return torch.device(device)


class Transformer:
    """Args, parameters (a dict of tensors on one device) and the dtype."""

    def __init__(
        self,
        args: TransformerArgs,
        params: tf.Params,
        dtype: torch.dtype = torch.bfloat16,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.args = args
        self.dtype = dtype
        self.device = resolve_device(device)
        self.params = params

    @classmethod
    def random(
        cls,
        args: TransformerArgs,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        device: Optional[Union[str, torch.device]] = None,
        quant: Optional[str] = None,
        group: int = 128,
    ) -> "Transformer":
        """Random weights from ``seed``, made directly on ``device`` (the card
        unless ``device="cpu"``). With ``quant`` ("int8" | "int4") every big
        linear is quantized as it is drawn: the same model as
        ``random(...).quantize(quant)``, without ever holding its dense form,
        which for Mixtral-8x7B exceeds the card."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = tf.init_params(args, dtype, gen, dev, quant, group)
        if quant is not None:
            args.quant = quant
        return cls(args, params, dtype, dev)

    def quantize(self, mode: str, group: int = 128) -> "Transformer":
        """Weight-only quantization in place: "int8" | "int4"
        (``quant/weights.py``). Returns self for chaining."""
        from mistral_inference_tpu_torch.quant.weights import quantize_params

        self.params = quantize_params(self.params, mode, group)
        self.args.quant = mode
        return self

    def alloc_cache(self, batch: int, max_seq_len: int) -> KVCache:
        if max_seq_len > MAX_SEQ_LEN:
            raise ValueError(f"max_seq_len {max_seq_len} exceeds {MAX_SEQ_LEN}")
        return KVCache.alloc(
            n_layers=self.args.n_layers,
            batch=batch,
            max_seq_len=max_seq_len,
            n_kv_heads=self.args.n_kv_heads,
            head_dim=self.args.head_dim,
            sliding_window=self.args.sliding_window,
            dtype=self.dtype,
            kv_quant=self.args.kv_quant,
            device=self.device,
        )

    def forward(
        self,
        tokens: torch.Tensor,  # (B, T)
        seqlens: torch.Tensor,  # (B,)
        cache: KVCache,
        attend_cache: bool = True,
        head: str = "full",
        write_cache: Union[bool, str] = True,
        input_embeds: Optional[torch.Tensor] = None,
    ):
        """Prelogits (B, T, V) fp32, or hidden states with ``head="none"``.
        The cache is updated in place. ``write_cache`` (False | "spec") is
        speculative decoding's verify pass, and ``input_embeds`` (B, T, dim)
        replaces the token embeddings: see ``models.transformer.forward``."""
        with torch.inference_mode():
            return tf.forward(
                self.params, tokens.to(self.device), seqlens.to(self.device), cache,
                self.args, attend_cache, head=head, write_cache=write_cache,
                input_embeds=None if input_embeds is None else input_embeds.to(self.device),
            )


class Mamba:
    """Args, parameters (a dict of tensors on one device), the dtype and the
    SSD state's dtype."""

    def __init__(
        self,
        args: MambaArgs,
        params: mm.Params,
        dtype: torch.dtype = torch.bfloat16,
        device: Optional[Union[str, torch.device]] = None,
        ssm_dtype: torch.dtype = torch.float32,
    ):
        self.args = args
        self.dtype = dtype
        self.ssm_dtype = ssm_dtype
        self.device = resolve_device(device)
        self.params = params

    @classmethod
    def random(
        cls,
        args: MambaArgs,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        device: Optional[Union[str, torch.device]] = None,
        quant: Optional[str] = None,
        ssm_dtype: torch.dtype = torch.float32,
        group: int = 128,
    ) -> "Mamba":
        """Random weights from ``seed``, made directly on ``device`` (the card
        unless ``device="cpu"``); with ``quant`` ("int8" | "int4") the big
        projections are quantized as they are drawn."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = mm.init_params(args, dtype, gen, dev, quant, group)
        if quant is not None:
            args.quant = quant
        return cls(args, params, dtype, dev, ssm_dtype)

    def quantize(self, mode: str, group: int = 128) -> "Mamba":
        """Weight-only quantization of ``in_proj`` and ``out_proj`` in place:
        "int8" | "int4" (``quant/weights.py``). Returns self."""
        from mistral_inference_tpu_torch.quant.weights import quantize_params

        self.params = quantize_params(self.params, mode, group)
        self.args.quant = mode
        return self

    def alloc_state(self, batch: int) -> mm.MambaState:
        return mm.MambaState.alloc(self.args, batch, self.dtype, self.device, self.ssm_dtype)

    def forward(
        self,
        tokens: torch.Tensor,  # (B, T)
        seqlens: torch.Tensor,  # (B,)
        state: mm.MambaState,
        chunk: int = mm.DEFAULT_CHUNK,
        head: str = "full",
        write_state: bool = True,
    ) -> torch.Tensor:
        """Prelogits (B, T, vocab_size) fp32, or hidden states with
        ``head="none"``. The state is updated in place unless
        ``write_state=False``: see ``models.mamba.forward``."""
        with torch.inference_mode():
            return mm.forward(
                self.params, tokens.to(self.device), seqlens.to(self.device), state,
                self.args, chunk, head=head, write_state=write_state,
            )
