"""Host handles around the forwards: ``Transformer`` (dense or sparse-MoE)
and ``Mamba`` (Mamba2), with bf16 or weight-only quantized linears, and
``from_folder``, which loads either from a checkpoint folder (counterpart of
``mistral_inference_tpu/model.py``).

With ``mesh`` (``parallel/mesh.py``) a model holds this rank's shard
(``parallel/sharding.py``) on the rank's device, its caches and states hold
the rank's heads and rows, and ``forward`` takes and returns the global
batch on every rank: the rows are split over ``data`` and gathered back."""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Optional, Union

import torch

from mistral_inference_tpu_torch.args import MambaArgs, TransformerArgs, load_args
from mistral_inference_tpu_torch.cache import KVCache
from mistral_inference_tpu_torch.models import mamba as mm
from mistral_inference_tpu_torch.models import transformer as tf
from mistral_inference_tpu_torch.parallel import multihost, sharding
from mistral_inference_tpu_torch.parallel.mesh import Mesh
from mistral_inference_tpu_torch.utils import profiling
from mistral_inference_tpu_torch.utils.profiling import METRICS, Span

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


def _mesh_device(device, mesh: Optional[Mesh]) -> torch.device:
    """The model's device: the rank's under a mesh (``device``, if given,
    must name it), else ``resolve_device``."""
    if mesh is None:
        return resolve_device(device)
    if device is not None:
        d = torch.device(device)
        if d.type != mesh.device.type or d.index not in (None, mesh.device.index):
            raise ValueError(f"device {device} is not this rank's device {mesh.device}")
    return mesh.device


def _mesh_forward(model, tokens, seqlens, state, b, extra, run):
    """``run(tokens, seqlens, local state, extra)`` on this rank's rows of
    the global batch under data parallelism (``b`` rows from ``state.row0``);
    the output's rows gathered back to the global batch (a tuple's first
    element; the rest, per-rank chunk K/V, stay local)."""
    B = tokens.shape[0]
    take = functools.partial(multihost.local_rows, row0=state.row0, b=b)
    out = run(take(tokens), take(seqlens), state.local(),
              None if extra is None else take(extra))
    if isinstance(out, tuple):
        return (multihost.fetch(out[0], model.mesh, B), *out[1:])
    return multihost.fetch(out, model.mesh, B)


def _forward_span(tokens: torch.Tensor, seqlens: torch.Tensor) -> Span:
    """A forward's call-tier span ``model.forward``: kind (decode for T = 1,
    else prefill), rows, T and the real tokens (``METRICS.real_tokens``)."""
    B, T = tokens.shape
    return METRICS.span("model.forward", kind="decode" if T == 1 else "prefill", rows=B, T=T,
                        real=METRICS.real_tokens(seqlens))


class Transformer:
    """Args, parameters (a dict of tensors on one device: under a mesh, this
    rank's shard) and the dtype."""

    def __init__(
        self,
        args: TransformerArgs,
        params: tf.Params,
        dtype: torch.dtype = torch.bfloat16,
        device: Optional[Union[str, torch.device]] = None,
        mesh: Optional[Mesh] = None,
    ):
        self.args = args
        self.dtype = dtype
        self.mesh = mesh
        self.device = _mesh_device(device, mesh)
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
        mesh: Optional[Mesh] = None,
    ) -> "Transformer":
        """Random weights from ``seed``, made directly on ``device`` (the card
        unless ``device="cpu"``). With ``quant`` ("int8" | "int4") every big
        linear is quantized as it is drawn: the same model as
        ``random(...).quantize(quant)``, without ever holding its dense form,
        which for Mixtral-8x7B exceeds the card. With ``mesh`` every rank
        draws the whole model layer by layer and keeps its shard: the shard
        of the single-device model of the same seed."""
        dev = _mesh_device(device, mesh)
        keep = None
        if mesh is not None:
            sharding.check_transformer(args, mesh, quant, group)
            keep = functools.partial(sharding.shard_layer, args=args, mesh=mesh)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = tf.init_params(args, dtype, gen, dev, quant, group, keep=keep)
        if mesh is not None:
            params["output"] = sharding.shard_vocab(params["output"], mesh.t, mesh.tensor)
        if quant is not None:
            args.quant = quant
        return cls(args, params, dtype, dev, mesh)

    @classmethod
    def from_folder(
        cls,
        folder: Union[str, Path],
        max_batch_size: int = 1,
        dtype: torch.dtype = torch.bfloat16,
        quant: Optional[str] = None,
        kv_quant: Optional[str] = None,
        device: Optional[Union[str, torch.device]] = None,
        mesh: Optional[Mesh] = None,
    ) -> "Transformer":
        """Load ``params.json`` and the weights of a reference folder or a
        stacked export (``loading.py``), on the card unless ``device="cpu"``.
        ``kv_quant`` sets the ring's element type; ``quant`` quantizes the
        weights after loading. A pre-quantized export is never re-quantized:
        ``quant`` equal to its mode is a no-op, another mode raises. With
        ``mesh`` each rank puts only its shard on its device."""
        from mistral_inference_tpu_torch.loading import load_transformer_params

        args = load_args(folder)
        if not isinstance(args, TransformerArgs):
            raise ValueError(f"{folder} holds a {type(args).__name__} checkpoint")
        args.max_batch_size = max_batch_size
        if kv_quant is not None:
            args.kv_quant = kv_quant
        dev = _mesh_device(device, mesh)
        params = load_transformer_params(folder, args, dtype, dev, mesh=mesh)
        model = cls(args, params, dtype, dev, mesh)
        _requantize(model, quant)
        return model

    def quantize(self, mode: str, group: int = 128) -> "Transformer":
        """Weight-only quantization in place: "int8" | "int4"
        (``quant/weights.py``). Returns self for chaining. Under a mesh the
        shard is quantized: its groups align with its rows, so the bytes are
        those of the shard of the quantized full model."""
        from mistral_inference_tpu_torch.quant.weights import quantize_params

        if self.mesh is not None:
            sharding.check_transformer(self.args, self.mesh, mode, group)
        self.params = quantize_params(self.params, mode, group)
        if self.mesh is not None:
            for lw in self.params["layers"]:
                sharding.mark_whole_n(lw, self.mesh.tensor)
        self.args.quant = mode
        return self

    def alloc_cache(self, batch: int, max_seq_len: int) -> KVCache:
        """A ring for ``batch`` rows; under a mesh it holds this rank's KV
        heads and, under ``data``, its rows of the batch."""
        if max_seq_len > MAX_SEQ_LEN:
            raise ValueError(f"max_seq_len {max_seq_len} exceeds {MAX_SEQ_LEN}")
        tp = 1 if self.mesh is None else self.mesh.tensor
        return KVCache.alloc(
            n_layers=self.args.n_layers,
            batch=batch,
            max_seq_len=max_seq_len,
            n_kv_heads=self.args.n_kv_heads // tp,
            head_dim=self.args.head_dim,
            sliding_window=self.args.sliding_window,
            dtype=self.dtype,
            kv_quant=self.args.kv_quant,
            device=self.device,
            ring_rows=multihost.rows_per_rank(batch, self.mesh),
            row0=multihost.first_row(batch, self.mesh),
        )

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """Final-norm hidden states (..., dim) -> fp32 prelogits (..., V):
        the same on every rank."""
        return tf.output_head(self.params, h, self.mesh)

    def forward(
        self,
        tokens: torch.Tensor,  # (B, T)
        seqlens: torch.Tensor,  # (B,)
        cache: KVCache,
        attend_cache: bool = True,
        head: str = "full",
        write_cache: Union[bool, str] = True,
        input_embeds: Optional[torch.Tensor] = None,
        router_rows: Optional[int] = None,
    ):
        """Prelogits (B, T, V) fp32, or hidden states with ``head="none"``.
        The cache is updated in place. ``write_cache`` (False | "spec") is
        speculative decoding's verify pass, ``input_embeds`` (B, T, dim)
        replaces the token embeddings, and ``router_rows`` is the row count
        the MoE router's product runs at: see ``models.transformer.forward``."""
        tokens, seqlens = tokens.to(self.device), seqlens.to(self.device)
        if input_embeds is not None:
            input_embeds = input_embeds.to(self.device)

        def run(tok, lens, c, embeds):
            return tf.forward(self.params, tok, lens, c, self.args, attend_cache, head=head,
                              write_cache=write_cache, input_embeds=embeds, mesh=self.mesh,
                              batch=tokens.shape[0], router_rows=router_rows)

        with torch.inference_mode(), (_forward_span(tokens, seqlens) if profiling.TRACING
                                      else profiling.NULL):
            if cache.row0 is None:
                return run(tokens, seqlens, cache, input_embeds)
            out = _mesh_forward(self, tokens, seqlens, cache, cache.k.shape[1], input_embeds,
                                run)
            if write_cache is True:
                cache.kv_len = cache.kv_len + seqlens.to(torch.int32)
            return out


class Mamba:
    """Args, parameters (a dict of tensors on one device: under a mesh, this
    rank's shard), the dtype and the SSD state's dtype."""

    def __init__(
        self,
        args: MambaArgs,
        params: mm.Params,
        dtype: torch.dtype = torch.bfloat16,
        device: Optional[Union[str, torch.device]] = None,
        ssm_dtype: torch.dtype = torch.float32,
        mesh: Optional[Mesh] = None,
    ):
        self.args = args
        self.dtype = dtype
        self.ssm_dtype = ssm_dtype
        self.mesh = mesh
        self.device = _mesh_device(device, mesh)
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
        mesh: Optional[Mesh] = None,
    ) -> "Mamba":
        """Random weights from ``seed``, made directly on ``device`` (the card
        unless ``device="cpu"``); with ``quant`` ("int8" | "int4") the big
        projections are quantized as they are drawn. With ``mesh``, the
        rank's shard of each layer as it is drawn."""
        dev = _mesh_device(device, mesh)
        keep = None
        if mesh is not None:
            sharding.check_mamba(args, mesh, quant, group)
            keep = functools.partial(sharding.shard_mamba_layer, args=args, mesh=mesh)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = mm.init_params(args, dtype, gen, dev, quant, group, keep=keep)
        if mesh is not None and "lm_head" in params:
            params["lm_head"] = sharding.shard_vocab(params["lm_head"], mesh.t, mesh.tensor)
        if quant is not None:
            args.quant = quant
        return cls(args, params, dtype, dev, ssm_dtype, mesh)

    @classmethod
    def from_folder(
        cls,
        folder: Union[str, Path],
        max_batch_size: int = 1,
        dtype: torch.dtype = torch.bfloat16,
        quant: Optional[str] = None,
        ssm_dtype: torch.dtype = torch.float32,
        device: Optional[Union[str, torch.device]] = None,
        mesh: Optional[Mesh] = None,
    ) -> "Mamba":
        """Load a mamba_ssm folder or a stacked export (``loading.py``), on
        the card unless ``device="cpu"``; ``quant`` and ``mesh`` as in
        ``Transformer.from_folder``."""
        from mistral_inference_tpu_torch.loading import load_mamba_params

        del max_batch_size  # the state is allocated per call
        args = load_args(folder)
        if not isinstance(args, MambaArgs):
            raise ValueError(f"{folder} holds a {type(args).__name__} checkpoint")
        dev = _mesh_device(device, mesh)
        params = load_mamba_params(folder, args, dtype, dev, mesh=mesh)
        model = cls(args, params, dtype, dev, ssm_dtype, mesh)
        _requantize(model, quant)
        return model

    def quantize(self, mode: str, group: int = 128) -> "Mamba":
        """Weight-only quantization of ``in_proj`` and ``out_proj`` in place:
        "int8" | "int4" (``quant/weights.py``). Returns self. Under a mesh,
        the shard, as ``Transformer.quantize``."""
        from mistral_inference_tpu_torch.quant.weights import quantize_params

        if self.mesh is not None:
            sharding.check_mamba(self.args, self.mesh, mode, group)
        self.params = quantize_params(self.params, mode, group)
        if self.mesh is not None:
            for lw in self.params["layers"]:
                sharding.mark_whole_n(lw, self.mesh.tensor)
        self.args.quant = mode
        return self

    def alloc_state(self, batch: int) -> mm.MambaState:
        """A state for ``batch`` rows; under a mesh, this rank's heads and,
        under ``data``, its rows."""
        return mm.MambaState.alloc(
            self.args, batch, self.dtype, self.device, self.ssm_dtype,
            tensor=1 if self.mesh is None else self.mesh.tensor,
            state_rows=multihost.rows_per_rank(batch, self.mesh),
            row0=multihost.first_row(batch, self.mesh),
        )

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """Final-norm hidden states -> fp32 prelogits (..., vocab_size)."""
        return mm.apply_head(h, self.params, self.args, self.mesh)

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
        tokens, seqlens = tokens.to(self.device), seqlens.to(self.device)

        def run(tok, lens, st, _):
            return mm.forward(self.params, tok, lens, st, self.args, chunk, head=head,
                              write_state=write_state, mesh=self.mesh, batch=tokens.shape[0])

        with torch.inference_mode(), (_forward_span(tokens, seqlens) if profiling.TRACING
                                      else profiling.NULL):
            if state.row0 is None:
                return run(tokens, seqlens, state, None)
            out = _mesh_forward(self, tokens, seqlens, state, state.conv.shape[1], None, run)
            if write_state:
                state.seen = state.seen + seqlens.to(torch.int32)
            return out


def _requantize(model: Union[Transformer, Mamba], quant: Optional[str]) -> None:
    """Quantize a freshly loaded model to ``quant`` unless it already is;
    an export quantized to another mode raises."""
    if quant is None or quant == model.args.quant:
        return
    if model.args.quant != "bf16":
        raise ValueError(f"the checkpoint is already {model.args.quant}-quantized; "
                         f"cannot re-quantize to {quant}")
    model.quantize(quant)


def get_model_cls(folder: Union[str, Path]):
    """``Mamba`` or ``Transformer``, by ``params.json``'s ``model_type``."""
    return Mamba if isinstance(load_args(folder), MambaArgs) else Transformer


def from_folder(folder: Union[str, Path], **kw) -> Union[Transformer, Mamba]:
    return get_model_cls(folder).from_folder(folder, **kw)
