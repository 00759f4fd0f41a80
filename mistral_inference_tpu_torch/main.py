"""CLI: interactive chat, a batch demo and the quantized export
(counterpart of ``mistral_inference_tpu/main.py``, with its parser and
defaults).

    python -m mistral_inference_tpu_torch.main chat <model_path> [--max_tokens N] ...
    python -m mistral_inference_tpu_torch.main demo <model_path> [...]
    python -m mistral_inference_tpu_torch.main quantize <model_path> <out_path> [...]

Installed, the same commands are the console scripts ``mistral-chat-torch``,
``mistral-demo-torch`` and ``mistral-quantize-torch``. Everything runs on the card unless ``--device cpu`` asks for the CPU (the
kernels' plain versions; for tests). ``--quant int8|int4``, ``--kv_quant fp8|int8``,
``--ssm_state bf16``, ``--draft_path <folder> | lookup`` and ``--lora_path
<adapter.safetensors>`` work as in the JAX package: an adapter merges into
the dense weights before any quantization (or fills the live pairs of a
folder whose ``params.json`` has ``lora``). ``quantize`` takes
``--lora_path`` too, and exports the merged model.

Over N GPUs, one process each, started by ``torchrun``:

    torchrun --nproc-per-node N -m mistral_inference_tpu_torch.main demo <model_path> --tensor N

``--tensor N`` shards the model over N ranks and ``--seq S`` splits each
prefill chunk's tokens over S (a transformer only; a Mamba raises with the
JAX package's message): the run needs ``WORLD_SIZE`` = N S, the mesh
``make_mesh(tensor=N, seq=S)``. ``--tensor auto`` factorizes the world into
(data, expert, tensor) as the JAX package does, data at most ``gcd(data,
--max_batch_size)`` (ranks left over sit idle), and a world of one stays
one device. Only the primary rank prints; in ``chat`` it reads the prompts
and sends them to the others.
"""

from __future__ import annotations

import argparse
import logging
import math
import sys
from typing import List, Optional

import torch

from mistral_inference_tpu_torch.generate import generate, generate_mamba
from mistral_inference_tpu_torch.args import load_args
from mistral_inference_tpu_torch.model import Mamba, Transformer, _requantize, get_model_cls
from mistral_inference_tpu_torch.parallel import distributed
from mistral_inference_tpu_torch.parallel.mesh import auto_factorize, make_mesh
from mistral_inference_tpu_torch.parallel.sharding import MAMBA_SEQ
from mistral_inference_tpu_torch.tokenizers import (
    ChatRequest,
    Message,
    encode_chat,
    load_tokenizer,
)


def _make_mesh(args, cls):
    """The mesh of ``--tensor`` and ``--seq`` over the ``torchrun`` world, or
    None for one device. Every rank joins the process group and makes the
    mesh; a rank the mesh leaves out gets None too and sits the run out."""
    seq = int(getattr(args, "seq", 1))
    world = distributed.world_size()
    if args.tensor == "auto":
        if world == 1:
            return None
        margs = load_args(args.model_path)
        # TP shards KV heads (a transformer) or SSD groups (a Mamba).
        n_kv = margs.n_groups if cls is Mamba else margs.n_kv_heads
        n_exp = margs.moe.num_experts if getattr(margs, "moe", None) else 0
        data, expert, tensor = auto_factorize(world, n_kv_heads=n_kv, n_experts=n_exp)
        # data shards the batch: at most a divisor of max_batch_size
        data = math.gcd(data, args.max_batch_size)
        seq = 1
    else:
        if seq > 1 and cls is Mamba:
            raise ValueError(MAMBA_SEQ)
        data, expert, tensor = 1, 1, int(args.tensor)
        if world != tensor * seq:
            what = " x ".join(f"--{k} {v}" for k, v in (("tensor", tensor), ("seq", seq))
                              if v > 1) or "--tensor 1"
            raise ValueError(f"{what} needs {tensor * seq} ranks, found {world}: start them "
                             f"with torchrun --nproc-per-node {tensor * seq}")
        if tensor * seq == 1:
            return None
    distributed.init_distributed(device=args.device)
    return make_mesh(data, expert, tensor, seq=seq, device=distributed.rank_device(args.device))


def _with_lora(cls, args, **kw):
    """``cls.from_folder`` with ``--quant``, and with ``--lora_path`` the
    adapter merged into the dense weights (or loaded into live pairs)
    before the quantization, as the JAX package does it."""
    if not args.lora_path:
        return cls.from_folder(args.model_path, quant=args.quant, **kw)
    from mistral_inference_tpu_torch.lora import load_lora

    model = cls.from_folder(args.model_path, **kw)
    load_lora(model, args.lora_path)
    _requantize(model, args.quant)
    return model


def _load(args):
    """The model of ``args`` (under a mesh, this rank's shard), or None on a
    rank the mesh leaves out."""
    cls = get_model_cls(args.model_path)
    mesh = _make_mesh(args, cls)
    if mesh is None and distributed.world_size() > 1:
        return None
    kw = dict(max_batch_size=args.max_batch_size, dtype=torch.bfloat16, device=args.device,
              mesh=mesh)
    if cls is Transformer:
        kw["kv_quant"] = args.kv_quant
    else:
        if args.kv_quant:
            raise ValueError("--kv_quant quantizes the transformer KV cache; Mamba has none "
                             "(its state lever is --ssm_state bf16)")
        if args.ssm_state == "bf16":
            kw["ssm_dtype"] = torch.bfloat16
    # A pre-quantized export is never re-quantized; another mode raises.
    model = _with_lora(cls, args, **kw)
    if args.draft_path:
        if args.draft_path in ("lookup", "ngram"):  # draft-free n-gram mode
            model._draft = args.draft_path
        else:
            if cls is not Transformer:
                raise ValueError("draft-model speculation needs a Transformer target; mamba "
                                 "supports --draft_path lookup (n-gram) only")
            model._draft = Transformer.from_folder(
                args.draft_path, max_batch_size=args.max_batch_size, dtype=torch.bfloat16,
                device=args.device, mesh=mesh)
    return model


def _shared(model, value):
    """``value`` from the primary rank on every rank of ``model``'s mesh
    (as is, without one): what the primary read from the terminal."""
    mesh = getattr(model, "mesh", None)
    return value if mesh is None else mesh.broadcast_object(value)


def _generate(model, prompts: List[List[int]], args, eos_id: Optional[int], images=()):
    if isinstance(model, Mamba):
        if any(images):
            raise ValueError("mamba models are text-only")
        return generate_mamba(
            prompts, model, max_tokens=args.max_tokens, temperature=args.temperature,
            eos_id=eos_id, draft_model=getattr(model, "_draft", None),
            spec_tokens=args.spec_tokens,
        )
    return generate(
        prompts, model, images=images, max_tokens=args.max_tokens,
        temperature=args.temperature, eos_id=eos_id,
        draft_model=getattr(model, "_draft", None), spec_tokens=args.spec_tokens,
    )


def _get_multimodal_input():
    """Text and zero or more image paths -> a content chunk list."""
    chunks: List = []
    text = input("Text prompt: ")
    if text:
        chunks.append(text)
    print("[You can input zero, one or more images now.]")
    while True:
        path = input("Image path [empty to finish image input]: ")
        if not path:
            break
        from mistral_inference_tpu_torch.images import decode_image_payload

        chunks.append(decode_image_payload(path))
    return chunks


def _read_turn(tok, model, args, messages: List[Message], is_multimodal: bool):
    """The next user turn from the terminal as (ids, images), the message
    appended to ``messages``; None at the input's end."""
    while True:
        try:
            if is_multimodal and args.instruct:
                chunks = _get_multimodal_input()
                if not chunks:
                    continue
                messages.append(Message("user", chunks))
                from mistral_inference_tpu_torch.tokenizers.chat import encode_chat_multimodal

                return encode_chat_multimodal(
                    tok, ChatRequest(messages=messages), model.args.vision_encoder)
            user = input("Prompt: ")
            if args.instruct:
                messages.append(Message("user", user))
                return encode_chat(tok, ChatRequest(messages=messages)), []
            return tok.encode(user, bos=True, eos=False), []
        except EOFError:
            return None


def interactive(args) -> None:
    """Multi-turn chat REPL; under a mesh the primary rank reads and prints."""
    tok = load_tokenizer(args.model_path)
    model = _load(args)
    if model is None:
        return
    primary = distributed.is_primary()
    messages: List[Message] = []
    if args.system_prompt:
        messages.append(Message("system", args.system_prompt))

    is_multimodal = isinstance(model, Transformer) and model.args.vision_encoder is not None
    if primary:
        print("Interactive chat. Ctrl-D to exit.")
    while True:
        turn = _read_turn(tok, model, args, messages, is_multimodal) if primary else None
        turn = _shared(model, turn)
        if turn is None:
            break
        ids, images = turn
        generated, _ = _generate(model, [ids], args, eos_id=tok.eos_id,
                                 images=[images] if images else ())
        answer = tok.decode(generated[0])
        if primary:
            print(answer)
            print("=" * 40)
        if args.instruct:
            messages.append(Message("assistant", answer))


DEMO_PROMPTS = (
    "This is a test",
    "This is another great test",
    "This is a third test, mistral AI is very good at testing. ",
)


def demo(args) -> None:
    """Batch demo over three fixed prompts."""
    tok = load_tokenizer(args.model_path)
    model = _load(args)
    if model is None:
        return
    encoded = [tok.encode(p, bos=True, eos=False) for p in DEMO_PROMPTS]
    generated, logprobs = _generate(model, encoded, args, eos_id=None)
    if not distributed.is_primary():
        return
    for p, g, lp in zip(DEMO_PROMPTS, generated, logprobs):
        print(p + tok.decode(g))
        logging.debug("logprobs: %s", lp)
        print("=" * 40)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="mistral_inference_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name, fn in (("chat", interactive), ("demo", demo)):
        sp = sub.add_parser(name)
        sp.add_argument("model_path")
        sp.add_argument("--max_tokens", type=int, default=35 if name == "demo" else 256)
        sp.add_argument("--temperature", type=float, default=0.0 if name == "demo" else 0.7)
        sp.add_argument("--max_batch_size", type=int, default=3)
        sp.add_argument("--lora_path", default=None,
                        help="LoRA adapter safetensors, merged before any --quant")
        sp.add_argument("--quant", choices=["int8", "int4"], default=None)
        sp.add_argument("--kv_quant", choices=["fp8", "int8"], default=None)
        sp.add_argument(
            "--ssm_state", choices=["fp32", "bf16"], default="fp32",
            help="Mamba stored SSD-state dtype; bf16 halves per-slot memory and state traffic",
        )
        sp.add_argument(
            "--draft_path", default=None,
            help="same-vocab draft model folder, or 'lookup': enables speculative decoding",
        )
        sp.add_argument("--spec_tokens", type=int, default=4)
        sp.add_argument("--tensor", default="1",
                        help="tensor-parallel degree N over N torchrun ranks, or 'auto' to "
                             "factorize the ranks into data x expert x tensor")
        sp.add_argument("--seq", type=int, default=1,
                        help="sequence-parallel degree: prefill chunks split over S ranks "
                             "(transformers only)")
        sp.add_argument("--system_prompt", default=None)
        sp.add_argument("--device", default=None, help="'cpu' to run off the card")
        sp.add_argument("--no-instruct", dest="instruct", action="store_false")
        sp.set_defaults(func=fn, instruct=True)

    qp = sub.add_parser(
        "quantize",
        help="export a quantized stacked checkpoint (quantize once, serve many)",
    )
    qp.add_argument("model_path")
    qp.add_argument("out_path")
    qp.add_argument("--quant", choices=["int8", "int4"], default="int4")
    qp.add_argument("--group", type=int, default=128)
    qp.add_argument("--kv_quant", choices=["fp8", "int8"], default=None)
    qp.add_argument("--lora_path", default=None,
                    help="LoRA adapter safetensors, merged before quantizing")
    qp.add_argument("--device", default=None, help="'cpu' to run off the card")
    qp.set_defaults(func=quantize_export)
    return p


def quantize_export(args) -> None:
    from mistral_inference_tpu_torch.loading import save_stacked

    cls = get_model_cls(args.model_path)
    kw = dict(dtype=torch.bfloat16, device=args.device)
    if args.kv_quant:
        if cls is not Transformer:
            raise ValueError("--kv_quant quantizes the transformer KV cache; Mamba has none")
        kw["kv_quant"] = args.kv_quant
    model = cls.from_folder(args.model_path, **kw)
    if args.lora_path:
        from mistral_inference_tpu_torch.lora import load_lora

        load_lora(model, args.lora_path)
    model.quantize(args.quant, group=args.group)
    save_stacked(args.out_path, model, tokenizer_from=args.model_path)
    print(f"wrote {args.quant} stacked checkpoint to {args.out_path}")


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    try:
        args.func(args)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def mistral_chat() -> None:
    """Console script ``mistral-chat-torch <model_path> [...]``."""
    main(["chat"] + sys.argv[1:])


def mistral_demo() -> None:
    """Console script ``mistral-demo-torch <model_path> [...]``."""
    main(["demo"] + sys.argv[1:])


def mistral_quantize() -> None:
    """Console script ``mistral-quantize-torch <model_path> <out_path> [...]``."""
    main(["quantize"] + sys.argv[1:])


if __name__ == "__main__":
    main()
