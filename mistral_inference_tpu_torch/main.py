"""CLI: interactive chat, a batch demo and the quantized export
(counterpart of ``mistral_inference_tpu/main.py``, with its parser and
defaults).

    python -m mistral_inference_tpu_torch.main chat <model_path> [--max_tokens N] ...
    python -m mistral_inference_tpu_torch.main demo <model_path> [...]
    python -m mistral_inference_tpu_torch.main quantize <model_path> <out_path> [...]

Everything runs on the card unless ``--device cpu`` asks for the CPU (the
kernels' plain versions; for tests). ``--quant int8|int4``, ``--kv_quant fp8|int8``,
``--ssm_state bf16`` and ``--draft_path <folder> | lookup`` work as in the
JAX package; ``--tensor`` takes 1 or ``auto`` (one device). Meshes
(``--tensor`` > 1, ``--seq`` > 1) and ``--lora_path`` are not ported yet and
raise.
"""

from __future__ import annotations

import argparse
import logging
from typing import List, Optional

import torch

from mistral_inference_tpu_torch.generate import generate, generate_mamba
from mistral_inference_tpu_torch.model import Mamba, Transformer, get_model_cls
from mistral_inference_tpu_torch.tokenizers import (
    ChatRequest,
    Message,
    encode_chat,
    load_tokenizer,
)


def _check_unported(args) -> None:
    if args.tensor != "auto" and int(args.tensor) > 1 or int(getattr(args, "seq", 1)) > 1:
        raise NotImplementedError("meshes (--tensor > 1, --seq > 1) are not ported yet "
                                  "(ROADMAP.md Queue 1 item 6)")
    if args.lora_path:
        raise NotImplementedError("LoRA adapters (--lora_path) are not ported yet "
                                  "(ROADMAP.md Queue 1 item 4)")


def _load(args):
    _check_unported(args)
    cls = get_model_cls(args.model_path)
    kw = dict(max_batch_size=args.max_batch_size, dtype=torch.bfloat16, device=args.device)
    if cls is Transformer:
        kw["kv_quant"] = args.kv_quant
    else:
        if args.kv_quant:
            raise ValueError("--kv_quant quantizes the transformer KV cache; Mamba has none "
                             "(its state lever is --ssm_state bf16)")
        if args.ssm_state == "bf16":
            kw["ssm_dtype"] = torch.bfloat16
    # A pre-quantized export is never re-quantized; another mode raises.
    model = cls.from_folder(args.model_path, quant=args.quant, **kw)
    if args.draft_path:
        if args.draft_path in ("lookup", "ngram"):  # draft-free n-gram mode
            model._draft = args.draft_path
        else:
            if cls is not Transformer:
                raise ValueError("draft-model speculation needs a Transformer target; mamba "
                                 "supports --draft_path lookup (n-gram) only")
            model._draft = Transformer.from_folder(
                args.draft_path, max_batch_size=args.max_batch_size, dtype=torch.bfloat16,
                device=args.device)
    return model


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


def interactive(args) -> None:
    """Multi-turn chat REPL."""
    tok = load_tokenizer(args.model_path)
    model = _load(args)
    messages: List[Message] = []
    if args.system_prompt:
        messages.append(Message("system", args.system_prompt))

    is_multimodal = isinstance(model, Transformer) and model.args.vision_encoder is not None
    print("Interactive chat. Ctrl-D to exit.")
    while True:
        images: List = []
        try:
            if is_multimodal and args.instruct:
                chunks = _get_multimodal_input()
                if not chunks:
                    continue
                messages.append(Message("user", chunks))
                from mistral_inference_tpu_torch.tokenizers.chat import encode_chat_multimodal

                ids, images = encode_chat_multimodal(
                    tok, ChatRequest(messages=messages), model.args.vision_encoder)
            else:
                user = input("Prompt: ")
                if args.instruct:
                    messages.append(Message("user", user))
                    ids = encode_chat(tok, ChatRequest(messages=messages))
                else:
                    ids = tok.encode(user, bos=True, eos=False)
        except EOFError:
            break
        generated, _ = _generate(model, [ids], args, eos_id=tok.eos_id,
                                 images=[images] if images else ())
        answer = tok.decode(generated[0])
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
    encoded = [tok.encode(p, bos=True, eos=False) for p in DEMO_PROMPTS]
    generated, logprobs = _generate(model, encoded, args, eos_id=None)
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
        sp.add_argument("--lora_path", default=None, help="not ported yet: raises")
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
                        help="1 or 'auto' (one device); larger meshes are not ported yet")
        sp.add_argument("--seq", type=int, default=1,
                        help="sequence-parallel degree; only 1 is ported yet")
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
    model.quantize(args.quant, group=args.group)
    save_stacked(args.out_path, model, tokenizer_from=args.model_path)
    print(f"wrote {args.quant} stacked checkpoint to {args.out_path}")


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
