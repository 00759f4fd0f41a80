"""The system under test for a Mistral-family configuration: the port's
``Transformer`` on the benchmark's weights, behind its serving ``Engine``.

Each layer is drawn (``weights.layer``) and handed to the port's
``quantize_params``, which quantizes it as it arrives; the dense form of the
layer is then dropped. The engine's settings come from the configuration
file's ``serve`` entry."""

from __future__ import annotations

from typing import Any, Dict

import torch

from perfbench import weights as W


def build(config: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """{"model", "engine", "dims"} for ``config`` with weights from ``seed``."""
    from mistral_inference_tpu_torch.args import MoeArgs, TransformerArgs
    from mistral_inference_tpu_torch.model import Transformer
    from mistral_inference_tpu_torch.quant.weights import quantize_params
    from mistral_inference_tpu_torch.server.engine import Engine

    d = W.dims(config)
    a = config["assumed"]
    mode = a["weights"]
    args = TransformerArgs(
        dim=d.dim, n_layers=d.n_layers, head_dim=d.head_dim, hidden_dim=d.hidden,
        n_heads=d.n_heads, n_kv_heads=d.n_kv_heads, norm_eps=d.norm_eps, vocab_size=d.vocab,
        rope_theta=d.rope_theta, sliding_window=d.window, kv_quant=d.kv_quant,
        moe=MoeArgs(d.experts, d.top_k) if d.experts else None,
        moe_impl=a.get("moe_impl", "dense"),
        moe_capacity_factor=float(a.get("moe_capacity_factor", 2.0)),
    )
    layers = []
    for li in range(d.n_layers):
        lw = W.layer(d, seed, li, device)
        layers.append(quantize_params({"layers": [lw]}, mode, d.group)["layers"][0])
    params = {
        "tok_embeddings": W.embeddings(d, seed, device),
        "layers": layers,
        "norm": torch.ones((d.dim,), dtype=d.dtype, device=device),
        "output": W.head(d, seed, device),
    }
    args.quant = mode
    model = Transformer(args, params, d.dtype, device)
    engine = Engine(model, **config["serve"])
    return {"model": model, "engine": engine, "dims": d, "span": engine.max_seq_len}


def warm_up(system: Dict[str, Any], seed: int) -> None:
    """Run every shape the traffic will use once, through the same engine:
    a staged sweep of two chunks, a full sweep with a prefix copy, a full
    sweep of more rows than staging takes, and decode blocks of each width.
    The prompts come from a stream of their own and share no prefix with the
    traffic, so their rows give it no hits."""
    import numpy as np

    engine, d = system["engine"], system["dims"]
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) % 2**63, 3]))
    chunk = engine.admit_chunk
    first = rng.integers(1, d.vocab, chunk + chunk // 2).tolist()
    engine.submit(first, max_tokens=9)
    engine.run_to_completion()
    engine.submit(first[: chunk // 2] + rng.integers(1, d.vocab, chunk).tolist(), max_tokens=9)
    engine.run_to_completion()
    for _ in range(engine._staging_B + 1):
        engine.submit(rng.integers(1, d.vocab, chunk // 4).tolist(), max_tokens=9)
    engine.run_to_completion()
