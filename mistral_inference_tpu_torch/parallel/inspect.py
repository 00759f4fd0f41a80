"""What a sharded forward costs in collectives (counterpart of
``mistral_inference_tpu/parallel/inspect.py``).

The JAX package compiles its decode program under a mesh and counts the
collectives in the optimized HLO. The port issues every collective itself,
through ``Mesh.all_reduce`` and ``Mesh.all_gather``, which count what they
issue; so the inventory here is a count taken while one decode forward (or
one prefill chunk) runs. There is no HLO to parse.
"""

from __future__ import annotations

from typing import Dict

import torch


def decode_collective_inventory(model, batch: int = 4, prompt_len: int = 8) -> Dict[str, int]:
    """The collectives, by kind ("all_reduce", "all_gather"), that one T = 1
    forward of ``model`` (a ``Transformer`` or ``Mamba`` with a mesh) issues
    on this rank, after a prefill of ``prompt_len`` tokens. Every rank of the
    mesh must call it."""
    mesh = model.mesh
    if mesh is None:
        raise ValueError("the model has no mesh")
    dev = model.device
    gen = torch.Generator().manual_seed(0)
    prompt = torch.randint(0, model.args.vocab_size, (batch, prompt_len), generator=gen).to(dev)
    lens = torch.full((batch,), prompt_len, dtype=torch.int32, device=dev)
    ones = torch.ones((batch,), dtype=torch.int32, device=dev)
    if hasattr(model, "alloc_state"):
        state = model.alloc_state(batch)
        model.forward(prompt, lens, state)
        mesh.reset_counts()
        model.forward(prompt[:, :1], ones, state, chunk=1)
    else:
        cache = model.alloc_cache(batch, prompt_len + 1)
        model.forward(prompt, lens, cache, attend_cache=False)
        mesh.reset_counts()
        model.forward(prompt[:, :1], ones, cache)
    counts = {"all_reduce": 0, "all_gather": 0, **mesh.counts}
    mesh.reset_counts()
    return counts


def prefill_collective_inventory(model, batch: int = 2, chunk: int = 8) -> Dict[str, int]:
    """The collectives, by kind, that one first prefill chunk of ``chunk``
    tokens (``head="none"``, as ``generate`` runs it) issues on this rank
    of a ``Transformer`` with a mesh: under ``seq`` the chunk's K/V and
    hidden-state gathers. Every rank of the mesh must call it."""
    mesh = model.mesh
    if mesh is None:
        raise ValueError("the model has no mesh")
    dev = model.device
    gen = torch.Generator().manual_seed(0)
    prompt = torch.randint(0, model.args.vocab_size, (batch, chunk), generator=gen).to(dev)
    lens = torch.full((batch,), chunk, dtype=torch.int32, device=dev)
    cache = model.alloc_cache(batch, chunk)
    mesh.reset_counts()
    model.forward(prompt, lens, cache, attend_cache=False, head="none")
    counts = {"all_reduce": 0, "all_gather": 0, **mesh.counts}
    mesh.reset_counts()
    return counts
