"""One general generator for every traffic mix: a mix file (``traffic/<name>.json``)
holds only parameters, and this turns them and a seed into requests.

Sizes and gaps are stratified: each block of ``block`` consecutive requests
takes its prompt lengths, output lengths and arrival gaps from the same
``block`` quantiles of their distributions, in an order drawn from the
mix's ``schedule_seed``, as is which requests share a system prompt. The
run's seed draws every token id. So every seed offers the same work at the
same times: with the order drawn per seed, chat-open's ``tpot_p90_ms`` read
about 90 on two seeds and about 115 on three others, run after run, on one
NVIDIA H100 80GB HBM3.

Mix keys:

* ``loop``: "open" (arrivals on a schedule, ``rate_per_s``, Poisson gaps) or
  "closed" (``clients`` that each send their next request when the previous
  one has finished; client c starts at c * ``start_spread_s`` / clients,
  the whole ramp by default).
* ``prompt`` and ``max_tokens``: ``{"median", "sigma", "min", "max"}`` of a
  lognormal, clipped.
* ``shared_prefix`` (optional): ``{"share", "count", "length"}``: that share
  of the requests begins with one of ``count`` system prompts of ``length``
  tokens, drawn once from the seed; the lognormal prompt is the user part.
* ``block``, ``schedule_seed``, ``ramp_s``, ``drain_cap_s``,
  ``sample_requests``, and for a closed loop ``requests_per_client``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import Any, Dict, List, Optional

import numpy as np


@dataclass
class Request:
    index: int
    prompt: List[int]
    max_tokens: int
    gap_s: float = 0.0  # open loop: time after the previous request's arrival
    prefix_id: Optional[int] = None  # the system prompt it begins with, if any


@dataclass
class Traffic:
    loop: str
    requests: List[Request]
    clients: int = 0
    rate_per_s: float = 0.0
    ramp_s: float = 0.0
    start_spread_s: float = 0.0
    drain_cap_s: float = 0.0


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2**63, stream]))


def lognormal_quantiles(d: Dict[str, Any], n: int) -> np.ndarray:
    """The n mid-quantiles (i + 0.5) / n of a clipped lognormal, as ints."""
    nd = NormalDist()
    mu, sigma = math.log(d["median"]), float(d["sigma"])
    q = [math.exp(mu + sigma * nd.inv_cdf((i + 0.5) / n)) for i in range(n)]
    return np.clip(np.rint(q), d["min"], d["max"]).astype(np.int64)


def exponential_quantiles(rate: float, n: int) -> np.ndarray:
    return np.array([-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)])


def make_traffic(mix: Dict[str, Any], seed: int, vocab_size: int, n_requests: int,
                 rate_per_s: Optional[float] = None) -> Traffic:
    """``n_requests`` requests of ``mix`` for ``seed``; ``rate_per_s``
    overrides the mix's open-loop rate (the knee sweep)."""
    loop = mix["loop"]
    if loop not in ("open", "closed"):
        raise ValueError(f"loop must be 'open' or 'closed', got {loop!r}")
    block = int(mix["block"])
    n_blocks = -(-n_requests // block)
    rate = float(rate_per_s if rate_per_s is not None else mix.get("rate_per_s", 0.0))
    order = _rng(int(mix["schedule_seed"]), 1)
    tokens = _rng(seed, 2)
    p_q = lognormal_quantiles(mix["prompt"], block)
    o_q = lognormal_quantiles(mix["max_tokens"], block)
    g_q = exponential_quantiles(rate, block) if loop == "open" else np.zeros(block)
    shared = mix.get("shared_prefix")
    n_shared = int(round(shared["share"] * block)) if shared else 0
    prefixes = []
    if shared:
        prefixes = [tokens.integers(1, vocab_size, shared["length"]).tolist()
                    for _ in range(shared["count"])]
    reqs: List[Request] = []
    for _ in range(n_blocks):
        p, o, g = order.permutation(p_q), order.permutation(o_q), order.permutation(g_q)
        flags = order.permutation(np.arange(block) < n_shared)
        which = order.permutation(np.arange(block) % max(1, len(prefixes)))
        for j in range(block):
            user = tokens.integers(1, vocab_size, int(p[j])).tolist()
            pid = int(which[j]) if flags[j] else None
            prompt = (prefixes[pid] + user) if pid is not None else user
            reqs.append(Request(len(reqs), prompt, int(o[j]), float(g[j]), pid))
    return Traffic(loop, reqs[:n_requests], clients=int(mix.get("clients", 0)),
                   rate_per_s=rate, ramp_s=float(mix["ramp_s"]),
                   start_spread_s=float(mix.get("start_spread_s", mix["ramp_s"])),
                   drain_cap_s=float(mix["drain_cap_s"]))


def requests_needed(mix: Dict[str, Any], seconds: float, rate_per_s: Optional[float] = None) -> int:
    """Enough requests for the ramp, the window and some slack: an open
    loop's arrivals over both, half again; a closed loop's
    ``requests_per_client`` for each client (a run that uses them all up
    fails: the pool is sized well above what a client sends)."""
    span = float(mix["ramp_s"]) + seconds
    if mix["loop"] == "open":
        rate = float(rate_per_s if rate_per_s is not None else mix["rate_per_s"])
        return int(math.ceil(1.5 * rate * span)) + int(mix["block"])
    return int(mix["clients"]) * int(mix["requests_per_client"]) + int(mix["block"])

