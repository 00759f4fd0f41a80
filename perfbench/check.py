"""The comparison that decides ``correct``: served tokens against the plain
reference.

Once the window has closed and the program's state is freed, a sample of
the requests the engine finished is drawn from the seed, the longest of
them always in it. The reference runs once over each prompt followed by its
served tokens and gives the logits at every position that chose a served
token. Each served token's gap is the amount by which its logit lies below
the reference's best at its position (greedy tokens: 0 where the program
chose the reference's argmax). The run reports the widest, the mean and
the median gap over all the sample's served tokens, their quantiles, and
``share_gap_over_<t>``: the share of served tokens whose gap exceeds t
nats, for a few t and for each t that the configuration's ``check`` names.
``check`` limits the numbers that separate sound runs from the
configuration's ``control`` (``references/<name>.py``), whose gaps are
those of the token that the lower precision puts first at each of the same
positions; a run that reads the control puts the control's numbers through
the same limits (``control_correct``, which has to come out false). The
widest gap carries no limit: it is set by the few positions where two
candidates nearly tie, and the control's lies within three times the
program's (``PERF.md``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench.drive import RunLog
from perfbench.traffic import Traffic


def sample(log: RunLog, traffic: Traffic, n: int, seed: int):
    """(prompt + served tokens, first scored position, served tokens, the
    program's logprobs of them) of n finished requests: the longest, then
    others drawn from the seed."""
    done = [r for r in log.recs if r.finished is not None and not r.error
            and len(r.tokens) == r.max_tokens]
    if not done:
        return []
    done.sort(key=lambda r: (r.prompt_len + len(r.tokens), r.index), reverse=True)
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) % 2**63, 7]))
    rest = rng.permutation(len(done) - 1)[:max(0, n - 1)] + 1
    picked = [done[0]] + [done[i] for i in sorted(rest)]
    out = []
    for r in picked:
        prompt = traffic.requests[r.index].prompt
        out.append((prompt + r.tokens[:-1], len(prompt) - 1, r.tokens, r.logprobs))
    return out


def gaps(ref_logits: List[torch.Tensor], chosen: List[List[int]]) -> List[float]:
    """Per position, the reference's best logit less its logit of the chosen token."""
    out: List[float] = []
    for lg, toks in zip(ref_logits, chosen):
        t = torch.tensor(toks, device=lg.device)
        best = lg.max(dim=-1).values
        out.extend((best - lg.gather(-1, t[:, None])[:, 0]).tolist())
    return out


def logprob_errors(ref_logits: List[torch.Tensor], chosen: List[List[int]],
                   logprobs: List[List[float]]) -> List[float]:
    """Per position, |a side's logprob of its chosen token - the reference's|."""
    out: List[float] = []
    for lg, toks, lps in zip(ref_logits, chosen, logprobs):
        t = torch.tensor(toks, device=lg.device)
        ref = torch.log_softmax(lg, dim=-1).gather(-1, t[:, None])[:, 0]
        out.extend((ref - torch.tensor(lps, device=lg.device)).abs().tolist())
    return out


def _quantiles(v: List[float]) -> Dict[str, float]:
    a = np.asarray(v)
    return {f"p{q}": float(np.quantile(a, q / 100)) for q in (50, 90, 99)}


SHARE = "share_gap_over_"
SHARES = (0.1, 0.25, 0.5, 1.0)


def thresholds(limits: Dict[str, Any]) -> List[float]:
    """The t of every ``share_gap_over_<t>`` to report: a few always, and
    each that ``limits`` names."""
    named = [float(k[len(SHARE):]) for k in limits if k.startswith(SHARE)]
    return sorted(set(SHARES) | set(named))


def summary(g: List[float], ts: List[float]) -> Dict[str, Any]:
    """The numbers compared of one side's gaps."""
    a = np.asarray(g)
    out: Dict[str, Any] = {"max_gap": float(a.max()), "mean_gap": float(a.mean()),
                           "median_gap": float(np.median(a))}
    out.update({f"{SHARE}{t:g}": float((a > t).mean()) for t in ts})
    return out


def compare(reference, config: Dict[str, Any], seed: int, seqs, device,
            control: Optional[str] = None) -> Dict[str, Any]:
    """The served tokens' gaps, and with ``control`` (the configuration's
    ``control``) the control's: the gap of its own first choice at each
    position, under ``control_`` names."""
    if not seqs:
        return {"max_gap": None, "served_tokens": 0}
    ts = thresholds(config["check"])
    inputs = [(toks, first) for toks, first, _, _ in seqs]
    ref = reference.logits(config, seed, inputs, device)
    served = [s for _, _, s, _ in seqs]
    g = gaps(ref, served)
    e = logprob_errors(ref, served, [lp for _, _, _, lp in seqs])
    out: Dict[str, Any] = summary(g, ts)
    out.update(mean_lp_err=float(np.mean(e)), served_tokens=len(g),
               gap_q=_quantiles(g), lp_err_q=_quantiles(e))
    if control:
        ctl = reference.logits(config, seed, inputs, device, control=control)
        picks = [c.argmax(dim=-1).tolist() for c in ctl]
        cg = gaps(ref, picks)
        ce = logprob_errors(ref, picks, [torch.log_softmax(c, dim=-1).max(dim=-1).values.tolist()
                                         for c in ctl])
        out.update({f"control_{k}": v for k, v in summary(cg, ts).items()})
        out.update(control_mean_lp_err=float(np.mean(ce)), control_gap_q=_quantiles(cg),
                   control_lp_err_q=_quantiles(ce))
    return out


def verdict(numbers: Dict[str, Any], limits: Dict[str, float]) -> Tuple[bool, Dict[str, Any]]:
    """correct iff every limited number is present and within its limit;
    the checks, each number beside its limit."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v: Optional[float] = numbers.get(name)
        checks[name] = {"value": v, "limit": limit}
        ok = ok and v is not None and limit is not None and v <= limit
    return ok, checks


def control_verdict(numbers: Dict[str, Any], limits: Dict[str, float]) -> Optional[bool]:
    """The control's numbers through the same limits: None where no control
    was read; otherwise whether the control would pass as the program."""
    if not any(k.startswith("control_") for k in numbers):
        return None
    return verdict({k: numbers.get(f"control_{k}") for k in limits}, limits)[0]
