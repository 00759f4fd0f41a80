"""The comparison that decides ``correct``, on the CPU at a size a test run
holds: sound runs pass, the control (the reference with float8 activations)
fails, and a run with its timed path broken underneath fails, once for each
fault a served cell can have. At such a size the MoE model's bf16 router
near-ties move its served tokens as far from the reference as the control's
float8 activations do (``PERF.md``), so for it the tests show only that the
control goes through the configuration's own limits; its control fails on
the card, at the cell's size. ``test_cell_on_card`` runs a real cell and
needs a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

import tiny
from perfbench import check


@pytest.mark.parametrize("seed", [2**31 + 977, 2**31 + 978, 5])
def test_sound_runs_pass_and_the_control_fails(seed):
    res = tiny.run(tiny.dense_open(), seed, control=True)
    ref, limit = res["reference"], res["checks"]["mean_gap"]["limit"]
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert ref["served_tokens"] >= 50
    assert ref["mean_gap"] <= limit < ref["control_mean_gap"]
    assert res["control_correct"] is False
    assert list(res)[-1] == "checks"


def test_a_sound_moe_run_passes_and_its_control_meets_the_same_limits():
    res = tiny.run(tiny.moe_closed(), 2**31 + 977, control=True)
    assert res["correct"], res["checks"]
    ref, limits = res["reference"], tiny.moe_closed().config["check"]
    assert res["control_correct"] is all(ref[f"control_{k}"] <= v for k, v in limits.items())


@pytest.mark.parametrize("config", ["mistral-7b-int4-fp8", "mixtral-8x7b-int4"])
def test_the_control_is_judged_by_the_configurations_limits(config):
    limits = json.loads((tiny.ROOT / "perfbench" / "configs" / f"{config}.json").read_text())["check"]
    sound = {k: 0.5 * v for k, v in limits.items()}
    assert check.control_verdict(sound, limits) is None  # no control read
    assert check.control_verdict(dict(sound, **{f"control_{k}": 2 * v for k, v in limits.items()}),
                                 limits) is False
    assert check.control_verdict(dict(sound, **{f"control_{k}": v for k, v in limits.items()}),
                                 limits) is True
    for k in limits:  # the limited number is one the comparison reports
        assert k in check.summary([0.0, 2.0], check.thresholds(limits))


def _altered_token(monkeypatch):
    """Every sampled token moved to its neighbour where it is produced."""
    from mistral_inference_tpu_torch import generate as G

    sample = G.sample

    def wrong(prelogits, *a, **kw):
        return (sample(prelogits, *a, **kw) + 1) % prelogits.shape[-1]

    monkeypatch.setattr(G, "sample", wrong)


def _state_unchanged(monkeypatch):
    """Decode steps attend without writing their token into the ring: the
    step's cache update leaves the state as it was."""
    import torch

    from mistral_inference_tpu_torch.models import transformer as tf

    fused = tf.fused_update_decode_attention

    def no_write(xq, xk, xv, CK, CV, KS, VS, li, window, write_slot, *a):
        return fused(xq, xk, xv, CK, CV, KS, VS, li, window, torch.full_like(write_slot, -1), *a)

    monkeypatch.setattr(tf, "fused_update_decode_attention", no_write)


@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged], ids=["token", "state"])
@pytest.mark.parametrize("make", [tiny.dense_open, tiny.moe_closed], ids=["dense", "moe"])
def test_a_broken_timed_path_is_not_correct(make, fault, monkeypatch):
    fault(monkeypatch)
    res = tiny.run(make(), 2**31 + 977)
    assert not res["correct"]
    (name, c), = [(k, v) for k, v in res["checks"].items() if k != "errors"]
    assert c["value"] > c["limit"], name


@pytest.mark.cuda
def test_cell_on_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the card only")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", tiny.OPEN, "--seed", "2147484000",
         "--seconds", "5", "--trace", "0"],
        cwd=tiny.ROOT, capture_output=True, text=True, timeout=900, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    import json

    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
