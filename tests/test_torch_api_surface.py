"""The port's public surface against the JAX package's, on the CPU:

* ``models.registry.param_count(name)`` equals the JAX package's for every
  preset of its ``REGISTRY``;
* ``main.mistral_chat`` / ``mistral_demo`` / ``mistral_quantize`` prepend
  their command to ``sys.argv[1:]`` and call ``main``, and the
  ``pyproject.toml`` scripts ``mistral-*-torch`` resolve to them, beside the
  JAX package's three, which stay;
* every name of the JAX package's top level resolves on the port's, the
  model classes and the tokenizer loader lazily: importing the package loads
  no model code and no kernel module;
* ``MISTRAL_MOE_DEBUG``: the dispatch's over-capacity drops, kept on the
  tensors' device and folded into ``METRICS["moe_dropped_assignments"]``
  by ``METRICS.dump()``, equal the JAX package's count on the same
  converted weights (its un-jitted dispatch), and the plain count of slots
  past the capacity; nothing is counted with the switch off.
"""

import dataclasses
import importlib
import os
import subprocess
import sys
import tomllib
from collections import defaultdict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mistral_inference_tpu
import mistral_inference_tpu_torch
from mistral_inference_tpu.args import MoeArgs as JaxMoeArgs
from mistral_inference_tpu.args import TransformerArgs as JaxArgs
from mistral_inference_tpu.model import Transformer as JaxTransformer
from mistral_inference_tpu.models import registry as jreg
from mistral_inference_tpu.models import transformer as jtf
from mistral_inference_tpu.utils.profiling import METRICS as JAX_METRICS
from mistral_inference_tpu_torch import main as tmain
from mistral_inference_tpu_torch.args import TransformerArgs
from mistral_inference_tpu_torch.convert import params_from_numpy
from mistral_inference_tpu_torch.models import registry as treg
from mistral_inference_tpu_torch.models import transformer as ttf
from mistral_inference_tpu_torch.utils.profiling import METRICS as PORT_METRICS

ROOT = Path(__file__).resolve().parents[1]
DROPS = "moe_dropped_assignments"


@pytest.mark.parametrize("name", sorted(jreg.REGISTRY))
def test_param_count_matches_jax(name):
    assert treg.param_count(name) == jreg.param_count(name)


def test_param_count_is_the_built_tree_less_conv_bias(monkeypatch):
    """The formula against a built tree at a narrow width: a transformer's
    count is its tensors'; the JAX Mamba formula leaves out the conv bias
    (conv_dim a layer), which the tree holds."""
    from mistral_inference_tpu_torch.model import Mamba, Transformer

    for name, cls in (("mistral-7b-v0.1", Transformer), ("codestral-mamba-7b", Mamba)):
        args = treg.get_args(name)
        args.n_layers, args.dim, args.vocab_size = 1, 256, 512
        if cls is Transformer:
            args.hidden_dim, args.n_heads, args.n_kv_heads = 512, 2, 1
        monkeypatch.setitem(treg.REGISTRY, name, args)
        model = cls.random(args, dtype=torch.float32, seed=0, device="cpu")
        built = sum(t.numel() for t in _tensors(model.params))
        assert built == treg.param_count(name) + (args.conv_dim if cls is Mamba else 0), name


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)


@pytest.mark.parametrize("fn,command", [
    ("mistral_chat", "chat"), ("mistral_demo", "demo"), ("mistral_quantize", "quantize")])
def test_console_functions_forward_argv(monkeypatch, fn, command):
    seen = []
    monkeypatch.setattr(tmain, "main", seen.append)
    monkeypatch.setattr(sys, "argv", ["prog", "/some/folder", "--max_tokens", "5",
                                      "--device", "cpu"])
    getattr(tmain, fn)()
    assert seen == [[command, "/some/folder", "--max_tokens", "5", "--device", "cpu"]]


def _scripts():
    return tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]["scripts"]


@pytest.mark.parametrize("script,fn", [
    ("mistral-chat", "mistral_chat"), ("mistral-demo", "mistral_demo"),
    ("mistral-quantize", "mistral_quantize")])
def test_pyproject_scripts_resolve(script, fn):
    scripts = _scripts()
    assert scripts[script] == f"mistral_inference_tpu.main:{fn}"
    target = scripts[script + "-torch"]
    assert target == f"mistral_inference_tpu_torch.main:{fn}"
    module, attr = target.split(":")
    assert callable(getattr(importlib.import_module(module), attr))


def test_cli_parses_through_a_console_function(monkeypatch):
    """Unpatched, the console function reaches the parser: a bad command
    line exits as ``main`` would."""
    monkeypatch.setattr(sys, "argv", ["mistral-demo-torch"])
    with pytest.raises(SystemExit):
        tmain.mistral_demo()


JAX_SURFACE = ["__version__", "LoraArgs", "MambaArgs", "MoeArgs", "TransformerArgs",
               "VisionEncoderArgs", "load_args", "Transformer", "Mamba", "from_folder",
               "get_model_cls", "load_tokenizer"]


@pytest.mark.parametrize("name", JAX_SURFACE)
def test_jax_top_level_names_resolve_on_the_port(name):
    assert hasattr(mistral_inference_tpu, name)
    got = getattr(mistral_inference_tpu_torch, name)
    if name == "__version__":
        assert got == mistral_inference_tpu.__version__
        return
    assert got.__module__.startswith("mistral_inference_tpu_torch."), got.__module__


def test_top_level_unknown_name_raises():
    with pytest.raises(AttributeError):
        mistral_inference_tpu_torch.generate_everything  # noqa: B018


def test_package_import_loads_no_model_code():
    code = ("import sys, mistral_inference_tpu_torch as m\n"
            "assert m.TransformerArgs and m.load_args\n"
            "bad = [k for k in sys.modules if k.startswith('mistral_inference_tpu_torch.') and\n"
            "       k.split('.')[1] in ('model', 'models', 'ops', 'generate')]\n"
            "assert not bad, bad\n"
            "m.Transformer\n"
            "assert 'mistral_inference_tpu_torch.model' in sys.modules\n"
            "from mistral_inference_tpu_torch.ops.cuda import _build\n"
            "assert not _build._LIBS\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]


# ---------------------------------------------------------------------------
# MISTRAL_MOE_DEBUG
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def moe_layer():
    """Layer 0 of a tiny MoE model in both packages, the port's through
    ``convert``, and x (24, 256): 48 assignments for 4 experts of 8 slots
    at capacity factor 0.5."""
    jargs = JaxArgs(dim=256, n_layers=1, head_dim=128, hidden_dim=512, n_heads=2,
                    n_kv_heads=1, norm_eps=1e-5, vocab_size=512,
                    moe=JaxMoeArgs(num_experts=4, num_experts_per_tok=2))
    jmodel = JaxTransformer.random(jargs, dtype=jnp.float32, seed=21)
    params = params_from_numpy(jax.tree.map(np.asarray, jmodel.params), device="cpu")
    jw = jax.tree.map(lambda a: a[0], jmodel.params["layers"]["moe"])
    x = np.random.default_rng(22).standard_normal((24, 256)).astype(np.float32)
    assert TransformerArgs.from_dict(dataclasses.asdict(jargs)).moe.num_experts == 4
    return jw, params["layers"][0], x


def _plain_drops(lw, x, factor):
    top_idx, _ = ttf._route(torch.from_numpy(x), lw["gate"], 2)
    flat = top_idx.reshape(-1).tolist()
    C = ttf.moe_capacity(x.shape[0], 2, lw["gate"].shape[0], factor)
    seen = defaultdict(int)
    drops = 0
    for e in flat:
        drops += seen[e] >= C
        seen[e] += 1
    return drops


@pytest.mark.parametrize("on", [True, False])
def test_moe_debug_counts_drops_like_jax(monkeypatch, moe_layer, on):
    jw, lw, x = moe_layer
    for metrics in (JAX_METRICS, PORT_METRICS):
        monkeypatch.setattr(metrics, "counters", defaultdict(float))
    monkeypatch.setattr(PORT_METRICS, "_on_device", {})
    monkeypatch.setattr(jtf, "_MOE_DEBUG", on)
    monkeypatch.setattr(ttf, "_MOE_DEBUG", on)
    ref = jtf._moe_ffn_dispatch(jnp.asarray(x), jw, 2, 0.5)
    jax.effects_barrier()
    out = ttf._moe_ffn_dispatch(torch.from_numpy(x), lw, 2, 0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
    # The port keeps the count on the tensors' device until a fold.
    assert DROPS not in PORT_METRICS.counters
    PORT_METRICS.dump()
    if not on:
        assert DROPS not in JAX_METRICS.counters and DROPS not in PORT_METRICS.counters
        return
    want = _plain_drops(lw, x, 0.5)
    assert want > 0
    assert PORT_METRICS.counters[DROPS] == JAX_METRICS.counters[DROPS] == want
    # Each expert rank's share counts the global drops: what one device counts.
    for e0 in (0, 2):
        shard = {"gate": lw["gate"], "w13": lw["w13"][e0:e0 + 2], "w2": lw["w2"][e0:e0 + 2]}
        ttf._moe_ffn_dispatch(torch.from_numpy(x), shard, 2, 0.5, experts=(e0, 2))
    PORT_METRICS.dump()
    assert PORT_METRICS.counters[DROPS] == 3 * want


def test_moe_debug_switch_reads_the_environment():
    """The switch is read once, at import, as the JAX package reads it."""
    code = ("import mistral_inference_tpu_torch.models.transformer as t; "
            "print(t._MOE_DEBUG)")
    for value, want in (("1", "True"), ("0", "False"), ("", "False")):
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                             text=True, timeout=300,
                             env={**os.environ, "MISTRAL_MOE_DEBUG": value})
        assert out.returncode == 0 and out.stdout.strip() == want, out.stderr[-2000:]
