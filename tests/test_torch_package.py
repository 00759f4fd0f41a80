"""Package rules of the PyTorch port.

* It imports neither ``jax`` nor ``mistral_inference_tpu`` (nor do
  ``chip_smoke.py`` and tests/test_torch_cuda.py, which run on the card's
  machine, where JAX is not installed).
* The lint rules of tests/test_codequality.py hold for its sources.
* Its kernel modules import without nvcc or a card: kernels build and load
  only when first launched.
* Its entry points run on the card by default and never fall back to the
  CPU quietly.
"""

import ast
import pathlib
import py_compile
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "mistral_inference_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py"))
SCANNED = SOURCES + [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py"]
# the port reads and writes safetensors files itself: the card has no such package
FORBIDDEN = ("jax", "jaxlib", "mistral_inference_tpu", "safetensors")


def _ids(p):
    return str(p.relative_to(ROOT))


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_sources_found():
    assert len(SOURCES) >= 21
    for module in ("ops/linear.py", "ops/cuda/matmul_quant.py", "ops/cuda/moe_matmul.py",
                   "quant/weights.py", "speculative.py", "models/mamba.py",
                   "ops/cuda/ssd_step.py", "models/vision.py", "images.py", "loading.py",
                   "main.py", "server/api.py", "io/safetensors.py", "native/__init__.py",
                   "tokenizers/spm.py", "tokenizers/tekken.py", "tokenizers/chat.py"):
        assert PKG / module in SOURCES
    assert sorted(p.name for p in (PKG / "ops" / "cuda" / "csrc").glob("*.cu")) == [
        "decode_attention.cu", "flash_attention.cu", "fused_decode.cu", "matmul_quant.cu",
        "moe_expert_matmul.cu", "moe_matmul.cu", "ring_attention.cu", "segment_attention.cu",
        "ssd_step.cu",
    ]
    # K3 and K8 share their device loop (dequant_mma.cuh: mma.sync with the
    # weight as A, x's rows as n-tiles); K1, K4 and K10 share theirs (the
    # Hopper tile loop of flash_hopper.cuh, each in an instantiation of its
    # own: K1 the chunk's bf16 keys, K10 at head dim 64 with a segment mask);
    # K2, K6 and K7 theirs (the cluster decode loop of decode_hopper.cuh, K2
    # and K7 with the ring write in front), whose entry points are in
    # fused_decode.cu and decode_attention.cu. flash_hopper.cuh and K5's
    # moe_matmul.cu share the wgmma, descriptor and mbarrier primitives of
    # hopper.cuh.
    assert sorted(p.name for p in (PKG / "ops" / "cuda" / "csrc").glob("*.cuh")) == [
        "common.cuh", "decode_hopper.cuh", "dequant_mma.cuh", "flash_hopper.cuh", "hopper.cuh",
    ]


@pytest.mark.parametrize("path", SCANNED, ids=_ids)
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imports(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{_ids(path)} imports {bad}"


@pytest.mark.parametrize("path", SOURCES, ids=_ids)
def test_compiles(path):
    py_compile.compile(str(path), doraise=True)


@pytest.mark.parametrize("path", SOURCES, ids=_ids)
def test_ast_lint(path):
    """tests/test_codequality.py's rules: no bare except, no mutable default
    argument, no print() in library modules (the CLI, main.py, prints, as
    that test allows), no assert on a tuple."""
    tree = ast.parse(path.read_text(), filename=str(path))
    problems = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            problems.append(f"line {node.lineno}: bare except")
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for d in list(node.args.defaults) + [d for d in node.args.kw_defaults if d is not None]:
                if isinstance(d, (ast.List, ast.Dict, ast.Set)):
                    problems.append(f"line {node.lineno}: mutable default arg in {node.name}")
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "print" and path != PKG / "main.py"):
            problems.append(f"line {node.lineno}: print() in library module")
        if isinstance(node, ast.Assert) and isinstance(node.test, ast.Tuple):
            problems.append(f"line {node.lineno}: assert on tuple (always true)")
    assert not problems, "\n".join(f"{_ids(path)}: {p}" for p in problems)


def test_package_imports_without_jax_or_nvcc():
    """In a fresh interpreter where importing jax or safetensors fails and
    nvcc is not on the PATH, every module of the port imports, and neither a
    kernel nor the native BPE is built."""
    code = (
        "import sys, importlib, pathlib\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'safetensors') "
        "or name == 'mistral_inference_tpu' "
        "or name.startswith('mistral_inference_tpu.'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "root = pathlib.Path(sys.argv[1])\n"
        "for p in sorted((root / 'mistral_inference_tpu_torch').rglob('*.py')):\n"
        "    mod = '.'.join(p.relative_to(root).with_suffix('').parts)\n"
        "    importlib.import_module(mod.removesuffix('.__init__'))\n"
        "from mistral_inference_tpu_torch.ops.cuda import _build\n"
        "assert not _build._LIBS\n"
        "from mistral_inference_tpu_torch import native\n"
        "assert native._LIB is None\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-S", "-c", code, str(ROOT)], capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ":".join([str(ROOT)] + sys.path[1:])},
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]


def _raises_without_cuda(monkeypatch, family, preset):
    from mistral_inference_tpu_torch import model
    from mistral_inference_tpu_torch.models.registry import get_args

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = get_args(preset)
    args.n_layers = 1
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(model, family).random(args)


def test_entry_points_raise_without_cuda(monkeypatch):
    _raises_without_cuda(monkeypatch, "Transformer", "mistral-7b-v0.1")


def test_mamba_entry_point_raises_without_cuda(monkeypatch):
    _raises_without_cuda(monkeypatch, "Mamba", "codestral-mamba-7b")


@pytest.mark.parametrize("name", ["params_from_numpy", "vision_params_from_numpy",
                                  "mamba_params_from_numpy"])
def test_converters_raise_without_cuda(monkeypatch, name):
    """The converters that carry JAX weights across default to the card, as
    the models do: without one they raise and name ``device="cpu"``."""
    from mistral_inference_tpu_torch import convert

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(convert, name)({"layers": {}})


def _cpu_only_on_request(family, args):
    from mistral_inference_tpu_torch import model as tmodel

    model = getattr(tmodel, family).random(args, dtype=torch.float32, seed=0, device="cpu")
    assert model.device.type == "cpu"
    assert all(t.device.type == "cpu" for t in model.params["layers"][0].values())


def test_cpu_only_on_request():
    from mistral_inference_tpu_torch.args import TransformerArgs

    _cpu_only_on_request("Transformer", TransformerArgs(
        dim=64, n_layers=1, head_dim=16, hidden_dim=128, n_heads=4, n_kv_heads=2,
        norm_eps=1e-5, vocab_size=64))


def test_mamba_cpu_only_on_request():
    from mistral_inference_tpu_torch.args import MambaArgs

    _cpu_only_on_request("Mamba", MambaArgs(
        dim=64, n_layers=1, vocab_size=64, n_groups=2, rms_norm=True, residual_in_fp32=True,
        fused_add_norm=True, pad_vocab_size_multiple=16, tie_embeddings=False, d_state=16,
        headdim=16))


PRESETS = ["mistral-7b-v0.1", "mistral-7b-v0.3", "mistral-nemo-12b", "codestral-22b",
           "mixtral-8x7b", "mixtral-8x22b", "mistral-large-2-123b", "pixtral-12b",
           "mistral-small-3.1-24b", "codestral-mamba-7b"]


@pytest.mark.parametrize("name", PRESETS)
def test_registry_matches_jax_presets(name):
    """The presets carry the JAX package's published widths, field by field
    (Pixtral's vision encoder too)."""
    import dataclasses

    from mistral_inference_tpu.models.registry import REGISTRY as JAX_REGISTRY
    from mistral_inference_tpu_torch.models.registry import REGISTRY

    ours = dataclasses.asdict(REGISTRY[name])
    theirs = dataclasses.asdict(JAX_REGISTRY[name])
    assert {k: theirs[k] for k in ours} == ours


def test_registry_has_every_jax_preset():
    from mistral_inference_tpu.models.registry import REGISTRY as JAX_REGISTRY
    from mistral_inference_tpu_torch.models.registry import REGISTRY

    assert sorted(REGISTRY) == sorted(JAX_REGISTRY) == sorted(PRESETS)
