"""The port's CLI (``python -m mistral_inference_tpu_torch.main``) on tiny
checkpoint folders, on the CPU (``--device cpu``).

Each demo's printed text is held to the port tokenizer's decode of the
port's ``generate()`` on the same folder, exactly; lookup and draft-model
speculation print plain greedy's text; ``quantize`` then ``demo`` of the
export prints what ``demo --quant int4`` prints. The parser's defaults are
the JAX package's ``build_parser()``'s.
"""

import json

import pytest
import torch

import test_tokenizers as tiny
from mistral_inference_tpu.main import build_parser as jax_build_parser
from mistral_inference_tpu_torch.generate import generate, generate_mamba
from mistral_inference_tpu_torch.main import DEMO_PROMPTS, build_parser, main
from mistral_inference_tpu_torch.model import Mamba, from_folder
from mistral_inference_tpu_torch.tokenizers import load_tokenizer
from test_torch_loading import write_reference_folder


def _tekken(folder):
    """The tiny Tekken of tests/test_cli.py: 20 specials and 236 byte
    ranks, so every id fits the checkpoints' 256-entry vocabulary."""
    cfg = tiny.tiny_tekken_cfg()
    cfg["config"]["default_vocab_size"] = 256
    cfg["vocab"] = cfg["vocab"][:236]
    (folder / "tekken.json").write_text(json.dumps(cfg))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    f = tmp_path_factory.mktemp("dense")
    write_reference_folder(f, "dense", seed=1)
    _tekken(f)
    return f


def expected_demo(folder, max_tokens, **load_kw) -> str:
    tok = load_tokenizer(folder)
    model = from_folder(folder, device="cpu", **load_kw)
    encoded = [tok.encode(p, bos=True, eos=False) for p in DEMO_PROMPTS]
    run = generate_mamba if isinstance(model, Mamba) else generate
    gen, _ = run(encoded, model, max_tokens=max_tokens, temperature=0.0)
    return "".join(p + tok.decode(g) + "\n" + "=" * 40 + "\n" for p, g in zip(DEMO_PROMPTS, gen))


def demo_out(capsys, folder, *extra) -> str:
    capsys.readouterr()
    main(["demo", str(folder), "--max_tokens", "5", "--device", "cpu", *extra])
    return capsys.readouterr().out


def test_demo_prints_generate(folder, capsys):
    assert demo_out(capsys, folder) == expected_demo(folder, 5)


def test_demo_quantized(folder, capsys):
    out = demo_out(capsys, folder, "--quant", "int4", "--kv_quant", "fp8")
    assert out == expected_demo(folder, 5, quant="int4", kv_quant="fp8")


def test_quantize_then_demo_of_the_export(folder, tmp_path, capsys):
    main(["quantize", str(folder), str(tmp_path / "q4"), "--quant", "int4", "--device", "cpu"])
    assert "wrote int4" in capsys.readouterr().out
    assert (tmp_path / "q4" / "tekken.json").is_file()
    assert json.loads((tmp_path / "q4" / "params.json").read_text())["quant"] == "int4"
    out = demo_out(capsys, tmp_path / "q4")
    assert out == expected_demo(tmp_path / "q4", 5)
    assert out == demo_out(capsys, folder, "--quant", "int4")


@pytest.mark.parametrize("draft", ["lookup", "folder"])
def test_demo_speculative_prints_plain_greedy(folder, tmp_path, capsys, draft):
    if draft == "folder":
        write_reference_folder(tmp_path / "draft", "dense", seed=2)
        draft = str(tmp_path / "draft")
    out = demo_out(capsys, folder, "--draft_path", draft, "--spec_tokens", "2")
    assert out == expected_demo(folder, 5)


def test_demo_tensor_auto_is_one_device(folder, capsys):
    assert demo_out(capsys, folder, "--tensor", "auto") == expected_demo(folder, 5)


def test_mamba_demo(tmp_path, capsys):
    write_reference_folder(tmp_path, "mamba", seed=3)
    _tekken(tmp_path)
    assert demo_out(capsys, tmp_path) == expected_demo(tmp_path, 5)
    out = demo_out(capsys, tmp_path, "--draft_path", "lookup", "--ssm_state", "bf16")
    assert out.count("=" * 40) == 3
    with pytest.raises(ValueError, match="Mamba has none"):
        demo_out(capsys, tmp_path, "--kv_quant", "fp8")


@pytest.mark.parametrize("argv", [["chat", "/x"], ["demo", "/x", "--no-instruct"],
                                  ["quantize", "/x", "/y"]])
def test_parser_defaults_match_jax(argv):
    ours = vars(build_parser().parse_args(argv))
    theirs = vars(jax_build_parser().parse_args(argv))
    for ns in (ours, theirs):
        ns.pop("func")
    assert ours.pop("device") is None
    if "lora_path" not in theirs:  # the port's quantize can merge an adapter first
        assert ours.pop("lora_path") is None
    assert ours == theirs


@pytest.mark.parametrize("extra,error,match", [
    (["--tensor", "2"], ValueError, "needs 2 ranks, found 1"),
    (["--seq", "2"], ValueError, "--seq 2 needs 2 ranks, found 1"),
])
def test_unported_options_raise(folder, capsys, extra, error, match):
    """``--tensor 2`` and ``--seq 2`` each need two ranks (``torchrun``;
    tests/test_torch_parallel_mp.py runs them so), and one process is
    refused with the command that starts them."""
    with pytest.raises(error, match=match):
        demo_out(capsys, folder, *extra)


def _adapter_file(folder, path):
    """A rank-4 adapter on wq and w2 of every layer of ``folder``'s model."""
    from mistral_inference_tpu_torch.args import load_args
    from mistral_inference_tpu_torch.io.safetensors import save_file

    args = load_args(folder)
    gen = torch.Generator().manual_seed(0)
    sd = {}
    for i in range(args.n_layers):
        for name, din, dout in (("attention.wq", args.dim, args.n_heads * args.head_dim),
                                ("feed_forward.w2", args.hidden_dim, args.dim)):
            sd[f"layers.{i}.{name}.lora_A.weight"] = torch.randn(4, din, generator=gen) * 0.1
            sd[f"layers.{i}.{name}.lora_B.weight"] = torch.randn(dout, 4, generator=gen) * 0.1
    save_file(sd, path)
    return path


def test_lora_merges_before_quantizing(folder, tmp_path, capsys):
    """tests/test_cli.py::test_quant_with_lora: ``demo --quant int8
    --lora_path`` prints generate()'s text of the model merged, then
    quantized; ``quantize --lora_path`` exports that model's leaves in bits,
    and the export's demo prints the same text."""
    from mistral_inference_tpu_torch.lora import load_lora

    adapter = str(_adapter_file(folder, tmp_path / "adapter.safetensors"))
    want = from_folder(folder, device="cpu")
    load_lora(want, adapter)
    want.quantize("int8")
    tok = load_tokenizer(folder)
    encoded = [tok.encode(p, bos=True, eos=False) for p in DEMO_PROMPTS]
    gen, _ = generate(encoded, want, max_tokens=5, temperature=0.0)
    text = "".join(p + tok.decode(g) + "\n" + "=" * 40 + "\n" for p, g in zip(DEMO_PROMPTS, gen))
    assert demo_out(capsys, folder, "--quant", "int8", "--lora_path", adapter) == text
    assert text != expected_demo(folder, 5, quant="int8")
    main(["quantize", str(folder), str(tmp_path / "q8"), "--quant", "int8", "--lora_path",
          adapter, "--device", "cpu"])
    got = from_folder(tmp_path / "q8", device="cpu")
    for lw, lw_want in zip(got.params["layers"], want.params["layers"]):
        for key in ("wqkv", "w2"):
            for k in lw[key]:
                assert torch.equal(lw[key][k], lw_want[key][k])
    assert demo_out(capsys, tmp_path / "q8") == text
