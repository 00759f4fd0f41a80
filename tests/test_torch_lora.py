"""LoRA in the port on the CPU, mirroring tests/test_lora.py: an adapter file
merged into the dense weights at load (``lora.merge_lora``) and live
adapters (``args.lora``: zero pairs in ``Transformer.random``, filled by
``lora.load_live_lora``), dense and MoE, every MoE route; and, as in
tests/test_speculative.py::test_spec_live_lora_target, speculation over a
live-LoRA target. One case per mode is held against the JAX package on the
same weights and the same adapter file (written by the port's
``io/safetensors.py``, read by the JAX package's ``safetensors``): merged,
live, and live expert adapters.

Tolerances: greedy tokens equal; logprobs within 1e-4 (fp32); a merged
weight within 1e-5 of W + s (B A)^T; a zero adapter changes no bit; the MoE
routes against the oracle within tests/test_torch_moe.py's FFN bound.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistral_inference_tpu.args import LoraArgs as JaxLoraArgs
from mistral_inference_tpu.args import MoeArgs as JaxMoeArgs
from mistral_inference_tpu.args import TransformerArgs as JaxArgs
from mistral_inference_tpu.generate import generate as jax_generate
from mistral_inference_tpu.lora import load_lora as jax_load_lora
from mistral_inference_tpu.model import Transformer as JaxTransformer
from mistral_inference_tpu_torch.args import LoraArgs, MambaArgs, MoeArgs, TransformerArgs
from mistral_inference_tpu_torch.convert import params_from_numpy, params_to_numpy
from mistral_inference_tpu_torch.generate import generate
from mistral_inference_tpu_torch.io.safetensors import save_file
from mistral_inference_tpu_torch.lora import load_lora, merge_lora
from mistral_inference_tpu_torch.model import Mamba, Transformer
from mistral_inference_tpu_torch.models import transformer as tf

PROMPTS = [[1, 2, 3, 4, 5], [7, 8]]
LP_TOL = dict(atol=1e-4, rtol=0)
FFN_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_args(**overrides) -> dict:
    kw = dict(dim=128, n_layers=2, head_dim=32, hidden_dim=256, n_heads=4, n_kv_heads=2,
              norm_eps=1e-5, vocab_size=512, max_batch_size=4, rope_theta=10000.0)
    kw.update(overrides)
    return kw


def port(seed, **overrides) -> Transformer:
    return Transformer.random(TransformerArgs(**tiny_args(**overrides)), dtype=torch.float32,
                              seed=seed, device="cpu")


def port_of(jmodel) -> Transformer:
    args = TransformerArgs.from_dict(dataclasses.asdict(jmodel.args))
    params = params_from_numpy(jax.tree.map(np.asarray, jmodel.params), device="cpu")
    return Transformer(args, params, torch.float32, device="cpu")


def adapter(args: dict, rank=4, seed=0, families=("wq", "wo", "w1"), experts=0, layers=None):
    """Reference-layout adapter tensors: lora_A (r, in), lora_B (out, r)."""
    rng = np.random.default_rng(seed)
    D, F, q, kv = args["dim"], args["hidden_dim"], args["n_heads"] * args["head_dim"], \
        args["n_kv_heads"] * args["head_dim"]
    shapes = {"wq": (D, q), "wk": (D, kv), "wv": (D, kv), "wo": (q, D), "w1": (D, F),
              "w2": (F, D), "w3": (D, F)}
    sd = {}
    for i in range(args["n_layers"]) if layers is None else layers:
        for name in families:
            din, dout = shapes[name]
            group = "attention" if name in ("wq", "wk", "wv", "wo") else "feed_forward"
            bases = ([f"layers.{i}.{group}.{name}"] if not experts or group == "attention" else
                     [f"layers.{i}.feed_forward.experts.{e}.{name}" for e in range(experts)])
            for base in bases:
                sd[base + ".lora_A.weight"] = torch.from_numpy(
                    rng.standard_normal((rank, din)).astype(np.float32) * 0.05)
                sd[base + ".lora_B.weight"] = torch.from_numpy(
                    rng.standard_normal((dout, rank)).astype(np.float32) * 0.05)
    return sd


def write(sd, path):
    save_file(sd, path)
    return path


def close(a, b, tol=LP_TOL):
    assert [len(x) for x in a] == [len(x) for x in b]
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, **tol)


def test_merge_math():
    """A merged weight is W + s (B A) in the port's (out, in) layout, in its
    slice of the fused wqkv; a family the file leaves out keeps its bits."""
    model = port(1)
    args = model.args
    sd = adapter(tiny_args())
    before = [{k: lw[k].clone() for k in ("wqkv", "wo", "w13", "w2")}
              for lw in model.params["layers"]]
    merge_lora(model.params, sd, args, scaling=2.0)
    q = args.n_heads * args.head_dim
    for i, lw in enumerate(model.params["layers"]):
        a, b = sd[f"layers.{i}.attention.wq.lora_A.weight"], sd[f"layers.{i}.attention.wq.lora_B.weight"]
        np.testing.assert_allclose(lw["wqkv"][:q].numpy(), (before[i]["wqkv"][:q] + 2.0 * b @ a).numpy(),
                                   atol=1e-5, rtol=1e-5)
        assert torch.equal(lw["wqkv"][q:], before[i]["wqkv"][q:])  # wk, wv
        assert torch.equal(lw["w2"], before[i]["w2"])
        a1 = sd[f"layers.{i}.feed_forward.w1.lora_A.weight"]
        b1 = sd[f"layers.{i}.feed_forward.w1.lora_B.weight"]
        np.testing.assert_allclose(lw["w13"][:256].numpy(),
                                   (before[i]["w13"][:256] + 2.0 * b1 @ a1).numpy(), atol=1e-5,
                                   rtol=1e-5)
        assert torch.equal(lw["w13"][256:], before[i]["w13"][256:])  # w3


def test_partial_adapter():
    """Only the layers the file holds are merged."""
    model = port(2)
    w0 = model.params["layers"][0]["wqkv"].clone()
    merge_lora(model.params, adapter(tiny_args(), layers=[1]), model.args, scaling=2.0)
    assert torch.equal(model.params["layers"][0]["wqkv"], w0)
    assert not torch.equal(model.params["layers"][1]["wqkv"][:128],
                           port(2).params["layers"][1]["wqkv"][:128])


def test_merged_lora_matches_jax(tmp_path):
    """load_lora into a model without LoraArgs merges, in both packages; the
    merge moves the logprobs, and the merged models agree."""
    jargs = tiny_args()
    jmodel = JaxTransformer.random(JaxArgs(**jargs), dtype=jnp.float32, seed=42)
    model = port_of(jmodel)
    _, base_lp = generate(PROMPTS, model, max_tokens=5, temperature=0.0)
    path = write(adapter(jargs, seed=3, families=("wq", "wk", "wv", "wo", "w1", "w2", "w3")),
                 tmp_path / "lora.safetensors")
    jax_load_lora(jmodel, path, scaling=2.0)
    load_lora(model, path, scaling=2.0)
    g, lp = generate(PROMPTS, model, max_tokens=5, temperature=0.0)
    jg, jlp = jax_generate(PROMPTS, jmodel, max_tokens=5, temperature=0.0)
    assert g == jg
    close(lp, jlp)
    assert not np.allclose(base_lp[0][:4], lp[0][:4], atol=1e-6)


def test_live_lora_matches_jax_and_merged(tmp_path):
    """A model built with LoraArgs applies the adapter live: the JAX
    package's live model's tokens and logprobs, and the merged model's."""
    path = write(adapter(tiny_args(), seed=9, families=("wq", "wk", "wv", "wo", "w1", "w2", "w3")),
                 tmp_path / "lora.safetensors")
    jlive = JaxTransformer.random(JaxArgs(**tiny_args(lora=JaxLoraArgs(rank=4, scaling=2.0))),
                                  dtype=jnp.float32, seed=42)
    live = port_of(jlive)
    assert live.args.lora == LoraArgs(rank=4, scaling=2.0)
    assert live.params["layers"][0]["lora"]["wq"]["a"].shape == (128, 4)
    jax_load_lora(jlive, path)
    load_lora(live, path)
    g, lp = generate(PROMPTS, live, max_tokens=5, temperature=0.0)
    jg, jlp = jax_generate(PROMPTS, jlive, max_tokens=5, temperature=0.0)
    assert g == jg
    close(lp, jlp)
    merged = port_of(JaxTransformer.random(JaxArgs(**tiny_args()), dtype=jnp.float32, seed=42))
    load_lora(merged, path, scaling=2.0)
    gm, lpm = generate(PROMPTS, merged, max_tokens=5, temperature=0.0)
    assert gm == g
    close(lpm, lp)
    # The live tree goes back to the JAX package's layout in bits.
    tree = params_to_numpy(live.params, live.args)
    np.testing.assert_array_equal(tree["layers"]["attention"]["wq_lora"]["a"],
                                  np.stack([lw["lora"]["wq"]["a"].numpy()
                                            for lw in live.params["layers"]]))


def test_live_lora_zero_adapter_changes_no_bit():
    """Zero pairs, int8 base: the tokens and logprobs of the model without
    LoRA leaves, in bits; decode == prefill with a loaded adapter."""
    plain = port(42).quantize("int8", group=32)
    live = port(42, lora=LoraArgs(rank=4, scaling=2.0)).quantize("int8", group=32)
    assert all(torch.equal(lw["lora"]["w2"]["b"], torch.zeros_like(lw["lora"]["w2"]["b"]))
               for lw in live.params["layers"])
    gp, lpp = generate(PROMPTS, plain, max_tokens=5, temperature=0.0)
    gl, lpl = generate(PROMPTS, live, max_tokens=5, temperature=0.0)
    assert gp == gl and lpp == lpl


def test_live_lora_decode_equals_prefill(tmp_path):
    live = port(7, lora=LoraArgs(rank=4, scaling=2.0))
    load_lora(live, write(adapter(tiny_args(), seed=4, families=("wq", "wv", "w2", "w3")),
                          tmp_path / "a.safetensors"))
    g, lp = generate(PROMPTS, live, max_tokens=6, temperature=0.0)
    _, lp_ref = generate([p + x for p, x in zip(PROMPTS, g)], live, max_tokens=0,
                         temperature=0.0)
    close(lp, lp_ref)


def _moe_sd(args, seed, families=("w1", "w2", "w3")):
    return adapter(args, seed=seed, families=families, experts=4)


def test_live_lora_moe_experts_match_jax(tmp_path):
    """Live expert adapters (dense oracle): the JAX package's tokens and
    logprobs; the same adapter merged into the experts agrees."""
    kw = tiny_args(moe=JaxMoeArgs(num_experts=4, num_experts_per_tok=2))
    path = write(_moe_sd(kw, 5, ("wq", "w1", "w2", "w3")), tmp_path / "lora.safetensors")
    jlive = JaxTransformer.random(JaxArgs(**kw, lora=JaxLoraArgs(rank=4, scaling=2.0)),
                                  dtype=jnp.float32, seed=42)
    live = port_of(jlive)
    assert live.params["layers"][0]["lora"]["w1"]["a"].shape == (4, 128, 4)
    jax_load_lora(jlive, path)
    load_lora(live, path)
    g, lp = generate(PROMPTS, live, max_tokens=5, temperature=0.0)
    jg, jlp = jax_generate(PROMPTS, jlive, max_tokens=5, temperature=0.0)
    assert g == jg
    close(lp, jlp)
    merged = port_of(JaxTransformer.random(JaxArgs(**kw), dtype=jnp.float32, seed=42))
    load_lora(merged, path, scaling=2.0)
    gm, lpm = generate(PROMPTS, merged, max_tokens=5, temperature=0.0)
    assert gm == g
    close(lpm, lp)


@pytest.mark.parametrize("bits", [None, 8])
def test_live_lora_moe_routes_match_the_oracle(bits):
    """The expert adapters on every MoE route: dispatch's capacity buffers
    (K8 for an int8 stack), the sorted ragged product (K5 per 256-row tile;
    the per-expert plain product for a dense stack), against the dense
    oracle with the same adapters."""
    args = TransformerArgs(**tiny_args(dim=256, hidden_dim=256,
                                       moe=MoeArgs(num_experts=4, num_experts_per_tok=2),
                                       lora=LoraArgs(rank=4, scaling=2.0)))
    gen = torch.Generator().manual_seed(0)
    lw = tf.init_params(args, torch.float32, gen, torch.device("cpu"),
                        "int8" if bits else None, group=32)["layers"][0]
    for pair in lw["lora"].values():
        for k in pair:
            pair[k].normal_(generator=gen).mul_(0.05)
    rng = np.random.default_rng(1)
    for N in (24, 512):  # capacity buffers; sorted ragged rows
        x = torch.from_numpy(rng.standard_normal((N, 256)).astype(np.float32))
        oracle = tf._moe_ffn(x, lw, 2, args)
        out = tf._moe_ffn_dispatch(x, lw, 2, 4.0, args)
        np.testing.assert_allclose(out.numpy(), oracle.numpy(), **FFN_TOL)
        no_lora = tf._moe_ffn(x, {k: v for k, v in lw.items() if k != "lora"}, 2)
        assert not np.allclose(no_lora.numpy(), oracle.numpy(), **FFN_TOL)


@pytest.mark.parametrize("draft", ["model", "lookup"])
def test_spec_live_lora_target(tmp_path, draft):
    """Speculation over a live-LoRA target (the adapters applied in every
    verify forward) gives that target's plain greedy tokens."""
    live = port(2, lora=LoraArgs(rank=4, scaling=2.0), head_dim=128, n_heads=2, n_kv_heads=1)
    load_lora(live, write(adapter(tiny_args(head_dim=128, n_heads=2, n_kv_heads=1), seed=6,
                                  families=("wq", "wk", "wv", "wo", "w1", "w2", "w3")),
                          tmp_path / "a.safetensors"))
    d = port(3, dim=64, n_layers=1, head_dim=16, hidden_dim=128) if draft == "model" else draft
    plain, plain_lp = generate(PROMPTS, live, max_tokens=12, temperature=0.0)
    spec, spec_lp = generate(PROMPTS, live, max_tokens=12, temperature=0.0, draft_model=d,
                             spec_tokens=3)
    assert spec == plain
    close(spec_lp, plain_lp)


def test_load_lora_refusals(tmp_path):
    """A quantized model without live pairs cannot merge; a Mamba takes no
    adapter; a file with other keys, or no file, is refused."""
    path = write(adapter(tiny_args()), tmp_path / "a.safetensors")
    with pytest.raises(ValueError, match="quantized"):
        load_lora(port(1).quantize("int8", group=32), path)
    mamba = Mamba.random(MambaArgs(dim=64, n_layers=1, vocab_size=256, n_groups=2, rms_norm=True,
                                   residual_in_fp32=True, fused_add_norm=True,
                                   pad_vocab_size_multiple=16, tie_embeddings=False,
                                   d_state=16, headdim=16), dtype=torch.float32, device="cpu")
    with pytest.raises(TypeError, match="Mamba"):
        load_lora(mamba, path)
    bad = write({"layers.0.attention.wq.weight": torch.zeros(2, 2)}, tmp_path / "b.safetensors")
    with pytest.raises(ValueError, match="not LoRA"):
        load_lora(port(1), bad)
    with pytest.raises(FileNotFoundError):
        load_lora(port(1), tmp_path / "missing.safetensors")
