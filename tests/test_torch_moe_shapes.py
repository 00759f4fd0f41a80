"""The shapes the callers send to K5 and K8 against the kernels' shape rules.

``moe_matmul.ragged_shape_ok`` (K5) and ``moe_matmul.expert_shape_ok`` (K8)
are the kernels' rules in pure Python, checked by the wrappers before every
launch. Here, without a card, every preset of ``models/registry.py`` (dense,
MoE, Mamba, the Pixtral decoder) is held to them: each quantized linear at
the row counts ``ops/linear.linear`` sends to K5, each expert stack at the
sorted rows ``_moe_ffn_ragged`` sends to K5 and at every capacity
``_expert_mm`` sends to K8. So a refusal cannot first show on the card as an
exception. The shapes come from the presets' widths; a small model's
quantized tree checks that formula against the leaves it really has.
"""

import pytest
import torch

from mistral_inference_tpu_torch.args import MambaArgs, MoeArgs, TransformerArgs
from mistral_inference_tpu_torch.models import mamba as tmamba
from mistral_inference_tpu_torch.models import transformer as ttf
from mistral_inference_tpu_torch.models.registry import REGISTRY
from mistral_inference_tpu_torch.ops import linear as tlin
from mistral_inference_tpu_torch.ops.cuda import moe_matmul as mm

GROUP = tlin.DEFAULT_GROUP
TM = ttf.MOE_RAGGED_TM  # the sorted MoE rows' tile
LTM = tlin.PREFILL_TILE_ROWS  # a dense linear's


def _linears(args):
    """{leaf: (K, N)} of a layer's quantized linears, applied as x @ w."""
    if isinstance(args, MambaArgs):
        gd = args.n_groups * args.d_state
        return {"in_proj": (args.dim, 2 * args.d_inner + 2 * gd),
                "out_proj": (args.d_inner, args.dim)}
    D, F, Dh = args.dim, args.hidden_dim, args.head_dim
    out = {"wqkv": (D, (args.n_heads + 2 * args.n_kv_heads) * Dh), "wo": (args.n_heads * Dh, D)}
    if args.moe is None:
        out.update(w13=(D, 2 * F), w2=(F, D))
    return out


def _experts(args):
    """{stack: (K, N)} of a MoE layer's expert stacks; {} for a dense layer."""
    if isinstance(args, MambaArgs) or args.moe is None:
        return {}
    return {"w13": (args.dim, 2 * args.hidden_dim), "w2": (args.hidden_dim, args.dim)}


# The row counts of the K5 band of ``linear``: more than the decode band,
# fewer than the dequantizing band, whole row tiles.
LINEAR_ROWS = (
    tlin.DECODE_ROWS_MAX + LTM, 2 * LTM, 2048, 4 * 512,
    (tlin.DEQUANT_ROWS_MIN - 1) // LTM * LTM,
)


def _k5_band(rows: int, K: int, N: int) -> bool:
    """Whether ``linear`` sends this product to K5."""
    return (tlin.DECODE_ROWS_MAX < rows < tlin.DEQUANT_ROWS_MIN and rows % LTM == 0
            and N % 128 == 0 and K % 256 == 0)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_preset_linears_are_taken_by_k5(name, bits):
    args = REGISTRY[name]
    for leaf, (K, N) in _linears(args).items():
        for rows in LINEAR_ROWS:
            assert _k5_band(rows, K, N), f"{name}.{leaf} {K}x{N} leaves the K5 band at {rows} rows"
            assert mm.ragged_shape_ok(rows, rows // LTM, K, N, K // GROUP, bits), (
                f"K5 refuses {name}.{leaf} {K}x{N} int{bits} at {rows} rows")


MOE_PRESETS = sorted(n for n, a in REGISTRY.items() if _experts(a))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("name", MOE_PRESETS)
def test_preset_experts_are_taken_by_k5_and_k8(name, bits):
    args = REGISTRY[name]
    E, k = args.moe.num_experts, args.moe.num_experts_per_tok
    for stack, (K, N) in _experts(args).items():
        assert K % 256 == 0 and N % 128 == 0, f"{name}.{stack} leaves the kernels' gates"
        # _moe_ffn_ragged: the worst-case sorted buffer, whole tiles of TM.
        for rows in (ttf.MOE_RAGGED_ROWS + 1, 4 * 512, 8 * 512):
            Mp = (-(-rows * k // TM) + E) * TM
            assert mm.ragged_shape_ok(Mp, Mp // TM, K, N, K // GROUP, bits), (
                f"K5 refuses {name}.{stack} int{bits} over {Mp} sorted rows")
        # _moe_ffn_dispatch: every capacity up to the K8 gate.
        for C in range(1, ttf.MOE_EXPERT_ROWS_MAX + 1):
            assert mm.expert_shape_ok(C, K, N, K // GROUP, bits), (
                f"K8 refuses {name}.{stack} int{bits} at C={C}")


def test_moe_presets_found():
    assert {"mixtral-8x7b", "mixtral-8x22b"} <= set(MOE_PRESETS)
    assert ttf.MOE_EXPERT_ROWS_MAX == mm.EXPERT_ROWS_MAX


@pytest.mark.parametrize("rule,shape", [
    ("ragged", (256, 1, 256, 192, 2, 8)),     # N not a multiple of 128
    ("ragged", (256, 4, 256, 128, 2, 8)),     # row tiles of 64
    ("ragged", (256, 1, 192, 128, 4, 8)),     # group of 48
    ("ragged", (256, 1, 192, 128, 3, 4)),     # int4 halves not whole 64-step stages
    ("ragged", (250, 1, 256, 128, 2, 8)),     # rows not whole tiles
    ("ragged", (256, 1, 256, 128, 2, 5)),     # no such width
    ("expert", (129, 256, 128, 2, 4)),        # more rows than the kernel holds
    ("expert", (4, 384, 128, 3, 4)),          # odd group count, int4
    ("expert", (4, 256, 64, 2, 8)),           # N not a multiple of 128
    ("expert", (4, 256, 128, 16, 8)),         # group of 16: taken
    ("expert", (4, 320, 128, 4, 8)),          # group of 80
])
def test_shape_rules_refuse_what_the_kernels_refuse(rule, shape):
    taken = {"ragged": mm.ragged_shape_ok, "expert": mm.expert_shape_ok}[rule](*shape)
    assert taken == (shape == (4, 256, 128, 16, 8))


@pytest.mark.parametrize("kind", ["dense", "moe", "mamba"])
def test_shape_formula_matches_a_quantized_tree(kind):
    """The widths above are the leaves' own: a small model's quantized tree
    has a (K, N) for each leaf named, stored as (K or K / 2, N)."""
    gen = torch.Generator().manual_seed(0)
    if kind == "mamba":
        args = MambaArgs(dim=64, n_layers=1, vocab_size=256, n_groups=2, rms_norm=True,
                         residual_in_fp32=True, fused_add_norm=True,
                         pad_vocab_size_multiple=16, tie_embeddings=False, d_state=16,
                         headdim=16)
        params = tmamba.init_params(args, torch.float32, gen, torch.device("cpu"), quant="int4",
                                    group=32)
    else:
        args = TransformerArgs(dim=256, n_layers=1, head_dim=64, hidden_dim=512, n_heads=4,
                               n_kv_heads=2, norm_eps=1e-5, vocab_size=128,
                               moe=MoeArgs(4, 2) if kind == "moe" else None)
        params = ttf.init_params(args, torch.float32, gen, torch.device("cpu"), quant="int4")
    layer = params["layers"][0]
    shapes = {**_linears(args), **_experts(args)}
    assert shapes and set(shapes) <= set(layer)
    for leaf, (K, N) in shapes.items():
        assert tlin.is_quantized(layer[leaf])
        assert tuple(layer[leaf]["q4"].shape[-2:]) == (K // 2, N), leaf
        assert layer[leaf]["scale"].shape[-1] == N, leaf
