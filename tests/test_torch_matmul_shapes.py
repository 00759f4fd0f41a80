"""The shapes the callers send to K3 against the kernel's shape rule.

``matmul_quant.shape_ok`` is K3's rule in pure Python (K8's: 1-256 rows, N
a multiple of 128, a group of 16 or 32 steps or a multiple of 64, K a
multiple of 64, int4 of 128 with an even group count), checked by the
wrappers before every launch: on the card a shape outside it raises.
``ops/linear.linear`` routes a product to K3 by its rows, N and K alone, as
the JAX package routes to its Pallas kernel, so here, without a card, every
preset of ``models/registry.py`` (dense, MoE, Mamba, the Pixtral decoder) is
held to the rule: each quantized linear at every row count ``linear`` sends
to K3. So a refusal cannot first show on the card as an exception. The
shapes come from the presets' widths (``test_torch_moe_shapes.py`` checks
that formula against a quantized tree's leaves).
"""

import numpy as np
import pytest
import torch

from mistral_inference_tpu_torch.models.registry import REGISTRY
from mistral_inference_tpu_torch.ops import linear as tlin
from mistral_inference_tpu_torch.ops.cuda import matmul_quant as mq
from mistral_inference_tpu_torch.ops.cuda import moe_matmul as mm
from test_torch_moe_shapes import _linears

GROUP = tlin.DEFAULT_GROUP


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_preset_linears_are_taken_by_k3(name, bits):
    args = REGISTRY[name]
    for leaf, (K, N) in _linears(args).items():
        assert K % 128 == 0 and N % 128 == 0, f"{name}.{leaf} {K}x{N} leaves the K3 band"
        for rows in range(1, tlin.DECODE_ROWS_MAX + 1):
            assert mq.shape_ok(rows, K, N, K // GROUP, bits), (
                f"K3 refuses {name}.{leaf} {K}x{N} int{bits} at {rows} rows")


def test_decode_band_is_the_kernels():
    assert tlin.DECODE_ROWS_MAX == mq.ROWS_MAX


@pytest.mark.parametrize("shape,taken", [
    ((4, 512, 256, 4, 4), True),       # a decode step, int4
    ((256, 512, 256, 4, 8), True),     # the most rows, int8
    ((4, 256, 128, 16, 8), True),      # group of 16
    ((4, 512, 256, 16, 4), True),      # group of 32, int4
    ((4, 1024, 128, 4, 4), True),      # group of 256
    ((4, 384, 128, 3, 4), False),      # an odd int4 group count: a group straddles the halves
    ((4, 192, 128, 4, 8), False),      # group of 48: neither divides the stage nor a multiple
    ((0, 512, 256, 4, 4), False),      # no rows
    ((257, 512, 256, 4, 4), False),    # past the decode band
    ((4, 512, 192, 4, 4), False),      # N not a multiple of 128
    ((4, 256, 128, 32, 8), False),     # group of 8
    ((4, 192, 128, 2, 4), False),      # int4 K not a multiple of 128
    ((4, 96, 128, 1, 8), False),       # int8 K not a multiple of 64
    ((4, 512, 256, 3, 8), False),      # groups that do not divide K
    ((4, 512, 256, 4, 5), False),      # no such width
])
def test_shape_rule_refuses_what_the_kernel_refuses(shape, taken):
    assert mq.shape_ok(*shape) == taken


def test_k3_and_k8_share_the_weight_rule():
    """One loop, one rule: K8 takes a weight at C rows where K3 does."""
    for K, N, ng, bits in ((512, 256, 4, 4), (384, 128, 3, 4), (192, 128, 4, 8), (256, 128, 16, 8),
                           (4096, 14336, 32, 4), (14336, 4096, 896, 8)):
        for C in (1, 4, 128):
            assert mm.expert_shape_ok(C, K, N, ng, bits) == mq.shape_ok(C, K, N, ng, bits)


@pytest.mark.parametrize("bits", [4, 8])
def test_linear_sends_decode_rows_to_k3_by_rows_n_and_k(monkeypatch, bits):
    """``linear`` routes up to 256 rows to K3 by rows, N and K alone, as the
    JAX package does: a group K3 does not take (8 steps) reaches its wrapper,
    which on the card raises and here runs the plain version."""
    rng = np.random.default_rng(bits)
    w = torch.from_numpy(rng.standard_normal((256, 128)).astype(np.float32) * 0.1)
    x = torch.from_numpy(rng.standard_normal((4, 256)).astype(np.float32))
    leaf = tlin.quantize_weight(w, bits, group=8)
    assert not mq.shape_ok(4, 256, 128, 32, bits)
    calls = []

    def recorded(*args):
        calls.append(args)
        return mq.matmul_quant(*args)

    monkeypatch.setattr(tlin, "matmul_quant", recorded)
    out = tlin.linear(x, leaf)
    assert len(calls) == 1
    q = leaf["q4"] if bits == 4 else leaf["q"]
    torch.testing.assert_close(out, mq.matmul_quant_plain(x, q, leaf["scale"]), atol=0, rtol=0)
