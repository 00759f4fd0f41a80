"""The port's ``utils/chip.py`` (the card's published peaks) and the
row-stable dense products of the Mamba path (``ops.linear.fixed_rows_linear``
under ``dt_proj`` and the head), on the CPU.

* ``spec_for_device_name``: the H100's name, a longer name it prefixes, and
  an unknown card, which raises (there is no default entry).
* ``hbm_seconds`` / ``flop_seconds`` give the bounds ``chip_smoke.py`` gave
  with its constants: bytes / 3.35e12 and flops / 989e12 (bf16), / 67e12
  (fp32), in bits.
* A row of ``dt_proj``'s and the head's product alone has the bits it has
  among 4, 16 and 300 rows, at every place, in bf16 and fp32: the property
  that makes ``MambaEngine`` give ``generate_mamba``'s tokens on the card.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mistral_inference_tpu_torch.args import MambaArgs
from mistral_inference_tpu_torch.models import mamba as mm
from mistral_inference_tpu_torch.ops.linear import ROW_BLOCK, fixed_rows_linear
from mistral_inference_tpu_torch.utils import chip

H100 = "NVIDIA H100 80GB HBM3"
ROOT = Path(__file__).resolve().parents[1]


def test_h100_entry_is_the_data_sheet():
    spec = chip.spec_for_device_name(H100)
    assert (spec.bf16_tflops, spec.fp32_tflops, spec.fp8_tflops, spec.int8_tops) == (
        989.0, 67.0, 1979.0, 1979.0)
    assert (spec.hbm_gbps, spec.hbm_gb, spec.sm_count, spec.power_w) == (3350.0, 80.0, 132, 700.0)
    with pytest.raises(dataclasses.FrozenInstanceError):
        spec.hbm_gbps = 1.0


def test_longest_prefix_wins(monkeypatch):
    assert chip.spec_for_device_name(H100 + " (a longer name)") is chip.CHIP_SPECS[H100]
    other = dataclasses.replace(chip.CHIP_SPECS[H100], name="narrower")
    monkeypatch.setitem(chip.CHIP_SPECS, H100 + " X", other)
    assert chip.spec_for_device_name(H100 + " X1") is other
    assert chip.spec_for_device_name(H100 + " Y") is chip.CHIP_SPECS[H100]


@pytest.mark.parametrize("name", ["NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe", "", "TPU v5e"])
def test_unknown_card_raises(name):
    with pytest.raises(KeyError, match="no published peaks"):
        chip.spec_for_device_name(name)


def test_spec_for_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the lookup may succeed")
    with pytest.raises((RuntimeError, AssertionError)):
        chip.spec_for_device(0)


@pytest.mark.parametrize("x", [1.0, 3.0e6, 1234567.0, 8.589934592e9, 2.5e12])
def test_seconds_equal_the_constants_they_replace(x):
    """The bounds chip_smoke.py printed with PEAK_* constants, in bits."""
    spec = chip.spec_for_device_name(H100)
    assert spec.hbm_seconds(x) == x / 3.35e12
    assert spec.flop_seconds(x) == x / 989e12
    assert spec.flop_seconds(x, torch.bfloat16) == spec.flop_seconds(x, torch.float16)
    assert spec.flop_seconds(x, torch.float32) == x / 67e12
    assert spec.flop_seconds(x, torch.float8_e4m3fn) == x / 1979e12
    assert spec.flop_seconds(x, torch.int8) == x / 1979e12


def test_seconds_of_one_second_of_work():
    spec = chip.spec_for_device_name(H100)
    assert spec.hbm_seconds(3.35e12) == 1.0
    assert spec.flop_seconds(989e12) == 1.0
    with pytest.raises(ValueError, match="no published peak"):
        spec.flop_seconds(1.0, torch.int32)


def test_module_imports_without_a_card():
    """The module reads no device when imported."""
    out = subprocess.run([sys.executable, "-c", "import mistral_inference_tpu_torch.utils.chip"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


# ---------------------------------------------------------------------------
# Row-stable dense products
# ---------------------------------------------------------------------------

TINY = MambaArgs(dim=64, n_layers=1, vocab_size=250, n_groups=2, rms_norm=True,
                 residual_in_fp32=True, fused_add_norm=True, pad_vocab_size_multiple=16,
                 tie_embeddings=False, d_state=16, headdim=16)


def _product(which, dtype):
    """(the product on x (b, T, D), D): layer 0's ``dt_proj`` or the head."""
    params = mm.init_params(TINY, dtype, torch.Generator().manual_seed(3), torch.device("cpu"))
    if which == "dt_proj":
        return lambda x: fixed_rows_linear(x, params["layers"][0]["dt_proj"])
    return lambda x: mm.apply_head(x, params, TINY)


@pytest.mark.parametrize("which", ["dt_proj", "head"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [4, 16, 300])
def test_a_row_alone_has_its_bits_among_others(which, dtype, rows):
    """Every row of ``rows`` (as (rows, 1, D): decode steps; and as (1,
    rows, D): one prompt's tokens) against that row alone, in bits."""
    f = _product(which, dtype)
    x = torch.from_numpy(np.random.default_rng(rows).standard_normal((rows, TINY.dim))
                         .astype(np.float32)).to(dtype)
    steps, tokens = f(x[:, None]), f(x[None])[0]
    for i in range(rows):
        alone = f(x[i:i + 1, None])[0]
        assert torch.equal(steps[i], alone), (which, dtype, rows, i)
        assert torch.equal(tokens[i:i + 1], alone), (which, dtype, rows, i)


def test_fixed_rows_linear_is_f_linear_blockwise():
    """Values: F.linear's own, one block of ROW_BLOCK rows at a time, the
    pad rows cut off; any leading shape; no rows at all."""
    w = torch.randn(24, 40, dtype=torch.float64)
    for shape in [(1, 40), (ROW_BLOCK, 40), (ROW_BLOCK + 1, 40), (3, 7, 40), (0, 40)]:
        x = torch.randn(shape, dtype=torch.float64)
        out = fixed_rows_linear(x, w)
        assert out.shape == (*shape[:-1], 24)
        torch.testing.assert_close(out, x @ w.T, rtol=1e-12, atol=1e-12)
