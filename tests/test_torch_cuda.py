"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card with sm_90a and nvcc; without one they skip.
They import no JAX, so they run where the port runs:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances: the int8 ring bytes and scales that the fused decode kernel
writes are equal to the plain write; outputs agree within 1e-2 (bf16
outputs, fp32 sums in another order) and the fp32 stats within 1e-4.
``python3 chip_smoke.py`` runs the same comparisons at the model's shapes.
"""

import pytest
import torch

from mistral_inference_tpu_torch import cache as tcache
from mistral_inference_tpu_torch.ops.cuda import attention as tk


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Each CUDA kernel against its plain version on the card (bf16, the
    7B head shapes): ring bytes equal, outputs within bf16 rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    dev = "cuda"
    tk.reset_launch_counts()
    g = torch.Generator(device=dev).manual_seed(0)
    B, T, H, Hkv, D, L, S, window = 2, 70, 32, 8, 128, 2, 256, 200
    bf = torch.bfloat16
    q = torch.randn((B, T, H, D), generator=g, device=dev).to(bf)
    k = torch.randn((B, T, Hkv, D), generator=g, device=dev).to(bf)
    v = torch.randn((B, T, Hkv, D), generator=g, device=dev).to(bf)
    pos = torch.arange(T, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    valid = torch.ones((B, T), dtype=torch.bool, device=dev)
    o, m, l = tk.flash_attention(q, k, v, pos, pos, valid, valid, window, return_stats=True)
    ro, rm, rl = tk.attend_stats_plain(q, k, v, None, None, pos, pos, valid, valid, window)
    torch.testing.assert_close(o.float(), ro.float(), atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(m, rm, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(l, rl, atol=1e-4, rtol=1e-4)

    CK, KS = tcache._quantize_ring(torch.randn((L, B, S, Hkv, D), generator=g, device=dev))
    CV, VS = tcache._quantize_ring(torch.randn((L, B, S, Hkv, D), generator=g, device=dev))
    CK, CV = CK.reshape(L, B, S, -1), CV.reshape(L, B, S, -1)
    KS, VS = KS.transpose(2, 3).contiguous(), VS.transpose(2, 3).contiguous()
    kv_len = torch.tensor([230, 17], dtype=torch.int32, device=dev)
    slot_pos, slot_valid = tcache.slot_positions(kv_len, window, S)
    qp = kv_len[:, None] + pos
    o, m, l = tk.ring_attention_stats(q, CK[1], CV[1], KS[1], VS[1], qp, slot_pos, valid,
                                      slot_valid, window)
    ro, rm, rl = tk.attend_stats_plain(q, CK[1].view(B, S, Hkv, D), CV[1].view(B, S, Hkv, D),
                                       KS[1], VS[1], qp, slot_pos, valid, slot_valid, window)
    torch.testing.assert_close(o.float(), ro.float(), atol=1e-2, rtol=1e-2)

    new_total = kv_len + 1
    write_slot = (kv_len % window).to(torch.int32)
    slot_pos, slot_valid = tcache.slot_positions(new_total, window, S)
    xq, xk, xv = q[:, :1].contiguous(), k[:, :1].contiguous(), v[:, :1].contiguous()
    plain = [t.clone() for t in (CK, CV, KS, VS)]
    out = tk.fused_update_decode_attention(xq, xk, xv, CK, CV, KS, VS, 1, window, write_slot,
                                           kv_len, slot_pos, slot_valid)
    ref = tk.fused_update_decode_attention_plain(xq, xk, xv, *plain, 1, window, write_slot,
                                                 kv_len, slot_pos, slot_valid)
    for a, b in zip((CK, CV, KS, VS), plain):
        assert torch.equal(a, b)
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=1e-2)
    # Each wrapper counted its own launches, and the plain versions none.
    assert [fn.launches for fn in tk.KERNELS] == [1, 1, 1]


@pytest.mark.cuda
def test_wrappers_reject_bad_operands_on_card():
    """A CUDA kernel reads its operands through raw pointers, so the wrapper
    checks every shape first and launches nothing when one is wrong."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    dev, bf = "cuda", torch.bfloat16
    B, T, H, Hkv, D = 2, 8, 32, 8, 128
    q = torch.zeros((B, T, H, D), dtype=bf, device=dev)
    k = torch.zeros((B, T, Hkv, D), dtype=bf, device=dev)
    pos = torch.arange(T, dtype=torch.int32, device=dev)[None].repeat(B, 1)
    valid = torch.ones((B, T), dtype=torch.bool, device=dev)
    tk.reset_launch_counts()
    with pytest.raises(ValueError, match="kv_pos"):
        tk.flash_attention(q, k, k, pos, pos[:, :5], valid, valid, 16)
    with pytest.raises(TypeError, match="k must be"):
        tk.flash_attention(q, k.float(), k, pos, pos, valid, valid, 16)
    with pytest.raises(ValueError, match="q_valid"):
        tk.ring_attention_stats(q, k.view(B, T, -1), k.view(B, T, -1), None, None, pos, pos,
                                valid[:1], valid, 16)
    assert [fn.launches for fn in tk.KERNELS] == [0, 0, 0]
