"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card with sm_90a and nvcc; without one they skip.
They import no JAX, so they run where the port runs:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances: the int8 and float8_e4m3fn ring bytes and scales that the fused
decode and fused verify kernels write are equal to the plain write, a verify chunk's query
t has the bits of a decode step at its position, a decode step the bits of K6
over the ring it has written, and a row alone its bits in the batch (also
where a write falls on the edge of a warp's part or a cluster slice, at 32
query rows and at 8 query heads per KV head); outputs agree within 1e-2 (bf16
outputs, fp32 sums in another order) and the fp32 stats within 1e-4. The
quantized matmuls are held to the same 1e-2 + 1e-2 |ref|, and the stacked and
repeated launches of K3 and K8 to equal bits. K9's new state has the bits of
its plain version (fp32 and bf16) and y agrees within 1e-5 (fp32 sums in
another order). K10, the vision encoder's segment-masked attention, is held
to 1e-2 + 1e-2 |ref| at the five shapes ``chip_smoke.py`` checks. K4 is held
to the same tolerances over int8, fp8 and bf16 rings where its tiles are
full, mixed (the wrap, a window's edge, invalid slots) and ragged, and K4
and K10 to equal bits for a row alone and the same row in a batch. K1 is
held to the same at causal-diagonal and ragged shapes, and K6 over int8,
fp8 and bf16 rings with holes, wrapped rows, fills that end inside a cluster
slice and windows shorter than the fill; both give a row alone the bits it
has in a batch.
``python3 chip_smoke.py`` runs the same comparisons at the model's shapes.
"""

import pytest
import torch

from mistral_inference_tpu_torch import cache as tcache
from mistral_inference_tpu_torch.ops import cuda as cuda_ops
from mistral_inference_tpu_torch.ops.cuda import attention as tk
from mistral_inference_tpu_torch.ops.linear import linear


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Each CUDA kernel against its plain version on the card (bf16, the
    7B head shapes): ring bytes equal, outputs within bf16 rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    dev = "cuda"
    cuda_ops.reset_launch_counts()
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

    i8 = torch.int8
    CK, KS = tcache._quantize_ring(torch.randn((L, B, S, Hkv, D), generator=g, device=dev), i8)
    CV, VS = tcache._quantize_ring(torch.randn((L, B, S, Hkv, D), generator=g, device=dev), i8)
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
    assert [fn.launches for fn in tk.KERNELS] == [1, 1, 1, 0, 0, 0, 0, 0, 0, 0]


def _same_bits(a, b):
    """Equal bits, element for element (not equal values: -0 is not 0)."""
    width = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    a, b = a.contiguous(), b.contiguous()
    return a.dtype == b.dtype and torch.equal(a.view(width), b.view(width))


def _ring_case(g, ring, B, T, S, window, kv_len, holes=False, H=32, Hkv=8, D=128):
    """One layer's stored ring (int8, fp8 or bf16) and a chunk of T queries
    after it; the last row's second half of queries invalid; with ``holes``,
    invalid slots inside otherwise full tiles."""
    x = torch.randn((B, S, Hkv, D), generator=g, device="cuda")
    y = torch.randn((B, S, Hkv, D), generator=g, device="cuda")
    if ring == "bf16":
        kq, vq, ks, vs = x.to(torch.bfloat16), y.to(torch.bfloat16), None, None
    else:
        dt = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[ring]
        (kq, ks), (vq, vs) = tcache._quantize_ring(x, dt), tcache._quantize_ring(y, dt)
        ks, vs = ks.transpose(1, 2).contiguous(), vs.transpose(1, 2).contiguous()
    kv_len = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    slot_pos, slot_valid = tcache.slot_positions(kv_len, window, S)
    if holes:
        slot_valid = slot_valid.clone()
        slot_valid[:, 100:140] = False
        slot_valid[:, 7::509] = False
    q_pos = kv_len[:, None] + torch.arange(T, dtype=torch.int32, device="cuda")[None]
    q_valid = torch.ones((B, T), dtype=torch.bool, device="cuda")
    q_valid[-1, T // 2:] = False
    q = torch.randn((B, T, H, D), generator=g, device="cuda").to(torch.bfloat16)
    return (q, kq.reshape(B, S, Hkv * D), vq.reshape(B, S, Hkv * D), ks, vs, q_pos, slot_pos,
            q_valid, slot_valid, window)


@pytest.mark.cuda
@pytest.mark.parametrize("ring", ["int8", "fp8", "bf16"])
@pytest.mark.parametrize("T,window,kv_len,holes", [
    (256, 1024, [1024 + 300, 700], False),   # wrapped: mixed tiles at the wrap
    (256, 300, [900, 1024 + 50], False),     # mixed tiles at the window's edge
    (256, 1024, [1024 + 10, 800], True),     # invalid slots inside tiles
    (200, 1024, [1024 + 500, 333], False),   # a ragged last query tile
], ids=["wrapped", "window-300", "invalid-slots", "T-200"])
def test_ring_attention_tile_classes_on_card(ring, T, window, kv_len, holes):
    """K4 against its plain version where its tiles are full, mixed and
    skipped, over every ring type: outputs within bf16 rounding, stats 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    g = torch.Generator(device="cuda").manual_seed(3)
    B, S, Hkv, D = 2, 1024, 8, 128
    case = _ring_case(g, ring, B, T, S, window, kv_len, holes)
    q, kq, vq, ks, vs = case[:5]
    o, m, l = tk.ring_attention_stats(*case)
    ro, rm, rl = tk.attend_stats_plain(q, kq.view(B, S, Hkv, D), vq.view(B, S, Hkv, D), ks, vs,
                                       *case[5:])
    vis = case[7][..., None, None]
    torch.testing.assert_close((o * vis).float(), (ro * vis).float(), **BF16_TOL)
    torch.testing.assert_close(m, rm, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(l, rl, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("ring", ["int8", "fp8", "bf16"])
def test_ring_attention_batch_invariant_on_card(ring):
    """A row's K4 (out, m, l) bits alone equal its bits among 8 rows: one
    block computes a row from its own tiles in a fixed order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    g = torch.Generator(device="cuda").manual_seed(4)
    lens = [1024 + 300, 700, 1024 + 1000, 64, 1000, 2000, 5, 1024]
    wide = _ring_case(g, ring, 8, 256, 1024, 1024, lens)
    for row in (0, 2, 7):
        one = tuple(x[row:row + 1].contiguous() if torch.is_tensor(x) else x for x in wide)
        for a, b in zip(tk.ring_attention_stats(*wide), tk.ring_attention_stats(*one)):
            assert _same_bits(a[row:row + 1], b)


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
    cuda_ops.reset_launch_counts()
    with pytest.raises(ValueError, match="kv_pos"):
        tk.flash_attention(q, k, k, pos, pos[:, :5], valid, valid, 16)
    with pytest.raises(TypeError, match="k must be"):
        tk.flash_attention(q, k.float(), k, pos, pos, valid, valid, 16)
    with pytest.raises(ValueError, match="q_valid"):
        tk.ring_attention_stats(q, k.view(B, T, -1), k.view(B, T, -1), None, None, pos, pos,
                                valid[:1], valid, 16)
    with pytest.raises(TypeError, match="x must be"):
        linear(torch.zeros((4, 256), device=dev), {
            "q": torch.zeros((256, 128), dtype=torch.int8, device=dev),
            "scale": torch.ones((2, 128), device=dev)})
    vq = torch.zeros((1, 64, 16, 64), dtype=bf, device=dev)
    seg = torch.zeros((1, 64), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head_dim 64"):
        tk.segment_flash_attention(q, q, q, pos)
    with pytest.raises(TypeError, match="v must be"):
        tk.segment_flash_attention(vq, vq, vq.float(), seg)
    with pytest.raises(ValueError, match="seg"):
        tk.segment_flash_attention(vq, vq, vq, seg[:, :60])
    with pytest.raises(ValueError, match="contiguous"):
        tk.segment_flash_attention(vq, vq.transpose(1, 2).contiguous().transpose(1, 2), vq, seg)
    assert len(cuda_ops.all_kernels()) == 14
    assert all(fn.launches == 0 for fn in cuda_ops.all_kernels())


def _quantized(g, K, N, bits, group, lead=()):
    from mistral_inference_tpu_torch.ops.linear import quantize_weight

    w = torch.randn((*lead, K, N), generator=g, device="cuda") * 0.05
    qw = quantize_weight(w, bits, group)
    return qw["q4" if bits == 4 else "q"], qw["scale"]


# bf16 outputs of fp32 sums taken in another order: one bf16 ulp of the result.
BF16_TOL = dict(atol=1e-2, rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,M,K,N,group", [
    (8, 4, 512, 256, 128),
    (4, 4, 512, 256, 128),
    (8, 1, 512, 256, 64),
    (4, 2, 128, 256, 32),     # K / 2 = 64 stored rows, group < 128
    (8, 256, 1024, 384, 128),  # the most rows the decode band sends
    (4, 37, 2048, 512, 128),  # rows that do not fill the last n-tile
    (4, 201, 1024, 256, 128),  # a second row block whose last n-tile is not full
    (8, 131, 512, 128, 64),   # the same in int8
    (4, 4, 4096, 18432, 128),  # codestral-mamba-7b's in_proj (a 128-column panel)
    (4, 4, 8192, 4096, 128),  # and its out_proj
    (8, 4, 14336, 256, 16),   # 112 groups a block: scales read as each unit starts, not staged
    (4, 4, 14336, 256, 16),   # the same in int4 (56 pairs of groups a block)
    (8, 20, 1024, 256, 256),  # three n-tiles a warp; a group of four stages
])
def test_matmul_quant_matches_plain_on_card(bits, M, K, N, group):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    from mistral_inference_tpu_torch.ops.cuda import matmul_quant as mq

    g = torch.Generator(device="cuda").manual_seed(bits + K + N)
    L = 3
    q, scale = _quantized(g, K, N, bits, group, lead=(L,))
    x = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
    before = mq.matmul_quant.launches
    for li in (0, 2):
        ref = mq.matmul_quant_plain(x, q[li], scale[li])
        out = mq.matmul_quant(x, q[li].contiguous(), scale[li].contiguous())
        stacked = mq.matmul_quant_stacked(x, q, scale, li)
        again = mq.matmul_quant_stacked(x, q, scale, li)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
        assert torch.equal(out, stacked), "the stacked form is the same kernel on an offset"
        assert torch.equal(stacked, again), "no atomics: the same bits on every run"
    assert mq.matmul_quant.launches == before + 6


@pytest.mark.cuda
@pytest.mark.parametrize("bits,K,N,group", [
    (4, 4096, 4096, 128),   # wo of a 7B layer: 64-column panels, eight splits
    (4, 4096, 28672, 128),  # w13: 128-column panels
    (8, 14336, 4096, 128),  # w2 in int8
    (8, 14336, 256, 16),    # scales not staged
])
def test_matmul_quant_row_bits_do_not_follow_the_row_count_on_card(bits, K, N, group):
    """K3's split follows the shape alone, so the first four rows have the
    bits of a 4-row launch among 8, 20, 32, 128 and 256 rows (the decode
    step, the engine's batch, a verify forward, a prefill chunk)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    from mistral_inference_tpu_torch.ops.cuda import matmul_quant as mq

    g = torch.Generator(device="cuda").manual_seed(bits + K + N)
    q, scale = _quantized(g, K, N, bits, group)
    x = torch.randn((256, K), generator=g, device="cuda").to(torch.bfloat16)
    four = mq.matmul_quant(x[:4].contiguous(), q, scale)
    for rows in (8, 20, 32, 128, 256):
        many = mq.matmul_quant(x[:rows].contiguous(), q, scale)
        torch.cuda.synchronize()
        assert torch.equal(many[:4], four), f"rows 0-3 differ among {rows} rows"
        if rows == 256:
            ref = mq.matmul_quant_plain(x, q, scale)
            torch.testing.assert_close(many.float(), ref.float(), **BF16_TOL)


@pytest.mark.cuda
def test_matmul_quant_rejects_bad_shapes_on_card():
    """K3's wrapper refuses the shapes its kernel does not take (N not a
    multiple of 128, a group of 8 or 48, more than 256 rows, K not a
    multiple of 128 in int4, an odd int4 group count) and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    from mistral_inference_tpu_torch.ops.cuda import matmul_quant as mq

    g = torch.Generator(device="cuda").manual_seed(0)
    before = mq.matmul_quant.launches
    for bits, rows, K, N, group in ((8, 4, 256, 192, 128), (8, 4, 256, 128, 8),
                                    (8, 257, 256, 128, 128), (4, 4, 192, 128, 64),
                                    (4, 3, 384, 128, 128), (8, 4, 192, 128, 48)):
        q, scale = _quantized(g, K, N, bits, group)
        x = torch.zeros((rows, K), dtype=torch.bfloat16, device="cuda")
        with pytest.raises(ValueError, match="1-256 rows"):
            mq.matmul_quant(x, q, scale)
        assert not mq.shape_ok(rows, K, N, K // group, bits)
    assert mq.matmul_quant.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
def test_linear_raises_on_a_group_k3_refuses_on_card(bits):
    """``linear`` sends up to 256 rows to K3 by rows, N and K, as the JAX
    package does; on the card a group K3 does not take raises, and no plain
    product stands in for the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    from mistral_inference_tpu_torch.ops.cuda import matmul_quant as mq
    from mistral_inference_tpu_torch.ops.linear import quantize_weight

    g = torch.Generator(device="cuda").manual_seed(bits)
    leaf = quantize_weight(torch.randn((256, 128), generator=g, device="cuda"), bits, 8)
    x = torch.randn((4, 256), generator=g, device="cuda").to(torch.bfloat16)
    before = mq.matmul_quant.launches
    with pytest.raises(ValueError, match="1-256 rows"):
        linear(x, leaf)
    assert mq.matmul_quant.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("E,n_tiles,TM,K,N,group,stacked", [
    (1, 2, 256, 512, 256, 128, False),    # the dense prefill case
    (3, 4, 128, 512, 256, 64, False),     # mixed tile_group
    (3, 3, 128, 256, 128, 32, True),      # (L, E, ...) stack with a layer index
    (1, 8, 256, 4096, 6144, 128, False),  # 2048 rows of a real layer's wqkv
    (2, 2, 256, 14336, 256, 128, False),  # the w2 reduction of a 7B layer
])
def test_moe_matmul_ragged_matches_plain_on_card(bits, E, n_tiles, TM, K, N, group, stacked):
    """K5 against its plain version; its first tile launched alone has the
    bits it has inside the whole launch (no sum depends on the row count or
    the other tiles), and a second launch the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    from mistral_inference_tpu_torch.ops.cuda import moe_matmul as mm

    g = torch.Generator(device="cuda").manual_seed(bits + E + K)
    lead = (2, E) if stacked else (E,)
    q, scale = _quantized(g, K, N, bits, group, lead=lead)
    x = torch.randn((n_tiles * TM, K), generator=g, device="cuda").to(torch.bfloat16)
    tg = torch.tensor([(3 * t + 1) % E for t in range(n_tiles)], dtype=torch.int32, device="cuda")
    li = 1 if stacked else None
    before = mm.moe_matmul_quant_ragged.launches
    out = mm.moe_matmul_quant_ragged(x, q, scale, tg, li)
    ref = mm.moe_matmul_quant_ragged_plain(x, q, scale, tg, li)
    alone = mm.moe_matmul_quant_ragged(x[:TM].contiguous(), q, scale, tg[:1].contiguous(), li)
    again = mm.moe_matmul_quant_ragged(x, q, scale, tg, li)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
    assert torch.equal(alone, out[:TM]), "a tile's bits do not depend on the other tiles"
    assert torch.equal(again, out), "no atomics: the same bits on every run"
    assert mm.moe_matmul_quant_ragged.launches == before + 3


@pytest.mark.cuda
def test_moe_matmul_ragged_rejects_bad_shapes_on_card():
    """K5's wrapper refuses the shapes its kernel does not take (N not a
    multiple of 128, row tiles not of 128, a group that is not 16, 32 or a
    multiple of 64) and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    from mistral_inference_tpu_torch.ops.cuda import moe_matmul as mm

    g = torch.Generator(device="cuda").manual_seed(0)
    tg = torch.zeros((2,), dtype=torch.int32, device="cuda")
    before = mm.moe_matmul_quant_ragged.launches
    for rows, K, N, group in ((256, 256, 192, 128), (128, 256, 128, 128), (256, 192, 128, 48)):
        q, scale = _quantized(g, K, N, 8, group, lead=(1,))
        x = torch.zeros((rows, K), dtype=torch.bfloat16, device="cuda")
        with pytest.raises(ValueError, match="row tiles"):
            mm.moe_matmul_quant_ragged(x, q, scale, tg)
    assert mm.moe_matmul_quant_ragged.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("bits,E,C,K,N,group", [
    (8, 4, 8, 256, 512, 128),
    (4, 4, 8, 256, 512, 128),
    (8, 2, 16, 512, 256, 64),
    (4, 8, 4, 2048, 384, 128),   # a split reduction: a cluster of two blocks
    (4, 3, 5, 512, 128, 128),    # rows that do not fill an n-tile
    (4, 2, 128, 512, 256, 128),  # the largest capacity the dispatch gate sends
    (4, 8, 4, 14336, 256, 128),  # the w2 reduction of a Mixtral layer: seven splits
    (8, 3, 40, 1024, 256, 32),   # two row groups a block, groups under a stage
    (8, 3, 20, 512, 256, 64),    # three n-tiles a warp
    (4, 2, 4, 14336, 256, 16),   # scales read as each unit starts, not staged
])
def test_moe_matmul_quant_matches_plain_on_card(bits, E, C, K, N, group):
    """K8 against its plain version: every expert on its own weight, empty
    capacity slots (zero rows, which the kernel skips) giving zeros, the
    stacked form the same kernel on an offset, one count per launch; each
    row has the bits it has among 128 rows of its expert."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    from mistral_inference_tpu_torch.ops.cuda import moe_matmul as mm

    g = torch.Generator(device="cuda").manual_seed(bits + E + K)
    L = 2
    q, scale = _quantized(g, K, N, bits, group, lead=(L, E))
    x = torch.randn((E, C, K), generator=g, device="cuda").to(torch.bfloat16)
    x[0, C // 2:] = 0  # a half-filled expert
    x[-1] = 0  # an expert with no row at all
    wide = torch.randn((E, 128, K), generator=g, device="cuda").to(torch.bfloat16)
    wide[:, :C] = x
    before = mm.moe_matmul_quant.launches
    for li in (0, 1):
        ref = mm.moe_matmul_quant_plain(x, q[li], scale[li])
        out = mm.moe_matmul_quant(x, q[li].contiguous(), scale[li].contiguous())
        stacked = mm.moe_matmul_quant_stacked(x, q, scale, li)
        again = mm.moe_matmul_quant_stacked(x, q, scale, li)
        among = mm.moe_matmul_quant_stacked(wide, q, scale, li)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
        assert not bool(out[-1].any()) and not bool(out[0, C // 2:].any())
        assert torch.equal(out, stacked), "the stacked form is the same kernel on an offset"
        assert torch.equal(stacked, again), "no atomics: the same bits on every run"
        assert torch.equal(among[:, :C], out), "a row's bits do not depend on the capacity"
    assert mm.moe_matmul_quant.launches == before + 8


@pytest.mark.cuda
def test_moe_matmul_quant_rejects_bad_operands_on_card():
    """K8's wrapper refuses wrong dtypes, devices, shapes and non-contiguous
    operands, as K5's does, and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    from mistral_inference_tpu_torch.ops.cuda import moe_matmul as mm

    g = torch.Generator(device="cuda").manual_seed(0)
    E, C, K, N = 2, 4, 256, 128
    q, scale = _quantized(g, K, N, 8, 128, lead=(E,))
    x = torch.zeros((E, C, K), dtype=torch.bfloat16, device="cuda")
    before = mm.moe_matmul_quant.launches
    with pytest.raises(TypeError, match="x must be"):
        mm.moe_matmul_quant(x.float(), q, scale)
    with pytest.raises(TypeError, match="q must be"):
        mm.moe_matmul_quant(x, q.to(torch.int16), scale)
    with pytest.raises(ValueError, match="scale is on"):
        mm.moe_matmul_quant(x, q, scale.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        mm.moe_matmul_quant(x.transpose(0, 1).contiguous().transpose(0, 1), q, scale)
    with pytest.raises(ValueError, match="q must have shape"):
        mm.moe_matmul_quant(x, q[:1], scale)
    with pytest.raises(ValueError, match="N % 128"):
        mm.moe_matmul_quant(x, q[..., :64].contiguous(), scale[..., :64].contiguous())
    with pytest.raises(ValueError, match="out of range"):
        mm.moe_matmul_quant_stacked(x, q[None], scale[None], 1)
    with pytest.raises(ValueError, match="takes x"):
        mm.moe_matmul_quant(x, q[None], scale[None])
    assert mm.moe_matmul_quant.launches == before


def _decode_case(g, ring, kv_len, window, L=3, B=None, S=1024, H=32, Hkv=8, D=128):
    """A stacked ring (L layers, int8, fp8 or bf16) after a decode step's
    write, the rows filled to ``kv_len`` (a fill past S wraps), holes in
    kv_valid, and one query per row at its position."""
    B = len(kv_len)
    kf = torch.randn((L, B, S, Hkv, D), generator=g, device="cuda")
    vf = torch.randn((L, B, S, Hkv, D), generator=g, device="cuda")
    if ring == "bf16":
        CK, CV, KS, VS = kf.to(torch.bfloat16), vf.to(torch.bfloat16), None, None
    else:
        dt = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[ring]
        (CK, KS), (CV, VS) = tcache._quantize_ring(kf, dt), tcache._quantize_ring(vf, dt)
        KS, VS = KS.transpose(2, 3).contiguous(), VS.transpose(2, 3).contiguous()
    CK, CV = CK.reshape(L, B, S, -1), CV.reshape(L, B, S, -1)
    kv_len = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    slot_pos, slot_valid = tcache.slot_positions(kv_len, S, S)
    slot_valid = slot_valid & (torch.rand((B, S), generator=g, device="cuda") > 0.1)
    q = torch.randn((B, 1, H, D), generator=g, device="cuda").to(torch.bfloat16)
    return q, CK, CV, KS, VS, L - 2, (kv_len - 1)[:, None].contiguous(), slot_pos, slot_valid, window


@pytest.mark.cuda
@pytest.mark.parametrize("ring", ["int8", "fp8", "bf16"])
@pytest.mark.parametrize("kv_len,window", [
    ([1100, 1030], 1021),        # wrapped rows, a window shorter than the ring
    ([129, 1000], 1024),         # fills that end inside a cluster slice and a step
    ([1024 + 500, 64], 300),     # a window far shorter than the fill
    ([1, 1024], 1024),           # one visible slot; a full ring
], ids=["wrapped", "slice-boundary", "window-300", "edges"])
def test_decode_attention_matches_plain_on_card(ring, kv_len, window):
    """K6 over a stored ring with holes (kv_valid), wrapped rows and windows
    shorter than the fill, which the fused kernel's fill rule would not
    cover, over every ring type: within bf16 rounding, the ring unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    g = torch.Generator(device="cuda").manual_seed(5)
    case = _decode_case(g, ring, kv_len, window)
    before = tk.decode_attention.launches
    rings = [None if t is None else t.clone() for t in case[1:5]]
    out = tk.decode_attention(*case)
    ref = tk.decode_attention_plain(*case)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
    for a, b in zip(case[1:5], rings):
        assert a is None or _same_bits(a, b), "decode_attention must not write the ring"
    assert tk.decode_attention.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("H", [48, 64])
def test_decode_attention_wide_groups_on_card(H):
    """K6 at 6 and 8 query heads per KV head (its second instantiation)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    g = torch.Generator(device="cuda").manual_seed(9)
    for ring in ("int8", "fp8", "bf16"):
        case = _decode_case(g, ring, [1100, 129, 700], 1000, H=H)
        out = tk.decode_attention(*case)
        ref = tk.decode_attention_plain(*case)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("ring", ["int8", "fp8", "bf16"])
def test_decode_attention_batch_invariant_on_card(ring):
    """A row's K6 bits alone equal its bits among 6 rows: its cluster sums
    its own visible slots in an order fixed by S alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    g = torch.Generator(device="cuda").manual_seed(6)
    q, CK, CV, KS, VS, li, qp, sp, sv, window = _decode_case(
        g, ring, [1100, 38, 1024, 700, 129, 2000], 1000)
    wide = tk.decode_attention(q, CK, CV, KS, VS, li, qp, sp, sv, window)
    for row in (0, 3, 5):
        one = [None if t is None else t[:, row:row + 1].contiguous() for t in (CK, CV, KS, VS)]
        got = tk.decode_attention(q[row:row + 1].contiguous(), *one, li,
                                  qp[row:row + 1].contiguous(), sp[row:row + 1].contiguous(),
                                  sv[row:row + 1].contiguous(), window)
        assert _same_bits(wide[row:row + 1], got)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,S,window,holes", [
    (2, 512, 512, 4096, False),  # the prefill chunk: the causal diagonal in every query tile
    (2, 200, 333, 100, True),    # T != S, T not a multiple of 32, window and holes inside tiles
    (3, 77, 77, 4096, True),     # a short chunk, one key tile
    (1, 130, 1030, 64, False),   # queries at the end of a longer key set, a narrow window
], ids=["causal-512", "ragged-200-333", "short-77", "window-64"])
def test_flash_attention_matches_plain_on_card(B, T, S, window, holes):
    """K1 against its plain version where its tiles are full, mixed (the
    diagonal, a window's edge, invalid keys and queries) and skipped:
    outputs within bf16 rounding, stats 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    case = _chunk_case(torch.Generator(device="cuda").manual_seed(7), B, T, S, window, holes)
    o, m, l = tk.flash_attention(*case, return_stats=True)
    flat = tk.flash_attention(*case)
    ro, rm, rl = tk.attend_stats_plain(*case[:3], None, None, *case[3:])
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), ro.float(), **BF16_TOL)
    assert torch.equal(flat, o.reshape(B, T, -1))
    torch.testing.assert_close(m, rm, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(l, rl, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("T,S", [(512, 512), (200, 333)])
def test_flash_attention_batch_invariant_on_card(T, S):
    """A row's K1 (out, m, l) bits alone equal its bits among 4 rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    wide = _chunk_case(torch.Generator(device="cuda").manual_seed(8), 4, T, S, 4096, True)
    got_wide = tk.flash_attention(*wide, return_stats=True)
    for row in (0, 2):
        one = tuple(x[row:row + 1].contiguous() if torch.is_tensor(x) else x for x in wide)
        for a, b in zip(got_wide, tk.flash_attention(*one, return_stats=True)):
            assert _same_bits(a[row:row + 1], b)


def _chunk_case(g, B, T, S, window, holes, H=32, Hkv=8, D=128):
    """K1's operands: T queries at the last T of S consecutive positions,
    bf16 keys; with ``holes``, invalid keys and the last 7 queries invalid."""
    bf = torch.bfloat16
    q = torch.randn((B, T, H, D), generator=g, device="cuda").to(bf)
    k = torch.randn((B, S, Hkv, D), generator=g, device="cuda").to(bf)
    v = torch.randn((B, S, Hkv, D), generator=g, device="cuda").to(bf)
    kv_pos = torch.arange(S, dtype=torch.int32, device="cuda")[None].repeat(B, 1)
    q_pos = kv_pos[:, S - T:].contiguous()
    q_valid = torch.ones((B, T), dtype=torch.bool, device="cuda")
    kv_valid = torch.ones((B, S), dtype=torch.bool, device="cuda")
    if holes:
        q_valid[:, -7:] = False
        kv_valid = torch.rand((B, S), generator=g, device="cuda") > 0.2
    return q, k, v, q_pos, kv_pos, q_valid, kv_valid, window


@pytest.mark.cuda
def test_quantize_weight_on_card_matches_cpu():
    """The card's quantizer gives the CPU's bytes and scales (it divides by a
    tensor: a host scalar would become a multiply by the reciprocal)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mistral_inference_tpu_torch.ops.linear import quantize_weight

    w = torch.randn((1024, 768), generator=torch.Generator().manual_seed(0)) * 0.02
    for bits in (8, 4):
        cpu, card = quantize_weight(w, bits), quantize_weight(w.cuda(), bits)
        for k in cpu:
            assert torch.equal(cpu[k], card[k].cpu()), (bits, k)


def _verify_case(int8, T, kv_len, live, L=3, B=4, S=384, H=32, Hkv=8, D=128, seed=7):
    dev, bf = "cuda", torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(seed)
    kf = torch.randn((L, B, S, Hkv, D), generator=g, device=dev)
    vf = torch.randn((L, B, S, Hkv, D), generator=g, device=dev)
    if int8:
        CK, KS = tcache._quantize_ring(kf, torch.int8)
        CV, VS = tcache._quantize_ring(vf, torch.int8)
        KS, VS = KS.transpose(2, 3).contiguous(), VS.transpose(2, 3).contiguous()
    else:
        CK, CV, KS, VS = kf.to(bf), vf.to(bf), None, None
    stacks = [CK.reshape(L, B, S, -1), CV.reshape(L, B, S, -1), KS, VS]
    xq = torch.randn((B, T, H, D), generator=g, device=dev).to(bf)
    xk = torch.randn((B, T, Hkv, D), generator=g, device=dev).to(bf) * 3
    xv = torch.randn((B, T, Hkv, D), generator=g, device=dev).to(bf)
    kv_len = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    live = torch.tensor(live, dtype=torch.int32, device=dev)
    q_pos = kv_len[:, None] + torch.arange(T, dtype=torch.int32, device=dev)[None]
    return stacks, (xq, xk, xv), kv_len, live, q_pos


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [True, False])
@pytest.mark.parametrize("T,kv_len,live,H,S", [
    (5, [126, 0, 379, 40], [1, 1, 1, 0], 32, 384),   # across a part, empty, the ring's end, dead
    (8, [124, 250, 376, 7], [1, 1, 1, 1], 32, 384),  # the most tokens: 32 query rows
    (1, [127, 128, 0, 383], [1, 1, 0, 1], 32, 384),  # K2's case
    # Across a block's slice (512 slots; a warp's part is 64) and from the last
    # slot of a part; from a part's first slot; a dead row.
    (5, [509, 63, 64, 1000], [1, 1, 1, 0], 32, 1024),
    # 8 query heads per KV head, 32 query rows: from a slice's first slot, to
    # a part's last, across a part, to the ring's end.
    (4, [512, 60, 126, 1020], [1, 1, 1, 1], 64, 1024),
    # K2 at 8 query heads per KV head, and at 4 with a dead row: the last and
    # first slot of a slice and of a part.
    (1, [511, 512, 63, 64], [1, 1, 1, 1], 64, 1024),
    (1, [511, 512, 63, 64], [1, 0, 1, 1], 32, 1024),
])
def test_fused_verify_matches_plain_on_card(int8, T, kv_len, live, H, S):
    """K7 (K2 at T = 1) against its plain version (ring bytes and scales
    equal, output within bf16 rounding); against T sequential K2 steps (equal
    bits: query t of the chunk is a decode step at its position), each step
    against K6 over the ring it has just written (equal bits: one loop); a
    row alone against the batch (equal bits, the same ring); and the rows
    over a ring of twice the slots (equal bits: no sum depends on S)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    window = S
    stacks, (xq, xk, xv), kv_len, live, q_pos = _verify_case(int8, T, kv_len, live, S=S, H=H)
    start = [None if t is None else t.clone() for t in stacks]
    plain = [None if t is None else t.clone() for t in stacks]
    ws0 = torch.where(live > 0, kv_len % window, -1).to(torch.int32)
    slot_pos, slot_valid = tcache.slot_positions(kv_len + live * T, window, S)
    tail = (ws0, q_pos, slot_pos, slot_valid)
    before = tk.fused_verify_chunk_attention.launches
    out = tk.fused_verify_chunk_attention(xq, xk, xv, *stacks, 1, window, *tail)
    ref = tk.fused_verify_chunk_attention_plain(xq, xk, xv, *plain, 1, window, *tail)
    torch.cuda.synchronize()
    assert tk.fused_verify_chunk_attention.launches == before + 1
    for a, b in zip(stacks, plain):
        assert a is None or torch.equal(a, b)
    torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
    for row in range(len(live)):
        one = [None if t is None else t[:, row:row + 1].contiguous() for t in start]
        alone = tk.fused_verify_chunk_attention(
            *(x[row:row + 1].contiguous() for x in (xq, xk, xv)), *one, 1, window,
            *(x[row:row + 1].contiguous() for x in tail))
        assert _same_bits(out[row:row + 1], alone), f"row {row} alone is not its batch bits"
        for a, b in zip(stacks, one):
            assert a is None or _same_bits(a[:, row:row + 1], b)
    # Twice the slots, those past S invalid: every row sees the same slots.
    big = [None if t is None else torch.cat([t, t], dim=3 if t.dtype == torch.float32 else 2)
           for t in start]
    bp, bv = tcache.slot_positions(kv_len + live * T, 2 * S, 2 * S)
    out_big = tk.fused_verify_chunk_attention(xq, xk, xv, *big, 1, window, ws0, q_pos, bp, bv)
    assert _same_bits(out, out_big), "a row's bits depend on the ring's size"
    rows = live > 0
    for t in range(T):
        sp, sv = tcache.slot_positions(kv_len + live * (t + 1), window, S)
        ws = torch.where(rows, (kv_len + t) % window, -1).to(torch.int32)
        xs = [x[:, t:t + 1].contiguous() for x in (xq, xk, xv)]
        step = tk.fused_update_decode_attention(*xs, *start, 1, window, ws,
                                                q_pos[:, t].contiguous(), sp, sv)
        assert torch.equal(step[rows, 0], out[rows, t]), f"query {t} is not a K2 step's bits"
        o6 = tk.decode_attention(xs[0], *start, 1, q_pos[:, t].contiguous(), sp, sv, window)
        assert _same_bits(step, o6), f"K2 step {t} is not K6's bits over its ring"
    for a, b in zip(stacks, start):
        assert a is None or torch.equal(a, b), "T K2 steps leave another ring"


@pytest.mark.cuda
def test_fused_verify_rejects_bad_operands_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    S = window = 384
    stacks, (xq, xk, xv), kv_len, live, q_pos = _verify_case(True, 5, [1, 2, 3, 4], [1, 1, 1, 1], S=S)
    ws0 = (kv_len % window).to(torch.int32)
    slot_pos, slot_valid = tcache.slot_positions(kv_len + 5, window, S)
    before = tk.fused_verify_chunk_attention.launches
    with pytest.raises(ValueError, match="q_pos"):
        tk.fused_verify_chunk_attention(xq, xk, xv, *stacks, 1, window, ws0, q_pos[:, :1],
                                        slot_pos, slot_valid)
    with pytest.raises(TypeError, match="xk must be"):
        tk.fused_verify_chunk_attention(xq, xk.float(), xv, *stacks, 1, window, ws0, q_pos,
                                        slot_pos, slot_valid)
    with pytest.raises(ValueError, match="out of range"):
        tk.fused_verify_chunk_attention(xq, xk, xv, *stacks, 3, window, ws0, q_pos,
                                        slot_pos, slot_valid)
    wide = xq.reshape(4, 5, 8, 4 * 128)[..., :128].contiguous().repeat(1, 1, 8, 1)  # 64 heads
    with pytest.raises(ValueError, match="query rows"):
        tk.fused_verify_chunk_attention(wide, xk, xv, *stacks, 1, window, ws0, q_pos,
                                        slot_pos, slot_valid)
    assert tk.fused_verify_chunk_attention.launches == before


@pytest.mark.cuda
def test_greedy_speculation_equals_greedy_on_card():
    """A 2-layer model at the kernels' head shapes: the fused verify route
    (K7, with K3 at B x (K + 1) rows) gives plain greedy generate()'s tokens,
    and the wrap-safe route runs without K7."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    from mistral_inference_tpu_torch.args import TransformerArgs
    from mistral_inference_tpu_torch.generate import generate
    from mistral_inference_tpu_torch.model import Transformer

    def make(layers, window, seed):
        args = TransformerArgs(dim=512, n_layers=layers, head_dim=128, hidden_dim=1024,
                               n_heads=8, n_kv_heads=2, norm_eps=1e-5, vocab_size=1000,
                               rope_theta=1e4, sliding_window=window, kv_quant="int8")
        return Transformer.random(args, dtype=torch.bfloat16, seed=seed, quant="int4")

    model, draft = make(2, 512, 0), make(1, None, 1)
    prompts = [list(range(1, 40)), [5, 9, 2], list(range(7, 150))]
    ref = generate(prompts, model, max_tokens=16, temperature=0.0)
    for dm, k in ((draft, 4), (model, 4), ("lookup", 7)):
        before = tk.fused_verify_chunk_attention.launches
        out = generate(prompts, model, max_tokens=16, temperature=0.0, draft_model=dm, spec_tokens=k)
        assert tk.fused_verify_chunk_attention.launches > before
        assert out[0] == ref[0]
        assert max(abs(a - b) for x, y in zip(out[1], ref[1]) for a, b in zip(x, y)) <= 1e-3
    small = make(2, 128, 0)  # the ring wraps: no-write verify + scatter_chunk
    ref = generate(prompts, small, max_tokens=16, temperature=0.0)
    before = tk.fused_verify_chunk_attention.launches
    out = generate(prompts, small, max_tokens=16, temperature=0.0, draft_model=draft)
    assert tk.fused_verify_chunk_attention.launches == before
    assert all(len(g) == 16 for g in out[0])
    agree = sum(a == b for x, y in zip(out[0], ref[0]) for a, b in zip(x, y))
    assert agree >= 24, "the wrap-safe route may leave plain greedy only at a near-tie"


def _bits(t):
    return t.view(torch.uint8) if t.element_size() == 1 else t


@pytest.mark.cuda
@pytest.mark.parametrize("T,kv_len,live", [
    (1, [127, 128, 0, 383], [1, 1, 0, 1]),  # K2 (and K6 after its write)
    (5, [126, 0, 379, 40], [1, 1, 1, 0]),   # K7 across a span's edge, empty, the ring's end
    (8, [124, 250, 376, 7], [1, 1, 1, 1]),  # K7, the most tokens
])
def test_fp8_ring_kernels_match_plain_on_card(T, kv_len, live):
    """The float8_e4m3fn instantiations of K2 (T = 1) or K7, then K6 and K4
    over the ring they wrote, against their plain versions: the written ring
    bytes and scales equal cache._quantize_ring's (the plain write), the
    outputs agree within bf16 rounding, and each launch is counted as fp8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    dev, bf, fp8 = "cuda", torch.bfloat16, torch.float8_e4m3fn
    L, B, S, H, Hkv, D, li = 3, 4, 384, 32, 8, 128, 1
    window = S
    g = torch.Generator(device=dev).manual_seed(3)
    CK, KS = tcache._quantize_ring(torch.randn((L, B, S, Hkv, D), generator=g, device=dev), fp8)
    CV, VS = tcache._quantize_ring(torch.randn((L, B, S, Hkv, D), generator=g, device=dev), fp8)
    stacks = [CK.reshape(L, B, S, -1), CV.reshape(L, B, S, -1),
              KS.transpose(2, 3).contiguous(), VS.transpose(2, 3).contiguous()]
    plain = [t.clone() for t in stacks]
    xq = torch.randn((B, T, H, D), generator=g, device=dev).to(bf)
    xk = torch.randn((B, T, Hkv, D), generator=g, device=dev).to(bf) * 3
    xv = torch.randn((B, T, Hkv, D), generator=g, device=dev).to(bf)
    kv_len = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    live = torch.tensor(live, dtype=torch.int32, device=dev)
    q_pos = kv_len[:, None] + torch.arange(T, dtype=torch.int32, device=dev)[None]
    ws = torch.where(live > 0, kv_len % window, -1).to(torch.int32)
    slot_pos, slot_valid = tcache.slot_positions(kv_len + live * T, window, S)
    cuda_ops.reset_launch_counts()
    if T == 1:
        args = (li, window, ws, kv_len, slot_pos, slot_valid)
        out = tk.fused_update_decode_attention(xq, xk, xv, *stacks, *args)
        ref = tk.fused_update_decode_attention_plain(xq, xk, xv, *plain, *args)
        wrote = tk.fused_update_decode_attention
    else:
        args = (li, window, ws, q_pos, slot_pos, slot_valid)
        out = tk.fused_verify_chunk_attention(xq, xk, xv, *stacks, *args)
        ref = tk.fused_verify_chunk_attention_plain(xq, xk, xv, *plain, *args)
        wrote = tk.fused_verify_chunk_attention
    torch.cuda.synchronize()
    for a, b in zip(stacks, plain):
        assert torch.equal(_bits(a), _bits(b)), "the fp8 write is not the ring rule's bytes"
    rows = live > 0
    torch.testing.assert_close(out[rows].float(), ref[rows].float(), **BF16_TOL)
    assert wrote.launches == tk.FP8_LAUNCHES[wrote].launches == 1

    # K6 at the last token of each row, and K4 for the whole chunk, over that ring.
    last = (q_pos[:, -1:]).contiguous()
    o6 = tk.decode_attention(xq[:, -1:].contiguous(), *stacks, li, last, slot_pos, slot_valid,
                             window)
    r6 = tk.decode_attention_plain(xq[:, -1:].contiguous(), *stacks, li, last, slot_pos,
                                   slot_valid, window)
    q_valid = torch.ones((B, T), dtype=torch.bool, device=dev)
    ring = (stacks[0][li], stacks[1][li], stacks[2][li], stacks[3][li])
    o4 = tk.ring_attention_stats(xq, *ring, q_pos, slot_pos, q_valid, slot_valid, window)
    r4 = tk.attend_stats_plain(xq, ring[0].view(B, S, Hkv, D), ring[1].view(B, S, Hkv, D),
                               ring[2], ring[3], q_pos, slot_pos, q_valid, slot_valid, window)
    torch.cuda.synchronize()
    torch.testing.assert_close(o6[rows].float(), r6[rows].float(), **BF16_TOL)
    torch.testing.assert_close(o4[0][rows].float(), r4[0][rows].float(), **BF16_TOL)
    torch.testing.assert_close(o4[1][rows], r4[1][rows], atol=1e-4, rtol=1e-4)
    for fn in (tk.decode_attention, tk.ring_attention_stats):
        assert fn.launches == tk.FP8_LAUNCHES[fn].launches == 1


def _ssd_case(L, B, NH, HD, DS, NG, dtype, seed=11, dead=None):
    g = torch.Generator(device="cuda").manual_seed(seed)
    ssm = torch.randn((L, B, NH, HD, DS), generator=g, device="cuda").to(dtype)
    dt = torch.rand((B, NH), generator=g, device="cuda") * 0.1
    if dead is not None:
        dt[dead] = 0.0
    A = -(1.0 + 15.0 * torch.rand((NH,), generator=g, device="cuda"))
    dtx = dt[..., None] * torch.randn((B, NH, HD), generator=g, device="cuda")
    Bm = torch.randn((B, NG, DS), generator=g, device="cuda")
    Cm = torch.randn((B, NG, DS), generator=g, device="cuda")
    return torch.exp(dt * A), dtx, Bm, Cm, ssm


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,B,NH,HD,DS,NG,li", [(3, 2, 8, 16, 32, 4, 1), (2, 4, 128, 64, 128, 8, 1),
                                                (1, 3, 6, 10, 12, 2, 0),
                                                # codestral-mamba-7b's whole stack, its decode batch
                                                (64, 4, 128, 64, 128, 8, 37),
                                                (2, 3, 4, 24, 4, 1, 1)])
def test_ssd_step_matches_plain_on_card(dtype, L, B, NH, HD, DS, NG, li):
    """K9: the state's new bits equal the plain version's (fp32 and bf16),
    a dead row and the other layers keep theirs, y within 1e-5 (fp32 sums in
    another order); one launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    from mistral_inference_tpu_torch.ops.cuda import ssd_step as k9

    cuda_ops.reset_launch_counts()
    a, dtx, Bm, Cm, ssm = _ssd_case(L, B, NH, HD, DS, NG, dtype, dead=B - 1)
    start = ssm.clone()
    ptr = ssm.data_ptr()
    y = k9.fused_ssd_step_stacked(a, dtx, Bm, Cm, ssm, li)
    plain = start.clone()
    y_ref = k9.fused_ssd_step_stacked_plain(a, dtx, Bm, Cm, plain, li)
    torch.cuda.synchronize()
    assert ssm.data_ptr() == ptr
    assert torch.equal(ssm, plain)
    assert torch.equal(ssm[li, B - 1], start[li, B - 1])
    for other in range(L):
        if other != li:
            assert torch.equal(ssm[other], start[other])
    torch.testing.assert_close(y, y_ref, atol=1e-5, rtol=1e-5)
    assert k9.fused_ssd_step_stacked.launches == 1
    # The depth-1 entry point is the same kernel on one layer's state.
    one = start[li].clone()
    y1 = k9.fused_ssd_step(a, dtx, Bm, Cm, one)
    torch.cuda.synchronize()
    assert torch.equal(y1, y) and torch.equal(one, plain[li])
    assert k9.fused_ssd_step_stacked.launches == 2


@pytest.mark.cuda
def test_ssd_step_rejects_bad_operands_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    from mistral_inference_tpu_torch.ops.cuda import ssd_step as k9

    cuda_ops.reset_launch_counts()
    a, dtx, Bm, Cm, ssm = _ssd_case(2, 2, 8, 16, 32, 4, torch.float32)
    with pytest.raises(TypeError):
        k9.fused_ssd_step_stacked(a.double(), dtx, Bm, Cm, ssm, 0)
    with pytest.raises(ValueError):
        k9.fused_ssd_step_stacked(a, dtx.transpose(1, 2).contiguous().transpose(1, 2), Bm, Cm,
                                  ssm, 0)
    with pytest.raises(ValueError):
        k9.fused_ssd_step_stacked(a, dtx, Bm, Cm, ssm, 2)
    with pytest.raises(TypeError):
        k9.fused_ssd_step_stacked(a, dtx, Bm, Cm, ssm.half(), 0)
    a6, dtx6, B6, C6, ssm6 = _ssd_case(1, 2, 8, 16, 6, 4, torch.float32)
    with pytest.raises(ValueError):
        k9.fused_ssd_step_stacked(a6, dtx6, B6, C6, ssm6, 0)
    assert k9.fused_ssd_step_stacked.launches == 0


@pytest.mark.cuda
def test_generate_mamba_on_card_matches_cpu():
    """A small fp32 Mamba on the card (K9 in every decode step) against the
    same weights on the CPU (K9's plain version): greedy tokens equal,
    logprobs within 1e-3 (fp32 sums in other orders through 2 layers), and
    the plain and lookup generators agree on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    from mistral_inference_tpu_torch.args import MambaArgs
    from mistral_inference_tpu_torch.generate import generate_mamba
    from mistral_inference_tpu_torch.model import Mamba

    torch.backends.cuda.matmul.allow_tf32 = False
    args = MambaArgs(dim=256, n_layers=2, vocab_size=512, n_groups=2, rms_norm=True,
                     residual_in_fp32=True, fused_add_norm=True, pad_vocab_size_multiple=16,
                     tie_embeddings=False, d_state=64, headdim=64)
    cpu = Mamba.random(args, dtype=torch.float32, seed=5, device="cpu")
    params = {k: v.cuda() for k, v in cpu.params.items() if k != "layers"}
    params["layers"] = [{k: v.cuda() for k, v in lw.items()} for lw in cpu.params["layers"]]
    card = Mamba(args, params, torch.float32, "cuda")
    prompts = [list(range(1, 30)), [7, 3, 9], list(range(40, 51)) * 3]
    cuda_ops.reset_launch_counts()
    g_card, lp_card = generate_mamba(prompts, card, max_tokens=12, temperature=0.0, chunk_size=16)
    from mistral_inference_tpu_torch.ops.cuda import ssd_step as k9

    assert k9.fused_ssd_step_stacked.launches == 2 * 12
    g_cpu, lp_cpu = generate_mamba(prompts, cpu, max_tokens=12, temperature=0.0, chunk_size=16)
    assert g_card == g_cpu
    for x, y in zip(lp_card, lp_cpu):
        torch.testing.assert_close(torch.tensor(x), torch.tensor(y), atol=1e-3, rtol=0)
    g_look, lp_look = generate_mamba(prompts, card, max_tokens=12, temperature=0.0,
                                     chunk_size=16, draft_model="lookup", spec_tokens=4)
    assert g_look == g_card and [len(x) for x in lp_look] == [len(x) for x in lp_card]


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [
    [(0, 4096)],               # a full 1024 x 1024 image
    [(0, 504), (-1, 8)],       # a 384 x 336 image in its 512 bucket
    [(0, 256)],                # a small bucket
    [(0, 1536), (1, 2048)],    # two images in one block-diagonal row
    [(0, 1600), (1, 1984)],    # a 128-row tile straddles the two images
], ids=["image-4096", "bucket-512-padded", "bucket-256", "two-images-3584",
        "two-images-straddling"])
def test_segment_attention_matches_plain_on_card(parts):
    """K10 against its plain version at the vision encoder's shapes (16 heads
    of 64, bf16), within one bf16 ulp: both round p to bf16 before PV."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    g = torch.Generator(device="cuda").manual_seed(0)
    N = sum(n for _, n in parts)
    seg = torch.cat([torch.full((n,), i, dtype=torch.int32, device="cuda")
                     for i, n in parts])[None]
    q, k, v = (torch.randn((1, N, 16, 64), generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    cuda_ops.reset_launch_counts()
    out = tk.segment_flash_attention(q, k, v, seg)
    ref = tk.segment_attention_plain(q, k, v, seg)
    torch.cuda.synchronize()
    assert out.shape == (1, N, 16 * 64)
    torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
    assert tk.segment_flash_attention.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n0,n1", [(1600, 1984), (504, 8), (1536, 2048)])
def test_segment_attention_batch_invariant_on_card(n0, n1):
    """K10: an image alone has the bits it has in a group beside another
    (encode_images with group_max > 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    g = torch.Generator(device="cuda").manual_seed(5)
    seg = torch.cat([torch.zeros(n0, dtype=torch.int32, device="cuda"),
                     torch.ones(n1, dtype=torch.int32, device="cuda")])[None]
    q, k, v = (torch.randn((1, n0 + n1, 16, 64), generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    group = tk.segment_flash_attention(q, k, v, seg)
    alone = tk.segment_flash_attention(*(x[:, :n0].contiguous() for x in (q, k, v, seg)))
    assert _same_bits(alone, group[:, :n0])
