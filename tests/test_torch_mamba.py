"""The port's Mamba2 forward (``models/mamba.py``) against the JAX package's,
on shared weights (``convert.mamba_params_from_numpy`` of
``init_mamba_params``), in fp32 on the CPU.

The JAX side runs on its XLA route (``MambaStaticConfig(pallas=False)``) and,
for a decode step and the quantized trees, with ``pallas=True`` under
``MISTRAL_PALLAS_INTERPRET=1``: its SSD step (K9) and quantized linears (K3,
K5) then run in interpret mode, as its own tests run them on the CPU. The
port's K9 and quantized linears run their plain versions on CPU tensors.

Tolerances: the chunked SSD 1e-4 against the naive recurrence and JAX's
(tests/test_mamba.py's); logits, SSD states and conv taps 2e-5 (fp32 through
two layers, sums in other orders); quantized trees byte-equal to JAX's, their
forwards within 1e-4 (the dequantized products summed per group in another
order). ``write_state=False`` leaves the state's bits.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mistral_inference_tpu.args import MambaArgs as JaxMambaArgs
from mistral_inference_tpu.models import mamba as jmm
from mistral_inference_tpu.quant.weights import quantize_params as jax_quantize_params
from mistral_inference_tpu_torch.args import MambaArgs
from mistral_inference_tpu_torch.convert import mamba_params_from_numpy
from mistral_inference_tpu_torch.model import Mamba
from mistral_inference_tpu_torch.models import mamba as tmm
from mistral_inference_tpu_torch.ops import linear as tlin

TINY = dict(dim=64, n_layers=2, vocab_size=256, n_groups=2, rms_norm=True,
            residual_in_fp32=True, fused_add_norm=True, pad_vocab_size_multiple=16,
            tie_embeddings=False, d_state=16, d_conv=4, expand=2, headdim=16)
# Widths that open the quantized kernels' gates: in_proj 256 -> 1280 and
# out_proj 512 -> 256 (multiples of 128 and 256), ng * ds = 128.
WIDE = dict(TINY, dim=256, vocab_size=512, d_state=64, headdim=64)
TOL = dict(atol=2e-5, rtol=0)


def jax_args(**over) -> JaxMambaArgs:
    return JaxMambaArgs(**{**TINY, **over})


def port_of(jargs: JaxMambaArgs, jparams) -> Mamba:
    args = MambaArgs.from_dict(dataclasses.asdict(jargs))
    return Mamba(args, mamba_params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu"),
                 torch.float32, device="cpu")


# The JAX functions jitted: one compile each is faster than eager dispatch.
jax_forward = jax.jit(jmm.forward, static_argnames=("cfg", "chunk", "head"))
jax_ssd_chunked = jax.jit(jmm._ssd_chunked, static_argnums=6)


@functools.lru_cache(maxsize=None)
def _jax_model(seed, over):
    jargs = jax_args(**dict(over))
    init = jax.jit(lambda key: jmm.init_mamba_params(key, jargs, jnp.float32))
    return jargs, init(jax.random.PRNGKey(seed))


def make(seed=0, **over):
    """JAX args and params (made once per seed and config) and a port model
    of its own on the same weights."""
    jargs, jparams = _jax_model(seed, tuple(sorted(over.items())))
    return jargs, jparams, port_of(jargs, jparams)


def jcfg(jargs, pallas=False):
    return jmm.MambaStaticConfig.from_args(jargs, pallas=pallas)


def check_state(port_state, jax_state, tol=TOL):
    conv = np.concatenate([np.asarray(jax_state.conv_x), np.asarray(jax_state.conv_B),
                           np.asarray(jax_state.conv_C)], axis=-1)
    np.testing.assert_allclose(port_state.conv.float().numpy(), conv, **tol)
    np.testing.assert_allclose(port_state.ssm.float().numpy(),
                               np.asarray(jax_state.ssm, np.float32), **tol)
    np.testing.assert_array_equal(port_state.seen.numpy(), np.asarray(jax_state.seen))


def _naive_ssd(x, dt, A, Bm, Cm, h0):
    """The literal recurrence h_t = exp(dt A) h + dt B (x) x, y_t = C_t . h_t."""
    B, T, nh, _ = x.shape
    rep = nh // Bm.shape[2]
    y, h = np.zeros_like(x), h0.copy()
    for t in range(T):
        for head in range(nh):
            g = head // rep
            a = np.exp(dt[:, t, head] * A[head])
            upd = dt[:, t, head, None, None] * np.einsum("bp,bd->bpd", x[:, t, head], Bm[:, t, g])
            h[:, head] = a[:, None, None] * h[:, head] + upd
            y[:, t, head] = np.einsum("bpd,bd->bp", h[:, head], Cm[:, t, g])
    return y, h


@pytest.mark.parametrize("chunk", [4, 5, 16])
def test_ssd_chunked_matches_naive_and_jax(chunk):
    rng = np.random.default_rng(0)
    B, T, nh, hd, ng, ds = 2, 13, 4, 8, 2, 16
    x = rng.standard_normal((B, T, nh, hd)).astype(np.float32)
    dt = np.abs(rng.standard_normal((B, T, nh))).astype(np.float32) * 0.5
    A = -np.abs(rng.standard_normal(nh)).astype(np.float32)
    Bm = rng.standard_normal((B, T, ng, ds)).astype(np.float32)
    Cm = rng.standard_normal((B, T, ng, ds)).astype(np.float32)
    h0 = rng.standard_normal((B, nh, hd, ds)).astype(np.float32) * 0.1
    ins = (x, dt, A, Bm, Cm, h0)
    y_ref, h_ref = _naive_ssd(*ins)
    y, h = tmm._ssd_chunked(*(torch.from_numpy(v) for v in ins), chunk)
    np.testing.assert_allclose(y.numpy(), y_ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(h.numpy(), h_ref, atol=1e-4, rtol=1e-4)
    y_j, h_j = jax_ssd_chunked(*(jnp.asarray(v) for v in ins), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), atol=1e-4, rtol=1e-4)


def test_ssd_chunked_large_decay_is_finite():
    """Above the diagonal exp(cum_i - cum_j) overflows to inf for strong
    decays (A = -16, dt = 0.1 over 128 tokens): the masked form must select
    0 there, never inf * 0 = NaN."""
    rng = np.random.default_rng(1)
    B, T, nh, hd, ng, ds = 1, 128, 2, 4, 1, 8
    x = torch.from_numpy(rng.standard_normal((B, T, nh, hd)).astype(np.float32))
    dt = torch.full((B, T, nh), 0.1)
    A = torch.tensor([-16.0, -1.0])
    Bm = torch.from_numpy(rng.standard_normal((B, T, ng, ds)).astype(np.float32))
    Cm = torch.from_numpy(rng.standard_normal((B, T, ng, ds)).astype(np.float32))
    y, h = tmm._ssd_chunked(x, dt, A, Bm, Cm, torch.zeros((B, nh, hd, ds)), 128)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()


def _prefill_both(jargs, jparams, port, tokens, seqlens, chunk=4):
    cfg = jcfg(jargs)
    jstate = jmm.MambaState.alloc(cfg, tokens.shape[0], jnp.float32)
    jlog, jstate = jax_forward(jparams, jnp.asarray(tokens), jnp.asarray(seqlens), jstate,
                               cfg, chunk=chunk)
    state = port.alloc_state(tokens.shape[0])
    log = port.forward(torch.from_numpy(tokens), torch.from_numpy(seqlens), state, chunk=chunk)
    return jlog, jstate, log, state


RAGGED_TOKENS = np.random.default_rng(2).integers(0, 256, (3, 11)).astype(np.int32)
RAGGED_LENS = np.array([11, 6, 0], np.int32)


def test_forward_prefill_ragged_matches_jax():
    jargs, jparams, port = make(seed=1)
    jlog, jstate, log, state = _prefill_both(jargs, jparams, port, RAGGED_TOKENS, RAGGED_LENS)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
    check_state(state, jstate)


@pytest.mark.parametrize("jax_route", ["xla", "pallas-interpret"])
def test_forward_decode_step_with_dead_row_matches_jax(monkeypatch, jax_route):
    """One T = 1 step after a ragged prefill, row 1 dead (seqlens 0): the
    port through K9's plain version, JAX through its chunked SSD or its
    Pallas step in interpret mode. The dead row keeps its state's bits."""
    if jax_route == "pallas-interpret":
        monkeypatch.setenv("MISTRAL_PALLAS_INTERPRET", "1")
    jargs, jparams, port = make(seed=1)
    _, jstate, _, state = _prefill_both(jargs, jparams, port, RAGGED_TOKENS, RAGGED_LENS)
    before = state.ssm.clone(), state.conv.clone()
    tok = np.array([[5], [7], [9]], np.int32)
    live = np.array([1, 0, 1], np.int32)
    cfg = jcfg(jargs, pallas=jax_route == "pallas-interpret")
    jlog, jstate = jax_forward(jparams, jnp.asarray(tok), jnp.asarray(live), jstate, cfg, chunk=1)
    log = port.forward(torch.from_numpy(tok), torch.from_numpy(live), state, chunk=1)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
    check_state(state, jstate)
    assert torch.equal(state.ssm[:, 1], before[0][:, 1])
    assert torch.equal(state.conv[:, 1], before[1][:, 1])


# Tied embeddings and a padded vocab in one model: the tied head reads the
# padded embedding, and the logits are cut to vocab_size.
TIED_PADDED = dict(tie_embeddings=True, vocab_size=250, pad_vocab_size_multiple=64)


def test_tied_embeddings_match_jax():
    jargs, jparams, port = make(seed=3, **TIED_PADDED)
    assert "lm_head" not in port.params
    jlog, jstate, log, state = _prefill_both(jargs, jparams, port, RAGGED_TOKENS % 250,
                                             RAGGED_LENS)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
    check_state(state, jstate)


def test_padded_vocab_cut_and_matches_jax():
    jargs, jparams, port = make(seed=3, **TIED_PADDED)
    assert port.args.padded_vocab_size == 256 and port.params["embedding"].shape[0] == 256
    state = port.alloc_state(3)
    log = port.forward(torch.from_numpy(RAGGED_TOKENS % 250), torch.from_numpy(RAGGED_LENS),
                       state, chunk=4)
    assert log.shape == (3, 11, 250)
    hidden = port.forward(torch.tensor([[1]]), torch.tensor([1]), port.alloc_state(1),
                          head="none")
    assert tmm.apply_head(hidden, port.params, port.args).shape == (1, 1, 250)


def test_write_state_false_leaves_state():
    """The lookup verify pass: the chunk is scored exactly as a writing pass
    scores it, and the state keeps its bits."""
    _, _, port = make(seed=1)
    state = port.alloc_state(3)
    port.forward(torch.from_numpy(RAGGED_TOKENS), torch.from_numpy(RAGGED_LENS), state, chunk=4)
    saved = [t.clone() for t in (state.conv, state.ssm, state.seen)]
    chunk = torch.tensor([[3, 1, 4, 1, 5], [9, 2, 6, 5, 3], [5, 8, 9, 7, 9]])
    lens = torch.tensor([5, 5, 0], dtype=torch.int32)
    verify = port.forward(chunk, lens, state, chunk=5, write_state=False)
    for a, b in zip((state.conv, state.ssm, state.seen), saved):
        assert torch.equal(a, b)
    written = port.forward(chunk, lens, state, chunk=5)
    assert torch.equal(verify, written)
    assert not torch.equal(state.ssm, saved[1])


def test_random_quant_equals_quantize_after():
    """``Mamba.random(quant=...)`` quantizes each projection as it is drawn:
    the same tree as drawing dense and quantizing afterwards."""
    args = MambaArgs.from_dict(WIDE)
    a = Mamba.random(args, dtype=torch.float32, seed=7, device="cpu", quant="int4", group=64)
    b = Mamba.random(MambaArgs.from_dict(WIDE), dtype=torch.float32, seed=7,
                     device="cpu").quantize("int4", group=64)
    for la, lb in zip(a.params["layers"], b.params["layers"]):
        for name in la:
            wa, wb = la[name], lb[name]
            if tlin.is_quantized(wa):
                assert all(torch.equal(wa[k], wb[k]) for k in wa)
            else:
                assert torch.equal(wa, wb)
    with pytest.raises(ValueError, match="already quantized"):
        a.quantize("int8")


@pytest.mark.parametrize("mode,jax_route", [("int8", "xla"), ("int4", "pallas-interpret")])
def test_quantized_trees_and_forward_match_jax(monkeypatch, mode, jax_route):
    """int8 / int4 trees: ``quantize`` of the port and
    ``mamba_params_from_numpy`` of a JAX-quantized tree hold JAX's bytes and
    scales; a 512-row prefill (the K5 band) and a decode step (K3) agree with
    JAX's, on its XLA route (int8) and through its Pallas kernels in
    interpret mode (int4)."""
    pallas = jax_route == "pallas-interpret"
    if pallas:
        monkeypatch.setenv("MISTRAL_PALLAS_INTERPRET", "1")
    group = 64
    jargs, jparams, port = make(seed=6, **{k: v for k, v in WIDE.items() if k in TINY})
    port.quantize(mode, group)
    # Eager, as ``Mamba.quantize`` runs it: jitted, XLA may divide by a
    # reciprocal multiply and change a scale's last bit.
    jq = jax_quantize_params(dict(jparams, layers=dict(jparams["layers"])), mode, group)
    carried = port_of(jargs, jq)
    key = "q4" if mode == "int4" else "q"
    for i, (lw, lc) in enumerate(zip(port.params["layers"], carried.params["layers"])):
        for name, parts in (("in_proj", ("z_proj", "x_proj", "b_proj", "c_proj")),
                            ("out_proj", ("out_proj",))):
            for k in (key, "scale"):
                want = np.concatenate([np.asarray(jq["layers"][p][k][i]) for p in parts], -1)
                np.testing.assert_array_equal(lw[name][k].numpy(), want)
                assert torch.equal(lc[name][k], lw[name][k])
        assert torch.equal(lw["dt_proj"], lc["dt_proj"]) and not tlin.is_quantized(lw["dt_proj"])

    rng = np.random.default_rng(8)
    tokens = rng.integers(0, 512, (2, 256)).astype(np.int32)
    lens = np.array([256, 200], np.int32)
    tok1 = np.array([[3], [4]], np.int32)
    ones = np.ones((2,), np.int32)
    state = port.alloc_state(2)
    log = port.forward(torch.from_numpy(tokens), torch.from_numpy(lens), state, chunk=64)
    log1 = port.forward(torch.from_numpy(tok1), torch.from_numpy(ones), state, chunk=1)
    cfg = jcfg(jargs, pallas=pallas)
    jstate = jmm.MambaState.alloc(cfg, 2, jnp.float32)
    jlog, jstate = jax_forward(jq, jnp.asarray(tokens), jnp.asarray(lens), jstate, cfg, chunk=64)
    jlog1, jstate = jax_forward(jq, jnp.asarray(tok1), jnp.asarray(ones), jstate, cfg, chunk=1)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=1e-4, rtol=0)
    np.testing.assert_allclose(log1.numpy(), np.asarray(jlog1), atol=1e-4, rtol=0)
    check_state(state, jstate, dict(atol=1e-4, rtol=0))
