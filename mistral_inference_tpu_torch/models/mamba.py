"""Mamba2 (Codestral-Mamba), counterpart of ``mistral_inference_tpu/models/mamba.py``.

Per layer: RMSNorm, then the mixer

    in_proj -> [z | x | B | C], dt_raw = x_in @ dt_proj   (model dtype)
    depthwise causal conv over x | B | C with a carried (K-1)-token state, silu
    dt = softplus(dt_raw + dt_bias), A = -exp(A_log)     (fp32)
    y = SSD(x, dt, A, B, C) + D x                       (fp32)
    y = rms_norm(y * silu(z)) -> out_proj               (model dtype)

and a residual add (fp32 when ``residual_in_fp32``); a final norm and the head.

Parameters are a plain dict with a list of per-layer dicts. The linears are
stored ``(out, in)`` and applied with ``F.linear``, or are quantized leaves of
``ops/linear.py``. The four projections that read the layer's input are one
``in_proj`` (2 d_inner + 2 ng ds, dim), z | x | B | C along out (grouped
quantization is per output column, so a quantized fusion is exact);
``dt_proj`` (nh, dim) stays dense and apart. The conv weight is one (K,
conv_dim) tensor over x | B | C.

The SSD runs as the chunked state-space-dual form (``_ssd_chunked``: a masked
quadratic form within a chunk, a loop over chunks for the carried state), and
at T = 1 through K9 (``ops/cuda/ssd_step.py``), which updates the layer's
state in place. Padding tokens (past ``seqlens``) enter with dt = 0 and zeroed
conv inputs: they neither decay nor write state, and a row with ``seqlens``
0 keeps its state. On CPU tensors K9 runs its plain version, so the CPU tests
run the decomposition the card runs.

Under a mesh (``parallel/``) a rank holds the heads [t nh / T, (t + 1) nh /
T) and their groups: its slice of ``in_proj`` takes its part of each of z,
x, B and C, ``dt_proj``'s whole product gives its heads' columns, the conv
and the SSD run on its channels and heads (K9 on nh / T heads). The gated
activation ``y * silu(z)`` is all-gathered over ``tensor`` to every
channel, so each rank takes the gated RMSNorm over all of d_inner as one
device does; ``out_proj`` holds D / T output columns over the whole d_inner,
gathered after the product. The head is vocab-sharded and its logits
all-gathered. Products are routed by one device's row count (``batch``).

The two dense cuBLAS products, ``dt_proj`` and the head, go through
``ops.linear.fixed_rows_linear``: one call per fixed block of rows, so a
row's bits do not depend on the rows beside it. ``MambaEngine`` then gives
``generate_mamba``'s tokens at any batch, and a data rank one device's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from mistral_inference_tpu_torch.args import MambaArgs
from mistral_inference_tpu_torch.ops.cuda.ssd_step import fused_ssd_step_stacked
from mistral_inference_tpu_torch.ops.linear import (
    DEFAULT_GROUP,
    Weight,
    fixed_rows_linear,
    linear,
    quantize_weight,
)
from mistral_inference_tpu_torch.ops.norm import rms_norm
from mistral_inference_tpu_torch.parallel.mesh import Mesh, gather

Params = Dict[str, Any]

MAMBA_NORM_EPS = 1e-5  # mamba_ssm's RMSNorm default
DEFAULT_CHUNK = 128


@dataclass
class MambaState:
    """The recurrent state, the Mamba counterpart of the KV cache; updated in
    place by ``forward``."""

    conv: torch.Tensor  # (L, B, K-1, conv_dim) model dtype: the last inputs of x | B | C
    ssm: torch.Tensor  # (L, B, nh, hd, ds) fp32, or bf16 (half the bytes, one rounding per store)
    seen: torch.Tensor  # (B,) int32: tokens absorbed
    # Under data parallelism the global row of conv's and ssm's first row;
    # ``seen`` stays global. None: they hold every row.
    row0: Optional[int] = None

    @classmethod
    def alloc(
        cls, args: MambaArgs, batch: int, dtype: torch.dtype, device: torch.device,
        ssm_dtype: torch.dtype = torch.float32, tensor: int = 1,
        state_rows: Optional[int] = None, row0: Optional[int] = None,
    ) -> "MambaState":
        """A bf16 ``ssm_dtype`` halves the state's memory and its traffic per
        decode step; all SSD arithmetic stays fp32. Prefill rounds the stored
        state once per chunk and decode once per token, so decode == prefill
        then holds only approximately. Under a mesh the state holds the
        heads of one of ``tensor`` ranks and ``state_rows`` rows from global
        row ``row0``."""
        L = args.n_layers
        rows = batch if state_rows is None else state_rows
        conv_dim = args.conv_dim // tensor
        return cls(
            conv=torch.zeros((L, rows, args.d_conv - 1, conv_dim), dtype=dtype, device=device),
            ssm=torch.zeros((L, rows, args.n_ssm_heads // tensor, args.headdim, args.d_state),
                            dtype=ssm_dtype, device=device),
            seen=torch.zeros((batch,), dtype=torch.int32, device=device),
            row0=row0,
        )

    def local(self) -> "MambaState":
        """The state with ``seen`` of its own rows only (a copy), as
        ``KVCache.local``."""
        from mistral_inference_tpu_torch.parallel.multihost import local_rows

        return MambaState(self.conv, self.ssm,
                          local_rows(self.seen, self.row0, self.conv.shape[1]))


def init_params(
    args: MambaArgs,
    dtype: torch.dtype,
    generator: torch.Generator,
    device: torch.device,
    quant: Optional[str] = None,
    group: int = DEFAULT_GROUP,
    keep: Optional[Callable[[Params], Params]] = None,
) -> Params:
    """Random weights in the JAX package's parameterization: linears N(0, 1)
    / sqrt(fan_in), the embedding N(0, 0.02^2), conv taps N(0, 1) / sqrt(K),
    A in [-16, -1] (A_log = log(1 + 15 u)), dt in [1e-3, 0.1] log-uniform
    stored as its inverse softplus in ``dt_bias``, D = 1, norms 1. Drawn in
    ``dtype`` on ``device``. With ``quant`` ("int8" | "int4") ``in_proj`` and
    ``out_proj`` are quantized as they are drawn, one layer at a time; ``keep``
    maps each layer as soon as it is drawn (a mesh keeps its shard)."""
    if quant not in (None, "int8", "int4"):
        raise ValueError(f"quant must be None, 'int8' or 'int4', got {quant!r}")
    bits = {None: 0, "int8": 8, "int4": 4}[quant]
    D, di, nh, K = args.dim, args.d_inner, args.n_ssm_heads, args.d_conv
    gd = args.n_groups * args.d_state
    f32 = torch.float32

    def draw(shape, scale: float, dt: torch.dtype = dtype) -> torch.Tensor:
        w = torch.randn(shape, generator=generator, dtype=dt, device=device)
        return w.mul_(scale)

    def uniform(n: int) -> torch.Tensor:
        return torch.rand((n,), generator=generator, dtype=f32, device=device)

    def big(out_f: int, in_f: int) -> Weight:
        w = draw((out_f, in_f), in_f**-0.5)
        return quantize_weight(w.t(), bits, group) if bits else w

    def ones(n: int, dt: torch.dtype = dtype) -> torch.Tensor:
        return torch.ones((n,), dtype=dt, device=device)

    layers = []
    for _ in range(args.n_layers):
        dt = torch.exp(uniform(nh) * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        lw = {
            "norm": ones(D),
            "in_proj": big(2 * di + 2 * gd, D),  # z | x | B | C along out
            "dt_proj": draw((nh, D), D**-0.5),
            "conv_w": draw((K, args.conv_dim), K**-0.5),  # x | B | C
            "conv_b": torch.zeros((args.conv_dim,), dtype=dtype, device=device),
            "A_log": torch.log(1.0 + uniform(nh) * 15.0),
            "D": ones(nh, f32),
            "dt_bias": dt + torch.log(-torch.expm1(-dt)),
            "mixer_norm": ones(di),
            "out_proj": big(D, di),
        }
        layers.append(lw if keep is None else keep(lw))
    params: Params = {
        "embedding": draw((args.padded_vocab_size, D), 0.02),
        "layers": layers,
        "norm_f": ones(D),
    }
    if not args.tie_embeddings:
        params["lm_head"] = draw((args.padded_vocab_size, D), D**-0.5)
    return params


def _ssd_chunked(
    x: torch.Tensor,  # (B, T, nh, hd) fp32
    dt: torch.Tensor,  # (B, T, nh) fp32: softplus'ed, 0 for invalid tokens
    A: torch.Tensor,  # (nh,) fp32, negative
    Bm: torch.Tensor,  # (B, T, ng, ds) fp32
    Cm: torch.Tensor,  # (B, T, ng, ds) fp32
    h0: torch.Tensor,  # (B, nh, hd, ds) fp32 incoming state (not modified)
    chunk: int,
):
    """h_t = exp(dt_t A) h_{t-1} + dt_t B_t (x) x_t,  y_t = C_t . h_t.

    Within a chunk of Q tokens the recurrence is a masked quadratic form;
    across chunks a loop carries the state. Heads of one group share B and
    C, so C.B is formed per group and broadcast over the group's heads.
    Returns (y (B, T, nh, hd), the final state (B, nh, hd, ds)), in fp32."""
    Bsz, T, nh, hd = x.shape
    ng, ds = Bm.shape[2], Bm.shape[3]
    rep = nh // ng
    Q = min(chunk, T)
    Tp = -(-T // Q) * Q
    if Tp != T:
        x, Bm, Cm = (F.pad(t, (0, 0, 0, 0, 0, Tp - T)) for t in (x, Bm, Cm))
        dt = F.pad(dt, (0, 0, 0, Tp - T))
    nc = Tp // Q

    # Group-major views: head h = g * rep + r.
    xc = x.reshape(Bsz, nc, Q, ng, rep, hd).permute(0, 1, 3, 4, 2, 5)  # (B,nc,ng,rep,Q,hd)
    dtc = dt.reshape(Bsz, nc, Q, ng, rep).permute(0, 1, 3, 4, 2)  # (B,nc,ng,rep,Q)
    Bc = Bm.reshape(Bsz, nc, Q, ng, ds).permute(0, 1, 3, 2, 4)  # (B,nc,ng,Q,ds)
    Cc = Cm.reshape(Bsz, nc, Q, ng, ds).permute(0, 1, 3, 2, 4)
    cum = torch.cumsum(dtc * A.reshape(ng, rep, 1), dim=-1)  # (B,nc,ng,rep,Q), inclusive

    # Within a chunk: att[i, j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i.
    # Above the diagonal cum_i - cum_j > 0 and its exp may be inf: the where
    # selects 0 there (a multiply by the mask would give inf * 0 = NaN).
    cb = (Cc @ Bc.transpose(-1, -2))[:, :, :, None]  # (B,nc,ng,1,Q,Q)
    decay = cum[..., :, None] - cum[..., None, :]  # (B,nc,ng,rep,i,j)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    att = torch.where(causal, cb * torch.exp(decay), 0.0) * dtc[..., None, :]
    del cb, decay
    y = att @ xc  # (B,nc,ng,rep,Q,hd)
    del att

    # Each chunk's own state S_c = sum_j exp(cum_last - cum_j) dt_j B_j (x) x_j.
    w = torch.exp(cum[..., -1:] - cum) * dtc  # (B,nc,ng,rep,Q)
    S = (xc * w[..., None]).transpose(-1, -2) @ Bc[:, :, :, None]  # (B,nc,ng,rep,hd,ds)

    # Across chunks: y += exp(cum_i) C_i . h_in, with h_in carried chunk to chunk.
    Ce = Cc[:, :, :, None] * torch.exp(cum)[..., None]  # (B,nc,ng,rep,Q,ds)
    h = h0.reshape(Bsz, ng, rep, hd, ds)
    decay_last = torch.exp(cum[..., -1])  # (B,nc,ng,rep)
    carried = []
    for c in range(nc):
        carried.append(Ce[:, c] @ h.transpose(-1, -2))  # (B,ng,rep,Q,hd)
        h = h * decay_last[:, c, :, :, None, None] + S[:, c]
    y = y + torch.stack(carried, dim=1)
    y = y.permute(0, 1, 4, 2, 3, 5).reshape(Bsz, Tp, nh, hd)[:, :T]
    return y, h.reshape(Bsz, nh, hd, ds)


class _Step(NamedTuple):
    """What every layer of one forward shares, made once per forward."""

    valid: torch.Tensor  # (B, T, 1) bool: token t < seqlens
    taps_idx: torch.Tensor  # (B, K-1, conv_dim) int64: seqlens + arange(K-1)
    zero: torch.Tensor  # () fp32


def _conv(
    xbc: torch.Tensor,  # (B, T, C) model dtype, padding tokens zeroed
    prev: torch.Tensor,  # (B, K-1, C) carried taps
    lw: Params,
):
    """Depthwise causal conv with a carried state (replaces causal_conv1d):
    the K taps summed in order in the model dtype. Returns (the conv before
    its activation, the padded input [prev ++ xbc])."""
    T = xbc.shape[1]
    full = torch.cat([prev, xbc], dim=1)
    w = lw["conv_w"].unbind(0)
    conv = full[:, :T] * w[0]
    for k in range(1, len(w)):
        conv = conv + full[:, k : k + T] * w[k]
    return conv + lw["conv_b"], full


def _mixer(
    lw: Params,
    x: torch.Tensor,  # (B, T, D) normed, model dtype
    step: _Step,
    state: MambaState,
    li: int,
    args: MambaArgs,
    chunk: int,
    write_state: bool,
    mesh: Optional[Mesh] = None,
    batch: Optional[int] = None,
) -> torch.Tensor:
    B, T, _ = x.shape
    tp = 1 if mesh is None else mesh.tensor
    di, ng, ds = args.d_inner // tp, args.n_groups // tp, args.d_state
    nh, hd = args.n_ssm_heads // tp, args.headdim
    gd = ng * ds
    rows = None if batch is None else batch * T  # one device's: the route
    zxbc = linear(x, lw["in_proj"], rows)
    dt_raw = fixed_rows_linear(x, lw["dt_proj"])  # dense (quant/weights.py); row-stable
    if tp > 1:
        dt_raw = dt_raw[..., mesh.t * nh:(mesh.t + 1) * nh]  # this rank's heads
    z = zxbc[..., :di]
    xbc = torch.where(step.valid, zxbc[..., di:], 0.0)
    conv, full = _conv(xbc, state.conv[li], lw)
    if write_state:
        # The new taps: each row's last K-1 valid inputs (a short row reaches
        # back into the carried state; a row with seqlens 0 keeps it).
        state.conv[li] = full.gather(1, step.taps_idx)
    xbc = F.silu(conv)
    xs = xbc[..., :di].reshape(B, T, nh, hd).float()
    Bm = xbc[..., di : di + gd].float()
    Cm = xbc[..., di + gd :].float()

    A = -torch.exp(lw["A_log"])
    # softplus as ``jax.nn.softplus`` computes it, logaddexp(x, 0), with no
    # switch to x above a threshold; 0 for padding tokens.
    dt = torch.where(step.valid, torch.logaddexp(dt_raw.float() + lw["dt_bias"], step.zero), 0.0)
    if T == 1 and write_state:
        y = fused_ssd_step_stacked(
            torch.exp(dt[:, 0] * A), dt[:, 0, :, None] * xs[:, 0],
            Bm.reshape(B, ng, ds).contiguous(), Cm.reshape(B, ng, ds).contiguous(), state.ssm,
            li,
        )[:, None]
    else:
        y, h_new = _ssd_chunked(
            xs, dt, A, Bm.reshape(B, T, ng, ds), Cm.reshape(B, T, ng, ds),
            state.ssm[li].float(), chunk,
        )
        if write_state:
            state.ssm[li] = h_new  # rounds once to a bf16 state
    y = (y + lw["D"][:, None] * xs).reshape(B, T, di).to(x.dtype)
    # Gated RMSNorm: rms_norm(y * silu(z)) * weight (mamba_ssm's RMSNormGated),
    # over every channel of d_inner: a rank's channels are gathered first.
    y = _gated_norm(gather(y * F.silu(z), mesh, "tensor", -1), lw["mixer_norm"])
    return gather(linear(y, lw["out_proj"], rows), mesh, "tensor", -1)


def _gated_norm(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``rms_norm`` over the d_inner channels of ``x``, its sum of squares
    in fp32."""
    xf = x.float()
    normed = xf * torch.rsqrt((xf * xf).sum(-1, keepdim=True) / x.shape[-1] + MAMBA_NORM_EPS)
    return normed.to(x.dtype) * weight


def apply_head(h: torch.Tensor, params: Params, args: MambaArgs,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """(..., D) hidden -> (..., vocab_size) fp32 prelogits, tied or not,
    each row's bits its own (``fixed_rows_linear``). Under a mesh this
    rank's vocab rows (of the replicated embedding, when tied), all-gathered
    over ``tensor``."""
    if mesh is None:
        w = params["embedding"] if args.tie_embeddings else params["lm_head"]
        return fixed_rows_linear(h, w).float()[..., : args.vocab_size]
    if args.tie_embeddings:
        V = params["embedding"].shape[0]
        w = params["embedding"][mesh.t * V // mesh.tensor:(mesh.t + 1) * V // mesh.tensor]
    else:
        w = params["lm_head"]
    logits = fixed_rows_linear(h, w).float()
    return mesh.all_gather(logits, "tensor", -1)[..., : args.vocab_size]


def forward(
    params: Params,
    tokens: torch.Tensor,  # (B, T) int
    seqlens: torch.Tensor,  # (B,) valid tokens per row in this chunk
    state: MambaState,
    args: MambaArgs,
    chunk: int = DEFAULT_CHUNK,
    head: str = "full",
    write_state: bool = True,
    mesh: Optional[Mesh] = None,
    batch: Optional[int] = None,
) -> torch.Tensor:
    """One chunk pass (a prefill chunk, one decode step or a verify chunk),
    under ``mesh`` on this rank's heads of every row given; ``batch``, the
    global batch where ``tokens`` holds a data rank's rows of it, routes
    the products by one device's row count.
    Returns prelogits (B, T, vocab_size) fp32, or with ``head="none"`` the
    final-norm hidden states (B, T, D). ``chunk`` is the SSD's chunk length.

    The state is updated IN PLACE; with ``write_state=False`` (speculative
    verify) the chunk is scored and the state is left as it was."""
    B, T = tokens.shape
    dev = tokens.device
    seqlens = seqlens.to(torch.int32)
    taps = seqlens.long()[:, None] + torch.arange(args.d_conv - 1, device=dev)[None, :]
    step = _Step(
        valid=(torch.arange(T, device=dev)[None, :] < seqlens[:, None])[..., None],
        taps_idx=taps[..., None].expand(-1, -1, state.conv.shape[-1]),
        zero=torch.zeros((), dtype=torch.float32, device=dev),
    )
    dtype = params["embedding"].dtype
    h = F.embedding(tokens.long(), params["embedding"])
    if args.residual_in_fp32:
        h = h.float()
    for li, lw in enumerate(params["layers"]):
        x = rms_norm(h.to(dtype), lw["norm"], MAMBA_NORM_EPS)
        out = _mixer(lw, x, step, state, li, args, chunk, write_state, mesh, batch)
        h = h + out.to(h.dtype)
    if write_state:
        state.seen += seqlens
    h = rms_norm(h.to(dtype), params["norm_f"], MAMBA_NORM_EPS)
    return h if head == "none" else apply_head(h, params, args, mesh)
