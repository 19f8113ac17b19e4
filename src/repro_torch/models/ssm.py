"""State-space / linear-recurrence blocks: Mamba2 (SSD) and RWKV6.

Port of ``repro.models.ssm``.  Mamba2 prefills with the chunked SSD form
(intra-chunk attention-like einsums plus an inter-chunk state scan, keeping
the reference's per-chunk state snapshots in the compute dtype) and
decodes with the O(1) recurrence; :func:`mamba_recurrent_ref` steps that
recurrence over a sequence, the oracle of :func:`mamba_ssd`.  The reference
computes Mamba2 outside any Pallas kernel, so it stays plain PyTorch here.

RWKV6 ("Finch") keeps the paper's data-dependent decay.  The WKV recurrence
runs through :func:`repro_torch.kernels.wkv.wkv`: on CUDA the hand-written
kernel runs the prefill (the prompt) in parallel chunks and decode (one step)
with each (batch, head) state on chip, in place of the reference's two-level
``lax.scan``; on the CPU its plain twin steps the same recurrence.

Both blocks train under autograd (no in-place writes on the training
path), the weights of two or more dimensions cast to the compute dtype
where they are used, as the reference casts them per super-block.  Mamba2
is plain PyTorch; RWKV6's WKV runs through the ``WKV`` autograd Function:
on CUDA the forward kernel, then the hand-written backward kernel
(``csrc/wkv_bwd.cu``), on the CPU their plain twins.

Sharded over a model axis (``axis``, :mod:`repro_torch.sharding`), each
block runs on the rank's heads, its state theirs: Mamba2 from its heads'
columns of ``in_proj`` and ``conv_w`` and all of B and C, its gated
RMSNorm's variance summed over the axis and ``out_proj`` row-parallel;
RWKV6 through the WKV kernels on its heads, ``Wo`` row-parallel and the
channel mix as :func:`rwkv_channel_mix` says.  Replicated parameters a
rank reads only for its heads enter through ``MeshAxis.copy``
(:func:`_part`), so that their gradients come out whole on every rank.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.wkv import wkv
from repro_torch.models.layers import (
    Keep, MeshAxis, dense_init, keep_all, mm, mm_f32, param, randn, reduce_sum)

# ===========================================================================
# Mamba2
# ===========================================================================


class MambaState(NamedTuple):
    h: torch.Tensor        # (B, H, hd, N) float32 SSM state
    conv: torch.Tensor     # (B, W - 1, conv_ch) conv tail, in the compute dtype


def mamba_dims(cfg: ArchConfig) -> tuple[int, int, int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    hd = cfg.ssm_head_dim
    H = d_in // hd
    N = cfg.ssm_state
    return d_in, hd, H, N


class Mamba(nn.Module):
    """One Mamba2 layer's parameters, named as the reference's pytree keys."""

    NAMES = ("ln", "in_proj", "conv_w", "conv_b", "A_log", "D_skip", "dt_bias",
             "out_norm", "out_proj")

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        if set(tensors) != set(self.NAMES):
            raise ValueError(f"Mamba takes exactly {self.NAMES}, got {sorted(tensors)}")
        for name in self.NAMES:
            setattr(self, name, param(tensors[name]))


def init_mamba(gen, cfg: ArchConfig, device, keep: Keep = keep_all) -> Mamba:
    d = cfg.d_model
    d_in, hd, H, N = mamba_dims(cfg)
    conv_ch = d_in + 2 * N
    f32 = dict(dtype=torch.float32, device=device)
    return Mamba(
        ln=torch.zeros((d,), **f32),
        in_proj=keep("in_proj", dense_init(gen, d, 2 * d_in + 2 * N + H, device)),
        conv_w=keep("conv_w", 0.1 * randn(gen, (cfg.conv_width, conv_ch), device)),
        conv_b=torch.zeros((conv_ch,), **f32),
        A_log=torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        D_skip=torch.ones((H,), **f32),
        dt_bias=torch.log(torch.expm1(0.01 * torch.ones((H,), **f32))),
        out_norm=torch.zeros((d_in,), **f32),
        out_proj=keep("out_proj", dense_init(gen, d_in, d, device)),
    )


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via shifted adds, in xbc's dtype (as the
    reference adds its bfloat16 products), then SiLU in float32 after the
    float32 bias. xbc: (B, S, C); w: (W, C)."""
    W = w.shape[0]
    w = w.to(xbc.dtype)
    out = xbc * w[-1][None, None, :]
    for i in range(1, W):
        shifted = F.pad(xbc, (0, 0, i, 0))[:, : xbc.shape[1]]
        out = out + shifted * w[-1 - i][None, None, :]
    return F.silu(out + b[None, None, :])


def _part(t: torch.Tensor, axis: Optional[MeshAxis], dim: int = -1) -> torch.Tensor:
    """A parameter a rank holds whole but uses only for its heads: the
    rank's 1 / size piece of it along ``dim``, the whole entering through
    ``MeshAxis.copy``, so that its gradient (zero outside the piece) is
    summed over the axis: whole on every rank."""
    if axis is None:
        return t
    n = t.shape[dim] // axis.size
    return axis.copy(t).narrow(dim, axis.rank * n, n)


def local_mamba_dims(cfg: ArchConfig, axis: Optional[MeshAxis]) -> tuple[int, int, int, int]:
    """:func:`mamba_dims` of one rank: its d_in / size channels and H / size
    heads (B and C, N wide, are whole on every rank)."""
    d_in, hd, H, N = mamba_dims(cfg)
    n = 1 if axis is None else axis.size
    return d_in // n, hd, H // n, N


class _MambaWeights(NamedTuple):
    in_proj: torch.Tensor
    conv_w: torch.Tensor
    conv_b: torch.Tensor
    A_log: torch.Tensor
    D_skip: torch.Tensor
    dt_bias: torch.Tensor
    out_norm: torch.Tensor
    out_proj: torch.Tensor


def _mamba_weights(params: Mamba, cfg: ArchConfig, axis: Optional[MeshAxis]) -> _MambaWeights:
    """The weights as a rank uses them.  It holds its heads' columns of
    ``in_proj`` (z | x | dt) and ``conv_w`` (x) and all of B and C
    (:func:`repro_torch.sharding.mamba_parts`): every rank computes B and C
    alike, for its own heads, so those columns enter through
    ``MeshAxis.copy`` (their gradients' partials summed), as do the
    replicated vectors it reads its heads' entries of (:func:`_part`)."""
    w = _MambaWeights(*(getattr(params, f) for f in _MambaWeights._fields))
    if axis is None:
        return w
    d_in, _, _, N = local_mamba_dims(cfg, axis)

    def bc_copied(t, at):   # columns [at, at + 2N): all of B and C
        return torch.cat([t[..., :at], axis.copy(t[..., at:at + 2 * N]), t[..., at + 2 * N:]], -1)

    conv_b = axis.copy(params.conv_b)
    return w._replace(
        in_proj=bc_copied(params.in_proj, 2 * d_in), conv_w=bc_copied(params.conv_w, d_in),
        conv_b=torch.cat([conv_b[axis.rank * d_in:(axis.rank + 1) * d_in],
                          conv_b[d_in * axis.size:]]),
        A_log=_part(params.A_log, axis), D_skip=_part(params.D_skip, axis),
        dt_bias=_part(params.dt_bias, axis), out_norm=_part(params.out_norm, axis))


def _split_proj(w: _MambaWeights, cfg: ArchConfig, u: torch.Tensor, dtype: torch.dtype,
                axis: Optional[MeshAxis] = None):
    d_in, hd, H, N = local_mamba_dims(cfg, axis)
    proj = mm(u, w.in_proj, dtype)                        # (B, S, 2 d_in + 2N + H)
    z = proj[..., :d_in]
    xbc = proj[..., d_in: 2 * d_in + 2 * N]
    dt_raw = proj[..., 2 * d_in + 2 * N:].float()
    return z, xbc, dt_raw


def _einsum32(eq: str, *operands: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``einsum`` of operands rounded to ``dtype``, summed and returned in
    float32 (the reference's ``preferred_element_type=float32``)."""
    return torch.einsum(eq, *(a.to(dtype).float() for a in operands))


def _gated_out(w: _MambaWeights, y: torch.Tensor, z: torch.Tensor, dtype: torch.dtype,
               axis: Optional[MeshAxis] = None):
    """Gated RMSNorm and the output projection. y: float32 (B, S, d_in).
    Sharded, the variance runs over every rank's channels (the sum of
    squares summed over the axis) and ``out_proj`` is row-parallel."""
    y = y * F.silu(z.float())
    if axis is None:
        var = torch.mean(y * y, dim=-1, keepdim=True)
    else:
        var = axis.sum(torch.sum(y * y, dim=-1, keepdim=True)) / (y.shape[-1] * axis.size)
    y = y * torch.rsqrt(var + 1e-5) * (1.0 + w.out_norm)
    if axis is None:
        return mm(y.to(dtype), w.out_proj, dtype)
    return reduce_sum(mm_f32(y, w.out_proj, dtype), axis, dtype)


def mamba_ssd(params: Mamba, cfg: ArchConfig, u: torch.Tensor, dtype: torch.dtype,
              return_state: bool = False, axis: Optional[MeshAxis] = None):
    """Prefill forward. u: (B, S, D) (pre-normed) -> (B, S, D) in ``dtype``,
    or (out, final :class:`MambaState`) when ``return_state``.  Over a model
    ``axis`` the rank runs its heads (the state is theirs)."""
    B, S0, D = u.shape
    d_in, hd, H, N = local_mamba_dims(cfg, axis)
    Q = min(cfg.ssd_chunk, S0)
    pad = (-S0) % Q
    S = S0 + pad

    if axis is not None:   # the replicated input meets the rank's columns
        u = axis.copy(u)
    w = _mamba_weights(params, cfg, axis)
    z, xbc_raw, dt_raw = _split_proj(w, cfg, u, dtype, axis)
    xbc = _causal_conv(xbc_raw, w.conv_w, w.conv_b)
    if pad:
        xbc = F.pad(xbc, (0, 0, 0, pad))
        dt_raw = F.pad(dt_raw, (0, 0, 0, pad))
    nc = S // Q
    x = xbc[..., :d_in].reshape(B, S, H, hd)
    Bm = xbc[..., d_in: d_in + N].float()                 # (B, S, N)
    Cm = xbc[..., d_in + N:].float()                      # (B, S, N)
    dt = F.softplus(dt_raw + w.dt_bias)                   # (B, S, H)
    if pad:
        # Padded positions neither inject input nor decay the state:
        # dt -> 0 gives x_dt = 0 and log_a = 0 (a = 1).
        valid = (torch.arange(S, device=u.device) < S0)[None, :, None]
        dt = torch.where(valid, dt, 0.0)
    log_a = -torch.exp(w.A_log)[None, None] * dt          # (B, S, H) <= 0

    xq = x.reshape(B, nc, Q, H, hd)
    Bq = Bm.reshape(B, nc, Q, N)
    Cq = Cm.reshape(B, nc, Q, N)
    dtq = dt.reshape(B, nc, Q, H)
    cum = torch.cumsum(log_a.reshape(B, nc, Q, H), dim=2)     # (B, nc, Q, H)

    x_dt = xq.float() * dtq[..., None]                    # (B, nc, Q, H, hd)

    # ---- intra-chunk (attention-like, causal) ----
    scores = torch.einsum("bcjn,bcin->bcji", Cq, Bq)      # (B, nc, Q, Q)
    # the decay from i to j <= i, the exponent masked before exp: the
    # reference masks after it, and once a chunk's decay passes float32's
    # range the masked exp(+large) is inf and its gradient inf * 0 = NaN
    # (the values are the same)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=u.device))
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, j, i, H)
    decay = torch.exp(torch.where(mask[None, None, :, :, None], seg, float("-inf")))
    M = scores[..., None] * decay
    y_intra = _einsum32("bcjih,bcihp->bcjhp", M, x_dt, dtype=dtype)

    # ---- chunk boundary states ----
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)     # (B, nc, Q, H)
    S_c = _einsum32("bcin,bcihp->bchpn", Bq, x_dt * decay_to_end[..., None], dtype=dtype)
    chunk_decay = torch.exp(cum[:, :, -1, :])             # (B, nc, H)

    # The carried state stays float32; the per-chunk snapshots (state at
    # each chunk's start) are kept in the compute dtype, as the reference
    # stores them for its compute-dtype y_inter einsum.
    h = torch.zeros((B, H, hd, N), dtype=torch.float32, device=u.device)
    starts = []
    for c in range(nc):
        starts.append(h.to(dtype))
        h = chunk_decay[:, c, :, None, None] * h + S_c[:, c]
    h_starts = torch.stack(starts, dim=1)                 # (B, nc, H, hd, N)

    y_inter = _einsum32("bcjn,bcjh,bchpn->bcjhp", Cq, torch.exp(cum), h_starts, dtype=dtype)

    y = (y_intra + y_inter).reshape(B, S, H, hd)
    y = y + w.D_skip[None, None, :, None] * xq.reshape(B, S, H, hd).float()
    out = _gated_out(w, y.reshape(B, S, d_in)[:, :S0], z, dtype, axis)
    if not return_state:
        return out
    conv_tail = xbc_raw[:, -(cfg.conv_width - 1):].to(dtype)
    return out, MambaState(h, conv_tail)


def mamba_decode(params: Mamba, cfg: ArchConfig, u: torch.Tensor, state: MambaState,
                 dtype: torch.dtype, axis: Optional[MeshAxis] = None
                 ) -> tuple[torch.Tensor, MambaState]:
    """Single-token recurrence. u: (B, 1, D) -> ((B, 1, D), new state)."""
    B = u.shape[0]
    d_in, hd, H, N = local_mamba_dims(cfg, axis)
    if axis is not None:
        u = axis.copy(u)
    w = _mamba_weights(params, cfg, axis)
    z, xbc, dt_raw = _split_proj(w, cfg, u, dtype, axis)  # (B, 1, ...)
    # conv over [state.conv ; xbc_t]
    seq = torch.cat([state.conv, xbc.to(state.conv.dtype)], dim=1)   # (B, W, ch)
    conv_out = torch.einsum("bwc,wc->bc", seq.float(), w.conv_w.float())
    xbc_t = F.silu(conv_out + w.conv_b)                   # (B, ch)
    new_conv = seq[:, 1:]

    x_t = xbc_t[:, :d_in].reshape(B, H, hd)
    B_t = xbc_t[:, d_in: d_in + N]
    C_t = xbc_t[:, d_in + N:]
    dt = F.softplus(dt_raw[:, 0] + w.dt_bias)             # (B, H)
    a = torch.exp(-torch.exp(w.A_log)[None] * dt)         # (B, H)

    h = a[..., None, None] * state.h + torch.einsum(
        "bn,bhp->bhpn", B_t, x_t.float() * dt[..., None])
    y = torch.einsum("bn,bhpn->bhp", C_t, h)
    y = y + w.D_skip[None, :, None] * x_t.float()
    out = _gated_out(w, y.reshape(B, 1, d_in), z, dtype, axis)
    return out, MambaState(h, new_conv)


def init_mamba_state(cfg: ArchConfig, batch: int, dtype: torch.dtype, device,
                     axis: Optional[MeshAxis] = None) -> MambaState:
    """A zero state; over a model ``axis`` the rank's heads of ``h`` and its
    conv channels (its x channels, all of B and C) of the tail."""
    d_in, hd, H, N = local_mamba_dims(cfg, axis)
    conv_ch = d_in + 2 * N
    return MambaState(
        torch.zeros((batch, H, hd, N), dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.conv_width - 1, conv_ch), dtype=dtype, device=device),
    )


def mamba_recurrent_ref(params: Mamba, cfg: ArchConfig, u: torch.Tensor,
                        dtype: torch.dtype) -> torch.Tensor:
    """Naive per-token recurrence: the oracle of :func:`mamba_ssd`."""
    B, S, D = u.shape
    state = init_mamba_state(cfg, B, dtype, u.device)
    outs = []
    for t in range(S):
        out, state = mamba_decode(params, cfg, u[:, t:t + 1], state, dtype)
        outs.append(out[:, 0])
    return torch.stack(outs, dim=1)


# ===========================================================================
# RWKV6
# ===========================================================================


class RWKVState(NamedTuple):
    wkv: torch.Tensor      # (B, H, hd, hd) float32
    x_tm: torch.Tensor     # (B, D) last input to time-mix
    x_cm: torch.Tensor     # (B, D) last input to channel-mix


def rwkv_dims(cfg: ArchConfig) -> tuple[int, int]:
    hd = cfg.rwkv_head_dim
    H = cfg.d_model // hd
    return H, hd


class RWKV(nn.Module):
    """One RWKV6 layer's parameters, named as the reference's pytree keys."""

    NAMES = ("ln1", "ln2", "mu", "Wr", "Wk", "Wv", "Wg", "Wo", "w_base", "w_A",
             "w_B", "u", "ln_x", "mu_c", "Wck", "Wcv", "Wcr")

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        if set(tensors) != set(self.NAMES):
            raise ValueError(f"RWKV takes exactly {self.NAMES}, got {sorted(tensors)}")
        for name in self.NAMES:
            setattr(self, name, param(tensors[name]))


def init_rwkv(gen, cfg: ArchConfig, device, keep: Keep = keep_all) -> RWKV:
    d, f = cfg.d_model, cfg.d_ff
    H, hd = rwkv_dims(cfg)
    lora = 64

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    def dense(name, d_in, d_out):
        return keep(name, dense_init(gen, d_in, d_out, device))

    return RWKV(
        ln1=full((d,), 0.0),
        ln2=full((d,), 0.0),
        mu=full((5, d), 0.5),                       # r,k,v,g,w token-shift mix
        Wr=dense("Wr", d, d),
        Wk=dense("Wk", d, d),
        Wv=dense("Wv", d, d),
        Wg=dense("Wg", d, d),
        Wo=dense("Wo", d, d),
        w_base=full((d,), -6.0),                    # decay ~ exp(-exp(-6)): slow
        w_A=keep("w_A", 0.01 * randn(gen, (d, lora), device)),
        w_B=keep("w_B", 0.01 * randn(gen, (lora, d), device)),
        u=keep("u", 0.1 * randn(gen, (H, hd), device)),
        ln_x=full((d,), 0.0),
        mu_c=full((2, d), 0.5),                     # channel-mix k,r
        Wck=dense("Wck", d, f),
        Wcv=dense("Wcv", f, d),
        Wcr=dense("Wcr", d, d),
    )


def _rwkv_projections(params: RWKV, cfg: ArchConfig, x: torch.Tensor,
                      x_prev: torch.Tensor, dtype: torch.dtype,
                      axis: Optional[MeshAxis] = None):
    """x, x_prev: (B, S, D) -> r, k, v (B, S, H, hd), g (B, S, D), w float32;
    over a model ``axis`` the rank's H / size heads (D / size channels of g
    and w), from its columns of Wr, Wk, Wv, Wg and w_B.  Every rank forms
    the token-shift mix and the decay's low-rank hidden alike, for its own
    heads, so ``mu``, ``w_A``, ``w_B`` and ``w_base`` enter through
    ``MeshAxis.copy`` (:func:`_part`)."""
    B, S, D = x.shape
    H, hd = rwkv_dims(cfg)
    H //= 1 if axis is None else axis.size
    copied = (lambda t: t) if axis is None else axis.copy
    mu = copied(params.mu).to(dtype)   # every weight of two or more dims in the compute dtype

    def mixed(i):
        return x + mu[i][None, None] * (x_prev - x)

    r = mm(mixed(0), params.Wr, dtype).reshape(B, S, H, hd)
    k = mm(mixed(1), params.Wk, dtype).reshape(B, S, H, hd)
    v = mm(mixed(2), params.Wv, dtype).reshape(B, S, H, hd)
    g = mm(mixed(3), params.Wg, dtype)
    # data-dependent decay (the RWKV6 contribution)
    ww = _part(params.w_base, axis)[None, None] + mm(
        torch.tanh(mm(mixed(4), copied(params.w_A), dtype)), _part(params.w_B, axis), dtype
    ).float()
    w = torch.exp(-torch.exp(ww)).reshape(B, S, H, hd)   # in (0, 1)
    return r, k, v, g, w


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor]) -> torch.Tensor:
    """x shifted one step later in time; position 0 gets ``last`` (or zeros)."""
    x_prev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    if last is not None:
        x_prev[:, 0] = last.to(x.dtype)
    return x_prev


def rwkv_time_mix(params: RWKV, cfg: ArchConfig, x: torch.Tensor,
                  state: Optional[RWKVState], dtype: torch.dtype,
                  axis: Optional[MeshAxis] = None
                  ) -> tuple[torch.Tensor, Optional[RWKVState]]:
    """Time-mix over a sequence (prefill, or decode with S = 1). x: (B, S, D).
    Over a model ``axis`` the WKV kernel and the group norm run on the
    rank's heads (its state theirs) and ``Wo`` is row-parallel."""
    B, S, D = x.shape
    H, hd = rwkv_dims(cfg)
    if axis is not None:   # the replicated input meets the rank's heads
        x = axis.copy(x)
        H //= axis.size
    x_prev = _token_shift(x, None if state is None else state.x_tm)
    r, k, v, g, w = _rwkv_projections(params, cfg, x, x_prev, dtype, axis)

    # r, k, v in the compute dtype: the kernel converts bfloat16 on load
    outs, wkv_state = wkv(r, k, v, w, _part(params.u, axis, 0).to(dtype),
                          None if state is None else state.wkv)
    y = outs.reshape(B, S, H * hd)                         # float32

    # per-head group norm
    yh = y.reshape(B, S, H, hd)
    mu_ = yh.mean(dim=-1, keepdim=True)
    var = yh.var(dim=-1, keepdim=True, unbiased=False)
    yh = (yh - mu_) * torch.rsqrt(var + 1e-5)
    y = yh.reshape(B, S, H * hd) * (1.0 + _part(params.ln_x, axis))
    y = y.to(dtype) * F.silu(g)
    if axis is None:
        out = mm(y, params.Wo, dtype)
    else:   # row-parallel Wo: the rank's heads give a partial sum
        out = reduce_sum(mm_f32(y, params.Wo, dtype), axis, dtype)
    new_state = None
    if state is not None:
        new_state = RWKVState(wkv_state, x[:, -1].float(), state.x_cm)
    return out, new_state


def rwkv_channel_mix(params: RWKV, cfg: ArchConfig, x: torch.Tensor,
                     state: Optional[RWKVState], dtype: torch.dtype,
                     axis: Optional[MeshAxis] = None
                     ) -> tuple[torch.Tensor, Optional[RWKVState]]:
    """``sigmoid(xr Wcr) * (relu(xk Wck)^2 Wcv)``.  Over a model ``axis``
    Wck and Wcr are column-parallel (the rank's F / size hidden channels and
    D / size gate channels) and Wcv row-parallel (a partial sum over all D).
    The product needs the gate and the sum on the same channels: the
    partial sums are reduce-scattered to the rank's D / size channels,
    gated there and the pieces gathered (``MeshAxis.scatter_sum``,
    ``concat``).  That moves one D-wide activation each way, where
    all-reducing the sums and gathering the gate would move two: an
    all-reduce is a reduce-scatter and a gather."""
    if axis is not None:
        x = axis.copy(x)
    x_prev = _token_shift(x, None if state is None else state.x_cm)
    mu = (params.mu_c if axis is None else axis.copy(params.mu_c)).to(dtype)
    xk = x + mu[0][None, None] * (x_prev - x)
    xr = x + mu[1][None, None] * (x_prev - x)
    kk = torch.square(F.relu(mm(xk, params.Wck, dtype)))
    gate = torch.sigmoid(mm(xr, params.Wcr, dtype).float()).to(dtype)
    if axis is None:
        out = gate * mm(kk, params.Wcv, dtype)
    else:
        summed = axis.scatter_sum(mm_f32(kk, params.Wcv, dtype), -1).to(dtype)
        out = axis.concat(gate * summed, -1)
    new_state = None
    if state is not None:
        new_state = RWKVState(state.wkv, state.x_tm, x[:, -1].float())
    return out, new_state


def init_rwkv_state(cfg: ArchConfig, batch: int, device,
                    axis: Optional[MeshAxis] = None) -> RWKVState:
    """A zero state; over a model ``axis`` the rank's heads of ``wkv``
    (``x_tm`` and ``x_cm`` are whole)."""
    H, hd = rwkv_dims(cfg)
    H //= 1 if axis is None else axis.size
    return RWKVState(
        torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device),
        torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device),
    )
