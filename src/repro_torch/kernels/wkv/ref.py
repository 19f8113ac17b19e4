"""Plain oracles for the WKV6 recurrence kernel (port of ``repro.kernels.wkv.ref``).

:func:`wkv_ref` steps the recurrence one time step at a time, as the
reference does.  :func:`wkv_chunked_ref` computes the same function by the
CUDA kernel's chunked route (``repro_torch/csrc/wkv.cu``), in plain PyTorch:
per-chunk state contributions, a scan over the chunks, then per-chunk
outputs, each chunk walked in sub-blocks.  Every decay factor is a product
of w's, never a quotient, so no factor overflows however fast the decay.
"""
from __future__ import annotations

from typing import Optional

import torch


def wkv_ref(r, k, v, w, u, state0: Optional[torch.Tensor] = None):
    """RWKV6 WKV recurrence, one time step at a time in float32.

    r, k, v, w: (B, S, H, hd); u: (H, hd); state0: (B, H, hd, hd) or None.
    Returns (out (B, S, H, hd), final_state):
      out_t = r_t . (u k_t v_t^T + S_t);  S_{t+1} = diag(w_t) S_t + k_t v_t^T
    """
    B, S, H, hd = r.shape
    s = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float())
    u = u.float()
    r, k, v, w = (a.float() for a in (r, k, v, w))
    outs = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s + u[None, :, :, None] * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(outs, dim=1), s


def _exclusive_cumprod(w: torch.Tensor, dim: int, reverse: bool = False) -> torch.Tensor:
    """Products of w along ``dim`` before each position (after it when
    ``reverse``), 1 at the first (last) position."""
    if reverse:
        return _exclusive_cumprod(w.flip(dim), dim).flip(dim)
    ones = torch.ones_like(w.narrow(dim, 0, 1))
    return torch.cat([ones, torch.cumprod(w, dim).narrow(dim, 0, w.shape[dim] - 1)], dim)


def _pair_decays(w: torch.Tensor) -> torch.Tensor:
    """w (..., T, hd) -> f (..., T, T, hd): f[t, s] = prod_{s<m<t} w_m for
    s < t (1 at s = t - 1), 0 for s >= t; built by multiplying forward."""
    T = w.shape[-2]
    rows = [torch.zeros_like(w)]
    for t in range(1, T):
        prev = rows[-1].clone()
        prev[..., : t - 1, :] *= w[..., t - 1 : t, :]
        prev[..., t - 1, :] = 1.0
        rows.append(prev)
    return torch.stack(rows, dim=-3)


def wkv_chunked_ref(r, k, v, w, u, state0: Optional[torch.Tensor] = None, *,
                    chunk: Optional[int] = None, sub: int = 16):
    """The WKV6 recurrence by the chunked route, in float32.

    Same arguments and result as :func:`wkv_ref`.  The sequence is cut into
    chunks of ``chunk`` steps (by default the kernel's ``wkv.CHUNK``; the
    last padded with r = k = v = 0, w = 1, which leave the state unchanged),
    each chunk into sub-blocks of ``sub``.

    1. For every chunk, its state contribution dS_c (the chunk run from a
       zero state) and its decay D_c = prod_t w_t.
    2. The scan S_{c+1} = D_c * S_c + dS_c from state0 gives each chunk's
       start state and the final state.
    3. For every chunk, from its start state, per sub-block starting at b:
       out_t = (lp_t r_t)^T S_b + sum_{b<=s<t} (sum_i r_t k_s prod_{s<m<t} w_m) v_s
               + (r_t . (u k_t)) v_t,  S_{b+sub} = lp_end S_b + sum_s (ls_s k_s) v_s^T
       with lp_t the product of w from b up to t and ls_s from s to the end.
    """
    if chunk is None:
        from repro_torch.kernels.wkv.wkv import CHUNK as chunk   # wkv imports this module
    if chunk <= 0 or sub <= 0 or chunk % sub:
        raise ValueError(f"chunk {chunk} must be a positive multiple of sub {sub}")
    B, S, H, hd = r.shape
    n = -(-S // chunk)
    pad = n * chunk - S

    def blocks(a, fill):
        a = a.float()
        if pad:
            a = torch.cat([a, a.new_full((B, pad, H, hd), fill)], dim=1)
        # (B, H, chunks, sub-blocks, sub, hd)
        return a.reshape(B, n, chunk // sub, sub, H, hd).permute(0, 4, 1, 2, 3, 5)

    r, k, v = (blocks(a, 0.0) for a in (r, k, v))
    w = blocks(w, 1.0)
    u = u.float()[None, :, None, None, :]   # (1, H, 1, 1, hd)
    lp = _exclusive_cumprod(w, -2)           # prod_{b<=m<t} w_m
    ls = _exclusive_cumprod(w, -2, reverse=True)   # prod_{s<m<end} w_m
    lp_end = lp[..., -1, :] * w[..., -1, :]  # (B, H, chunks, sub-blocks, hd)
    kd = ls * k

    def advance(state, j):
        """The state after sub-block j of every chunk."""
        return (lp_end[:, :, :, j, :, None] * state
                + torch.einsum("bhcsi,bhcsj->bhcij", kd[:, :, :, j], v[:, :, :, j]))

    # phase 1: chunk contributions and decays
    dS = r.new_zeros((B, H, n, hd, hd))
    for j in range(chunk // sub):
        dS = advance(dS, j)
    D = torch.prod(lp_end, dim=3)            # (B, H, chunks, hd)

    # phase 2: the scan over chunks
    s = (r.new_zeros((B, H, hd, hd)) if state0 is None else state0.float())
    starts = []
    for c in range(n):
        starts.append(s)
        s = D[:, :, c, :, None] * s + dS[:, :, c]
    state = torch.stack(starts, dim=2)       # (B, H, chunks, hd, hd)

    # phase 3: outputs
    outs = []
    for j in range(chunk // sub):
        rj, kj, vj = r[:, :, :, j], k[:, :, :, j], v[:, :, :, j]
        inter = torch.einsum("bhcti,bhcij->bhctj", lp[:, :, :, j] * rj, state)
        P = torch.einsum("bhcti,bhcsi,bhctsi->bhcts", rj, kj, _pair_decays(w[:, :, :, j]))
        bonus = torch.einsum("bhcti,bhcti->bhct", rj, u * kj)
        P = P + torch.diag_embed(bonus)
        outs.append(inter + torch.einsum("bhcts,bhcsj->bhctj", P, vj))
        state = advance(state, j)
    out = torch.stack(outs, dim=3)           # (B, H, chunks, sub-blocks, sub, hd)
    out = out.permute(0, 2, 3, 4, 1, 5).reshape(B, n * chunk, H, hd)[:, :S]
    return out.contiguous(), s
