"""Plain oracles for the WKV6 recurrence kernel (port of ``repro.kernels.wkv.ref``).

:func:`wkv_ref` steps the recurrence one time step at a time, as the
reference does.  :func:`wkv_recurrent_ref` steps it as the CUDA kernel's
recurrent route (``wkv_step``, decode) does, with the kernel's split of
each state over threads and its order of the ``out[j]`` reduction.
:func:`wkv_chunked_ref` computes the same function by the CUDA kernel's
chunked route (``repro_torch/csrc/wkv.cu``), in plain PyTorch: per-chunk
state contributions, a scan over the chunks, then per-chunk outputs, each
chunk walked in sub-blocks.  Every decay factor is a product of w's, never
a quotient, so no factor overflows however fast the decay.

The backward has two twins.  :func:`wkv_bwd_ref` steps the reverse-time
recurrence one step at a time from every forward state (the CPU path's
backward and the card's yardstick); :func:`wkv_bwd_chunked_ref` computes the
same gradients by the CUDA backward's own schedule
(``repro_torch/csrc/wkv_bwd.cu``).  Neither divides by w: a decay that
underflows to 0 gives the gradient the recurrence gives.
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


# The recurrent kernel's split of a state (csrc/wkv.cu ``Step``): 16 row
# groups, a thread holding rows g + 16 m of 4 columns, the 16 groups of a
# column in one warp.
STEP_ROW_GROUPS = 16


def wkv_recurrent_ref(r, k, v, w, u, state0: Optional[torch.Tensor] = None):
    """The WKV6 recurrence as the recurrent CUDA kernel computes it, float32.

    Same arguments and result as :func:`wkv_ref`.  Per step, ``out[j]`` is
    summed over the state rows in the kernel's order: each row group g's
    rows ``i = g + 16 m`` in order of m, then the 16 row groups by a
    pairwise tree, lower group on the left.  The state update is
    elementwise.
    """
    B, S, H, hd = r.shape
    G = STEP_ROW_GROUPS
    s = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float())
    u = u.float()
    r, k, v, w = (a.float() for a in (r, k, v, w))
    outs = []
    for t in range(S):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]          # (B, H, hd)
        uk = (u[None] * kt)[..., None]
        terms = rt[..., None] * (s + uk * vt[:, :, None, :])         # (B, H, i, j)
        terms = terms.reshape(B, H, hd // G, G, hd)                  # i = g + G m
        part = terms[:, :, 0]
        for m in range(1, hd // G):
            part = part + terms[:, :, m]                              # (B, H, g, j)
        while part.shape[2] > 1:
            part = part[:, :, 0::2] + part[:, :, 1::2]
        outs.append(part[:, :, 0])
        s = wt[..., None] * s + kt[..., None] * vt[:, :, None, :]
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


def _zeros_or(state, shape, like):
    return (like.new_zeros(shape, dtype=torch.float32) if state is None else state.float())


def wkv_bwd_ref(r, k, v, w, u, dout, state0: Optional[torch.Tensor] = None,
                dstateT: Optional[torch.Tensor] = None):
    """Gradients of :func:`wkv_ref`, stepped backward in time in float32.

    ``dout`` (B, S, H, hd) and ``dstateT`` (B, H, hd, hd, or None for zeros)
    are the gradients of the output and of the final state.  Returns (dr,
    dk, dv, dw, du, dstate0), all float32.  With the forward's states S_t
    (kept for every step) and dS_{t+1} the gradient of the state after step
    t, from dS_S = dstateT:

      dr_t = S_t dout_t + u k_t (dout_t . v_t)
      dk_t = r_t u (dout_t . v_t) + dS_{t+1} v_t
      dv_t = (sum_i r_t u k_t) dout_t + dS_{t+1}^T k_t
      dw_t = sum_j dS_{t+1} * S_t;   du += r_t k_t (dout_t . v_t)
      dS_t = diag(w_t) dS_{t+1} + r_t dout_t^T
    """
    B, S, H, hd = r.shape
    r, k, v, w, dout = (a.float() for a in (r, k, v, w, dout))
    u = u.float()
    s = _zeros_or(state0, (B, H, hd, hd), r)
    states = []
    for t in range(S):
        states.append(s)
        s = w[:, t, :, :, None] * s + k[:, t, :, :, None] * v[:, t, :, None, :]
    ds = _zeros_or(dstateT, (B, H, hd, hd), r)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros_like(u)
    for t in reversed(range(S)):
        rt, kt, vt, wt, dot = r[:, t], k[:, t], v[:, t], w[:, t], dout[:, t]   # (B, H, hd)
        st = states[t]
        dov = (dot * vt).sum(-1, keepdim=True)                                  # (B, H, 1)
        dr[:, t] = torch.einsum("bhij,bhj->bhi", st, dot) + u * kt * dov
        dk[:, t] = rt * u * dov + torch.einsum("bhij,bhj->bhi", ds, vt)
        dv[:, t] = ((rt * u * kt).sum(-1, keepdim=True) * dot
                    + torch.einsum("bhij,bhi->bhj", ds, kt))
        dw[:, t] = (ds * st).sum(-1)
        du = du + (rt * kt * dov).sum(0)
        ds = wt[..., None] * ds + rt[..., None] * dot[:, :, None, :]
    return dr, dk, dv, dw, du, ds


def wkv_bwd_chunked_ref(r, k, v, w, u, dout, state0: Optional[torch.Tensor] = None,
                        dstateT: Optional[torch.Tensor] = None, *,
                        starts: Optional[torch.Tensor] = None, chunk: Optional[int] = None,
                        sub: int = 16, cols: int = 16):
    """The gradients of :func:`wkv_bwd_ref` by the CUDA backward's schedule.

    The sequence is cut into chunks of ``chunk`` steps (by default the
    kernel's ``wkv.CHUNK``; the last padded with r = k = v = dout = 0, w = 1,
    which change neither the state nor its gradient), each chunk into
    sub-blocks of ``sub`` steps and the state's columns into slices of
    ``cols``.  ``starts`` (B, H, chunks, hd, hd) are the chunk-start states
    the forward's chunked route keeps; by default they are stepped here.

    1. For every chunk, its share of the state gradient at its start,
       G_c = sum_t (prod_{c0 <= m < t} w_m) r_t dout_t^T, and its decay
       D_c = prod_t w_t (products formed forward, never divided).
    2. The reverse scan dS_start(c) = D_c * dS_end(c) + G_c from dstateT
       gives the gradient at every chunk's end, and dstate0.
    3. For every chunk and slice of columns: the start state of each
       sub-block, stepped forward from the chunk's start state; then the
       sub-blocks last first: its states stepped forward again, then its
       steps walked backward carrying the slice's dS, each step adding the
       slice's part of dr, dk, dw (slices added in order) and writing dv
       for the slice's columns.
    4. du: each chunk's sum over its steps (summed over slices), then
       summed over batch rows and chunks in order.
    """
    if chunk is None:
        from repro_torch.kernels.wkv.wkv import CHUNK as chunk   # wkv imports this module
    if chunk <= 0 or sub <= 0 or chunk % sub:
        raise ValueError(f"chunk {chunk} must be a positive multiple of sub {sub}")
    B, S, H, hd = r.shape
    if cols <= 0 or hd % cols:
        raise ValueError(f"cols {cols} must divide the head dim {hd}")
    n = -(-S // chunk)
    pad = n * chunk - S

    def blocks(a, fill):
        a = a.float()
        if pad:
            a = torch.cat([a, a.new_full((B, pad, H, hd), fill)], dim=1)
        return a.reshape(B, n, chunk, H, hd).permute(0, 3, 1, 2, 4)   # (B, H, n, chunk, hd)

    r, k, v, dout = (blocks(a, 0.0) for a in (r, k, v, dout))
    w = blocks(w, 1.0)
    u = u.float()[None, :, None, :]                                    # (1, H, 1, hd)
    if starts is None:
        s = _zeros_or(state0, (B, H, hd, hd), r)
        kept = []
        for c in range(n):
            kept.append(s)
            for t in range(chunk):
                s = w[:, :, c, t, :, None] * s + k[:, :, c, t, :, None] * v[:, :, c, t, None, :]
        starts = torch.stack(kept, dim=2)
    starts = starts.float()

    # 1. chunk contributions and decays
    f = torch.ones_like(w[:, :, :, 0])
    G = r.new_zeros((B, H, n, hd, hd))
    for t in range(chunk):
        G = G + (f * r[:, :, :, t])[..., None] * dout[:, :, :, t, None, :]
        f = f * w[:, :, :, t]
    # 2. reverse scan over chunks
    g = _zeros_or(dstateT, (B, H, hd, hd), r)
    ends = [None] * n
    for c in reversed(range(n)):
        ends[c] = g
        g = f[:, :, c, :, None] * g + G[:, :, c]
    dstate0 = g
    ends = torch.stack(ends, dim=2)                                    # (B, H, n, hd, hd)

    # 3. per chunk and slice: sub-blocks last first, steps last first
    def advance(s, t, J):
        return w[:, :, :, t, :, None] * s + k[:, :, :, t, :, None] * v[:, :, :, t, None, J]

    dr, dk, dw = (torch.zeros_like(r) for _ in range(3))
    dv = torch.empty_like(r)
    du_part = torch.zeros_like(r[:, :, :, 0])                          # (B, H, n, hd)
    for sl in range(hd // cols):
        J = slice(sl * cols, (sl + 1) * cols)
        s = starts[..., J]
        sub_starts = []
        for b0 in range(0, chunk, sub):
            sub_starts.append(s)
            for t in range(b0, b0 + sub):
                s = advance(s, t, J)
        ds = ends[..., J]
        for si in reversed(range(chunk // sub)):
            b0 = si * sub
            s, kept = sub_starts[si], []
            for t in range(b0, b0 + sub):
                kept.append(s)
                s = advance(s, t, J)
            for t in reversed(range(b0, b0 + sub)):
                rt, kt, wt = r[:, :, :, t], k[:, :, :, t], w[:, :, :, t]     # (B, H, n, hd)
                vt, dt = v[:, :, :, t, J], dout[:, :, :, t, J]
                st = kept[t - b0]                                           # (B, H, n, hd, cols)
                dot = (dt * vt).sum(-1, keepdim=True)
                dr[:, :, :, t] += (st * dt[..., None, :]).sum(-1) + u * kt * dot
                dk[:, :, :, t] += (ds * vt[..., None, :]).sum(-1) + rt * u * dot
                dw[:, :, :, t] += (ds * st).sum(-1)
                dv[:, :, :, t, J] = (kt[..., None] * ds
                                     + (rt * u * kt)[..., None] * dt[..., None, :]).sum(-2)
                du_part += rt * kt * dot
                ds = wt[..., None] * ds + rt[..., None] * dt[..., None, :]

    # 4. du over batch rows, then chunks, in order
    du = torch.zeros_like(u[0, :, 0])
    for bi in range(B):
        for c in range(n):
            du = du + du_part[bi, :, c]

    def unblock(a):
        return a.permute(0, 2, 3, 1, 4).reshape(B, n * chunk, H, hd)[:, :S].contiguous()

    return (unblock(dr), unblock(dk), unblock(dv), unblock(dw), du, dstate0)
