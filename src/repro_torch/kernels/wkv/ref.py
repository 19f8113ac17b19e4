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


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero: ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _product(eq: str, a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    """``einsum(eq, a, b)`` in float32; with ``tf32`` as the CUDA backward's
    tensor cores form it (3xTF32): each operand split as hi = tf32(x), lo =
    tf32(x - hi), and lo hi + hi lo + hi hi (lo lo dropped)."""
    if not tf32:
        return torch.einsum(eq, a, b)
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, ah, bh)


def wkv_bwd_chunked_ref(r, k, v, w, u, dout, state0: Optional[torch.Tensor] = None,
                        dstateT: Optional[torch.Tensor] = None, *,
                        starts: Optional[torch.Tensor] = None, chunk: Optional[int] = None,
                        sub: int = 16, tf32: bool = False):
    """The gradients of :func:`wkv_bwd_ref` by the CUDA backward's schedule.

    The sequence is cut into chunks of ``chunk`` steps (by default the
    kernel's ``wkv.CHUNK``; the last padded with r = k = v = dout = 0, w = 1,
    which change neither the state nor its gradient), each chunk into
    sub-blocks of ``sub`` steps.  ``starts`` (B, H, chunks, hd, hd) are the
    chunk-start states the forward's chunked route keeps; by default they
    are stepped here.  With ``tf32`` every product over a head dim or a
    sub-block (``_product``) is formed as the kernel's tensor cores form it.

    In a sub-block [b, e) with start state S_b and state gradient dS_e at its
    end, A_t = prod_{b<=m<t} w_m, Z_t = prod_{t<m<e} w_m, D = A_e and P(s, t)
    = prod_{s<m<t} w_m, all products formed by multiplying, never dividing.
    X = S_b dout^T, Y = dS_e V^T and M = V dout^T (M[s, t] = v_s . dout_t):

      dr_t = A_t X_t + sum_{s<t} P(s,t) k_s M[s,t] + u k_t M[t,t]
      dk_t = Z_t Y_t + sum_{s>t} P(t,s) r_s M[t,s] + u r_t M[t,t]
      dw_t = A_t Z_t rowsum(S_b * dS_e) + A_t sum_{s>t} P(t,s) r_s X_s
             + Z_t sum_{s<t} P(s,t) k_s Y_s + sum_{s<t<s'} P(s,t) P(t,s') k_s r_s' M[s,s']
      dv_t = dS_e^T (Z_t k_t) + sum_{s>=t} C[t,s] dout_s,   C[t,s] = sum_i k_t P(t,s) r_s
             (s > t), C[t,t] = sum_i r_t u k_t
      du  += sum_t r_t k_t M[t,t]
      dS_b = D dS_e + (A R)^T dout,   S_e = D S_b + (Z K)^T V

    the sums over s < t (and s > t) run as the kernel runs them: a running
    L_{t+1} = w_t L_t + k_t M[t, :] (and its mirror backward in time).

    1. For every chunk, its share of the state gradient at its start G_c
       (the rule for dS_b from dS = 0, sub-blocks last first) and its decay
       D_c, the product of the sub-blocks' D.
    2. The reverse scan dS_start(c) = D_c * dS_end(c) + G_c from dstateT
       gives the gradient at every chunk's end, and dstate0.
    3. For every chunk: the sub-blocks' start states, stepped forward from
       the chunk's start state; then the sub-blocks last first, each giving
       its steps' dr, dk, dv, dw, its share of du and dS at its start.
    4. du: each chunk's sum, then summed over batch rows and chunks in order.
    """
    if chunk is None:
        from repro_torch.kernels.wkv.wkv import CHUNK as chunk   # wkv imports this module
    if chunk <= 0 or sub <= 0 or chunk % sub:
        raise ValueError(f"chunk {chunk} must be a positive multiple of sub {sub}")
    B, S, H, hd = r.shape
    n, T, nsub = -(-S // chunk), sub, chunk // sub
    pad = n * chunk - S

    def blocks(a, fill):
        a = a.float()
        if pad:
            a = torch.cat([a, a.new_full((B, pad, H, hd), fill)], dim=1)
        # (B, H, n, sub-blocks, sub, hd)
        return a.reshape(B, n, nsub, T, H, hd).permute(0, 4, 1, 2, 3, 5)

    r, k, v, dout = (blocks(a, 0.0) for a in (r, k, v, dout))
    w = blocks(w, 1.0)
    u = u.float()[None, :, None, :]                                    # (1, H, 1, hd)
    if starts is None:
        s = _zeros_or(state0, (B, H, hd, hd), r)
        kept = []
        for c in range(n):
            kept.append(s)
            for j in range(nsub):
                for t in range(T):
                    s = (w[:, :, c, j, t, :, None] * s
                         + k[:, :, c, j, t, :, None] * v[:, :, c, j, t, None, :])
        starts = torch.stack(kept, dim=2)
    starts = starts.float()
    A = _exclusive_cumprod(w, -2)                    # prod_{b<=m<t} w_m
    Z = _exclusive_cumprod(w, -2, reverse=True)      # prod_{t<m<e} w_m
    D = A[..., -1, :] * w[..., -1, :]                # (B, H, n, sub-blocks, hd)
    AR, ZK = A * r, Z * k

    # 1. chunk shares of the state gradient, and decays
    G = r.new_zeros((B, H, n, hd, hd))
    Dc = torch.ones_like(D[:, :, :, 0])
    for j in reversed(range(nsub)):
        G = D[:, :, :, j, :, None] * G + _product("bhnti,bhntj->bhnij", AR[:, :, :, j],
                                                  dout[:, :, :, j], tf32)
        Dc = Dc * D[:, :, :, j]
    # 2. reverse scan over chunks
    g = _zeros_or(dstateT, (B, H, hd, hd), r)
    ends = [None] * n
    for c in reversed(range(n)):
        ends[c] = g
        g = Dc[:, :, c, :, None] * g + G[:, :, c]
    dstate0 = g

    # 3. per chunk: sub-block start states forward, then the sub-blocks backward
    states = [starts]
    for j in range(nsub - 1):
        states.append(D[:, :, :, j, :, None] * states[-1]
                      + _product("bhnsi,bhnsj->bhnij", ZK[:, :, :, j], v[:, :, :, j], tf32))
    dS = torch.stack(ends, dim=2)                                      # (B, H, n, hd, hd)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du_part = torch.zeros_like(r[:, :, :, 0, 0])                       # (B, H, n, hd)
    for j in reversed(range(nsub)):
        rj, kj, vj, wj, dj = (a[:, :, :, j] for a in (r, k, v, w, dout))   # (B, H, n, T, hd)
        Aj, Zj = A[:, :, :, j], Z[:, :, :, j]
        Sb = states[j]
        X = _product("bhnij,bhntj->bhnti", Sb, dj, tf32)
        Y = _product("bhnij,bhntj->bhnti", dS, vj, tf32)
        M = _product("bhnsj,bhntj->bhnst", vj, dj, tf32)
        Md = torch.diagonal(M, dim1=-2, dim2=-1)                       # (B, H, n, T)
        diag = (Sb * dS).sum(-1)
        f = _pair_decays(wj)               # f[t, s] = P(s, t) for s < t, else 0
        # forward in time: dr, the Y term of dw and the pair term, from L
        L = torch.zeros_like(rj)           # L[c] = sum_{s<t} P(s,t) k_s M[s,c]
        F = torch.zeros_like(rj[..., 0, :])
        for t in range(T):
            dr[:, :, :, j, t] = (Aj[..., t, :] * X[..., t, :] + L[..., t, :]
                                 + u * kj[..., t, :] * Md[..., t, None])
            beta = f[..., :, t, :] * rj                                # P(t, c) r_c, c > t
            dw[:, :, :, j, t] = (Aj[..., t, :] * Zj[..., t, :] * diag + Zj[..., t, :] * F
                                 + (beta * L).sum(-2))
            L = wj[..., t, None, :] * L + kj[..., t, None, :] * M[..., t, :, None]
            F = wj[..., t, :] * F + kj[..., t, :] * Y[..., t, :]
        # backward in time: dk and the X term of dw, from the mirror of L
        Lb = torch.zeros_like(rj)          # Lb[c] = sum_{s>t} P(t,s) r_s M[c,s]
        E = torch.zeros_like(F)
        for t in reversed(range(T)):
            dk[:, :, :, j, t] = (Zj[..., t, :] * Y[..., t, :] + Lb[..., t, :]
                                 + u * rj[..., t, :] * Md[..., t, None])
            dw[:, :, :, j, t] += Aj[..., t, :] * E
            Lb = wj[..., t, None, :] * Lb + rj[..., t, None, :] * M[..., :, t, None]
            E = wj[..., t, :] * E + rj[..., t, :] * X[..., t, :]
        # dv: the state term over rows, then the pair and bonus terms
        C = torch.einsum("bhnsti,bhnsi,bhnti->bhnts", f, rj, kj)      # C[t, s], s > t
        C = C + torch.diag_embed((rj * u[:, :, :, None] * kj).sum(-1))
        dv[:, :, :, j] = (_product("bhnti,bhnij->bhntj", ZK[:, :, :, j], dS, tf32)
                          + torch.einsum("bhnts,bhnsj->bhntj", C, dj))
        du_part += (rj * kj * Md[..., None]).sum(-2)
        dS = (D[:, :, :, j, :, None] * dS
              + _product("bhnti,bhntj->bhnij", AR[:, :, :, j], dj, tf32))

    # 4. du over batch rows, then chunks, in order
    du = torch.zeros_like(u[0, :, 0])
    for bi in range(B):
        for c in range(n):
            du = du + du_part[bi, :, c]

    def unblock(a):
        return a.permute(0, 2, 3, 4, 1, 5).reshape(B, n * chunk, H, hd)[:, :S].contiguous()

    return (unblock(dr), unblock(dk), unblock(dv), unblock(dw), du, dstate0)
