"""Plain oracle for the WKV6 recurrence kernel (port of ``repro.kernels.wkv.ref``)."""
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
