"""Flash-attention backward kernel wrapper, its plain PyTorch twin and a
mirror of the bfloat16 kernels' launch plan.

The reference differentiates attention through a custom VJP in plain JAX
(``repro.models.attention._flash_bwd``); its Pallas kernel is forward only.
The CUDA source (``repro_torch/csrc/flash_attention_bwd.cu``) computes that
VJP: dq, dk, dv of grouped-query attention with the forward's causal mask,
window and query offset, from q, k, v, the forward's output o, its
cotangent dO and the forward kernel's per-row log-sum-exp.  Three kernels
run under one counted launch (``delta = rowsum(dO O)``, then dk / dv by key
tile, then dq by row tile), in a fixed order without atomics: two launches
give the same bits.  bfloat16 runs them on the tensor cores (bf16 operands,
P and dS rounded to bf16 for the second products, float32 accumulators);
float32 on the CUDA cores in full FP32.

:func:`bwd_tiles`, :func:`dkdv_order`, :func:`dq_order`, :func:`dkdv_walk`
and :func:`dq_walk` mirror the bfloat16 kernels' tiles, block order and
walks (``TcBwdCfg`` and the kernels' prologues), so the CPU tests can check
that every valid (row, key) pair is visited once by each kernel and that
the tiles that skip the mask hold only valid pairs.

:class:`repro_torch.kernels.flash_attention.ops.FlashAttention` calls
:func:`flash_attention_bwd_cuda` for CUDA tensors and
:func:`flash_attention_bwd_plain` for CPU tensors, and
:func:`flash_attention_bwd_meta` for ``meta`` tensors (a dry run: the
gradients' shapes and one launch counted with :func:`flash_bwd_cost`).
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.kernels import _build, _meta
from repro_torch.kernels.flash_attention.flash_attention import (
    _DTYPES, check_cuda_operands, valid_pairs)
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_void_p])


@dataclass(frozen=True)
class BwdTiles:
    """The bfloat16 kernels' tiles at one head dim (``TcBwdCfg``)."""

    keys: int     # flash_bwd_dkdv_tc: keys a block, 16 a warp
    rows: int     # ... rows a tile of its walk
    dacc: int     # ... dK, dV columns a block
    nsplit: int   # ... blocks a key tile (hd / dacc)
    q_rows: int   # flash_bwd_dq_tc: rows a block, 16 a warp
    q_keys: int   # ... keys a tile of its walk


def bwd_tiles(hd: int) -> BwdTiles:
    """64 keys and 64-row tiles at hd <= 64, 32-row tiles above; dq's 64
    rows walk 64-key tiles at hd <= 64, 32 above; hd 256 splits dK and dV's
    columns over two blocks."""
    dacc = hd if hd <= 128 else 128
    return BwdTiles(keys=64, rows=64 if hd <= 64 else 32, dacc=dacc, nsplit=hd // dacc,
                    q_rows=64, q_keys=64 if hd <= 64 else 32)


def dkdv_order(n_key_tiles: int, B: int, Hkv: int, nsplit: int) -> list[tuple[int, int, int, int]]:
    """(key tile, column split, KV head, batch) of each dkdv block in
    ``blockIdx.x`` order: the key tile outermost, so every head's first
    tile (causal: the longest walk) is in the first wave."""
    return [(kt, split, hk, b) for kt in range(n_key_tiles) for b in range(B)
            for hk in range(Hkv) for split in range(nsplit)]


def dq_order(n_row_tiles: int, B: int, Hkv: int, causal: bool) -> list[tuple[int, int, int]]:
    """(row tile, KV head, batch) of each dq block in ``blockIdx.x`` order:
    the row tile outermost, causal the last (longest walk) first."""
    order = range(n_row_tiles - 1, -1, -1) if causal else range(n_row_tiles)
    return [(qt, hk, b) for qt in order for b in range(B) for hk in range(Hkv)]


def dkdv_walk(kt: int, tiles: BwdTiles, Sq: int, Skv: int, G: int, causal: bool,
              window: Optional[int], q_offset: int):
    """``(k0, key_end, [(r0, r1, need_mask), ...])``: key tile ``kt``'s keys
    and the row tiles its block walks (rows ``[r0, r1)`` of the flattened
    ``i * G + g``), each with whether the kernel evaluates the mask there."""
    w = window or 0
    k0 = kt * tiles.keys
    key_end = min(Skv, k0 + tiles.keys)
    i_lo = max(0, k0 - q_offset) if causal else 0
    i_hi = min(Sq, max(0, key_end - 1 + w - q_offset)) if w > 0 else Sq
    row_lo, row_end = i_lo * G, max(i_hi, i_lo) * G
    steps = []
    for r0 in range(row_lo, row_end, tiles.rows):
        last = min(r0 + tiles.rows, row_end) - 1
        pa, pb = q_offset + r0 // G, q_offset + last // G
        need = (r0 + tiles.rows > row_end or k0 + tiles.keys > key_end
                or (causal and k0 + tiles.keys - 1 > pa) or (w > 0 and k0 <= pb - w))
        steps.append((r0, min(r0 + tiles.rows, row_end), need))
    return k0, key_end, steps


def dq_walk(qt: int, tiles: BwdTiles, Sq: int, Skv: int, G: int, causal: bool,
            window: Optional[int], q_offset: int):
    """``(r0, row_end, [(t0, t1, need_mask), ...])``: row tile ``qt``'s
    rows and the key tiles its block walks, each with whether the kernel
    evaluates the mask there."""
    w = window or 0
    R = Sq * G
    r0 = qt * tiles.q_rows
    row_end = min(R, r0 + tiles.q_rows)
    qa, qb = q_offset + r0 // G, q_offset + (row_end - 1) // G
    kv_lo = max(0, qa - w + 1) if w > 0 else 0
    kv_hi = min(Skv, qb + 1) if causal else Skv
    steps = []
    for t0 in range(kv_lo, kv_hi, tiles.q_keys):
        need = (t0 + tiles.q_keys > kv_hi or r0 + tiles.q_rows > row_end
                or (causal and t0 + tiles.q_keys - 1 > qa) or (w > 0 and t0 <= qb - w))
        steps.append((t0, min(t0 + tiles.q_keys, kv_hi), need))
    return r0, row_end, steps


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    if lib.flash_attention_bwd.argtypes is None:
        lib.flash_attention_bwd.argtypes = _ARGTYPES
        lib.flash_attention_bwd.restype = ctypes.c_int
        lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_bwd_plain(q, k, v, o, do, lse, *, causal: bool = True,
                              window: Optional[int] = None, q_offset: int = 0):
    """Plain PyTorch twin of the kernel: :func:`attention_bwd_ref` (float32)
    with each gradient returned in its operand's dtype."""
    dq, dk, dv = attention_bwd_ref(q, k, v, o, do, lse, causal=causal,
                                   window=window, q_offset=q_offset)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_cuda(q, k, v, o, do, lse, *, causal: bool = True,
                             window: Optional[int] = None, q_offset: int = 0):
    """Launch the backward kernel on CUDA q, k, v, o, dO of one dtype and the
    forward's float32 lse (B, Hq, Sq) -> (dq, dk, dv) in that dtype."""
    window = check_cuda_operands(q, k, v, o, do, window=window, q_offset=q_offset)
    B, Sq, Hq, hd = (int(s) for s in q.shape)
    Skv, Hkv = int(k.shape[1]), int(k.shape[2])
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and dO {tuple(do.shape)} must be q's "
                         f"{tuple(q.shape)}")
    if tuple(lse.shape) != (B, Hq, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {(B, Hq, Sq)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    q, k, v, o, do, lse = (t.contiguous() for t in (q, k, v, o, do, lse))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_bwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, Sq, Skv, Hq, Hkv, hd, int(causal),
            0 if window is None else int(window), int(q_offset), 1.0 / math.sqrt(hd), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"flash attention backward launch failed: "
            f"{lib.flash_attention_bwd_error_string(rc).decode()} "
            f"(q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype})"
        )
    _build.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


def flash_bwd_cost(B: int, Sq: int, Skv: int, Hq: int, Hkv: int, hd: int, *,
                   causal: bool = True, window: Optional[int] = None, q_offset: int = 0,
                   elem_bytes: int = 2) -> tuple[float, float]:
    """(flops, bytes) of one backward call, the least work the kernels must
    do: 10 hd flops a valid (query head, key) pair (S = Q K^T again, dV +=
    P^T dO, dP = dO V^T, dQ += dS K, dK += dS^T Q, 2 hd each); q, k, v, o,
    dO read and dq, dk, dv written once in ``elem_bytes``, the float32 lse
    read."""
    pairs = valid_pairs(Sq, Skv, causal=causal, window=window, q_offset=q_offset)
    nbytes = elem_bytes * (4.0 * B * Sq * Hq * hd + 4.0 * B * Skv * Hkv * hd) + 4.0 * B * Hq * Sq
    return 10.0 * B * Hq * hd * pairs, nbytes


def flash_attention_bwd_meta(q, k, v, o, do, lse, *, causal: bool = True,
                             window: Optional[int] = None, q_offset: int = 0):
    """:func:`flash_attention_bwd_cuda` on ``meta`` tensors: dq, dk, dv and
    the ``delta`` scratch as empty ``meta`` tensors, and one launch reported
    to the dry run with :func:`flash_bwd_cost`.  It refuses what the
    kernels refuse."""
    check_cuda_operands(q, k, v, o, do, window=window, q_offset=q_offset)
    B, Sq, Hq, hd = (int(s) for s in q.shape)
    Skv, Hkv = int(k.shape[1]), int(k.shape[2])
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
    torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)   # delta, for the call
    _meta.record("flash_attention_bwd", *flash_bwd_cost(
        B, Sq, Skv, Hq, Hkv, hd, causal=causal, window=window, q_offset=q_offset,
        elem_bytes=q.element_size()))
    return dq, dk, dv
