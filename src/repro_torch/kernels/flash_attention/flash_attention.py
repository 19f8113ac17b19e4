"""Flash-attention forward kernel wrapper and its plain PyTorch twin.

Ports ``repro.kernels.flash_attention.flash_attention`` (``_flash_kernel`` /
``flash_attention_pallas``).  The CUDA kernel
(``repro_torch/csrc/flash_attention.cu``) computes the forward of
grouped-query attention with a causal mask, an optional sliding window and a
query offset in an online softmax, float32 or bfloat16 in and the same type
out, float32 inside, at head dims 16, 32, 64, 112, 128 and 256; asked for
(``return_lse``), it also writes each row's log-sum-exp, which the backward
kernel (:mod:`repro_torch.kernels.flash_attention.flash_attention_bwd`)
reads.  Unlike the TPU kernel it
takes ragged ``Sq`` and ``Skv`` (masked at the edge) and needs no tile
sizes; K and V may be views of the first ``Skv`` slots of a longer cache
(:func:`kv_operands`).  bfloat16 runs on the tensor cores; when
the grid would not fill the card (decode), :func:`split_plan` cuts the keys
into ranges whose partial softmax states the kernel merges in a second step
(:func:`repro_torch.kernels.flash_attention.ref.merge_partials` is that
merge in plain PyTorch).  float32 runs on the CUDA cores, unsplit.

:func:`repro_torch.kernels.flash_attention.ops.flash_attention` takes the
plain twin only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises.  ``meta`` tensors (a dry run) take
:func:`flash_attention_meta`: the outputs' shapes and one launch counted
with :func:`flash_fwd_cost`, the formula the kernel's bound is read from.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build, _meta
from repro_torch.kernels.flash_attention.ref import attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 112, 128, 256)
_MAX_GROUP = 128  # query heads per KV head: one float32 block's rows

# The bfloat16 kernel's tiling (csrc/flash_attention.cu: kBK, launch_tc_hd).
TC_KEYS = 64      # keys per tile
MAX_SPLITS = 256  # kMaxSplits: splits the merge step takes


def tc_rows_per_block(hd: int, rows: int) -> int:
    """(position, head) rows per block of the bfloat16 kernel: two m16 tiles
    per warp (128 rows) for hd <= 64 when there are more than 64 rows, else
    one (64 rows): hd 112, 128 and 256 always take one."""
    return 128 if hd <= 64 and rows > 64 else 64


# dtype; q, k, v, o, lse, part_m, part_l, part_acc; nsplit, split_len, B, Sq,
# Skv, Hq, Hkv, hd, causal, window, q_offset; scale; kv_bstride; stream
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
             + [ctypes.c_float, ctypes.c_longlong, ctypes.c_void_p])


def split_plan(B: int, Sq: int, Skv: int, Hq: int, Hkv: int, hd: int, *,
               sm_count: int = _build.H100_SMS) -> tuple[int, int]:
    """``(nsplit, split_len)`` for the bfloat16 kernel: split ``s`` walks
    keys ``[s * split_len, (s + 1) * split_len)`` of ``[0, Skv)``.

    Splits only when the unsplit grid (query tiles x Hkv x B blocks) holds
    fewer than two blocks per SM, into as many splits as reach two per SM
    (at most ``MAX_SPLITS``), each a whole number of key tiles and none past
    ``Skv``.
    """
    rows = Sq * (Hq // Hkv)
    q_tiles = -(-rows // tc_rows_per_block(hd, rows))
    blocks = q_tiles * Hkv * B
    tiles = -(-Skv // TC_KEYS)
    nsplit = min(-(-2 * sm_count // blocks), tiles, MAX_SPLITS)
    if nsplit <= 1:
        return 1, Skv
    split_len = -(-tiles // nsplit) * TC_KEYS
    return -(-Skv // split_len), split_len


def kv_operands(k: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, int]:
    """K and V as the kernel reads them, and their batch stride in elements.

    A view whose rows are contiguous within each batch row (the first Skv
    slots of a longer cache) is passed as it is, with the cache's batch
    stride, when that stride keeps every batch row 16-byte aligned; any
    other layout is made contiguous.
    """
    B, Skv, Hkv, hd = k.shape
    inner = (Hkv * hd, hd, 1)
    dense = Skv * Hkv * hd
    row_align = 16 // k.element_size()
    if (k.stride() == v.stride() and tuple(k.stride()[1:]) == inner
            and (B == 1 or (k.stride(0) >= dense and k.stride(0) % row_align == 0))):
        return k, v, dense if B == 1 else int(k.stride(0))
    return k.contiguous(), v.contiguous(), dense


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if lib.flash_attention_fwd.argtypes is None:
        lib.flash_attention_fwd.argtypes = _ARGTYPES
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def check_operands(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: Optional[int],
    q_offset: int,
) -> None:
    """Raise on operands the kernel (and its twin) do not take."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(
            f"expected q (B, Sq, Hq, hd) and k, v (B, Skv, Hkv, hd), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, _, Hq, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or Hq % k.shape[2] != 0:
        raise ValueError(
            f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch or "
            f"head dim, or Hq is not a multiple of Hkv"
        )
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"operands on {q.device}, {k.device}, {v.device}")


def check_cuda_operands(*tensors: torch.Tensor, window: Optional[int], q_offset: int
                        ) -> Optional[int]:
    """Raise on CUDA operands the kernels (forward: q, k, v; backward also o
    and dO) do not take (``meta`` operands, a dry run's, as CUDA ones);
    returns the window the kernels apply: None where every key a query can
    see lies inside it (no mask to apply)."""
    q, k, v = tensors[:3]
    check_operands(q, k, v, window=window, q_offset=q_offset)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"the flash-attention kernels need CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(
            f"flash attention takes float32 or bfloat16 operands of one dtype, "
            f"got {[str(t.dtype) for t in tensors]}"
        )
    B, Sq, Hq, hd = (int(s) for s in q.shape)
    Skv, Hkv = int(k.shape[1]), int(k.shape[2])
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in the kernel's {HEAD_DIMS}")
    if Hq // Hkv > _MAX_GROUP:
        raise ValueError(f"{Hq // Hkv} query heads per KV head exceed {_MAX_GROUP}")
    if min(B, Sq, Skv) == 0:
        raise ValueError(f"empty operand: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if max(q.numel(), k.numel()) >= 2**62 or max(Sq, Skv) + q_offset >= 2**31 - 1:
        raise ValueError(f"operands too large: q {tuple(q.shape)}, k {tuple(k.shape)}")
    return None if window is not None and window > q_offset + Sq - 1 else window


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    return_lse: bool = False,
):
    """Plain PyTorch twin of the kernel: dense float32 attention
    (:func:`attention_ref`) returned in q's dtype, as the kernel returns it;
    with ``return_lse`` also each row's float32 log-sum-exp (B, Hq, Sq)."""
    out = attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset,
                        return_lse=return_lse)
    if return_lse:
        return out[0].to(q.dtype), out[1]
    return out.to(q.dtype)


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    return_lse: bool = False,
):
    """Launch the CUDA kernel on CUDA q, k, v of one dtype -> q's shape and
    dtype; with ``return_lse`` also each row's float32 log-sum-exp (B, Hq,
    Sq), the state the backward kernel reads."""
    window = check_cuda_operands(q, k, v, window=window, q_offset=q_offset)
    B, Sq, Hq, hd = (int(s) for s in q.shape)
    Skv, Hkv = int(k.shape[1]), int(k.shape[2])
    q = q.contiguous()
    k, v, kv_bstride = kv_operands(k, v)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device) if return_lse else None
    nsplit, split_len = 1, Skv
    if q.dtype == torch.bfloat16:
        nsplit, split_len = split_plan(B, Sq, Skv, Hq, Hkv, hd,
                                       sm_count=_build.sm_count(q.device.index))
    parts = (None, None, None)
    if nsplit > 1:
        # per-split softmax state (m, l) and accumulator, merged by the kernel
        rows = Sq * (Hq // Hkv)
        ml = torch.empty((2, B, Hkv, nsplit, rows), dtype=torch.float32, device=q.device)
        acc = torch.empty((B, Hkv, nsplit, rows, hd), dtype=torch.float32, device=q.device)
        parts = (ml[0].data_ptr(), ml[1].data_ptr(), acc.data_ptr())
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), *parts, nsplit, split_len,
            B, Sq, Skv, Hq, Hkv, hd, int(causal), 0 if window is None else int(window),
            int(q_offset), 1.0 / math.sqrt(hd), kv_bstride, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"flash attention kernel launch failed: "
            f"{lib.flash_attention_error_string(rc).decode()} "
            f"(q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype})"
        )
    _build.LAUNCHES["flash_attention"] += 1
    return (o, lse) if return_lse else o


def valid_pairs(Sq: int, Skv: int, *, causal: bool = True, window: Optional[int] = None,
                q_offset: int = 0) -> int:
    """(query, key) pairs a call's mask leaves valid, per query head: query
    ``i`` at position ``q_offset + i`` sees the keys from ``pos - window +
    1`` (with a window) up to ``pos`` (causal) of ``[0, Skv)``.  Summed in
    closed form over the runs of positions where that count is linear."""
    w = window or 0

    def seen(pos: int) -> int:
        hi = min(Skv, pos + 1) if causal else Skv
        return max(0, hi - (max(0, pos - w + 1) if w else 0))

    a, b = q_offset, q_offset + Sq
    cuts = sorted({a, b, *(c for c in (Skv, w - 1, Skv + w - 1) if a < c < b)})
    return sum((hi - lo) * (seen(lo) + seen(hi - 1)) // 2 for lo, hi in zip(cuts, cuts[1:]))


def flash_fwd_cost(B: int, Sq: int, Skv: int, Hq: int, Hkv: int, hd: int, *,
                   causal: bool = True, window: Optional[int] = None, q_offset: int = 0,
                   elem_bytes: int = 2, lse: bool = False) -> tuple[float, float]:
    """(flops, bytes) of one forward call, the least work the kernel must
    do: 4 hd flops a valid (query head, key) pair (the products Q K^T and
    P V, 2 hd each); q, k and v read and o written once in ``elem_bytes``,
    and with ``lse`` each row's float32 log-sum-exp written."""
    pairs = valid_pairs(Sq, Skv, causal=causal, window=window, q_offset=q_offset)
    nbytes = elem_bytes * (2.0 * B * Sq * Hq * hd + 2.0 * B * Skv * Hkv * hd)
    return 4.0 * B * Hq * hd * pairs, nbytes + (4.0 * B * Hq * Sq if lse else 0.0)


def flash_attention_meta(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    return_lse: bool = False,
):
    """:func:`flash_attention_cuda` on ``meta`` tensors: the same outputs
    and scratch (the split-KV partials where the bfloat16 kernel splits,
    planned for an H100's SMs) as empty ``meta`` tensors, and one launch
    reported to the dry run with :func:`flash_fwd_cost`.  It refuses what
    the kernel refuses."""
    check_cuda_operands(q, k, v, window=window, q_offset=q_offset)
    B, Sq, Hq, hd = (int(s) for s in q.shape)
    Skv, Hkv = int(k.shape[1]), int(k.shape[2])
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device) if return_lse else None
    nsplit = split_plan(B, Sq, Skv, Hq, Hkv, hd)[0] if q.dtype == torch.bfloat16 else 1
    if nsplit > 1:   # the partials, live for the call as on the card
        rows = Sq * (Hq // Hkv)
        parts = [torch.empty((2, B, Hkv, nsplit, rows), dtype=torch.float32, device=q.device),
                 torch.empty((B, Hkv, nsplit, rows, hd), dtype=torch.float32, device=q.device)]
        del parts
    _meta.record("flash_attention", *flash_fwd_cost(
        B, Sq, Skv, Hq, Hkv, hd, causal=causal, window=window, q_offset=q_offset,
        elem_bytes=q.element_size(), lse=return_lse))
    return (o, lse) if return_lse else o
