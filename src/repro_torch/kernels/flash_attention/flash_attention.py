"""Flash-attention kernel wrapper and its plain PyTorch twin.

Ports ``repro.kernels.flash_attention.flash_attention`` (``_flash_kernel`` /
``flash_attention_pallas``).  The CUDA kernel
(``repro_torch/csrc/flash_attention.cu``) computes forward-only grouped-query
attention with a causal mask, an optional sliding window and a query offset
in an online softmax, float32 or bfloat16 in and the same type out, float32
inside.  Unlike the TPU kernel it takes ragged ``Sq`` and ``Skv`` (masked at
the edge) and needs no tile sizes.  bfloat16 runs on the tensor cores; when
the grid would not fill the card (decode), :func:`split_plan` cuts the keys
into ranges whose partial softmax states the kernel merges in a second step
(:func:`repro_torch.kernels.flash_attention.ref.merge_partials` is that
merge in plain PyTorch).  float32 runs on the CUDA cores, unsplit.

:func:`repro_torch.kernels.flash_attention.ops.flash_attention` takes the
plain twin only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)
_MAX_GROUP = 128  # query heads per KV head: one float32 block's rows

# The bfloat16 kernel's tiling (csrc/flash_attention.cu: kBK, launch_tc_hd).
TC_KEYS = 64      # keys per tile
MAX_SPLITS = 256  # kMaxSplits: splits the merge step takes


def tc_rows_per_block(hd: int, rows: int) -> int:
    """(position, head) rows per block of the bfloat16 kernel: two m16 tiles
    per warp (128 rows) for hd <= 64 when there are more than 64 rows, else
    one (64 rows)."""
    return 128 if hd <= 64 and rows > 64 else 64


_ARGTYPES = [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
]


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


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: dense float32 attention
    (:func:`attention_ref`) returned in q's dtype, as the kernel returns it."""
    return attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset).to(q.dtype)


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA q, k, v of one dtype -> q's shape and dtype."""
    check_operands(q, k, v, window=window, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash attention takes float32 or bfloat16 operands of one dtype, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}"
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
    if window is not None and window > q_offset + Sq - 1:
        window = None  # every key is inside the window: no mask to apply
    q, k, v = (x.contiguous() for x in (q, k, v))
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    o = torch.empty_like(q)
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
            *parts, nsplit, split_len,
            B, Sq, Skv, Hq, Hkv, hd, int(causal), 0 if window is None else int(window),
            int(q_offset), 1.0 / math.sqrt(hd), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"flash attention kernel launch failed: "
            f"{lib.flash_attention_error_string(rc).decode()} "
            f"(q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype})"
        )
    _build.LAUNCHES["flash_attention"] += 1
    return o
