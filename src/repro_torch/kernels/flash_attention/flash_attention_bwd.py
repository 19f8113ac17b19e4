"""Flash-attention backward kernel wrapper and its plain PyTorch twin.

The reference differentiates attention through a custom VJP in plain JAX
(``repro.models.attention._flash_bwd``); its Pallas kernel is forward only.
The CUDA source (``repro_torch/csrc/flash_attention_bwd.cu``) computes that
VJP: dq, dk, dv of grouped-query attention with the forward's causal mask,
window and query offset, from q, k, v, the forward's output o, its
cotangent dO and the forward kernel's per-row log-sum-exp.  Three kernels
run under one counted launch (``delta = rowsum(dO O)``, then dk / dv by key
tile, then dq by query tile), float32 or bfloat16 in and the same type out,
float32 inside, in a fixed order without atomics: two launches give the
same bits.

:class:`repro_torch.kernels.flash_attention.ops.FlashAttention` calls
:func:`flash_attention_bwd_cuda` for CUDA tensors and
:func:`flash_attention_bwd_plain` for CPU tensors.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.flash_attention import _DTYPES, check_cuda_operands
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_void_p])


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
