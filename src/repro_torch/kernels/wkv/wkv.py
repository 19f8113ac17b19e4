"""WKV6 recurrence kernel wrapper and its plain PyTorch twin.

Ports ``repro.kernels.wkv.wkv`` (``_wkv_kernel`` / ``wkv_pallas``).  The CUDA
kernel (``repro_torch/csrc/wkv.cu``) keeps each (batch, head) state in
registers for the whole sequence: one block per (head, batch), one thread per
column of the state.

:func:`repro_torch.kernels.wkv.ops.wkv` takes the plain twin only for tensors
on the CPU; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wkv.ref import wkv_ref

HEAD_DIMS = (16, 32, 64, 128)
_MAX_BATCH = 65535

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = _build.load("wkv")
    if lib.wkv_fwd_f32.argtypes is None:
        lib.wkv_fwd_f32.argtypes = _ARGTYPES
        lib.wkv_fwd_f32.restype = ctypes.c_int
        lib.wkv_error_string.argtypes = [ctypes.c_int]
        lib.wkv_error_string.restype = ctypes.c_char_p
    return lib


def check_operands(r, k, v, w, u, state0: Optional[torch.Tensor] = None) -> None:
    """Raise on operands the kernel (and its twin) do not take."""
    if r.ndim != 4 or not (r.shape == k.shape == v.shape == w.shape):
        raise ValueError(
            f"expected r, k, v, w of one (B, S, H, hd) shape, got "
            f"{[tuple(a.shape) for a in (r, k, v, w)]}"
        )
    B, _, H, hd = r.shape
    if tuple(u.shape) != (H, hd):
        raise ValueError(f"u must be ({H}, {hd}), got {tuple(u.shape)}")
    if state0 is not None and tuple(state0.shape) != (B, H, hd, hd):
        raise ValueError(f"state0 must be ({B}, {H}, {hd}, {hd}), got {tuple(state0.shape)}")
    devices = {a.device for a in (r, k, v, w, u) + (() if state0 is None else (state0,))}
    if len(devices) != 1:
        raise ValueError(f"operands on {sorted(map(str, devices))}")


def wkv_plain(r, k, v, w, u, state0: Optional[torch.Tensor] = None):
    """Plain PyTorch twin of the kernel: the step-by-step recurrence
    (:func:`wkv_ref`) in float32."""
    return wkv_ref(r, k, v, w, u, state0)


def wkv_cuda(r, k, v, w, u, state0: Optional[torch.Tensor] = None):
    """Launch the CUDA kernel on float32 CUDA operands -> (out, final state)."""
    check_operands(r, k, v, w, u, state0)
    operands = (r, k, v, w, u) + (() if state0 is None else (state0,))
    for a in operands:
        if a.device.type != "cuda":
            raise ValueError(f"wkv_cuda needs CUDA tensors, got {a.device}")
        if a.dtype != torch.float32:
            raise ValueError(f"wkv_cuda takes float32 operands, got {a.dtype}")
    B, S, H, hd = (int(s) for s in r.shape)
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in the kernel's {HEAD_DIMS}")
    if min(B, S, H) == 0 or B > _MAX_BATCH or r.numel() >= 2**62:
        raise ValueError(f"unsupported shape {tuple(r.shape)}")
    r, k, v, w, u = (a.contiguous() for a in (r, k, v, w, u))
    if state0 is not None:
        state0 = state0.contiguous()
    out = torch.empty_like(r)
    stateT = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    lib = _lib()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = lib.wkv_fwd_f32(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            None if state0 is None else state0.data_ptr(),
            out.data_ptr(), stateT.data_ptr(), B, S, H, hd, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"wkv kernel launch failed: {lib.wkv_error_string(rc).decode()} "
            f"(r {tuple(r.shape)})"
        )
    _build.LAUNCHES["wkv"] += 1
    return out, stateT
