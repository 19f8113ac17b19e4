"""WKV6 recurrence kernel wrapper, its plan and its plain PyTorch twin.

Ports ``repro.kernels.wkv.wkv`` (``_wkv_kernel`` / ``wkv_pallas``).  The CUDA
source (``repro_torch/csrc/wkv.cu``) has two routes, chosen explicitly by
:func:`wkv_plan` from the sequence length: the recurrent one (each (batch,
head) state in registers, one block per state; decode and short sequences)
and the chunked one (chunk contributions, a scan over chunks, chunk outputs:
three kernels under one call; prefill).  Both read r, k, v as float32 or
bfloat16 and compute in float32.

:func:`repro_torch.kernels.wkv.ops.wkv` takes the plain twin only for tensors
on the CPU; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.wkv.ref import wkv_ref

HEAD_DIMS = (16, 32, 64, 128)
_MAX_BATCH = 65535
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The chunked route's tiling (csrc/wkv.cu): steps per chunk (a multiple of
# the kernel's 16-step sub-block) and the shortest sequence it takes, both
# set by measurement on an H100 at rwkv6-1.6b's (4, S, 32, 64) with
# ``chip_smoke.py --sweep-wkv`` (times in PERF.md): at S = 1024 chunks of
# 128 beat 64 and 32 (the scan is shorter) and come within 4% of 256, which
# halves the blocks (128 at batch 1, fewer than the card's SMs); the chunked
# route beats the recurrent one from S = 48.
CHUNK = 128
SUB_BLOCK = 16
CHUNKED_MIN_S = 48

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
             + [ctypes.c_void_p])


class WkvPlan(NamedTuple):
    """``route`` "recurrent" or "chunked"; chunk ``c`` covers the steps
    ``[c * chunk, min((c + 1) * chunk, S))`` of ``n_chunks``."""
    route: str
    chunk: int
    n_chunks: int


def wkv_plan(S: int) -> WkvPlan:
    """The route for a sequence of ``S`` steps: the recurrent kernel below
    ``CHUNKED_MIN_S`` steps (decode is S = 1), else chunks of ``CHUNK``."""
    if S < 1:
        raise ValueError(f"S must be positive, got {S}")
    if S < CHUNKED_MIN_S:
        return WkvPlan("recurrent", S, 1)
    return WkvPlan("chunked", CHUNK, -(-S // CHUNK))


def _lib() -> ctypes.CDLL:
    lib = _build.load("wkv")
    if lib.wkv_fwd.argtypes is None:
        lib.wkv_fwd.argtypes = _ARGTYPES
        lib.wkv_fwd.restype = ctypes.c_int
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
    """Launch the CUDA kernel -> (out, final state), both float32.

    r, k, v: CUDA tensors of one dtype, float32 or bfloat16; w, u and state0
    float32.  The route is :func:`wkv_plan` of the sequence length; one call
    counts one launch whatever the route.
    """
    check_operands(r, k, v, w, u, state0)
    operands = (r, k, v, w, u) + (() if state0 is None else (state0,))
    for a in operands:
        if a.device.type != "cuda":
            raise ValueError(f"wkv_cuda needs CUDA tensors, got {a.device}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"r, k, v must be one of float32 / bfloat16, got "
                         f"{r.dtype}, {k.dtype}, {v.dtype}")
    for name, a in (("w", w), ("u", u), ("state0", state0)):
        if a is not None and a.dtype != torch.float32:
            raise ValueError(f"wkv_cuda takes a float32 {name}, got {a.dtype}")
    B, S, H, hd = (int(s) for s in r.shape)
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in the kernel's {HEAD_DIMS}")
    if min(B, S, H) == 0 or B > _MAX_BATCH or H > _MAX_BATCH or r.numel() >= 2**62:
        raise ValueError(f"unsupported shape {tuple(r.shape)}")
    plan = wkv_plan(S)
    # contiguous and 16-byte aligned: the kernel loads 4 elements at a time
    r, k, v, w, u, state0 = (
        a if a is None or a.data_ptr() % 16 == 0 else a.clone()
        for a in (None if x is None else x.contiguous() for x in (r, k, v, w, u, state0)))
    out = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    stateT = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    chunk, ws, wd = 0, None, None
    if plan.route == "chunked":
        # chunk contributions, overwritten by the scan with chunk-start states
        chunk = plan.chunk
        ws = torch.empty((B, H, plan.n_chunks, hd, hd), dtype=torch.float32, device=r.device)
        wd = torch.empty((B, H, plan.n_chunks, hd), dtype=torch.float32, device=r.device)
    lib = _lib()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = lib.wkv_fwd(
            _DTYPES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if state0 is None else state0.data_ptr(),
            out.data_ptr(), stateT.data_ptr(),
            None if ws is None else ws.data_ptr(), None if wd is None else wd.data_ptr(),
            B, S, H, hd, chunk, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"wkv kernel launch failed: {lib.wkv_error_string(rc).decode()} "
            f"(r {tuple(r.shape)}, {r.dtype}, {plan})"
        )
    _build.LAUNCHES["wkv"] += 1
    return out, stateT
