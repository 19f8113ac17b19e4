"""WKV6 recurrence kernel wrapper, its plan and its plain PyTorch twin.

Ports ``repro.kernels.wkv.wkv`` (``_wkv_kernel`` / ``wkv_pallas``).  The CUDA
source (``repro_torch/csrc/wkv.cu``) has two routes, chosen explicitly by
:func:`wkv_plan` from the sequence length: the recurrent one (``wkv_step``:
each (batch, head) state in registers as 16-byte column quads, the 16 row
groups of a column in one warp; decode and short sequences) and the chunked one
(chunk contributions, a scan over chunks, chunk outputs: three kernels
under one call; prefill).  Both read r, k, v as float32 or
bfloat16 and compute in float32.

The backward (``repro_torch/csrc/wkv_bwd.cu``, :func:`wkv_bwd_cuda`) walks
the sequence in the chunks of :func:`wkv_bwd_plan` from the forward's
chunk-start states (``wkv_cuda(..., return_starts=True)``), each chunk in
16-step sub-blocks by the chunk form of gated linear attention on the
tensor cores (3xTF32); :func:`wkv_bwd_plain` is its twin and
:func:`~repro_torch.kernels.wkv.ref.wkv_bwd_chunked_ref` its schedule.

:func:`repro_torch.kernels.wkv.ops.wkv` takes the plain twins only for
tensors on the CPU; for CUDA tensors it launches the kernels or raises.
``meta`` tensors (a dry run) take :func:`wkv_meta` and :func:`wkv_bwd_meta`:
the outputs' and scratch's shapes, and one launch counted with
:func:`wkv_cost` or :func:`wkv_bwd_cost`, the formulas the kernels' bounds
are read from.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build, _meta
from repro_torch.kernels.wkv.ref import wkv_bwd_ref, wkv_ref

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
_BWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5
                 + [ctypes.c_void_p])
# The backward's scratch: each chunk's sub-block start states.
BWD_STATE_SLOTS = CHUNK // SUB_BLOCK


class WkvPlan(NamedTuple):
    """``route`` "recurrent" or "chunked"; chunk ``c`` covers the steps
    ``[c * chunk, min((c + 1) * chunk, S))`` of ``n_chunks``."""
    route: str
    chunk: int
    n_chunks: int


def wkv_plan(S: int) -> WkvPlan:
    """The route for a sequence of ``S`` steps: the recurrent kernel below
    ``CHUNKED_MIN_S`` steps (decode is S = 1; one kernel body for every such
    S, stepping the sequence with the state in registers), else chunks of
    ``CHUNK``."""
    if S < 1:
        raise ValueError(f"S must be positive, got {S}")
    if S < CHUNKED_MIN_S:
        return WkvPlan("recurrent", S, 1)
    return WkvPlan("chunked", CHUNK, -(-S // CHUNK))


def wkv_bwd_plan(S: int) -> WkvPlan:
    """The backward's chunks for a sequence of ``S`` steps: chunks of
    ``CHUNK`` whatever the forward's route, so that a sequence shorter than
    ``CHUNKED_MIN_S`` (recurrent forward, no chunk states) is one chunk
    starting from state0."""
    if S < 1:
        raise ValueError(f"S must be positive, got {S}")
    return WkvPlan("chunked", CHUNK, -(-S // CHUNK))


def _lib() -> ctypes.CDLL:
    lib = _build.load("wkv")
    if lib.wkv_fwd.argtypes is None:
        lib.wkv_fwd.argtypes = _ARGTYPES
        lib.wkv_fwd.restype = ctypes.c_int
        lib.wkv_error_string.argtypes = [ctypes.c_int]
        lib.wkv_error_string.restype = ctypes.c_char_p
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("wkv_bwd")
    if lib.wkv_bwd.argtypes is None:
        lib.wkv_bwd.argtypes = _BWD_ARGTYPES
        lib.wkv_bwd.restype = ctypes.c_int
        lib.wkv_bwd_error_string.argtypes = [ctypes.c_int]
        lib.wkv_bwd_error_string.restype = ctypes.c_char_p
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


def wkv_bwd_plain(r, k, v, w, u, dout, state0: Optional[torch.Tensor] = None,
                  dstateT: Optional[torch.Tensor] = None):
    """Plain PyTorch twin of the backward kernel: the reverse-time
    recurrence stepped from every forward state (:func:`wkv_bwd_ref`) ->
    (dr, dk, dv, dw, du, dstate0), all float32."""
    return wkv_bwd_ref(r, k, v, w, u, dout, state0, dstateT)


def _check_cuda_operands(fn: str, r, k, v, w, u, extra: dict) -> tuple[int, int, int, int]:
    """The checks the forward and backward kernels share: CUDA tensors (or
    a dry run's ``meta`` ones), r, k, v of one dtype (float32 or bfloat16),
    w, u and ``extra`` float32, a head dim and shape the kernels take.
    Returns (B, S, H, hd)."""
    operands = (r, k, v, w, u) + tuple(a for a in extra.values() if a is not None)
    for a in operands:
        if a.device.type not in ("cuda", "meta"):
            raise ValueError(f"{fn} needs CUDA tensors, got {a.device}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"r, k, v must be one of float32 / bfloat16, got "
                         f"{r.dtype}, {k.dtype}, {v.dtype}")
    for name, a in (("w", w), ("u", u), *extra.items()):
        if a is not None and a.dtype != torch.float32:
            raise ValueError(f"{fn} takes a float32 {name}, got {a.dtype}")
    B, S, H, hd = (int(s) for s in r.shape)
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in the kernel's {HEAD_DIMS}")
    if min(B, S, H) == 0 or B > _MAX_BATCH or H > _MAX_BATCH or r.numel() >= 2**62:
        raise ValueError(f"unsupported shape {tuple(r.shape)}")
    return B, S, H, hd


def _aligned(*tensors):
    """Each tensor contiguous and 16-byte aligned (the kernels load 4
    elements at a time); None stays None."""
    return tuple(a if a is None or a.data_ptr() % 16 == 0 else a.clone()
                 for a in (None if x is None else x.contiguous() for x in tensors))


def wkv_cuda(r, k, v, w, u, state0: Optional[torch.Tensor] = None, *,
             return_starts: bool = False):
    """Launch the CUDA kernel -> (out, final state), both float32.

    r, k, v: CUDA tensors of one dtype, float32 or bfloat16; w, u and state0
    float32.  The route is :func:`wkv_plan` of the sequence length; one call
    counts one launch whatever the route.  With ``return_starts`` the result
    gains the state at the start of each of :func:`wkv_bwd_plan`'s chunks,
    (B, H, chunks, hd, hd) float32, which the backward recomputes from: the
    chunked route's own workspace, or state0 (zeros) as the one chunk of a
    sequence the recurrent route takes.
    """
    check_operands(r, k, v, w, u, state0)
    B, S, H, hd = _check_cuda_operands("wkv_cuda", r, k, v, w, u, {"state0": state0})
    plan = wkv_plan(S)
    r, k, v, w, u, state0 = _aligned(r, k, v, w, u, state0)
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
    if not return_starts:
        return out, stateT
    if ws is None:   # one chunk (S < CHUNKED_MIN_S <= CHUNK), from state0
        ws = (torch.zeros((B, H, 1, hd, hd), dtype=torch.float32, device=r.device)
              if state0 is None else state0.reshape(B, H, 1, hd, hd).clone())
    return out, stateT, ws


def wkv_bwd_cuda(r, k, v, w, u, dout, starts, dstateT: Optional[torch.Tensor] = None):
    """Launch the CUDA backward -> (dr, dk, dv, dw, du, dstate0), all
    float32.

    r, k, v, w, u as :func:`wkv_cuda` takes them; ``dout`` (B, S, H, hd) and
    ``dstateT`` (B, H, hd, hd, or None for zeros) float32, the gradients of
    the output and of the final state; ``starts`` the chunk-start states
    that ``wkv_cuda(..., return_starts=True)`` gave for these operands.  Four
    kernels (chunk shares of the state gradient, a reverse scan over the
    chunks, each chunk's gradients, the sum of u's gradient) count one
    launch.  Scratch: each chunk's sub-block start states, ``BWD_STATE_SLOTS``
    (hd, hd) float32 states a chunk (268 MB at rwkv6's (4, 2048, 32, 64)).
    """
    check_operands(r, k, v, w, u)
    B, S, H, hd = _check_cuda_operands("wkv_bwd_cuda", r, k, v, w, u, {
        "dout": dout, "starts": starts, "dstateT": dstateT})
    plan = wkv_bwd_plan(S)
    if tuple(dout.shape) != (B, S, H, hd):
        raise ValueError(f"dout must be {(B, S, H, hd)}, got {tuple(dout.shape)}")
    if tuple(starts.shape) != (B, H, plan.n_chunks, hd, hd):
        raise ValueError(f"starts must be {(B, H, plan.n_chunks, hd, hd)}, got "
                         f"{tuple(starts.shape)}")
    if dstateT is not None and tuple(dstateT.shape) != (B, H, hd, hd):
        raise ValueError(f"dstateT must be {(B, H, hd, hd)}, got {tuple(dstateT.shape)}")
    devices = {a.device for a in (r, dout, starts) + (() if dstateT is None else (dstateT,))}
    if len(devices) != 1:
        raise ValueError(f"operands on {sorted(map(str, devices))}")
    r, k, v, w, u, dout, starts, dstateT = _aligned(r, k, v, w, u, dout, starts, dstateT)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=r.device)

    dr, dk, dv, dw = (f32(B, S, H, hd) for _ in range(4))
    du, dstate0 = f32(H, hd), f32(B, H, hd, hd)
    # the chunks' state-gradient shares, overwritten by the scan with the
    # gradient at each chunk's end; their decays; each chunk's share of du
    wsd = f32(B, H, plan.n_chunks, hd, hd)
    wd, du_part = f32(B, H, plan.n_chunks, hd), f32(B, H, plan.n_chunks, hd)
    wss = f32(B, H, plan.n_chunks, BWD_STATE_SLOTS, hd, hd)
    lib = _bwd_lib()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = lib.wkv_bwd(
            _DTYPES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), dout.data_ptr(), starts.data_ptr(),
            None if dstateT is None else dstateT.data_ptr(),
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
            dstate0.data_ptr(), wsd.data_ptr(), wd.data_ptr(), du_part.data_ptr(),
            wss.data_ptr(), B, S, H, hd, plan.chunk, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"wkv backward kernel launch failed: {lib.wkv_bwd_error_string(rc).decode()} "
            f"(r {tuple(r.shape)}, {r.dtype}, {plan})"
        )
    _build.LAUNCHES["wkv_bwd"] += 1
    return dr, dk, dv, dw, du, dstate0


def wkv_cost(B: int, S: int, H: int, hd: int, *, rkv_bytes: int, state0: bool,
             starts: bool = False) -> tuple[float, float]:
    """(flops, bytes) of one forward call, the least work the kernel must
    do: 5 flops a step and state entry (``out_j += r_i S_ij``, one FMA, and
    ``S_ij = w_i S_ij + k_i v_j``, a multiply and an FMA; the bonus term is
    per column, not per entry); r, k, v read in ``rkv_bytes``, w read and
    out written in float32, u read, the final state written and
    ``state0`` read where given, and with ``starts`` the backward's
    chunk-start states written."""
    n = B * S * H * hd
    states = (2 if state0 else 1) + (wkv_bwd_plan(S).n_chunks if starts else 0)
    return 5.0 * n * hd, rkv_bytes * 3.0 * n + 4.0 * (2 * n + H * hd + states * B * H * hd * hd)


def wkv_bwd_cost(B: int, S: int, H: int, hd: int, *, rkv_bytes: int
                 ) -> tuple[float, float, float]:
    """(tensor-core flops, FP32 flops, bytes) of one backward call, the work
    its kernels do: 12 hd^2 + 2 T hd flops a step on the TF32 tensor cores
    as 3xTF32 (five hd x hd products a sub-block and M = V dout^T in
    wkv_bwd_grad_tc, G_c in wkv_bwd_chunk_tc; T = ``SUB_BLOCK`` steps a
    sub-block) and the pair terms' 8 T hd flops a step on the FP32 cores
    beside them; r, k, v (``rkv_bytes`` each), w, dout, u and the
    chunk-start states read and dr, dk, dv, dw (float32), du and dstate0
    written once."""
    steps, n = B * S * H, B * S * H * hd
    starts = B * H * wkv_bwd_plan(S).n_chunks * hd * hd
    nbytes = (rkv_bytes * 3.0 * n + 4.0 * (2 * n + H * hd + starts)
              + 4.0 * (4 * n + H * hd + B * H * hd * hd))
    return ((12.0 * hd + 2.0 * SUB_BLOCK) * steps * hd, 8.0 * SUB_BLOCK * steps * hd, nbytes)


def wkv_meta(r, k, v, w, u, state0: Optional[torch.Tensor] = None, *,
             return_starts: bool = False):
    """:func:`wkv_cuda` on ``meta`` tensors: out, the final state, the
    chunked route's workspace and with ``return_starts`` the chunk-start
    states as empty ``meta`` tensors, and one launch reported to the dry
    run with :func:`wkv_cost`.  It refuses what the kernel refuses."""
    check_operands(r, k, v, w, u, state0)
    B, S, H, hd = _check_cuda_operands("wkv_meta", r, k, v, w, u, {"state0": state0})
    plan = wkv_plan(S)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=r.device)

    out, stateT = f32(B, S, H, hd), f32(B, H, hd, hd)
    ws = None
    if plan.route == "chunked":   # the chunk states, and their decays for the call
        ws = f32(B, H, plan.n_chunks, hd, hd)
        f32(B, H, plan.n_chunks, hd)
    _meta.record("wkv", *wkv_cost(B, S, H, hd, rkv_bytes=r.element_size(),
                                  state0=state0 is not None, starts=return_starts))
    if not return_starts:
        return out, stateT
    return out, stateT, f32(B, H, 1, hd, hd) if ws is None else ws


def wkv_bwd_meta(r, k, v, w, u, dout, starts, dstateT: Optional[torch.Tensor] = None):
    """:func:`wkv_bwd_cuda` on ``meta`` tensors: the six gradients and the
    kernels' scratch (``BWD_STATE_SLOTS`` states a chunk among them) as
    empty ``meta`` tensors, and one launch reported to the dry run with
    :func:`wkv_bwd_cost`, both parts of its flops.  It refuses what the
    kernels refuse."""
    check_operands(r, k, v, w, u)
    B, S, H, hd = _check_cuda_operands("wkv_bwd_meta", r, k, v, w, u, {
        "dout": dout, "starts": starts, "dstateT": dstateT})
    plan = wkv_bwd_plan(S)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=r.device)

    grads = tuple(f32(B, S, H, hd) for _ in range(4)) + (f32(H, hd), f32(B, H, hd, hd))
    # the scratch, live for the call as on the card (the sub-block states last)
    scratch = [f32(B, H, plan.n_chunks, hd, hd), f32(B, H, plan.n_chunks, hd),
               f32(B, H, plan.n_chunks, hd), f32(B, H, plan.n_chunks, BWD_STATE_SLOTS, hd, hd)]
    del scratch
    tc, fp32, nbytes = wkv_bwd_cost(B, S, H, hd, rkv_bytes=r.element_size())
    _meta.record("wkv_bwd", tc + fp32, nbytes)
    return grads
