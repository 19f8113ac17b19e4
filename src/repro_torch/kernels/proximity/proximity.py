"""Cross proximity kernel wrapper and its plain PyTorch twin.

Ports ``repro.kernels.proximity.proximity`` (``_proximity_kernel`` /
``proximity_pallas``).  The CUDA kernel (``repro_torch/csrc/proximity.cu``)
computes the principal-angle block ``(Ka, n, p) x (Kb, n, q) -> (Ka, Kb)``
in degrees; the square matrix is the case ``Ua is Ub`` followed by the
hygiene pass (:func:`repro_torch.kernels.proximity.ops.proximity`).  Unlike
the TPU kernel it is not square-only and does not zero-pad K: it masks the
ragged edge itself.

:func:`proximity_cross` takes the plain twin only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.measures import eq3_from_diag, measure_from_gram
from repro_torch.kernels import _build

# Largest basis rank the kernel instantiates (csrc/proximity.cu kMaxRank).
MAX_RANK = 8

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_int,
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
]


def _lib() -> ctypes.CDLL:
    lib = _build.load("proximity")
    if lib.proximity_cross_f32.argtypes is None:
        lib.proximity_cross_f32.argtypes = _ARGTYPES
        lib.proximity_cross_f32.restype = ctypes.c_int
        lib.proximity_error_string.argtypes = [ctypes.c_int]
        lib.proximity_error_string.restype = ctypes.c_char_p
    return lib


def check_operands(Ua: torch.Tensor, Ub: torch.Tensor, measure: str) -> None:
    """Raise on operands the kernel (and its twin) do not take."""
    if measure not in ("eq2", "eq3"):
        raise ValueError(f"unknown measure: {measure!r}")
    if Ua.ndim != 3 or Ub.ndim != 3:
        raise ValueError(
            f"expected (Ka, n, p) and (Kb, n, q) stacks, got "
            f"{tuple(Ua.shape)} and {tuple(Ub.shape)}"
        )
    if Ua.shape[1] != Ub.shape[1]:
        raise ValueError(
            f"ambient dims differ: n={Ua.shape[1]} vs n={Ub.shape[1]}"
        )
    p, q = int(Ua.shape[2]), int(Ub.shape[2])
    if measure == "eq3" and p != q:
        raise ValueError(
            f"eq3 pairs identically ordered angles and needs p == q, got "
            f"p={p}, q={q} (use eq2 for rectangular pairs)"
        )
    if max(p, q) > MAX_RANK:
        raise ValueError(
            f"the proximity kernel supports basis ranks p, q <= {MAX_RANK}, "
            f"got p={p}, q={q}"
        )
    if Ua.device != Ub.device:
        raise ValueError(f"operands on {Ua.device} and {Ub.device}")


def proximity_plain(
    Ua: torch.Tensor, Ub: torch.Tensor, measure: str = "eq3"
) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: (Ka, n, p) x (Kb, n, q) -> (Ka, Kb).

    Same function as the kernel: the Gram entries of the float32 inputs,
    summed without float32 cancellation (float64 here; FP32 chunk sums with
    FP64 totals in the kernel) and rounded to float32, then the measure
    core's clipped-arccos (eq3) / packed-Jacobi (eq2) reduction in float32.
    """
    Ua, Ub = Ua.float().double(), Ub.float().double()
    if measure == "eq3":
        return eq3_from_diag(torch.einsum("anr,bnr->abr", Ua, Ub).float())
    G = torch.einsum("anp,bnq->abpq", Ua, Ub).float()
    return measure_from_gram(G, measure, eq2_solver="jacobi")


def proximity_cuda(
    Ua: torch.Tensor, Ub: torch.Tensor, measure: str = "eq3"
) -> torch.Tensor:
    """Launch the CUDA kernel on float32 CUDA stacks -> (Ka, Kb) degrees."""
    check_operands(Ua, Ub, measure)
    for name, U in (("Ua", Ua), ("Ub", Ub)):
        if U.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {U.device}")
        if U.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {U.dtype}")
        if U.shape[0] == 0 or U.shape[1] == 0:
            raise ValueError(f"{name} is empty: {tuple(U.shape)}")
        if U.shape[0] >= 2**31 or U.numel() >= 2**62:
            raise ValueError(f"{name} is too large: {tuple(U.shape)}")
    Ka, n, p = (int(s) for s in Ua.shape)
    Kb, _, q = (int(s) for s in Ub.shape)
    C = torch.empty((Ka, Kb), dtype=torch.float32, device=Ua.device)
    lib = _lib()
    with torch.cuda.device(Ua.device):
        stream = torch.cuda.current_stream(Ua.device).cuda_stream
        rc = lib.proximity_cross_f32(
            Ua.data_ptr(), *Ua.stride(), Ka,
            Ub.data_ptr(), *Ub.stride(), Kb,
            n, p, q, int(measure == "eq2"),
            C.data_ptr(), C.stride(0), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"proximity kernel launch failed: "
            f"{lib.proximity_error_string(rc).decode()} "
            f"(Ka={Ka}, Kb={Kb}, n={n}, p={p}, q={q}, {measure})"
        )
    _build.LAUNCHES["proximity"] += 1
    return C


def proximity_cross(
    Ua: torch.Tensor, Ub: torch.Tensor, measure: str = "eq3"
) -> torch.Tensor:
    """(Ka, n, p) x (Kb, n, q) -> (Ka, Kb) degrees through the kernel.

    CPU tensors take :func:`proximity_plain`; CUDA tensors launch the
    kernel (and raise if it cannot), never the twin.
    """
    check_operands(Ua, Ub, measure)
    if Ua.device.type == "cpu":
        return proximity_plain(Ua, Ub, measure)
    return proximity_cuda(Ua.float(), Ub.float(), measure)
