"""Batched, strided tall-skinny GEMM wrapper and its plain PyTorch twin.

Ports ``repro.kernels.tsgemm.tsgemm`` (``_tsgemm_kernel`` /
``tsgemm_pallas``), which the reference vmaps over clients.  The CUDA
kernel (``repro_torch/csrc/tsgemm.cu``) takes ``(Bt, m, k) @ (Bt, k, p)``
with the batch in the grid and every operand addressed through its strides,
so the transposed views the randomized SVD passes (``D.T``, ``Q.T``) are
read in place, never copied.  :func:`split_k_plan` fits the kernel's column
slab to ``p`` and cuts ``k`` into splits when the grid would not fill the
card; the kernel sums the splits' partial products in a second step.

:func:`repro_torch.kernels.tsgemm.ops.tsgemm` takes the plain twin only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BATCH = 65535

# The kernel's tiling (csrc/tsgemm.cu: kBM, kBK) and its column slabs.
TS_ROWS = 128     # rows of C per block
TS_K = 32         # k per tile
SLABS = (4, 8, 12, 16)

_ARGTYPES = [
    ctypes.c_int,
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]


def split_k_plan(Bt: int, m: int, k: int, p: int, *,
                 sm_count: int = _build.H100_SMS) -> tuple[int, int, int, int]:
    """``(slab, n_slabs, nsplit, split_len)`` for ``(Bt, m, k) @ (Bt, k, p)``.

    The columns of C go in ``n_slabs`` slabs of ``slab`` (a multiple of 4,
    at most 16: 12 for p = 11).  When the grid (row tiles x slabs x Bt
    blocks) holds fewer than four blocks per SM, split ``s`` takes
    ``k`` indices ``[s * split_len, (s + 1) * split_len)``: as many splits
    as reach four blocks per SM, each at least four tiles of ``TS_K`` and a
    whole number of them, none past ``k``.
    """
    n_slabs = -(-p // SLABS[-1])
    slab = -(-p // n_slabs)
    slab = -(-slab // 4) * 4
    blocks = -(-m // TS_ROWS) * n_slabs * Bt
    nsplit = min(-(-4 * sm_count // blocks), k // (4 * TS_K))
    if nsplit <= 1:
        return slab, n_slabs, 1, k
    split_len = -(-(-(-k // TS_K)) // nsplit) * TS_K
    return slab, n_slabs, -(-k // split_len), split_len


def _lib() -> ctypes.CDLL:
    lib = _build.load("tsgemm")
    if lib.tsgemm_batched.argtypes is None:
        lib.tsgemm_batched.argtypes = _ARGTYPES
        lib.tsgemm_batched.restype = ctypes.c_int
        lib.tsgemm_error_string.argtypes = [ctypes.c_int]
        lib.tsgemm_error_string.restype = ctypes.c_char_p
    return lib


def check_operands(A: torch.Tensor, B: torch.Tensor) -> None:
    """Raise on operand shapes the kernel (and its twin) do not take."""
    if A.ndim not in (2, 3) or B.ndim != A.ndim:
        raise ValueError(
            f"expected (m, k) @ (k, p) or (Bt, m, k) @ (Bt, k, p), got "
            f"{tuple(A.shape)} @ {tuple(B.shape)}"
        )
    if A.shape[-1] != B.shape[-2] or A.shape[:-2] != B.shape[:-2]:
        raise ValueError(f"shape mismatch: {tuple(A.shape)} @ {tuple(B.shape)}")
    if A.device != B.device:
        raise ValueError(f"operands on {A.device} and {B.device}")


def tsgemm_plain(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin: ``A @ B`` with both operands upcast to float32."""
    return torch.matmul(A.float(), B.float())


def tsgemm_cuda(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: ``(Bt, m, k) @ (Bt, k, p) -> (Bt, m, p)``
    float32; 2-D operands are a batch of one."""
    check_operands(A, B)
    if A.device.type != "cuda":
        raise ValueError(f"tsgemm_cuda needs CUDA tensors, got {A.device}")
    if A.dtype not in _DTYPES or B.dtype != A.dtype:
        raise ValueError(
            f"tsgemm takes float32 or bfloat16 operands of one dtype, got "
            f"{A.dtype} and {B.dtype}"
        )
    squeeze = A.ndim == 2
    if squeeze:
        A, B = A.unsqueeze(0), B.unsqueeze(0)
    Bt, m, k = (int(s) for s in A.shape)
    p = int(B.shape[-1])
    if min(Bt, m, k, p) == 0:
        raise ValueError(f"empty operand: {tuple(A.shape)} @ {tuple(B.shape)}")
    if Bt > _MAX_BATCH:
        raise ValueError(f"batch {Bt} exceeds the kernel's grid limit {_MAX_BATCH}")
    if max(m, k, p) >= 2**31:
        raise ValueError(f"dimension too large: {tuple(A.shape)} @ {tuple(B.shape)}")
    C = torch.empty((Bt, m, p), dtype=torch.float32, device=A.device)
    # The kernel streams its A operand; when B is the wide one (Q^T @ D),
    # compute the transpose C^T = B^T @ A^T through transposed views.
    if p > m:
        A_, B_, C_ = B.transpose(1, 2), A.transpose(1, 2), C.transpose(1, 2)
        m_, p_ = p, m
    else:
        A_, B_, C_ = A, B, C
        m_, p_ = m, p
    sab, sam, sak = A_.stride()
    a_mode = 1 if sak == 1 and sam != 1 else 0
    # 16-byte copies along A's fast axis: 4 float32 or 8 bfloat16 values
    epv = 16 // A_.element_size()
    fast_ok = sam == 1 and sak % epv == 0 if a_mode == 0 else sam % epv == 0
    vec = int(fast_ok and sab % epv == 0 and A_.data_ptr() % 16 == 0)
    slab, _, nsplit, split_len = split_k_plan(Bt, m_, k, p_,
                                             sm_count=_build.sm_count(A.device.index))
    part = None
    if nsplit > 1:
        part = torch.empty((nsplit, Bt, m_, p_), dtype=torch.float32, device=A.device)
    lib = _lib()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = lib.tsgemm_batched(
            _DTYPES[A.dtype],
            A_.data_ptr(), sab, sam, sak,
            B_.data_ptr(), *B_.stride(),
            C_.data_ptr(), *C_.stride(),
            None if part is None else part.data_ptr(),
            Bt, m_, k, p_, a_mode, vec, slab, nsplit, split_len, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"tsgemm kernel launch failed: {lib.tsgemm_error_string(rc).decode()} "
            f"({tuple(A.shape)} @ {tuple(B.shape)}, {A.dtype})"
        )
    _build.LAUNCHES["tsgemm"] += 1
    return C[0] if squeeze else C
