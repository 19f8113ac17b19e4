"""Cross proximity kernel wrapper, its eq2 plan and its plain PyTorch twin.

Ports ``repro.kernels.proximity.proximity`` (``_proximity_kernel`` /
``proximity_pallas``).  The CUDA kernel (``repro_torch/csrc/proximity.cu``)
computes the principal-angle block ``(Ka, n, p) x (Kb, n, q) -> (Ka, Kb)``
in degrees; the square matrix is the case ``Ua is Ub`` followed by the
hygiene pass (:func:`repro_torch.kernels.proximity.ops.proximity`).  Unlike
the TPU kernel it is not square-only and does not zero-pad K: it masks the
ragged edge itself.  Like the TPU kernel it takes any basis rank, and every
rank runs on the FP64 tensor cores; when both operands are one stack, only
the upper-triangle tiles of the square are launched (:func:`triangle_tile`).
Eq. 3 mirrors each value; eq. 2 runs its Jacobi on both ``G^T G`` and
``G G^T`` of each unordered pair.  Above rank 8 (``MAX_TC_RANK``, the
largest rank a template unrolls) eq. 3 runs in chunks of 8 columns, adding
into its result, and eq. 2 forms each pair's Gram in pieces of at most
8 x 8 and reduces it with a runtime-rank Jacobi.  Eq. 2 splits n where its
tiles cannot fill the card and runs its tiles in batches where its
workspace would outgrow ``EQ2_WORKSPACE_BYTES`` (:func:`eq2_plan`, a pure
host function whose numbers the kernel takes as arguments).

:func:`proximity_cross` takes the plain twin only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.core.measures import eq3_from_diag, measure_from_gram
from repro_torch.kernels import _build

# Clients per side of the eq3 tensor-core kernel's square block tile
# (csrc/proximity.cu ``Eq3Tile``), at every rank.
EQ3_TILE = 32
# The eq2 tensor-core kernel (csrc/proximity.cu ``Eq2Tile``): 32 x 32 client
# pairs a block; n staged 16 rows (one k16 mma step) at a time; FP64
# registers a lane gives its Gram rows (``kEq2Doubles``); a split takes at
# least four k16 steps, so its copy ring has work.
EQ2_TILE = 32
EQ2_K_STEP = 16
EQ2_DOUBLES = 80
EQ2_MIN_SPLIT_ROWS = 64
# The largest rank a template of the kernel unrolls: larger ranks run in
# chunks (eq3) and pieces (eq2) of at most this many columns.
MAX_TC_RANK = 8
# Cap on the eq2 workspace; a plan that would need more runs its tiles in
# batches, each batch's pieces and then its reduce.
EQ2_WORKSPACE_BYTES = 512 << 20
# The any-rank eq2 reduce (csrc/proximity.cu ``eq2_form_any``,
# ``eq2_jacobi_any``): the most epilogues a block runs, and the shared
# memory a block may take on an H100.
REDUCE_ANY_JOBS = 64
SMEM_BYTES = 232448

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_int,
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
]


def triangle_tile(x: int) -> tuple[int, int]:
    """The tile ``(bi, bj)``, ``bi <= bj``, that block ``x`` of the symmetric
    eq3 grid computes: x enumerates the upper triangle column by column,
    (0, 0), (0, 1), (1, 1), (0, 2), ...  The kernel's ``triangle_tile`` uses
    the same formula (a double square root, then exact integer correction)."""
    j = int((math.sqrt(8.0 * x + 1.0) - 1.0) / 2.0)
    while j * (j + 1) // 2 > x:
        j -= 1
    while (j + 1) * (j + 2) // 2 <= x:
        j += 1
    return x - j * (j + 1) // 2, j


def triangle_tiles(K: int) -> int:
    """Blocks of the symmetric eq3 grid for K clients."""
    nt = -(-K // EQ3_TILE)
    return nt * (nt + 1) // 2


def eq2_row_group(p: int, q: int) -> int:
    """Gram rows a block accumulates: all p where a lane's accumulators (4
    pairs x rows x q) and one step's fragments (4 q + 8) fit in
    ``EQ2_DOUBLES``, else the largest divisor of p that fits (the kernel's
    ``eq2_row_group``)."""
    for d in range(p, 1, -1):
        if p % d == 0 and 4 * d * q + 4 * q + 8 <= EQ2_DOUBLES:
            return d
    return 1


class Eq2Piece(NamedTuple):
    """One launch of the eq2 Gram kernel ``eq2_tc<rows, cols>``: a grid of
    ``row_chunks x col_chunks`` pieces of the pair's Gram, piece (i, j) the
    rows ``[r_base + i * rows, ... + rows)`` and columns ``[s_base + j * cols,
    ... + cols)``, each in ``groups`` blocks of ``row_group`` rows."""
    rows: int
    cols: int
    r_base: int
    s_base: int
    row_chunks: int
    col_chunks: int

    @property
    def row_group(self) -> int:
        return eq2_row_group(self.rows, self.cols)

    @property
    def groups(self) -> int:
        return self.rows // self.row_group

    @property
    def blocks(self) -> int:
        """Blocks of a tile and split."""
        return self.row_chunks * self.col_chunks * self.groups


def eq2_pieces(p: int, q: int, chunk_p: int, chunk_q: int) -> list[Eq2Piece]:
    """The launches that cover a p x q Gram in pieces of chunk_p x chunk_q:
    the full pieces, then the ragged last rows and columns (at most four
    launches; the kernel's ``launch_eq2`` walks them in this order)."""
    fp, fq = p - p % chunk_p, q - q % chunk_q
    rows = [(chunk_p, 0, p // chunk_p), (p - fp, fp, 1)]
    cols = [(chunk_q, 0, q // chunk_q), (q - fq, fq, 1)]
    return [Eq2Piece(rw, cw, r0, s0, rn, cn)
            for rw, r0, rn in rows for cw, s0, cn in cols if rw and cw]


def eq2_chunks(p: int, q: int) -> tuple[int, int]:
    """The piece shape of a p x q Gram: (p, q) up to ``MAX_TC_RANK`` (one
    piece); above it the shape of at most 8 x 8 that loads the fewest
    operands a k16 step over all pieces: a block's A and B fragments (8 a
    Gram row, 4 a column, per lane) and its staged rows (2 a column of
    either operand, per thread), then the fewest blocks, then wider pieces."""
    if max(p, q) <= MAX_TC_RANK:
        return p, q

    def cost(cp: int, cq: int) -> tuple[int, int, int]:
        loads = blocks = 0
        for pc in eq2_pieces(p, q, cp, cq):
            per_block = 8 * pc.row_group + 4 * pc.cols + 2 * (pc.rows + pc.cols)
            loads += pc.blocks * per_block
            blocks += pc.blocks
        return loads, blocks, -cp * cq

    return min(((cp, cq) for cp in range(1, min(p, MAX_TC_RANK) + 1)
                for cq in range(1, min(q, MAX_TC_RANK) + 1)), key=lambda c: cost(*c))


def reduce_any_smem(p: int, q: int, jobs: int, sym: bool) -> int:
    """Shared memory of the larger block of the any-rank reduce: the
    forming block's float32 Gram of its pairs, or the Jacobi block's packed
    q x q triangle and scratch slot for each job and its q x q offset table
    (``form_any_words``, ``jacobi_any_words``)."""
    pairs = jobs // 2 if sym else jobs
    return 4 * max(p * q * pairs, (q * (q + 1) // 2 + 1) * jobs + q * q)


def reduce_jobs(p: int, q: int, sym: bool) -> int:
    """Epilogues a block of the any-rank reduce runs, one a thread: the
    most (64, 32, ... 1; even on the symmetric grid, two a pair) whose
    shared memory fits."""
    for jobs in (REDUCE_ANY_JOBS, 32, 16, 8, 4, 2, 1):
        if (not sym or jobs % 2 == 0) and reduce_any_smem(p, q, jobs, sym) <= SMEM_BYTES:
            return jobs
    raise ValueError(f"eq2 at p={p}, q={q}: one pair's reduce does not fit in shared memory")


class Eq2Plan(NamedTuple):
    """The eq2 kernel's grid for ``(Ka, n, p) x (Kb, n, q)``: ``tiles``
    blocks of 32 x 32 client pairs (the upper triangle when ``sym``), each
    pair's Gram in pieces of ``chunk_p x chunk_q`` (:meth:`pieces`), and n
    in ``splits`` of ``split_rows`` rows (split s covers ``[s * split_rows,
    min((s + 1) * split_rows, n))``).  With more than one split, piece or
    row group, each block writes FP64 partial Grams to a workspace that a
    second pass adds in split order; the tiles run in batches of
    ``batch_tiles``.  ``reduce_jobs``: epilogues a block of the any-rank
    second pass (0 on the templates' route, p and q <= 8)."""
    sym: bool
    p: int
    q: int
    tiles: int
    chunk_p: int
    chunk_q: int
    splits: int
    split_rows: int
    batch_tiles: int
    reduce_jobs: int

    def pieces(self) -> list[Eq2Piece]:
        return eq2_pieces(self.p, self.q, self.chunk_p, self.chunk_q)

    @property
    def any_rank(self) -> bool:
        return (self.chunk_p, self.chunk_q) != (self.p, self.q)

    @property
    def row_group(self) -> int:
        return self.pieces()[0].row_group

    @property
    def groups(self) -> int:
        return self.pieces()[0].groups

    @property
    def workspace(self) -> bool:
        return self.splits > 1 or self.any_rank or self.groups > 1

    @property
    def entries(self) -> int:
        """Workspace rows a tile: the Gram's p * q, or on the any-rank route
        at least the rows the reduce's float32 matrices take (q (q + 1) / 2
        floats an epilogue, two an epilogue pair on the symmetric grid, two
        floats a row's double; the kernel's ``launch_eq2``)."""
        if not self.any_rank:
            return self.p * self.q
        tri = self.q * (self.q + 1) // 2
        return max(self.p * self.q, -(-tri * (2 if self.sym else 1) // 2))

    def workspace_doubles(self) -> int:
        """FP64 entries of the workspace: (splits, batch_tiles, entries, 32 * 32)."""
        if not self.workspace:
            return 0
        return self.splits * self.batch_tiles * self.entries * EQ2_TILE * EQ2_TILE

    def batches(self) -> list[range]:
        """The tile ranges run one after the other."""
        return [range(t0, min(t0 + self.batch_tiles, self.tiles))
                for t0 in range(0, self.tiles, self.batch_tiles)]


def eq2_plan(Ka: int, Kb: int, n: int, p: int, q: int, sym: bool,
             sm_count: int = _build.H100_SMS,
             workspace_bytes: int = EQ2_WORKSPACE_BYTES) -> Eq2Plan:
    """The eq2 kernel's plan for ``(Ka, n, p) x (Kb, n, q)`` (``sym``: one
    stack on both sides, so ``Ka == Kb``, ``p == q``).

    The kernel runs one 256-thread block per SM (its registers), so where
    tiles x (pieces and row groups) blocks fill at least a wave of
    ``sm_count`` SMs (K = 1024 gives 528 triangle tiles) n stays whole: one
    split.  Else n is cut into splits of whole k16 steps, at least
    ``EQ2_MIN_SPLIT_ROWS`` rows each, as many as one wave holds: blocks x
    splits <= ``sm_count``, as close to it as the rows allow (K = 97: 10
    triangle tiles x 13 splits of 240 rows, 130 blocks).  Ranks above
    ``MAX_TC_RANK`` take pieces (:func:`eq2_chunks`).  A workspace larger
    than ``workspace_bytes`` is cut by running the tiles in equal batches
    (K = 1024, p = q = 16: 528 tiles of 2 MiB in 3 batches of 176; the
    ranks up to 8 keep one batch at K = 1024)."""
    if min(Ka, Kb, n, p, q) < 1:
        raise ValueError(f"empty eq2 problem: Ka={Ka} Kb={Kb} n={n} p={p} q={q}")
    if sym and (Ka != Kb or p != q):
        raise ValueError(f"a symmetric grid needs Ka == Kb and p == q, got "
                         f"{Ka}, {Kb}, {p}, {q}")
    nta, ntb = -(-Ka // EQ2_TILE), -(-Kb // EQ2_TILE)
    tiles = nta * (nta + 1) // 2 if sym else nta * ntb
    chunk_p, chunk_q = eq2_chunks(p, q)
    blocks = sum(pc.blocks for pc in eq2_pieces(p, q, chunk_p, chunk_q))

    def whole_steps(rows: int) -> int:
        return -(-rows // EQ2_K_STEP) * EQ2_K_STEP

    wave = sm_count // (tiles * blocks)   # splits one wave of blocks holds
    rows = whole_steps(n)
    if wave > 1:
        rows = min(rows, max(EQ2_MIN_SPLIT_ROWS, whole_steps(-(-n // wave))))
    plan = Eq2Plan(sym, p, q, tiles, chunk_p, chunk_q, -(-n // rows), rows, tiles,
                   reduce_jobs(p, q, sym) if (chunk_p, chunk_q) != (p, q) else 0)
    per_tile = 8 * plan.workspace_doubles() // tiles
    if per_tile * tiles > workspace_bytes:
        batches = -(-tiles // max(1, workspace_bytes // per_tile))
        plan = plan._replace(batch_tiles=-(-tiles // batches))
    return plan


def proximity_route(p: int, q: int, measure: str) -> str:
    """The route key a launch is counted under in ``_build.ROUTE_LAUNCHES``:
    the measure, with ``_any_rank`` above ``MAX_TC_RANK``."""
    return measure + ("_any_rank" if max(p, q) > MAX_TC_RANK else "")


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
    if Ua.device != Ub.device:
        raise ValueError(f"operands on {Ua.device} and {Ub.device}")


def proximity_plain(
    Ua: torch.Tensor, Ub: torch.Tensor, measure: str = "eq3"
) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: (Ka, n, p) x (Kb, n, q) -> (Ka, Kb).

    Same function as the kernel: the Gram entries of the float32 inputs,
    summed without float32 cancellation (float64 here, FP64 tensor-core sums
    in the kernel) and rounded to float32, then the measure core's
    clipped-arccos (eq3) / packed-Jacobi (eq2) reduction in float32.  The
    kernel's eq2 schedule (splits, both epilogues of the symmetric grid) is
    emulated by :func:`repro_torch.kernels.proximity.ref.proximity_eq2_schedule_ref`.
    """
    Ua, Ub = Ua.float().double(), Ub.float().double()
    if measure == "eq3":
        return eq3_from_diag(torch.einsum("anr,bnr->abr", Ua, Ub).float())
    G = torch.einsum("anp,bnq->abpq", Ua, Ub).float()
    return measure_from_gram(G, measure, eq2_solver="jacobi")


def check_out(out: torch.Tensor, Ka: int, Kb: int, device: torch.device) -> None:
    """Raise on an ``out`` the kernel cannot write: it must be a float32
    (Ka, Kb) view on the operands' device whose rows are unit-stride and do
    not overlap (the kernel writes row a at ``out.data_ptr() + a * ldc``)."""
    if out.device != device:
        raise ValueError(f"out is on {out.device}, the operands on {device}")
    if out.dtype != torch.float32:
        raise ValueError(f"out must be float32, got {out.dtype}")
    if tuple(out.shape) != (Ka, Kb):
        raise ValueError(f"out has shape {tuple(out.shape)}, want {(Ka, Kb)}")
    if out.stride(1) != 1 or (Ka > 1 and out.stride(0) < Kb):
        raise ValueError(f"out's rows must be unit-stride and apart, got strides {out.stride()}")


def proximity_cuda(
    Ua: torch.Tensor, Ub: torch.Tensor, measure: str = "eq3",
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on float32 CUDA stacks -> (Ka, Kb) degrees.

    ``out``: a (Ka, Kb) float32 view on Ua's device with unit-stride rows
    (:func:`check_out`), e.g. a strip of rows of a larger matrix, which the
    kernel fills in place; returned.  Default: a new tensor."""
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
    if out is None:
        C = torch.empty((Ka, Kb), dtype=torch.float32, device=Ua.device)
    else:
        check_out(out, Ka, Kb, Ua.device)
        C = out
    plan, ws = None, None
    if measure == "eq2":
        # the kernel's symmetric test: one stack, same strides, on both sides
        sym = (Ua.data_ptr() == Ub.data_ptr() and Ua.shape == Ub.shape
               and Ua.stride() == Ub.stride())
        plan = eq2_plan(Ka, Kb, n, p, q, sym, _build.sm_count(Ua.device.index))
        if plan.workspace:
            ws = torch.empty(plan.workspace_doubles(), dtype=torch.float64,
                             device=Ua.device)
    lib = _lib()
    with torch.cuda.device(Ua.device):
        stream = torch.cuda.current_stream(Ua.device).cuda_stream
        rc = lib.proximity_cross_f32(
            Ua.data_ptr(), *Ua.stride(), Ka,
            Ub.data_ptr(), *Ub.stride(), Kb,
            n, p, q, int(measure == "eq2"),
            C.data_ptr(), C.stride(0),
            *((plan.split_rows, plan.splits, plan.tiles, plan.batch_tiles, plan.chunk_p,
               plan.chunk_q, plan.reduce_jobs) if plan else (0,) * 7),
            None if ws is None else ws.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"proximity kernel launch failed: "
            f"{lib.proximity_error_string(rc).decode()} "
            f"(Ka={Ka}, Kb={Kb}, n={n}, p={p}, q={q}, {measure}, {plan})"
        )
    _build.LAUNCHES["proximity"] += 1
    _build.ROUTE_LAUNCHES["proximity", proximity_route(p, q, measure)] += 1
    return C


def proximity_cross(
    Ua: torch.Tensor, Ub: torch.Tensor, measure: str = "eq3",
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """(Ka, n, p) x (Kb, n, q) -> (Ka, Kb) degrees through the kernel.

    CPU tensors take :func:`proximity_plain`, which ignores ``out`` and
    returns a new tensor; CUDA tensors launch the kernel (and raise if it
    cannot), never the twin, writing into ``out`` where one is given.
    """
    check_operands(Ua, Ub, measure)
    if Ua.device.type == "cpu":
        return proximity_plain(Ua, Ub, measure)
    return proximity_cuda(Ua.float(), Ub.float(), measure, out=out)
