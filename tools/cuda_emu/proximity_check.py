"""The proximity kernel (``src/repro_torch/csrc/proximity.cu``) on the CPU.

    python3 tools/cuda_emu/proximity_check.py

Builds the kernel source with g++ through the thread emulation of
``emu_runtime.h`` (a block's threads are OS threads, ``__syncthreads`` a
barrier, ``mma.sync`` a warp-collective exchange, ``cp.async`` a plain copy)
into ``build/cuda_emu/`` and runs it at small sizes against the plain twin
``proximity_plain``: squares and cross blocks at p = 3, 9, 12, 16 and 3 x 12,
column views of a wider stack, tile batches, splits over n, and the square
against the full rectangle, bitwise.  It checks the host plan, the index
arithmetic and the reductions; it says nothing of speed, and the emulated
mma sums each product in order where the card's may not.  About two
minutes.
"""
import ctypes
import importlib
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parent
OUT = ROOT / "build" / "cuda_emu"
TOL_DEG = 1e-3


class Emulated:
    """proximity.cu built for the CPU, called as the CUDA wrapper calls it."""

    def __init__(self, plan_module):
        sys.path.insert(0, str(HERE))
        from transform import transform

        OUT.mkdir(parents=True, exist_ok=True)
        cpp = OUT / "proximity_emu.cpp"
        cpp.write_text(transform((ROOT / "src/repro_torch/csrc/proximity.cu").read_text()))
        lib = OUT / "libproximity_emu.so"
        subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-pthread", f"-I{HERE}",
                        "-Wno-unknown-pragmas", "-o", str(lib), str(cpp),
                        str(HERE / "emu_runtime.cpp")], check=True)
        self.P = plan_module
        self.lib = ctypes.CDLL(str(lib))
        self.lib.proximity_cross_f32.argtypes = plan_module._ARGTYPES
        self.lib.proximity_cross_f32.restype = ctypes.c_int

    def __call__(self, Ua, Ub, measure, sm_count=132, workspace_bytes=None):
        P = self.P
        Ka, n, p = Ua.shape
        Kb, _, q = Ub.shape
        C = torch.full((Ka, Kb), float("nan"))
        plan, ws = None, None
        if measure == "eq2":
            sym = (Ua.data_ptr() == Ub.data_ptr() and Ua.shape == Ub.shape
                   and Ua.stride() == Ub.stride())
            plan = P.eq2_plan(Ka, Kb, n, p, q, sym, sm_count,
                              workspace_bytes or P.EQ2_WORKSPACE_BYTES)
            if plan.workspace:   # NaN-filled: an entry read before it is written shows
                ws = torch.full((plan.workspace_doubles(),), float("nan"), dtype=torch.float64)
        fields = ((plan.split_rows, plan.splits, plan.tiles, plan.batch_tiles, plan.chunk_p,
                   plan.chunk_q, plan.reduce_jobs) if plan else (0,) * 7)
        rc = self.lib.proximity_cross_f32(
            Ua.data_ptr(), *Ua.stride(), Ka, Ub.data_ptr(), *Ub.stride(), Kb, n, p, q,
            int(measure == "eq2"), C.data_ptr(), C.stride(0), *fields,
            None if ws is None else ws.data_ptr(), None)
        if rc != 0:
            raise RuntimeError(f"launch refused: {rc} ({plan})")
        return C, plan


def signatures(K, n, p, seed, spread=0.3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p))[None] + spread / np.sqrt(n) * rng.normal(size=(K, n, p))
    return torch.from_numpy(np.stack([np.linalg.qr(x)[0] for x in X]).astype(np.float32))


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    P = importlib.import_module("repro_torch.kernels.proximity.proximity")
    from repro_torch.core.angles import _hygiene

    emu = Emulated(P)
    failures = []

    def require(ok, what):
        print(("ok   " if ok else "FAIL ") + what, flush=True)
        if not ok:
            failures.append(what)

    def check(label, Ua, Ub, measure):
        t0 = time.time()
        got, plan = emu(Ua, Ub, measure)
        want = P.proximity_plain(Ua, Ub, measure)
        if Ua is Ub:
            got, want = _hygiene(got), _hygiene(want)
        err = (got - want).abs().max().item()
        require(bool(torch.isfinite(got).all()) and err <= TOL_DEG,
                f"{label} {measure}: max|emulated - plain| = {err:.2e} deg "
                f"({time.time() - t0:.1f} s) {plan or ''}")

    n = 80
    for p in (3, 9, 12, 16):
        U = signatures(40, n, p, p)
        for measure in ("eq3", "eq2"):
            check(f"square K=40 p={p}", U, U, measure)
    U16, V16 = signatures(37, n, 16, 1), signatures(5, n, 16, 2)
    for measure in ("eq3", "eq2"):
        check("cross 37x5 p=16", U16, V16, measure)
    U3, U12 = signatures(33, n, 3, 3), signatures(9, n, 12, 4)
    for label, Ua, Ub in (("cross 33x9 3x12", U3, U12), ("cross 9x33 12x3", U12, U3),
                          ("cross 20x9 1x12", signatures(20, n, 1, 11), U12),
                          ("cross 9x20 12x1", U12, signatures(20, n, 1, 12))):
        check(label, Ua, Ub, "eq2")
    # column views of a wider stack: 16-byte row quads at offset 4, element copies at 1
    W = signatures(35, n, 20, 5)
    for measure in ("eq3", "eq2"):
        check("column view p=16 of 20 (offset 4)", W[:, :, 4:], W[:, :, 4:], measure)
    check("column view p=9 cross", W[:, :, 1:10], W[:20, :, 11:20], "eq2")
    check("square K=20 n=200 p=12 (split over n)", *(2 * (signatures(20, 200, 12, 9),)), "eq2")
    # the tiles in batches give the same bits as one batch
    U = signatures(70, n, 12, 7)
    batched, plan = emu(U, U, "eq2", workspace_bytes=1 << 20)
    whole, _ = emu(U, U, "eq2")
    require(torch.equal(batched, whole), f"{len(plan.batches())} tile batches == one batch")
    # the square (upper-triangle tiles) == the full rectangle, both one split
    U = signatures(45, n, 16, 8)
    for measure in ("eq3", "eq2"):
        square, _ = emu(U, U, measure, sm_count=1)
        rect, _ = emu(U, U.clone(), measure, sm_count=1)
        require(torch.equal(square, rect), f"{measure} p=16 square == rectangle")
    print("FAILED: " + "; ".join(failures) if failures else "all checks passed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
