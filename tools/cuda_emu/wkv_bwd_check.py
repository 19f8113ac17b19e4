"""The WKV backward kernel (``src/repro_torch/csrc/wkv_bwd.cu``) on the CPU.

    python3 tools/cuda_emu/wkv_bwd_check.py

Builds the kernel source with g++ through the thread emulation of
``emu_runtime.h`` (a block's threads are OS threads, ``__syncthreads`` a
barrier, ``__shfl_xor_sync`` and the TF32 ``mma.sync`` warp-collective
exchanges, ``cp.async`` a copy) into
``build/cuda_emu/`` and runs it, called as ``wkv_bwd_cuda`` calls it, at
small sizes against the plain twin ``wkv_bwd_plain``: head dims 16, 32, 64
and 128, S = 1, 20, 40, 47, 129 and 300 (one chunk, ragged chunks), with
and without state0 and dstateT, the model's slow decays and fast ones with
a decay of exactly 0, float32 and bfloat16 r, k, v, each run twice and
required bitwise equal.  Both sides compute in float32 from the same
inputs: each gradient within TOL of its max |plain|.  It checks the chunk
plan, the index arithmetic and the reductions; it says nothing of speed or
of what nvcc accepts.  About a minute and a half.
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
TOL = 1e-5


class Emulated:
    """wkv_bwd.cu built for the CPU, called as the CUDA wrapper calls it."""

    def __init__(self, wkv_module):
        sys.path.insert(0, str(HERE))
        from transform import transform

        OUT.mkdir(parents=True, exist_ok=True)
        cpp = OUT / "wkv_bwd_emu.cpp"
        cpp.write_text(transform((ROOT / "src/repro_torch/csrc/wkv_bwd.cu").read_text()))
        lib = OUT / "libwkv_bwd_emu.so"
        subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-pthread",
                        "-fno-strict-aliasing", f"-I{HERE}", "-Wno-unknown-pragmas", "-o",
                        str(lib), str(cpp), str(HERE / "emu_runtime.cpp")], check=True)
        self.W = wkv_module
        self.lib = ctypes.CDLL(str(lib))
        self.lib.wkv_bwd.argtypes = wkv_module._BWD_ARGTYPES
        self.lib.wkv_bwd.restype = ctypes.c_int

    def __call__(self, r, k, v, w, u, dout, starts, dstateT):
        B, S, H, hd = r.shape
        plan = self.W.wkv_bwd_plan(S)

        def nan(*shape):   # an entry read before it is written shows
            return torch.full(shape, float("nan"), dtype=torch.float32)

        dr, dk, dv, dw = (nan(B, S, H, hd) for _ in range(4))
        du, dstate0 = nan(H, hd), nan(B, H, hd, hd)
        wsd = nan(B, H, plan.n_chunks, hd, hd)
        wd, du_part = nan(B, H, plan.n_chunks, hd), nan(B, H, plan.n_chunks, hd)
        wss = nan(B, H, plan.n_chunks, self.W.BWD_STATE_SLOTS, hd, hd)
        rc = self.lib.wkv_bwd(
            self.W._DTYPES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), dout.data_ptr(), starts.data_ptr(),
            None if dstateT is None else dstateT.data_ptr(), dr.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dw.data_ptr(), du.data_ptr(), dstate0.data_ptr(), wsd.data_ptr(),
            wd.data_ptr(), du_part.data_ptr(), wss.data_ptr(), B, S, H, hd, plan.chunk, None)
        if rc != 0:
            raise RuntimeError(f"launch refused: {rc} ({plan})")
        return dr, dk, dv, dw, du, dstate0


def chunk_starts(k, v, w, state0, chunk):
    """The state at the start of each chunk, stepped in float32 (what the
    forward's chunked route keeps)."""
    B, S, H, hd = k.shape
    s = torch.zeros((B, H, hd, hd)) if state0 is None else state0.clone()
    kept = []
    for t in range(S):
        if t % chunk == 0:
            kept.append(s)
        s = w[:, t, :, :, None] * s + k[:, t, :, :, None].float() * v[:, t, :, None, :].float()
    return torch.stack(kept, dim=2).contiguous()


def operands(B, S, H, hd, seed, regime, with_state, with_dT, dtype):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))

    r, k, v, dout = (t(rng.normal(size=(B, S, H, hd))) for _ in range(4))
    if regime == "fast":
        w = t(np.exp(-np.exp(rng.uniform(-6.0, 2.0, size=(B, S, H, hd)))))
        w[0, S // 2, 0, :3] = 0.0   # a decay of exactly 0
    else:
        w = t(np.exp(-np.exp(-6.0 + 0.5 * rng.normal(size=(B, S, H, hd)))))
    u = t(0.1 * rng.normal(size=(H, hd)))
    state0 = t(0.1 * rng.normal(size=(B, H, hd, hd))) if with_state else None
    dT = t(rng.normal(size=(B, H, hd, hd))) if with_dT else None
    r, k, v = (a.to(dtype) for a in (r, k, v))
    return r, k, v, w, u, dout, state0, dT


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    W = importlib.import_module("repro_torch.kernels.wkv.wkv")
    emu = Emulated(W)
    failures = []

    def require(ok, what):
        print(("ok   " if ok else "FAIL ") + what, flush=True)
        if not ok:
            failures.append(what)

    cases = [(1, 1, 2, 16, "fast", True, True), (2, 47, 2, 16, "slow", False, False),
             (1, 129, 2, 32, "fast", True, False), (1, 300, 1, 64, "slow", False, True),
             (1, 300, 1, 64, "fast", True, True), (2, 20, 1, 32, "fast", False, True),
             (1, 40, 1, 128, "fast", True, True)]
    for dtype in (torch.float32, torch.bfloat16):
        for B, S, H, hd, regime, with_state, with_dT in cases:
            t0 = time.time()
            r, k, v, w, u, dout, s0, dT = operands(B, S, H, hd, B + S + hd, regime, with_state,
                                                   with_dT, dtype)
            starts = chunk_starts(k, v, w, s0, W.wkv_bwd_plan(S).chunk)
            got = emu(r, k, v, w, u, dout, starts, dT)
            again = emu(r, k, v, w, u, dout, starts, dT)
            want = W.wkv_bwd_plain(r, k, v, w, u, dout, s0, dT)
            rel = [((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
                   for a, b in zip(got, want)]
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            finite = all(bool(torch.isfinite(a).all()) for a in got)
            require(finite and same and max(rel) <= TOL,
                    f"{str(dtype)[6:]} (B, S, H, hd) = {(B, S, H, hd)} {regime} decay, state0 "
                    f"{with_state}, dstateT {with_dT}: dr dk dv dw du dstate0 max|emulated - "
                    f"plain| / max|plain| {', '.join(f'{x:.1e}' for x in rel)}; twice bitwise "
                    f"{same} ({time.time() - t0:.1f} s)")
    print("FAILED: " + "; ".join(failures) if failures else "all checks passed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
