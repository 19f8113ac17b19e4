"""Build, load and count the port's CUDA kernels.

Each kernel is one CUDA C++ source in ``repro_torch/csrc/`` with a plain C
interface.  On first use it is compiled by ``nvcc`` for ``sm_90a`` into a
shared library under ``<repo>/build/kernels/`` and loaded with ``ctypes``;
the library name carries a hash of the source and flags, so an edited
source never reuses a stale build.  :func:`build_all` starts one ``nvcc``
per source at once, so the builds run in parallel.

``LAUNCHES`` counts kernel launches by name; each wrapper adds one where it
launches its kernel and nowhere else.  ``BUILD_SECONDS`` holds each
source's ``nvcc`` wall time from the last build in this process.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# Every kernel source in csrc/, by name.
KERNELS = ("proximity", "tsgemm", "flash_attention", "wkv")

LAUNCHES: collections.Counter = collections.Counter()
BUILD_SECONDS: dict[str, float] = {}

H100_SMS = 132  # the default SM count of the kernels' grid plans

_LOADED: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    LAUNCHES.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` lands (content-addressed)."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str) -> tuple[str, Path, Path, subprocess.Popen, float] | None:
    lib = library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return name, lib, tmp, proc, t0


def _finish(started: tuple[str, Path, Path, subprocess.Popen, float]) -> str | None:
    name, lib, tmp, proc, t0 = started
    out, _ = proc.communicate()
    BUILD_SECONDS[name] = time.perf_counter() - t0
    if proc.returncode != 0:
        return f"{lib.name}: nvcc exit {proc.returncode}\n{out}"
    os.replace(tmp, lib)
    return None


def build_all(names: Iterable[str]) -> None:
    """Compile every named source that has no current build, in parallel."""
    started = [s for s in (_start(n) for n in names) if s is not None]
    with ThreadPoolExecutor(max_workers=max(1, len(started))) as pool:
        failures = [f for f in pool.map(_finish, started) if f is not None]
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (for grid plans)."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count
