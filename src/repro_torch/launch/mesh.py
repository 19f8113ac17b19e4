"""Device meshes over ``torch.distributed``: one process per rank.

Port of ``repro.launch.mesh``.  The reference builds the TPU pod's GSPMD
mesh, ("data", "model") or, across pods, ("pod", "data", "model");
:func:`make_mesh` builds a ``torch.distributed`` ``DeviceMesh`` with the
same axis names over the ranks of an initialized process group, of any
shape whose size is the world size.  The reference's TPU v5e constants are
not carried; the port's H100 peaks are in :mod:`repro_torch.launch.roofline`.

The process group's backend is the caller's choice (:func:`init_ranks`):
``nccl`` with one card a rank, ``gloo`` on the CPU or where ranks share a
card (gloo reduces CUDA tensors through the host).  Nothing switches it:
NCCL refuses two ranks on one card, and that error stands.  Under
``torchrun`` each rank uses ``cuda:LOCAL_RANK``.

:func:`run_ranks` runs a function in fresh processes, one per rank, in a
process group over a ``file://`` store (no port to collide on), and
returns each rank's result: the tests' and ``chip_smoke.py``'s launcher.
"""
from __future__ import annotations

import itertools
import os
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


def mesh_device_count(data: int, model: int, *, pod: int = 1) -> int:
    """Ranks (devices) of a ``pod x data x model`` mesh."""
    return pod * data * model


def init_ranks(backend: str, *, init_method: str = "env://", rank: Optional[int] = None,
               world_size: Optional[int] = None,
               device: Optional[torch.device] = None) -> torch.device:
    """Join the default process group with ``backend`` and return this
    rank's device.  ``rank`` and ``world_size`` default to ``RANK`` and
    ``WORLD_SIZE`` (set by ``torchrun``).  The device is ``device`` if given
    (``cuda`` with no index: ``cuda:LOCAL_RANK``), else ``cuda:LOCAL_RANK``
    with ``backend="nccl"`` and the CPU with ``gloo``; a CUDA device becomes
    the process's current one."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: the port runs over nccl or gloo")
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    if device is None:
        device = (torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
                  if backend == "nccl" else torch.device("cpu"))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA rank needs a card; torch.cuda.is_available() is False")
        if device.index is None:   # under torchrun, this rank's card
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return device


def make_mesh(data: int, model: int, *, pod: int = 1, device_type: str = "cuda"):
    """The ``DeviceMesh`` ("data", "model"), or ("pod", "data", "model")
    with ``pod > 1``, over the default process group, whose world size
    must be ``pod * data * model``; rank r sits at the row-major position
    r.  Each axis is a process group of its own
    (``mesh.get_group("model")``)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group (init_ranks)")
    shape = (pod, data, model) if pod > 1 else (data, model)
    if min(shape) < 1:
        raise ValueError(f"mesh {shape}: every axis needs at least one rank")
    size = mesh_device_count(data, model, pod=pod)
    if size != dist.get_world_size():
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh has {size} ranks, the "
                         f"process group {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=POD_AXES if pod > 1 else AXES)


def axis_coords(mesh) -> dict[str, tuple[int, int]]:
    """``{axis: (this rank's index along it, its size)}``."""
    return {name: (mesh.get_local_rank(name), mesh.size(mesh.mesh_dim_names.index(name)))
            for name in mesh.mesh_dim_names}


def rank_coords(mesh) -> list[dict[str, tuple[int, int]]]:
    """:func:`axis_coords` of every rank of ``mesh``, by rank (the mesh
    holds ranks 0 .. N - 1 of the default process group)."""
    grid = mesh.mesh
    out: list = [None] * grid.numel()
    for at in itertools.product(*map(range, grid.shape)):
        out[int(grid[at])] = {name: (i, n) for name, i, n in
                              zip(mesh.mesh_dim_names, at, grid.shape)}
    return out


def parse_mesh(text: str) -> tuple[int, int]:
    """``"DATAxMODEL"`` -> (data, model)."""
    parts = text.lower().split("x")
    if len(parts) != 2 or not all(p.isdigit() and int(p) > 0 for p in parts):
        raise ValueError(f"mesh {text!r}: expected DATAxMODEL, e.g. 1x4")
    return int(parts[0]), int(parts[1])


# ---------------------------------------------------------------------------
# One process per rank
# ---------------------------------------------------------------------------


def _rank_main(fn, rank: int, world_size: int, backend: str, init_method: str,
               device: Optional[str], out: str, args: tuple) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_RANK=str(torch.device(device).index or 0) if device else "0")
    try:
        init_ranks(backend, init_method=init_method, rank=rank, world_size=world_size,
                   device=device)
        result = {"ok": fn(*args)}
    except Exception:   # sent to the parent, which raises it
        result = {"error": traceback.format_exc()}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(result, out)


def run_ranks(fn: Callable[..., Any], world_size: int, *args, backend: str,
              devices: Optional[Sequence[str]] = None, timeout: float = 600.0,
              store_dir: Optional[str] = None) -> list:
    """``fn(*args)`` in ``world_size`` fresh processes (``spawn``), rank r
    in a process group with ``backend`` over a ``file://`` store in
    ``store_dir`` (a new temporary directory by default) and on
    ``devices[r]`` (default: the CPU).  Returns each rank's return value in
    rank order (tensors on the CPU travel best).  A rank that raises or
    dies, or a run that outlasts ``timeout`` seconds, raises here with every
    rank's error; the other ranks are stopped at once (they would wait in
    their next collective), and every process is stopped before this
    returns or raises."""
    if devices is not None and len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        init_method = f"file://{Path(tmp) / 'store'}"
        outs = [str(Path(tmp) / f"rank{r}.pt") for r in range(world_size)]
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            fn, r, world_size, backend, init_method,
            None if devices is None else str(devices[r]), outs[r], args))
            for r in range(world_size)]
        results: dict[int, dict] = {}
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.start()
            while len(results) < world_size and time.monotonic() < deadline:
                for r, p in enumerate(procs):
                    if r not in results and not p.is_alive():
                        results[r] = (torch.load(outs[r], weights_only=False)
                                      if os.path.exists(outs[r]) else
                                      {"error": f"exited with code {p.exitcode} and no result"})
                if any("error" in res for res in results.values()):
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        errors = [f"rank {r}: {res['error']}" for r, res in sorted(results.items())
                  if "error" in res]
        late = [r for r in range(world_size) if r not in results]
        if errors or late:
            if late:
                errors.append(f"ranks {late} of {world_size} stopped after "
                              f"{'an error' if errors else f'{timeout:.0f} s'}")
            raise RuntimeError("\n".join(errors))
        return [results[r]["ok"] for r in range(world_size)]
