"""Rank function of tests/test_torch_step_costs.py.

It runs inside one rank process of ``repro_torch.launch.mesh.run_ranks``
(gloo on the CPU) and imports torch and the port only, never jax.
"""
import dataclasses
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch import sharding
from repro_torch.configs import get_config
from repro_torch.launch.mesh import axis_coords, make_mesh
from repro_torch.launch.step_costs import count_collectives
from repro_torch.launch.train import synthetic_batch
from repro_torch.models import lm
from repro_torch.optim import adamw, cosine_schedule


def _run(mesh, arch: str, scheme: str, kind: str, batch: int, seq: int, changes=()) -> list:
    """The collectives of one step of ``kind`` (``train``: ``make_train_step``
    with the dry run's AdamW; ``prefill``: ``make_prefill_step``) of
    ``arch`` at ``reduced()`` size (with ``changes``, (field, value) pairs,
    to its configuration) on this rank, float32 on the CPU, as
    :class:`repro_torch.launch.step_costs.CountingAxis` records them while
    they run."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **dict(changes))
    plan = sharding.plan_for(cfg, scheme)
    train = kind == "train"
    params = sharding.init_params_sharded(cfg, plan, mesh, seed=1, dtype=torch.float32,
                                          device="cpu")
    log: list = []
    count_collectives(params, log)
    data = synthetic_batch(cfg, batch, seq, torch.Generator().manual_seed(2))
    local = sharding.local_batch(cfg, data, mesh)
    if train:
        opt = adamw(cosine_schedule(3e-4, warmup=10, total=20))
        lm.make_train_step(opt)(params, opt.init(dict(params.named_parameters())), local)
    else:
        with torch.inference_mode():
            lm.make_prefill_step(max_len=seq)(params, local)
    return log


def collectives_rank(store: str, quad: list, pair: list) -> dict:
    """This rank's collectives of each ``quad`` case (label, arch, scheme,
    kind, batch, seq[, changes]) on a 2x2 mesh, then of each ``pair`` case on 1x2 (the
    first two ranks), with the rank's coordinates on each mesh."""
    torch.set_num_threads(1)
    mesh = make_mesh(2, 2, device_type="cpu")
    res = {"quad_coords": {a: i for a, (i, _) in axis_coords(mesh).items()}}
    for label, *case in quad:
        res[label] = _run(mesh, *case)
    rank = dist.get_rank()
    dist.destroy_process_group()
    if rank >= 2:
        return res
    dist.init_process_group("gloo", init_method=f"file://{Path(store) / 'store_1x2'}",
                            rank=rank, world_size=2)
    mesh = make_mesh(1, 2, device_type="cpu")
    res["pair_coords"] = {a: i for a, (i, _) in axis_coords(mesh).items()}
    for label, *case in pair:
        res[label] = _run(mesh, *case)
    return res
