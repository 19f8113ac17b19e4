"""Rank function of tests/test_torch_sharded_ckpt.py.

It runs inside one rank process of ``repro_torch.launch.mesh.run_ranks``
(gloo on the CPU) and imports torch and the port only, never jax: the
reference writes and reads its files in the test process.
"""
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch import ckpt, sharding
from repro_torch.launch.mesh import axis_coords, make_mesh, rank_coords
from repro_torch.launch.train import synthetic_batch
from repro_torch.models import lm
from repro_torch.optim import adamw, cosine_schedule

from _torch_tp_ranks import config

BATCH, SEQ = 4, 20
BF16_ARCH = "granite-8b"


def _optimizer():
    """The LM tests' AdamW (``adamw_cosine``)."""
    return adamw(cosine_schedule(5e-5, warmup=10, total=100), weight_decay=0.1)


def _pieces(model, state) -> dict:
    """Copies of a rank's parameters and optimizer state."""
    return {"params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "m": {n: t.clone() for n, t in state["m"].items()},
            "v": {n: t.clone() for n, t in state["v"].items()},
            "step": state["step"].clone()}


def _differ(a: dict, b: dict) -> list:
    """The fields of two :func:`_pieces` that are not bit-equal."""
    out = [] if torch.equal(a["step"], b["step"]) else ["step"]
    for what in ("params", "m", "v"):
        out += [f"{what} {n}" for n, t in a[what].items()
                if b[what][n].dtype != t.dtype or not torch.equal(b[what][n], t)]
    return out


def _resume(mesh, label: str, arch: str, experts, scheme: str, path: Path,
            device="cpu") -> dict:
    """Two steps of ``make_train_step`` uninterrupted, against one step,
    ``ckpt.save_sharded``, ``ckpt.restore_sharded`` into a fresh model and
    state, and the second step, on ``device``: both runs' losses and what
    differs between their states after it, and the state the file holds
    (the first step's pieces)."""
    cfg = config(arch, experts)
    plan = sharding.plan_for(cfg, scheme)
    params = sharding.init_params_sharded(cfg, plan, mesh, seed=3, dtype=torch.float32,
                                          device=device)
    batch = {k: v.to(device) for k, v in sharding.local_batch(cfg, synthetic_batch(
        cfg, BATCH, SEQ, torch.Generator().manual_seed(4)), mesh).items()}
    opt = _optimizer()
    step = lm.make_train_step(opt)
    state = opt.init(dict(params.named_parameters()))
    params, state, first = step(params, state, batch)
    ckpt.save_sharded(path, params, state, plan, mesh, step=1, config={"arch": arch})
    saved = _pieces(params, state)
    params, state, second = step(params, state, batch)
    straight = _pieces(params, state)
    del params, state
    params, state, meta = ckpt.restore_sharded(path, cfg, plan, mesh, device=device)
    restored = _pieces(params, state)
    params, state, again = step(params, state, batch)
    return {"label": label, "losses": [float(first["loss"]), float(second["loss"]),
                                       float(again["loss"])],
            "restored_differ": _differ(saved, restored),
            "resumed_differ": _differ(straight, _pieces(params, state)),
            "meta_step": meta["step"], "saved": saved}


def ckpt_rank(ref_paths: dict, out: str, store: str, quad: list, pair: list,
              reshard_from: str) -> dict:
    """This rank's part of the test, in one process group of four ranks
    (2x2), then of the first two (1x2) while the others leave:

    * on 2x2 ``fsdp_tp``: each reference checkpoint of ``ref_paths``
      ({arch: path}) restored (its pieces returned) and saved again as
      ``out/port_ARCH``; the last one's model saved with zero moments held
      as broadcast views, as ``out/zero_views``; a BF16_ARCH model stored
      in bfloat16 saved as ``out/bf16`` and restored (what differs);
    * :func:`_resume` of each ``quad`` case (label, arch, experts, scheme)
      on 2x2, then of each ``pair`` case on 1x2, each file at
      ``out/LABEL``;
    * on 1x2 ``tp_only``: the file ``out/reshard_from`` restored (its
      pieces returned).
    """
    torch.set_num_threads(1)
    out = Path(out)
    mesh = make_mesh(2, 2, device_type="cpu")
    res = {"coords": axis_coords(mesh), "rank_coords": rank_coords(mesh)}
    for arch, path in ref_paths.items():
        cfg = config(arch)
        plan = sharding.plan_for(cfg, "fsdp_tp")
        model, state, meta = ckpt.restore_sharded(path, cfg, plan, mesh, device="cpu")
        res[("reference", arch)] = _pieces(model, state)
        ckpt.save_sharded(out / f"port_{arch}", model, state, plan, mesh, step=meta["step"],
                          config=meta["config"])
    # zero moments held as broadcast views of one element, as a first step's
    # state may hold them
    zero = torch.zeros(())
    zeros = {n: zero.expand(p.shape) for n, p in model.named_parameters()}
    ckpt.save_sharded(out / "zero_views", model, {"step": state["step"], "m": zeros, "v": zeros},
                      plan, mesh, step=0)
    # a model stored in bfloat16: |V2 records both ways
    cfg = config(BF16_ARCH)
    plan = sharding.plan_for(cfg, "fsdp_tp")
    model = sharding.init_params_sharded(cfg, plan, mesh, seed=5, dtype=torch.bfloat16,
                                         device="cpu")
    state = _optimizer().init(dict(model.named_parameters()))
    ckpt.save_sharded(out / "bf16", model, state, plan, mesh, step=0)
    saved = _pieces(model, state)
    model, state, _ = ckpt.restore_sharded(out / "bf16", cfg, plan, mesh, device="cpu")
    res["bf16_differ"] = _differ(saved, _pieces(model, state))
    for label, arch, experts, scheme in quad:
        res[label] = _resume(mesh, label, arch, experts, scheme, out / label)
    rank = dist.get_rank()
    dist.destroy_process_group()
    if rank >= 2:
        return res
    dist.init_process_group("gloo", init_method=f"file://{Path(store) / 'store_1x2'}",
                            rank=rank, world_size=2)
    mesh = make_mesh(1, 2, device_type="cpu")
    res["pair_coords"] = axis_coords(mesh)
    for label, arch, experts, scheme in pair:
        res[label] = _resume(mesh, label, arch, experts, scheme, out / label)
    arch = next(a for label, a, _, _ in quad if label == reshard_from)
    cfg = config(arch)
    model, state, _ = ckpt.restore_sharded(out / reshard_from, cfg,
                                           sharding.plan_for(cfg, "tp_only"), mesh,
                                           device="cpu")
    res["resharded"] = _pieces(model, state)
    return res


def card_ckpt_case(label: str, arch: str, experts, scheme: str, path: str) -> dict:
    """:func:`_resume` on a 2x2 mesh over NCCL, a card a rank (the
    checkpoint's gathers on the card, one copy to the writer's host; the
    restore onto the card), without the saved pieces."""
    mesh = make_mesh(2, 2, device_type="cuda")
    res = _resume(mesh, label, arch, experts, scheme, Path(path),
                  torch.device("cuda", torch.cuda.current_device()))
    del res["saved"]
    return res
