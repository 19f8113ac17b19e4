"""Rank function of tests/test_torch_shared_kv_heads.py.

It runs inside one rank process of ``repro_torch.launch.mesh.run_ranks``
(gloo on the CPU) and imports torch and the port only, never jax: the
reference's results are computed in the test process and the ranks' are
compared with them there.
"""
import dataclasses
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch import ckpt, sharding
from repro_torch.configs import get_config
from repro_torch.convert import lm_shard_from_numpy, opt_state_shard_from_numpy
from repro_torch.launch.mesh import axis_coords, make_mesh
from repro_torch.models import lm
from repro_torch.optim import adamw, cosine_schedule

from _torch_tp_ranks import _greedy


def config(arch: str, heads: tuple):
    """``arch`` at ``reduced()`` size with ``heads`` (query heads, KV heads)."""
    n_heads, n_kv = heads
    return dataclasses.replace(get_config(arch).reduced(), n_heads=n_heads, n_kv_heads=n_kv)


def optimizer():
    """The LM tests' AdamW (``adamw_cosine``)."""
    return adamw(cosine_schedule(5e-5, warmup=10, total=100), weight_decay=0.1)


def _pieces(model, state=None) -> dict:
    out = {"params": {n: p.detach().clone() for n, p in model.named_parameters()}}
    if state is not None:
        out.update(m={n: t.clone() for n, t in state["m"].items()},
                   v={n: t.clone() for n, t in state["v"].items()}, step=state["step"].clone())
    return out


def _serve(mesh, case: tuple, n_decode: int) -> dict:
    """One serving case (label, arch, heads, scheme, reference numpy tree,
    prompt): the rank's shard of the reference's weights, its
    :func:`_greedy` record and its query and KV head counts."""
    _, arch, heads, scheme, tree, prompt = case
    cfg = config(arch, heads)
    params = lm_shard_from_numpy(cfg, tree, sharding.plan_for(cfg, scheme), mesh, device="cpu")
    out = _greedy(params, sharding.local_batch(cfg, {"tokens": torch.from_numpy(prompt).long()},
                                               mesh), n_decode)
    out["heads"] = lm.rank_heads(cfg, params.model_axis)
    out["cache_heads"] = lm.init_cache(params, 1, 4)[0][0]["sub0"]["kv"].k.shape[2]
    return out


def _train(mesh, case: tuple, ckpt_path=None) -> dict:
    """One training case (label, arch, heads, scheme, reference numpy tree,
    numpy batch, the reference optimizer's numpy init state): the rank's
    shard takes ``lm.value_and_grad`` over its rows, then one
    ``make_train_step`` of :func:`optimizer` from the reference's state cut
    by ``opt_state_shard_from_numpy``; with ``ckpt_path`` the state after
    the step is saved there (``ckpt.save_sharded``)."""
    _, arch, heads, scheme, tree, batch, state = case
    cfg = config(arch, heads)
    plan = sharding.plan_for(cfg, scheme)
    params = lm_shard_from_numpy(cfg, tree, plan, mesh, device="cpu")
    local = sharding.local_batch(cfg, {"tokens": torch.from_numpy(batch["tokens"]).long()},
                                 mesh)
    loss, grads = lm.value_and_grad(params, local)
    params, state, metrics = lm.make_train_step(optimizer())(
        params, opt_state_shard_from_numpy(cfg, state, plan, mesh, device="cpu"), local)
    if ckpt_path is not None:
        ckpt.save_sharded(ckpt_path, params, state, plan, mesh, step=1, config={"arch": arch})
    return {"loss": loss, "grads": grads, "step_loss": metrics["loss"], **_pieces(params, state)}


def _restore(path, arch: str, heads: tuple, data: int, model: int) -> dict:
    cfg = config(arch, heads)
    mesh = make_mesh(data, model, device_type="cpu")
    params, state, meta = ckpt.restore_sharded(path, cfg, sharding.plan_for(cfg, "tp_only"), mesh,
                                               device="cpu")
    return {"coords": axis_coords(mesh), "step": meta["step"], **_pieces(params, state)}


def _regroup(store: str, name: str, size: int) -> bool:
    """Leave the process group; the first ``size`` ranks join a new one over
    ``store/name`` (True on them)."""
    rank = dist.get_rank()
    dist.destroy_process_group()
    if rank >= size:
        return False
    dist.init_process_group("gloo", init_method=f"file://{Path(store) / name}", rank=rank,
                            world_size=size)
    return True


def shared_kv_rank(store: str, serve: list, train_1x4: tuple, train_2x2: tuple,
                   n_decode: int) -> dict:
    """This rank's part of the test, in one process group of four ranks,
    then of the first two, then of the first alone:

    * on 1x4: each ``serve`` case (result under ``("serve", label)``),
      then ``train_1x4`` (under ``("train", label)``), its state after the
      step saved as ``store/ckpt_1x4``;
    * on 2x2: ``train_2x2``;
    * ``store/ckpt_1x4`` restored at 1x2 (``tp_only``, ranks 0 and 1),
      then at 1x1 (rank 0).
    """
    torch.set_num_threads(1)
    path = Path(store) / "ckpt_1x4"
    mesh = make_mesh(1, 4, device_type="cpu")
    res = {"coords": axis_coords(mesh)}
    for case in serve:
        res[("serve", case[0])] = _serve(mesh, case, n_decode)
    res[("train", train_1x4[0])] = _train(mesh, train_1x4, path)
    mesh = make_mesh(2, 2, device_type="cpu")
    res["coords_2x2"] = axis_coords(mesh)
    res[("train", train_2x2[0])] = _train(mesh, train_2x2)
    _, arch, heads = train_1x4[:3]
    if _regroup(store, "store_1x2", 2):
        res["restored_1x2"] = _restore(path, arch, heads, 1, 2)
        if _regroup(store, "store_1x1", 1):
            res["restored_1x1"] = _restore(path, arch, heads, 1, 1)
    return res
