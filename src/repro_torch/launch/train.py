"""LM training launcher: ``python -m repro_torch.launch.train --arch <id> [--reduced]``.

Port of ``repro.launch.train``, with the same flags plus ``--device``
(default ``cuda``): AdamW under ``cosine_schedule(lr, warmup=10,
total=steps)``, a fresh synthetic batch each step, the loss printed every 5
steps and at the last.

    python -m repro_torch.launch.train --arch tinyllama-1.1b --steps 10 --batch 4 --seq 2048
    python -m repro_torch.launch.train --reduced --device cpu

On the card the model keeps float32 masters and computes in bfloat16 (the
reference's TPU policy), through the flash-attention and WKV kernels
forward and backward; on the CPU it computes in float32 through their plain
twins.  Every family trains on both:

    python -m repro_torch.launch.train --arch rwkv6-1.6b --steps 10 --batch 4 --seq 2048

``--mesh DATAxMODEL`` trains over ``data * model`` ranks, one process each
(``torchrun`` or ``launch.mesh.run_ranks`` starts them): weights sharded by
``--scheme``'s rules (:mod:`repro_torch.sharding`: ``fsdp_tp`` tensor and
expert parallel over ``model`` and FSDP over ``data``, ``tp_only`` without
FSDP, ``ddp`` every weight replicated), each data group training on its
rows of every step's batch (the same draws as ``--mesh 1x1``), the loss and
gradients averaged over the data groups.  Rank 0 prints the losses:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch granite-8b --mesh 2x2 --scheme fsdp_tp --steps 10 --batch 4 --seq 2048

The backend is NCCL with a card a rank (``cuda:LOCAL_RANK``), gloo on the
CPU; nothing switches it when NCCL refuses.  The default ``--mesh 1x1`` is
the one-card path, with no process group.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.configs import ARCH_NAMES, ArchConfig, get_config
from repro_torch.launch.mesh import init_ranks, make_mesh, parse_mesh
from repro_torch.models import lm
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.sharding import SCHEMES


def synthetic_batch(cfg: ArchConfig, batch: int, seq: int, gen: torch.Generator,
                    dtype: torch.dtype = torch.float32) -> dict:
    """The reference's synthetic batch, drawn from ``gen`` on its device:
    uniform tokens (batch, seq) and, where the model takes them, 0.02 x
    standard normal vision embeddings or encoder frames."""
    dev = gen.device
    out = {"tokens": torch.randint(0, cfg.vocab, (batch, seq), generator=gen, device=dev)}
    if cfg.vision_tokens:
        out["vision_embeds"] = (0.02 * torch.randn(
            (batch, cfg.vision_tokens, cfg.d_model), generator=gen, device=dev)).to(dtype)
    if cfg.is_enc_dec:
        out["encoder_frames"] = (0.02 * torch.randn(
            (batch, cfg.encoder_seq, cfg.d_model), generator=gen, device=dev)).to(dtype)
    return out


def _train(args, cfg: ArchConfig, device: torch.device, mesh=None) -> list[float]:
    """``args.steps`` steps on one card, or on this rank of ``mesh``."""
    from repro_torch import sharding

    compute = torch.bfloat16 if device.type == "cuda" else torch.float32
    init = dict(seed=0, dtype=torch.float32, compute_dtype=compute, device=device)
    if mesh is None:
        params = lm.init_params(cfg, **init)
    else:
        params = sharding.init_params_sharded(cfg, sharding.plan_for(cfg, args.scheme), mesh,
                                              **init)
    lead = mesh is None or torch.distributed.get_rank() == 0
    n_params = sum(p.numel() for p in params.parameters())
    where = "" if mesh is None else (f" a rank, mesh {args.mesh} ({args.scheme}, "
                                     f"{torch.distributed.get_backend()})")
    if lead:
        print(f"arch={cfg.name} params={n_params / 1e6:.2f}M{where} reduced={args.reduced} "
              f"compute={compute} on {device}")

    opt = adamw(cosine_schedule(args.lr, warmup=10, total=args.steps))
    opt_state = opt.init(dict(params.named_parameters()))
    step = lm.make_train_step(opt, microbatches=args.microbatches)
    gen = torch.Generator(device=device).manual_seed(0)

    losses = []
    t0 = time.time()
    for i in range(args.steps):
        batch = synthetic_batch(cfg, args.batch, args.seq, gen, compute)
        if mesh is not None:   # every rank draws the whole batch and keeps its rows
            batch = sharding.local_batch(cfg, batch, mesh, microbatches=args.microbatches)
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if lead and (i % 5 == 0 or i == args.steps - 1):
            print(f"step {i:4d} loss {losses[-1]:.4f} ({time.time() - t0:.1f}s)")
    if lead:
        print("done")
    return losses


def main(argv: Optional[list[str]] = None) -> list[float]:
    """Run the launcher; returns each step's loss (the global batch's)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_NAMES, default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="default: cuda (with --mesh: cuda:LOCAL_RANK)")
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL ranks, one process each (default 1x1: one card)")
    ap.add_argument("--scheme", choices=SCHEMES, default="fsdp_tp",
                    help="sharding rules (with --mesh)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="process-group backend (default nccl; gloo with --device cpu)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    data, model = parse_mesh(args.mesh)
    if (data, model) == (1, 1):
        return _train(args, cfg, resolve_device(args.device))
    joined = not dist.is_initialized()
    if joined:
        cpu = args.device is not None and torch.device(args.device).type == "cpu"
        device = init_ranks(args.backend or ("gloo" if cpu else "nccl"), device=args.device)
    else:
        device = resolve_device(args.device)
    try:
        return _train(args, cfg, device, make_mesh(data, model, device_type=device.type))
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
