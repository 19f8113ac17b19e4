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
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import ARCH_NAMES, ArchConfig, get_config
from repro_torch.models import lm
from repro_torch.optim import adamw, cosine_schedule


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


def main(argv: Optional[list[str]] = None) -> list[float]:
    """Run the launcher; returns each step's loss."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_NAMES, default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    compute = torch.bfloat16 if device.type == "cuda" else torch.float32
    params = lm.init_params(cfg, seed=0, dtype=torch.float32, compute_dtype=compute,
                            device=device)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"arch={cfg.name} params={n_params / 1e6:.2f}M reduced={args.reduced} "
          f"compute={compute} on {device}")

    opt = adamw(cosine_schedule(args.lr, warmup=10, total=args.steps))
    opt_state = opt.init(dict(params.named_parameters()))
    step = lm.make_train_step(opt, microbatches=args.microbatches)
    gen = torch.Generator(device=device).manual_seed(0)

    losses = []
    t0 = time.time()
    for i in range(args.steps):
        batch = synthetic_batch(cfg, args.batch, args.seq, gen, compute)
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss {losses[-1]:.4f} ({time.time() - t0:.1f}s)")
    print("done")
    return losses


if __name__ == "__main__":
    main()
