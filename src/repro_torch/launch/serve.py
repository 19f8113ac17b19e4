"""LM serving: batched prefill, then greedy decode, on one card or sharded.

Port of ``repro.launch.serve``, a generation-throughput smoke for the model
zoo (not the membership service).  It builds the model at full width (or
``--reduced``) with the port's own seeded initialization, prefills a random
prompt batch (with random vision embeddings or encoder frames where the
model takes them, as the reference draws them), decodes ``--tokens`` tokens
greedily against the KV caches or recurrent state, and prints tok/s:

    python -m repro_torch.launch.serve --arch tinyllama-1.1b
    python -m repro_torch.launch.serve --arch rwkv6-1.6b --batch 4 --prompt-len 1024 --tokens 32
    python -m repro_torch.launch.serve --arch gemma3-4b --batch 4 --prompt-len 2048 --tokens 32
    python -m repro_torch.launch.serve --arch whisper-medium --reduced --device cpu

On the card the model computes in bfloat16 with float32 accumulation, the
reference's TPU policy; on the CPU in float32.

``--mesh DATAxMODEL`` serves over ``data * model`` ranks, one process each
(``torchrun`` starts them): weights sharded over ``model`` by ``--scheme``'s
rules (:mod:`repro_torch.sharding`; tensor and expert parallel), each data
group serving its rows of the batch.  Rank 0 prints its tokens and times:

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch llama4-scout-17b-a16e --mesh 1x4 --batch 4 --prompt-len 1024 --tokens 32

The backend is NCCL with a card a rank (``cuda:LOCAL_RANK``), gloo on the
CPU; ranks that share one card take ``--backend gloo --device cuda:0``.
The default ``--mesh 1x1`` is the one-card path, with no process group.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs import ARCH_NAMES, ArchConfig, get_config
from repro_torch.models import lm
from repro_torch.sharding import SCHEMES

def default_dtype(device: torch.device) -> torch.dtype:
    """bfloat16 on the card (the reference's TPU policy), float32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def random_prompt(cfg: ArchConfig, batch: int, prompt_len: int, *, seed: int = 0,
                  device: DeviceLike = None) -> torch.Tensor:
    """(batch, prompt_len) token ids drawn uniformly from the vocabulary."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen, device=dev)


def model_inputs(cfg: ArchConfig, batch: int, *, dtype: torch.dtype, seed: int = 0,
                 device: DeviceLike = None) -> dict:
    """The extra prefill inputs the model takes, drawn as the reference's
    ``launch/serve.py`` draws them (0.02 x standard normal) from a seeded
    generator: ``vision_embeds`` (batch, vision_tokens, D) for the vision
    stub, ``encoder_frames`` (batch, encoder_seq, D) for the
    encoder-decoder; empty for the others."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    extra = {}
    if cfg.vision_tokens:
        extra["vision_embeds"] = (0.02 * torch.randn(
            (batch, cfg.vision_tokens, cfg.d_model), generator=gen, device=dev)).to(dtype)
    if cfg.is_enc_dec:
        extra["encoder_frames"] = (0.02 * torch.randn(
            (batch, cfg.encoder_seq, cfg.d_model), generator=gen, device=dev)).to(dtype)
    return extra


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def generate(params: lm.LM, prompt: torch.Tensor, n_tokens: int, *,
             vision_embeds: Optional[torch.Tensor] = None,
             encoder_frames: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, dict]:
    """Greedy generation: one prefill forward (over the prompt, with the
    model's extra inputs, :func:`model_inputs`), then ``n_tokens - 1``
    decode forwards.  Returns (tokens (B, n_tokens), host-clock seconds of
    the prefill and of the decode loop, each ending in a device sync)."""
    B, S = prompt.shape
    batch = {"tokens": prompt}
    if vision_embeds is not None:
        batch["vision_embeds"] = vision_embeds
    if encoder_frames is not None:
        batch["encoder_frames"] = encoder_frames
    prefill = lm.make_prefill_step(max_len=S + n_tokens)
    serve_step = lm.make_serve_step()
    device = prompt.device
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    tok = torch.argmax(logits, dim=-1)[:, None]
    _sync(device)
    t1 = time.perf_counter()
    out = [tok]
    for t in range(n_tokens - 1):
        logits, cache = serve_step(params, cache, tok, S + t)
        tok = torch.argmax(logits, dim=-1)[:, None]
        out.append(tok)
    _sync(device)
    t2 = time.perf_counter()
    return torch.cat(out, dim=1), {"prefill_s": t1 - t0, "decode_s": t2 - t1}


def _sharded(args, cfg: ArchConfig, data: int, model: int) -> dict:
    """The ``--mesh`` path on this rank: join the process group (unless the
    caller's process already has), build the rank's shard and serve its
    data group's rows."""
    import torch.distributed as dist

    from repro_torch import sharding
    from repro_torch.launch.mesh import init_ranks, make_mesh

    joined = not dist.is_initialized()
    if joined:
        cpu = args.device is not None and torch.device(args.device).type == "cpu"
        backend = args.backend or ("gloo" if cpu else "nccl")
        device = init_ranks(backend, device=args.device)
    else:
        device = resolve_device(args.device)
    try:
        mesh = make_mesh(data, model, device_type=device.type)
        dtype = default_dtype(device)
        plan = sharding.plan_for(cfg, args.scheme)
        params = sharding.init_params_sharded(cfg, plan, mesh, seed=0, dtype=dtype, device=device)
        batch = {"tokens": random_prompt(cfg, args.batch, args.prompt_len, seed=0, device=device),
                 **model_inputs(cfg, args.batch, dtype=dtype, seed=1, device=device)}
        local = sharding.local_batch(cfg, batch, mesh)
        toks, times = generate(params, local.pop("tokens"), args.tokens, **local)
        if device.type == "cuda":
            times["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        if dist.get_rank() == 0:
            total = times["prefill_s"] + times["decode_s"]
            print(f"arch={cfg.name} {dtype} mesh {data}x{model} ({args.scheme}, "
                  f"{dist.get_backend()}) on {device}: rank 0 generated {tuple(toks.shape)} in "
                  f"{total:.2f}s (prefill {times['prefill_s']:.3f}s, decode "
                  f"{times['decode_s']:.3f}s; {toks.numel() / total:.1f} tok/s a data group)")
            print("sample:", toks[0][:16].tolist())
        return {"tokens": toks.cpu(), **times}
    finally:
        if joined:
            dist.destroy_process_group()


def main(argv: Optional[list[str]] = None) -> dict:
    """Serve once; returns this rank's tokens (B, tokens) and times."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_NAMES, default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="default: cuda (with --mesh: cuda:LOCAL_RANK)")
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL ranks, one process each (default 1x1: one card)")
    ap.add_argument("--scheme", choices=SCHEMES, default="tp_only",
                    help="sharding rules (with --mesh)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="process-group backend (default nccl; gloo with --device cpu)")
    args = ap.parse_args(argv)

    from repro_torch.launch.mesh import parse_mesh

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    data, model = parse_mesh(args.mesh)
    if (data, model) != (1, 1):
        return _sharded(args, cfg, data, model)
    device = resolve_device(args.device)
    dtype = default_dtype(device)
    params = lm.init_params(cfg, seed=0, dtype=dtype, device=device)
    prompt = random_prompt(cfg, args.batch, args.prompt_len, seed=0, device=device)
    extra = model_inputs(cfg, args.batch, dtype=dtype, seed=1, device=device)
    toks, times = generate(params, prompt, args.tokens, **extra)
    total = times["prefill_s"] + times["decode_s"]
    print(f"arch={cfg.name} {dtype} on {device}: generated {tuple(toks.shape)} in "
          f"{total:.2f}s (prefill {times['prefill_s']:.3f}s, decode "
          f"{times['decode_s']:.3f}s; {args.batch * args.tokens / total:.1f} tok/s)")
    print("sample:", toks[0][:16].tolist())
    return {"tokens": toks.cpu(), **times}


if __name__ == "__main__":
    main()
