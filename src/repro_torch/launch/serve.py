"""LM serving on one card: batched prefill, then greedy decode.

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
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs import ARCH_NAMES, ArchConfig, get_config
from repro_torch.models import lm

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


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_NAMES, default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
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


if __name__ == "__main__":
    main()
