"""Device resolution shared by the port's entry points.

``device=None`` means ``"cuda"``.  A CUDA request without a usable card
raises; nothing in the port silently carries on on the CPU.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise if CUDA is asked for but unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def as_f32(x, device: torch.device) -> torch.Tensor:
    """``x`` (array-like or tensor) as a float32 tensor on ``device``."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@contextlib.contextmanager
def float32_math() -> Iterator[None]:
    """Float32 matmuls and convolutions, computed the same way on every run,
    as the reference computes them: TF32 off for cuBLAS and for cuDNN (whose
    default is on), and cuDNN held to deterministic algorithms, chosen by
    its heuristics rather than by timing (``cudnn.deterministic`` on,
    ``cudnn.benchmark`` off; by default cuDNN may take a weight-gradient
    algorithm that sums with atomics, so two runs of one seed drift apart).
    The previous settings are restored after the block.  Backward passes
    run inside the block too, so they read the same settings."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark = saved
