"""The hand-written kernels on ``meta`` tensors: a launch counted, not run.

A dry run (:mod:`repro_torch.launch.step_costs`) runs a step on ``meta``
tensors, which hold shapes and dtypes and no data.  There each kernel
wrapper takes its meta branch: it allocates the kernel's outputs and
scratch on ``meta`` (their shapes and dtypes, so a count of live bytes sees
them) and reports one launch, with the FLOPs and bytes of the cost formula
kept beside the kernel, to the recorder that :func:`recording` installs.
No kernel runs, no plain twin runs (it would hold an (S, S) score tensor
that the kernel never holds), and nothing is added to
``_build.LAUNCHES``, which counts launches on the card.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator

# a dry run's callback: (kernel name, flops, bytes) of one launch
Recorder = Callable[[str, float, float], None]
_RECORDERS: list[Recorder] = []   # the recorders installed, innermost last


def record(name: str, flops: float, nbytes: float) -> None:
    """Report one launch of kernel ``name`` on ``meta`` tensors to the
    innermost recorder (none outside :func:`recording`)."""
    if _RECORDERS:
        _RECORDERS[-1](name, float(flops), float(nbytes))


@contextlib.contextmanager
def recording(recorder: Recorder) -> Iterator[None]:
    """Within the block, every meta launch goes to ``recorder``."""
    _RECORDERS.append(recorder)
    try:
        yield
    finally:
        _RECORDERS.remove(recorder)
