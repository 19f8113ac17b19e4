"""Device time and launch count of each CUDA kernel that a callable runs.

Read from ``torch.profiler`` (CUPTI).  On the H100 machines the port is
measured on, a profiler session can come back without the device records
of its first launches while their launch API records are there, and the
longer the process has run, the more launches a session loses.  So a
session opens with ``PAD`` empty kernels (``torch.cuda._sleep(0)``) that
take those losses, and every launch made after them must have its device
record, matched by CUPTI's correlation id: a session that lost one is
repeated with twice the padding, and the ``ATTEMPTS``-th failure raises.
A launch is an API record whose name matches ``_LAUNCH``
(``cudaLaunchKernel``, ``cuLaunchKernelEx``, ...); copies and fills are
timed but not checked.
"""
from __future__ import annotations

import collections
import dataclasses
import re

import torch

_LAUNCH = re.compile(r"Launch\w*Kernel")
_PAD_KERNEL = "spin_kernel"     # what torch.cuda._sleep launches
PAD = 1024                      # padding kernels a first session opens with
ATTEMPTS = 3


@dataclasses.dataclass(frozen=True)
class KernelTimes:
    """``ms``: device milliseconds per call of ``fn`` by kernel name (names
    that shorten alike add up); ``launches``: each kernel's launches over
    all ``iters`` calls; ``pad_lost``: how many of the padding kernels the
    session lost (the losses it absorbed)."""

    ms: dict
    launches: dict
    pad_lost: int


def short_name(key: str) -> str:
    """A kernel's profiler name without ``void``, anonymous namespaces and
    arguments: ``wkv_bwd_grad_tc<64, __nv_bfloat16>``."""
    return key.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")


def split_session(events, pad: int, iters: int) -> KernelTimes | None:
    """The session's device records after its ``pad`` padding launches, by
    kernel, or None if any launch after the padding lacks its device record
    or the padding's records are not the first ``pad`` launches.  ``events``
    are ``(name, correlation_id, on_device, duration_ns)`` tuples."""
    launch_ids = sorted(cid for name, cid, dev, _ in events if not dev and _LAUNCH.search(name))
    pad_ids = set(launch_ids[:pad])
    device = [(name, cid, ns) for name, cid, dev, ns in events if dev]
    recorded = {cid for _, cid, _ in device}
    if len(pad_ids) < pad or any(cid not in recorded for cid in launch_ids[pad:]):
        return None
    if any((cid in pad_ids) != (_PAD_KERNEL in name) for name, cid, _ in device):
        return None
    ms: dict = collections.defaultdict(float)
    launches: dict = collections.Counter()
    for name, cid, ns in device:
        if cid not in pad_ids:
            ms[short_name(name)] += ns / iters / 1e6
            launches[short_name(name)] += 1
    pad_lost = pad - sum(cid in pad_ids for _, cid, _ in device)
    return KernelTimes(dict(ms), dict(launches), pad_lost)


def kernel_times(fn, *, iters: int = 10) -> KernelTimes:
    """Each CUDA kernel's device time per call of ``fn()`` and its launches
    over ``iters`` calls, after one warm-up call; raises if no session of
    ``ATTEMPTS`` (the padding doubled each time) recorded every launch."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    pad = PAD
    for _ in range(ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(pad):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [(e.name(), e.correlation_id(), e.device_type() == cuda, e.duration_ns())
                  for e in prof.profiler.kineto_results.events()]
        times = split_session(events, pad, iters)
        if times is not None:
            return times
        pad *= 2
    raise RuntimeError(f"torch.profiler lost device records of launches after {pad // 2} "
                       f"padding kernels in each of {ATTEMPTS} sessions")
