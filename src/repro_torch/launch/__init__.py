"""Entry points of the port (``python -m repro_torch.launch.<name>``).

``train``, ``serve``, ``fl_train`` and ``assign_serve`` port the reference's
launchers (``serve --mesh DATAxMODEL`` serves sharded, one process a rank);
``roofline`` its analytic model FLOPs, over an H100's peaks; ``mesh`` its
device mesh, over ``torch.distributed`` (with ``run_ranks``, one fresh
process a rank); ``kernel_times`` reads each CUDA kernel's device time from
torch.profiler with every launch accounted for.  The reference's sharding
rules are ported in :mod:`repro_torch.sharding`.

Not ported (no stubs):

- ``repro.launch.dryrun``: lowers every step on a 512-device fake mesh to
  read XLA's memory and cost analyses without running.  Its counterpart is
  queued: each rank's bytes from the ported plan on ``meta`` tensors.
  Until then, whether a model's step fits is answered by running it
  (``chip_smoke.py`` prints the peak ``max_memory_allocated``).
- ``repro.launch.hlo_analysis``: trip-count-aware costs parsed from XLA's
  compiled HLO text.  Not applicable: the port runs eagerly and compiles no
  XLA module; its costs on the card are measured (``torch.profiler``, CUDA
  events).
"""
