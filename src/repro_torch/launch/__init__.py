"""Entry points of the port (``python -m repro_torch.launch.<name>``).

``train``, ``serve``, ``fl_train`` and ``assign_serve`` port the reference's
launchers; ``roofline`` its analytic model FLOPs, over an H100's peaks;
``kernel_times`` reads each CUDA kernel's device time from torch.profiler
with every launch accounted for.

Not applicable on one H100, and not ported (no stubs):

- ``repro.launch.hlo_analysis``: trip-count-aware costs parsed from XLA's
  compiled HLO text.  The port runs eagerly and compiles no XLA module;
  its costs on the card are measured (``torch.profiler``, CUDA events).
- ``repro.launch.dryrun``: lowers every step on a 512-device fake mesh to
  read XLA's memory and cost analyses without running.  On one card the
  question it answers, whether a model's step fits, is answered by running
  it: ``chip_smoke.py`` phase 10 prints the peak ``max_memory_allocated``.
- ``repro.launch.mesh.make_production_mesh`` and ``repro.sharding``: the
  TPU pod's device mesh and GSPMD partition specs.  One card has no mesh;
  a multi-card port would shard with ``torch.distributed`` instead.
"""
