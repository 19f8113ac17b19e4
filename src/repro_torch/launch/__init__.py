"""Entry points of the port (``python -m repro_torch.launch.<name>``).

``train``, ``serve``, ``fl_train`` and ``assign_serve`` port the reference's
launchers (``train --mesh DATAxMODEL`` trains and ``serve --mesh`` serves
sharded, one process a rank); ``dryrun`` its dry run: each rank's bytes from
the ported plan and, where the port executes the plan, one rank's step run
on ``meta`` tensors and counted (``step_costs``) with the reference's
three-term roofline over an H100's data-sheet figures (``roofline``, which
also holds the analytic model FLOPs); ``mesh`` its device mesh, over
``torch.distributed`` (with ``run_ranks``, one fresh process a rank);
``kernel_times`` reads each CUDA kernel's device time from torch.profiler
with every launch accounted for.  The reference's sharding rules are ported
in :mod:`repro_torch.sharding`.

``repro.launch.hlo_analysis`` parses XLA's compiled HLO text for
trip-count-aware costs.  Its numbers are ported, not its parser:
``step_costs`` counts the FLOPs (the products by FlopCounterMode's formulas,
elementwise ops and reductions as ``hlo_analysis`` counts them, each
kernel's launch by its cost formula), the unfused bytes (its ``bytes``),
the collectives by kind with their group sizes, remat's recomputation, and
``top_ops`` / ``top_bytes`` by where the op runs, from the step the port
executes.  Not ported: the text parser and its trip counts (the port runs
its loops, so each iteration is counted as it runs), and ``bytes_major``,
the fusion-boundary bytes of a compiled module (the port runs eagerly, one
kernel an op, so the unfused count is its own).
"""
