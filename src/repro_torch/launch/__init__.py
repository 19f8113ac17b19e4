"""Entry points of the port (``python -m repro_torch.launch.<name>``).

``train``, ``serve``, ``fl_train`` and ``assign_serve`` port the reference's
launchers (``train --mesh DATAxMODEL`` trains and ``serve --mesh`` serves
sharded, one process a rank); ``dryrun`` its dry run, as each rank's bytes
from the ported plan on ``meta`` tensors (no compile, no activations);
``roofline`` its analytic model FLOPs, over an H100's peaks; ``mesh`` its
device mesh, over ``torch.distributed`` (with ``run_ranks``, one fresh
process a rank); ``kernel_times`` reads each CUDA kernel's device time from
torch.profiler with every launch accounted for.  The reference's sharding
rules are ported in :mod:`repro_torch.sharding`.

Not ported (no stubs): ``repro.launch.hlo_analysis``, trip-count-aware
costs parsed from XLA's compiled HLO text.  Not applicable: the port runs
eagerly and compiles no XLA module; its costs on the card are measured
(``torch.profiler``, CUDA events).
"""
