"""Analytic model FLOPs of a step, and the three-term roofline on H100 figures.

Ports ``repro.launch.roofline``.  :func:`model_flops` is the reference's
arithmetic over the port's ``ArchConfig`` and ``INPUT_SHAPES`` (6 N tokens
to train, 2 N tokens to prefill, 2 N a sequence to decode, N =
``cfg.active_param_count()``, plus the causal attention terms of attention
models), mirrored as it is: for rwkv6 its ``param_count`` counts the
channel mix as 3 D d_ff where the block holds 2 D d_ff + D^2, so rwkv6's
figures read high; for zamba2 it adds a gated MLP (3 D d_ff) to every
Mamba2 layer, which holds none: 19.20 B against the 6.75 B parameters the
model holds, so zamba2's figures read about 2.8x high.

:func:`build_report` is the reference's :class:`RooflineReport` of one
rank's step: compute = FLOPs / peak, memory = bytes / HBM rate, collective
= ring-effective collective bytes (:data:`RING`, the reference's ``_RING``)
/ link rate, the dominant term, model FLOPs over counted FLOPs
(``useful_ratio``) and whether the step's peak bytes fit the card.  The
reference reads its FLOPs and bytes from XLA's compiled HLO
(``hlo_flops``, ``hlo_bytes``); the port counts them from the step it
executes (``step_flops``, ``step_bytes``: :mod:`repro_torch.launch.step_costs`).

The figures are NVIDIA's H100 SXM data sheet's, not the reference's TPU
v5e constants: 989 TFLOP/s dense bfloat16 on the tensor cores, 3.35 TB/s
HBM3, 80 GB; NVLink 4 at 450 GB/s a direction for a group inside one
8-card node (HGX H100), and a 400 Gb/s NDR InfiniBand adapter a card (50
GB/s) for a group that spans nodes.  Ranks map to nodes row-major over
(pod, data, model), ``model`` innermost, :data:`RANKS_PER_NODE` consecutive
ranks a node.  A rate is the data sheet's at 700 W; no card measured it.
"""
from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import Mapping

from repro_torch.configs.base import ArchConfig, InputShape

PEAK_FLOPS_BF16 = 989e12   # FLOP/s, dense bfloat16 on the tensor cores
HBM_BW = 3.35e12           # bytes/s
HBM_BYTES = 80e9           # bytes of one card
NVLINK_BW = 450e9          # bytes/s a direction: NVLink 4, a group inside one node
IB_BW = 50e9               # bytes/s a card: 400 Gb/s NDR InfiniBand, a group across nodes
RANKS_PER_NODE = 8

# bytes each rank sends of a ring collective over a group of g, per byte of
# the collective (the reference's _RING)
RING = {
    "all-reduce": lambda g: 2.0 * (g - 1) / g,
    "all-gather": lambda g: (g - 1) / g,
    "reduce-scatter": lambda g: (g - 1) / g,
    "all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
    "collective-broadcast": lambda g: 1.0,
}


def model_flops(cfg: ArchConfig, shape: InputShape) -> float:
    """Analytic useful FLOPs of one step at ``shape`` (global, all chips)."""
    n_active = cfg.active_param_count()
    hd = cfg.resolved_head_dim
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = B * S
        flops = 6.0 * n_active * tokens
        # quadratic attention term (forward and backward: 3x 4 S^2 H hd a layer)
        if cfg.block_kind == "attn":
            att = 4.0 * S * S * cfg.n_heads * hd * B * cfg.n_layers
            flops += 3.0 * att / 2.0  # causal halves the useful pairs
        return flops
    if shape.kind == "prefill":
        tokens = B * S
        flops = 2.0 * n_active * tokens
        if cfg.block_kind == "attn":
            flops += 4.0 * S * S * cfg.n_heads * hd * B * cfg.n_layers / 2.0
        return flops
    # decode: one token per sequence
    flops = 2.0 * n_active * B
    if cfg.block_kind == "attn":
        flops += 4.0 * S * cfg.n_heads * hd * B * cfg.n_layers
    return flops


def model_flop_utilisation(cfg: ArchConfig, shape: InputShape, seconds: float) -> float:
    """:func:`model_flops` of one step done in ``seconds`` on one H100, as a
    share of its bfloat16 peak."""
    return model_flops(cfg, shape) / seconds / PEAK_FLOPS_BF16


def spans_nodes(sizes: Mapping[str, int], axis: str,
                coords: Mapping[str, int] | None = None) -> bool:
    """Whether the group along ``axis`` of the rank at ``coords`` (default
    rank 0) holds ranks of more than one node: ranks numbered row-major
    over (pod, data, model), ``RANKS_PER_NODE`` a node."""
    names = [a for a in ("pod", "data", "model") if a in sizes]
    stride = math.prod(sizes[a] for a in names[names.index(axis) + 1:])
    at = dict(coords or {}, **{axis: 0})
    base = 0
    for a in names:
        base = base * sizes[a] + at.get(a, 0)
    return len({(base + i * stride) // RANKS_PER_NODE for i in range(sizes[axis])}) > 1


def link_bw(sizes: Mapping[str, int], axis: str, coords: Mapping[str, int] | None = None
            ) -> float:
    """The link rate a collective along ``axis`` runs at: NVLink inside a
    node, a card's InfiniBand adapter across nodes."""
    return IB_BW if spans_nodes(sizes, axis, coords) else NVLINK_BW


def replica_link_bw(sizes: Mapping[str, int], R: int,
                    coords: Mapping[str, int] | None = None) -> float:
    """The link rate of a collective over the replica group of the rank at
    ``coords``: the R consecutive ranks of its model axis that share its KV
    head (``repro_torch.sharding.kv_replicas``)."""
    at = dict(coords or {})
    at["model"] = at.get("model", 0) // R * R   # the group's first rank
    base = 0
    for a in ("pod", "data", "model"):
        if a in sizes:
            base = base * sizes[a] + at.get(a, 0)
    spans = base // RANKS_PER_NODE != (base + R - 1) // RANKS_PER_NODE
    return IB_BW if spans else NVLINK_BW


def effective_collective_seconds(collectives: Mapping[str, dict], links: Mapping[str, float]
                                 ) -> tuple[float, float]:
    """(ring-effective bytes, seconds) of a step's collectives:
    ``collectives`` maps a name to ``{"kind", "axis", "group", "bytes"}``
    (the bytes of every such call summed), ``links`` an axis to its rate."""
    eff = seconds = 0.0
    for c in collectives.values():
        b = c["bytes"] * RING[c["kind"]](max(c["group"], 2))
        eff += b
        seconds += b / links[c["axis"]]
    return eff, seconds


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    step_flops: float
    step_bytes: float
    collective_bytes_eff: float
    model_flops_per_device: float
    useful_ratio: float
    bytes_per_device: float
    fits_hbm: bool
    collective_counts: dict
    note: str = ""

    def to_dict(self) -> dict:
        return asdict(self)


def build_report(*, arch: str, shape_name: str, mesh_name: str, n_chips: int, counted: dict,
                 cfg: ArchConfig, shape: InputShape, links: Mapping[str, float],
                 card_bytes: float = HBM_BYTES, note: str = "") -> RooflineReport:
    """The three-term roofline of one rank's counted step (``counted``:
    :func:`repro_torch.launch.step_costs.count_step`'s record) on a mesh
    of ``n_chips``: compute at the bfloat16 peak (every counted FLOP, as
    the reference divides every HLO FLOP by its one peak), memory at the
    HBM rate, collectives at ``links``' rates; ``fits_hbm`` holds the
    step's peak live bytes against ``card_bytes``."""
    compute_s = counted["flops"] / PEAK_FLOPS_BF16
    memory_s = counted["bytes"] / HBM_BW
    coll_eff, coll_s = effective_collective_seconds(counted["collectives"], links)
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    mf = model_flops(cfg, shape) / n_chips
    return RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name, compute_s=compute_s, memory_s=memory_s,
        collective_s=coll_s, dominant=max(terms, key=terms.get),
        step_flops=float(counted["flops"]), step_bytes=float(counted["bytes"]),
        collective_bytes_eff=coll_eff, model_flops_per_device=mf,
        useful_ratio=mf / max(counted["flops"], 1.0),
        bytes_per_device=float(counted["peak_bytes"]),
        fits_hbm=counted["peak_bytes"] <= card_bytes,
        collective_counts={name: c["count"] for name, c in counted["collectives"].items()},
        note=note)
