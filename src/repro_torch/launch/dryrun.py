"""Each rank's bytes and counted step on a mesh, and its roofline.

    python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k --mesh 2x2
    python -m repro_torch.launch.dryrun --all [--mesh single|multi|both|DATAxMODEL]

Counterpart of ``repro.launch.dryrun``, which lowers and compiles every
(architecture x input shape x mesh) step on a 512-device fake mesh to read
XLA's memory and cost analyses, ``hlo_analysis``'s trip-count-aware counts
and the three-term roofline: proof that the distribution config is
coherent.  The port runs eagerly and compiles nothing.  Each record holds:

* each rank's bytes from the ported plan (:mod:`repro_torch.sharding`) over
  the model built on ``meta``: train: the float32 parameters, their
  gradients and AdamW's ``m`` and ``v`` (both float32, laid out as the
  parameters: ``opt_state_specs``); prefill and decode: the parameters in
  the serving dtype, bfloat16 (the vectors float32, as ``lm.init_params``
  stores them), and the caches in the port's own layout (``lm.init_cache``:
  KV heads over ``model`` by ``sharding.attn_heads``, a shared KV head
  whole on each rank of its replica group, the Mamba2 and RWKV6 states'
  heads over ``model`` where they divide, ring caches of the window's
  slots; batch over the data axes); attention's weights by head too, at
  model index 0 (a rank with the most query heads);
  every step: the batch (int64 token ids, bfloat16 vision embeddings or
  encoder frames), its rows over the data axes as ``local_batch`` cuts
  them.  A dimension its axes do not divide rounds up, as GSPMD pads it;
* where the port executes the plan (``sharding.check_plan``; else the
  refusal and ``roofline: null``, never a guess): one rank's step run on
  ``meta`` tensors and counted (:mod:`repro_torch.launch.step_costs`): its
  FLOPs, bytes, collectives by kind and axis (bytes, count, group size),
  kernel launches, the peak of its live bytes (``peak_bytes_per_rank``:
  parameters, optimizer state, batch, caches and every activation, the
  counterpart of XLA's ``argument + output + temp``), ``top_ops`` /
  ``top_bytes``, the seconds the count took, and the three-term roofline
  on H100 figures (:func:`repro_torch.launch.roofline.build_report`).
  The counted rank is model index 0 of every axis, a rank with the most
  query heads where a replica group shares each KV head; its collectives
  include the sum of the shared heads' k and v gradients over the group
  (``kv_replicas``).

The count is of what the port runs.  As under the reference's ``logits``
hint, the train step's logits stay vocab-parallel over ``model``: its loss
(``lm.cross_entropy``) all-gathers a (B, S - 1) float32 logsumexp a rank
and all-reduces the gold logits, and no rank forms the whole vocabulary's
logits; prefill and decode gather one position's.  The reference's dry run
also shards the residual stream between blocks over (data, model)
(sequence parallelism); the port keeps it replicated over ``model``, and
its records say so.  ``fits`` holds the plan's bytes against the card's memory
(``torch.cuda.get_device_properties`` where a card is present, else an
H100's 80 GB, labelled as such); the roofline's ``fits_hbm`` holds the
counted peak.  Meshes: the reference's production meshes, ``single`` 16x16
and ``multi`` 2x16x16 (pod, data, model), or any ``DATAxMODEL``; one JSON
record a combination under ``--out`` (default ``build/dryrun/``).
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import torch

from repro_torch import sharding
from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES, ArchConfig, get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import roofline, step_costs
from repro_torch.launch.mesh import parse_mesh
from repro_torch.models import lm
from repro_torch.models.layers import MeshAxis

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
H100_BYTES = 80e9   # H100 SXM, 80 GB (data sheet): the figure used without a card
PRODUCTION = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}
NOTE = ("step_flops and step_bytes counted from the port's step executed on meta tensors "
        "(launch/step_costs.py; bytes: every op's operands and outputs, unfused) on model "
        "index 0, a rank with the most query heads where ranks share a KV head; the train "
        "step's logits and loss vocab-parallel over model, as the reference's logits hint "
        "keeps them; the residual stream stays replicated over model between blocks, where "
        "the reference's dry run shards it over (data, model); H100 SXM data-sheet rates")


def mesh_sizes(mesh: str) -> dict[str, int]:
    """{axis: ranks} of ``single``, ``multi`` or ``DATAxMODEL``."""
    if mesh in PRODUCTION:
        return dict(PRODUCTION[mesh])
    data, model = parse_mesh(mesh)
    return {"data": data, "model": model}


def mesh_name(sizes: dict[str, int]) -> str:
    return "x".join(str(sizes[a]) for a in ("pod", "data", "model") if a in sizes)


def _numel(shape) -> int:
    return math.prod(int(d) for d in shape)


def param_bytes(cfg: ArchConfig, sizes: dict[str, int], scheme: str,
                dtype: torch.dtype = torch.float32) -> int:
    """One rank's parameter bytes under ``scheme`` on a mesh of ``sizes``:
    weights of two or more dimensions in ``dtype``, vectors in float32; a
    Mamba2 ``in_proj`` and ``conv_w`` as the port holds them over ``model``,
    B and C whole on every rank, and attention's ``q``, ``k``, ``v``, ``o``
    by head, model index 0's (``sharding.model_parts``)."""
    named = sharding.meta_params(cfg)
    plan = sharding.param_specs(named, cfg, scheme=scheme)
    size = torch.empty((), dtype=dtype).element_size()
    return sum(_numel(sharding.local_shape(tuple(p.shape), plan[n], sizes,
                                           sharding.model_parts(cfg, n)))
               * (size if p.ndim >= 2 else 4) for n, p in named.items())


def _rows(batch: int, sizes: dict[str, int]) -> int:
    """A rank's rows of a batch (split over pod and data when above 1)."""
    dp = sizes.get("pod", 1) * sizes.get("data", 1)
    return -(-batch // dp) if batch > 1 else batch


def batch_bytes(cfg: ArchConfig, shape: InputShape, sizes: dict[str, int]) -> int:
    """One rank's bytes of the step's inputs."""
    rows = _rows(shape.global_batch, sizes)
    seq = 1 if shape.kind == "decode" else shape.seq_len
    total = rows * seq * 8                       # int64 token ids
    if shape.kind != "decode":
        total += rows * cfg.vision_tokens * cfg.d_model * 2
        if cfg.is_enc_dec:
            total += rows * cfg.encoder_seq * cfg.d_model * 2
    return total


def cache_bytes(cfg: ArchConfig, shape: InputShape, sizes: dict[str, int],
                dtype: torch.dtype = torch.bfloat16) -> int:
    """One rank's bytes of the caches a prefill of ``shape`` fills (and a
    decode reads): ``lm.init_cache``'s tree at the rank's rows, KV heads
    over ``model`` by ``sharding.attn_heads`` (whole KV heads a rank) and
    the recurrent states' heads over ``model``, where every kind of head
    goes over it whole (``sharding.check_heads``), else whole."""
    m = sizes.get("model", 1)
    try:
        sharding.check_heads(cfg, m)
    except ValueError:
        m = 1
    # what init_cache reads of a model: its configuration, device, compute
    # dtype and model axis
    model = SimpleNamespace(cfg=cfg, embed=torch.empty(0, device="meta"), compute_dtype=dtype,
                            model_axis=MeshAxis(None, m, 0))
    cache = lm.init_cache(model, _rows(shape.global_batch, sizes), shape.seq_len)

    def walk(node) -> int:
        if isinstance(node, torch.Tensor):
            return node.numel() * node.element_size()
        values = node.values() if isinstance(node, dict) else node
        return sum(walk(v) for v in values)

    return walk(cache)


def card_bytes() -> tuple[int, str]:
    """(bytes, what they are) of the card's memory."""
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        return props.total_memory, f"{props.name} (torch.cuda.get_device_properties)"
    return int(H100_BYTES), "H100 80 GB (data sheet figure; no card present)"


def skip_reason(cfg: ArchConfig, shape: InputShape) -> Optional[str]:
    """The reference's skip: long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.long_context_ok:
        return ("full-attention architecture: long_500k requires sub-quadratic attention "
                "or O(1) state")
    return None


def dryrun_one(arch: str, shape_name: str, mesh: str, *, scheme: str = "fsdp_tp") -> dict:
    """The record of one (architecture, input shape, mesh) under ``scheme``."""
    return record(get_config(arch), shape_name, mesh_sizes(mesh), scheme)


def record(cfg: ArchConfig, shape_name: str, sizes: dict[str, int], scheme: str) -> dict:
    """The record of ``cfg`` at one input shape on a mesh of ``sizes``."""
    shape = INPUT_SHAPES[shape_name]
    arch = cfg.name
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name(sizes), "scheme": scheme,
           "ranks": _numel(sizes.values())}
    reason = skip_reason(cfg, shape)
    if reason:
        return {**rec, "status": "skip", "note": reason}
    if shape.kind == "train":
        params = param_bytes(cfg, sizes, scheme)
        parts = {"params": params, "grads": params, "adamw_m_v": 2 * params}
    else:
        parts = {"params": param_bytes(cfg, sizes, scheme, torch.bfloat16),
                 "cache": cache_bytes(cfg, shape, sizes)}
    parts["batch"] = batch_bytes(cfg, shape, sizes)
    total = sum(parts.values())
    card, card_what = card_bytes()
    try:
        sharding.check_plan(cfg, sharding.plan_for(cfg, scheme), sizes)
        refusal = None
    except (ValueError, NotImplementedError) as exc:
        refusal = str(exc)
    rec = {**rec, "status": "ok", "bytes_per_rank": parts, "total_bytes_per_rank": total,
           "card_bytes": card, "card": card_what, "fits": total <= card,
           "port_executes": refusal is None, "refusal": refusal}
    if refusal is not None:
        return {**rec, "roofline": None, "collectives": None, "kernels": None,
                "top_ops": None, "top_bytes": None, "peak_bytes_per_rank": None,
                "count_s": None}
    counted = step_costs.count_step(cfg, shape, sizes, scheme)
    links = {a: roofline.link_bw(sizes, a, counted["rank"]) for a in sizes}
    links["kv_replicas"] = roofline.replica_link_bw(
        sizes, sharding.kv_replicas(cfg, sizes.get("model", 1)), counted["rank"])
    report = roofline.build_report(
        arch=arch, shape_name=shape_name, mesh_name=rec["mesh"], n_chips=rec["ranks"],
        counted=counted, cfg=cfg, shape=shape, links=links, card_bytes=card, note=NOTE)
    return {**rec, "roofline": report.to_dict(), "counted_rank": counted["rank"],
            "flops": {k: counted[k] for k in ("matmul_flops", "elementwise_flops",
                                               "kernel_flops")},
            "collectives": counted["collectives"], "links": links,
            "kernels": counted["kernels"], "top_ops": counted["top_ops"],
            "top_bytes": counted["top_bytes"], "peak_bytes_per_rank": counted["peak_bytes"],
            "count_s": counted["count_s"]}


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=tuple(INPUT_SHAPES))
    ap.add_argument("--mesh", default="single",
                    help="single (16x16), multi (2x16x16), both, or DATAxMODEL")
    ap.add_argument("--scheme", default="fsdp_tp", choices=sharding.SCHEMES)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help=f"default {OUT_DIR}")
    args = ap.parse_args(argv)

    archs = ARCH_NAMES if (args.all or not args.arch) else (args.arch,)
    shapes = tuple(INPUT_SHAPES) if (args.all or not args.shape) else (args.shape,)
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    out_dir = Path(args.out) if args.out else OUT_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    for a in archs:
        for s in shapes:
            for m in meshes:
                rec = dryrun_one(a, s, m, scheme=args.scheme)
                name = f"{a.replace('.', '_')}__{s}__{rec['mesh']}__{args.scheme}.json"
                (out_dir / name).write_text(json.dumps(rec, indent=2))
                if rec["status"] == "skip":
                    print(f"[{a} x {s} x {rec['mesh']}] skip: {rec['note']}")
                    continue
                parts = ", ".join(f"{k} {v / 2**30:.2f}" for k, v in
                                  rec["bytes_per_rank"].items())
                print(f"[{a} x {s} x {rec['mesh']} {args.scheme}] GiB a rank: {parts}; total "
                      f"{rec['total_bytes_per_rank'] / 2**30:.2f} of {rec['card']} "
                      f"{rec['card_bytes'] / 2**30:.2f}: fits {rec['fits']}; port executes "
                      f"{rec['port_executes']}")
                r = rec["roofline"]
                if r is None:
                    print(f"  refused: {rec['refusal']}")
                    continue
                print(f"  counted in {rec['count_s']:.1f}s: peak {r['bytes_per_device'] / 2**30:.2f}"
                      f" GiB a rank; roofline: compute {r['compute_s'] * 1e3:.2f}ms  memory "
                      f"{r['memory_s'] * 1e3:.2f}ms  collective {r['collective_s'] * 1e3:.2f}ms "
                      f"-> {r['dominant']}-bound; useful_ratio {r['useful_ratio']:.2f}  "
                      f"fits_hbm={r['fits_hbm']}")
    print(f"done: {len(archs) * len(shapes) * len(meshes)} combinations in {out_dir} "
          f"({time.perf_counter() - t0:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
