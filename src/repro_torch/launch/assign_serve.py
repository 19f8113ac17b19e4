"""Assignment-serving launcher: membership-as-a-service over a synthetic
federation.

Port of ``repro.launch.assign_serve``.  Builds a clustered synthetic
engine, stands up a :class:`repro_torch.serving.AssignmentServer`, fires
batched assignment queries at it and prints p50/p99 latency plus sustained
QPS; then demonstrates the epoch swap by submitting churn and draining
mid-serve.  Signatures, the proximity kernel and the dispatch run on
``--device`` (default ``cuda``):

    python -m repro_torch.launch.assign_serve --clients 512 --queries 256 --batch 32
    python -m repro_torch.launch.assign_serve --clients 64 --queries 32 --batch 8 --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.angles import proximity_matrix
from repro_torch.core.engine import ClusterEngine, EngineConfig
from repro_torch.serving import REPRESENTATIVE_KINDS, AssignmentServer


def _clustered_signatures(K, n_bases=64, n=64, p=5, seed=0, device: DeviceLike = None):
    """K orthonormal (n, p) signatures around ``n_bases`` random subspaces
    (client k near base k mod n_bases), drawn on ``device`` from ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    bases = torch.linalg.qr(torch.randn((n_bases, n, p), generator=gen, device=dev))[0]
    noise = 0.15 * torch.randn((K, n, p), generator=gen, device=dev)
    X = bases[torch.arange(K, device=dev) % n_bases] + noise
    return torch.linalg.qr(X)[0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=512)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--n-bases", type=int, default=64)
    ap.add_argument("--measure", choices=("eq2", "eq3"), default="eq3")
    ap.add_argument(
        "--representative", choices=REPRESENTATIVE_KINDS, default="medoid"
    )
    ap.add_argument("--churn", type=int, default=8,
                    help="joins to submit + drain mid-serve (0 disables)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    K, Q, B = args.clients, args.queries, args.batch
    U_all = _clustered_signatures(K + Q + args.churn, n_bases=args.n_bases, device=dev)
    U_seen, pool = U_all[:K], U_all[K : K + Q]
    A = proximity_matrix(U_seen, args.measure).cpu().numpy()
    beta = float(np.quantile(A[A > 0], 0.05))
    engine = ClusterEngine.from_proximity(
        A, U_seen, EngineConfig(beta=beta, measure=args.measure), device=dev
    )
    engine.warm_cache()
    server = AssignmentServer(
        engine, representative=args.representative, batch_max=B
    )
    C = int(server.snapshot.rep_labels.size)
    print(f"engine: K={K} C={C} beta={beta:.2f}deg "
          f"measure={args.measure} representative={args.representative} device={dev}")

    server.assign(pool[:B])  # warmup: kernel load, allocator
    lat = []
    assigned = 0
    t_all = time.perf_counter()
    for lo in range(0, Q - B + 1, B):
        t0 = time.perf_counter()
        res = server.assign(pool[lo : lo + B])   # ends with the host readback
        lat.append((time.perf_counter() - t0) * 1e3)
        assigned += int((res.labels >= 0).sum())
    wall = time.perf_counter() - t_all
    lat.sort()
    n = len(lat)
    p50 = lat[n // 2]
    p99 = lat[min(n - 1, int(n * 0.99))]
    total = n * B
    print(f"served {total} queries in {n} batches of {B}: "
          f"p50={p50:.2f}ms p99={p99:.2f}ms per batch "
          f"({p50 / B * 1e3:.0f}us/query p50), {total / wall:.0f} qps; "
          f"{assigned}/{total} assigned within beta")

    report = None
    if args.churn:
        snap = server.snapshot
        for i in range(args.churn):
            server.submit_join(U_all[K + Q + i])
        report = server.drain()
        res_old = server.assign(pool[:B], snapshot=snap)
        res_new = server.assign(pool[:B])
        _sync(dev)
        print(f"drained {report.joins} joins -> epoch {report.epoch} "
              f"(C={server.snapshot.rep_labels.size}); held pre-drain "
              f"snapshot still answers epoch {res_old.epoch}, "
              f"current answers epoch {res_new.epoch}")
    return {"p50_ms": p50, "p99_ms": p99, "qps": total / wall, "clusters": C,
            "drain": report}


if __name__ == "__main__":
    main()
