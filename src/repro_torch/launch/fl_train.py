"""PACFL federation launcher (the paper's end-to-end pipeline).

Port of ``repro.launch.fl_train``: the same flags and JSON summary, plus
``--device`` (default ``cuda``):

    python -m repro_torch.launch.fl_train --setting mix4 --strategy pacfl --rounds 20
    python -m repro_torch.launch.fl_train --setting mix4 --model lenet5 --dim 3072 --clients 100
    python -m repro_torch.launch.fl_train --clients 12 --rounds 2 --dim 64 --device cpu

The CNNs read ``--dim`` as a square (hw, hw, 3) image, ``hw = sqrt(dim //
3)``, for both their parameters and their forward pass.
"""
import argparse
import json

import numpy as np

from repro_torch.core.pacfl import PACFLConfig
from repro_torch.data import make_dataset
from repro_torch.fl import (
    FLConfig, STRATEGIES, dirichlet_skew, label_skew, mix_datasets, run_federation,
)
from repro_torch.models.cnn import MODEL_ZOO, build_model

MIX4 = ("cifar10s", "svhns", "fmnists", "uspss")


def build_clients(setting: str, n_clients: int, dim: int, n_train: int):
    if setting == "mix4":
        dss = [make_dataset(n, n_train=n_train, n_test=800, dim=dim) for n in MIX4]
        counts = [max(1, round(n_clients * f)) for f in (0.31, 0.25, 0.27, 0.14)]
        while sum(counts) > n_clients:
            counts[np.argmax(counts)] -= 1
        return mix_datasets(dss, counts, samples_per_client=300), 40
    ds = make_dataset("cifar10s", n_train=n_train, n_test=800, dim=dim)
    if setting == "label20":
        return label_skew(ds, n_clients, rho=0.2), ds.n_classes
    if setting == "label30":
        return label_skew(ds, n_clients, rho=0.3), ds.n_classes
    if setting == "dir01":
        return dirichlet_skew(ds, n_clients, alpha=0.1), ds.n_classes
    raise ValueError(setting)


def fl_config(setting: str, rounds: int, beta=None, measure=None) -> FLConfig:
    """The launcher's FL settings: sample 0.1, 3 local epochs, batch 20,
    lr 0.05; PACFL p = 3 with beta 50 / eq2 on mix4, 175 / eq3 otherwise."""
    pac = PACFLConfig(
        p=3,
        beta=beta if beta is not None else (50.0 if setting == "mix4" else 175.0),
        measure=measure or ("eq2" if setting == "mix4" else "eq3"),
    )
    return FLConfig(rounds=rounds, sample_frac=0.1, local_epochs=3,
                    batch_size=20, lr=0.05, pacfl=pac)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--setting", default="mix4",
                    choices=("mix4", "label20", "label30", "dir01"))
    ap.add_argument("--strategy", default="pacfl", choices=sorted(STRATEGIES))
    ap.add_argument("--model", default="mlp", choices=sorted(MODEL_ZOO))
    ap.add_argument("--clients", type=int, default=40)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--beta", type=float, default=None)
    ap.add_argument("--measure", default=None, choices=(None, "eq2", "eq3"))
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    clients, n_classes = build_clients(args.setting, args.clients, args.dim, 3000)
    model = build_model(args.model, dim=args.dim, n_classes=n_classes)
    cfg = fl_config(args.setting, args.rounds, args.beta, args.measure)
    res = run_federation(args.strategy, clients, model, cfg, seed=args.seed,
                         eval_every=5, verbose=True, device=args.device)
    summary = {
        "strategy": args.strategy, "setting": args.setting,
        "final_acc_mean": res.final_mean, "final_acc_std": res.final_std,
        "comm_mb": (res.strategy_obj.comm_up + res.strategy_obj.comm_down) / 1e6,
    }
    if args.strategy == "pacfl":
        summary["n_clusters"] = int(res.strategy_obj.clustering.n_clusters)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
