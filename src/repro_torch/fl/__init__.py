"""Federated-learning substrate (port of ``repro.fl``): partitioners,
clients, strategies, trainer, churn."""
from repro_torch.fl.churn import ChurnBatch, ChurnQueue, DrainPolicy
from repro_torch.fl.partition import (
    ClientData,
    dirichlet_skew,
    iid_split,
    label_skew,
    mix_datasets,
)
from repro_torch.fl.strategies import STRATEGIES, FLConfig
from repro_torch.fl.trainer import (
    ChurnEvent,
    FederationResult,
    apply_churn_batches,
    run_federation,
)

__all__ = [
    "ClientData", "label_skew", "dirichlet_skew", "mix_datasets", "iid_split",
    "STRATEGIES", "FLConfig", "FederationResult", "run_federation",
    "ChurnEvent", "ChurnBatch", "ChurnQueue", "DrainPolicy",
    "apply_churn_batches",
]
