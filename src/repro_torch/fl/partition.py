"""Client data partitioners: Non-IID label skew, Dirichlet skew, MIX-K.

Faithful to the protocols in the paper (Sec. 3, Li et al. 2021b):

* :func:`label_skew` — each client is assigned ``rho``% of the label set at
  random, then each label's samples are split among the clients owning it.
* :func:`dirichlet_skew` — class ``i``'s samples are split across clients
  with proportions ``p_i ~ Dir_N(alpha)`` (alpha=0.1 in the paper).
* :func:`mix_datasets` — MIX-4: each client owns samples from exactly one of
  several datasets (31/25/27/14 clients, 500 samples each in the paper), with
  labels offset so the union task has ``sum n_classes`` labels.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.data.synthetic import SyntheticDataset


@dataclass
class ClientData:
    """One client's local train/test split."""

    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    dataset_name: str = ""
    meta: dict = field(default_factory=dict)

    @property
    def n_train(self) -> int:
        return self.x_train.shape[0]


def _split_test_by_labels(
    ds: SyntheticDataset, labels: np.ndarray, rng: np.random.Generator, n_test: int
) -> tuple[np.ndarray, np.ndarray]:
    """Local test set restricted to a client's label support (paper evaluates
    each client on its own label distribution)."""
    mask = np.isin(ds.y_test, labels)
    idx = np.where(mask)[0]
    take = min(n_test, idx.size)
    idx = rng.choice(idx, size=take, replace=False)
    return ds.x_test[idx], ds.y_test[idx]


def label_skew(
    ds: SyntheticDataset,
    n_clients: int,
    rho: float = 0.2,
    *,
    seed: int = 0,
    test_per_client: int = 200,
) -> list[ClientData]:
    """Non-IID label skew: each client owns ``rho * n_classes`` labels."""
    rng = np.random.default_rng(seed)
    n_labels = max(1, int(round(rho * ds.n_classes)))
    client_labels = [
        rng.choice(ds.n_classes, size=n_labels, replace=False)
        for _ in range(n_clients)
    ]
    # For each label, split its sample indices among owners.
    owners: dict[int, list[int]] = {c: [] for c in range(ds.n_classes)}
    for k, labs in enumerate(client_labels):
        for c in labs:
            owners[int(c)].append(k)
    per_client_idx: list[list[int]] = [[] for _ in range(n_clients)]
    for c in range(ds.n_classes):
        idx = np.where(ds.y_train == c)[0]
        rng.shuffle(idx)
        ks = owners[c]
        if not ks:
            continue
        for part, k in zip(np.array_split(idx, len(ks)), ks):
            per_client_idx[k].extend(part.tolist())
    clients = []
    for k in range(n_clients):
        idx = np.array(sorted(per_client_idx[k]), dtype=np.int64)
        if idx.size == 0:  # degenerate split; give the client a random label
            c = int(rng.integers(ds.n_classes))
            idx = np.where(ds.y_train == c)[0][:16]
        xt, yt = _split_test_by_labels(ds, client_labels[k], rng, test_per_client)
        clients.append(
            ClientData(
                ds.x_train[idx],
                ds.y_train[idx],
                xt,
                yt,
                ds.name,
                meta={"labels": np.sort(client_labels[k])},
            )
        )
    return clients


def dirichlet_skew(
    ds: SyntheticDataset,
    n_clients: int,
    alpha: float = 0.1,
    *,
    seed: int = 0,
    test_per_client: int = 200,
    min_samples: int = 8,
) -> list[ClientData]:
    """Non-IID Dirichlet(alpha) label skew (Li et al. 2021b protocol)."""
    rng = np.random.default_rng(seed)
    per_client_idx: list[list[int]] = [[] for _ in range(n_clients)]
    for c in range(ds.n_classes):
        idx = np.where(ds.y_train == c)[0]
        rng.shuffle(idx)
        p = rng.dirichlet(alpha * np.ones(n_clients))
        cuts = (np.cumsum(p)[:-1] * idx.size).astype(int)
        for k, part in enumerate(np.split(idx, cuts)):
            per_client_idx[k].extend(part.tolist())
    clients = []
    for k in range(n_clients):
        idx = np.array(sorted(per_client_idx[k]), dtype=np.int64)
        if idx.size < min_samples:
            extra = rng.integers(0, ds.x_train.shape[0], size=min_samples)
            idx = np.concatenate([idx, extra])
        labels = np.unique(ds.y_train[idx])
        xt, yt = _split_test_by_labels(ds, labels, rng, test_per_client)
        clients.append(
            ClientData(
                ds.x_train[idx], ds.y_train[idx], xt, yt, ds.name,
                meta={"labels": labels},
            )
        )
    return clients


def mix_datasets(
    datasets: list[SyntheticDataset],
    clients_per_dataset: list[int],
    *,
    samples_per_client: int = 500,
    seed: int = 0,
    test_per_client: int = 200,
) -> list[ClientData]:
    """MIX-K: each client owns ``samples_per_client`` samples from *one*
    dataset, all classes present (50/class in the paper).  Labels offset per
    dataset so the union task is a single classification head."""
    assert len(datasets) == len(clients_per_dataset)
    rng = np.random.default_rng(seed)
    clients = []
    offset = 0
    for ds, n_k in zip(datasets, clients_per_dataset):
        for _ in range(n_k):
            idx = rng.choice(ds.x_train.shape[0], size=samples_per_client, replace=False)
            tidx = rng.choice(ds.x_test.shape[0], size=min(test_per_client, ds.x_test.shape[0]), replace=False)
            clients.append(
                ClientData(
                    ds.x_train[idx],
                    ds.y_train[idx] + offset,
                    ds.x_test[tidx],
                    ds.y_test[tidx] + offset,
                    ds.name,
                    meta={"label_offset": offset},
                )
            )
        offset += ds.n_classes
    return clients


def iid_split(
    ds: SyntheticDataset, n_clients: int, *, seed: int = 0, test_per_client: int = 200
) -> list[ClientData]:
    """IID control: uniform random split (PACFL should find 1 cluster)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(ds.x_train.shape[0])
    clients = []
    for part in np.array_split(idx, n_clients):
        tidx = rng.choice(ds.x_test.shape[0], size=test_per_client, replace=False)
        clients.append(
            ClientData(
                ds.x_train[part], ds.y_train[part],
                ds.x_test[tidx], ds.y_test[tidx], ds.name,
            )
        )
    return clients
