"""Synthetic datasets with controllable subspace structure."""
from repro_torch.data.synthetic import (
    DATASET_NAMES,
    DriftGenerator,
    DriftSpec,
    SyntheticDataset,
    data_matrix,
    make_dataset,
)

__all__ = [
    "DATASET_NAMES",
    "DriftGenerator",
    "DriftSpec",
    "SyntheticDataset",
    "make_dataset",
    "data_matrix",
]
