"""Synthetic datasets with controllable subspace structure.

This container is offline, so CIFAR-10/SVHN/FMNIST/USPS are stood in by
synthetic datasets engineered to reproduce the *statistical relationships* the
paper exploits:

* each dataset lives (mostly) in a low-dimensional subspace with a decaying
  spectrum (real image datasets have sharply decaying spectra — that is why
  the paper's Eq. 3 angle-by-order measure works);
* related datasets (CIFAR-10 ~ SVHN in Table 1) share part of their basis;
  unrelated ones (CIFAR-10 vs USPS) are near-orthogonal;
* each dataset has ``n_classes`` class prototypes inside its subspace, with
  two "super-clusters" of classes (the CIFAR-10 animals/vehicles structure of
  Fig. 3) so label-skew partitions produce clusterable clients.

Samples are flattened "images" of dimension ``dim`` (default 3*16*16=768,
a scaled CIFAR).  All generation is pure-numpy and deterministic per seed.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field

import numpy as np


def _name_digest(name: str) -> int:
    """Process-stable 31-bit digest of a dataset name for RNG seeding.

    An earlier revision used ``abs(hash(name))`` here — but Python string
    hashes are salted per process (PYTHONHASHSEED), so every interpreter
    generated *different* "seeded" data and downstream seeded runs were
    silently nondeterministic across processes.
    """
    return zlib.crc32(name.encode()) % (2**31)

DATASET_NAMES = ("cifar10s", "svhns", "fmnists", "uspss")  # synthetic stand-ins


@dataclass
class SyntheticDataset:
    name: str
    x_train: np.ndarray  # (N, dim) float32
    y_train: np.ndarray  # (N,) int64
    x_test: np.ndarray
    y_test: np.ndarray
    n_classes: int

    @property
    def dim(self) -> int:
        return self.x_train.shape[1]


def _orth(rng: np.random.Generator, dim: int, r: int) -> np.ndarray:
    Q, _ = np.linalg.qr(rng.standard_normal((dim, r)))
    return Q.astype(np.float32)


@dataclass
class DatasetSpec:
    name: str
    rank: int = 12                 # intrinsic dimension
    shared_frac: float = 0.0       # fraction of basis shared with `shared_with`
    shared_with: str | None = None
    share_tail: bool = False       # share the parent's WEAK directions only
    n_classes: int = 10
    class_spread: float = 0.55     # distance between class prototypes
    super_gap: float = 1.6         # distance between the two class super-clusters
    noise: float = 0.06


# Relationship graph mirroring Table 1: cifar10s~svhns close (share the
# dominant directions -> tiny principal angles, like CIFAR-SVHN's 6 deg);
# fmnists~uspss weakly related (share only tail directions -> large top-p
# angles, like FMNIST-USPS's 43 deg); cross pairs unrelated.
DEFAULT_SPECS = {
    "cifar10s": DatasetSpec("cifar10s"),
    "svhns": DatasetSpec("svhns", shared_frac=0.8, shared_with="cifar10s"),
    "fmnists": DatasetSpec("fmnists"),
    "uspss": DatasetSpec("uspss", shared_frac=0.3, shared_with="fmnists",
                         share_tail=True),
    # A 100-class stand-in for CIFAR-100 (same subspace family as cifar10s).
    "cifar100s": DatasetSpec(
        "cifar100s", rank=16, shared_frac=0.6, shared_with="cifar10s", n_classes=100
    ),
}


def make_dataset(
    name: str,
    *,
    n_train: int = 6000,
    n_test: int = 1500,
    dim: int = 768,
    seed: int = 0,
    specs: dict[str, DatasetSpec] | None = None,
) -> SyntheticDataset:
    """Generate one synthetic dataset with the configured subspace relations."""
    specs = specs or DEFAULT_SPECS
    if name not in specs:
        raise ValueError(f"unknown dataset {name!r}; have {sorted(specs)}")
    spec = specs[name]
    # Bases are derived from a *global* seed so shared_with relationships are
    # consistent regardless of generation order.
    base_rng = np.random.default_rng(seed)
    bases: dict[str, np.ndarray] = {}

    def basis_for(nm: str) -> np.ndarray:
        if nm in bases:
            return bases[nm]
        sp = specs[nm]
        rng = np.random.default_rng([seed, _name_digest(nm)])
        own = _orth(rng, dim, sp.rank)
        if sp.shared_with is not None and sp.shared_frac > 0:
            parent = basis_for(sp.shared_with)
            k = int(round(sp.shared_frac * sp.rank))
            if sp.share_tail:
                # shared directions sit in the weak tail of BOTH spectra
                mix = np.concatenate([own[:, : sp.rank - k], parent[:, sp.rank - k:]], axis=1)
            else:
                mix = np.concatenate([parent[:, :k], own[:, k:]], axis=1)
            own, _ = np.linalg.qr(mix)
            own = own.astype(np.float32)
        bases[nm] = own
        return own

    B = basis_for(name)                     # (dim, r)
    r = spec.rank
    # Decaying spectrum => stable, ordered principal directions (Eq. 3 works).
    spectrum = (0.82 ** np.arange(r)).astype(np.float32)

    rng = np.random.default_rng([seed + 1, _name_digest(name)])
    # Class prototypes in latent space; two super-clusters (animals/vehicles).
    n_cls = spec.n_classes
    super_centers = rng.standard_normal((2, r)).astype(np.float32)
    super_centers *= spec.super_gap / np.linalg.norm(super_centers, axis=1, keepdims=True)
    protos = np.stack(
        [
            super_centers[c % 2]
            + spec.class_spread * rng.standard_normal(r).astype(np.float32)
            for c in range(n_cls)
        ]
    )  # (n_cls, r)

    def sample(n: int, sub) -> tuple[np.ndarray, np.ndarray]:
        y = sub.integers(0, n_cls, size=n)
        latent = protos[y] + sub.standard_normal((n, r)).astype(np.float32)
        latent = latent * spectrum[None, :]
        x = latent @ B.T + spec.noise * sub.standard_normal((n, dim)).astype(np.float32)
        return x.astype(np.float32), y.astype(np.int64)

    x_tr, y_tr = sample(n_train, np.random.default_rng([seed + 2, _name_digest(name)]))
    x_te, y_te = sample(n_test, np.random.default_rng([seed + 3, _name_digest(name)]))
    return SyntheticDataset(name, x_tr, y_tr, x_te, y_te, n_cls)


def data_matrix(x: np.ndarray) -> np.ndarray:
    """Arrange samples as *columns* (paper footnote 2): (N_features, M)."""
    return np.ascontiguousarray(x.T)


# -- drift schedules ---------------------------------------------------------


@dataclass(frozen=True)
class DriftSpec:
    """Schedule for a client's local distribution shift over rounds.

    kind: ``"covariate"`` rotates a rank-``rank`` slice of the client's
        data subspace by exactly ``angle_per_round_deg * rnd`` degrees — the
        drifted signature's principal angles against the original are
        *analytically* the rotation angle, so drift magnitude is a control
        knob, not an emergent property.  ``"label"`` resamples the client's
        data under a fresh Dirichlet(``label_gamma``) class distribution
        each round (the classic label-shift model; smaller gamma = more
        skew).
    seed: root of the RNG tree.  Every stream is keyed
        ``[seed, crc32(name), ...]`` — process-stable (see
        :func:`_name_digest`'s note on the salted-``hash()`` bug), so
        identical schedules reproduce bitwise across interpreters.
    """

    kind: str = "covariate"
    angle_per_round_deg: float = 5.0
    rank: int = 4
    label_gamma: float = 0.5
    seed: int = 0


class DriftGenerator:
    """Deterministic per-client drift: ``apply(name, rnd, x, y)``.

    ``name`` keys the client's private drift directions (stable across
    rounds — a client drifts along one trajectory, not a fresh one per
    round) and ``rnd`` the position along the schedule.  The same
    ``(spec, dim, name, rnd)`` always produces the same output arrays, in
    any process: the generator holds no mutable state.

    Covariate drift is an exact plane rotation: with ``(B, C)`` an
    orthonormal ``(dim, 2 * rank)`` frame private to the client,

        x' = x + (x @ B) @ ((cos(theta) - 1) B + sin(theta) C)^T

    maps each basis direction ``b_i`` to ``cos(theta) b_i + sin(theta)
    c_i`` and leaves the orthogonal complement untouched — every principal
    angle between ``span(B)`` and its drifted image is exactly ``theta =
    rnd * angle_per_round_deg``.
    """

    def __init__(self, spec: DriftSpec, dim: int):
        if spec.kind not in ("covariate", "label"):
            raise ValueError(
                f"unknown drift kind {spec.kind!r}; have covariate | label"
            )
        if spec.kind == "covariate" and 2 * spec.rank > dim:
            raise ValueError(
                f"rank {spec.rank} needs a 2x complement inside dim {dim}"
            )
        self.spec = spec
        self.dim = int(dim)

    def _rng(self, name: str, *extra: int) -> np.random.Generator:
        return np.random.default_rng(
            [self.spec.seed, _name_digest(str(name)), *map(int, extra)]
        )

    def frame(self, name: str) -> tuple[np.ndarray, np.ndarray]:
        """The client's private rotation frame ``(B, C)``, float64
        ``(dim, rank)`` each, orthonormal and mutually orthogonal."""
        r = self.spec.rank
        Q, _ = np.linalg.qr(self._rng(name).standard_normal((self.dim, 2 * r)))
        return Q[:, :r], Q[:, r:]

    def theta_deg(self, rnd: int) -> float:
        """Cumulative rotation angle at round ``rnd`` (degrees)."""
        return float(self.spec.angle_per_round_deg * int(rnd))

    def apply(
        self, name: str, rnd: int, x: np.ndarray, y: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Drift ``(x, y)`` to round ``rnd``'s distribution.

        ``x`` is always the *original* (round-0) data: the schedule is
        cumulative from the origin, not compounded from the previous
        round, so replaying round ``rnd`` never depends on having applied
        rounds ``1..rnd-1`` first.
        """
        if int(rnd) <= 0:
            return np.asarray(x).copy(), np.asarray(y).copy()
        if self.spec.kind == "covariate":
            return self._covariate(name, rnd, x, y)
        return self._label(name, rnd, x, y)

    def _covariate(self, name, rnd, x, y):
        B, C = self.frame(name)
        theta = np.deg2rad(self.theta_deg(rnd))
        delta = (np.cos(theta) - 1.0) * B + np.sin(theta) * C
        x64 = np.asarray(x, dtype=np.float64)
        x2 = x64 + (x64 @ B) @ delta.T
        return x2.astype(np.asarray(x).dtype), np.asarray(y).copy()

    def _label(self, name, rnd, x, y):
        y = np.asarray(y)
        rng = self._rng(name, int(rnd))
        present = np.unique(y)
        w = rng.dirichlet(np.full(present.size, self.spec.label_gamma))
        drawn = rng.choice(present.size, size=y.size, p=w)
        idx = np.empty(y.size, dtype=np.int64)
        for c in range(present.size):
            mask = drawn == c
            if not mask.any():
                continue
            pool = np.where(y == present[c])[0]
            idx[mask] = pool[rng.integers(0, pool.size, size=int(mask.sum()))]
        return np.asarray(x)[idx].copy(), y[idx].copy()
