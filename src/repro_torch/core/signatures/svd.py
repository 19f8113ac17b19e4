"""The ``svd`` family: the paper's raw-data truncated-SVD signatures.

Port of ``repro.core.signatures.svd``.  Ragged clients are grouped into
pow2 shape buckets (zero columns do not change the left singular basis),
and each bucket runs in chunks of at most :data:`SIG_BATCH_MAX` clients
through the batched signature path.  Client ``k``'s random sketch comes
from its own generator seeded from ``(seed, k)`` (the reference folds
``k`` into its key), so a signature does not depend on its chunk.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.signatures.base import (
    FamilyContext,
    SignatureFamily,
    client_matrix,
    register_family,
)
from repro_torch.core.svd import batched_client_signatures, bucket_samples

# Max clients per batched signature call: bounds the padded
# (B, N, M_bucket) stack's memory.
SIG_BATCH_MAX = 64


def client_generator(seed: int, k: int, device: torch.device) -> torch.Generator:
    """Client ``k``'s sketch generator, seeded from ``(seed, k)``."""
    state = np.random.SeedSequence((int(seed), int(k))).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]) >> 1)


class SVDFamily(SignatureFamily):
    """Top-p left singular basis of each client's raw (d, M) data matrix."""

    name = "svd"
    needs_model = False

    def signatures(
        self,
        payloads: list,
        config,
        *,
        seed: Optional[int] = None,
        context: Optional[FamilyContext] = None,
        device: DeviceLike = None,
    ) -> torch.Tensor:
        del context  # data-local: no model, no probe
        dev = resolve_device(device)
        seed = 0 if seed is None else seed
        client_data = [client_matrix(p) for p in payloads]
        K = len(client_data)
        if K == 0:
            raise ValueError("compute_signatures needs at least one client")
        n = int(client_data[0].shape[0])

        buckets: dict[int, list[int]] = {}
        for k, D in enumerate(client_data):
            if D.ndim != 2 or int(D.shape[0]) != n:
                raise ValueError(
                    f"client {k}: expected ({n}, M_k) data matrix, got "
                    f"{tuple(D.shape)}"
                )
            buckets.setdefault(bucket_samples(int(D.shape[1])), []).append(k)

        randomized = config.svd_method != "exact"
        U = torch.empty((K, n, config.p), dtype=torch.float32, device=dev)
        for mb, idxs in sorted(buckets.items()):
            for lo in range(0, len(idxs), SIG_BATCH_MAX):
                chunk = idxs[lo : lo + SIG_BATCH_MAX]
                D_stack = torch.zeros(
                    (len(chunk), n, mb), dtype=torch.float32, device=dev
                )
                for b, k in enumerate(chunk):
                    D = client_data[k]
                    D_stack[b, :, : D.shape[1]] = D.to(dev, torch.float32)
                gens = (
                    [client_generator(seed, k, dev) for k in chunk]
                    if randomized else None
                )
                U[torch.as_tensor(chunk, device=dev)] = batched_client_signatures(
                    D_stack, config.p, config.svd_method, generators=gens
                )
        return U


register_family(SVDFamily())
