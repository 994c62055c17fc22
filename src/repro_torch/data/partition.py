"""Heterogeneous data partitioners (statistical non-IID-ness).

A copy of ``repro/data/partition.py:35-140`` (numpy only): the
Dirichlet(alpha) label-skew partition and the Dirichlet quantity-skew
partition, both exact (every sample on exactly one device, no device
empty) and deterministic per ``seed``, and the population helpers
(``shard_for_device``: global device id -> shard of the pool;
``label_marginals``, ``skew_score``).  The same seed gives the same shards
as the reference (tests/test_torch_sim_core.py), and the helpers the same
numbers (tests/test_torch_population.py).
"""
from __future__ import annotations

import numpy as np

Shards = list[tuple[np.ndarray, np.ndarray]]


def _rebalance_nonempty(device_idx: list[list[int]]) -> None:
    """Move single samples from the largest shards into empty ones."""
    for dev in range(len(device_idx)):
        while not device_idx[dev]:
            donor = max(range(len(device_idx)),
                        key=lambda j: len(device_idx[j]))
            if len(device_idx[donor]) <= 1:
                raise ValueError("fewer samples than devices")
            device_idx[dev].append(device_idx[donor].pop())


def partition_dirichlet(x: np.ndarray, y: np.ndarray, m: int,
                        alpha: float = 0.5, seed: int = 0) -> Shards:
    """Dirichlet(alpha) label-skew partition (Hsu et al. 2019 style).

    Per class c: p ~ Dir(alpha * 1_M), the shuffled class-c indices are cut
    at the cumulative proportions and dealt to the devices.  alpha -> 0
    gives near-single-class devices; alpha -> inf recovers IID.
    """
    if m < 1:
        raise ValueError(f"need at least one device, got m={m}")
    if alpha <= 0:
        raise ValueError(f"alpha must be positive, got {alpha}")
    rng = np.random.default_rng(seed)
    n_classes = int(y.max()) + 1
    device_idx: list[list[int]] = [[] for _ in range(m)]
    for c in range(n_classes):
        idx_c = np.flatnonzero(y == c)
        rng.shuffle(idx_c)
        p = rng.dirichlet(np.full(m, alpha))
        cuts = (np.cumsum(p)[:-1] * len(idx_c)).astype(int)
        for dev, part in enumerate(np.split(idx_c, cuts)):
            device_idx[dev].extend(part.tolist())
    _rebalance_nonempty(device_idx)
    out = []
    for dev in range(m):
        idx = np.array(sorted(device_idx[dev]), dtype=np.int64)
        out.append((x[idx], y[idx]))
    return out


def partition_quantity_skew(x: np.ndarray, y: np.ndarray, m: int,
                            alpha: float = 0.5, seed: int = 0) -> Shards:
    """Quantity-skew partition: shard sizes ~ Dirichlet(alpha), labels IID.

    Sizes use largest-remainder rounding with a floor of one sample per
    device, over one global shuffle -- so label marginals stay near the
    global distribution while shard sizes get more unequal as alpha -> 0.
    """
    if m < 1:
        raise ValueError(f"need at least one device, got m={m}")
    if alpha <= 0:
        raise ValueError(f"alpha must be positive, got {alpha}")
    n = int(x.shape[0])
    if n < m:
        raise ValueError(f"fewer samples ({n}) than devices ({m})")
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    p = rng.dirichlet(np.full(m, alpha))
    # largest-remainder apportionment of n - m spare samples on top of the
    # one-per-device floor: exact partition, deterministic, all non-empty
    raw = p * (n - m)
    counts = np.floor(raw).astype(np.int64)
    rem = int(n - m - counts.sum())
    if rem:
        order = np.argsort(-(raw - counts), kind="stable")
        counts[order[:rem]] += 1
    counts += 1
    cuts = np.cumsum(counts)[:-1]
    return [(x[np.sort(s)], y[np.sort(s)]) for s in np.split(perm, cuts)]


def shard_for_device(dev_ids: np.ndarray, n_shards: int) -> np.ndarray:
    """Map global device ids onto the population's fixed shard pool:
    ``id % n_shards``, keyed by the id alone and onto every shard for a
    population of at least ``n_shards`` devices.  Devices sharing a shard
    still draw their own minibatch streams (TAG_BATCH is keyed by id)."""
    dev_ids = np.asarray(dev_ids)
    if n_shards < 1:
        raise ValueError(f"need at least one shard, got {n_shards}")
    return dev_ids % n_shards


def label_marginals(shards: Shards, n_classes: int | None = None
                    ) -> np.ndarray:
    """(M, n_classes) per-device label distributions (rows sum to 1)."""
    ys = [y for _, y in shards]
    if n_classes is None:
        n_classes = int(max(int(y.max()) for y in ys if y.size)) + 1
    out = np.zeros((len(shards), n_classes))
    for i, y in enumerate(ys):
        binc = np.bincount(y.astype(np.int64), minlength=n_classes)
        out[i] = binc / max(1, y.size)
    return out


def skew_score(shards: Shards) -> float:
    """Mean total-variation distance between the devices' label marginals
    and the pooled one: 0 for IID shards, toward 1 for single-class
    devices."""
    marg = label_marginals(shards)
    sizes = np.array([y.size for _, y in shards], dtype=np.float64)
    pooled = (marg * sizes[:, None]).sum(0) / sizes.sum()
    return float(0.5 * np.abs(marg - pooled).sum(1).mean())
