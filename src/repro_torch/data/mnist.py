"""Synthetic MNIST stand-in and the two seed partitioners.

A copy of ``repro/data/mnist.py`` (numpy only): a deterministic, learnable
10-class 28x28 grayscale dataset (one stroke template per class, affine
jitter and pixel noise), and the IID and label-subset partitioners.  The
same seed gives the same arrays as the reference
(tests/test_torch_sim_core.py::test_data_copies_match_reference).
"""
from __future__ import annotations

import numpy as np

_N_CLASSES = 10
_SIDE = 28


def _class_template(c: int) -> np.ndarray:
    """A distinct 28x28 stroke pattern per class, drawn procedurally."""
    img = np.zeros((_SIDE, _SIDE), np.float32)
    yy, xx = np.mgrid[0:_SIDE, 0:_SIDE].astype(np.float32)
    cx, cy = 13.5, 13.5
    if c == 0:  # ring
        r = np.hypot(xx - cx, yy - cy)
        img[(r > 6) & (r < 10)] = 1.0
    elif c == 1:  # vertical bar
        img[:, 12:16] = 1.0
    elif c == 2:  # top arc + diagonal
        r = np.hypot(xx - cx, yy - 8)
        img[(r > 4) & (r < 7) & (yy < 10)] = 1.0
        d = np.abs((yy - 10) - (10 - (xx - 20)) * -1.2)
        img[(d < 1.8) & (yy >= 10)] = 1.0
    elif c == 3:  # two right arcs
        for oy in (8, 19):
            r = np.hypot(xx - 11, yy - oy)
            img[(r > 4) & (r < 7) & (xx > 11)] = 1.0
    elif c == 4:  # L + vertical
        img[4:16, 8:11] = 1.0
        img[13:16, 8:20] = 1.0
        img[4:24, 17:20] = 1.0
    elif c == 5:  # top bar, left bar, bottom-right arc
        img[4:7, 8:20] = 1.0
        img[4:14, 8:11] = 1.0
        r = np.hypot(xx - 12, yy - 18)
        img[(r > 4) & (r < 7) & (xx > 10)] = 1.0
    elif c == 6:  # left hook + lower ring
        img[4:20, 9:12] = 1.0
        r = np.hypot(xx - 14, yy - 19)
        img[(r > 3.5) & (r < 6.5)] = 1.0
    elif c == 7:  # top bar + steep diagonal
        img[4:7, 6:22] = 1.0
        d = np.abs((xx - 20) + (yy - 6) * 0.55)
        img[(d < 1.6) & (yy >= 6)] = 1.0
    elif c == 8:  # two rings
        for oy in (9, 19):
            r = np.hypot(xx - cx, yy - oy)
            img[(r > 3) & (r < 5.8)] = 1.0
    else:  # 9: upper ring + tail
        r = np.hypot(xx - cx, yy - 10)
        img[(r > 3.5) & (r < 6.5)] = 1.0
        img[10:24, 17:20] = 1.0
    return np.clip(img, 0, 1)


_TEMPLATES = np.stack([_class_template(c) for c in range(_N_CLASSES)])


def _jitter(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """Small random shift + multiplicative stroke noise + pixel noise."""
    dy, dx = rng.integers(-2, 3, 2)
    out = np.roll(np.roll(img, dy, 0), dx, 1)
    out = out * rng.uniform(0.7, 1.0)
    out = out + rng.normal(0, 0.15, out.shape).astype(np.float32)
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def load_synthetic_mnist(n_train: int = 6000, n_test: int = 1000,
                         seed: int = 0) -> tuple[tuple[np.ndarray, np.ndarray],
                                                 tuple[np.ndarray, np.ndarray]]:
    """Returns ((x_train, y_train), (x_test, y_test)); x in [0,1], (N,28,28,1)."""
    rng = np.random.default_rng(seed)

    def make(n):
        y = rng.integers(0, _N_CLASSES, n).astype(np.int32)
        x = np.stack([_jitter(rng, _TEMPLATES[c]) for c in y])
        return x[..., None], y
    return make(n_train), make(n_test)


def partition_iid(x: np.ndarray, y: np.ndarray, m: int, seed: int = 0
                  ) -> list[tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(x.shape[0])
    shards = np.array_split(perm, m)
    return [(x[s], y[s]) for s in shards]


def partition_noniid(x: np.ndarray, y: np.ndarray, m: int,
                     classes_per_device: int = 4, seed: int = 0
                     ) -> list[tuple[np.ndarray, np.ndarray]]:
    """Label-skewed partition: each device sees a subset of classes."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(m):
        cls = rng.choice(_N_CLASSES, classes_per_device, replace=False)
        mask = np.isin(y, cls)
        idx = np.where(mask)[0]
        rng.shuffle(idx)
        idx = idx[: max(64, len(idx) // m)]
        out.append((x[idx], y[idx]))
    return out
