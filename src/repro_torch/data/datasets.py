"""The paper's four datasets (Table 3) and the paper-scale stream —
numpy copy of `repro/data/datasets.py`.

Kepler ships verbatim (9 planets, public). Iris/KAT-7/LIGO are generated
stand-ins with the exact assigned shapes: Iris as the classic 3-cluster
Gaussian mixture, KAT-7 (10,000×9) and LIGO glitch (4,000×1,373) as
synthetic classification sets whose labels follow a nonlinear feature
rule. Every figure in the paper measures throughput, which depends only
on shape. The same seeds give the same arrays as the reference.
"""
from __future__ import annotations

import numpy as np

# Kepler's 3rd law: orbital radius r (AU) → period p (years); p = r^1.5.
_KEPLER = np.array([
    # r (AU),  p (years)
    [0.387, 0.241],   # Mercury
    [0.723, 0.615],   # Venus
    [1.000, 1.000],   # Earth
    [1.524, 1.881],   # Mars
    [5.203, 11.862],  # Jupiter
    [9.539, 29.457],  # Saturn
    [19.18, 84.011],  # Uranus
    [30.06, 164.79],  # Neptune
    [39.53, 248.54],  # Pluto (forsaken)
], np.float32)


def kepler():
    """9×2 regression: X=[r] → y=p (GP must discover p = sqrt(r·r·r))."""
    return _KEPLER[:, :1], _KEPLER[:, 1], {"kernel": "r", "features": ["r"]}


_IRIS_MEANS = np.array([[5.01, 3.43, 1.46, 0.25],
                        [5.94, 2.77, 4.26, 1.33],
                        [6.59, 2.97, 5.55, 2.03]], np.float32)
_IRIS_STDS = np.array([[0.35, 0.38, 0.17, 0.11],
                       [0.52, 0.31, 0.47, 0.20],
                       [0.64, 0.32, 0.55, 0.27]], np.float32)


def iris(seed: int = 0):
    """150×4, 3 classes — Gaussian mixture at the real Iris statistics."""
    rng = np.random.RandomState(seed)
    X, y = [], []
    for c in range(3):
        X.append(rng.randn(50, 4).astype(np.float32) * _IRIS_STDS[c] + _IRIS_MEANS[c])
        y.append(np.full(50, c, np.float32))
    X, y = np.concatenate(X), np.concatenate(y)
    order = rng.permutation(150)
    return X[order], y[order], {"kernel": "c", "n_classes": 3}


def _synthetic_classification(rows: int, feats: int, seed: int, informative: int = 6):
    """Nonlinear binary labels over standard-normal features."""
    rng = np.random.RandomState(seed)
    X = rng.randn(rows, feats).astype(np.float32)
    w = rng.randn(informative).astype(np.float32)
    z = (X[:, :informative] * w).sum(-1) + 0.5 * X[:, 0] * X[:, 1] - 0.3 * np.abs(X[:, 2])
    y = (z > np.median(z)).astype(np.float32)
    return X, y


def kat7(rows: int = 10_000, seed: int = 1):
    """10,000×9 RFI-flagging stand-in: binary classification."""
    X, y = _synthetic_classification(rows, 9, seed)
    return X, y, {"kernel": "c", "n_classes": 2}


def ligo_glitch(rows: int = 4_000, feats: int = 1_373, seed: int = 2):
    """4,000×1,373 glitch-classification stand-in."""
    X, y = _synthetic_classification(rows, feats, seed, informative=24)
    return X, y, {"kernel": "c", "n_classes": 2}


def stream_rows(rows: int = 5_500_000, feats: int = 8, *, seed: int = 0,
                block_rows: int = 65_536):
    """Paper-scale synthetic regression stream: a CALLABLE yielding
    `(X [n, feats], y [n])` row blocks totalling `rows`, for the
    streaming path (`GPSession.ingest(stream=...)`). Nothing is
    materialized beyond one block.

    The same seed gives the same rows for any `block_rows`: blocks are
    drawn in turn from one `np.random.RandomState`, whose state (gauss
    cache included) carries across block boundaries, so a chunked pass
    and a monolithic pass see the very same rows. Not in `BY_NAME`, as
    in the reference."""
    if feats < 4:
        raise ValueError(f"stream_rows target uses features 0-3; feats={feats}")

    def blocks():
        rng = np.random.RandomState(seed)
        done = 0
        while done < rows:
            n = min(block_rows, rows - done)
            X = rng.randn(n, feats).astype(np.float32)
            y = (X[:, 0] * X[:, 1] + np.sin(X[:, 2])
                 - 0.5 * np.abs(X[:, 3])).astype(np.float32)
            yield X, y
            done += n

    return blocks


BY_NAME = {"kepler": kepler, "iris": iris, "kat7": kat7, "ligo": ligo_glitch}
