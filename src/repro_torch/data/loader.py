"""Host-side data layout (numpy copy of `repro/data/loader.py` lines
19–60).

`feature_major` is the paper's Eq. 1 → Eq. 2 transposition: row-major
[rows, features] becomes feature-major [features, rows] so each feature is
a contiguous vector. `pad_rows` / `pad_feature_major` pad the data axis to
a multiple with a zero-weight mask that keeps fitness exact.
"""
from __future__ import annotations

import numpy as np


def feature_major(X_rows: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(X_rows.T)


def _check_multiple(multiple: int) -> int:
    if not isinstance(multiple, (int, np.integer)) or multiple <= 0:
        raise ValueError(f"pad multiple must be a positive integer, got "
                         f"{multiple!r}")
    return int(multiple)


def pad_rows(X_rows, y, multiple: int, *, weight=None):
    """Pad [rows, ...] data up to a multiple; returns (X, y, weight) where
    weight is 1.0 on real rows (or the given sample weights) and 0.0 on
    padding."""
    multiple = _check_multiple(multiple)
    D = X_rows.shape[0]
    pad = (-D) % multiple
    if pad:
        X_rows = np.concatenate([X_rows, np.zeros((pad,) + X_rows.shape[1:], X_rows.dtype)])
        y = np.concatenate([y, np.zeros((pad,), y.dtype)])
    real_w = (np.ones(D, np.float32) if weight is None
              else np.asarray(weight, np.float32))
    w = np.concatenate([real_w, np.zeros(pad, np.float32)])
    return X_rows, y, w


def pad_feature_major(X_fm, y, multiple: int, *, weight=None):
    """`pad_rows` for already-transposed [features, rows] data: pads the
    trailing (data) axis. Returns (X [F, D'], y [D'], weight [D'])."""
    multiple = _check_multiple(multiple)
    F, D = X_fm.shape
    pad = (-D) % multiple
    if pad:
        X_fm = np.concatenate([X_fm, np.zeros((F, pad), X_fm.dtype)], axis=1)
        y = np.concatenate([y, np.zeros((pad,), y.dtype)])
    real_w = (np.ones(D, np.float32) if weight is None
              else np.asarray(weight, np.float32))
    w = np.concatenate([real_w, np.zeros(pad, np.float32)])
    return np.ascontiguousarray(X_fm), y, w
