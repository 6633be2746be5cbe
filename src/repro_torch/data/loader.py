"""Host-side data layout (numpy copy of `repro/data/loader.py` lines
19–60 and 75–264).

`feature_major` is the paper's Eq. 1 → Eq. 2 transposition: row-major
[rows, features] becomes feature-major [features, rows] so each feature is
a contiguous vector. `pad_rows` / `pad_feature_major` pad the data axis to
a multiple with a zero-weight mask that keeps fitness exact.
`ChunkedDataset` is the host side of streaming chunked fitness: a
dataset of any size as fixed-shape numpy chunks, which the fold
(`core/engine.chunked_moments`) places on the device one at a time.
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


class ChunkedDataset:
    """Fixed-shape chunk stream over a dataset of any size — the host side
    of streaming chunked fitness.

    Iterating yields `(X_fm f32[F, chunk_rows], y f32[chunk_rows],
    weight f32[chunk_rows])` feature-major numpy chunks. Every chunk —
    including the ragged final one — is zero-weight padded to the same
    fixed shape, so a padded point contributes an exact 0.0 to every
    fitness moment. Iterate as many times as you like: evolution folds
    the stream once per generation.

    Sources (`source` positional):

      array     in-memory `[rows, features]` numpy array (`y` required);
                `np.load(path, mmap_mode="r")` memmaps work unchanged and
                stream from disk without ever materializing all rows
      callable  `source()` returns a FRESH iterator of `(X, y)` or
                `(X, y, weight)` row blocks (any block sizes — blocks are
                re-chunked to `chunk_rows`); re-invoked for every pass,
                so nothing is cached host-side
      iterator  a one-shot iterator/generator of the same blocks — it is
                consumed once at construction and the fixed-shape chunks
                cached host-side for replay

    `sample_weight` (array source only) scales each real point's fitness
    contribution and composes with the padding mask. `n_rows` is the REAL
    (pre-padding) row count — None for a callable source until its first
    full pass has been folded.
    """

    def __init__(self, source, y=None, *, chunk_rows: int, layout: str = "rows",
                 sample_weight=None, n_features: int | None = None):
        if not isinstance(chunk_rows, (int, np.integer)) or chunk_rows <= 0:
            raise ValueError(f"chunk_rows must be a positive integer, got "
                             f"{chunk_rows!r}")
        if layout not in ("rows", "features"):
            raise ValueError(f"layout must be 'rows' or 'features', got {layout!r}")
        self.chunk_rows = int(chunk_rows)
        self._layout = layout
        self._array = None  # [rows, F] or [F, rows] per layout (maybe memmap)
        self._y = None
        self._weight = None
        self._callable = None
        self._cache = None  # list of emitted chunks (one-shot iterator source)
        self._n_rows = None
        self.n_features = None  # set by the first block when not known up front

        if callable(source):
            self._callable = source
            if sample_weight is not None or y is not None:
                raise ValueError("callable sources yield (X, y[, weight]) "
                                 "blocks; pass weights inside the blocks")
            if n_features is None:
                # peek ONE block of a fresh iterator for F, then discard it
                first = next(iter(source()), None)
                if first is None:
                    raise ValueError("callable source yielded no blocks")
                n_features = np.asarray(first[0]).shape[-1]
            self.n_features = int(n_features)
        elif hasattr(source, "__next__") or (not hasattr(source, "shape")
                                             and hasattr(source, "__iter__")):
            if sample_weight is not None or y is not None:
                raise ValueError("iterator sources yield (X, y[, weight]) "
                                 "blocks; pass weights inside the blocks")
            self._cache = list(self._rechunk(source))
            if not self._cache:
                raise ValueError("iterator source yielded no blocks")
            self.n_features = int(self._cache[0][0].shape[0])
        else:
            X = np.asarray(source) if not isinstance(source, np.ndarray) else source
            if y is None:
                raise ValueError("array sources need y")
            y = np.asarray(y, np.float32)
            if X.ndim != 2:
                raise ValueError(f"array source must be 2-D, got shape {X.shape}")
            D = X.shape[0] if layout == "rows" else X.shape[1]
            if y.shape != (D,):
                raise ValueError(f"y shape {y.shape} does not match {D} data points")
            if sample_weight is not None:
                sample_weight = np.asarray(sample_weight, np.float32)
                if sample_weight.shape != (D,):
                    raise ValueError(f"sample_weight shape {sample_weight.shape} "
                                     f"does not match {D} data points")
            self._array, self._y, self._weight = X, y, sample_weight
            self._n_rows = D
            self.n_features = int(X.shape[1] if layout == "rows" else X.shape[0])

    @classmethod
    def from_npy(cls, x_path, y_path, *, chunk_rows: int, layout: str = "rows",
                 sample_weight=None) -> "ChunkedDataset":
        """Stream a dataset from `.npy` files via `np.load(mmap_mode="r")`
        — chunks are read from disk on demand, never the whole array."""
        return cls(np.load(x_path, mmap_mode="r"), np.load(y_path),
                   chunk_rows=chunk_rows, layout=layout,
                   sample_weight=sample_weight)

    @property
    def n_rows(self) -> int | None:
        """REAL (pre-padding) rows; None for a callable source that has
        not completed a pass yet."""
        return self._n_rows

    @property
    def n_chunks(self) -> int | None:
        if self._cache is not None:
            return len(self._cache)
        if self._n_rows is None:
            return None
        return max(1, -(-self._n_rows // self.chunk_rows))

    def _emit(self, X_rows, y, weight):
        """One fixed-shape chunk from ≤ chunk_rows real rows: transpose to
        feature-major f32 and zero-weight pad the tail."""
        n = y.shape[0]
        X_fm = np.ascontiguousarray(np.asarray(X_rows, np.float32).T)
        if self.n_features is None:
            self.n_features = int(X_fm.shape[0])
        if X_fm.shape[0] != self.n_features:
            raise ValueError(f"source block has {X_fm.shape[0]} features, "
                             f"expected {self.n_features}")
        w = (np.ones(n, np.float32) if weight is None
             else np.asarray(weight, np.float32))
        pad = self.chunk_rows - n
        if pad:
            X_fm = np.concatenate(
                [X_fm, np.zeros((X_fm.shape[0], pad), np.float32)], axis=1)
            y = np.concatenate([np.asarray(y, np.float32),
                                np.zeros(pad, np.float32)])
            w = np.concatenate([w, np.zeros(pad, np.float32)])
        return X_fm, np.ascontiguousarray(np.asarray(y, np.float32)), w

    def _rechunk(self, blocks):
        """Re-slice arbitrary (X, y[, weight]) row blocks into fixed
        `chunk_rows` chunks (row counting rides along)."""
        bx, by, bw, buffered, total = [], [], [], 0, 0
        any_weight = False

        def drain(final: bool):
            nonlocal bx, by, bw, buffered
            X = np.concatenate(bx) if len(bx) > 1 else bx[0]
            y = np.concatenate(by) if len(by) > 1 else by[0]
            w = (np.concatenate(bw) if len(bw) > 1 else bw[0]) if any_weight else None
            out = []
            stop = len(y) if final else (len(y) // self.chunk_rows) * self.chunk_rows
            for a in range(0, stop, self.chunk_rows):
                b = min(a + self.chunk_rows, stop)
                out.append(self._emit(X[a:b], y[a:b], None if w is None else w[a:b]))
            bx, by, bw = [X[stop:]], [y[stop:]], [] if w is None else [w[stop:]]
            buffered = len(y) - stop
            return out

        for block in blocks:
            X, y = np.asarray(block[0], np.float32), np.asarray(block[1], np.float32)
            if X.ndim != 2 or y.shape != (X.shape[0],):
                raise ValueError(f"source blocks must be (X [n, F], y [n][, "
                                 f"weight [n]]); got X {X.shape}, y {y.shape}")
            w = np.asarray(block[2], np.float32) if len(block) > 2 else None
            if bx and (w is not None) != any_weight:
                raise ValueError("source blocks must consistently include or "
                                 "omit weights")
            any_weight = w is not None
            bx.append(X)
            by.append(y)
            if any_weight:
                bw.append(w)
            buffered += len(y)
            total += len(y)
            if buffered >= self.chunk_rows:
                yield from drain(final=False)
        if buffered:
            yield from drain(final=True)
        self._n_rows = total

    def __iter__(self):
        if self._cache is not None:
            yield from self._cache
        elif self._callable is not None:
            yield from self._rechunk(self._callable())
        else:
            X, y, w, D = self._array, self._y, self._weight, self._n_rows
            for a in range(0, max(D, 1), self.chunk_rows):
                b = min(a + self.chunk_rows, D)
                if self._layout == "rows":
                    Xc = X[a:b]
                else:
                    Xc = np.asarray(X[:, a:b], np.float32).T
                yield self._emit(Xc, y[a:b], None if w is None else w[a:b])
