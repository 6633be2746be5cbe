"""Data, configurations and a test fitness kernel shared by
`test_torch_mesh.py` and the reference runs it starts in a subprocess
(numpy only, so that both sides import it)."""

import numpy as np

MIXES = ((0.1, 0.1, 0.1, 0.7), (0.05, 0.05, 0.05, 0.85), (0.1, 0.3, 0.3, 0.3),
         (0.25, 0.25, 0.25, 0.25))
TOURN = (4, 10, 7, 3)
RATES = (0.1, 0.25, 0.5, 0.3)
TOPOLOGIES = ("ring", "torus", "broadcast-best")
# the island sessions of (pod 2, data 2, model 1), whose pods span
# processes: the pod ring's ppermute (ring) and the champion's all_gather
POD_TOPOLOGIES = ("ring", "broadcast-best")
MERGE_KERNELS = ("r", "hoist", "pearson", "r2")
LAT3 = dict(kernel="r", max_depth=3, p_const=0.0, fn_set="add,sub,mul")


def lattice(rows, seed, lo=-2, hi=3, feats=2):
    rng = np.random.RandomState(seed)
    X = rng.randint(lo, hi, size=(rows, feats)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] - X[:, 0] + rng.randint(-1, 2, size=rows)).astype(np.float32)
    return X, y


def dyadic(seed):
    rng = np.random.RandomState(seed)
    X = rng.randint(-1, 2, size=(16, 3)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] + rng.randint(-1, 2, size=16)).astype(np.float32)
    return X, y


def real(rows=128, seed=1):
    rng = np.random.RandomState(seed)
    X = np.abs(rng.randn(2, rows)).astype(np.float32) + 0.5
    return X, (X[0] ** 2 / X[1]).astype(np.float32)


def merge_inputs(kernel, seed=2):
    # four data shards of 12 points and 6 trees: dyadic values where
    # the merge is a sum (exact in any order), real ones for the folds
    rng = np.random.RandomState(seed)
    if kernel in ("r", "hoist"):
        preds = rng.randint(-8, 9, size=(6, 48)).astype(np.float32) / 4
        y = rng.randint(-8, 9, size=48).astype(np.float32) / 4
        w = rng.randint(0, 3, size=48).astype(np.float32)
    else:
        preds = rng.randn(6, 48).astype(np.float32)
        y = (rng.randn(48) * 3 + 1).astype(np.float32)
        w = rng.randint(0, 3, size=48).astype(np.float32)
    return preds, y, w


HOIST = "hoist"  # a test kernel: Σw|p - y| / Σw, its Σw column hoisted


def hoist_kernel(xp, FitnessKernel):
    def moments(preds, y, w, spec):
        a = (w[None, :] * xp.abs(preds - y[None, :])).sum(-1)
        return xp.stack([a, xp.broadcast_to(w.sum(), a.shape)], -1)

    def reduce(m, spec):
        return m[..., 0] / m[..., 1]

    def y_moments(y, w, spec):
        return xp.stack([w.sum()])

    return FitnessKernel(name=HOIST, partial_fitness=lambda p, y, w, s: reduce(
        moments(p, y, w, s), s), moments=moments, reduce_moments=reduce,
        n_moments=2, y_moments=y_moments, y_moment_idx=(1,), decomposable=False)
