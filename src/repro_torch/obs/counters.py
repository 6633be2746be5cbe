"""The telemetry counter stream — column contract (port of
`repro/obs/counters.py`).

Every evolution block (`core/engine.evolve_block`) emits one `int32[C]`
counter row per generation beside the best-fitness stream, so a block
returns an `int32[K, C]` telemetry block that comes back to the host
with the same single block-boundary sync as the state and history.

Columns (index into the trailing axis):

    CACHE_HITS     elite-cache hit gates that matched this generation
    CACHE_QUERIES  hit gates evaluated (0 when the cache is disabled)
    FROZEN         steps that ran frozen (early-stopped or past `limit`);
                   their compute was executed and discarded
    MIGRATIONS     island-migration events that came due (I on a
                   generation where migration is due; 0 on the classic
                   layout)
    TREE_EVALS     productive tree evaluations: population rows scored
                   against the full dataset, excluding cache-served rows
                   and frozen steps (× row count = the paper's trees·rows)
    SUBTREE_EVALS_SAVED, UNIQUE_SUBTREES
                   dedup telemetry; 0 on heap genomes
"""
from __future__ import annotations

import numpy as np

COUNTERS = ("cache_hits", "cache_queries", "frozen", "migrations",
            "tree_evals", "subtree_evals_saved", "unique_subtrees")
(CACHE_HITS, CACHE_QUERIES, FROZEN, MIGRATIONS, TREE_EVALS,
 SUBTREE_EVALS_SAVED, UNIQUE_SUBTREES) = range(7)
N_COUNTERS = len(COUNTERS)


def totals(rows) -> dict:
    """Sum an `int32[K, C]` telemetry block into a {column: int} dict."""
    rows = np.asarray(rows)
    if rows.ndim == 1:
        rows = rows[None]
    tot = rows.sum(axis=0)
    return {name: int(tot[i]) for i, name in enumerate(COUNTERS)}


def hit_rate(stats: dict) -> float:
    """cache_hits / cache_queries from a stats dict (0.0 before any query)."""
    q = stats.get("cache_queries", 0)
    return stats.get("cache_hits", 0) / q if q else 0.0
