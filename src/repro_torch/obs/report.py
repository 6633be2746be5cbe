"""Render a run's metrics JSONL (and optionally its trace) as a table.

    python -m repro_torch.obs.report metrics.jsonl [--trace trace.json]

Reads the event stream a `Metrics(path=...)` sink wrote — the final
`{"kind": "snapshot"}` line carries every counter/gauge/summary; the
per-event lines give block/chunk timing series. With `--trace`, also
validates the Chrome trace file and prints per-span-name totals.
The port's own copy of `repro/obs/report.py`.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict


def load_jsonl(path: str) -> list[dict]:
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def _table(rows: list[tuple], header: tuple) -> str:
    rows = [tuple(_fmt(c) for c in r) for r in rows]
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(header)]
    def line(cells):
        return "  ".join(c.ljust(w) for c, w in zip(cells, widths)).rstrip()
    out = [line(header), line(tuple("-" * w for w in widths))]
    out.extend(line(r) for r in rows)
    return "\n".join(out)


def summarize_metrics(records: list[dict]) -> str:
    """Human-readable report from a metrics JSONL record list."""
    snap = None
    for rec in records:
        if rec.get("kind") == "snapshot":
            snap = rec  # last snapshot wins
    parts = []
    if snap is None:
        parts.append("(no snapshot line — run did not close its Metrics "
                     "sink; reporting event lines only)")
    else:
        counters = sorted(snap.get("counters", {}).items())
        if counters:
            parts.append("counters\n" + _table(counters, ("name", "value")))
        gauges = sorted(snap.get("gauges", {}).items())
        if gauges:
            parts.append("gauges\n" + _table(gauges, ("name", "value")))
        summaries = snap.get("summaries", {})
        if summaries:
            rows = [(name, s.get("count"), s.get("mean"), s.get("min"),
                     s.get("max"), s.get("ema"))
                    for name, s in sorted(summaries.items())]
            parts.append("summaries\n" + _table(
                rows, ("name", "count", "mean", "min", "max", "ema")))
        c = snap.get("counters", {})
        q = c.get("cache_queries", 0)
        if q:
            parts.append(f"cache hit rate: {c.get('cache_hits', 0) / q:.3f} "
                         f"({c.get('cache_hits', 0)}/{q})")
        saved = c.get("subtree_evals_saved", 0)
        uniq = c.get("unique_subtrees", 0)
        if saved or uniq:
            rate = saved / (saved + uniq) if saved + uniq else 0.0
            parts.append(f"subtree evals saved by dedup: {saved} "
                         f"(unique subtrees: {uniq}, duplicate rate: "
                         f"{rate:.3f})")
    kinds = defaultdict(int)
    for rec in records:
        kinds[rec.get("kind", "?")] += 1
    parts.append("events\n" + _table(sorted(kinds.items()),
                                     ("kind", "count")))
    return "\n\n".join(parts)


def summarize_trace(path: str) -> str:
    """Validate a Chrome trace file and total wall time per span name."""
    from repro_torch.obs.trace import validate_trace

    with open(path) as f:
        payload = json.load(f)
    problems = validate_trace(payload)
    parts = []
    if problems:
        parts.append("trace problems:\n" + "\n".join(
            f"  - {p}" for p in problems))
    else:
        parts.append("trace: valid (spans nest, no orphan events)")
    # Total B→E durations per name, matching the same stack walk the
    # validator does so misnested traces don't crash the report.
    totals = defaultdict(float)
    counts = defaultdict(int)
    stacks: dict[tuple, list] = {}
    for ev in payload.get("traceEvents", []):
        ph = ev.get("ph")
        if ph == "B":
            stacks.setdefault((ev.get("pid"), ev.get("tid")), []).append(
                (ev.get("name"), ev.get("ts", 0.0)))
        elif ph == "E":
            stack = stacks.get((ev.get("pid"), ev.get("tid")), [])
            if stack:
                name, t0 = stack.pop()
                totals[name] += (ev.get("ts", 0.0) - t0) / 1e6
                counts[name] += 1
    if totals:
        rows = [(name, counts[name], totals[name])
                for name in sorted(totals, key=totals.get, reverse=True)]
        parts.append("spans\n" + _table(rows, ("name", "count",
                                               "total_s")))
    return "\n\n".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Summarize a GP run's metrics JSONL / trace JSON.")
    ap.add_argument("metrics", help="metrics JSONL file from --metrics")
    ap.add_argument("--trace", default=None,
                    help="Chrome trace JSON from --trace")
    args = ap.parse_args(argv)
    print(summarize_metrics(load_jsonl(args.metrics)))
    if args.trace:
        print()
        print(summarize_trace(args.trace))
    return 0


if __name__ == "__main__":
    sys.exit(main())
