"""Trace-file analysis CLI: per-phase breakdown of an engine timeline (the
port's copy of the JAX package's ``launch/obs.py``, over
:func:`repro_torch.obs.trace.load_trace`).

``python -m repro_torch.launch.obs summarize out.trace.json`` reads a trace
written by ``launch/serve.py --trace`` (Chrome trace-event JSON or the
JSONL form) and prints where the run's wall time went:

* total wall from the ``cat="run"`` span (``engine.run``), falling back to
  the event extent when a run span is absent (e.g. a truncated JSONL log);
* a per-phase table over the ``cat="phase"`` spans (admit / decode /
  chunked-prefill / spec-verify / decode-fori) — these tile the loop body,
  so their percentages sum to the trace's loop coverage;
* sub-phase spans (``cat="sub"``: cow-fork, evict) shown separately —
  they nest *inside* phase spans and would double-count in the tiling;
* top stall causes, tallied from ``stall=...`` attributes on admit spans.
"""
from __future__ import annotations

import argparse
import sys
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs.trace import Event, load_trace


def _span_extent(events: List[Event]) -> float:
    """Wall time in us covered by the events (max end - min start)."""
    spans = [e for e in events if e.get("ph") == "X"]
    if not spans:
        return 0.0
    t0 = min(float(e["ts"]) for e in spans)
    t1 = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in spans)
    return t1 - t0


def _phase_key(ev: Event) -> str:
    args = ev.get("args") or {}
    return str(args.get("phase", ev.get("name", "?")))


def summarize(events: List[Event]) -> Dict[str, Any]:
    """Aggregate a trace into the structure ``_print_summary`` renders
    (kept separate so tests can assert on numbers, not stdout)."""
    runs = [e for e in events if e.get("ph") == "X" and e.get("cat") == "run"]
    total_us = sum(float(e.get("dur", 0.0)) for e in runs) \
        if runs else _span_extent(events)

    phases: Dict[str, List[float]] = defaultdict(list)
    subs: Dict[str, List[float]] = defaultdict(list)
    stalls: Dict[str, int] = defaultdict(int)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        dur = float(ev.get("dur", 0.0))
        if cat == "phase":
            phases[_phase_key(ev)].append(dur)
        elif cat == "sub":
            subs[str(ev.get("name", "?"))].append(dur)
        stall = (ev.get("args") or {}).get("stall")
        if stall:
            stalls[str(stall)] += 1

    def rows(groups: Dict[str, List[float]]) -> List[Tuple[str, int, float]]:
        out = [(name, len(ds), sum(ds)) for name, ds in groups.items()]
        out.sort(key=lambda r: -r[2])
        return out

    covered_us = sum(sum(ds) for ds in phases.values())
    return {
        "total_us": total_us,
        "n_events": sum(1 for e in events if e.get("ph") == "X"),
        "phases": rows(phases),
        "subs": rows(subs),
        "stalls": sorted(stalls.items(), key=lambda kv: -kv[1]),
        "covered_us": covered_us,
        "coverage": covered_us / total_us if total_us > 0 else 0.0,
    }


def _print_summary(s: Dict[str, Any]) -> None:
    total = s["total_us"]
    print(f"trace: {s['n_events']} spans, "
          f"total {total / 1e3:.2f} ms (engine.run)")
    print(f"{'phase':<18} {'count':>6} {'total_ms':>10} {'%':>6}")
    for name, n, us in s["phases"]:
        pct = 100.0 * us / total if total > 0 else 0.0
        print(f"{name:<18} {n:>6} {us / 1e3:>10.2f} {pct:>5.1f}%")
    print(f"{'(loop coverage)':<18} {'':>6} "
          f"{s['covered_us'] / 1e3:>10.2f} {100.0 * s['coverage']:>5.1f}%")
    if s["subs"]:
        print("sub-phases (nested inside the above, not additive):")
        for name, n, us in s["subs"]:
            pct = 100.0 * us / total if total > 0 else 0.0
            print(f"  {name:<16} {n:>6} {us / 1e3:>10.2f} {pct:>5.1f}%")
    if s["stalls"]:
        print("top stall causes:")
        for cause, n in s["stalls"]:
            print(f"  {cause:<24} x{n}")
    else:
        print("no stalls recorded")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.obs",
        description="analyze traces written by launch/serve.py --trace")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_sum = sub.add_parser("summarize",
                           help="per-phase time breakdown + stall causes")
    p_sum.add_argument("trace", help="trace file (Chrome JSON or JSONL)")
    args = ap.parse_args(argv)

    if args.cmd == "summarize":
        events = load_trace(args.trace)
        if not events:
            print(f"{args.trace}: no events", file=sys.stderr)
            return 1
        _print_summary(summarize(events))
        return 0
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
