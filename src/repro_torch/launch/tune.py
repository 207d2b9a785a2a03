"""Persistent-autotune-store launcher — inspect and maintain a tunedb.

The store (:mod:`repro_torch.tunedb`) banks measured DSE searches, serving
microbench winners, and per-kernel tile schedules; this CLI is its
maintenance surface:

Usage:
  python -m repro_torch.launch.tune show --db tune.jsonl [--kind explore] [-v]
  python -m repro_torch.launch.tune gc --db tune.jsonl [--keep-stale]
  python -m repro_torch.launch.tune export --db tune.jsonl [--out records.json]

``show`` prints the store summary and one line per record (``-v`` adds the
full key/value payloads).  ``gc`` compacts the append-only log to the
latest record per fingerprint, dropping records from other code versions
unless ``--keep-stale``.  ``export`` writes the indexed records as one
JSON document (stdout by default) for offline analysis or seeding another
machine's store.
"""
import argparse
import dataclasses
import json
import sys
from typing import List, Optional

from repro_torch import tunedb


def _fmt_record(rec: tunedb.TuneRecord, verbose: bool) -> List[str]:
    stale = "" if rec.code_version == tunedb.CODE_VERSION else " STALE"
    head = (f"{rec.kind:8s} {rec.fingerprint[:16]}  dev={rec.device}"
            f"  ver={rec.code_version}{stale}")
    if not verbose:
        return [head]
    return [head,
            "    key:   " + tunedb.canonical_json(rec.key),
            "    value: " + tunedb.canonical_json(rec.value)]


def cmd_show(db: tunedb.TuneDB, *, kind: Optional[str],
             verbose: bool) -> int:
    st = db.stats()
    print(f"tunedb {st['path']}: {st['records']} records "
          f"{st['by_kind']} stale={st['stale']} "
          f"skipped_on_load={st['skipped_on_load']}")
    for rec in db.records(kind):
        for line in _fmt_record(rec, verbose):
            print(line)
    return 0


def cmd_gc(db: tunedb.TuneDB, *, keep_stale: bool) -> int:
    out = db.gc(drop_stale=not keep_stale)
    print(f"tunedb {db.path}: kept={out['kept']} "
          f"dropped_stale={out['dropped_stale']}")
    return 0


def cmd_export(db: tunedb.TuneDB, *, kind: Optional[str],
               out: Optional[str]) -> int:
    recs = [tunedb.encode_value(dataclasses.asdict(r))
            for r in db.records(kind)]
    doc = json.dumps({"code_version": tunedb.CODE_VERSION,
                      "schema": tunedb.SCHEMA_VERSION,
                      "records": recs}, indent=2, sort_keys=True)
    if out:
        with open(out, "w", encoding="utf-8") as f:
            f.write(doc + "\n")
        print(f"exported {len(recs)} records to {out}")
    else:
        print(doc)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.tune",
        description="inspect/maintain a persistent autotune store")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, helpline in (("show", "print the store summary and records"),
                           ("gc", "compact the log (latest per fingerprint)"),
                           ("export", "dump records as one JSON document")):
        p = sub.add_parser(name, help=helpline)
        p.add_argument("--db", required=True, help="path of the JSONL store")
        if name in ("show", "export"):
            p.add_argument("--kind", default=None, choices=tunedb.KINDS,
                           help="only records of this kind")
        if name == "show":
            p.add_argument("-v", "--verbose", action="store_true",
                           help="print full key/value payloads")
        if name == "gc":
            p.add_argument("--keep-stale", action="store_true",
                           help="keep records from other code versions")
        if name == "export":
            p.add_argument("--out", default=None,
                           help="output file (default: stdout)")
    args = ap.parse_args(argv)

    db = tunedb.TuneDB(args.db)
    if args.cmd == "show":
        return cmd_show(db, kind=args.kind, verbose=args.verbose)
    if args.cmd == "gc":
        return cmd_gc(db, keep_stale=args.keep_stale)
    return cmd_export(db, kind=args.kind, out=args.out)


if __name__ == "__main__":
    sys.exit(main())
