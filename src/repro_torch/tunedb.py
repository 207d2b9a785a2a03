"""repro_torch.tunedb — the persistent autotune database.

The paper's flow pays an expensive per-model optimization search once and
banks the outcome; AutoTVM-style stacks (Canopy's logged conv2d schedules)
make the same move explicit: *measured tuning records persist and
transfer*, so tuning cost is paid per (workload, device) — not per process.
This module is that store for the port (a copy of the JAX package's
``tunedb.py``: the JSONL format and :func:`fingerprint` are byte-identical,
so each package reads the other's files):

* :class:`TuneRecord` — one measured result: a structured JSON-safe key
  (model/shape/flow/device facts), its :func:`fingerprint`, the record
  ``kind`` (``"explore"`` for DSE searches, ``"serving"`` for the engine
  autotune's microbenches, ``"kernel"`` for per-kernel tile schedules),
  the measured ``value`` payload, the device key, and the code version
  the measurement was taken under.
* :class:`TuneDB` — an append-only JSONL file plus an in-memory index
  (last record per fingerprint wins).  Appends are single ``O_APPEND``
  writes, so concurrent writers interleave whole lines (never torn
  records); a truncated or corrupt trailing line from a killed writer is
  skipped with a warning on load, never a crash.  ``gc()`` compacts the
  log atomically (temp file + ``os.replace``).

Consumers: ``repro_torch.core.dse.explore(db=...)`` serves
exact-fingerprint hits without re-measuring and warm-starts new searches
from nearest-neighbor records (:meth:`TuneDB.neighbors`);
``repro_torch.serving.autotune`` banks its microbench winners; the
``python -m repro_torch.launch.tune`` CLI shows/compacts/exports a store.
Lookup outcomes are published as ``tunedb.{hits,misses,transfers}``
through :data:`repro_torch.obs.METRICS` and bracketed by ``tunedb.*``
spans.  Fingerprints hash canonical JSON; the device key comes from torch
(:func:`device_key`).
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch.obs import METRICS, TRACER

#: Bump when the meaning of a stored measurement changes (not merely when
#: new fields are added): records from another code version never serve
#: exact hits — they are reported stale (diagnostic T601) and re-measured.
#: The port's own version: a record the JAX package measured (a TPU or XLA
#: CPU time) is read but never served to the port, nor the reverse.
CODE_VERSION = "torch1.0"

SCHEMA_VERSION = 1

KINDS = ("explore", "serving", "kernel")


# ---------------------------------------------------------------------------
# JSON-safe value encoding (tuples must round-trip: flow knobs carry them)
# ---------------------------------------------------------------------------

def encode_value(v: Any) -> Any:
    """Recursively encode ``v`` into JSON-safe structures.  Tuples become
    ``{"__tuple__": [...]}`` so :func:`decode_value` restores them exactly
    (flow knobs like ``mesh_split`` and tile shapes are tuples, and the
    winner must round-trip byte-identical)."""
    if isinstance(v, tuple):
        return {"__tuple__": [encode_value(x) for x in v]}
    if isinstance(v, list):
        return [encode_value(x) for x in v]
    if isinstance(v, dict):
        return {str(k): encode_value(x) for k, x in v.items()}
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    raise TypeError(f"tunedb cannot encode {type(v).__name__!r}: {v!r}")


def decode_value(v: Any) -> Any:
    """Inverse of :func:`encode_value`."""
    if isinstance(v, dict):
        if set(v) == {"__tuple__"}:
            return tuple(decode_value(x) for x in v["__tuple__"])
        return {k: decode_value(x) for k, x in v.items()}
    if isinstance(v, list):
        return [decode_value(x) for x in v]
    return v


def canonical_json(obj: Any) -> str:
    """Deterministic JSON: sorted keys, no whitespace variance."""
    return json.dumps(encode_value(obj), sort_keys=True,
                      separators=(",", ":"))


def fingerprint(key: Dict[str, Any]) -> str:
    """Stable hex fingerprint of a structured key dict."""
    import hashlib
    return hashlib.blake2b(canonical_json(key).encode(),
                           digest_size=16).hexdigest()


def device_key(device: Any = None) -> str:
    """``"cuda:<card name>"`` or ``"cpu:cpu"`` — part of every fingerprint,
    so a record measured on one platform never serves another.  ``None``
    means the port's default device (the card; the CPU without CUDA)."""
    from repro_torch.device import device_key as _key
    return _key(device)


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TuneRecord:
    """One persisted measurement."""
    kind: str                       # "explore" | "serving" | "kernel"
    fingerprint: str                # fingerprint(key)
    key: Dict[str, Any]             # the structured facts that were keyed
    value: Dict[str, Any]           # winner + measurements
    device: str                     # device_key() at measurement time
    code_version: str = CODE_VERSION
    schema: int = SCHEMA_VERSION
    created_s: float = 0.0          # wall time of the measurement

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown record kind {self.kind!r}; "
                             f"expected one of {KINDS}")

    def to_json(self) -> str:
        return canonical_json(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, line: str) -> "TuneRecord":
        d = decode_value(json.loads(line))
        if not isinstance(d, dict):
            raise ValueError("tunedb record line is not an object")
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def make(cls, kind: str, key: Dict[str, Any], value: Dict[str, Any], *,
             device: Optional[str] = None) -> "TuneRecord":
        return cls(kind=kind, fingerprint=fingerprint(key), key=key,
                   value=value,
                   device=device if device is not None else device_key(),
                   created_s=time.time())


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

class TuneDB:
    """Append-only JSONL store of :class:`TuneRecord` with an in-memory
    index (last record per fingerprint wins — re-tuning supersedes)."""

    def __init__(self, path: str) -> None:
        self.path = os.fspath(path)
        self._lock = threading.Lock()
        self._index: Dict[str, TuneRecord] = {}
        self.n_skipped = 0              # corrupt/truncated lines on load
        self._load()

    # -- loading -------------------------------------------------------------
    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        sp = TRACER.timed("tunedb.load", cat="tunedb", path=self.path)
        n_bad = 0
        with open(self.path, "r", encoding="utf-8") as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = TuneRecord.from_json(line)
                except (ValueError, TypeError, KeyError) as e:
                    n_bad += 1
                    warnings.warn(
                        f"tunedb: skipping corrupt record at "
                        f"{self.path}:{lineno} ({e})", stacklevel=2)
                    continue
                self._index[rec.fingerprint] = rec
        self.n_skipped = n_bad
        sp.end(n=len(self._index), skipped=n_bad)

    def reload(self) -> None:
        """Re-read the file (another process may have appended)."""
        with self._lock:
            self._index.clear()
            self._load()

    # -- writes --------------------------------------------------------------
    def put(self, rec: TuneRecord) -> TuneRecord:
        """Append one record.  The write is a single ``O_APPEND`` ``write()``
        of one full line, so concurrent writers (threads or processes)
        interleave whole records — a reader never sees a torn line from a
        completed write."""
        line = (rec.to_json() + "\n").encode("utf-8")
        sp = TRACER.timed("tunedb.store", cat="tunedb", kind=rec.kind)
        with self._lock:
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            fd = os.open(self.path,
                         os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            try:
                os.write(fd, line)
            finally:
                os.close(fd)
            self._index[rec.fingerprint] = rec
        sp.end()
        return rec

    def record(self, kind: str, key: Dict[str, Any],
               value: Dict[str, Any]) -> TuneRecord:
        """Build (fingerprinting ``key``) and append one record."""
        return self.put(TuneRecord.make(kind, key, value))

    # -- lookup --------------------------------------------------------------
    def get(self, fp: str, *, code_version: Optional[str] = CODE_VERSION
            ) -> Optional[TuneRecord]:
        """The exact-fingerprint record, or None.  Records from a different
        code version are *not* served (pass ``code_version=None`` to see
        them anyway, e.g. for the CLI / gc)."""
        rec = self._index.get(fp)
        if rec is None:
            return None
        if code_version is not None and rec.code_version != code_version:
            return None
        return rec

    def lookup(self, key: Dict[str, Any], **kw) -> Optional[TuneRecord]:
        rec = self.get(fingerprint(key), **kw)
        if rec is not None:
            METRICS.counter("tunedb.hits").inc()
        else:
            METRICS.counter("tunedb.misses").inc()
        return rec

    def records(self, kind: Optional[str] = None) -> List[TuneRecord]:
        out = [r for r in self._index.values()
               if kind is None or r.kind == kind]
        return sorted(out, key=lambda r: (r.kind, r.fingerprint))

    def neighbors(self, kind: str, match: Dict[str, Any], *,
                  exclude: Optional[str] = None,
                  distance: Optional[Callable[[TuneRecord], float]] = None,
                  code_version: Optional[str] = CODE_VERSION
                  ) -> List[TuneRecord]:
        """Records of ``kind`` whose key agrees with every entry of
        ``match`` (the transfer axes are simply left out of ``match``),
        excluding fingerprint ``exclude``, nearest first when ``distance``
        is given.  This is the cross-config transfer query: e.g. match on
        (cfg, flow, device, validate mode) but not on the batch bucket, and
        the same workload tuned at a neighboring bucket comes back."""
        want = {k: encode_value(v) for k, v in match.items()}
        out = []
        for rec in self._index.values():
            if rec.kind != kind or rec.fingerprint == exclude:
                continue
            if code_version is not None and rec.code_version != code_version:
                continue
            enc = {k: encode_value(v) for k, v in rec.key.items()}
            if all(enc.get(k) == v for k, v in want.items()):
                out.append(rec)
        if distance is not None:
            out.sort(key=distance)
        else:
            out.sort(key=lambda r: r.fingerprint)
        return out

    # -- maintenance ---------------------------------------------------------
    def gc(self, *, drop_stale: bool = True) -> Dict[str, int]:
        """Compact the log: keep the indexed (latest) record per
        fingerprint, optionally dropping records from other code versions,
        and rewrite atomically (temp file + ``os.replace``)."""
        with self._lock:
            kept, dropped = [], 0
            for fp in sorted(self._index):
                rec = self._index[fp]
                if drop_stale and rec.code_version != CODE_VERSION:
                    dropped += 1
                    continue
                kept.append(rec)
            tmp = self.path + ".tmp"
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as f:
                for rec in kept:
                    f.write(rec.to_json() + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            self._index = {r.fingerprint: r for r in kept}
            return {"kept": len(kept), "dropped_stale": dropped}

    def stats(self) -> Dict[str, Any]:
        by_kind: Dict[str, int] = {}
        stale = 0
        for rec in self._index.values():
            by_kind[rec.kind] = by_kind.get(rec.kind, 0) + 1
            if rec.code_version != CODE_VERSION:
                stale += 1
        return {"path": self.path, "records": len(self._index),
                "by_kind": dict(sorted(by_kind.items())), "stale": stale,
                "skipped_on_load": self.n_skipped}

    def __len__(self) -> int:
        return len(self._index)

    def __repr__(self) -> str:
        return f"<TuneDB {self.path!r} records={len(self._index)}>"


# ---------------------------------------------------------------------------
# process-level open-db cache (one index per path per process)
# ---------------------------------------------------------------------------

_OPEN: Dict[str, TuneDB] = {}
_OPEN_LOCK = threading.Lock()


def open_db(db: Any) -> Optional[TuneDB]:
    """Coerce ``db`` (TuneDB | path | None) into a TuneDB.  Paths are
    cached per process so every explore/autotune call against the same
    store shares one loaded index."""
    if db is None:
        return None
    if isinstance(db, TuneDB):
        return db
    path = os.path.abspath(os.fspath(db))
    with _OPEN_LOCK:
        inst = _OPEN.get(path)
        if inst is None:
            inst = TuneDB(path)
            _OPEN[path] = inst
        return inst


def close_all() -> None:
    """Drop the process-level path cache (tests)."""
    with _OPEN_LOCK:
        _OPEN.clear()


# ---------------------------------------------------------------------------
# structured-key helpers shared by the DSE and serving autotune
# ---------------------------------------------------------------------------

def config_facts(cfg: Any) -> Dict[str, Any]:
    """The model-config part of a key: name plus a content hash, so a
    same-named config with edited dimensions never serves stale records."""
    d = dataclasses.asdict(cfg)
    return {"name": cfg.name, "hash": fingerprint(d)}


def flow_facts(flow: Any) -> Dict[str, Any]:
    """The flow-knob part of a key: full FlowConfig content minus where the
    store itself lives (moving the db file must not orphan its records)."""
    d = dataclasses.asdict(flow)
    d.get("tuning", {}).pop("tune_db", None)
    return d


def shape_facts(shape: Any) -> Dict[str, Any]:
    return {"kind": shape.kind, "seq_len": shape.seq_len,
            "global_batch": shape.global_batch}
