"""Nested-span tracer with a bounded ring buffer and Chrome-trace export.

One :class:`Tracer` owns a ring buffer of finished span events.  Spans are
opened with :meth:`Tracer.span` (recorded only while the tracer is enabled;
a shared no-op span otherwise — the disabled path is a single boolean
check) or :meth:`Tracer.timed` (always wall-clocked, recorded only while
enabled — the drop-in replacement for hand-rolled ``t0 = perf_counter()``
blocks whose elapsed time feeds existing stats).  Every finished span
becomes one Chrome trace-event dict (``ph="X"`` complete event with
``name``/``cat``/``ts``/``dur``/``pid``/``tid``/``args``), so the export
loads directly in Perfetto or ``chrome://tracing``.

Thread-safety: the buffer append and tid interning are lock-protected; the
span stack is thread-local, so nesting depth is correct per thread.
"""
from __future__ import annotations

import functools
import json
import threading
import time
from collections import deque
from typing import (Any, Callable, Deque, Dict, Iterator, List, Optional,
                    TypeVar)

_F = TypeVar("_F", bound=Callable[..., Any])

#: One exported trace event (Chrome trace-event "complete" format).
Event = Dict[str, Any]


class Span:
    """One open span.  Usable as a context manager or ended explicitly via
    :meth:`end` (idempotent — the first call wins); ``set()`` attaches
    attributes at any point before the end.  ``elapsed_s`` is valid after
    the span has ended (and live-reads while it is still open)."""

    __slots__ = ("_tracer", "_record", "name", "cat", "attrs", "_t0",
                 "_t_end", "depth", "_ended")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 attrs: Dict[str, Any], record: bool) -> None:
        self._tracer = tracer
        self._record = record
        self.name = name
        self.cat = cat
        self.attrs = attrs
        self.depth = tracer._push(self) if record else 0
        self._t0 = tracer._clock()
        self._t_end: Optional[float] = None
        self._ended = False

    # -- lifecycle -----------------------------------------------------------
    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def end(self, **attrs: Any) -> None:
        """Close the span (no-op on a second call) and record its event."""
        if self._ended:
            return
        self._ended = True
        self._t_end = self._tracer._clock()
        if attrs:
            self.attrs.update(attrs)
        if self._record:
            self._tracer._pop(self)
            self._tracer._emit(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.end()

    # -- timing --------------------------------------------------------------
    @property
    def elapsed_s(self) -> float:
        end = self._t_end if self._t_end is not None else self._tracer._clock()
        return end - self._t0

    @property
    def elapsed_ms(self) -> float:
        return self.elapsed_s * 1e3


class _NoopSpan(Span):
    """The shared disabled-path span: every operation is a no-op and the
    elapsed time is 0.0 (callers needing wall time use ``timed()``)."""

    def __init__(self) -> None:  # no tracer, no clock reads
        pass

    def set(self, **attrs: Any) -> "Span":
        return self

    def end(self, **attrs: Any) -> None:
        return None

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None

    @property
    def elapsed_s(self) -> float:
        return 0.0


_NOOP = _NoopSpan()


class Tracer:
    """Bounded, thread-safe span recorder.

    * ``enabled=False`` (the default): :meth:`span` returns a shared no-op
      span after one boolean check — nothing is timed or stored.
    * ``max_events`` bounds the ring buffer: the newest events win, the
      oldest are dropped (``n_dropped`` counts them).
    * ``clock`` is injectable (defaults to ``time.perf_counter``) so span
      timelines are deterministic under test.
    """

    def __init__(self, enabled: bool = False, *, max_events: int = 65536,
                 clock: Callable[[], float] = time.perf_counter,
                 pid: int = 0) -> None:
        if max_events < 1:
            raise ValueError(f"max_events must be >= 1, got {max_events}")
        self.enabled = enabled
        self.max_events = max_events
        self.pid = pid
        self._clock = clock
        self._epoch = clock()
        self._buf: Deque[Event] = deque(maxlen=max_events)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._tids: Dict[int, int] = {}      # thread ident -> small tid
        self.n_dropped = 0

    # -- span plumbing (internal) -------------------------------------------
    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = []
            self._local.stack = st
        return st

    def _push(self, span: Span) -> int:
        st = self._stack()
        depth = len(st)
        st.append(span)
        return depth

    def _pop(self, span: Span) -> None:
        st = self._stack()
        if st and st[-1] is span:
            st.pop()
        elif span in st:                     # out-of-order end: drop through
            st.remove(span)

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def _emit(self, span: Span) -> None:
        t_end = span._t_end if span._t_end is not None else self._clock()
        ev: Event = {
            "name": span.name,
            "cat": span.cat or "span",
            "ph": "X",
            "ts": (span._t0 - self._epoch) * 1e6,
            "dur": (t_end - span._t0) * 1e6,
            "pid": self.pid,
            "tid": self._tid(),
            "args": dict(span.attrs),
            "depth": span.depth,
        }
        with self._lock:
            if len(self._buf) == self.max_events:
                self.n_dropped += 1
            self._buf.append(ev)

    # -- public API ----------------------------------------------------------
    def span(self, name: str, cat: str = "span", **attrs: Any) -> Span:
        """Open a recorded span — or the shared no-op span when disabled
        (the hot-path contract: one boolean check, no clock read)."""
        if not self.enabled:
            return _NOOP
        return Span(self, name, cat, attrs, record=True)

    def timed(self, name: str, cat: str = "timed", **attrs: Any) -> Span:
        """Open an always-wall-clocked span, recorded only while enabled —
        the one-code-path replacement for hand-rolled stopwatch blocks:
        ``elapsed_s`` is valid whether or not tracing is on."""
        return Span(self, name, cat, attrs, record=self.enabled)

    def trace(self, name: Optional[str] = None,
              cat: str = "fn") -> Callable[[_F], _F]:
        """Decorator form: the wrapped call runs inside a span (named after
        the function unless overridden); zero overhead beyond one boolean
        check while disabled."""
        def deco(fn: _F) -> _F:
            label = name if name is not None else fn.__qualname__

            @functools.wraps(fn)
            def wrapper(*args: Any, **kw: Any) -> Any:
                if not self.enabled:
                    return fn(*args, **kw)
                with self.span(label, cat=cat):
                    return fn(*args, **kw)
            return wrapper  # type: ignore[return-value]
        return deco

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.n_dropped = 0

    def events(self) -> List[Event]:
        """Snapshot of the ring buffer, oldest first."""
        with self._lock:
            return list(self._buf)

    def __len__(self) -> int:
        return len(self._buf)

    # -- export --------------------------------------------------------------
    def to_chrome(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Chrome trace-event JSON (``{"traceEvents": [...]}``): loads in
        Perfetto (ui.perfetto.dev) and ``chrome://tracing``.  Written to
        ``path`` when given; the document is returned either way."""
        events = sorted(self.events(), key=lambda e: (e["ts"], -e["dur"]))
        doc: Dict[str, Any] = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"producer": "repro_torch.obs",
                          "n_dropped": self.n_dropped},
        }
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
                f.write("\n")
        return doc

    def to_jsonl(self, path: str) -> None:
        """One JSON event per line (stream-appendable log form)."""
        with open(path, "w") as f:
            for ev in self.events():
                f.write(json.dumps(ev))
                f.write("\n")


def load_trace(path: str) -> List[Event]:
    """Read a trace written by :meth:`Tracer.to_chrome` (a traceEvents
    document or a bare event array) or :meth:`Tracer.to_jsonl`."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:              # JSONL: one event per line
        return [json.loads(line) for line in text.splitlines()
                if line.strip()]
    if isinstance(doc, dict):
        events = doc.get("traceEvents", [])
    else:
        events = doc
    if not isinstance(events, list):
        raise ValueError(f"{path}: not a trace-event document")
    return events


def _iter_spans(events: List[Event]) -> Iterator[Event]:
    for ev in events:
        if ev.get("ph") == "X":
            yield ev


#: Module default: compile-side code (pass runs, flow stages, DSE candidate
#: validation, autotune microbenchmarks) times through this tracer so every
#: stopwatch in the stack is one code path; enable it to watch a compile.
TRACER = Tracer(enabled=False)
