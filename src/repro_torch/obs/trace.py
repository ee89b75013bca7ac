"""Structured request-lifecycle tracing.

A ``Tracer`` records **spans** — named intervals with a category, a
track (``tid``), and key/value args — through an injectable clock, and
exports Chrome trace-event JSON that Perfetto / ``chrome://tracing``
load directly.  The serving stack opens one span per lifecycle stage
(``submit``/``admit``/``form``/``dispatch``/``kernel``/``epilogue``/
``degrade``/``complete``) and one *lifetime* span per request on its own
track, closed at the single terminal accounting point with the outcome
in ``args`` — so the zero-loss invariant ("every submitted request
reaches exactly one of ok/rejected/expired/failed") is visible in the
trace itself.

Determinism: span IDs are a plain sequence number, and all timestamps
come from the injected ``clock``, so a test driving a fake clock gets a
byte-identical event list and can assert exact trees via
``span_tree``.

The no-op path is ``NULL_TRACER`` (a ``NullTracer``): every method is a
``pass``, so instrumented hot paths cost one method call when tracing
is off.  ``tracer.enabled`` lets a caller skip argument construction
entirely.

Chrome trace-event fields emitted (the subset ``validate_trace``
checks): ``name``/``cat``/``ph``/``ts``/``pid``/``tid`` on every event,
``dur`` on complete (``ph="X"``) events, ``s`` scope on instants
(``ph="i"``), ``args`` everywhere.  Timestamps are microseconds, as the
format requires.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "SpanHandle",
           "validate_trace", "span_tree"]

# Well-known track ids: one per pipeline stage, requests above REQ_TID0.
TID_ENGINE = 0        # engine control: stage/form/admission
TID_DISPATCH = 1      # device dispatch + kernel + per-layer children
TID_COMPLETE = 2      # readback/epilogue/completion
TID_COMPILE = 3       # compile_network / schedule planning
TID_TRANSPORT = 4     # HTTP front-end: one span per wire request
REQ_TID0 = 1000       # request r lives on track REQ_TID0 + r


class SpanHandle:
    """An open span: returned by ``begin``, closed by ``end``."""

    __slots__ = ("id", "name", "cat", "tid", "ts_s", "args", "parent")

    def __init__(self, sid: int, name: str, cat: str, tid: int,
                 ts_s: float, args: Dict[str, Any],
                 parent: Optional[int]) -> None:
        self.id = sid
        self.name = name
        self.cat = cat
        self.tid = tid
        self.ts_s = ts_s
        self.args = args
        self.parent = parent


class Tracer:
    """Span recorder with an injectable clock and deterministic IDs.

    ``clock`` is any zero-arg callable returning seconds (monotonic by
    contract).  Pass a fake in tests; production uses
    ``time.monotonic`` supplied by the caller (this module never
    touches the wall clock on its own).
    """

    enabled = True

    def __init__(self, clock, pid: int = 0) -> None:
        self.clock = clock
        self.pid = int(pid)
        self.events: List[dict] = []
        self._next_id = 1
        self._open: Dict[int, List[SpanHandle]] = {}   # tid -> span stack

    # -- span lifecycle ----------------------------------------------------
    def begin(self, name: str, cat: str = "serve", tid: int = TID_ENGINE,
              **args) -> SpanHandle:
        stack = self._open.setdefault(tid, [])
        parent = stack[-1].id if stack else None
        h = SpanHandle(self._next_id, name, cat, tid, float(self.clock()),
                       dict(args), parent)
        self._next_id += 1
        stack.append(h)
        return h

    def end(self, handle: SpanHandle, discard: bool = False,
            **args) -> None:
        """Close ``handle``.  ``discard=True`` drops the span instead of
        recording it — used for no-work iterations (an idle ``form()``
        call) that would otherwise bury the trace in noise."""
        stack = self._open.get(handle.tid, [])
        if handle in stack:
            # close any children left open (crash paths) along the way
            while stack and stack[-1] is not handle:
                self.end(stack[-1])
            stack.pop()
        if discard:
            return
        end_s = float(self.clock())
        handle.args.update(args)
        self.events.append(self._event(
            handle.name, handle.cat, "X", handle.tid, handle.ts_s,
            dur_s=max(0.0, end_s - handle.ts_s), args=handle.args,
            id=handle.id, parent=handle.parent))

    def span(self, name: str, cat: str = "serve", tid: int = TID_ENGINE,
             **args):
        """``with tracer.span(...):`` convenience wrapper."""
        return _SpanCtx(self, name, cat, tid, args)

    def instant(self, name: str, cat: str = "serve",
                tid: int = TID_ENGINE, **args) -> None:
        """A zero-duration event (e.g. a request expiring in the queue,
        an injected fault firing)."""
        self.events.append(self._event(
            name, cat, "i", tid, float(self.clock()), args=dict(args),
            id=self._next_id, scope="t"))
        self._next_id += 1

    def add_span(self, name: str, cat: str, tid: int, ts_s: float,
                 dur_s: float, parent: Optional[int] = None,
                 **args) -> int:
        """Record a complete span with explicit timing — for intervals
        not measurable inline, like per-layer kernel spans apportioned
        from a jitted forward's total (tagged ``apportioned`` by the
        caller).  Returns the span id for use as a later ``parent``."""
        sid = self._next_id
        self._next_id += 1
        self.events.append(self._event(
            name, cat, "X", tid, float(ts_s), dur_s=max(0.0, float(dur_s)),
            args=dict(args), id=sid, parent=parent))
        return sid

    def metadata(self, tid: int, name: str) -> None:
        """Name a track in the viewer (``thread_name`` metadata)."""
        self.events.append({
            "name": "thread_name", "cat": "__metadata", "ph": "M",
            "ts": 0, "pid": self.pid, "tid": int(tid),
            "args": {"name": name},
        })

    # -- export ------------------------------------------------------------
    def _event(self, name: str, cat: str, ph: str, tid: int, ts_s: float,
               dur_s: Optional[float] = None,
               args: Optional[Dict[str, Any]] = None,
               id: Optional[int] = None, parent: Optional[int] = None,
               scope: Optional[str] = None) -> dict:
        ev: Dict[str, Any] = {
            "name": name, "cat": cat, "ph": ph,
            "ts": round(ts_s * 1e6, 3),        # µs, per the format
            "pid": self.pid, "tid": int(tid),
            "args": dict(args or {}),
        }
        if dur_s is not None:
            ev["dur"] = round(dur_s * 1e6, 3)
        if id is not None:
            ev["args"]["span_id"] = id
        if parent is not None:
            ev["args"]["parent_id"] = parent
        if scope is not None:
            ev["s"] = scope
        return ev

    def to_json(self) -> dict:
        """The Chrome trace-event JSON object format."""
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms"}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")


class _SpanCtx:
    __slots__ = ("t", "name", "cat", "tid", "args", "handle")

    def __init__(self, t: Tracer, name: str, cat: str, tid: int,
                 args: Dict[str, Any]) -> None:
        self.t, self.name, self.cat, self.tid = t, name, cat, tid
        self.args = args
        self.handle: Optional[SpanHandle] = None

    def __enter__(self) -> SpanHandle:
        self.handle = self.t.begin(self.name, self.cat, self.tid,
                                   **self.args)
        return self.handle

    def __exit__(self, exc_type, exc, tb) -> None:
        extra = {"error": repr(exc)} if exc is not None else {}
        self.t.end(self.handle, **extra)


class NullTracer:
    """The default recorder: every operation is a no-op, so the
    instrumented paths cost one method dispatch when tracing is off."""

    enabled = False
    events: List[dict] = []

    def begin(self, name, cat="serve", tid=0, **args):
        return None

    def end(self, handle, discard=False, **args):
        pass

    def span(self, name, cat="serve", tid=0, **args):
        return _NULL_CTX

    def instant(self, name, cat="serve", tid=0, **args):
        pass

    def add_span(self, name, cat, tid, ts_s, dur_s, parent=None, **args):
        return 0

    def metadata(self, tid, name):
        pass

    def to_json(self):
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def save(self, path):
        raise RuntimeError("NullTracer records nothing; construct a "
                           "Tracer to save a trace")


class _NullCtx:
    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        pass


_NULL_CTX = _NullCtx()
NULL_TRACER = NullTracer()


# -- analysis / validation ----------------------------------------------------
def span_tree(trace: dict) -> Dict[Optional[int], List[dict]]:
    """Parent-id -> children (complete spans only), children in
    recording order.  Roots are under key ``None``.  Tests assert exact
    trees against this under a fake clock."""
    tree: Dict[Optional[int], List[dict]] = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        parent = ev.get("args", {}).get("parent_id")
        tree.setdefault(parent, []).append(ev)
    return tree


_PH_REQUIRED: Dict[str, tuple] = {
    "X": ("dur",),
    "i": (),
    "M": (),
}


def validate_trace(trace) -> List[str]:
    """Every schema problem in a Chrome trace-event JSON object (empty
    list = valid).  Checks the fields Perfetto requires plus this
    repo's own invariants (span ids unique, parents exist)."""
    problems: List[str] = []
    if not isinstance(trace, dict):
        return [f"trace must be a JSON object, got {type(trace).__name__}"]
    evs = trace.get("traceEvents")
    if not isinstance(evs, list):
        return ["missing or non-list 'traceEvents'"]
    seen_ids = set()
    for i, ev in enumerate(evs):
        where = f"event[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        for k in ("name", "cat", "ph", "ts", "pid", "tid"):
            if k not in ev:
                problems.append(f"{where}: missing {k!r}")
        ph = ev.get("ph")
        if ph not in _PH_REQUIRED:
            problems.append(f"{where}: unknown ph {ph!r}")
        else:
            for k in _PH_REQUIRED[ph]:
                if k not in ev:
                    problems.append(f"{where}: ph={ph} missing {k!r}")
        for k in ("ts", "dur"):
            if k in ev and (isinstance(ev[k], bool)
                            or not isinstance(ev[k], (int, float))
                            or ev[k] < 0):
                problems.append(f"{where}: {k}={ev[k]!r} is not a "
                                "non-negative number")
        args = ev.get("args", {})
        if not isinstance(args, dict):
            problems.append(f"{where}: args is not an object")
            continue
        sid = args.get("span_id")
        if sid is not None:
            if sid in seen_ids:
                problems.append(f"{where}: duplicate span_id {sid}")
            seen_ids.add(sid)
    # parent links must resolve to a recorded span
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            continue
        parent = ev.get("args", {}).get("parent_id") \
            if isinstance(ev.get("args"), dict) else None
        if parent is not None and parent not in seen_ids:
            problems.append(f"event[{i}]: parent_id {parent} does not "
                            "match any span_id")
    return problems
