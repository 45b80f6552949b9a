"""Low-overhead structured tracer: spans, instants, counters.

Design constraints, in order:

1. **Cheap on the hot path.** The runtime worker loop records one span
   per (frame, stage); at scheduler-bound periods of tens of µs even a
   single lock acquisition per frame would show up in the measured
   period (the quantity this whole repo is about). So each thread
   appends plain tuples to its *own* ring buffer — no locks, no
   allocation beyond the tuple, timestamps taken by the caller (the
   runtime reuses the ``perf_counter`` calls it already makes for busy
   metering, so an enabled tracer adds only the append).
2. **Bounded memory.** Rings have a fixed capacity; when full, the
   oldest records are overwritten and counted (``dropped_records``) —
   a long soak keeps the most recent window instead of dying.
3. **Explicit drain.** Nothing is exported implicitly; :meth:`Tracer.
   drain` snapshots and clears every ring (taking the registry lock —
   the only lock, off the hot path) and returns time-ordered
   :class:`TraceEvent` records for the exporters.

Clock: ``time.perf_counter()`` (monotonic, sub-µs). All timestamps and
durations are raw seconds on that clock; the Perfetto exporter converts
to µs and normalizes to the earliest event.

Record phases mirror the Chrome trace-event format the exporter emits:
``"X"`` complete span (ts + dur), ``"i"`` instant, ``"C"`` counter
sample, ``"M"`` metadata (thread names). A disabled tracer
(``enabled=False``, or the shared :data:`NULL_TRACER`) turns every
record call into an early return so call sites can hold one reference
unconditionally.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One drained record. ``ts``/``dur`` are perf_counter seconds."""

    ph: str                 # "X" span | "i" instant | "C" counter | "M" meta
    name: str
    ts: float
    dur: float
    tid: int
    cat: str = ""
    args: Mapping[str, Any] | None = None


class _Ring:
    """Fixed-capacity append buffer owned by exactly one thread.

    Appends are a list append until full, then an overwrite of the
    oldest slot — both single-bytecode-ish operations that need no lock
    against the draining thread beyond the GIL's per-op atomicity (a
    drain may race one in-flight append; it catches it next drain)."""

    __slots__ = ("cap", "tid", "buf", "head", "dropped")

    def __init__(self, cap: int, tid: int):
        self.cap = cap
        self.tid = tid      # owner's thread ident at ring creation
        self.buf: list = []
        self.head = 0       # next overwrite position once full
        self.dropped = 0

    def append(self, rec) -> None:
        if len(self.buf) < self.cap:
            self.buf.append(rec)
        else:
            self.buf[self.head] = rec
            self.head = (self.head + 1) % self.cap
            self.dropped += 1

    def snapshot_and_clear(self) -> list:
        out = self.buf[self.head:] + self.buf[:self.head]
        self.buf = []
        self.head = 0
        return out


class _SpanCtx:
    """Context-manager span for non-hot call sites (``with tracer.span``)."""

    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._tracer.complete(self._name, self._t0, t1 - self._t0,
                              cat=self._cat, args=self._args)
        return False


class Tracer:
    """Per-thread ring-buffer trace recorder.

    ``ring_size`` is the per-thread record capacity (oldest records are
    overwritten when a thread exceeds it). ``enabled=False`` makes every
    record call an early return (~an attribute check) — the off switch
    call sites can leave wired in permanently.
    """

    def __init__(self, enabled: bool = True, ring_size: int = 65536):
        if ring_size <= 0:
            raise ValueError("ring_size must be positive")
        self.enabled = enabled
        self.ring_size = ring_size
        self._lock = threading.Lock()          # ring registry only
        self._rings: list[_Ring] = []
        self._local = threading.local()
        self.t0 = time.perf_counter()          # epoch for exporters

    # ------------------------------------------------------------ plumbing
    def now(self) -> float:
        """The tracer clock (``time.perf_counter()`` seconds)."""
        return time.perf_counter()

    def _ring(self) -> _Ring:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            ring = _Ring(self.ring_size, threading.get_ident())
            self._local.ring = ring
            with self._lock:
                # a list, not an ident-keyed dict: the OS reuses thread
                # idents after a death, and keying would overwrite a
                # dead thread's un-drained ring. Two rings sharing a
                # reused ident just merge onto one exported row.
                self._rings.append(ring)
        return ring

    # ------------------------------------------------------------ recording
    def complete(self, name: str, ts: float, dur: float, cat: str = "",
                 args: Mapping[str, Any] | None = None) -> None:
        """Record a finished span (the hot-path entry point: the caller
        supplies both timestamps, typically ones it already took)."""
        if not self.enabled:
            return
        self._ring().append(("X", name, ts, dur, cat, args))

    def span(self, name: str, cat: str = "",
             args: Mapping[str, Any] | None = None) -> _SpanCtx:
        """``with tracer.span("name"): ...`` — times the block."""
        return _SpanCtx(self, name, cat, args)

    def instant(self, name: str, cat: str = "",
                args: Mapping[str, Any] | None = None,
                ts: float | None = None) -> None:
        if not self.enabled:
            return
        self._ring().append(
            ("i", name, time.perf_counter() if ts is None else ts,
             0.0, cat, args))

    def counter(self, name: str, value, ts: float | None = None) -> None:
        """Record a counter sample. ``value`` is a number, or a mapping
        of series name -> number for a multi-series counter track."""
        if not self.enabled:
            return
        self._ring().append(
            ("C", name, time.perf_counter() if ts is None else ts,
             0.0, "", value))

    def set_thread_name(self, name: str) -> None:
        """Name the calling thread's trace row (one metadata record)."""
        if not self.enabled:
            return
        self._ring().append(("M", name, time.perf_counter(), 0.0, "", None))

    def ingest(self, records: list, tid: int, dropped: int = 0) -> None:
        """Absorb a foreign ring's raw records under ``tid``.

        The cross-process merge path: a process-executor worker records
        into its own process-local ``_Ring`` (it must not touch this
        registry — the fork's copy of the lock is not shared) and ships
        the raw tuples back over a pipe when it retires; the parent
        calls ``ingest`` with the worker's pid as the row id. The
        records join the next :meth:`drain` exactly as if a local
        thread had recorded them — including their ``"M"`` thread-name
        metadata, so exported rows keep the same ``{stage}/r{replica}``
        naming on both executors. ``dropped`` carries the foreign
        ring's overwrite count into :attr:`dropped_records`."""
        if not self.enabled or (not records and not dropped):
            return
        ring = _Ring(max(len(records), 1), tid)
        ring.buf = list(records)
        ring.dropped = dropped
        with self._lock:
            self._rings.append(ring)

    # -------------------------------------------------------------- drain
    @property
    def dropped_records(self) -> int:
        """Records lost to ring overwrites since construction."""
        with self._lock:
            return sum(r.dropped for r in self._rings)

    def drain(self) -> list[TraceEvent]:
        """Snapshot and clear every thread's ring; returns all records
        in timestamp order (including thread-name metadata, so the
        export is a pure function of the returned list)."""
        with self._lock:
            raw = [(ring.tid, rec) for ring in self._rings
                   for rec in ring.snapshot_and_clear()]
        events = [TraceEvent(ph, name, ts, dur, tid, cat, args)
                  for tid, (ph, name, ts, dur, cat, args) in raw]
        events.sort(key=lambda e: e.ts)
        return events


NULL_TRACER = Tracer(enabled=False)
"""A shared disabled tracer: safe to record into from anywhere, keeps
nothing. Call sites that want to avoid even the ``None`` check can
default to this."""
