"""Shared-memory fixed-slot ring queues for the process executor.

The thread backend moves frames through ``queue.Queue`` — a pointer
handoff under the GIL. Process workers need the same bounded-FIFO
semantics *across address spaces* without paying a pickle of every
array payload, so this module provides :class:`ShmRingQueue`: a
fixed-capacity ring of fixed-size slots living in one
``multiprocessing.shared_memory`` segment.

Layout (one contiguous segment, all views are numpy arrays over it):

  - header: ``head``/``tail`` uint64 monotonic counters (slot index =
    counter % capacity);
  - per-slot metadata: frame ``seq`` (int64), ``kind`` (uint8),
    ``t_enq`` (float64, the producer's ``perf_counter`` enqueue stamp
    that queue-wait metering subtracts), payload byte length, and — for
    raw ndarray payloads — dtype string, ndim and shape;
  - per-slot payload: ``slot_bytes`` of raw storage.

Numpy array payloads are copied in and out as raw bytes (dtype/shape
travel in the slot metadata — *no pickling on the frame hot path*).
Anything else falls back to ``pickle`` into the same slot, so small
control payloads and synthetic int frames just work; a payload that
does not fit ``slot_bytes`` raises ``ValueError`` rather than silently
degrading.

Synchronization is classic bounded-buffer: a ``free``-slot semaphore, a
``used``-slot semaphore, and one lock per ring end (MPMC-safe: the slot
copy happens inside the end's lock, so a consumer can never observe a
claimed-but-unwritten slot). All primitives come from the ``fork``
multiprocessing context — workers inherit the segment mapping and the
semaphores by fork, so no name-based reattach (and no pickling of the
queue object) is ever needed. The creating process owns the segment
and must call :meth:`destroy` when the queue is retired.

``kind`` values double as the cross-process control channel: ``STOP``
is the stage-retirement sentinel (circulated exactly like the thread
backend's ``_STOP``), ``ABORT`` unblocks a sink drain at a ``run()``
deadline.
"""
from __future__ import annotations

import multiprocessing
import pickle
import time
from multiprocessing import shared_memory

import numpy as np

__all__ = [
    "ShmRingQueue", "Empty", "Full",
    "KIND_RAW", "KIND_PICKLE", "KIND_STOP", "KIND_ABORT",
]

KIND_RAW = 0      # numpy ndarray payload stored as raw bytes
KIND_PICKLE = 1   # arbitrary (small) python object, pickled
KIND_STOP = 2     # stage-retirement sentinel
KIND_ABORT = 3    # sink-drain abort marker (run() deadline)

_MAX_DIMS = 8
_DTYPE_CHARS = 16
_HDR_BYTES = 16   # head, tail as uint64


class Empty(Exception):
    """get() timed out: no slot became available."""


class Full(Exception):
    """put() timed out: no free slot became available."""


def fork_context():
    """The ``fork`` multiprocessing context the process executor runs
    on (workers inherit stage fns, shm mappings and semaphores — no
    pickling). Raises on platforms without fork."""
    if "fork" not in multiprocessing.get_all_start_methods():
        raise RuntimeError(
            "the process executor needs the 'fork' start method "
            "(Linux/macOS); this platform does not provide it")
    return multiprocessing.get_context("fork")


class ShmRingQueue:
    """Bounded MPMC FIFO over one shared-memory segment.

    ``capacity`` slots of ``slot_bytes`` payload each. Items are
    ``(kind, seq, payload, t_enq)``; sentinels carry no payload.
    """

    def __init__(self, capacity: int = 8, slot_bytes: int = 1 << 16,
                 ctx=None, name: str | None = None):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        if slot_bytes <= 0:
            raise ValueError("slot_bytes must be positive")
        ctx = ctx if ctx is not None else fork_context()
        self.capacity = capacity
        self.slot_bytes = slot_bytes
        meta = capacity * (8 + 1 + 8 + 8 + 1 + _DTYPE_CHARS
                           + 8 * _MAX_DIMS)
        self._shm = shared_memory.SharedMemory(
            create=True, size=_HDR_BYTES + meta + capacity * slot_bytes,
            name=name)
        self._owner_pid = multiprocessing.current_process().pid
        self._closed = False
        buf = self._shm.buf
        off = 0

        def view(dtype, shape):
            nonlocal off
            a = np.ndarray(shape, dtype=dtype, buffer=buf, offset=off)
            off += a.nbytes
            return a

        self._hdr = view(np.uint64, (2,))          # head, tail
        self._seq = view(np.int64, (capacity,))
        self._kind = view(np.uint8, (capacity,))
        self._t_enq = view(np.float64, (capacity,))
        self._nbytes = view(np.int64, (capacity,))
        self._ndim = view(np.int8, (capacity,))    # -1 => pickled payload
        self._dtype = view(f"S{_DTYPE_CHARS}", (capacity,))
        self._shape = view(np.int64, (capacity, _MAX_DIMS))
        self._payload = view(np.uint8, (capacity, slot_bytes))
        self._hdr[:] = 0
        self._free = ctx.Semaphore(capacity)
        self._used = ctx.Semaphore(0)
        self._head_lock = ctx.Lock()   # consumer end
        self._tail_lock = ctx.Lock()   # producer end

    # ------------------------------------------------------------ produce
    def put(self, seq: int, payload, t_enq: float | None = None,
            kind: int | None = None, timeout: float | None = None) -> None:
        """Copy one item into the ring; blocks while full.

        ``kind`` is inferred (RAW for ndarray, PICKLE otherwise) unless
        given explicitly (sentinels). Raises :class:`Full` on timeout.
        """
        if not self._free.acquire(True, timeout):
            raise Full
        try:
            with self._tail_lock:
                idx = int(self._hdr[1] % self.capacity)
                self._write_slot(idx, seq, payload, t_enq, kind)
                self._hdr[1] += 1
        except Exception:
            self._free.release()   # slot was never published
            raise
        self._used.release()

    def put_sentinel(self, kind: int, timeout: float | None = None) -> None:
        self.put(-1, None, 0.0, kind=kind, timeout=timeout)

    def _write_slot(self, idx, seq, payload, t_enq, kind):
        self._seq[idx] = seq
        self._t_enq[idx] = time.perf_counter() if t_enq is None else t_enq
        if kind in (KIND_STOP, KIND_ABORT):
            self._kind[idx] = kind
            self._nbytes[idx] = 0
            return
        if isinstance(payload, np.ndarray) and payload.dtype != object:
            # asarray(order="C"), not ascontiguousarray: the latter
            # promotes 0-d arrays to shape (1,) and would lose the shape
            raw = np.asarray(payload, order="C")
            if raw.nbytes <= self.slot_bytes and raw.ndim <= _MAX_DIMS \
                    and len(raw.dtype.str) <= _DTYPE_CHARS:
                self._kind[idx] = KIND_RAW
                self._nbytes[idx] = raw.nbytes
                self._ndim[idx] = raw.ndim
                self._dtype[idx] = raw.dtype.str.encode()
                self._shape[idx, :raw.ndim] = raw.shape
                self._payload[idx, :raw.nbytes] = raw.reshape(-1).view(
                    np.uint8) if raw.nbytes else 0
                return
        blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
        if len(blob) > self.slot_bytes:
            raise ValueError(
                f"frame payload needs {len(blob)} bytes but slots hold "
                f"{self.slot_bytes}; construct the runtime with a larger "
                f"slot_bytes")
        self._kind[idx] = KIND_PICKLE
        self._nbytes[idx] = len(blob)
        self._ndim[idx] = -1
        self._payload[idx, :len(blob)] = np.frombuffer(blob, dtype=np.uint8)

    # ------------------------------------------------------------ consume
    def get(self, timeout: float | None = None):
        """Pop the oldest item: ``(kind, seq, payload, t_enq)``.

        Raises :class:`Empty` on timeout. The payload is copied out of
        the slot (the returned array owns its memory).
        """
        if not self._used.acquire(True, timeout):
            raise Empty
        try:
            with self._head_lock:
                idx = int(self._hdr[0] % self.capacity)
                out = self._read_slot(idx)
                self._hdr[0] += 1
        finally:
            self._free.release()
        return out

    def _read_slot(self, idx):
        kind = int(self._kind[idx])
        seq = int(self._seq[idx])
        t_enq = float(self._t_enq[idx])
        if kind in (KIND_STOP, KIND_ABORT):
            return kind, seq, None, t_enq
        n = int(self._nbytes[idx])
        raw = bytes(self._payload[idx, :n])
        if kind == KIND_RAW:
            ndim = int(self._ndim[idx])
            shape = tuple(int(s) for s in self._shape[idx, :ndim])
            dtype = np.dtype(self._dtype[idx].decode())
            payload = np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
        else:
            payload = pickle.loads(raw)
        return kind, seq, payload, t_enq

    # ------------------------------------------------------------ misc
    def qsize(self) -> int:
        """Approximate items currently queued (racy but monotonic
        counters, so never negative)."""
        return max(0, int(self._hdr[1]) - int(self._hdr[0]))

    def flush(self) -> int:
        """Drop everything currently queued; returns the count."""
        n = 0
        while True:
            try:
                self.get(timeout=0)
                n += 1
            except Empty:
                return n

    def close(self) -> None:
        """Detach this process's mapping (workers on exit)."""
        if not self._closed:
            self._closed = True
            # views alias the mmap; drop them before closing it
            for attr in ("_hdr", "_seq", "_kind", "_t_enq", "_nbytes",
                         "_ndim", "_dtype", "_shape", "_payload"):
                setattr(self, attr, None)
            self._shm.close()

    def destroy(self) -> None:
        """Owner-side teardown: detach and unlink the segment."""
        self.close()
        if multiprocessing.current_process().pid == self._owner_pid:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass
