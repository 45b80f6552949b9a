"""Streaming pipeline runtime — the StreamPU analogue, the port's
counterpart of ``repro.pipeline.runtime``.

Executes a scheduled pipeline (repro_torch.pipeline.planner.PipelinePlan) as a
host-driven streaming system:

  - one worker per stage *replica*, on one of two executors:
    ``executor="thread"`` (the default: cheap, in-process, fine for
    sleep-simulated chains and IO/GIL-releasing stage fns) or
    ``executor="process"`` — real OS processes pulling frames from
    shared-memory ring queues (:mod:`repro_torch.pipeline.shm`), so CPU-bound
    pure-Python stage fns genuinely run in parallel instead of
    timeslicing one GIL;
  - bounded queues between stages; replicas of a stage PULL from a shared
    queue — natural work stealing, which is the straggler mitigation story:
    a slow replica simply takes fewer frames, the fast ones absorb load;
  - frames (microbatches / request batches) carry sequence ids so the sink
    restores ordering (the 'emit' sequential task);
  - throughput/period measured over the steady-state window;
  - elastic scaling: ``rebuild(plan)`` re-materializes stages from a new
    schedule *without stopping traffic* (live handoff, below), preserving
    the global sequence counter (used after simulated device loss and by
    the repro_torch.control governor's closed-loop re-planning).

Process workers pin their replica's core type (big-class replicas onto
the low half of the affinity mask, little-class onto the high half — a
no-op on hosts with fewer than two cores) and honor the plan's chosen
``FreqStage.freq`` for real when the runtime is built with
``enforce_freq=True``: a replica at frequency ``f`` duty-cycle throttles
itself so each frame costs ``busy/f`` wall seconds — the same 1/f
latency scaling the planner priced, now enforced by the worker itself
rather than simulated inside the stage fn. (Do not combine with
builders that already scale their own latency by 1/f, like the sim's
``sleep_stage_builder``.)

Rebuild — live handoff vs drain:

  ``rebuild(plan)`` defaults to ``mode="handoff"``: the new stage set
  (queues + workers) is stood up *alongside* the old one, the feed is
  fenced at a sequence id (frames below the fence drain through the old
  workers, frames at/above it flow through the new set), and a stop
  sentinel trailing the last fenced frame retires the old workers as
  their final frame clears — off the traffic path, in a background
  retirement thread. Traffic never stops: the only exclusion is the
  fence swap itself (microseconds, reported as ``stall_s``). The
  ``runtime/rebuild`` trace span therefore measures the old/new
  *overlap* window, not a stall. ``mode="drain"`` keeps the old
  stop-the-world behavior (stop, swap, restart) for A/B comparison —
  the reference's ``benchmarks/sched_perf.py`` gates the handoff's
  traffic stall against the measured drain.

Stage functions are arbitrary callables (stage fns that launch CUDA work
or plain Python for synthetic chains), so the same runtime executes both
the DVB-S2-style synthetic chains and per-layer LM stage functions. The
process executor uses the ``fork`` start method: stage fns, closures
and shm mappings are inherited, never pickled. CUDA cannot run in a child
forked after its parent initialised CUDA, so the process executor raises
``RuntimeError`` once ``torch.cuda.is_initialized()`` holds in the parent
(at construction and again before each fork); CUDA stage fns run on the
thread executor. It never falls back to threads on its own.

The runtime meters a stage as the wall time around ``spec.fn(payload)``.
A stage fn that launches asynchronous device work must wait for it (for
example ``torch.cuda.Stream.synchronize``) before it returns, or busy
time, the period and the metered energy measure launch time.

Observability — two complementary channels:

  - ``on_event`` callback, stable payload schema: every event carries
    ``t`` (monotonic ``time.perf_counter()`` seconds — the same clock
    the runtime measures periods with) and ``plan_seq`` (an integer
    plan-identity counter, 0 for the constructed stage set, incremented
    by every ``rebuild``), so external consumers can order events and
    correlate them with the plan that produced them. Events:
    ``start {t, plan_seq, stages}``, ``stop {t, plan_seq}``,
    ``rebuild {t, plan_seq, stages, mode, fence}`` (``plan_seq`` is the
    NEW plan's; a handoff rebuild emits only ``rebuild`` — no
    stop/start pair, the pipe never went down — while a drain rebuild
    keeps the historical ``stop``/``rebuild``/``start`` sequence).
  - an optional ``repro_torch.obs.Tracer``: each worker becomes a named
    ``{stage}/r{replica}`` trace row emitting one complete span per
    frame (cat ``"frame"``, args ``seq``/``wait_s``) and, from its
    second frame on, a ``runtime/handoff`` span (cat ``"runtime"``) from
    its last frame's end to this frame's start — both reusing the
    timestamps the busy-metering already takes. Process workers record
    into a process-local ring and ship it back over a pipe when they
    retire (stop or rebuild); the parent merges it into the session
    tracer via ``Tracer.ingest``, so the trace report's stage
    rows, ``queue_wait_s`` and rebuild accounting are identical on both
    backends. The ``runtime/rebuild`` span carries
    ``{mode, stall_s, fence}``: stall accounting sums ``stall_s`` (the
    traffic-visible exclusion), not the span duration (the overlap).

``run()`` stats additionally report ``queue_wait_s``: per
(stage, replica) time frames sat in that stage's input queue before
being picked up — the backpressure signal that distinguishes a slow
stage (high ``busy_s``) from a starved one downstream of a bottleneck.
"""
from __future__ import annotations

import dataclasses
import inspect
import os
import queue
import threading
import time
from typing import Any, Callable, Sequence

from . import shm as _shm


@dataclasses.dataclass
class StageSpec:
    name: str
    fn: Callable[[Any], Any]
    replicas: int = 1
    device_class: str = "big"
    # optional artificial per-frame delay per replica (straggler injection)
    delays: Sequence[float] = ()
    # optional wall-clock energy metering (watts while executing / waiting);
    # leave at 0 to disable the energy report for this stage
    busy_watts: float = 0.0
    idle_watts: float = 0.0
    # DVFS level this stage's replicas run at. Workers duty-cycle
    # throttle to it when < 1 (each frame costs busy/f wall seconds);
    # set by _specs_from_plan(enforce_freq=True), 1.0 = full speed.
    freq: float = 1.0
    # kernel variant the plan chose for this stage ("base" = the default
    # implementation). Set by _specs_from_plan from FreqStage.variant;
    # carried into frame trace spans so variant swaps are observable.
    variant: str = "base"


class _Sentinel:
    pass


_STOP = _Sentinel()


def _call_builder(builder: Callable, st) -> Callable:
    """Invoke a stage-fn builder as ``builder(start, end)`` or, when it
    accepts a third positional parameter, ``builder(start, end, stage)``
    — the stage object carries cores/ctype (and ``freq`` for DVFS plans),
    which simulation builders need to size their per-frame latencies.
    Only positional parameters count (``*args`` accepts the stage;
    keyword-only params and ``**kwargs`` don't change the call)."""
    try:
        params = list(inspect.signature(builder).parameters.values())
    except (TypeError, ValueError):
        return builder(st.start, st.end)
    if any(p.kind is p.VAR_POSITIONAL for p in params):
        return builder(st.start, st.end, st)
    positional = [p for p in params
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    if len(positional) >= 3:
        return builder(st.start, st.end, st)
    return builder(st.start, st.end)


def _affinity_pools(cpus: list[int],
                    core_map: dict | None) -> dict[str, list[int]]:
    """Per-class core-id pools from an explicit map or the halves policy.

    ``core_map`` is ``{"big": [ids...], "little": [ids...]}`` — the
    per-SoC override (e.g. ``repro_torch.configs.dvbs2.core_map``) for hosts
    whose clusters are NOT contiguous-low-half-first. Ids outside the
    current affinity mask are dropped; an empty surviving pool falls back
    to the whole mask. Without a map, the default policy stands: the low
    half of the mask is the big cluster, the high half the little one
    (clusters are contiguous in core numbering on the big.LITTLE SoCs
    the paper targets)."""
    if core_map is not None:
        avail = set(cpus)
        pools = {}
        for cls in ("big", "little"):
            pool = [c for c in core_map.get(cls, ()) if c in avail]
            pools[cls] = pool or cpus
        return pools
    half = (len(cpus) + 1) // 2
    return {"big": cpus[:half], "little": cpus[half:] or cpus}


def _pin_replica_core(device_class: str, ri: int,
                      core_map: dict | None = None) -> None:
    """Pin the calling process to one core of its replica's class.

    The per-class pools come from :func:`_affinity_pools` (explicit
    ``core_map`` override, or low-half-big / high-half-little by
    default). Replicas round-robin within their pool. No-op when the
    host exposes fewer than two cores or no affinity API."""
    try:
        cpus = sorted(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return
    if len(cpus) < 2:
        return
    pool = _affinity_pools(cpus, core_map)[device_class]
    try:
        os.sched_setaffinity(0, {pool[ri % len(pool)]})
    except OSError:
        pass


def _require_fork_safe() -> None:
    """Raise when forking would hand a child this process's CUDA context:
    a CUDA stage fn in such a child hangs or crashes."""
    import torch

    if torch.cuda.is_initialized():
        raise RuntimeError(
            "executor='process' forks its workers, and CUDA is initialised "
            "in this process: a forked child cannot use it. Run CUDA stage "
            "fns on executor='thread'.")


class _StageSet:
    """One *generation* of stage workers and their inter-stage queues.

    The runtime usually holds exactly one; during a live-handoff rebuild
    two (or more) coexist — the retiring set draining its fenced frames
    while the new set serves fresh traffic — all writing into the shared
    sink."""

    __slots__ = ("gen", "specs", "queues", "workers", "alive", "alive_lock",
                 "stats", "keys", "procs", "pipes")

    def __init__(self, gen: int, specs: list[StageSpec]):
        self.gen = gen
        self.specs = specs
        self.queues: list = []
        self.workers: list[threading.Thread] = []   # thread executor
        self.procs: list = []                       # process executor
        self.pipes: list = []      # parent (recv) pipe end per process
        self.alive = None          # per-stage live-replica counts
        self.alive_lock = None
        self.stats = None          # process executor: 3 doubles per worker
        self.keys: list[tuple[str, int]] = []  # worker idx -> (stage, ri)


class StreamingPipelineRuntime:
    def __init__(self, stages: Sequence[StageSpec], queue_depth: int = 8,
                 on_event: Callable[[str, dict], None] | None = None,
                 tracer=None, executor: str = "thread",
                 slot_bytes: int = 1 << 16, core_map: dict | None = None):
        if executor not in ("thread", "process"):
            raise ValueError(f"unknown executor {executor!r} "
                             "(expected 'thread' or 'process')")
        if executor == "process":
            _require_fork_safe()
        self.stages = list(stages)
        self.queue_depth = queue_depth
        self.on_event = on_event
        self.tracer = tracer         # repro_torch.obs.Tracer or None
        self.executor = executor
        self.slot_bytes = slot_bytes
        # optional explicit {"big": [core ids], "little": [core ids]}
        # affinity override for process workers (see _affinity_pools)
        self.core_map = core_map
        self._queues: list = []      # current input set's queues + [sink]
        self._threads: list[threading.Thread] = []  # live thread workers
        self._sets: list[_StageSet] = []            # live generations
        self._input: _StageSet | None = None        # set receiving frames
        self._sink = None            # queue.Queue | ShmRingQueue
        self._feed_lock = threading.Lock()   # fence point for handoff
        self._retire_threads: list[threading.Thread] = []
        self._replica_counts: dict[tuple[str, int], int] = {}
        self._busy_s: dict[tuple[str, int], float] = {}
        self._queue_wait_s: dict[tuple[str, int], float] = {}
        self._started = False
        self._next_seq = 0           # survives rebuild(): global frame ids
        self._last_fed_seq = -1      # last seq actually enqueued (feeder)
        self._plan_seq = 0           # plan identity; bumped per rebuild()
        self._ctx = None             # fork mp context (process executor)
        # from_plan wiring, so rebuild(plan) can re-materialize stages
        self._builder: Callable | None = None
        self._power = None
        self._enforce_freq = False

    def _emit(self, event: str, **payload):
        if self.on_event is not None:
            self.on_event(event, {"t": time.perf_counter(),
                                  "plan_seq": self._plan_seq, **payload})

    # ------------------------------------------------------------- workers
    def _worker_thread(self, ss: _StageSet, si: int, ri: int):
        spec = ss.specs[si]
        q_in = ss.queues[si]
        q_out = ss.queues[si + 1] if si + 1 < len(ss.specs) else None
        delay = spec.delays[ri] if ri < len(spec.delays) else 0.0
        throttle = (1.0 / spec.freq - 1.0) \
            if 0.0 < spec.freq < 1.0 - 1e-12 else 0.0
        tracer = self.tracer
        tracing = tracer is not None and tracer.enabled
        if tracing:
            tracer.set_thread_name(f"{spec.name}/r{ri}")
        span_extra = {} if spec.variant == "base" \
            else {"variant": spec.variant}
        key = (spec.name, ri)
        sink = self._sink
        t_prev = None       # the replica's last frame's t_done
        while True:
            item = q_in.get()
            if isinstance(item, _Sentinel):
                with ss.alive_lock:
                    ss.alive[si] -= 1
                    last = ss.alive[si] == 0
                if not last:
                    q_in.put(item)  # let sibling replicas see the stop signal
                elif q_out is not None:
                    # last replica out forwards the sentinel downstream so
                    # stages >= 1 terminate too (the sink queue never gets
                    # one: run()'s drain thread only expects frames)
                    q_out.put(item)
                return
            seq, payload, t_enq = item
            t_busy0 = time.perf_counter()
            if delay:
                time.sleep(delay)  # injected stragglers count as busy time
            result = spec.fn(payload)
            if throttle:
                # duty-cycle DVFS: stretch each frame to busy/f seconds
                time.sleep((time.perf_counter() - t_busy0) * throttle)
            t_done = time.perf_counter()
            self._busy_s[key] = (self._busy_s.get(key, 0.0)
                                 + t_done - t_busy0)
            # time the frame sat in this stage's input queue (enqueue to
            # pickup) — backpressure, as opposed to busy time
            self._queue_wait_s[key] = (self._queue_wait_s.get(key, 0.0)
                                       + t_busy0 - t_enq)
            self._replica_counts[key] = self._replica_counts.get(key, 0) + 1
            if tracing:
                # reuses the busy-metering timestamps: tracing-on cost on
                # the hot path is two ring appends per (frame, stage), the
                # frame's span and the hand-off since the replica's last
                if t_prev is not None:
                    tracer.complete("runtime/handoff", t_prev,
                                    t_busy0 - t_prev, cat="runtime",
                                    args={"seq": seq})
                tracer.complete(spec.name, t_busy0, t_done - t_busy0,
                                cat="frame",
                                args={"seq": seq, "wait_s": t_busy0 - t_enq,
                                      **span_extra})
            t_prev = t_done
            if q_out is not None:
                q_out.put((seq, result, t_done))
            else:
                sink.put((seq, result, t_done))

    def _worker_proc(self, ss: _StageSet, si: int, ri: int, widx: int, conn):
        # Forked child. Discipline: touch ONLY the shm rings, the shared
        # alive/stats arrays and our own pipe end. The parent's threading
        # locks, tracer registry, event callbacks and metering dicts are
        # copy-on-write ghosts here — mutating them would be invisible,
        # and taking the tracer's registry lock would be fork-unsafe.
        from repro_torch.obs.trace import _Ring

        spec = ss.specs[si]
        _pin_replica_core(spec.device_class, ri, self.core_map)
        delay = spec.delays[ri] if ri < len(spec.delays) else 0.0
        throttle = (1.0 / spec.freq - 1.0) \
            if 0.0 < spec.freq < 1.0 - 1e-12 else 0.0
        q_in = ss.queues[si]
        q_out = ss.queues[si + 1] if si + 1 < len(ss.specs) else None
        sink = self._sink
        tracer = self.tracer
        tracing = tracer is not None and tracer.enabled
        ring = _Ring(tracer.ring_size if tracing else 1, os.getpid())
        if tracing:
            ring.append(("M", f"{spec.name}/r{ri}",
                         time.perf_counter(), 0.0, "", None))
        stats = ss.stats
        base = 3 * widx
        t_prev = None       # the replica's last frame's t_done
        while True:
            try:
                kind, seq, payload, t_enq = q_in.get(timeout=1.0)
            except _shm.Empty:
                continue
            if kind == _shm.KIND_STOP:
                with ss.alive.get_lock():
                    ss.alive[si] -= 1
                    last = ss.alive[si] == 0
                if not last:
                    q_in.put_sentinel(_shm.KIND_STOP)
                elif q_out is not None:
                    q_out.put_sentinel(_shm.KIND_STOP)
                break
            if kind == _shm.KIND_ABORT:
                continue  # sink-only marker; never valid mid-pipe
            t_busy0 = time.perf_counter()
            if delay:
                time.sleep(delay)
            result = spec.fn(payload)
            if throttle:
                time.sleep((time.perf_counter() - t_busy0) * throttle)
            t_done = time.perf_counter()
            stats[base] += t_done - t_busy0
            stats[base + 1] += t_busy0 - t_enq
            stats[base + 2] += 1.0
            if tracing:
                args = {"seq": seq, "wait_s": t_busy0 - t_enq}
                if spec.variant != "base":
                    args["variant"] = spec.variant
                if t_prev is not None:
                    ring.append(("X", "runtime/handoff", t_prev,
                                 t_busy0 - t_prev, "runtime", {"seq": seq}))
                ring.append(("X", spec.name, t_busy0, t_done - t_busy0,
                             "frame", args))
            t_prev = t_done
            if q_out is not None:
                q_out.put(seq, result, t_done)
            else:
                sink.put(seq, result, t_done)
        # ship the trace ring to the parent, then exit without running
        # inherited atexit/teardown (we are a fork of a threaded parent)
        try:
            conn.send((ring.snapshot_and_clear(), ring.dropped))
            conn.close()
        except (OSError, ValueError, BrokenPipeError):
            pass
        os._exit(0)

    # ----------------------------------------------------------- stage sets
    def _fork_ctx(self):
        _require_fork_safe()
        if self._ctx is None:
            self._ctx = _shm.fork_context()
        return self._ctx

    def _make_sink(self):
        if self.executor == "thread":
            self._sink = queue.Queue()
        else:
            # roomy: stragglers from a timed-out run land here between
            # runs with nobody draining; capacity must absorb them
            self._sink = _shm.ShmRingQueue(
                capacity=max(4 * self.queue_depth, 64),
                slot_bytes=self.slot_bytes, ctx=self._fork_ctx())

    def _make_set(self, specs: list[StageSpec], gen: int) -> _StageSet:
        """Build queues + workers for one generation and start them."""
        ss = _StageSet(gen, specs)
        if self.executor == "thread":
            ss.queues = [queue.Queue(maxsize=self.queue_depth)
                         for _ in specs]
            ss.alive = [max(s.replicas, 1) for s in specs]
            ss.alive_lock = threading.Lock()
            for si, spec in enumerate(specs):
                for ri in range(max(spec.replicas, 1)):
                    t = threading.Thread(target=self._worker_thread,
                                         args=(ss, si, ri), daemon=True)
                    t.start()
                    ss.workers.append(t)
            with self._feed_lock:
                self._threads.extend(ss.workers)
        else:
            ctx = self._fork_ctx()
            ss.queues = [_shm.ShmRingQueue(capacity=self.queue_depth,
                                           slot_bytes=self.slot_bytes,
                                           ctx=ctx)
                         for _ in specs]
            ss.alive = ctx.Array("i", [max(s.replicas, 1) for s in specs])
            n_workers = sum(max(s.replicas, 1) for s in specs)
            ss.stats = ctx.RawArray("d", 3 * n_workers)
            widx = 0
            for si, spec in enumerate(specs):
                for ri in range(max(spec.replicas, 1)):
                    ss.keys.append((spec.name, ri))
                    recv_end, send_end = ctx.Pipe(duplex=False)
                    p = ctx.Process(target=self._worker_proc,
                                    args=(ss, si, ri, widx, send_end),
                                    daemon=True)
                    p.start()
                    send_end.close()
                    ss.procs.append(p)
                    ss.pipes.append(recv_end)
                    widx += 1
        return ss

    def _refresh_queues_alias(self):
        # compat view: the *current input* generation's queues + the sink
        self._queues = list(self._input.queues) + [self._sink] \
            if self._input is not None else []

    def _send_stop(self, ss: _StageSet):
        """Queue the stop sentinel behind ``ss``'s in-flight frames."""
        if not ss.queues:
            return
        if self.executor == "thread":
            ss.queues[0].put(_STOP)
        else:
            try:
                ss.queues[0].put_sentinel(_shm.KIND_STOP, timeout=5.0)
            except _shm.Full:
                pass  # wedged pipe; the join timeout will terminate it

    def _collect_procs(self, ss: _StageSet, timeout: float = 5.0):
        """Join process workers, absorbing their shipped trace rings."""
        tracer = self.tracer
        for proc, conn in zip(ss.procs, ss.pipes):
            try:
                if conn.poll(timeout):
                    records, dropped = conn.recv()
                    if tracer is not None and tracer.enabled and records:
                        tracer.ingest(records, tid=proc.pid or 0,
                                      dropped=dropped)
            except (EOFError, OSError):
                pass
            try:
                conn.close()
            except OSError:
                pass
            proc.join(timeout)
            if proc.is_alive():
                proc.terminate()
                proc.join(1.0)
        ss.procs = []
        ss.pipes = []

    def _fold_stats(self, ss: _StageSet):
        """Fold a retired process generation's shared-memory counters
        into the runtime's lifetime metering dicts (caller holds
        ``_feed_lock`` so a concurrent snapshot never double-counts)."""
        if ss.stats is None:
            return
        for widx, key in enumerate(ss.keys):
            b, w, c = (ss.stats[3 * widx], ss.stats[3 * widx + 1],
                       ss.stats[3 * widx + 2])
            if b:
                self._busy_s[key] = self._busy_s.get(key, 0.0) + b
            if w:
                self._queue_wait_s[key] = \
                    self._queue_wait_s.get(key, 0.0) + w
            if c:
                self._replica_counts[key] = \
                    self._replica_counts.get(key, 0) + int(c)
        ss.stats = None

    def _close_set_queues(self, ss: _StageSet):
        if self.executor == "process":
            for q in ss.queues:
                q.destroy()
        ss.queues = []

    def _stats_snapshot(self):
        """Lifetime (busy, wait, counts) dicts: the folded base plus the
        live process generations' shared counters."""
        with self._feed_lock:
            busy = dict(self._busy_s)
            wait = dict(self._queue_wait_s)
            counts = dict(self._replica_counts)
            for ss in self._sets:
                if ss.stats is None:
                    continue
                for widx, key in enumerate(ss.keys):
                    b, w, c = (ss.stats[3 * widx], ss.stats[3 * widx + 1],
                               ss.stats[3 * widx + 2])
                    if b:
                        busy[key] = busy.get(key, 0.0) + b
                    if w:
                        wait[key] = wait.get(key, 0.0) + w
                    if c:
                        counts[key] = counts.get(key, 0) + int(c)
        return busy, wait, counts

    # --------------------------------------------------------------- start
    def start(self):
        if self._started:
            return self
        self._make_sink()
        ss = self._make_set(self.stages, self._plan_seq)
        with self._feed_lock:
            self._sets = [ss]
            self._input = ss
        self._refresh_queues_alias()
        self._started = True
        self._emit("start", stages=[s.name for s in self.stages])
        return self

    # ----------------------------------------------------------------- run
    def _feed(self, seq: int, payload):
        """Enqueue one frame into the *current* input generation.

        The feed lock is the handoff fence: a rebuild swaps the input
        set and queues the old set's stop sentinel under this lock, so
        a frame can never land behind its generation's sentinel. Puts
        use a short timeout and retry so a full queue doesn't hold the
        fence hostage for more than one slot's wait."""
        while True:
            with self._feed_lock:
                ss = self._input
                try:
                    if self.executor == "thread":
                        ss.queues[0].put(
                            (seq, payload, time.perf_counter()),
                            timeout=0.1)
                    else:
                        ss.queues[0].put(seq, payload, time.perf_counter(),
                                         timeout=0.1)
                    self._last_fed_seq = seq
                    return
                except (queue.Full, _shm.Full):
                    continue

    def _flush_sink(self):
        if self.executor == "thread":
            while True:
                try:
                    self._sink.get_nowait()
                except queue.Empty:
                    break
        else:
            self._sink.flush()

    def _sink_get(self):
        """Next delivered frame as ``(seq, result)``; None on abort."""
        if self.executor == "thread":
            item = self._sink.get()
            if isinstance(item, _Sentinel):
                return None
            return item[0], item[1]
        kind, seq, payload, _ = self._sink.get()
        if kind == _shm.KIND_ABORT:
            return None
        return seq, payload

    def _abort_sink(self):
        if self.executor == "thread":
            self._sink.put(_Sentinel())
        else:
            self._sink.put_sentinel(_shm.KIND_ABORT)

    def run(self, frames: Sequence[Any], warmup: int = 0,
            timeout_s: float | None = None) -> dict:
        """Push frames through; returns outputs + timing stats.

        Sequence ids are drawn from a runtime-global counter, so ordering
        is preserved across ``rebuild()`` boundaries — including a
        rebuild *during* the run: in-flight frames drain through the old
        stage set, later frames flow through the new one, and the sink
        reorders by seq.

        ``timeout_s`` bounds the wait for the whole batch: frames not
        emitted by the deadline are reported as dropped (the ``outputs``
        come back short) instead of blocking forever — the liveness
        check the control-layer scenarios assert on. A timed-out run
        leaves stragglers in flight; those are counted dropped by THIS
        run and — should they surface later — ignored by subsequent
        runs (the drain admits only this batch's sequence range), so an
        in-flight frame is accounted exactly once, never double-counted
        across a rebuild."""
        if not self._started:
            self.start()
        busy0, wait0, counts0 = self._stats_snapshot()
        t0 = time.perf_counter()
        marks = {}
        # flush leftovers from a previous timed-out run (its abort
        # sentinel, or stragglers that landed after its deadline) so they
        # cannot be miscounted as this batch's output
        self._flush_sink()
        done = threading.Event()
        expected = len(frames)
        outs: list[tuple[int, Any]] = []
        seq0 = self._next_seq
        self._next_seq += expected

        def drain():
            while len(outs) < expected:
                item = self._sink_get()
                if item is None:
                    break  # timed out: give up on the stragglers
                seq, result = item
                if not seq0 <= seq < seq0 + expected:
                    continue  # straggler from an earlier timed-out batch
                if len(outs) == warmup:
                    marks["steady_start"] = time.perf_counter()
                outs.append((seq, result))
            marks["end"] = time.perf_counter()
            done.set()

        dr = threading.Thread(target=drain, daemon=True)
        dr.start()
        for i, f in enumerate(frames):
            self._feed(seq0 + i, f)
        if not done.wait(timeout_s):
            if not done.is_set():  # narrow the lost-race window: if the
                # drain finished at the deadline, don't orphan a sentinel
                self._abort_sink()  # unblock the drain thread
            done.wait()
        steady = marks["end"] - marks.get("steady_start", t0)
        n_steady = len(outs) - warmup  # == expected - warmup unless timed out
        outs.sort(key=lambda x: x[0])  # ordered emit
        total_s = marks["end"] - t0
        busy1, wait1, counts1 = self._stats_snapshot()
        busy_s = {k: v - busy0.get(k, 0.0) for k, v in busy1.items()
                  if v - busy0.get(k, 0.0) > 0.0}
        queue_wait_s = {
            k: v - wait0.get(k, 0.0) for k, v in wait1.items()
            if v - wait0.get(k, 0.0) > 0.0}
        # frames each (stage, replica) processed during THIS run — the
        # per-window denominator the governor's per-stage drift
        # recalibration divides busy_s by ("replica_counts" stays the
        # lifetime accumulation)
        replica_frames = {
            k: v - counts0.get(k, 0) for k, v in counts1.items()
            if v - counts0.get(k, 0) > 0}
        stats = {
            "outputs": [o for _, o in outs],
            "seq_ids": [s for s, _ in outs],
            "frames_dropped": expected - len(outs),
            "total_s": total_s,
            "period_s": steady / max(n_steady, 1),
            "throughput_fps": max(n_steady, 1) / steady if steady > 0 else 0.0,
            "replica_counts": counts1,
            "replica_frames": replica_frames,
            "busy_s": busy_s,
            "queue_wait_s": queue_wait_s,
        }
        if any(s.busy_watts or s.idle_watts for s in self.stages):
            stats["energy_j"] = self.measured_energy_j(total_s, busy_s)
            stats["avg_power_w"] = (
                stats["energy_j"] / total_s if total_s > 0 else 0.0)
        return stats

    def measured_energy_j(self, window_s: float,
                          busy_s: dict | None = None) -> float:
        """Wall-clock energy over ``window_s``: per-replica busy time at
        busy watts plus the remaining allocated time at idle watts.

        ``busy_s`` is the per-(stage, replica) busy-seconds map for the
        window; defaults to the runtime's lifetime accumulation."""
        if busy_s is None:
            busy_s, _, _ = self._stats_snapshot()
        total = 0.0
        for spec in self.stages:
            for ri in range(max(spec.replicas, 1)):
                busy = min(busy_s.get((spec.name, ri), 0.0), window_s)
                total += (busy * spec.busy_watts
                          + (window_s - busy) * spec.idle_watts)
        return total

    # ---------------------------------------------------------------- stop
    def stop(self):
        """Drain and terminate all workers.

        The stop sentinel enters each generation's first queue behind any
        in-flight frames (FIFO), circulates among that stage's replicas,
        and the last replica out forwards it downstream — so every queued
        frame is processed before the pipeline winds down, stage by
        stage. In-flight handoff retirements are allowed to finish
        first."""
        if self._started:
            for th in list(self._retire_threads):
                th.join(timeout=10.0)
            self._retire_threads = []
            with self._feed_lock:
                sets = list(self._sets)
            for ss in sets:
                self._send_stop(ss)
            for t in self._threads:
                t.join(timeout=2.0)
            self._threads = []
            for ss in sets:
                self._collect_procs(ss)
            with self._feed_lock:
                for ss in sets:
                    self._fold_stats(ss)
                    if ss in self._sets:
                        self._sets.remove(ss)
            for ss in sets:
                self._close_set_queues(ss)
            self._input = None
            if self.executor == "process" and self._sink is not None:
                self._sink.destroy()
                self._sink = None
        self._started = False
        self._emit("stop")

    # -------------------------------------------------------------- elastic
    @staticmethod
    def _specs_from_plan(plan, stage_fn_builder: Callable,
                         power=None, enforce_freq: bool = False
                         ) -> list[StageSpec]:
        """StageSpecs for a PipelinePlan(-like) object.

        DVFS plans (``plan.freq_solution`` set) are materialized from the
        frequency-annotated stages: busy watts are taken at each stage's
        level, and three-argument builders receive the FreqStage so they
        can scale latencies by 1/f. With ``enforce_freq`` the chosen
        frequency is instead driven into the workers themselves
        (duty-cycle throttling) — for real stage fns whose builders don't
        simulate DVFS.

        Variant plans (stages carrying a non-base ``FreqStage.variant``
        with a ``VariantSpec`` on the solution) instantiate the chosen
        implementation: if any task in the stage registered a callable
        factory for the chosen variant (``TaskVariant.fn``, same
        ``(start, end[, stage])`` calling convention as a stage builder),
        the first such factory builds the stage fn instead of the base
        builder; otherwise the base builder runs and can itself branch on
        ``stage.variant`` (three-argument builders see it)."""
        freq_solution = getattr(plan, "freq_solution", None)
        stages = freq_solution.stages if freq_solution is not None \
            else plan.solution.stages
        variants = getattr(freq_solution, "variants", None)
        specs = []
        for st in stages:
            variant = getattr(st, "variant", "base")
            builder = stage_fn_builder
            if variants is not None and variant != "base":
                for ti in range(st.start, st.end + 1):
                    vfn = variants.fn_for(plan.chain.names[ti], variant)
                    if vfn is not None:
                        builder = vfn
                        break
            fn = _call_builder(builder, st)
            freq = getattr(st, "freq", 1.0)
            specs.append(StageSpec(
                name=f"s{st.start}-{st.end}",
                fn=fn,
                replicas=st.cores if plan.chain.is_rep(st.start, st.end) else 1,
                device_class="big" if st.ctype == "B" else "little",
                busy_watts=power.busy_watts(st.ctype, freq) if power else 0.0,
                idle_watts=power.idle_watts(st.ctype) if power else 0.0,
                freq=freq if enforce_freq else 1.0,
                variant=variant,
            ))
        return specs

    def rebuild(self, plan, stage_fn_builder: Callable | None = None,
                mode: str = "handoff"):
        """Re-materialize stages from a new plan.

        ``mode="handoff"`` (default) — zero-drain live handoff: the new
        stage set is stood up alongside the old, the feed is fenced at a
        sequence id under the feed lock (the only traffic exclusion,
        reported as ``stall_s``), and the old workers retire in the
        background as their last fenced frame clears. Traffic, ordering
        and the global sequence counter are all preserved *through* the
        swap; the ``runtime/rebuild`` span measures the old/new overlap.

        ``mode="drain"`` — the historical stop-the-world path: ``stop()``
        lets every in-flight frame finish, then workers are rebuilt and
        restarted. Kept for A/B measurement (``sched_perf.py``'s
        ``runtime/rebuild`` family) and as a conservative fallback.

        ``stage_fn_builder`` defaults to the one captured by
        :meth:`from_plan`; runtimes constructed directly from StageSpecs
        must pass one.
        """
        builder = stage_fn_builder if stage_fn_builder is not None \
            else self._builder
        if builder is None:
            raise ValueError(
                "rebuild() needs a stage_fn_builder (none captured; "
                "construct via from_plan or pass one explicitly)")
        if mode not in ("handoff", "drain"):
            raise ValueError(f"unknown rebuild mode {mode!r}")
        tracer = self.tracer
        tracing = tracer is not None and tracer.enabled
        was_started = self._started
        t0 = time.perf_counter()
        if tracing and was_started:
            # frames queued at swap entry = what the old set still owes
            with self._feed_lock:
                depth = sum(q.qsize() for ss in self._sets
                            for q in ss.queues)
            tracer.counter("runtime/queue_depth", depth, ts=t0)
        self._builder = builder
        new_specs = self._specs_from_plan(plan, builder, self._power,
                                          self._enforce_freq)

        if not was_started or mode == "drain":
            if was_started:
                self.stop()
            self.stages = new_specs
            self._plan_seq += 1
            self._emit("rebuild", stages=[s.name for s in self.stages],
                       mode=mode, fence=self._next_seq)
            if was_started:
                self.start()
            if tracing:
                # the drain gap: stop-the-world from swap entry to restart
                dur = time.perf_counter() - t0
                tracer.complete(
                    "runtime/rebuild", t0, dur,
                    cat="control",
                    args={"plan_seq": self._plan_seq,
                          "stages": [s.name for s in self.stages],
                          "mode": "drain", "stall_s": dur,
                          "fence": self._next_seq})
                if was_started:
                    tracer.counter("runtime/queue_depth", 0)
            return self

        # ---- live handoff: overlap the generations, fence the feed ----
        ss_new = self._make_set(new_specs, self._plan_seq + 1)
        with self._feed_lock:
            t_fence = time.perf_counter()
            ss_old = self._input
            fence = self._last_fed_seq + 1
            self._sets.append(ss_new)
            self._input = ss_new
            stall_s = time.perf_counter() - t_fence
        # the sentinel trails the last fenced frame; queued outside the
        # fence lock so a full old queue can't stall fresh traffic
        self._send_stop(ss_old)
        self.stages = new_specs
        self._plan_seq += 1
        self._refresh_queues_alias()
        self._emit("rebuild", stages=[s.name for s in new_specs],
                   mode="handoff", fence=fence)
        plan_seq = self._plan_seq
        names = [s.name for s in new_specs]

        def retire():
            for t in ss_old.workers:
                t.join(timeout=10.0)
            self._collect_procs(ss_old, timeout=10.0)
            with self._feed_lock:
                self._fold_stats(ss_old)
                if ss_old in self._sets:
                    self._sets.remove(ss_old)
                if ss_old.workers:
                    dead = set(ss_old.workers)
                    self._threads = [t for t in self._threads
                                     if t not in dead]
            self._close_set_queues(ss_old)
            if tracing:
                # the overlap window: fence to last old worker retired
                t1 = time.perf_counter()
                tracer.complete(
                    "runtime/rebuild", t0, t1 - t0, cat="control",
                    args={"plan_seq": plan_seq, "stages": names,
                          "mode": "handoff", "fence": fence,
                          "stall_s": stall_s})
                tracer.counter("runtime/queue_depth",
                               sum(q.qsize() for q in ss_new.queues))

        th = threading.Thread(target=retire, daemon=True)
        th.start()
        self._retire_threads.append(th)
        return self

    @classmethod
    def from_plan(cls, plan, stage_fn_builder: Callable,
                  queue_depth: int = 8, power=None,
                  on_event: Callable[[str, dict], None] | None = None,
                  tracer=None, executor: str = "thread",
                  slot_bytes: int = 1 << 16, enforce_freq: bool = False,
                  core_map: dict | None = None,
                  ) -> "StreamingPipelineRuntime":
        """Materialize stage workers from a PipelinePlan.

        ``stage_fn_builder(start, end)`` returns the callable executing
        chain tasks [start, end]; builders accepting a third parameter are
        called as ``(start, end, stage)`` with the plan's Stage/FreqStage.
        Passing a ``repro_torch.energy.model.PowerModel`` as ``power`` enables
        wall-clock energy metering: each run() reports ``energy_j``
        (per-replica busy time at busy watts + allocated idle time at idle
        watts) next to the measured period. The builder and power model
        are captured so :meth:`rebuild` can re-materialize from a new
        plan.

        ``executor`` selects the worker substrate ("thread" or
        "process" — see the module docstring); ``slot_bytes`` sizes the
        process backend's shared-memory frame slots. ``enforce_freq``
        drives each stage's planned ``FreqStage.freq`` into its workers
        as duty-cycle throttling (don't combine with builders that
        already scale latency by 1/f, like the sim's
        ``sleep_stage_builder``). ``core_map`` overrides the process
        executor's big/little affinity pools with explicit core ids
        (e.g. ``repro_torch.configs.dvbs2.core_map``)."""
        rt = cls(cls._specs_from_plan(plan, stage_fn_builder, power,
                                      enforce_freq),
                 queue_depth=queue_depth, on_event=on_event, tracer=tracer,
                 executor=executor, slot_bytes=slot_bytes, core_map=core_map)
        rt._builder = stage_fn_builder
        rt._power = power
        rt._enforce_freq = enforce_freq
        return rt
