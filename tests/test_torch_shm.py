"""The port's shared-memory frame ring (``repro_torch.pipeline.shm``), a
copy of ``repro.pipeline.shm``: the reference's cases (payload
round-trips, sentinel kinds, bounded-capacity blocking semantics, and a
real cross-process producer/consumer over one segment) on the port's
ring, and the wire constants equal to the reference's."""
import numpy as np
import pytest

import repro.pipeline.shm as jshm
from repro_torch.pipeline import shm
from repro_torch.pipeline.shm import (
    KIND_ABORT,
    KIND_PICKLE,
    KIND_RAW,
    KIND_STOP,
    ShmRingQueue,
    fork_context,
)


@pytest.fixture
def ring():
    q = ShmRingQueue(capacity=4, slot_bytes=4096)
    yield q
    q.destroy()


def test_ndarray_raw_roundtrip(ring):
    for dtype in (np.float64, np.float32, np.int32, np.uint8):
        arr = (np.arange(24, dtype=dtype) * 3).reshape(2, 3, 4)
        ring.put(7, arr)
        kind, seq, out, _ = ring.get(timeout=1.0)
        assert kind == KIND_RAW
        assert seq == 7
        assert out.dtype == arr.dtype and out.shape == arr.shape
        np.testing.assert_array_equal(out, arr)


def test_zero_size_and_scalar_arrays(ring):
    for arr in (np.empty((0, 3)), np.array(5.0)):
        ring.put(1, arr)
        _, _, out, _ = ring.get(timeout=1.0)
        assert out.shape == arr.shape
        np.testing.assert_array_equal(out, arr)


def test_python_object_pickle_roundtrip(ring):
    payload = {"tok": [1, 2, 3], "meta": ("x", 4.5), "none": None}
    ring.put(3, payload, t_enq=12.25)
    kind, seq, out, t_enq = ring.get(timeout=1.0)
    assert kind == KIND_PICKLE
    assert (seq, out, t_enq) == (3, payload, 12.25)


def test_sentinels_carry_no_payload(ring):
    ring.put_sentinel(KIND_STOP)
    ring.put_sentinel(KIND_ABORT)
    assert ring.get(timeout=1.0)[0] == KIND_STOP
    assert ring.get(timeout=1.0)[0] == KIND_ABORT


def test_full_and_empty_on_timeout(ring):
    with pytest.raises(shm.Empty):
        ring.get(timeout=0.05)
    for i in range(4):  # capacity
        ring.put(i, i)
    assert ring.qsize() == 4
    with pytest.raises(shm.Full):
        ring.put(4, 4, timeout=0.05)
    assert ring.get(timeout=1.0)[1] == 0  # FIFO
    ring.put(4, 4, timeout=1.0)           # slot freed -> accepted


def test_oversized_payload_rejected(ring):
    with pytest.raises(ValueError, match="slot_bytes"):
        ring.put(0, np.zeros(4096, dtype=np.float64))
    big = b"x" * 8192
    with pytest.raises(ValueError, match="slot_bytes"):
        ring.put(0, big)
    # the failed put must not leak its free slot: capacity still intact
    for i in range(4):
        ring.put(i, i, timeout=1.0)
    assert ring.qsize() == 4


def test_flush_discards_backlog(ring):
    for i in range(3):
        ring.put(i, i)
    assert ring.flush() == 3
    assert ring.qsize() == 0
    with pytest.raises(shm.Empty):
        ring.get(timeout=0.05)


def test_cross_process_transfer():
    ctx = fork_context()
    q = ShmRingQueue(capacity=8, slot_bytes=4096, ctx=ctx)
    try:
        def produce():
            for i in range(20):
                q.put(i, np.full(5, i, dtype=np.float64), timeout=5.0)
            q.put_sentinel(KIND_STOP, timeout=5.0)

        p = ctx.Process(target=produce)
        p.start()
        got = []
        while True:
            kind, seq, payload, _ = q.get(timeout=10.0)
            if kind == KIND_STOP:
                break
            got.append((seq, payload))
        p.join(10.0)
        assert p.exitcode == 0
        assert [s for s, _ in got] == list(range(20))
        for seq, payload in got:
            np.testing.assert_array_equal(
                payload, np.full(5, seq, dtype=np.float64))
    finally:
        q.destroy()


def test_constants_and_layout_match_reference():
    names = [n for n in dir(jshm) if n.isupper()]
    assert names and names == [n for n in dir(shm) if n.isupper()]
    for n in names:
        assert getattr(shm, n) == getattr(jshm, n), n
    ours = ShmRingQueue(capacity=3, slot_bytes=256)
    ref = jshm.ShmRingQueue(capacity=3, slot_bytes=256)
    try:
        assert ours._shm.size == ref._shm.size
        for q in (ours, ref):
            q.put(5, np.arange(6, dtype=np.int16).reshape(2, 3), t_enq=1.5)
        a, b = ours.get(timeout=1.0), ref.get(timeout=1.0)
        assert a[:2] == b[:2] and a[3] == b[3]
        np.testing.assert_array_equal(a[2], b[2])
    finally:
        ours.destroy()
        ref.destroy()
