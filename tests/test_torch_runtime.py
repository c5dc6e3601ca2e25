"""The port's native-runtime wrappers (`intensity_slam_tpu_torch/runtime/
{native,scanlog,channel,traj}.py`), the mirror of tests/test_runtime.py,
plus the two packages against each other: a log written by either reads
back through the other's `ScanLog`, and the port's `stream_wire` frames
equal the reference's byte for byte.  Each package opens the log through
its own copy of the library; no handle crosses between them.
"""

import os
import threading

import numpy as np
import pytest

from intensity_slam_tpu.runtime import scanlog as JLog
from intensity_slam_tpu_torch.runtime import (
    Channel, Prefetcher, ScanLog, ScanLogWriter, TrajectoryWriter, native)

H, W = 8, 16
N = H * W


def _write_log(path, frames=5, gt=False, writer=ScanLogWriter, base=0.0):
    rng = np.random.RandomState(0)
    data = []
    with writer(str(path), H, W, ground_truth=gt) as w:
        for k in range(frames):
            xyz = (rng.randn(N, 3) * 20).astype(np.float32)
            inten = (rng.rand(N) * 300).astype(np.float32)
            gt_q = np.array([1, 0, 0, 0], np.float32) if gt else None
            gt_t = np.float32([k, 0, 0]) if gt else None
            w.append(base + 0.1 * k, xyz, inten, gt_q, gt_t)
            data.append((base + 0.1 * k, xyz, inten, gt_t))
    return data


def test_library_is_the_port_s_own_build():
    lib = native.lib()
    assert os.path.samefile(lib._name, native.LIBRARY)
    assert os.path.basename(os.path.dirname(native.LIBRARY)) == "_build"
    assert "native/build" not in native.LIBRARY.replace(os.sep, "/")


def test_scanlog_roundtrip(tmp_path):
    path = tmp_path / "a.islog"
    data = _write_log(path, frames=5)
    with ScanLog(str(path)) as log:
        assert (log.height, log.width, len(log)) == (H, W, 5)
        for k, (ts, xyz, inten, _) in enumerate(data):
            fr = log[k]
            assert fr.timestamp == pytest.approx(ts)
            np.testing.assert_array_equal(fr.xyz, xyz)
            np.testing.assert_array_equal(fr.intensity, inten)
            assert fr.gt_q is None
        with pytest.raises(IndexError):
            log[5]


def test_scanlog_ground_truth(tmp_path):
    path = tmp_path / "b.islog"
    data = _write_log(path, frames=3, gt=True)
    with ScanLog(str(path)) as log:
        for k in range(3):
            fr = log[k]
            np.testing.assert_array_equal(fr.gt_t, data[k][3])
            np.testing.assert_array_equal(fr.gt_q, np.array([1, 0, 0, 0], np.float32))


def test_prefetcher_streams_in_order(tmp_path):
    path = tmp_path / "c.islog"
    data = _write_log(path, frames=20)
    with ScanLog(str(path)) as log:
        seen = [(fr.index, fr.xyz.copy()) for fr in log.stream(depth=3)]
        assert [k for k, _ in seen] == list(range(20))
        for k, xyz in seen:
            np.testing.assert_array_equal(xyz, data[k][1])


def test_prefetcher_subrange(tmp_path):
    path = tmp_path / "d.islog"
    _write_log(path, frames=10)
    with ScanLog(str(path)) as log:
        with Prefetcher(log, 3, 7, depth=2) as pf:
            assert [fr.index for fr in pf] == [3, 4, 5, 6]


def test_channel_fifo_and_drop():
    dt = np.dtype([("kf", np.int64), ("t", np.float32, 3)])
    ch = Channel(capacity=2, dtype=dt)
    r = np.zeros((), dt)
    for k in range(2):
        r["kf"] = k
        assert ch.push(r)
    r["kf"] = 2
    assert not ch.push(r)                      # full
    assert ch.push(r, drop_oldest=True)        # drops kf=0
    assert ch.dropped == 1
    assert int(ch.pop()["kf"]) == 1
    assert int(ch.pop()["kf"]) == 2
    assert ch.pop(timeout_ms=10) is None       # timeout
    ch.destroy()


def test_channel_cross_thread():
    dt = np.dtype([("v", np.int64)])
    ch = Channel(capacity=8, dtype=dt)
    got = []

    def consumer():
        while True:
            r = ch.pop(timeout_ms=2000)
            if r is None:
                return
            got.append(int(r["v"]))

    th = threading.Thread(target=consumer)
    th.start()
    for v in range(50):
        rec = np.zeros((), dt)
        rec["v"] = v
        while not ch.push(rec):
            pass
    ch.close()
    th.join()
    assert got == list(range(50))
    ch.destroy()


def test_traj_writer(tmp_path):
    path = tmp_path / "traj.tum"
    with TrajectoryWriter(str(path)) as w:
        for k in range(4):
            w.append(float(k), np.float32([k, 0, 0]), np.float32([1, 0, 0, 0]))
        w.close()
        with pytest.raises(ValueError):
            w.append(5.0, np.float32([0, 0, 0]), np.float32([1, 0, 0, 0]))
    rows = [line.split() for line in path.read_text().splitlines()]
    assert len(rows) == 4
    assert [float(r[1]) for r in rows] == [0, 1, 2, 3]
    assert rows[0][7] == "1.000000"  # qw last (TUM order)


@pytest.mark.parametrize("written_by", ["port", "reference"])
def test_logs_cross_read(tmp_path, written_by):
    """A log written by either package reads back through the other's
    ScanLog (each opens the file with its own library copy)."""
    path = tmp_path / "x.islog"
    writer = ScanLogWriter if written_by == "port" else JLog.ScanLogWriter
    data = _write_log(path, frames=4, gt=True, writer=writer)
    for reader in (ScanLog, JLog.ScanLog):
        with reader(str(path)) as log:
            assert (log.height, log.width, len(log), log.flags) == (H, W, 4, 1)
            for k, (ts, xyz, inten, gt_t) in enumerate(data):
                fr = log[k]
                assert fr.timestamp == ts
                np.testing.assert_array_equal(fr.xyz, xyz)
                np.testing.assert_array_equal(fr.intensity, inten)
                np.testing.assert_array_equal(fr.gt_t, gt_t)


@pytest.mark.parametrize("base", [0.0, 1.7e9])
def test_stream_wire_equals_the_reference_s(tmp_path, base):
    """The port's wire frames (native WirePrefetcher through the port's
    library) equal the reference's byte for byte, epoch stamps included,
    over a sub-range."""
    path = tmp_path / "w.islog"
    _write_log(path, frames=6, base=base)
    with ScanLog(str(path)) as tlog:
        got = list(tlog.stream_wire(1, 6, depth=2, max_range=120.0))
    with JLog.ScanLog(str(path)) as jlog:
        want = list(jlog.stream_wire(1, 6, depth=2, max_range=120.0))
    assert [g.index for g in got] == [w.index for w in want] == [1, 2, 3, 4, 5]
    for g, w in zip(got, want):
        assert g.timestamp == w.timestamp
        assert g.packed.dtype == w.packed.dtype == np.uint16
        assert g.packed.tobytes() == w.packed.tobytes()
