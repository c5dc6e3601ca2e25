"""What the harness reads from a trace, on made-up events: busy and window
seconds, the top device operations, idle gaps by the host operation across
them, and the device seconds between a layer's marker bursts."""

import pytest

from slambench import trace

MS = 1_000_000


def dev(name, a, b):
    return (True, name, a * MS, b * MS, 0)


def host(name, a, b):
    return (False, name, a * MS, b * MS, 1)


def test_busy_window_ops_and_gaps():
    ev = [host(trace.WINDOW, 0, 10), host("cudaGraphLaunch", 0, 1),
          host("aten::item", 4, 6),
          dev("k1", 1, 3), dev("k2", 2, 4), dev("k1", 6, 7)]
    s = trace.summarize(ev)
    assert s["window_s"] == pytest.approx(0.010)
    assert s["busy_s"] == pytest.approx(0.004)
    assert s["device_ops"][0] == ["k1", pytest.approx(0.003)]
    gaps = dict(s["idle_gaps"])
    assert gaps["aten::item"] == pytest.approx(0.002)       # the gap 4-6 ms
    assert gaps["cudaGraphLaunch"] == pytest.approx(0.001)  # the gap 0-1 ms
    assert gaps["idle"] == pytest.approx(0.003)             # 7-10 ms


def test_marked_layers():
    spin = trace.SPIN + "(long)"
    ev = [host(trace.WINDOW, 0, 100),
          dev(spin, 0, 1), dev("a", 1, 5), dev("b", 6, 8), dev(spin, 8, 9),   # mapping
          dev("c", 10, 11),
          dev(spin, 20, 21), dev(spin, 21, 22), dev(spin, 22, 23),            # pgo opens
          dev("d", 23, 43),
          dev(spin, 43, 44), dev(spin, 44, 45), dev(spin, 45, 46),            # pgo closes
          dev("e", 50, 51)]
    layers = trace.summarize(ev)["layers"]
    assert layers["mapping"] == [pytest.approx(0.006)]
    assert layers["pgo"] == [pytest.approx(0.020)]
    assert all(n[0] != spin for n in trace.summarize(ev)["device_ops"])


def test_mark_wraps_and_keeps_the_result():
    import types
    mod = types.SimpleNamespace(f=lambda x, y=1: x + y)
    trace.mark(mod, "f", "pgo")
    assert mod.f(2, y=3) == 5 and mod.f.__wrapped__(2) == 3
