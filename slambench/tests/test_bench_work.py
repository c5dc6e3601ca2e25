"""The yardstick's operation and byte counts at small shapes, against
counts made by hand."""

import pytest

from slambench import work


def test_pgo_counts_by_hand():
    # K = 2 keyframes: n = 12; 1 loop slot, 1 damping, 1 iteration
    w = work.pgo(2, 1, loop_slots=1, dampings=1)
    gram = 4 * 2 * 216                  # 4 block products of 6x6x6 multiply-adds
    assert w.flops == pytest.approx(gram + 12 ** 3 / 3 + 2 * 144)
    assert w.bytes == 1 * 2 * 36 * 4 + 144 * 4 + 3 * 144 * 4
    # three dampings and three iterations scale the factor and the solves
    w3 = work.pgo(2, 3, loop_slots=1, dampings=3)
    assert w3.flops == pytest.approx(3 * (gram + 3 * 12 ** 3 / 3 + 3 * 2 * 144))


def test_pgo_at_the_configured_size_is_bound_by_operations():
    w = work.pgo(1024, 3)
    peaks = work.PEAKS["NVIDIA H100 80GB HBM3"]
    assert w.flops / peaks.fp32_flops > w.bytes / peaks.bytes_per_s
    assert w.least_s(peaks) == pytest.approx(w.flops / 67e12)


def test_knn_counts_by_hand():
    w = work.knn_queries(2, cells=1, slots=3, k=1)
    assert w.flops == 2 * 3 * 8
    assert w.bytes == 2 * (3 + 9) * 4 + 2 * (3 + 1) * 4


def test_mapping_counts_by_hand():
    cfg = {"mapping": {"max_query_points": 4, "knn_neighborhood": 2, "cell_capacity": 1,
                       "knn": 1, "gn_iters": 2, "use_corner_residuals": False}}
    w = work.mapping(cfg)
    assert w.flops == 4 * 2 * 1 * 8 + 4 * work.PLANE_FIT + 2 * 4 * work.PLANE_RES
    assert w.bytes == 4 * (3 + 6) * 4 + 4 * 4 * 4
    cfg["mapping"]["use_corner_residuals"] = True
    wc = work.mapping(cfg)
    assert wc.flops == w.flops + 2 * 16 + 2 * work.LINE_FIT + 2 * 2 * work.LINE_RES


def test_share():
    peaks = work.Peaks(1e3, 1e3)
    w = work.Work(flops=10, bytes=5)
    assert work.share(w, [0.02, 0.02], peaks) == pytest.approx(50.0)
    assert work.share(w, [], peaks) is None
    assert work.share(w, [0.02], None) is None
