"""`BENCHMARK.json` against the benchmark's rules, and every cell's files
found by name."""

import json
import os

import pytest

from slambench import spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            yield e["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


def test_keys_and_sizes():
    assert set(BENCH) == KEYS
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_name_characters(name):
    assert spec.NAME.match(name), name


def test_names_unique_and_units():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert spec.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds_and_sources():
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "bound" not in m


def test_every_layer_metric_moves_what_its_cells_report():
    for m in BENCH["per_layer"]:
        for cell in m.get("workloads", CELLS):
            reported = {e["name"] for e in BENCH["end_to_end"] if spec.reports(e, cell)}
            assert m["moves"] in reported, (m["name"], cell)
    for cell in CELLS:
        e2e = [e for e in BENCH["end_to_end"] if spec.reports(e, cell)]
        assert len(e2e) >= 2 and any(e["name"] == "setup_s" for e in e2e)
        assert any(spec.reports(m, cell) for m in BENCH["per_layer"])


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_resolve(workload):
    cell = spec.Cell(BENCH, workload)
    assert cell.kind_module().run
    for m in cell.per_layer:
        assert callable(cell.metric(m["name"]))
    from slambench import check
    assert "decisions" in cell.limits and set(cell.limits) <= set(check.NUMBERS)
    assert cell.config_entry["file"].startswith("slambench/")
    assert cell.config["name"] == cell.config_entry["name"]
    assert "assumed" in cell.config and cell.config["reduced"] == cell.config_entry["reduced"]


def test_paths_and_command():
    for p in BENCH["paths"]:
        assert os.path.isdir(os.path.join(spec.ROOT, p)) and not p.endswith("_torch")
    assert len(BENCH["command"]) <= 32
    assert all(not a.startswith("/") and ".." not in a for a in BENCH["command"])
