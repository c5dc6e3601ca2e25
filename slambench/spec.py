"""The benchmark as data: `BENCHMARK.json` at the root of the checkout, and
the files that its names lead to.

- A cell (`workloads[i]`) names a configuration and a traffic mix.
- A configuration is `configs[j]`, whose `file` holds the deployment.
- A traffic mix named `t` is `slambench/traffic/<t>.json`; its `kind` names
  the module `slambench/kinds/<kind>.py`, which renders the scans from the
  seed and drives the program's entry point.
- A per-layer metric named `m` is read by `slambench/metrics/<m>.py`.
- The limits that decide `correct` in a cell named `w` are
  `slambench/limits/<w>.json`.

Adding a cell, a configuration, a traffic mix or a metric is adding files
and entries: nothing here lists them."""

from __future__ import annotations

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_benchmark(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no BENCHMARK.json beside {HERE}")
    with open(path) as f:
        return json.load(f)


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{name!r} is not a benchmark name")
    return name


class Cell:
    """One workload of `BENCHMARK.json` with everything its names resolve to."""

    def __init__(self, bench: dict, workload: str, root: str = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"({sorted(cells)})")
        self.root = root
        self.base = os.path.join(root, "slambench")
        self.entry = cells[_checked(workload)]
        self.name = workload
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[_checked(self.entry["config"])]
        self.config = _read_json(os.path.join(root, self.config_entry["file"]))
        traffic = _checked(self.entry["traffic"])
        self.traffic_name = traffic
        self.traffic = _read_json(os.path.join(self.base, "traffic", f"{traffic}.json"))
        self.kind = _checked(self.traffic["kind"])
        self.limits = _read_json(os.path.join(self.base, "limits", f"{workload}.json"))
        self.end_to_end = [m for m in bench["end_to_end"] if reports(m, workload)]
        self.per_layer = [m for m in bench["per_layer"] if reports(m, workload)]
        self.chips = int(self.entry["chips"])

    def kind_module(self):
        return load_module(os.path.join(self.base, "kinds", f"{self.kind}.py"),
                           f"slambench_kind_{self.kind}")

    def metric(self, name: str):
        """The `read(run) -> float | None` of the per-layer metric `name`."""
        mod = load_module(os.path.join(self.base, "metrics", f"{_checked(name)}.py"),
                          "slambench_metric_" + name.replace(".", "_").replace("-", "_"))
        return mod.read


def reports(metric: dict, workload: str) -> bool:
    """Whether the cell `workload` reports `metric` (all cells where the
    metric lists none)."""
    return "workloads" not in metric or workload in metric["workloads"]


def load_module(path: str, name: str):
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
