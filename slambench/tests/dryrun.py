"""A throwaway checkout for CPU runs of the harness: `BENCHMARK.json` and
the files under `slambench/` that a run resolves by name, with each cell
cut to `small_test_config` sizes and a few frames.  Built from files
alone: nothing of the real benchmark is edited."""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

from intensity_slam_tpu_torch import config as pconfig
from slambench import spec

SMALL = dataclasses.asdict(pconfig.small_test_config())
TRAFFIC = {
    "tiny_replay": {"kind": "islog_stream", "pacing": "closed", "frames": 4,
                    "warm_frames": 2, "trace_from": 2, "trace_frames": 2},
    "tiny_live": {"kind": "islog_stream", "pacing": "open", "frames": 14, "rate_hz": 50.0,
                  "warm_frames": 8, "trace_frames": 2},
}
CELLS = {"tiny.replay": ("tiny_replay", "os0_64.circuit_replay"),
         "tiny.live": ("tiny_live", "os0_64.circuit_live_10hz")}
# a window long enough for a replay's second pass, whose steps are checked
SECONDS = {"tiny.replay": 6.0, "tiny.live": 1.0}


def make(root: str) -> dict:
    """Write the throwaway checkout under `root`; returns its benchmark."""
    real = spec.load_benchmark()
    base = os.path.join(root, "slambench")
    for sub in ("kinds", "metrics"):
        shutil.copytree(os.path.join(spec.HERE, sub), os.path.join(base, sub))
    for sub in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    cfg = {"name": "tiny", "slam": SMALL, "reduced": [], "assumed": {}}
    with open(os.path.join(base, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    workloads = []
    for cell, (traffic, like) in CELLS.items():
        real_cell = spec.Cell(real, like)
        mix = dict(real_cell.traffic, **TRAFFIC[traffic])
        with open(os.path.join(base, "traffic", f"{traffic}.json"), "w") as f:
            json.dump(mix, f)
        with open(os.path.join(base, "limits", f"{cell}.json"), "w") as f:
            json.dump(real_cell.limits, f)
        workloads.append({"name": cell, "config": "tiny", "traffic": traffic, "chips": 1,
                          "why": "a CPU dry run"})
    names = [w["name"] for w in workloads]
    bench = dict(real, configs=[{"name": "tiny", "source": "small_test_config",
                                 "file": "slambench/configs/tiny.json", "reduced": [],
                                 "why": "a CPU dry run"}],
                 workloads=workloads)
    like = {real_cell: cell for cell, (_, real_cell) in CELLS.items()}
    for group in ("end_to_end", "per_layer"):
        bench[group] = [dict(m, workloads=[like[w] for w in m["workloads"]])
                        if "workloads" in m else m for m in real[group]]
    assert all(w in names for m in bench["per_layer"] for w in m["workloads"])
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return bench
