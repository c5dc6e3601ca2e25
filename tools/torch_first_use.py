#!/usr/bin/env python3
"""What a process pays the first time it runs the port's graphed frame on
one GPU, and what an attached profiler costs its replays.

    python3 tools/torch_first_use.py [--out RESULTS_torch_first_use.json]

Each part runs in a fresh Python process, so that nothing is set up before
it:

- `system`: the kernels' builds (`nvcc`, when the checkout has none yet),
  then `SlamSystem` on the full-width slice of `chip_smoke.py` (the
  38-frame out-and-back at SlamConfig() widths): the first frame (it runs
  eagerly, warms the keyframe regions up with their predicates forced and
  captures the frame graph), its `warmup_s` by region and `capture_s`, then
  two replayed frames;
- `calls`: the first calls on the keyframe branch's PGO path one by one,
  each synchronized: a first kernel (the CUDA context), `cholesky_ex` on
  three 6144² matrices (cuSOLVER), `solve_triangular` (cuBLAS), a 6144²
  GEMM, `torch.func.jvp` of `torch.sin` and of a function with a Python
  scalar in it, each twice, then `posegraph.optimize` three times
  at product scale (1024 nodes, 200 loop edges,
  `tools/torch_multiproc_product.py`'s state);
- `cupti` (twice: `TEARDOWN_CUPTI` unset, then 1): the slice's frame graph
  replayed bare from the same state (median of ten, each synchronized,
  the state set back between them) before and after one
  `torch.profiler` trace, then six back-to-back traces of one replay and
  the device events each saw.

Prints each part's lines with the card's name and power limit and writes
them as JSON.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "RESULTS_torch_first_use.json")
PARTS = (("system", {}), ("calls", {}), ("cupti", {"TEARDOWN_CUPTI": None}),
         ("cupti", {"TEARDOWN_CUPTI": "1"}))


def _slice(dev):
    import chip_smoke
    from intensity_slam_tpu_torch import config
    from intensity_slam_tpu_torch.io import synthetic
    from intensity_slam_tpu_torch.utils import se3
    cfg = chip_smoke.slice_config(config.SlamConfig())
    traj = chip_smoke.loop_trajectory()
    xyz, inten = synthetic.render_sequence(
        se3.Pose(traj.q.to(dev), traj.t.to(dev)), synthetic.corridor_world(device=dev),
        cfg.sensor)
    return cfg, xyz, inten


def _timed(fn) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def part_system(dev) -> dict:
    import chip_smoke
    from intensity_slam_tpu_torch.pipeline.system import SlamSystem
    builds = {}
    for mod in (chip_smoke.pallas_nn, chip_smoke.eigsym, chip_smoke.svd3,
                chip_smoke.graph_cond):
        t0 = time.perf_counter()
        mod.build()
        builds[mod.__name__.rsplit(".", 1)[-1]] = time.perf_counter() - t0
    cfg, xyz, inten = _slice(dev)
    system = SlamSystem(cfg, device=dev)
    first = _timed(lambda: system.process(xyz[0], inten[0], 0.0))
    later = [1e3 * _timed(lambda k=k: system.process(xyz[k], inten[k], 0.1 * k))
             for k in (1, 2)]
    return {"kernel_builds_s": builds, "first_frame_s": first,
            "warmup_s": dict(system.graph.warmup_s),
            "capture_s": dict(system.graph.capture_s), "next_frames_ms": later}


def part_calls(dev) -> dict:
    import torch
    from torch.func import jvp
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch_multiproc_product as product
    from intensity_slam_tpu_torch.pipeline import posegraph
    n = 6144
    eye = torch.eye(n, device=dev)[None].repeat(3, 1, 1)
    rhs = torch.ones(3, n, 1, device=dev)
    factor = []
    x = torch.zeros(1024, 6, device=dev)
    calls = [("first kernel (CUDA context)", lambda: torch.zeros(8, device=dev).add_(1)),
             ("cholesky_ex, 3 x 6144^2 (cuSOLVER)",
              lambda: factor.append(torch.linalg.cholesky_ex(eye)[0])),
             ("solve_triangular (cuBLAS)",
              lambda: torch.linalg.solve_triangular(factor[0], rhs, upper=False)),
             ("6144^2 GEMM", lambda: eye[0] @ eye[0]),
             ("torch.func.jvp of torch.sin", lambda: jvp(torch.sin, (x,), (torch.ones_like(x),))),
             ("torch.func.jvp of sin(v) * 2.0",
              lambda: jvp(lambda v: torch.sin(v) * 2.0, (x,), (torch.ones_like(x),)))]
    out = {}
    for name, fn in calls:
        out[name] = [_timed(fn), _timed(fn)]
    cfg = product.product_config(False)
    g = product.synth_product_state(cfg, device=dev).graph
    lc = cfg.loop
    kw = dict(gn_iters=lc.pgo_gn_iters, odo_noise=lc.odom_noise,
              loop_cauchy_c=lc.loop_cauchy_c, drift_rate=lc.loop_drift_rate,
              drift_rot_rate=lc.loop_drift_rot_rate)
    out["posegraph.optimize, 1024 nodes, 200 loops"] = [
        _timed(lambda: posegraph.optimize(g, **kw)) for _ in range(3)]
    return {"seconds_first_second": out}


def part_cupti(dev) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from intensity_slam_tpu_torch.pipeline.system import SlamSystem
    cfg, xyz, inten = _slice(dev)
    system = SlamSystem(cfg, device=dev)
    for k in range(3):
        system.process(xyz[k], inten[k], 0.1 * k)
    graph = system.graph.segments.graphs["frame"]
    start = system.snapshot()       # every replay from the same state: the same work

    def replay_ms():
        out = []
        for _ in range(10):
            system.graph.adopt(start)
            out.append(1e3 * _timed(graph.replay))
        return statistics.median(out)

    def trace():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        return sum(1 for e in prof.events() if e.device_type.name == "CUDA")

    before = replay_ms()
    first = trace()
    after = replay_ms()
    return {"TEARDOWN_CUPTI": os.environ.get("TEARDOWN_CUPTI"),
            "replay_ms_before_a_trace": before, "replay_ms_after_it": after,
            "events_first_trace": first,
            "events_six_traces_back_to_back": [trace() for _ in range(6)]}


def run_part(name: str) -> int:
    import torch
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda", 0)
    res = {"system": part_system, "calls": part_calls, "cupti": part_cupti}[name](dev)
    print(json.dumps(res), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=str, default=OUT)
    ap.add_argument("--part", type=str, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.part:
        return run_part(args.part)
    import torch
    if not torch.cuda.is_available():
        print("torch_first_use.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from intensity_slam_tpu_torch.utils import device as devices
    card = devices.describe("cuda")
    print(card, flush=True)
    res = {"device": card, "parts": []}
    for name, env in PARTS:
        penv = {k: v for k, v in os.environ.items() if k not in env}
        penv.update({k: v for k, v in env.items() if v is not None})
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--part", name],
                              env=penv, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"part {name} {env} failed ({proc.returncode}):\n"
                               f"{proc.stderr[-4000:]}")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        row["part"] = name
        print(f"{name} {env}: {json.dumps(row)} [{card}]", flush=True)
        res["parts"].append(row)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(f"results -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
