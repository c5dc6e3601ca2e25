#!/usr/bin/env python
"""B independent SLAM sessions on one card in one launch sequence: the
counterpart of `tools/scaling_multisession.py` for the PyTorch/CUDA port.

    python tools/torch_scaling_multisession.py [--device cuda] [--batches 1,2,4,8]
        [--frames 48] [--warm 8] [--procs N] [--small]
        [--out RESULTS_torch_scaling_multisession.json]

The JAX tool's configuration: `os0_64_config()` (64 x 1024), the circuit
world, `--frames` (48) frames at 0.4 m a frame, rendered once on the
device; B streams of it, stream b rolled by b frames (`roll(-b)`) so that
the sessions' states differ.  For each B the step runs as the JAX tool
runs it, compiled: `pipeline.frame_graph.BatchedStepGraph`, the batched
step replayed from one CUDA graph over a state updated in place (the
counterpart of `jax.jit(step, donate_argnums=(0,))`); it runs `--warm` (8)
frames (the first captures the graph), then the rest are timed, the
device synchronized at the end of the run: total scans/s = B * timed
frames / seconds.  Then, on the card, one more step is traced with
`torch.profiler` (device kernels a step, the device's busy share: summed
kernel time over the step's host time, both inside the trace) and one more
counted with CUDA's sync debug mode (host syncs a step); peak memory is
`torch.cuda.max_memory_allocated` over the whole B run.
`one_chip_batch8_efficiency` is scans/s at B = 8 over 8 times scans/s at
B = 1.  The same rows for the eager `slam.slam_step_batched` are kept
under `batch_eager`, for the record.

`--procs N` is the counterpart of the JAX tool's collective inventory: the
largest B is split over N ranks (`parallel.multiproc.launch`; NCCL, one
rank a card, on the card; gloo processes on the CPU), every rank steps its
own sessions, and every collective of `torch.distributed` is wrapped and
counted while they step: `sharded_step_collective_ops` (expected 0: the
sessions share nothing).

`--small` runs small_test_config at 3 frames (1 warm) for the CPU test.
Writes the JSON to `--out`, with `device` (the card's name and power
limit, or "cpu").
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "RESULTS_torch_scaling_multisession.json")

from intensity_slam_tpu_torch import config  # noqa: E402
from intensity_slam_tpu_torch.io import synthetic  # noqa: E402
from intensity_slam_tpu_torch.ops import projection  # noqa: E402
from intensity_slam_tpu_torch.parallel import multiproc  # noqa: E402
from intensity_slam_tpu_torch.pipeline import frame_graph, slam  # noqa: E402
from intensity_slam_tpu_torch.utils import device as devices  # noqa: E402

COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
               "reduce_scatter_tensor", "all_to_all", "all_to_all_single", "broadcast",
               "reduce", "gather", "scatter", "send", "recv", "isend", "irecv")


def streams(cfg, frames: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """(F, H*W, 3) xyz and (F, H*W) intensity of the circuit at 0.4 m a
    frame, rendered on `dev`."""
    poses = synthetic.circuit_trajectory(frames, speed=0.4, device=dev)
    return synthetic.render_sequence(poses, synthetic.circuit_world(device=dev), cfg.sensor)


def staggered(x: torch.Tensor, first: int, count: int) -> torch.Tensor:
    """(F, count, ...) streams first..first+count-1, stream b rolled by b."""
    return torch.stack([torch.roll(x, -b, 0) for b in range(first, first + count)], 1)


def run_batch(cfg, xyz, inten, first: int, B: int, warm: int, dev, probe: bool,
              graphs: bool = True) -> dict:
    """Step sessions first..first+B-1 over the streams, through the graphs
    (or with `graphs` false the eager step); the timing, and on the card
    the traced and the counted step."""
    F = xyz.shape[0] - (2 if probe else 0)
    xb, ib = staggered(xyz, first, B), staggered(inten, first, B)
    mask = projection.detection_mask(cfg.sensor, device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    seeds = range(first, first + B)
    if graphs:
        graph = frame_graph.BatchedStepGraph(cfg, seeds, dev)
        step = lambda k: graph.step(xb[k], ib[k], k * 0.1)
    else:
        state = slam.init_batched_state(cfg, seeds, device=dev)

        def step(k):
            nonlocal state
            state, out = slam.slam_step_batched(state, xb[k], ib[k], k * 0.1, mask, cfg)
            return out
    for k in range(warm):
        out = step(k)
    devices.synchronize(dev)
    t0 = time.perf_counter()
    for k in range(warm, F):
        out = step(k)
    devices.synchronize(dev)
    dt = time.perf_counter() - t0
    row = {"total_scans_per_sec": B * (F - warm) / dt,
           "ms_per_step": 1e3 * dt / (F - warm),
           "skips_last_step": sum(h.skip for h in out.host)}
    if probe:
        from torch.profiler import ProfilerActivity
        with devices.profile([ProfilerActivity.CUDA]) as prof:
            devices.synchronize(dev)
            t0 = time.perf_counter()
            step(F)
            devices.synchronize(dev)
            host_us = 1e6 * (time.perf_counter() - t0)
        events = [e for e in prof.events() if e.device_type.name == "CUDA"]
        dev_us = sum(e.time_range.elapsed_us() for e in events)
        with devices.count_syncs(dev.type == "cuda") as sites:
            step(F + 1)
            devices.synchronize(dev)
        row.update(device_kernels_per_step=len(events),
                   device_busy_share=dev_us / host_us if events else None,
                   host_syncs_per_step=sum(sites.values()),
                   peak_memory_bytes=torch.cuda.max_memory_allocated(dev))
    return row


def _print_row(name: str, B: int, row: dict, on_card: bool) -> None:
    print(f"B={B} {name}: {row['total_scans_per_sec']:.1f} scans/s total, "
          f"{row['ms_per_step']:.2f} ms/step"
          + (f", {row['device_kernels_per_step']} kernels, busy "
             f"{row['device_busy_share']:.3f}, {row['host_syncs_per_step']} syncs, "
             f"peak {row['peak_memory_bytes'] / 2**20:.0f} MiB" if on_card else ""),
          flush=True)


class CollectiveCounter:
    """Counts the calls of `torch.distributed`'s collectives while on."""

    def __init__(self):
        import torch.distributed as dist
        self.dist, self.calls, self.saved = dist, {}, {}

    def __enter__(self):
        for name in COLLECTIVES:
            fn = getattr(self.dist, name, None)
            if fn is None:
                continue
            self.saved[name] = fn
            self.calls[name] = 0

            def counted(*a, _fn=fn, _name=name, **k):
                self.calls[_name] += 1
                return _fn(*a, **k)
            setattr(self.dist, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.dist, name, fn)


def worker(pid: int, nproc: int, coordinator: str, out_path: str | None,
           timeout_s: float, device: str, small: bool, batch: int) -> None:
    """One rank of `--procs`: steps its block of `batch` sessions with every
    collective counted; rank 0 writes the gathered counts."""
    import torch.distributed as dist
    if device == "cuda":
        dev = torch.device("cuda", pid)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        dev = torch.device("cpu")
        backend = "gloo"
        torch.set_num_threads(1)
    mesh = multiproc.initialize(pid, nproc, coordinator, backend, timeout_s)
    try:
        cfg, frames, warm = settings(small)
        lo, hi = multiproc.row_block(batch, mesh)
        xyz, inten = streams(cfg, frames, dev)
        with CollectiveCounter() as cc:
            row = run_batch(cfg, xyz, inten, lo, hi - lo, warm, dev, probe=False)
        counts = torch.tensor([cc.calls[n] for n in sorted(cc.calls)], dtype=torch.int64,
                              device=mesh.device)
        dist.all_reduce(counts)
        if pid == 0 and out_path:
            with open(out_path, "w") as f:
                json.dump({"ranks": nproc, "sessions": batch,
                           "sessions_per_rank": hi - lo, "rank0": row,
                           "collective_calls": dict(zip(sorted(cc.calls), counts.tolist()))},
                          f, indent=1)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def settings(small: bool):
    """(config, frames, warm frames)."""
    if small:
        return config.small_test_config(), 3, 1
    return config.os0_64_config(), 48, 8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batches", default="1,2,4,8")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--warm", type=int, default=None)
    ap.add_argument("--procs", type=int, default=0)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--timeout", type=float, default=1800.0)
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    devices.detach_profiler_after_traces()       # the traces must not slow the timed calls
    if args.worker is not None:
        worker(args.worker, args.procs, args.coordinator, args.out, args.timeout,
               args.device, args.small, args.batch)
        return 0
    dev = devices.resolve(args.device)
    cfg, frames, warm = settings(args.small)
    frames = args.frames or frames
    warm = warm if args.warm is None else args.warm
    batches = [int(b) for b in args.batches.split(",")]
    on_card = dev.type == "cuda"
    xyz, inten = streams(cfg, frames + (2 if on_card else 0), dev)
    if on_card:
        # the profiler's first trace in a process carries its start-up
        from torch.profiler import ProfilerActivity
        with devices.profile([ProfilerActivity.CUDA]):
            torch.zeros(1, device=dev).add_(1)
            devices.synchronize(dev)
    res = {"frames_per_stream": frames, "step": "BatchedStepGraph (CUDA graphs)",
           "batch": {}, "batch_eager": {}}
    for B in batches:
        for key, graphs in (("batch", True), ("batch_eager", False)):
            row = run_batch(cfg, xyz, inten, 0, B, warm, dev, probe=on_card, graphs=graphs)
            res[key][str(B)] = row
            _print_row("graphed" if graphs else "eager", B, row, on_card)
    rates = {int(b): r["total_scans_per_sec"] for b, r in res["batch"].items()}
    eager = {int(b): r["total_scans_per_sec"] for b, r in res["batch_eager"].items()}
    if 1 in rates and 8 in rates:
        res["one_chip_batch8_efficiency"] = rates[8] / (8 * rates[1])
        res["one_chip_batch8_efficiency_eager"] = eager[8] / (8 * eager[1])
    if args.procs:
        B = max(batches)
        tmp = args.out + ".procs.json"
        rc = multiproc.launch(args.procs, tmp, args.timeout, retries=0,
                              module=os.path.abspath(__file__),
                              args=["--device", dev.type, "--batch", str(B)]
                              + (["--small"] if args.small else []))
        if rc != 0:
            print(f"--procs {args.procs} FAILED rc={rc}")
            return rc
        with open(tmp) as f:
            procs = json.load(f)
        os.remove(tmp)
        res["sharded_step_collective_ops"] = procs["collective_calls"]
        res["sharded_step"] = {k: procs[k] for k in ("ranks", "sessions", "sessions_per_rank")}
    lo, hi = min(rates), max(rates)
    res["scaling_statement"] = (
        f"B={hi} sessions in one launch sequence give {rates[hi]:.1f} scans/s in all "
        f"against {rates[lo]:.1f} at B={lo}: {rates[hi] / rates[lo]:.2f}x the total rate "
        f"for {hi // lo}x the sessions")
    res["device"] = devices.describe(dev)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
