#!/usr/bin/env python
"""Per-stage times, device work and bounds of the PyTorch/CUDA port's
per-frame path: the counterpart of `tools/profile_stages.py`.

    python tools/torch_profile_stages.py [--reps 30] [--device cuda]
                                         [--out RESULTS_torch_profile.json]

The same ten stages as the JAX tool, in its order and under its names, each
called in isolation on the same inputs at os0_64_config (the circuit's
eighth frame, after seven frames through `slam_step` to fill the maps).
Each row gives:

  host ms    median of `--reps` calls, each synchronized before and after
  device us  the sum of the device kernels' durations (copies included) in
             one `torch.profiler` trace of one call
  kernels    device kernels (and copies) that one call launches, and the
             one whose launches take the most device time
  busy       device us over host us
  opnd MB    operand bytes: every input and output tensor of the call once
             (the NamedTuple trees walked), a lower bound on its traffic
  MFLOP      FLOPs counted by `torch.utils.flop_counter.FlopCounterMode`,
             which counts matmul-class aten ops only (mm, bmm, addmm,
             convolutions, attention): elementwise work and the ctypes NN
             kernel are invisible to it, so the count is a lower bound
  bound      max(FLOP / FP32 peak, operand bytes / memory bandwidth) from
             the card's published peaks (`utils.device.PEAKS`), which of
             the two sets it, and its share of the host time

Each stage is called once more than it is timed.  Its inputs must be
bit-equal after the calls to a copy taken before them, so that no stage
times an input it has changed in place; the RANSAC draws are fixed
arguments for the same reason.  The outputs of the first and the last call
are compared too: the row counts the output tensors that differ and the
largest difference (on the card, sums made in atomic order, such as the
keyframe cloud's per-voxel intensity means, part in their last bits).  The
probe lines say whether the two `fused_step` rows timed the keyframe
branch.

On the card an eleventh row, `FULL frame (graphs)`, times the probe
frame, at half the keyframe interval after the last keyframe (so not a
keyframe: the two `fused_step` probes are, see their probe lines), as
`SlamSystem` runs it: through
`pipeline.frame_graph.FrameGraph`, the frame replayed from one CUDA graph
(captured at the first call; its solves, fallback, log append and capacity
policy behind conditional nodes) over a state updated in place, which is set
back to the probe's state before every call, outside the timing and the
trace.  A replay dispatches no aten op, so the row's FLOPs are the
`fused_step (non-keyframe)` row's count.  Beside it a twelfth row,
`geo_slam_step (graphs)`, times the A-LOAM step (the geometric-only path)
on the same probe scan, unorganized, as `geometric_slam.run_sequence` runs
it: through `geometric_slam.GeoStepGraph`, one replayed graph, over the
state that `geo_slam_step` leaves after the seven frames before it, set
back before every call; its FLOPs are one eager `geo_slam_step`'s count.  On
the CPU the graphed rows are left out (a graph owner runs the eager
segments there).  Two more, `FULL keyframe (graphs)` and `FULL keyframe,
accepted loop (graphs)`, replay keyframes of the 38-frame out-and-back
(SlamConfig() widths, 64x1024, the recency exclusions shortened) through
`FrameGraph`, the keyframe branch inside the graph: the last keyframe that
verified nothing before the first accepted loop, and that loop's frame
(ICP verification, PCM, the dense 6144-dim PGO, the map rebuild), each set
back to the state before it before every call (`keyframe_graph_rows`).

On `--device cpu` every device column reads "not measured", and so does
the bound on a card that the peaks table lacks.  Prints the JAX tool's
markdown table (its XLA "logical bytes" column has no counterpart and is
gone) with the card's name and power limit beside every row, and writes the
rows as JSON.  `--small` (small_test_config) rehearses the tool on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "RESULTS_torch_profile.json")

from intensity_slam_tpu_torch import config  # noqa: E402
from intensity_slam_tpu_torch.io import synthetic  # noqa: E402
from intensity_slam_tpu_torch.ops import curvature, ground, projection  # noqa: E402
from intensity_slam_tpu_torch.pipeline import frame_graph, fused, geometric, mapping  # noqa: E402
from intensity_slam_tpu_torch.pipeline import geometric_slam  # noqa: E402
from intensity_slam_tpu_torch.pipeline import loop as loop_mod  # noqa: E402
from intensity_slam_tpu_torch.pipeline import odometry, slam  # noqa: E402
from intensity_slam_tpu_torch.utils import device as devices  # noqa: E402

NOT_MEASURED = "not measured"
WARM_FRAMES = 8


def _tensors(tree, path: str = ""):
    """(path, tensor) of each tensor of a nest of tuples (NamedTuples by
    field name), lists and dicts."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, (tuple, list)):
        names = getattr(tree, "_fields", range(len(tree)))
        for k, v in zip(names, tree):
            yield from _tensors(v, f"{path}.{k}")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, f"{path}.{k}")


def operand_bytes(tree) -> int:
    return sum(a.numel() * a.element_size() for _, a in _tensors(tree))


def _clone(tree):
    """A copy of the tensors of a nest of tuples, lists and dicts (other
    leaves kept as they are)."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_clone(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree


def differences(a, b) -> dict[str, float]:
    """For each tensor of `a` that is not equal to `b`'s (NaN equal to NaN),
    its path and the largest absolute difference (inf where the structure,
    shape or type differ)."""
    ta, tb = list(_tensors(a)), list(_tensors(b))
    if [p for p, _ in ta] != [p for p, _ in tb]:
        return {"": float("inf")}
    out = {}
    for (path, x), (_, y) in zip(ta, tb):
        if x.shape != y.shape or x.dtype != y.dtype:
            out[path] = float("inf")
        elif not bool(torch.all((x == y) | ((x != x) & (y != y)))):
            d = (x.double() - y.double()).abs()
            out[path] = float(torch.max(torch.where(torch.isnan(d), 0.0, d)))
    return out


def device_trace(fn, traces: int = 3, reset=None) -> tuple[float, int, str, float]:
    """(summed device-side microseconds, device events, the name and summed
    microseconds of the kernel that takes the most) of one call of `fn`
    from a `torch.profiler` trace; a trace that comes back empty is taken
    again, up to `traces` times.  `reset`, when given, runs before each
    call, outside the trace."""
    from torch.profiler import ProfilerActivity
    for _ in range(traces):
        if reset is not None:
            reset()
            torch.cuda.synchronize()
        with devices.profile([ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type.name == "CUDA"]
        if events:
            by_name = {}
            for e in events:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            top = max(by_name, key=by_name.get)
            return (sum(by_name.values()), len(events), top[:100], by_name[top])
    return 0.0, 0, NOT_MEASURED, 0.0


class Profiler:
    """Times stages on one device and keeps their rows."""

    def __init__(self, dev, reps: int):
        self.dev = dev
        self.reps = reps
        self.peaks = devices.peaks(dev)
        self.card = devices.describe(dev)
        self.rows = []

    def stage(self, name: str, fn, *args, reset=None, flops=None):
        """Time `fn(*args)` (see the module docstring).  `reset`, when
        given, runs before every call, outside the timing; `flops` stands
        for the count where FlopCounterMode cannot see the work."""
        reset = reset or (lambda: None)
        before = _clone(args)
        reset()
        first = fn(*args)
        host = []
        for _ in range(self.reps):
            reset()
            devices.synchronize(self.dev)
            t0 = time.perf_counter()
            out = fn(*args)
            devices.synchronize(self.dev)
            host.append(time.perf_counter() - t0)
        changed = differences(before, args)
        if changed:
            raise RuntimeError(f"{name}: its inputs changed over {self.reps + 1} calls "
                               f"({changed}); the stage changes its inputs in place")
        # outputs may still part where the device sums in atomic order
        repeat = differences(first, out)
        if flops is None:
            reset()
            with FlopCounterMode(display=False) as fc:
                fn(*args)
            flops = fc.get_total_flops()
        opnd = operand_bytes(args) + operand_bytes(out)
        host_us = 1e6 * statistics.median(host)
        row = {"stage": name, "host_ms": host_us / 1e3, "device_us": NOT_MEASURED,
               "kernels": NOT_MEASURED, "busy_share": NOT_MEASURED, "operand_bytes": opnd,
               "flops": flops, "bound_us": NOT_MEASURED, "bound_by": NOT_MEASURED,
               "bound_share": NOT_MEASURED, "top_kernel": NOT_MEASURED,
               "top_kernel_us": NOT_MEASURED, "repeat_outputs_differing": len(repeat),
               "repeat_max_abs_diff": max(repeat.values(), default=0.0)}
        if self.dev.type == "cuda":
            dev_us, kernels, top, top_us = device_trace(lambda: fn(*args), reset=reset)
            row.update(device_us=dev_us, kernels=kernels, busy_share=dev_us / host_us,
                       top_kernel=top, top_kernel_us=top_us)
        if self.peaks is not None:
            t_ops = 1e6 * flops / self.peaks.fp32_flops
            t_bytes = 1e6 * opnd / self.peaks.bytes_per_s
            bound = max(t_ops, t_bytes)
            row.update(bound_us=bound, bound_by="operations" if t_ops > t_bytes else "bytes",
                       bound_share=bound / host_us)
        self.rows.append(row)
        print(f"{name:28s} {_fmt(row['host_ms'], 3):>9} ms  {_fmt(row['device_us'], 1):>12} "
              f"us dev  {_fmt(row['kernels'], 0):>12} kernels  opnd {opnd / 1e6:8.1f} MB  "
              f"{flops / 1e6:9.1f} MF  bound {_fmt(row['bound_us'], 2)} us "
              f"({row['bound_by']})  [{self.card}]", flush=True)
        if self.dev.type == "cuda":
            print(f"  top kernel {row['top_kernel_us']:.1f} us: {row['top_kernel']}", flush=True)
        if repeat:
            print(f"  call {self.reps + 1} differs from call 1 in {len(repeat)} output "
                  f"tensors: {repeat}", flush=True)
        return out


def graph_row(prof: Profiler, cfg, fstate, x0, i0, u, flops) -> frame_graph.FrameGraph:
    """The `FULL frame (graphs)` row: the probe frame through a `FrameGraph`,
    set back to `fstate` before every call, at half the keyframe interval
    after the state's last keyframe, so that the keyframe gate does not
    pass (the frame is printed as a probe line)."""
    ts = float(fstate.slam.odo.last_kf_time) + 0.5 * cfg.odometry.keyframe_time_interval
    fg = frame_graph.FrameGraph(cfg, prof.dev, state=fstate)
    prof.stage("FULL frame (graphs)", lambda fs, x, i: fg.step(x, i, ts, ground_u=u),
               fstate, x0, i0, reset=lambda: fg.adopt(fstate), flops=flops)
    fg.adopt(fstate)
    info = fg.step(x0, i0, ts, ground_u=u)
    print(f"  (graph-row probe at t={ts:.3f}: is_keyframe={bool(info.is_keyframe)}, "
          f"skip={bool(info.skip)})")
    return fg


def out_and_back_config(base):
    """`base` with the recency exclusions shortened for the 38-frame
    out-and-back (tests/test_loop_closure.py:41-49)."""
    return base.replace(loop=dataclasses.replace(
        base.loop, sc_num_exclude_recent=4, min_loop_search_gap=4))


def keyframe_graph_rows(prof: Profiler, cfg) -> frame_graph.FrameGraph:
    """The `FULL keyframe (graphs)` and `FULL keyframe, accepted loop
    (graphs)` rows: keyframes of the out-and-back (`cfg`'s widths, the
    recency exclusions shortened) through a `FrameGraph`, the whole
    keyframe branch replayed inside the frame's graph.  The eager
    `fused_step` runs the sequence up to its first accepted loop; the
    accepted-loop row replays that frame (ICP verification, PCM, the loop
    edge, the dense PGO, the map rebuild), the keyframe row the last
    keyframe before it that verified nothing, each from the state before
    it, set back before every call.  The FLOPs are those of the same frame
    through the eager `fused_step`."""
    dev = prof.dev
    xyz, inten = synthetic.render_sequence(
        synthetic.out_and_back_trajectory(device=dev), synthetic.corridor_world(device=dev),
        cfg.sensor)
    mask = projection.detection_mask(cfg.sensor, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    u = ground.draw_uniforms(gen, cfg.ground, dev)
    st = fused.init_state(cfg, device=dev)
    before, plain, loop = [], None, None
    for k in range(xyz.shape[0]):
        before.append(frame_graph.clone_state(st))
        st, info = fused.fused_step(st, xyz[k], inten[k], 0.1 * k, mask, cfg, ground_u=u)
        if bool(info.loop_found):
            loop = k
            break
        if bool(info.is_keyframe) and not bool(info.loop_found) and \
                not torch.isfinite(info.icp_fitness):
            plain = k
    if loop is None or plain is None:
        raise RuntimeError(f"the out-and-back gave no accepted loop ({loop}) or no plain "
                           f"keyframe before it ({plain})")
    fg = None
    for name, k in (("FULL keyframe (graphs)", plain),
                    ("FULL keyframe, accepted loop (graphs)", loop)):
        fstate = before[k]
        with FlopCounterMode(display=False) as fc:
            fused.fused_step(fstate, xyz[k], inten[k], 0.1 * k, mask, cfg, ground_u=u)
        fg = frame_graph.FrameGraph(cfg, dev, state=fstate)
        prof.stage(name, lambda fs, x, i, _fg=fg, _k=k: _fg.step(x, i, 0.1 * _k, ground_u=u),
                   fstate, xyz[k], inten[k], reset=lambda _fg=fg, _s=fstate: _fg.adopt(_s),
                   flops=fc.get_total_flops())
        warm = fg.warmup_s or "none (an earlier owner's of this configuration served)"
        print(f"  (frame {k} of the out-and-back: keyframe {fg.last_flags['keyframe']}, "
              f"verified {fg.last_flags['verify']}, loop accepted "
              f"{fg.last_flags['accept']}; warm-up s {warm}, capture s {fg.capture_s})")
    return fg


def geo_graph_row(prof: Profiler, cfg, xyz, inten, x0, i0):
    """The `geo_slam_step (graphs)` row: the probe scan through a
    `GeoStepGraph` set back before every call to the state that eager
    `geo_slam_step`s leave after the frames `xyz`, `inten`."""
    gstate = geometric_slam.init_state(cfg, device=prof.dev)
    for k in range(xyz.shape[0]):
        gstate, _ = geometric_slam.geo_slam_step(gstate, xyz[k], inten[k], cfg)
    with FlopCounterMode(display=False) as fc:
        geometric_slam.geo_slam_step(gstate, x0, i0, cfg)
    g = geometric_slam.GeoStepGraph(cfg, prof.dev, state=gstate)
    prof.stage("geo_slam_step (graphs)", lambda gs, x, i: g.step(x, i), gstate, x0, i0,
               reset=lambda: g.adopt(gstate), flops=fc.get_total_flops())
    return g


def _fmt(v, digits: int) -> str:
    return v if isinstance(v, str) else f"{v:.{digits}f}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--small", action="store_true", help="small test shapes")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default=OUT)
    args = ap.parse_args(argv)
    devices.detach_profiler_after_traces()       # the traces must not slow the timed calls
    dev = devices.resolve(args.device)
    cfg = config.small_test_config() if args.small else config.os0_64_config()
    poses = synthetic.circuit_trajectory(WARM_FRAMES, speed=0.4, device=dev)
    xyz, inten = synthetic.render_sequence(poses, synthetic.circuit_world(device=dev),
                                           cfg.sensor)
    mask = projection.detection_mask(cfg.sensor, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    u = ground.draw_uniforms(gen, cfg.ground, dev)      # fixed RANSAC draws

    # a few frames first, so that the maps hold points
    state = slam.init_state(cfg, device=dev)
    for k in range(WARM_FRAMES):
        state, out = slam.slam_step(state, xyz[k], inten[k], k * cfg.sensor.scan_period,
                                    mask, cfg)
    x0, i0, t0 = xyz[-1], inten[-1], 0.7
    prof = Profiler(dev, args.reps)
    print(f"{cfg.sensor.image_height}x{cfg.sensor.image_width}, {args.reps} timed calls a "
          f"stage; FLOPs counted by FlopCounterMode (matmul-class aten ops only); "
          f"{prof.card}")

    prof.stage("FULL slam_step", lambda s, x, i: slam.slam_step(
        s, x, i, t0, mask, cfg, ground_u=u), state, x0, i0)
    scan = prof.stage("projection", lambda x, i: projection.project_organized(
        x, i, cfg.sensor), x0, i0)
    prof.stage("odometry_step", lambda s, sc: odometry.odometry_step(
        s, sc, t0, mask, cfg), state.odo, scan)
    fc = prof.stage("curvature features", lambda sc: curvature.extract_features(
        sc, cfg.sensor, cfg.geometric), scan)
    prof.stage("geometric_delta (solve)", lambda s, f: geometric.geometric_delta(s, f, cfg),
               state.geo, fc)
    gres = prof.stage("ground RANSAC", lambda r, x, v: ground.extract_ground(
        r, x, v, cfg.ground), u, x0, scan.valid.reshape(-1))
    mout = prof.stage("mapping_step", lambda ms, x, gm, c, cm, p, sp, sm: mapping.mapping_step(
        ms, x, gm, c, cm, p, cfg, surf_pts=sp, surf_mask=sm), state.mapping, x0,
        gres.ground_mask, fc.less_sharp, fc.less_sharp_mask, state.merged_pose,
        fc.less_flat, fc.less_flat_mask)

    # ---- keyframe back end (detection channels; ICP and PGO at a candidate)
    _, mo = mout

    def bstep(bs, x, m, d, dv, pose):
        return loop_mod.backend_step(
            bs, x, m, d, dv, pose, t0, cfg, feat_xyz=out.feat_xyz,
            ground_pts=mo.ground_ds, ground_mask=mo.ground_ds_mask,
            corner_pts=mo.corner_ds, corner_mask=mo.corner_ds_mask, scan_int=i0)

    sm = torch.linalg.norm(x0, dim=-1) >= cfg.sensor.min_range
    bstate, _ = bstep(loop_mod.init_state(cfg, device=dev), x0, sm, out.desc,
                      out.desc_valid, out.pose)
    prof.stage("backend_step (keyframe)", bstep, bstate, x0, sm, out.desc, out.desc_valid,
               out.pose)

    # ---- the fused per-frame step (what the live system runs) -----------
    fstate = fused.init_state(cfg, device=dev)
    for k in range(WARM_FRAMES):
        fstate, _ = fused.fused_step(fstate, xyz[k], inten[k], k * cfg.sensor.scan_period,
                                     mask, cfg)
    # non-keyframe: a timestamp just after the last (dt < 0.3 s); whether
    # the gate agrees is printed, as for the next row
    _, fi1 = fused.fused_step(fstate, x0, i0, 0.72, mask, cfg, ground_u=u)
    non_kf_is_kf = bool(fi1.is_keyframe)
    print(f"  (non-keyframe probe: is_keyframe={non_kf_is_kf})")
    prof.stage("fused_step (non-keyframe)", lambda fs, x, i: fused.fused_step(
        fs, x, i, 0.72, mask, cfg, ground_u=u), fstate, x0, i0)
    # a large dt: a keyframe if the spatial gate passes too (printed so that
    # the reader knows which branch the row timed)
    _, fi2 = fused.fused_step(fstate, x0, i0, 9.0, mask, cfg, ground_u=u)
    is_kf = bool(fi2.is_keyframe)
    print(f"  (keyframe-branch probe: is_keyframe={is_kf})")
    prof.stage("fused_step (kf-gate frame)", lambda fs, x, i: fused.fused_step(
        fs, x, i, 9.0, mask, cfg, ground_u=u), fstate, x0, i0)
    graph = None
    if dev.type == "cuda":
        # the non-keyframe frame as SlamSystem runs it (CUDA graphs)
        eager = next(r for r in prof.rows if r["stage"] == "fused_step (non-keyframe)")
        fg = graph_row(prof, cfg, fstate, x0, i0, u, eager["flops"])
        gg = geo_graph_row(prof, cfg, xyz[:-1], inten[:-1], x0, i0)
        keyframe_graph_rows(prof, out_and_back_config(
            config.small_test_config() if args.small else config.SlamConfig()))
        graph = {"capture_s": fg.capture_s, "replays": dict(fg.replays),
                 "geo_capture_s": gg.capture_s, "geo_replays": dict(gg.replays)}
        print(f"  (graphs: capture s {fg.capture_s}, replays {dict(fg.replays)}; A-LOAM "
              f"step capture s {gg.capture_s}, replays {dict(gg.replays)})")

    print(f"\n| Stage | host ms | device us | kernels | busy | operand MB | counted MFLOP "
          f"| bound us | bound by | bound / host | card |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    for r in prof.rows:
        busy = r["busy_share"] if isinstance(r["busy_share"], str) else \
            f"{100 * r['busy_share']:.1f} %"
        share = r["bound_share"] if isinstance(r["bound_share"], str) else \
            f"{100 * r['bound_share']:.2f} %"
        print(f"| {r['stage']} | {r['host_ms']:.3f} | {_fmt(r['device_us'], 1)} "
              f"| {_fmt(r['kernels'], 0)} | {busy} | {r['operand_bytes'] / 1e6:.1f} "
              f"| {r['flops'] / 1e6:.1f} | {_fmt(r['bound_us'], 2)} | {r['bound_by']} "
              f"| {share} | {prof.card} |")
    res = {"device": prof.card, "reps": args.reps,
           "sensor": f"{cfg.sensor.image_height}x{cfg.sensor.image_width}",
           "peaks": prof.peaks._asdict() if prof.peaks else NOT_MEASURED,
           "flops_counted": "FlopCounterMode: matmul-class aten ops only",
           "non_keyframe_probe_is_keyframe": non_kf_is_kf,
           "kf_gate_probe_is_keyframe": is_kf, "graphs": graph or NOT_MEASURED,
           "rows": prof.rows}
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(f"results -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
