"""Traffic kind `islog_stream`: organized scans through the program's
streaming entry, `StreamingRunner.run` in wire mode (one `FrameGraph`
replay of `fused_step` a frame).

Set-up renders the mix's drive from the seed into a scan log under
`TMPDIR` (deleted at exit), builds the runner and runs the mix's
`warm_frames` through it: the first frame runs eagerly, warms the keyframe
regions up and captures the frame graph.

- `pacing: "closed"`: the window replays the whole log through one `run`
  per pass, `reset()` between passes (the captured graphs are kept) and the
  corrected trajectory exported at each pass's end, as fast as the system
  goes, until `--seconds` have passed; the window ends at the end of the
  frame that crosses them.  A frame's time runs from the end of the
  previous frame's dispatch (its flags read, after which its pose is final
  on the device) to the end of its own.  The traced run, after the window,
  replays the log once more and traces frames [`trace_from`,
  `trace_from` + `trace_frames`).
- `pacing: "open"`: one `run` over the log; the frames before
  `warm_frames` are set-up, replayed as fast as possible, and frame k of
  the window is released at t0 + (k - warm_frames) / rate_hz, where t0 is
  the end of set-up; `on_frame` sleeps until the next frame is due, so a
  frame that is late is not waited for.  A frame's latency runs from its
  due time to the end of its dispatch.  The window holds `--seconds` x
  `rate_hz` frames, as many as the log has after set-up.

`check` (the mix's quotas) picks the steps that the reference redoes after
the window (`slambench.check`).  A replay picks them from the first pass's
flags and copies the state around them alone in the second pass (each
pass replays the same frames from the same reset state); a live mix copies
the state after every frame of its window, one pass that sees each frame
once, and keeps the copies of the steps its flags pick.  The exported
trajectory of the first pass (a replay's) or of the whole run (a live
mix's) is held to the rendered poses."""

from __future__ import annotations

import os
import shutil
import statistics
import tempfile
import time

import torch

from intensity_slam_tpu_torch import interop
from intensity_slam_tpu_torch.pipeline import mapping, posegraph
from intensity_slam_tpu_torch.runtime import stream
from intensity_slam_tpu_torch.runtime.scanlog import ScanLog, ScanLogWriter
from intensity_slam_tpu_torch.utils import device as pdevice
from slambench import check, reference, scans, trace as tracing, work
from slambench.reference.islam.ops import projection as rprojection
from slambench.reference.islam.pipeline import fused as rfused

LUT_FRAMES = 20         # frames the stream's beam-direction table is built from
WATCHED_PASS = 1        # the replay's pass whose chosen steps are copied


class WindowClosed(Exception):
    """Raised from `on_frame` to end the dispatch loop when the window closes."""


def run(cell, seed: int, seconds: float, traced: bool, device) -> dict:
    tr = cell.traffic
    cfg = interop.config_from_dict(cell.config["slam"])
    dev = torch.device(device)
    drive = scans.Drive(tr, dev)
    closed = tr["pacing"] == "closed"
    warm = int(tr["warm_frames"])
    tmp = tempfile.mkdtemp(prefix="slambench.", dir=os.environ.get("TMPDIR"))
    try:
        if traced:      # before the first frame captures the graph
            tracing.mark(mapping, "mapping_step", "mapping")
            tracing.mark(posegraph, "optimize", "pgo")
        path = os.path.join(tmp, "drive.islog")
        first = _write_log(path, drive, cfg, seed)
        with ScanLog(path) as log:
            runner = stream.StreamingRunner(cfg, traj_path=os.path.join(tmp, "live.tum"),
                                            device=dev)
            if closed:
                out = _closed(runner, log, cfg, tr, seed, seconds, traced, warm)
            else:
                out = _open(runner, log, cfg, tr, seed, seconds, traced, warm)
            if not closed:                 # the live state at the window's end
                out["export"] = out["watched_export"] = _export(runner)
            out["failed"] = out["dropped"] + runner._stats()["dropped_pose_writes"]
            out["first_frame_s"] = (sum(runner.graph.warmup_s.values())
                                    + sum(runner.graph.capture_s.values()))
        accepted = sum(f["flags"].get("accept", False) for f in out["all_frames"])
        kfs = sum(f["flags"].get("keyframe", False) for f in out["all_frames"])
        out["lines"].append(f"window: {len(out['all_frames'])} frames, {kfs} keyframes, "
                            f"{accepted} accepted loops; checked steps "
                            f"{[(r['k'], r['why']) for r in out['watch'].kept]}")
        out["work"] = dict(mapping=work.mapping(cell.config["slam"]),
                           pgo=work.pgo(cfg.loop.max_keyframes, cfg.loop.pgo_gn_iters))
        out["check"] = lambda control=False: _check(out, cell, drive, first, seed, dev,
                                                    control)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _export(runner):
    """The PGO-corrected trajectory the runner exports, or None where the
    export fails (the check counts that as a wrong answer)."""
    try:
        return runner.trajectory()
    except (AssertionError, RuntimeError, ValueError):
        return None


def _write_log(path: str, drive, cfg, seed: int) -> list:
    """Render every frame of the drive into the log, 0.1 s apart, with the
    rendered poses as ground truth; returns the first frames' points, from
    which the reference builds the beam-direction table."""
    first = []
    sc = cfg.sensor
    with ScanLogWriter(path, sc.image_height, sc.image_width, ground_truth=True) as w:
        for k in range(drive.frames):
            xyz, inten = drive.render(sc, seed, k)
            x = xyz.cpu().numpy()
            if k < LUT_FRAMES:
                first.append(x)
            p = drive.pose(k)
            w.append(scans.SCAN_PERIOD * k, x, inten.cpu().numpy(),
                     p.q.cpu().numpy(), p.t.cpu().numpy())
    return first


def _pool(runner, tr) -> check.Pool:
    quota = tr["check"]
    pairs = sum(int(v) for v in quota.values())
    return check.Pool(check.tensors(runner.state), 2 * pairs + 3)


def _watch(runner, pool, plan) -> check.Watch:
    gen_state = lambda: runner.state.slam.gen.get_state()
    return check.Watch(pool, lambda: check.tensors(runner.state), gen_state, plan)


def _closed(runner, log, cfg, tr, seed, seconds, traced, warm) -> dict:
    n = len(log)
    if warm:
        runner.run(log, end=warm)
    pool = _pool(runner, tr)
    plan = check.Plan(tr["check"], seed, 0, n)
    watch = None
    frames, exports, waits, dropped = [], [], 0, 0
    state = dict(pass_=0, last=None)
    with pdevice.count_syncs(traced and runner.device.type == "cuda") as sites:
        pdevice.synchronize(runner.device)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        state["last"] = t0

        def on_frame(idx, info):
            t = time.perf_counter()
            flags = dict(runner.graph.last_flags)
            frames.append(dict(k=idx, t=t, dt=t - state["last"], service=t - state["last"],
                               flags=flags, first=idx == 0, pass_=state["pass_"]))
            state["last"] = t
            if state["pass_"] == WATCHED_PASS:
                watch.step(idx, info, flags)
            if t >= deadline:
                raise WindowClosed

        try:
            while True:
                runner.reset()
                if state["pass_"] == WATCHED_PASS:
                    chosen = {f["k"]: plan.wants(f["k"], f["flags"]) for f in frames}
                    watch = _watch(runner, pool, check.Chosen(
                        {k: why for k, why in chosen.items() if why is not None}))
                    watch.begin(0)
                stats = runner.run(log, on_frame=on_frame)
                dropped += stats["dropped_pose_writes"]
                waits += runner.upload_waits
                exports.append(_export(runner))
                if state["pass_"] == WATCHED_PASS:
                    watch.finish()
                state["pass_"] += 1
                if time.perf_counter() >= deadline:
                    break
        except WindowClosed:
            pass
    t_end = frames[-1]["t"]
    peak = pool.program_peak()
    syncs = sum(v for k, v in sites.items() if not k.startswith("["))
    summary = None
    if traced:
        summary = _traced_pass(runner, log, int(tr["trace_from"]), int(tr["trace_frames"]))
    dt = [f["dt"] for f in frames]
    return dict(t0=t0, window_s=t_end - t0, frames=frames, all_frames=frames,
                watch=watch or _watch(runner, pool, plan), peak_bytes=peak,
                fresh_start=True, exported=bool(exports),
                export=exports[0] if exports else None,
                watched_export=exports[WATCHED_PASS] if len(exports) > WATCHED_PASS else None,
                dropped=dropped, counters=dict(upload_waits=waits,
                                               dispatch_syncs=syncs if traced else None),
                trace=summary,
                end_to_end=dict(scans_per_s=len(frames) / (t_end - t0),
                                frame_ms_p95=1e3 * check.p95(dt)),
                lines=[f"passes {len(exports)} complete in the window, {len(frames)} frames; "
                       f"seconds a pass {_pass_seconds(frames, t0)}"])


def _traced_pass(runner, log, first: int, count: int) -> dict:
    """One more pass from the reset state, frames [first, first + count)
    traced (`first` >= 1: the trace starts after frame first - 1)."""
    runner.reset()
    tracer = tracing.Tracer()

    def on_frame(idx, info):
        if idx == first - 1:
            tracer.start()
    runner.run(log, end=first + count, on_frame=on_frame)
    tracer.stop()
    return tracer.summary()


def _pass_seconds(frames, t0) -> list:
    ends, start = [], t0
    for a, b in zip(frames, frames[1:] + [None]):
        if b is None or b["pass_"] != a["pass_"]:
            ends.append(round(a["t"] - start, 4))
            start = a["t"]
    return ends


def _open(runner, log, cfg, tr, seed, seconds, traced, warm) -> dict:
    n = len(log)
    rate = float(tr["rate_hz"])
    count = min(n - warm, int(round(seconds * rate)))
    last = warm + count - 1
    trace_from = last - int(tr["trace_frames"]) + 1 if traced else None
    pool = _pool(runner, tr)
    watch = _watch(runner, pool, check.Plan(tr["check"], seed, warm, count))
    frames, late = [], []
    tracer = tracing.Tracer() if traced else None
    st = dict(t0=None, prev=None)

    def due(k):
        return st["t0"] + (k - warm) / rate

    def on_frame(idx, info):
        t = time.perf_counter()
        if idx == warm - 1:
            pdevice.synchronize(runner.device)
            watch.begin(warm)
            st["t0"] = st["prev"] = time.perf_counter()
        elif idx >= warm:
            flags = dict(runner.graph.last_flags)
            frames.append(dict(k=idx, t=t, due=due(idx), lat=t - due(idx),
                               service=t - max(due(idx), st["prev"]), flags=flags,
                               traced=trace_from is not None and idx >= trace_from))
            st["prev"] = t
            watch.step(idx, info, flags)
            if idx >= last:
                raise WindowClosed
        if idx >= warm - 1:
            if trace_from is not None and idx == trace_from - 1:
                tracer.start()
            wait = due(idx + 1) - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
                late.append(time.perf_counter() - due(idx + 1))

    if warm < 1:
        raise ValueError("an open-paced mix needs warm_frames >= 1")
    try:
        runner.run(log, end=warm + count, on_frame=on_frame)
    except WindowClosed:
        pass
    watch.finish()
    peak = pool.program_peak()
    summary = None
    if tracer is not None:
        tracer.stop()
        summary = tracer.summary()
    untraced = [f for f in frames if not f["traced"]]
    lat = [f["lat"] for f in frames]
    lines = [f"generator lateness (release after due, frames released on time "
             f"{len(late)} of {len(frames)}): median {1e3 * _median(late):.4f} ms, "
             f"max {1e3 * max(late, default=0.0):.4f} ms"]
    return dict(t0=st["t0"], window_s=frames[-1]["t"] - st["t0"], frames=untraced,
                all_frames=frames, watch=watch, peak_bytes=peak, fresh_start=False,
                exported=True, dropped=0,
                counters=dict(upload_waits=None, dispatch_syncs=None), trace=summary,
                end_to_end=dict(pose_latency_ms_p95=1e3 * check.p95(lat)), lines=lines)


def _median(xs) -> float:
    return statistics.median(xs) if xs else float("nan")


# ---- after the window: the reference redoes the kept steps -------------------

def _check(out, cell, drive, first, seed, dev, control) -> tuple[dict, int, list]:
    """The numbers over the kept steps: the exported trajectory against the
    rendered poses, the state at the start of the watched pass (a
    replay's), each kept frame redone by the reference, and the export of
    the state after the last watched frame.  With `control`, the reference
    computed with TF32 takes the program's place in the kept frames."""
    rcfg = reference.build_config(cell.config["slam"])
    sensor = interop.config_from_dict(cell.config["slam"]).sensor
    dirs = torch.from_numpy(reference.beam_directions(first)).to(dev)
    mask = rprojection.detection_mask(rcfg.sensor, device=dev)
    skeleton = rfused.init_state(rcfg, device=dev)
    watch = out["watch"]
    numbers, notes = check.fresh(), []
    if not control:
        if not out["exported"]:
            notes.append("no pass ended in the window: no trajectory to hold")
        elif out["export"] is None:
            numbers["decisions"] += 1
            notes.append("the export failed")
        else:
            errs = check.trajectory_errors(out["export"], drive.positions())
            notes.append(f"exported trajectory of {len(out['export'])} frames: {errs}")
            numbers = check.merge(numbers, errs)
    if out["fresh_start"] and watch.start is not None and not control:
        numbers = check.merge(numbers, check.compare_start(
            watch.start[0], watch.start[1], check.tensors(skeleton),
            skeleton.slam.gen.get_state()))
    for rec in watch.kept:
        k = rec["k"]
        xyz, inten = drive.render(sensor, seed, k)
        words = reference.wire_words(xyz.cpu().numpy(), inten.cpu().numpy(),
                                     scans.SCAN_PERIOD * k)
        x, i, ts = reference.wire_frame(words, dirs)
        step = lambda: rfused.fused_step(check.unflatten(
            skeleton, rec["before"][0], rec["before"][1]), x, i, ts, mask, rcfg)
        with reference.precision(tf32=False):
            ref_after, rinfo = step()
        if control:
            with reference.precision(tf32=True):
                side, sinfo = step()
        else:
            side = check.unflatten(skeleton, rec["after"][0])
            sinfo = rec["out"]
        one = check.compare_frame(rcfg, side, sinfo, ref_after, rinfo)
        notes.append(f"frame {k} ({rec['why']}): {one}")
        numbers = check.merge(numbers, one)
        del ref_after, side
    if watch.end is not None and not control:
        if out["watched_export"] is None:
            numbers = check.merge(numbers, dict(check.fresh(), decisions=1))
            notes.append("the watched pass's export failed")
            return numbers, len(watch.kept), notes
        end = check.unflatten(skeleton, watch.end[0])
        with reference.precision(tf32=False):
            _, t, _ = rfused.trajectory(end, rcfg)
        numbers = check.merge(numbers, check.compare_export(out["watched_export"], t))
    return numbers, len(watch.kept), notes
