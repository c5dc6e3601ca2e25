"""Run one cell of the benchmark once.

    python slambench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`.  The cell's
configuration, traffic mix, limits and per-layer metrics are found by the
names in `BENCHMARK.json` (`slambench/spec.py`).  The run needs as many
CUDA devices as the cell asks for and exits 2 without a result otherwise.

Earlier lines say what the run did; the last lines of standard error give
each number that decides `correct` beside its limit; the last line of
standard output is the result: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics with `--trace 0`, its per-layer
metrics with `--trace 1`), `device`, with `--trace 1` a `breakdown`, and
last `checks`, the compared numbers with their limits."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# build and kernel caches at fixed paths inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".slambench_cache", sub)
os.environ.setdefault("USE_FLAX", "0")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "intensity_slam_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(cell, seed: int, seconds: float, traced: bool, device, t_start: float,
            card: str) -> tuple[dict, list[str], list[str]]:
    """Run the cell on `device` and check it: (result, earlier lines, check
    lines)."""
    import torch
    from slambench import check, work

    run = cell.kind_module().run(cell, seed, seconds, traced, device)
    dev = torch.device(device)
    run["peaks"] = work.PEAKS.get(torch.cuda.get_device_name(dev)) if dev.type == "cuda" else None
    setup_s = run["t0"] - t_start
    lines = [f"cell {cell.name}: {card}; set-up {setup_s:.4f} s, window "
             f"{run['window_s']:.4f} s"] + run["lines"]
    if traced:
        values = {}
        for m in cell.per_layer:
            v = cell.metric(m["name"])(run)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        # a metric's quantity is its name up to the first dot; the rest
        # names the cells it is split over
        e2e = dict(run["end_to_end"], setup_s=setup_s)
        values = {m["name"]: {"value": e2e[m["name"].split(".")[0]], "unit": m["unit"]}
                  for m in cell.end_to_end}
    numbers, checked, notes = run["check"]()
    lines += [f"check {n}" for n in notes]
    limits = cell.limits
    correct = check.verdict(numbers, limits, checked)
    result = {
        "correct": bool(correct),
        "attempted": len(run["all_frames"] or run["frames"]),
        "failed": int(run["failed"]),
        "metrics": values,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": int(run["peak_bytes"]),
        },
    }
    tr = run["trace"]
    if tr is not None:
        lines.append(f"trace: {tr['device_events']} device events, {tr['markers']} marker "
                     f"kernels, device ms a call by layer "
                     f"{ {k: (len(v), round(1e3 * sum(v) / len(v), 4)) for k, v in tr['layers'].items()} }, busy "
                     f"{tr['busy_s']:.4f} s of {tr['window_s']:.4f} s")
    if traced and tr is not None:
        result["device"]["busy_s"] = tr["busy_s"]
        result["device"]["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {n: {"value": numbers[n], "limit": limits[n]} for n in limits}
    result["checks"]["checked_steps"] = {"value": checked, "limit": 1}
    return result, lines, check.lines(numbers, limits, checked)


def main(argv=None) -> int:
    args = parse(argv)
    from slambench import spec
    try:
        bench = spec.load_benchmark(ROOT)
    except FileNotFoundError as e:
        print(f"slambench: {e}", file=sys.stderr)
        return 2
    cell = spec.Cell(bench, args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"slambench: {cell.name} needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from intensity_slam_tpu_torch.utils import device as pdevice
    card = pdevice.describe("cuda")
    result, lines, checks = execute(cell, args.seed, args.seconds, bool(args.trace),
                                    "cuda", T_START, card)
    bad = forbidden_modules()
    if bad:
        print(f"slambench: the run loaded {bad}", file=sys.stderr)
        return 3
    emit(result, lines, checks)
    return 0


def emit(result: dict, lines: list[str], checks: list[str]) -> None:
    """The earlier lines, then the compared numbers as the last lines of
    standard error, then the result as the last line of standard output."""
    for line in lines:
        print(line)
    sys.stdout.flush()
    for line in checks:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()


if __name__ == "__main__":
    sys.exit(main())
