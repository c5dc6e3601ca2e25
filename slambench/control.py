"""The readings that the limits of `correct` are set from, for one cell on
many seeds in one process:

    python slambench/control.py --workload <name> --seconds <s> --seeds <n> [<n> ...]

For each seed it runs the cell as `run.py` does (a window of `--seconds`,
no trace) and prints, for each number, the program's reading (the program
against the reference) and the reference's own in TF32, the precision
below the float32 the configuration states, put in the program's place on
the same kept steps.  On the first `TF32_PROGRAM_SEEDS` seeds it runs the
cell a second time with the program's own matrix products in TF32
(torch's switch, set before the graphs are captured): the control.  The
lower reading of a number is the largest of the program's over the seeds,
the upper the smallest of the control's.  The benchmark's own runs do not
run this."""

from __future__ import annotations

import gc
import json
import sys
import time

import run as harness  # noqa: F401  (puts the checkout on sys.path, sets the caches)

TF32_PROGRAM_SEEDS = 3


def main(argv=None) -> int:
    import argparse

    import torch

    from intensity_slam_tpu_torch.utils import device as pdevice
    from slambench import check, reference, spec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.Cell(spec.load_benchmark(harness.ROOT), args.workload, harness.ROOT)
    if not torch.cuda.is_available():
        print("slambench: the control runs on the card", file=sys.stderr)
        return 2
    card = pdevice.describe("cuda")
    rows = []
    for seed in args.seeds:
        t = time.perf_counter()
        run = cell.kind_module().run(cell, seed, args.seconds, False, "cuda")
        prog, checked, pnotes = run["check"](control=False)
        ctl, _, cnotes = run["check"](control=True)
        notes = [f"program: {n}" for n in pnotes] + [f"tf32 reference: {n}" for n in cnotes]
        row = dict(seed=seed, checked=checked, program=prog, control=ctl,
                   program_correct=check.verdict(prog, cell.limits, checked),
                   control_correct=check.verdict(ctl, cell.limits, checked))
        del run
        _free()
        if len(rows) < TF32_PROGRAM_SEEDS:
            with reference.precision(tf32=True):
                run = cell.kind_module().run(cell, seed, args.seconds, False, "cuda")
            tprog, tchecked, tnotes = run["check"](control=False)
            notes += [f"tf32 program: {n}" for n in tnotes]
            row.update(tf32_program=tprog,
                       tf32_program_correct=check.verdict(tprog, cell.limits, tchecked))
            del run
            _free()
        rows.append(row)
        print(json.dumps(row), f"({time.perf_counter() - t:.1f} s; {card})", flush=True)
        for n in notes:
            print("  ", n)
    for n in check.NUMBERS:  # every number, limited or not
        low = max(r["program"][n] for r in rows)
        up = min(r["control"][n] for r in rows)
        tp = [r["tf32_program"][n] for r in rows if "tf32_program" in r]
        print(f"{n}: lower reading {low!r} (largest of the program's), upper reading "
              f"{min(tp) if tp else None!r} (smallest of the program's in TF32), "
              f"{up!r} (smallest of the reference's in TF32), limit {cell.limits.get(n)!r}")
    return 0


def _free() -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
