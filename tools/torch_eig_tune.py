#!/usr/bin/env python3
"""Matrices-per-warp sweep of the port's 3x3 Jacobi eigensolver kernel on
one GPU.

    python3 tools/torch_eig_tune.py

`jacobi_kernel<T, 3, VECS>` (`intensity_slam_tpu_torch/csrc/eigsym.cu`)
runs one matrix on one thread and spreads a batch over at least
`ISL_EIG_SPREAD_WARPS` warps, up to 32 matrices a warp; a warp runs every
rotation any of its matrices needs.  This builds the source once for each
value of that constant with `-D` (33: 32 matrices a warp at 1024; 8448:
one a warp at 8 x 1024), checks that every build gives the same bits as
the default one at every shape (a matrix's bits do not depend on where it
is packed), and prints each build's device-side time (`torch.profiler`, median of 33
launches) at the main path's shapes: one 3x3 (the ground refit), the line
fit's (1024, 3, 3) from the smoke run's frame, and 8 x 1024 (the batched
sessions' line fit), with the card's name and power limit.  The builds are
timed in turns within one process, so they share one card and one power
limit.
"""

from __future__ import annotations

import concurrent.futures
import os
import statistics
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from intensity_slam_tpu_torch.ops import eigsym  # noqa: E402
from intensity_slam_tpu_torch.utils import device as devices  # noqa: E402
from intensity_slam_tpu_torch.utils import nvcc  # noqa: E402

SPREADS = (33, 264, 528, 1056, 2112, 4224, 8448)
TURNS = 2


def build_variant(spread: int):
    path = os.path.join(nvcc.BUILD_DIR, f"libisl_eigsym_s{spread}.so")
    nvcc.build(eigsym.SOURCE, path, (f"-DISL_EIG_SPREAD_WARPS={spread}",))
    return eigsym.load(path)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(devices.describe(dev))
    with concurrent.futures.ThreadPoolExecutor(len(SPREADS) + 1) as pool:
        default = pool.submit(eigsym.build)
        libs = dict(zip(SPREADS, pool.map(build_variant, SPREADS)))
        default.result()
    sites = chip_smoke.eig_sites(dev)
    lines = sites["fit_lines (Q, 3, 3)"][0].contiguous()
    g = torch.Generator().manual_seed(13)
    shapes = {"one 3x3 (ground)": sites["ground (3, 3)"][0][:1].contiguous(),
              f"fit_lines {tuple(lines.shape)}": lines,
              "8 x fit_lines": torch.cat(
                  [lines] + [chip_smoke.random_spd(len(lines), 3, 8.0, g).to(lines)
                             for _ in range(7)])}
    ref = {name: eigsym._launch(a, True) for name, a in shapes.items()}
    times: dict = {}
    for _ in range(TURNS):
        for spread, lib in libs.items():
            for name, a in shapes.items():
                run = lambda: eigsym._launch(a, True, lib)   # noqa: E731
                chip_smoke.check(chip_smoke.same_bits(run(), ref[name]),
                                 f"spread {spread} at {name}: other bits than the default")
                us = chip_smoke.kernel_device_us(run, "jacobi_kernel", min_seen=16)
                times.setdefault((spread, name), []).append(us)
    print("device-side us (median of 33 launches; each turn), bits equal to the "
          "default build at every shape")
    print(f"{'spread warps':>12} " + " ".join(f"{name:>24}" for name in shapes))
    for spread in SPREADS:
        cells = []
        for name, a in shapes.items():
            per_warp = min(32, max(1, -(-len(a) // spread)))
            ts = times[(spread, name)]
            cells.append(f"{statistics.median(ts):7.2f} ({per_warp:2d}/warp) "
                         + "/".join(f"{t:.2f}" for t in ts))
        print(f"{spread:>12} " + " ".join(f"{c:>24}" for c in cells))
    print(devices.describe(dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
