#!/usr/bin/env python3
"""Tile-shape sweep of the port's CUDA nearest-neighbour kernel on one GPU.

    python3 tools/torch_nn_tune.py

Builds `intensity_slam_tpu_torch/csrc/nn.cu` once per variant of
(sources per thread, warps per block, blocks per cluster) with `-D` flags,
checks each variant against the plain PyTorch version on the smoke run's
real keyframe clouds (P = 2048, M = 6144), and prints for each: `ptxas`
registers, the time per launch of 33 back-to-back launches into
preallocated outputs (CUDA events), and the kernel's device-side duration
from `torch.profiler`.  With `--old PATH`, a previous version of the source
that exports `isl_nn_launch(src, tgt, mask, P, M, idx, dist, stream)` (the
unpacked one-kernel design) is built and timed in the same turns.  All variants are timed in turns within one process,
so they share one card and one power limit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from intensity_slam_tpu_torch import config  # noqa: E402
from intensity_slam_tpu_torch.ops import pallas_nn  # noqa: E402

# (sources per thread, warps per block, blocks per cluster)
VARIANTS = [(1, 8, 8), (2, 8, 8), (4, 8, 8), (8, 4, 8), (2, 4, 8), (1, 16, 8),
            (1, 8, 4), (4, 8, 4), (1, 16, 4), (4, 8, 2), (2, 16, 2), (4, 8, 1),
            (1, 32, 1)]


def build_variant(r: int, warps: int, cluster: int):
    os.makedirs(pallas_nn.BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(pallas_nn.BUILD_DIR, f"libisl_nn_r{r}_w{warps}_c{cluster}.so")
    cmd = [pallas_nn._nvcc(), *pallas_nn.NVCC_FLAGS, "-Xptxas", "-v",
           f"-DISL_NN_R={r}", f"-DISL_NN_WARPS={warps}", f"-DISL_NN_CLUSTER={cluster}",
           "-o", lib_path, pallas_nn.SOURCE]
    return lib_path, cmd


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(chip_smoke.gpu_name_and_power())
    cfg = chip_smoke.slice_config(config.SlamConfig())
    src, tgt, mask = chip_smoke.kernel_sets(dev, cfg)["keyframe_clouds"]
    pi, pd = pallas_nn.nearest_neighbor_plain(src, tgt, mask)
    builds = [build_variant(*v) for v in VARIANTS]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for _, cmd in builds]
    packed = pallas_nn.pack_targets(tgt, mask)
    idx = torch.empty(src.shape[0], dtype=torch.int32, device=dev)
    dist = torch.empty(src.shape[0], dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = []
    for v, (lib_path, _), proc in zip(VARIANTS, builds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"variant {v}: nvcc failed\n{out}")
            continue
        regs = [l for l in out.splitlines() if "registers" in l]
        lib = ctypes.CDLL(lib_path)
        lib.isl_nn_packed_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] \
            + [ctypes.c_void_p] * 3
        lib.isl_nn_packed_launch.restype = ctypes.c_int
        args = (src.data_ptr(), packed.data.data_ptr(), packed.count.data_ptr(),
                src.shape[0], idx.data_ptr(), dist.data_ptr(), stream)

        def launch(_i=0, lib=lib, args=args):
            rc = lib.isl_nn_packed_launch(*args)
            if rc:
                raise RuntimeError(f"launch failed: {rc}")

        launch()
        torch.cuda.synchronize()
        ok = torch.equal(idx, pi) and torch.equal(dist, pd)
        rows.append((v, ok, regs[-1].strip() if regs else "", launch))
    if "--old" in sys.argv:
        old_src = sys.argv[sys.argv.index("--old") + 1]
        old_lib = os.path.join(pallas_nn.BUILD_DIR, "libisl_nn_old.so")
        subprocess.run([pallas_nn._nvcc(), *pallas_nn.NVCC_FLAGS, "-o", old_lib,
                        old_src], check=True)
        old = ctypes.CDLL(old_lib)
        old.isl_nn_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p] * 3
        old.isl_nn_launch.restype = ctypes.c_int
        oargs = (src.data_ptr(), tgt.data_ptr(), mask.data_ptr(), src.shape[0],
                 tgt.shape[0], idx.data_ptr(), dist.data_ptr(), stream)
        for rnd in range(2):
            per = chip_smoke.time_cuda_batch(lambda _i: old.isl_nn_launch(*oargs), 33)
            dus = chip_smoke.kernel_device_us(lambda: old.isl_nn_launch(*oargs),
                                              "nn_kernel")
            print(f"round {rnd} previous source {old_src}: 33-launch "
                  f"{per * 1e3:.2f} us each, device {dus:.2f} us")
    for rnd in range(2):
        for v, ok, regs, launch in rows:
            per = chip_smoke.time_cuda_batch(launch, 33)
            dus = chip_smoke.kernel_device_us(launch, "nn_packed_kernel")
            print(f"round {rnd} R={v[0]} warps={v[1]} cluster={v[2]}: identical={ok} "
                  f"33-launch {per * 1e3:.2f} us each, device {dus:.2f} us; {regs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
