"""intensity_slam_tpu_torch — the PyTorch/CUDA port of intensity_slam_tpu.

A second package beside the JAX one (which stays the reference): the same
module layout, public function names, argument order, array layouts and
NamedTuple fields, written as plain functions on torch tensors.  It imports
torch and numpy only — never JAX and nothing of `intensity_slam_tpu`.

Rules the whole package keeps:

- Explicit device.  Every `init_state` and entry point takes `device=`,
  default "cuda"; functions on tensors run where their inputs live.
- Kernel dispatch by tensor device.  A hand-written kernel's wrapper
  launches the CUDA kernel for CUDA tensors (or raises) and runs its plain
  PyTorch version for CPU tensors; there is no fallback and no switch.
- No TF32.  Corner responses and descriptor bits are compare-based and flip
  under TF32 rounding, so importing the package sets
  `torch.backends.cuda.matmul.allow_tf32 = False` and
  `torch.backends.cudnn.allow_tf32 = False`.

Ported so far (the main path, slices 1 to 4): `utils.se3`, `utils.index`
(reads and writes at a device-side index without a host read),
`ops.projection`, `ops.conv2d`, `ops.features`, `ops.solver`,
`ops.curvature`, `ops.ground`, `ops.grid_hash` (the voxel map), `ops.voxel`,
`ops.scancontext`, `ops.bow`, `ops.pallas_nn` (CUDA nearest-neighbour
kernels, `csrc/nn.cu`), `ops.icp`, `pipeline.odometry`, `pipeline.geometric`,
`pipeline.mapping` (scan-to-map), `pipeline.slam` (the per-frame step),
`pipeline.posegraph`, `pipeline.loop`, `pipeline.fused` (the fused step and
its ring log), `pipeline.system` (`SlamSystem`), `runtime.spill`,
`io.synthetic` (noise-free renderer) and `interop`; then the streaming
runtime, checkpoints, the whole renderer and the A-LOAM path (slice 5), and
`parallel` (slice 6: the distributed back-end behind `SlamSystem.refine`,
over `torch.distributed` process groups).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
