"""The yardstick of the roofline shares: the operations and bytes a layer's
work needs, counted from the configuration's shapes, and the card's
published peaks.  Whatever implements the work, these counts stay.

A share is the least time the card could take (the larger of operations
over peak FLOP/s and bytes over peak bytes/s) over the device time the
trace measured for the same calls."""

from __future__ import annotations

from typing import NamedTuple


class Peaks(NamedTuple):
    fp32_flops: float       # FLOP/s, float32 outside the tensor cores
    bytes_per_s: float      # device memory


# NVIDIA's H100 SXM data sheet: dense float32 67 TFLOP/s, HBM3 3.35 TB/s, at
# the full 700 W power limit (a card set below it reads against these too)
PEAKS = {"NVIDIA H100 80GB HBM3": Peaks(67e12, 3.35e12)}

F32 = 4
LOOP_SLOTS = 256            # the pose graph's loop-edge slots
DAMPINGS = 3                # Levenberg-Marquardt dampings factored per iteration


class Work(NamedTuple):
    flops: float
    bytes: float

    def least_s(self, peaks: Peaks) -> float:
        return max(self.flops / peaks.fp32_flops, self.bytes / peaks.bytes_per_s)


def pgo(max_keyframes: int, gn_iters: int, loop_slots: int = LOOP_SLOTS,
        dampings: int = DAMPINGS) -> Work:
    """One dense pose-graph optimization as `posegraph.optimize` is
    specified: n = 6 K unknowns; each Gauss-Newton iteration forms the loop
    edges' normal equations (each loop edge's 6 rows touch two 6-column
    blocks: 4 block products of 6x6x6 multiply-adds), then for each damping
    factors the n x n system (n^3/3 multiply-adds) and solves it by two
    triangular solves (n^2 each).  Bytes: each iteration reads the loop
    Jacobian blocks and writes the n x n loop normal matrix, each damping
    reads its matrix and writes its factor, and its two solves read a
    triangle of the factor each."""
    n = 6 * max_keyframes
    gram = loop_slots * 4 * 2 * 6 ** 3
    factor = dampings * n ** 3 / 3.0
    solve = dampings * 2 * n ** 2
    flops = gn_iters * (gram + factor + solve)
    per_iter = loop_slots * 2 * 36 * F32 + n * n * F32 + dampings * 3 * n * n * F32
    return Work(flops, gn_iters * per_iter)


def knn_queries(queries: int, cells: int, slots: int, k: int) -> Work:
    """`queries` k-NN queries each probing `cells` hash cells of `slots`
    points: a squared distance (8 operations) per probed point; reads each
    query point and each probed point once, writes k neighbours (3 floats)
    and their count."""
    flops = queries * cells * slots * 8
    reads = queries * (3 + cells * slots * 3) * F32
    writes = queries * (k * 3 + 1) * F32
    return Work(flops, reads + writes)


# hand counts of the per-query fits and residuals (float operations)
PLANE_FIT = 5 * 18 + 60      # 5 points into a 3x3 system, Cramer's rule
LINE_FIT = 5 * 24 + 220      # mean and 3x3 scatter of 5 points, its eigensystem
PLANE_RES = 15 + 5 + 6 + 42  # transform, residual, Jacobian row, J^T J and J^T r
LINE_RES = 15 + 30 + 3 * 48  # transform, 3 residual rows with their Jacobians


def mapping(cfg) -> Work:
    """One `mapping_step`'s k-NN queries, fits and residuals: the padded
    query capacities of the configuration (plane queries
    `max_query_points`, corner queries half of it), each probing
    `knn_neighborhood` cells of `cell_capacity` points, then `gn_iters`
    Gauss-Newton passes over the residuals."""
    mc = cfg["mapping"]
    qg, qc = mc["max_query_points"], mc["max_query_points"] // 2
    cells, slots, k = mc["knn_neighborhood"], mc["cell_capacity"], mc["knn"]
    knn_g = knn_queries(qg, cells, slots, k)
    knn_c = knn_queries(qc, cells, slots, k) if mc["use_corner_residuals"] else Work(0, 0)
    fits = qg * PLANE_FIT + (qc * LINE_FIT if mc["use_corner_residuals"] else 0)
    res = mc["gn_iters"] * (qg * PLANE_RES + (qc * LINE_RES if mc["use_corner_residuals"] else 0))
    return Work(knn_g.flops + knn_c.flops + fits + res, knn_g.bytes + knn_c.bytes)


def share(work: Work, seconds: list[float], peaks: Peaks) -> float | None:
    """Percent of the roofline over the calls whose device seconds the trace
    read; None where it read none."""
    seconds = [s for s in seconds if s > 0]
    if not seconds or peaks is None:
        return None
    return 100.0 * len(seconds) * work.least_s(peaks) / sum(seconds)
