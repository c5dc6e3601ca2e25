"""Process groups, placement and the collectives of the distributed back-end.

PyTorch counterpart of `intensity_slam_tpu/parallel/multiproc.py`.  JAX
shards over a `Mesh` of devices, and one process may hold several of them.
Torch has no virtual devices: here ONE RANK IS ONE DEVICE, and a mesh is a
`Mesh`: a `torch.distributed` process group, this rank's index, the world
size, the axis name and the rank's device.  `mesh=None` everywhere means one
device, the same math and no collective.

* `initialize` joins this process to a process group; it replaces
  `jax.distributed.initialize`.  The caller picks the backend: NCCL for CUDA
  tensors, gloo for CPU tensors.  The reference's `local_devices` has no
  counterpart, since a rank holds one device.
* `put_global` / `tree_put_global`: every rank already holds the same value
  whole, so placing it replicated moves it to the rank's device, and placing
  it sharded over the axis takes this rank's block of rows.
* `fetch_replicated` is `.cpu().numpy()`: a replicated value is whole on
  every rank.
* `all_reduce` / `all_gather_rows` are the only collectives the back-end
  makes.  A group whose backend does not match the tensors' device raises:
  gloo would stage CUDA tensors through the host, a hidden fallback.
* `launch` and the worker entry run the two-process check of the back-end
  (the port's counterpart of `tools/multiproc_dryrun.py`):

      python -m intensity_slam_tpu_torch.parallel.multiproc [--procs 2] [--out PATH]

  spawns `--procs` gloo workers on this host (CPU tensors), which build the
  same live system, then run the cross-process pose-graph solve and the
  sharded-store refine and hold both to the single-process solve; rank 0
  writes the JSON record to `--out`.  `launch(..., module=...)` spawns
  another worker the same way (the scale-out tools' ranks).
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

_BACKEND_OF = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One axis of ranks, each holding one device."""

    group: object            # torch.distributed ProcessGroup
    rank: int
    size: int
    device: torch.device
    axis: str = "data"

    @classmethod
    def world(cls) -> "Mesh":
        """The whole world as this process joined it; the device follows the
        group's backend (NCCL: the current CUDA device, gloo: the CPU)."""
        group = dist.group.WORLD
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend(group) == "nccl" else torch.device("cpu"))
        return cls(group=group, rank=dist.get_rank(group),
                   size=dist.get_world_size(group), device=device)


def initialize(process_id: int, num_processes: int,
               coordinator: str = "127.0.0.1:12377", backend: str = "gloo",
               timeout_s: float = 300.0) -> Mesh:
    """Join this process to a process group of `num_processes` ranks over
    TCP at `coordinator` (host:port); returns the world mesh.  Collectives
    that wait longer than `timeout_s` raise instead of hanging."""
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", rank=process_id,
        world_size=num_processes, timeout=datetime.timedelta(seconds=timeout_s))
    return Mesh.world()


def _check(x: torch.Tensor, mesh: Mesh) -> None:
    backend = dist.get_backend(mesh.group)
    want = _BACKEND_OF.get(x.device.type)
    if backend != want:
        raise ValueError(f"a {backend} group cannot reduce {x.device.type} tensors "
                         f"(use {want})")


def all_reduce(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Sum of `x` over the mesh's ranks, in place (`x` itself without a
    mesh)."""
    if mesh is not None:
        _check(x, mesh)
        dist.all_reduce(x, group=mesh.group)
    return x


def all_gather_rows(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """The ranks' equal-shape blocks of rows `x`, concatenated in rank
    order."""
    if mesh is None:
        return x
    _check(x, mesh)
    out = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(out, x.contiguous(), group=mesh.group)
    return torch.cat(out)


def row_block(n: int, mesh: Mesh | None) -> tuple[int, int]:
    """[lo, hi) of this rank's contiguous block of `n` rows: blocks of
    ceil(n / size) rows in rank order, the last ones shorter or empty."""
    if mesh is None:
        return 0, n
    b = -(-n // mesh.size)
    lo = min(mesh.rank * b, n)
    return lo, min(lo + b, n)


def put_global(x: torch.Tensor, mesh: Mesh, spec: str | None = None) -> torch.Tensor:
    """Place `x` (identical on every rank) on the mesh: `spec=None`
    replicated (the whole value on this rank's device), `spec=axis` sharded
    over its rows (this rank's block)."""
    if spec is not None:
        if spec != mesh.axis:
            raise ValueError(f"the mesh has axis {mesh.axis!r}, not {spec!r}")
        lo, hi = row_block(x.shape[0], mesh)
        x = x[lo:hi]
    return x.to(mesh.device)


def tree_map(fn, tree):
    """`fn` over the tensors of a nest of NamedTuples."""
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def tree_put_global(tree, mesh: Mesh, spec: str | None = None):
    """`put_global` over a nest of NamedTuples with one spec for every
    leaf."""
    return tree_map(lambda a: put_global(a, mesh, spec), tree)


def fetch_replicated(x: torch.Tensor) -> np.ndarray:
    """Host value of a replicated tensor (whole on every rank)."""
    return x.detach().cpu().numpy()


# ---- the two-process check --------------------------------------------------

def worker(pid: int, nproc: int, coordinator: str, out_path: str | None,
           timeout_s: float) -> None:
    """One rank of the check: the same live system on every rank, then the
    cross-process PGO and the sharded-store refine against this process's
    single-process solves."""
    from ..pipeline import posegraph
    from . import dist_backend, dist_pgo, live_demo

    torch.set_num_threads(1)
    mesh = initialize(pid, nproc, coordinator, "gloo", timeout_s)
    try:
        # the channel first, while the ranks are aligned
        probe = all_reduce(torch.tensor([float(pid)]), mesh)
        if float(probe) != nproc * (nproc - 1) / 2:
            raise RuntimeError(f"all_reduce gave {float(probe)}")
        print(f"[worker {pid}] collective channel up", flush=True)

        t0 = time.perf_counter()
        cfg = live_demo.live_config(n_scale=nproc)
        system = live_demo.build_live_system(cfg, frames=12, device="cpu")
        bstate = system.bstate
        n_kf = int(bstate.num_kf)
        t_build = time.perf_counter() - t0
        print(f"[worker {pid}] live state: {n_kf} keyframes ({t_build:.1f}s)", flush=True)
        dist.barrier()

        lc = cfg.loop
        pgo_kw = dict(gn_iters=lc.pgo_gn_iters, cg_iters=cfg.parallel.pgo_cg_iters,
                      odo_noise=lc.odom_noise, prior_noise=lc.prior_noise,
                      loop_cauchy_c=lc.loop_cauchy_c, drift_rate=lc.loop_drift_rate,
                      drift_rot_rate=lc.loop_drift_rot_rate)
        # the live graph, and a drifted line closed by three loops, whose
        # loop edges the ranks share out
        pgo_err, t_pgo = 0.0, 0.0
        for name, g, n in (("live", bstate.graph, n_kf), ("three-loop", _loop_graph(), 32)):
            ref_t = posegraph.optimize(g, **pgo_kw).poses.t[:n].numpy()
            t0 = time.perf_counter()
            mp_t = fetch_replicated(dist_pgo.optimize_shmap(g, mesh, **pgo_kw).poses.t)[:n]
            t_pgo += time.perf_counter() - t0
            err = float(np.abs(mp_t - ref_t).max()) if n else 0.0
            print(f"[worker {pid}] PGO across processes, {name} graph: max |dt| vs the "
                  f"dense solve {err:.2e}", flush=True)
            pgo_err = max(pgo_err, err)
        if not pgo_err < 1e-3:
            raise RuntimeError(f"PGO across processes is {pgo_err} m off")

        t0 = time.perf_counter()
        sharded = dist_backend.shard_backend_state(bstate, mesh)
        rows = [None] * nproc
        dist.all_gather_object(rows, int(sharded.kf_cloud.shape[0]), group=mesh.group)
        res = dist_backend.refine(sharded, cfg, mesh=mesh)
        ref = dist_backend.refine(bstate, cfg, mesh=None)
        t_refine = time.perf_counter() - t0
        got = fetch_replicated(res.state.graph.poses.t)[:n_kf]
        want = ref.state.graph.poses.t[:n_kf].numpy()
        refine_err = float(np.abs(got - want).max()) if n_kf else 0.0
        costs = [float(c) for c in (res.ba_initial_cost, res.ba_final_cost,
                                    ref.ba_initial_cost, ref.ba_final_cost)]
        n_obs = int(res.num_obs)
        print(f"[worker {pid}] refine: {n_obs} BA observations, cost {costs[0]:.5f} -> "
              f"{costs[1]:.5f} (single process {costs[2]:.5f} -> {costs[3]:.5f}), max "
              f"|dt| vs single process {refine_err:.2e}, keyframe rows per rank {rows} "
              f"({t_refine:.1f}s)", flush=True)
        if not refine_err < 1e-3:
            raise RuntimeError(f"the sharded refine is {refine_err} m off")
        if abs(costs[0] - costs[2]) > 1e-4 * max(1.0, abs(costs[2])):
            raise RuntimeError(f"BA initial cost {costs[0]} against {costs[2]}")

        if pid == 0 and out_path:
            K = bstate.graph.node_valid.shape[0]
            with open(out_path, "w") as f:
                json.dump({
                    "processes": nproc,
                    "collective_backend": "gloo",
                    "keyframe_slots": K,
                    "keyframe_rows_per_rank": rows,
                    "live_keyframes": n_kf,
                    "ba_observations": n_obs,
                    "pgo_max_abs_dt_vs_dense_reference_m": pgo_err,
                    "refine_max_abs_dt_vs_single_process_m": refine_err,
                    "ba_cost_initial": costs[0], "ba_cost_final": costs[1],
                    "ba_cost_initial_single_process": costs[2],
                    "ba_cost_final_single_process": costs[3],
                    "build_s": t_build, "dist_pgo_s": t_pgo, "dist_refine_s": t_refine,
                    "ok": True,
                }, f, indent=1)
            print(f"[worker 0] wrote {out_path}", flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _loop_graph():
    """A 32-node line that drifts 2 % a metre, closed by three loops in a
    table of four slots (so that two ranks each hold loops), on the CPU."""
    from ..config import LoopConfig
    from ..pipeline import posegraph
    from ..utils import se3

    ident = torch.tensor([1.0, 0.0, 0.0, 0.0])
    g = posegraph.empty(64, 4, device="cpu")
    step = se3.Pose(ident, torch.tensor([1.02, 0.005, 0.0]))
    pose = se3.Pose.identity(device="cpu")
    for k in range(32):
        pose = se3.compose(pose, step) if k else pose
        g = posegraph.add_node(g, pose)
    for i, j, d in ((0, 31, 31.0), (4, 20, 16.0), (2, 28, 27.5)):
        g = posegraph.add_loop(g, torch.tensor(i), torch.tensor(j),
                               se3.Pose(ident, torch.tensor([d, 0.0, 0.0])),
                               torch.tensor(1e-4), LoopConfig())
    return g


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _kill(ps) -> None:
    for p in ps:
        if p.poll() is None:
            p.kill()
    for p in ps:
        p.wait(timeout=30)


def launch(procs: int, out_path: str | None, timeout_s: float = 600.0,
           retries: int = 1, module: str | None = None, args=()) -> int:
    """Spawn `procs` workers on localhost and wait for them, at most
    `timeout_s` in all per attempt.  Returns the workers' exit codes ORed
    together (124 for a timeout).  A worker that fails ends the attempt at
    once (the others are killed, never left waiting in a collective).  One
    retry by default: the ranks' first connect has a bounded window, and a
    loaded machine can push a worker's start past it.

    The worker is `module` (a dotted module name run with `-m`, or the path
    of a script; this module's own check when None), started as
    `module --worker PID --procs N --coordinator HOST:PORT --timeout S
    [--out PATH] *args`."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    module = __spec__.name if module is None else module
    entry = [module] if module.endswith(".py") else ["-m", module]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    rc = -1
    for attempt in range(retries + 1):
        common = ["--procs", str(procs), "--coordinator", f"127.0.0.1:{_free_port()}",
                  "--timeout", str(timeout_s)] + (["--out", out_path] if out_path else [])
        ps = [subprocess.Popen([sys.executable] + entry + ["--worker", str(pid)] + common
                               + [str(a) for a in args], env=env, cwd=root)
              for pid in range(procs)]
        deadline = time.monotonic() + timeout_s
        rc = 0
        try:
            while any(p.poll() is None for p in ps):
                if time.monotonic() > deadline:
                    rc |= 124
                    break
                if any(p.poll() not in (None, 0) for p in ps):
                    break
                time.sleep(0.1)
        finally:
            _kill(ps)
        for p in ps:
            rc |= p.returncode & 0xFF
        if rc == 0:
            return 0
        print(f"multiproc attempt {attempt + 1} failed rc={rc}"
              + (", retrying" if attempt < retries else ""), file=sys.stderr, flush=True)
    return rc


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--coordinator", type=str, default="127.0.0.1:12377")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args()
    if args.worker is not None:
        worker(args.worker, args.procs, args.coordinator, args.out, args.timeout)
        return 0
    rc = launch(args.procs, args.out, args.timeout)
    print(f"multiproc check {'OK' if rc == 0 else f'FAILED rc={rc}'}",
          file=sys.stdout if rc == 0 else sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
