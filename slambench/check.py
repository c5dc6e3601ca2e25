"""How `correct` is decided: the program's sampled steps against the
reference's steps from the same state (see `slambench.reference`).

Inside the window the harness copies the program's state into buffers made
in set-up (`Pool`): before and after each step it keeps (`Watch`), and at
the start and the end of the run of steps it watches.  Once the window has
closed, the reference redoes each kept step from the copy before it and the
raw scan, and `compare_*` reads these numbers:

- `decisions`: the decisions and counts that differ (flags, keyframe and
  loop ids, counts, the loop table; at the start every leaf of the state);
  exact, limit 0;
- `pose_gap_m`: the largest gap of a position the step wrote (the frame's
  pose, its log row, the keyframe graph's poses, the exported trajectory);
- `rot_gap`: the largest gap of a unit quaternion's component, the sign
  aligned;
- `loop_gap_m`: the largest gap of a loop edge's measured translation (the
  ICP's result) in the pose graph, printed and held to no limit: sound runs
  reach the lower precision's readings on one seed in twelve;
- `ate_m`, `rpe_m`: the exported (PGO-corrected) trajectory against the
  rendered poses, which the reference does not make: the RMS of the
  position errors and of the errors of each frame's motion.  The one
  witness independent of the port's algorithm (the reference is a frozen
  copy of it).

A cell's limits file names the numbers it is held to; `verdict` holds
each to its limit and `lines` prints them."""

from __future__ import annotations

import math
import random

import numpy as np
import torch

from intensity_slam_tpu_torch.utils.tree import leaves, map_leaves

NUMBERS = ("decisions", "pose_gap_m", "rot_gap", "loop_gap_m", "ate_m", "rpe_m")


def tensors(state) -> list:
    """The tensors of a state tree, in leaf order."""
    return [x for x in leaves(state) if isinstance(x, torch.Tensor)]


def p95(xs) -> float:
    """The 95th percentile (nearest rank) of every sample."""
    s = sorted(xs)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


class Pool:
    """`n` buffers shaped like the tensors `like`, made in set-up, so that a
    copy inside the window allocates nothing.  Making them resets the
    device's peak; `program_peak()` is the peak without them."""

    def __init__(self, like: list, n: int):
        dev = like[0].device
        self.cuda = dev.type == "cuda"
        self.device = dev
        self.peak_before = torch.cuda.max_memory_allocated(dev) if self.cuda else 0
        a0 = torch.cuda.memory_allocated(dev) if self.cuda else 0
        self.free = [[torch.empty_like(t) for t in like] for _ in range(n)]
        self.bytes = torch.cuda.memory_allocated(dev) - a0 if self.cuda else 0
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(dev)

    def program_peak(self) -> int:
        """The device's peak allocation with the pool's buffers left out
        (they stay allocated from their making on)."""
        if not self.cuda:
            return 0
        return max(self.peak_before, torch.cuda.max_memory_allocated(self.device) - self.bytes)

    def take(self, src: list):
        if not self.free:
            return None
        buf = self.free.pop()
        torch._foreach_copy_(buf, src)
        return buf

    def give(self, buf) -> None:
        self.free.append(buf)


class Plan:
    """Which steps to keep: the first `quota[c]` steps of each category c
    (the first category a step's flags match, in the order of `quota`), and
    `random` more drawn from the seed among the watched steps."""

    def __init__(self, quota: dict, seed: int, first: int, count: int):
        quota = dict(quota)
        n_random = int(quota.pop("random", 0))
        self.left = {c: int(v) for c, v in quota.items()}
        rng = random.Random(int(seed) ^ 0x51A3B)
        self.random = set(rng.sample(range(first, first + count), min(n_random, count)))

    def wants(self, k: int, flags: dict) -> str | None:
        for c, left in self.left.items():
            if left > 0 and flags.get(c, False):
                self.left[c] -= 1
                return c
        return "random" if k in self.random else None

    def needs(self, k: int) -> bool:
        """Any step may be kept: its flags decide after it."""
        return True


class Chosen:
    """A plan whose steps were chosen beforehand, from the flags of an
    earlier run of the same steps: `{k: why}`."""

    def __init__(self, chosen: dict):
        self.chosen = dict(chosen)

    def wants(self, k: int, flags: dict) -> str | None:
        return self.chosen.get(k)

    def needs(self, k: int) -> bool:
        return k in self.chosen


class Watch:
    """Copies of the state around the kept steps of one run of steps.
    `tensors()` gives the state's tensors, `gen_state()` its generator's
    state (or None).  `plan.needs(k)` says before step k whether it may be
    kept, so that its before-copy is taken (a step's after-copy is the next
    one's before-copy), and `plan.wants(k, flags)` after it whether it is;
    a copy no kept step needs goes back to the pool."""

    def __init__(self, pool: Pool, tensors, gen_state, plan):
        self.pool, self.tensors, self.gen_state, self.plan = pool, tensors, gen_state, plan
        self.kept: list[dict] = []
        self.prev = None
        self.start = None
        self.end = None
        self.open = False

    def _take(self):
        buf = self.pool.take(self.tensors())
        return None if buf is None else (buf, self.gen_state())

    def begin(self, k: int) -> None:
        """Start watching before step k: the copy of the start."""
        self.start = self._take()
        self.prev = self.start if self.plan.needs(k) else None
        self.open = self.start is not None

    def step(self, k: int, out, flags: dict) -> None:
        if not self.open:
            return
        before, self.prev = self.prev, None
        why = self.plan.wants(k, flags) if before is not None else None
        after = None
        if why is not None or self.plan.needs(k + 1):
            after = self._take()
            if after is None:    # out of buffers: keep what was kept
                self.open = False
                return
        if why is not None:
            self.kept.append(dict(k=k, why=why, before=before, after=after, out=out))
        elif before is not None and not self._pinned(before):
            self.pool.give(before[0])
        self.prev = after if self.plan.needs(k + 1) else None

    def finish(self) -> None:
        """Copy the state after the last step and stop watching."""
        if self.open:
            self.end = self.prev if self.prev is not None else self._take()
        self.open = False

    def _pinned(self, snap) -> bool:
        return snap is self.start or any(snap is r["before"] or snap is r["after"]
                                         for r in self.kept)


def unflatten(skeleton, tensors: list, gen_state=None):
    """The tree `skeleton` with its tensors replaced, in leaf order, by
    `tensors`, and its generator by a new one in `gen_state`."""
    it = iter(tensors)

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return next(it)
        if isinstance(x, torch.Generator):
            g = torch.Generator(device=x.device)
            g.set_state(gen_state if gen_state is not None else x.get_state())
            return g
        return x
    return map_leaves(skeleton, leaf)


# ---- the numbers ------------------------------------------------------------

def _t_gap(a, b) -> float:
    a, b = torch.as_tensor(a).double().cpu(), torch.as_tensor(b).double().cpu()
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb):
        return float("inf")
    return float((a[fa] - b[fa]).abs().max()) if bool(fa.any()) else 0.0


def _q_gap(a, b) -> float:
    a, b = torch.as_tensor(a).double().cpu(), torch.as_tensor(b).double().cpu()
    if a.numel() == 0:
        return 0.0
    d = torch.minimum((a - b).abs().amax(-1), (a + b).abs().amax(-1))
    return float(d.max())


def _differ(a, b) -> int:
    a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
    return int(a.shape != b.shape or not torch.equal(a, b))


def fresh() -> dict:
    return dict.fromkeys(NUMBERS, 0)


def merge(acc: dict, one: dict) -> dict:
    """`decisions` add up; every other number is the largest gap."""
    return {k: acc[k] + one[k] if k == "decisions" else max(acc[k], one[k]) for k in acc}


def compare_start(prog_tensors: list, prog_gen, ref_tensors: list, ref_gen) -> dict:
    """The program's state at the start of a run of steps against the
    reference's initial state: every leaf equal."""
    n = sum(_differ(a, b) for a, b in zip(prog_tensors, ref_tensors))
    n += abs(len(prog_tensors) - len(ref_tensors))
    if (prog_gen is None) != (ref_gen is None) or (
            prog_gen is not None and not torch.equal(prog_gen, ref_gen)):
        n += 1
    return dict(fresh(), decisions=n)


def compare_frame(cfg, prog, pinfo, ref, rinfo) -> dict:
    """One intensity frame: the program's state after it (`prog`) and its
    `FrameInfo` against the reference's."""
    cap = cfg.log_capacity
    row = (int(ref.log.count) - 1) % cap
    dec = sum(_differ(getattr(pinfo, f), getattr(rinfo, f)) for f in (
        "is_keyframe", "skip", "num_good", "loop_found", "loop_idx", "num_kf", "compacted"))
    dec += _differ(torch.isfinite(pinfo.icp_fitness), torch.isfinite(rinfo.icp_fitness))
    pl, rl, pg, rg = prog.log, ref.log, prog.backend.graph, ref.backend.graph
    dec += sum(_differ(a, b) for a, b in (
        (pl.count, rl.count), (pl.num_skips, rl.num_skips), (pl.kf[row], rl.kf[row]),
        (pl.skip[row], rl.skip[row]), (prog.backend.num_kf, ref.backend.num_kf),
        (pg.node_valid, rg.node_valid), (pg.num_loops, rg.num_loops),
        (pg.loop_valid, rg.loop_valid), (pg.loop_i, rg.loop_i), (pg.loop_j, rg.loop_j)))
    valid = rg.node_valid.bool()
    loops = rg.loop_valid.bool()
    pose = max(_t_gap(pinfo.pose_t, rinfo.pose_t), _t_gap(pl.t[row], rl.t[row]),
               _t_gap(pl.ot[row], rl.ot[row]),
               _t_gap(prog.slam.merged_pose.t, ref.slam.merged_pose.t),
               _t_gap(pg.poses.t[valid], rg.poses.t[valid]))
    rot = max(_q_gap(pl.q[row], rl.q[row]), _q_gap(pl.oq[row], rl.oq[row]),
              _q_gap(prog.slam.merged_pose.q, ref.slam.merged_pose.q),
              _q_gap(pg.poses.q[valid], rg.poses.q[valid]))
    return dict(fresh(), decisions=dec, pose_gap_m=pose, rot_gap=rot,
                loop_gap_m=_t_gap(pg.loop_rel.t[loops], rg.loop_rel.t[loops]))


def compare_export(prog_t: np.ndarray, ref_t: torch.Tensor) -> dict:
    """The program's exported (PGO-corrected) positions against the
    reference's export of the same state."""
    n = prog_t.shape[0]
    dec = int(ref_t.shape[0] < n)
    return dict(fresh(), decisions=dec, pose_gap_m=_t_gap(prog_t, ref_t[:n]))


def trajectory_errors(est: np.ndarray, gt: np.ndarray) -> dict:
    """`ate_m` and `rpe_m` of exported positions `est` (N, 3) against the
    rendered positions `gt`, both relative to the first frame, over the
    frames both have."""
    n = min(len(est), len(gt))
    if n < 2:
        return dict(fresh(), decisions=1)
    d = np.asarray(est[:n], np.float64) - np.asarray(gt[:n], np.float64)
    motion = np.diff(d, axis=0)
    return dict(fresh(), ate_m=float(np.sqrt(np.mean(np.sum(d * d, -1)))),
                rpe_m=float(np.sqrt(np.mean(np.sum(motion * motion, -1)))))


def verdict(numbers: dict, limits: dict, checked: int) -> bool:
    """Each number that the cell's limits name within its limit, and at
    least one step checked."""
    return checked > 0 and all(numbers[k] <= limits[k] for k in limits)


def lines(numbers: dict, limits: dict, checked: int) -> list[str]:
    out = [f"{k} {numbers[k]!r} limit {limits[k]!r}" for k in limits]
    return out + [f"checked_steps {checked} limit >= 1"]
