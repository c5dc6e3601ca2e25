"""The pieces of `correct` on made-up data: the trajectory errors against
the rendered poses, and which steps a `Watch` copies."""

import numpy as np
import pytest
import torch

from slambench import check


def test_trajectory_errors_by_hand():
    gt = np.array([[0.0, 0, 0], [1, 0, 0], [2, 0, 0]])
    est = gt + np.array([[0.0, 0, 0], [0, 0.3, 0], [0, 0.4, 0]])
    e = check.trajectory_errors(est, gt)
    assert e["ate_m"] == pytest.approx(np.sqrt((0.09 + 0.16) / 3))
    assert e["rpe_m"] == pytest.approx(np.sqrt((0.09 + 0.01) / 2))
    assert e["decisions"] == 0
    assert check.trajectory_errors(est[:1], gt)["decisions"] == 1


class Counting(check.Pool):
    def __init__(self, like, n):
        super().__init__(like, n)
        self.takes = 0

    def take(self, src):
        self.takes += 1
        return super().take(src)


def _drive(watch, state, flags, n):
    watch.begin(0)
    for k in range(n):
        state[0] += 1
        watch.step(k, k, flags.get(k, {}))
    watch.finish()


def test_chosen_steps_alone_are_copied():
    state = [torch.zeros(2)]
    pool = Counting(state, 6)
    watch = check.Watch(pool, lambda: state, lambda: None, check.Chosen({3: "keyframe"}))
    _drive(watch, state, {}, 6)
    # the start, the before-copy of step 3 (after step 2), its after-copy, the end
    assert pool.takes == 4
    (rec,) = watch.kept
    assert rec["k"] == 3 and rec["why"] == "keyframe"
    assert float(rec["before"][0][0][0]) == 3 and float(rec["after"][0][0][0]) == 4
    assert float(watch.end[0][0][0]) == 6 and float(watch.start[0][0][0]) == 0


def test_a_plan_from_the_flags_copies_every_step_and_keeps_its_own():
    state = [torch.zeros(2)]
    pool = Counting(state, 5)
    plan = check.Plan({"keyframe": 1}, seed=0, first=0, count=8)
    watch = check.Watch(pool, lambda: state, lambda: None, plan)
    _drive(watch, state, {5: {"keyframe": True}, 6: {"keyframe": True}}, 8)
    assert [r["k"] for r in watch.kept] == [5]
    assert float(watch.kept[0]["before"][0][0][0]) == 5
    assert pool.takes == 1 + 8 and float(watch.end[0][0][0]) == 8
    assert pool.program_peak() == 0          # no card: no device peak
