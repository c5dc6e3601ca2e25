"""Each cell's path run whole on the CPU at `small_test_config` sizes, from
a throwaway checkout whose cells were added as files alone (`dryrun`):
the run prints a last line of the contract's shape, and a program broken
underneath comes out not correct."""

import json

import pytest
import torch

from intensity_slam_tpu_torch.pipeline import frame_graph, fused
from intensity_slam_tpu_torch.utils.tree import clone_state, donate
from slambench import run, spec
from slambench.tests import dryrun

SEED = 2 ** 31 + 4242


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    # few threads a process: under parallel workers the CPU's frames would
    # otherwise slow many times over, and a replay checks its second pass
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("checkout")
    yield str(root), dryrun.make(str(root))
    torch.set_num_threads(threads)


def _run(bench, cell, traced=False):
    root, b = bench
    c = spec.Cell(b, cell, root)
    return run.execute(c, SEED, dryrun.SECONDS[cell], traced, "cpu", 0.0, "cpu")


@pytest.mark.parametrize("cell", sorted(dryrun.CELLS))
@pytest.mark.parametrize("traced", [False, True])
def test_last_line_has_the_contract_shape(bench, cell, traced, capsys):
    result, lines, checks = _run(bench, cell, traced)
    run.emit(result, lines, checks)
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert list(last)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(last)
    assert last["correct"] is True and last["attempted"] > 0 and last["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(last["device"])
    c = spec.Cell(bench[1], cell, bench[0])
    wanted = c.per_layer if traced else c.end_to_end
    assert set(last["metrics"]) <= {m["name"] for m in wanted}
    if not traced:
        assert set(last["metrics"]) == {m["name"] for m in wanted}
        assert all(v["value"] > 0 for v in last["metrics"].values())
    else:
        assert "breakdown" in last and "busy_s" in last["device"]
    assert err.strip().splitlines()[-1].startswith("checked_steps ")
    assert set(last["checks"]) == set(c.limits) | {"checked_steps"}


def _unchanged_frame(monkeypatch):
    orig = frame_graph.FrameGraph._frame

    def frame(self):
        before = clone_state(self.state)
        out = orig(self)
        donate(self.state, before)
        return out
    monkeypatch.setattr(frame_graph.FrameGraph, "_frame", frame)


def _altered_pose(monkeypatch):
    orig = fused.append_log

    def append_log(*a, **kw):
        log, info = orig(*a, **kw)
        return log, info._replace(pose_t=info.pose_t + 0.05)
    monkeypatch.setattr(fused, "append_log", append_log)


@pytest.mark.parametrize("cell,fault", [
    ("tiny.replay", _unchanged_frame), ("tiny.replay", _altered_pose),
    ("tiny.live", _unchanged_frame), ("tiny.live", _altered_pose)],
    ids=lambda x: x if isinstance(x, str) else x.__name__.strip("_"))
def test_a_broken_step_is_not_correct(bench, cell, fault, monkeypatch):
    fault(monkeypatch)
    result, _, _ = _run(bench, cell)
    assert result["correct"] is False
    checks = result["checks"]
    assert (checks["decisions"]["value"] > 0
            or checks["pose_gap_m"]["value"] > checks["pose_gap_m"]["limit"])


def test_control_runs_the_reference_in_the_program_place(bench):
    root, b = bench
    c = spec.Cell(b, "tiny.replay", root)
    r = c.kind_module().run(c, SEED, dryrun.SECONDS["tiny.replay"], False, "cpu")
    numbers, checked, _ = r["check"](control=True)
    assert checked > 0 and numbers["decisions"] == 0
    assert numbers["ate_m"] == 0.0      # a whole run's numbers are the program's alone
    if not torch.cuda.is_available():       # TF32 is a CUDA precision
        assert numbers["pose_gap_m"] == 0.0 and numbers["rot_gap"] == 0.0
