"""`tools/torch_scaling_multisession.py` on the CPU: B = 1, 2 at
small_test_config over 3 frames (1 warm), its `main(argv)` called in this
process, and `--procs 2` over two gloo processes (spawned through
`parallel.multiproc.launch`), which steps one session a rank with every
collective of `torch.distributed` counted: 0 calls.  The record has the
JAX tool's keys, for the graphed step (`BatchedStepGraph`) and, under
`batch_eager`, for the eager one (`SCALING_r05.json`: `frames_per_stream`,
`batch.{B}.total_scans_per_sec`, `ms_per_step`,
`one_chip_batch8_efficiency` when B = 1 and 8 both ran) and `device`.
The tool's default device is the card, and without one it raises."""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import torch_scaling_multisession as tool  # noqa: E402


def test_batches_and_gloo_ranks(tmp_path, capsys):
    out = tmp_path / "ms.json"
    assert tool.main(["--device", "cpu", "--small", "--batches", "1,2", "--procs", "2",
                      "--out", str(out), "--timeout", "300"]) == 0
    capsys.readouterr()
    res = json.loads(out.read_text())
    ref = json.loads((ROOT / "SCALING_r05.json").read_text())
    assert res["frames_per_stream"] == 3 and res["device"] == "cpu"
    assert set(res["batch"]) == {"1", "2"} and set(res["batch_eager"]) == {"1", "2"}
    for row in list(res["batch"].values()) + list(res["batch_eager"].values()):
        assert set(ref["batch"]["1"]) <= set(row)
        assert row["total_scans_per_sec"] > 0 and row["ms_per_step"] > 0
    assert "one_chip_batch8_efficiency" not in res          # B = 8 did not run
    ops = res["sharded_step_collective_ops"]
    assert sum(ops.values()) == 0 and {"all_reduce", "all_gather", "broadcast"} <= set(ops)
    assert res["sharded_step"] == {"ranks": 2, "sessions": 2, "sessions_per_rank": 1}
    assert "scaling_statement" in res


def test_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tool.main(["--small", "--out", str(tmp_path / "x.json")])
