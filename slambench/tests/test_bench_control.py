"""The control on the card, at the cell's own size over a short window: the
program with its matrix products in TF32 (torch's switch, the precision
below the configurations' float32, set before the graphs are captured)
comes out not correct under the cell's limits, while the program comes
out correct.  A replay's kept steps are in its second pass, so its window
holds two passes."""

import pytest
import torch

from slambench import check, reference, spec

CELLS = {"os0_64.circuit_replay": 20.0, "os0_64.circuit_live_10hz": 8.0}
SEED = 6_100_000_001


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("the control runs on the card (TF32 is a CUDA precision)")
    c = spec.Cell(spec.load_benchmark(), cell)
    r = c.kind_module().run(c, SEED, CELLS[cell], False, "cuda")
    prog, checked, _ = r["check"](control=False)
    assert check.verdict(prog, c.limits, checked), prog
    del r
    with reference.precision(tf32=True):
        r = c.kind_module().run(c, SEED, CELLS[cell], False, "cuda")
    ctl, checked, _ = r["check"](control=False)
    assert checked > 0 and not check.verdict(ctl, c.limits, checked), ctl
    assert ctl["decisions"] > 0 or ctl["pose_gap_m"] > c.limits["pose_gap_m"]
