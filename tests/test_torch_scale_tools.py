"""The port's scale-out tools (`tools/torch_{multiproc_product,scaling_bench,
scaling_projection}.py`) on the CPU.

- `synth_product_state`: the JAX tool's (`tools/multiproc_product.py`,
  whose module imports no JAX at its top) and the port's, from the same
  `np.random.default_rng(7)` draws at `product_config(small=True)` (192
  keyframes, a lap and a quarter of the circuit, so that 102 loop edges
  close), carried across with `interop`.  Integers and booleans are equal;
  floats differ by the float32 rounding of the two packages'
  `circuit_trajectory` (the graph's quaternions are the trajectory's: up
  to 2 steps in a component), which the feature observations carry over a
  lever of up to ~60 m: 2.4e-7 on quaternions, 2e-5 m on positions.  Then both packages' dense
  `posegraph.optimize` on the reference's state agree within 5e-4, the
  tolerance of tests/test_torch_dist_pgo.py (the sums run in another
  order).
- `torch_multiproc_product --device cpu --procs 2 --small`: two gloo ranks
  spawned through `parallel.multiproc.launch`; the cross-rank PGO and the
  sharded refine within 1e-3 m of the dense and single-rank solves, the
  reference's record keys (`MULTIPROC_r05.json`) plus `device`.
- `torch_scaling_bench --device cpu --devices 2 --small` twice: the same
  count of `all_reduce` calls per sharded solve in both runs, sharded
  poses within 1e-3 m of the unsharded ones.
- `torch_scaling_projection --small`: `collective_bytes_per_solve` is the
  JAX tool's GN * (36 K^2 + 6 K) * 4 (`tools/scaling_projection.py:110`)
  and the record has its keys (`SCALING_r04.json`).
- Each tool's default `--out` starts with `RESULTS_torch_`; each tool's
  default device is the card, and without one it raises.
"""

import dataclasses
import json
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT))

import multiproc_product  # noqa: E402
import torch_multiproc_product  # noqa: E402
import torch_scaling_bench  # noqa: E402
import torch_scaling_projection  # noqa: E402

from intensity_slam_tpu import config as JC  # noqa: E402
from intensity_slam_tpu.pipeline import posegraph as JP  # noqa: E402
from intensity_slam_tpu_torch import interop  # noqa: E402
from intensity_slam_tpu_torch.pipeline import posegraph as TP  # noqa: E402

torch.set_num_threads(1)
EPS32 = float(np.finfo(np.float32).eps)
Q_ATOL, M_ATOL = 2 * EPS32, 2e-5
PGO_TOL = 5e-4
TOOLS = {"multiproc_product": torch_multiproc_product, "scaling_bench": torch_scaling_bench,
         "scaling_projection": torch_scaling_projection}


def _read(path) -> dict:
    with open(path) as f:
        return json.load(f)


def _jax_small_config():
    cfg = torch_multiproc_product.product_config(small=True)
    j = JC.small_test_config()
    return j.replace(
        feature=dataclasses.replace(j.feature, num_features=cfg.feature.num_features),
        loop=dataclasses.replace(j.loop, max_keyframes=cfg.loop.max_keyframes))


def _leaves(tree, name=""):
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), f"{name}.{f}")
    else:
        yield name, np.asarray(tree)


@pytest.fixture(scope="module")
def states():
    jcfg = _jax_small_config()
    ref = jax.tree.map(np.asarray, multiproc_product.synth_product_state(jcfg))
    port = interop.state_to_numpy(torch_multiproc_product.synth_product_state(
        torch_multiproc_product.product_config(small=True), device="cpu"))
    return jcfg, ref, port


def test_synth_product_state_equals_the_reference(states):
    _, ref, port = states
    assert int(ref.num_kf) == 192 and int(ref.graph.num_loops) == 102
    for (name, a), (_, b) in zip(_leaves(ref), _leaves(port)):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype.kind in "biu":
            assert np.array_equal(a, b), name
        else:
            atol = Q_ATOL if name.endswith(".q") else M_ATOL
            np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=name)


def test_dense_pgo_agrees_on_the_product_state(states):
    jcfg, ref, _ = states
    lc = jcfg.loop
    kw = dict(gn_iters=lc.pgo_gn_iters, odo_noise=lc.odom_noise, prior_noise=lc.prior_noise,
              loop_cauchy_c=lc.loop_cauchy_c, drift_rate=lc.loop_drift_rate,
              drift_rot_rate=lc.loop_drift_rot_rate)
    jg = JP.optimize(ref.graph, **kw)
    tg = TP.optimize(interop.state_from_numpy(ref.graph, device="cpu"), **kw)
    np.testing.assert_allclose(tg.poses.t.numpy(), np.asarray(jg.poses.t), atol=PGO_TOL)
    np.testing.assert_allclose(tg.poses.q.numpy(), np.asarray(jg.poses.q), atol=PGO_TOL)
    # the solve moved the drifted chain
    assert np.abs(np.asarray(jg.poses.t) - ref.graph.poses.t).max() > 0.1


def test_multiproc_product_two_gloo_ranks(tmp_path, capsys):
    out = tmp_path / "mp.json"
    rc = torch_multiproc_product.main(["--device", "cpu", "--procs", "2", "--small",
                                       "--out", str(out), "--timeout", "300"])
    assert rc == 0, capsys.readouterr().out
    res = _read(out)
    assert set(res) == set(_read(ROOT / "MULTIPROC_r05.json")) | {"device"}
    assert res["processes"] == 2 and res["collective_backend"].startswith("gloo")
    assert res["graph_nodes"] == 192 and res["loop_edges"] == 102
    assert res["pgo_max_abs_dt_vs_dense_reference_m"] < 1e-3
    assert res["refine_max_abs_dt_vs_single_process_m"] < 1e-3
    assert res["ba_observations"] > 0 and res["ba_cost_final"] < res["ba_cost_initial"]
    assert res["pgo_ate_after_m"] < res["pgo_ate_before_m"]


def test_scaling_bench_counts_collectives(tmp_path, capsys):
    runs = []
    for k in range(2):
        out = tmp_path / f"sb{k}.json"
        assert torch_scaling_bench.main(["--device", "cpu", "--devices", "2", "--small",
                                         "--reps", "1", "--out", str(out)]) == 0
        runs.append(_read(out))
    capsys.readouterr()
    counts = [r["sections"]["collective_count"]["per_devices"]["2"]["ba_all_reduce_ops"]
              for r in runs]
    assert counts[0] == counts[1] > 0
    weak = runs[0]["sections"]["weak_scaling_partition_overhead"]["per_devices"]["2"]
    assert weak["max_abs_dt_sharded_vs_unsharded_m"] < 1e-3
    assert weak["total_poses"] == 16 and runs[0]["device"] == "cpu"
    assert set(runs[0]["sections"]) == {"weak_scaling_partition_overhead",
                                        "collective_count", "single_device_solve_vs_size"}


def test_scaling_projection_bytes(tmp_path, capsys):
    out = tmp_path / "proj.json"
    assert torch_scaling_projection.main(["--device", "cpu", "--small", "--reps", "1",
                                          "--out", str(out)]) == 0
    capsys.readouterr()
    res = _read(out)
    K, GN = res["graph"]["K"], res["graph"]["gn_iters"]
    assert (K, GN) == (64, 3)
    assert res["collective_bytes_per_solve"] == GN * (36 * K * K + 6 * K) * 4
    ref = _read(ROOT / "SCALING_r04.json")
    assert set(res) == set(ref)
    assert set(res["measured_single_chip"]) == \
        set(ref["measured_single_chip"]) - {"platform"} | {"device"}
    assert set(res["assumptions"]) == set(ref["assumptions"]) | {"ici_link", "dcn_link"}
    assert [p["chips"] for p in res["projection_ici"]] == [2, 4, 8]
    assert [p["chips"] for p in res["projection_dcn_hosts"]] == [2, 4]


@pytest.mark.parametrize("name", list(TOOLS))
def test_default_out_is_the_port_s(name):
    assert os.path.basename(TOOLS[name].OUT).startswith("RESULTS_torch_")


@pytest.mark.parametrize("name", list(TOOLS))
def test_default_device_is_the_card(name):
    """Each tool checks the device before it spawns a rank or builds a
    problem."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        TOOLS[name].main([])
