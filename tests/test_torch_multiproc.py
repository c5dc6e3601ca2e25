"""The distributed back-end across two OS processes: the port's counterpart
of tests/test_multiproc.py.

`parallel.multiproc.launch` spawns two gloo workers on localhost (CPU
tensors; each `python -m intensity_slam_tpu_torch.parallel.multiproc
--worker N`), each building the same live system.  The workers check, and
the JSON record of rank 0 shows, that the cross-process pose-graph solve
(`dist_pgo.optimize_shmap`, loop edges split over the ranks) and the
sharded-store refine (`dist_backend.shard_backend_state` + `refine`, BA
observations split over the ranks) agree with the single-process solves to
1e-3 m, and that each rank held only its block of the keyframe store (plus
the one keyframe before it).  The launcher kills both workers if either
fails or the time limit passes, so a worker cannot hang the suite.
"""

import json

from intensity_slam_tpu_torch.parallel import multiproc


def test_two_process_distributed_backend(tmp_path):
    out = str(tmp_path / "multiproc.json")
    rc = multiproc.launch(2, out, timeout_s=300)
    assert rc == 0, "a worker failed (see its output above)"
    with open(out) as f:
        art = json.load(f)
    assert art["ok"] and art["processes"] == 2 and art["collective_backend"] == "gloo"
    assert art["pgo_max_abs_dt_vs_dense_reference_m"] < 1e-3
    assert art["refine_max_abs_dt_vs_single_process_m"] < 1e-3
    assert art["live_keyframes"] >= 4
    assert art["ba_observations"] > 0
    K = art["keyframe_slots"]
    assert art["keyframe_rows_per_rank"] == [K // 2, K // 2 + 1]


def test_launcher_kills_the_workers_at_its_time_limit():
    """Past `timeout_s` the launcher kills the workers and reports 124
    (ORed with their kill codes) instead of waiting on."""
    rc = multiproc.launch(2, None, timeout_s=0.5, retries=0)
    assert rc & 124 == 124
