"""Typed configuration — single source of truth (reference C23).

The PyTorch port's own copy of `intensity_slam_tpu/config.py`: the same
frozen dataclasses, field names and defaults, so a config built by either
package round-trips through `dataclasses.asdict` (`interop.config_from_dict`).
The port imports nothing of the JAX package, this module included.

The reference scatters configuration across the ROS parameter server
(`config/spot.yaml`, `launch/spot.launch`), per-node `getParam` calls
(`src/intensity_feature_tracker.cpp:1101-1124`, `src/mapOptimization.cpp:522-541`,
`src/scanRegistration.cpp:692-695`, `src/loop_closure_handler.cpp:136-139`,
`src/laserOdometry.cpp:265`) and hard-coded constants.  Here everything lives
in frozen dataclasses with the reference values as defaults; each field cites
its source.  Static fields (shapes, capacities, iteration counts) become jit
compile-time constants.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class SensorConfig:
    """Ouster OS0-64 organized scan geometry (`config/spot.yaml:6-10`)."""

    image_width: int = 1024           # spot.yaml:7
    image_height: int = 64            # spot.yaml:8
    image_crop: int = 3               # columns masked at L/R edges, spot.yaml:9
    hand_held: bool = True            # mask operator shadow rows, spot.yaml:10
    min_range: float = 0.1            # zero out closer points, image_handler.h_ouster:126
    range_scale: float = 20.0         # range-image debug gain (CV_8UC1 viz),
    # image_handler.h_ouster:131 — used by tools/visualize.py range dumps
    scan_period: float = 0.1          # ~10 Hz, README.md:153-169
    undistort: bool = False           # constant-velocity motion undistortion
    # to scan start (A-LOAM TransformToStart, `laserOdometry.cpp:147-194`;
    # the reference ships DISTORTION=0, so off by default)
    # Vertical FOV of the SYNTHETIC renderer's beam table (the SLAM side
    # consumes organized clouds and never needs it).  The demo recording's
    # sensor is an Ouster OS0-64 with a 90 deg vertical FOV (+-45 deg,
    # README.md:153); the +-16.6 default is the OS1-64 geometry the
    # round-1..3 benchmark worlds were rendered with, kept as the default
    # so those numbers stay comparable — `os0_64_config()` selects the
    # OS0-exact table and RESULTS_os064.json validates on it.
    fov_up: float = 16.6              # deg, top beam elevation
    fov_down: float = -16.6           # deg, bottom beam elevation

    @property
    def num_points(self) -> int:
        return self.image_width * self.image_height


@dataclass(frozen=True)
class GroundConfig:
    """RANSAC ground extraction (`image_handler.h_ouster:41-100`)."""

    z_min: float = -2.0               # height-band prefilter, :51
    z_max: float = -0.45              # :51
    ransac_iters: int = 256           # batched hypotheses (PCL iterates sequentially)
    dist_threshold: float = 0.01      # setDistanceThreshold, :66
    axis_max_angle_deg: float = 15.0  # setEpsAngle(15°) vs +z, :64-65
    keep_threshold: float = 0.03      # final inlier band, :86


@dataclass(frozen=True)
class FeatureConfig:
    """Intensity-image feature front-end (reference C3, `spot.yaml:13-14`)."""

    num_features: int = 1024          # NUM_ORB_FEATURES=1000, spot.yaml:14 (padded to 2^k)
    detect_multiplier: int = 2        # failure re-detect uses 2x features, intensity_feature_tracker.cpp:652-668
    # (the BRIEF pattern geometry — 256 bits over a 31x13 patch — is a
    # module-level compile-time constant of ops.features (_PATTERN_BITS,
    # _PATCH_X/_PATCH_Y): the dense bit-plane descriptor is built from
    # shifted image differences whose offsets must be Python ints)
    nms_radius: int = 2               # non-max suppression radius on score map
    match_keep_frac: float = 0.3      # keep top 30% matches, intensity_feature_tracker.cpp:640-646
    match_keep_frac_retry: float = 0.2  # 20% on the re-detect path, :684-689
    min_good_matches: int = 4         # good-frame gate, :693
    max_hamming: int = 64             # descriptor distance gate (BFMatcher crossCheck analogue)
    oriented: bool = False            # steer BRIEF by the intensity centroid (ORB's rBRIEF).
    # Default OFF: LiDAR intensity images are gravity-aligned and vehicle yaw
    # appears as a pure column shift, which the unrotated pattern is exactly
    # invariant to; skipping rotation keeps the descriptor computable densely
    # (no gathers) and MORE distinctive.  Set True for handheld/rolling rigs
    # (the reference's ORB behavior, intensity_feature_tracker.cpp:609).


@dataclass(frozen=True)
class OdometryConfig:
    """Scan-to-scan intensity odometry solve (reference C4)."""

    gn_iters: int = 20                # Ceres max_num_iterations=20, intensity_feature_tracker.cpp:921
    huber_delta: float = 0.1          # HuberLoss(0.1), :908
    lm_lambda0: float = 1e-4
    min_hessian_eig: float = 2.0      # degeneracy gate on the weakest solve
    # direction (no reference counterpart in the front-end; same idea as
    # LOAM's mapping eigen check) — tuned on synthetic sequences
    keyframe_time_interval: float = 0.3   # spot.yaml:35
    keyframe_distance_interval: float = 0.3  # spot.yaml:36


@dataclass(frozen=True)
class GeometricConfig:
    """A-LOAM fallback feature extraction + odometry (C11/C12)."""

    min_range: float = 0.3            # remove_radius, spot.yaml:49 / scanRegistration.cpp:695
    num_segments: int = 6             # 6 azimuth segments per ring, scanRegistration.cpp:437
    sharp_per_segment: int = 2        # scanRegistration.cpp:472-486
    less_sharp_per_segment: int = 20  # :487-500
    flat_per_segment: int = 4         # :522-536
    curvature_threshold: float = 0.1  # :456,521
    less_flat_voxel: float = 0.2      # :560-565
    nearby_scan: float = 2.5          # laserOdometry.cpp:90
    dist_sq_threshold: float = 25.0   # laserOdometry.cpp:89
    odom_outer_iters: int = 2         # laserOdometry.cpp:417
    odom_gn_iters: int = 4            # Ceres max_num_iterations=4, laserOdometry.cpp:706
    max_surf_points: int = 2048
    less_flat_column_stride: int = 2  # azimuth subsample before the
    # less-flat voxel dedup: adjacent columns are 0.006*r m apart (2pi/1024)
    # and land in the SAME 0.2 m voxel for r < ~16 m even at stride 2, so
    # the dedup output is near-identical while the O(N log N) dedup sort
    # runs on half the points (measured 1.1 ms -> 0.6 ms on 64x1024)


@dataclass(frozen=True)
class MappingConfig:
    """Scan-to-map back-end (reference C14)."""

    ground_voxel: float = 0.8         # plane res 0.8, spot.launch:5 (mapping surf filter)
    corner_voxel: float = 0.4         # line res 0.4, spot.launch:4
    knn: int = 5
    knn_neighborhood: int = 8         # 8 = 2x2x2 octant block (exact within
    # cell_size/2 = ground_voxel, far beyond the 0.2 m plane gate); 27 = full
    # 3x3x3 (exact within cell_size) at 3.4x the gather traffic                      # 5-NN plane fit, mapOptimization.cpp:379
    plane_valid_threshold: float = 0.2  # point-to-fit-plane validity, :406-414
    gn_iters: int = 10                # Ceres ≤10 iters, :437
    map_capacity: int = 1 << 20       # voxel-hash capacity (points)
    cell_capacity: int = 8            # points per voxel cell
    cell_size: float = 0.4            # hash voxel edge
    max_query_points: int = 2048      # padded per-frame ground+surf points
    # for NN.  r5: the plane core consumes the RANSAC ground AND the
    # less-flat surf cloud (walls); on the +-45 OS0 table nearby ground
    # alone fills ~1100 voxel cells, so 1024 crowded the wall planes out
    # entirely.  Overflow degrades to dropped residuals, never wrong ones.
    # sliding-window visual BA (`mapOptimization.cpp:295-361`): ORB matches
    # against the last `sliding_window_size` mapped frames add point-to-point
    # residuals (`FeatureMatchingResidual`) alongside the ground core.
    # Default 0 = inert, exactly like the shipped yaml (`spot.yaml:46`).
    sliding_window_size: int = 0
    window_min_matches: int = 100     # matches_tmp.size() > 100, `:308`
    window_keep_frac: float = 0.2     # top 20% by distance, `:313-315`
    window_min_good: int = 50         # good_matches_tmp.size() > 50, `:330`
    window_dist_gate: float = 0.3     # map-frame pair distance < 0.3, `:345`
    window_sqrt_info: float = 20.0    # per-axis sqrt-information of a visual
    # match (sigma ~5 cm).  The reference adds FeatureMatchingResidual blocks
    # unwhitened to a problem with NO prior factor; our solve carries the
    # odometry-prediction anchor (prior_sqrt_info), so visual observations
    # need their honest information to override it where they genuinely
    # observe x/y/yaw
    # long-run capacity policy: when a map exceeds map_evict_frac of its
    # point capacity, points farther than map_keep_radius from the current
    # pose are evicted — the reference's rolling 21x21x11 cube-map
    # recentering (`laserMapping.cpp:330-565`, +/-525 m) as one masked pass
    map_keep_radius: float = 400.0
    map_evict_frac: float = 0.8
    downsample_prefilter: int = 16384  # compact masked points to this many
    # before the voxel-dedup sort (ground masks select ~7k of 65k points; the
    # sort is the dominant cost and scales with its input length)
    # odometry-prediction anchor, sqrt-information per tangent axis
    # (roll, pitch, yaw, x, y, z): weak where the ground map observes
    # strongly (roll/pitch/z), strong where it observes nothing (x/y/yaw)
    prior_sqrt_info: tuple = (5.0, 5.0, 100.0, 50.0, 50.0, 2.0)
    # corner point-to-line residuals (r5): the reference's ACTIVE core is
    # ground-plane only (`mapOptimization.cpp:364-430`) — its corner
    # ikd-tree is fed but never used in residuals (`:478-479,504-505`), so
    # x/y/yaw drift passes through scan-to-map uncorrected.  Its own unused
    # laserMapping node (C15, `laserMapping.cpp:665-723`) shows the fix:
    # each corner point takes its 5 map NNs, the neighborhood covariance is
    # eigen-checked for line-ness, and a point-to-line factor constrains
    # the pose.  Measured on the OS0-64 circuit this cuts live mapping ATE
    # ~10x (the ±45 beam table amplifies per-frame odometry noise; see
    # RESULTS_os064.json r5).  When enough line fits exist the x/y/yaw
    # prior drops to `prior_sqrt_info_corner` so the map can override the
    # odometry prediction in the directions it now observes.
    use_corner_residuals: bool = True
    corner_eig_ratio: float = 3.0     # lambda_max > ratio * lambda_mid, laserMapping.cpp:693
    corner_sqrt_info: float = 5.0     # per-axis sqrt-info of a line factor (sigma 0.2 m)
    min_corner_residuals: int = 32    # below this the strong prior stays
    prior_sqrt_info_corner: tuple = (5.0, 5.0, 5.0, 5.0, 5.0, 2.0)
    # on an accepted loop closure, rebuild the ground/corner maps from the
    # per-keyframe downsampled clouds at the OPTIMIZED graph poses (one
    # batched transform + scatter pass).  The reference never corrects its
    # ikd-tree map after a loop — lap-2 geometry keeps being inserted in the
    # drifted frame, smearing the very map the scan-to-map step matches
    # against; a device-resident map makes the full rebuild a few ms.
    rebuild_on_loop: bool = True


@dataclass(frozen=True)
class LoopConfig:
    """Loop detection + ICP verification + PGO (C7-C10, `spot.yaml:27-40`)."""

    # --- strategy switches: the reference hard-switches between three
    # detection strategies (`loop_closure_handler.cpp:94-96`: USE_ORBLOOP
    # true, USE_SCANCONTEXT / kd-radius false).  Here each channel is
    # independently selectable; any channel's candidate goes to ICP verify.
    use_bow_loop: bool = True         # ORB bag-of-words channel (C8)
    use_scancontext: bool = True      # ScanContext channel (C9)
    use_radius_search: bool = False   # kd-radius channel (`:42-84`)
    use_crop: bool = False            # crop submap around current pose, spot.yaml:28
    crop_size: float = 200.0          # crop box half-extent (m), spot.yaml:29
    use_voxel: bool = True            # spot.yaml:31
    voxel_size: float = 0.25          # vf_scan_res, spot.yaml:32
    icp_fitness_score: float = 0.5    # spot.yaml:34
    icp_min_inlier_frac: float = 0.3  # coverage gate (see ops.icp fitness note)
    icp_iters: int = 32               # PCL ICP 100 iters; batched fixed-iter here (intensity_feature_tracker.cpp:220-224)
    icp_max_corr: float = 100.0       # setMaxCorrespondenceDistance, :221
    bow_score_threshold: float = 0.04 # accept gate for the mutual-match
    # descriptor channel (ops.bow): fraction of the current keyframe's
    # strongest descriptors with a MUTUAL <=24-bit match in the candidate.
    # Calibrated on the circuit battery (detector precision 0.94 / recall
    # 0.94 at 0.04; tools/loop_eval.py).  The reference gates DBoW raw
    # scores at min_loop_bow_threshold 0.013 (spot.yaml:38) — a different
    # score scale; like the reference's, this gate proposes aggressively
    # and relies on ICP verification to reject.  (The reference's
    # `skiped_frames` yaml param is read but never used,
    # `loop_closure_handler.cpp:133-139` — omitted here.)
    min_loop_search_gap: int = 20     # spot.yaml:39
    # cooldown after an ACCEPTED loop: skip detection for this many
    # keyframes.  The reference throttles implicitly via its 10 Hz
    # loop-thread cadence + MIN_LOOP_SEARCH_GAP; without a cooldown every
    # keyframe along a revisited stretch re-closes against the same place,
    # each paying a full PGO solve and stacking near-duplicate edges (the r2
    # circuit accepted 25 loops for ~2 physical revisit events).
    loop_cooldown_kf: int = 5
    submap_window: int = 1            # loop keyframe ±1, intensity_feature_tracker.cpp:175
    max_keyframes: int = 1024         # fixed-capacity keyframe store
    keyframe_cloud_size: int = 2048   # subsampled points stored per keyframe
    # ScanContext (include/Scancontext.h:77-95)
    sc_num_ring: int = 20
    sc_num_sector: int = 60
    sc_max_radius: float = 80.0
    sc_lidar_height: float = 2.0
    # (the reference's SEARCH_RATIO ±10% shift window, Scancontext.h:94, is
    # subsumed: ops.scancontext evaluates ALL column shifts in one broadcast)
    sc_dist_threshold: float = 0.13   # SC_DIST_THRES, Scancontext.h:93
    sc_num_exclude_recent: int = 50   # Scancontext.h:89
    sc_num_candidates: int = 10       # NUM_CANDIDATES_FROM_TREE, Scancontext.h:90
    # kd-radius strategy (loop_closure_handler.cpp:42-84)
    radius_search_m: float = 7.0      # :68
    min_time_gap: float = 40.0        # :77
    # iSAM2-replacement PGO solve.  Each GN step's linear system is solved
    # EXACTLY (dense relative-coordinate Cholesky, posegraph.optimize);
    # measured convergence on the circuit graph is complete by iteration 2-3
    # (the problem is mildly nonlinear), so 3 buys exactness without paying
    # ~6144^3 Cholesky flops five more times per accepted loop.
    pgo_gn_iters: int = 3
    # run the full PGO solve ON-DEVICE at every accepted loop (the default,
    # reference behavior: isam_->update per closure).  False = collect loop
    # edges but defer the global solve to the distributed back-end
    # (`parallel.dist_backend.refine`, config `refine_every_kf`) — the
    # scale-out mode where keyframe-rate work stays light and a mesh does
    # the heavy solves; no correction feedback happens until a refine.
    online_pgo: bool = True
    # noise models, diag variances (rot, trans).  The reference uses
    # (1e-6,1e-6,1e-6,1e-8,1e-8,1e-6) for prior AND odometry
    # (`intensity_feature_tracker.cpp:41-47`) and per-axis variance =
    # raw ICP fitness for loops (`:344-355`) — with those values a loop
    # factor is ~10^6x weaker than the odometry chain and corrects almost
    # nothing.  We keep the reference's fitness-scaled loop semantics but
    # give the odometry chain its HONEST covariance (~0.005 rad / 0.02 m
    # per keyframe) so loop closures actually remove drift.
    prior_noise: tuple = (1e-6, 1e-6, 1e-6, 1e-8, 1e-8, 1e-6)
    odom_noise: tuple = (2.5e-5, 2.5e-5, 2.5e-5, 4e-4, 4e-4, 4e-4)
    loop_fitness_floor: float = 1e-4  # var per axis = max(fitness, floor)
    loop_cauchy_c: float = 1.0        # Cauchy robust scale on loop edges
    # (reference wraps loop BetweenFactors in CauchyEstimator(1),
    # `intensity_feature_tracker.cpp:356-363`); <= 0 disables
    # plausible-drift envelope the Cauchy residual is whitened by: real
    # odometry drift is bias-dominated, i.e. roughly LINEAR in distance
    # travelled — translation drift_rate (m/m) and rotation rad/m over the
    # chain path between the loop endpoints (see posegraph.optimize).
    # r5: tightened 0.15 -> 0.02 after the corner-residual scan-to-map,
    # the occlusion-boundary feature fix and the surf-plane core cut live
    # drift to ~0.3-0.9% of path (circuit live max 0.5-1 m over 170 m;
    # noisy figure8 ~2 m over 220 m).  The envelope is both the
    # channel-level defense against aliased wrong candidates AND the
    # chain stiffness in the solve: at 0.05 the chain yielded so much to
    # fitness-scaled loop noise (~0.2 m/axis) that corrected ATE landed
    # 1-4 cm ABOVE an already-good live trajectory on the circuit
    # battery; at 0.02 the chain resists loop noise where drift is small
    # while multi-meter genuine drift still fits 3 sigma at revisit path
    # lengths (3 x 0.02 x 140 m = 8.4 m envelope).
    loop_drift_rate: float = 0.02
    loop_drift_rot_rate: float = 0.003
    # intensity-correlation gate on the ICP inlier pairs
    # (ops.icp.intensity_correlation): wrong loops align geometry but pair
    # different surfaces, whose intensities decorrelate.  <= -1 disables.
    # 0.10 calibrated on the figure8 noise battery: wrong-place loops
    # score ~0.03 (uncorrelated), true revisits 0.16-0.74 (the low end =
    # 0.4 m-offset revisits whose voxel sampling straddles texture cells).
    loop_intensity_min: float = 0.10
    # pairwise-consistency (PCM-style) vote over the loop table before
    # every solve (posegraph.consistent_loop_mask)
    use_pcm: bool = True
    pcm_chi2: float = 25.0
    # chi^2 acceptance gate on a verified loop's implied correction against
    # the drift envelope: ScanContext matches between self-similar but
    # DIFFERENT places align geometrically (pass the fitness gate) yet
    # imply corrections odometry drift cannot explain — reject those before
    # they enter the edge table (pipeline.loop verify_and_close)
    loop_gate_chi2: float = 25.0


@dataclass(frozen=True)
class ParallelConfig:
    """Multi-host sharding (new — no reference counterpart; SURVEY §7.10).

    Read by `parallel.dist_backend` (the sharded keyframe back-end) and
    the live BA-problem construction of `parallel`."""

    mesh_axis_data: str = "data"      # keyframe/observation shard axis
    ba_keep_frac: float = 0.5         # match keep fraction for BA tracks
    ba_gn_iters: int = 5              # Gauss-Newton iterations in dist-BA
    ba_cg_iters: int = 16             # CG iterations per Schur solve
    pgo_cg_iters: int = 64            # CG iterations in the sharded PGO
    # online scale-out: every N keyframes the live system hands its
    # BackendState to `dist_backend.refine` on the session mesh (sharded
    # BA + PGO) and applies the refined poses back (0 = off).  The host
    # triggers it; the refined graph re-enters the device state through
    # `pipeline.fused.adopt_graph`.
    refine_every_kf: int = 0
    # write the Schur-BA pose estimates back over the PGO result.  Default
    # OFF: on LiDAR-intensity feature tracks the BA's data association is
    # far weaker evidence than ICP-verified loop closures + the PGO chain —
    # measured on the out-and-back CPU-mesh test it DEGRADED the live
    # trajectory (ATE 0.12 -> 1.27 m) while still reducing its own
    # reprojection cost.  The BA pass still runs and returns the refined
    # landmark map; flip this on for sensors whose tracks deserve it.
    ba_pose_writeback: bool = False


@dataclass(frozen=True)
class SlamConfig:
    sensor: SensorConfig = field(default_factory=SensorConfig)
    ground: GroundConfig = field(default_factory=GroundConfig)
    feature: FeatureConfig = field(default_factory=FeatureConfig)
    odometry: OdometryConfig = field(default_factory=OdometryConfig)
    geometric: GeometricConfig = field(default_factory=GeometricConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    # capacity of the device-resident per-frame trajectory log (ring buffer
    # inside the fused step; 8192 frames = ~13 min at 10 Hz).  The log is
    # what keeps the hot loop free of per-frame host readbacks: poses are
    # exported once at the end (or periodically) instead of every frame.
    log_capacity: int = 8192

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)


DEFAULT = SlamConfig()


def os0_64_config() -> SlamConfig:
    """Default config with the OS0-64-exact beam table (+-45 deg vertical
    FOV) for the synthetic renderer — the sensor of the reference's demo
    recording (`README.md:153`: "Ouster (OS0-64)")."""
    import dataclasses

    base = SlamConfig()
    return base.replace(sensor=dataclasses.replace(
        base.sensor, fov_up=45.0, fov_down=-45.0))


def small_test_config() -> SlamConfig:
    """Tiny shapes for unit tests / CPU dry runs."""
    return SlamConfig(
        sensor=SensorConfig(image_width=256, image_height=32),
        ground=GroundConfig(ransac_iters=128),
        feature=FeatureConfig(num_features=128),
        mapping=MappingConfig(map_capacity=1 << 14, max_query_points=512),
        loop=LoopConfig(max_keyframes=64, keyframe_cloud_size=512),
    )
