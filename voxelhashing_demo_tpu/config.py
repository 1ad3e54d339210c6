"""Typed configuration for the dense SLAM engine.

The reference scatters its configuration over compile-time constants
(reference: common.h:7-50) with duplicated, conflicting copies (e.g. the
``#define fx 525`` in CameraTrackingUtils.cu:23-29 vs ``fx = 517.3`` in
common.h:7).  Here everything lives in frozen dataclasses: hashable (usable
as jit static args), printable, and serializable.

Defaults reproduce the reference's capacity envelope (common.h) where it is
sane, and fix it where it is not (the reference's ``truncation = 1.0 m`` at
2 cm voxels is a 50-voxel truncation band; we default to 10 cm).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole depth camera model.

    Defaults are the TUM fr1 intrinsics the reference hard-codes
    (reference: common.h:7-10,17-18) and the TUM 16-bit depth convention of
    5000 units per meter (reference: CameraTrackingUtils.cu:64).
    """

    width: int = 640
    height: int = 480
    fx: float = 517.3
    fy: float = 516.5
    cx: float = 318.6
    cy: float = 255.3
    depth_scale: float = 5000.0  # uint16 units per meter
    depth_min: float = 0.1       # meters; below -> invalid
    depth_max: float = 4.0       # meters; reference maxIntegrationDistance (common.h:46)

    def scaled(self, factor: int) -> "CameraConfig":
        """Intrinsics for an image downsampled by ``factor`` (ICP pyramid)."""
        return dataclasses.replace(
            self,
            width=self.width // factor,
            height=self.height // factor,
            fx=self.fx / factor,
            fy=self.fy / factor,
            # pixel-center convention: (cx + 0.5) / f - 0.5
            cx=(self.cx + 0.5) / factor - 0.5,
            cy=(self.cy + 0.5) / factor - 0.5,
        )


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Depth prefiltering (no reference counterpart — its frontend is
    back-project + normals only, CameraTrackingUtils.cu:50-113)."""

    bilateral: bool = False
    bilateral_radius: int = 2
    bilateral_sigma_space: float = 1.5   # pixels
    bilateral_sigma_depth: float = 0.03  # meters
    # flying-pixel rejection (ops/preprocess.reject_outliers): keep a
    # sample only if >= min_support of its 8 neighbors agree within
    # band_base + band_quad * z^2 meters
    outlier_reject: bool = False
    outlier_band_base: float = 0.03
    outlier_band_quad: float = 0.007
    outlier_min_support: int = 3


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """Point-to-plane ICP solved by Gauss-Newton.

    The reference runs 20 fixed host-driven iterations
    (reference: CameraTracking.h:40, CameraTracking.cpp:35) with
    distThres=0.08 (common.h:12).  We keep 20 as the cap but iterate
    on-device inside a ``lax.while_loop`` with a convergence test, and use a
    damped Cholesky solve instead of the reference's explicit 6x6 inverse
    (reference: Solver.cpp:109-110).
    """

    max_iters: int = 20
    dist_thresh: float = 0.08     # meters, point-to-plane residual gate
    normal_thresh: float = 0.6    # min cos(angle) between normals
    damping: float = 1e-6         # Levenberg damping added to JTJ diagonal
    huber_delta: float = 0.0      # IRLS Huber kernel width (m); 0 = off
    update_tol: float = 1e-5      # |delta xi| convergence threshold
    # constant-velocity motion prior, RACED against the identity start at
    # the coarsest level (ops/icp.icp_align_pyramid) so it can only help
    use_motion_prior: bool = True
    # physically-plausible per-frame motion gate on the tracked result:
    # projective ICP can lock into a wrong basin with thousands of
    # sliding inliers (box-room geometry after a kidnap/occlusion), but
    # a real sensor cannot teleport — results beyond these bounds are
    # declared tracking failures (tracked=False) so recovery
    # (relocalization) can engage.  At 30 Hz the defaults allow 9 m/s
    # and 750 deg/s.  <= 0 disables the gate.
    max_motion_trans: float = 0.30    # meters per frame
    max_motion_rot_deg: float = 25.0  # degrees per frame
    pyramid: Tuple[int, ...] = (1,)  # downsample factors, coarse-to-fine
    pyramid_iters: Tuple[int, ...] = (20,)
    # extra per-level SOURCE-side pooling: level i associates
    # pyramid[i]*source_pools[i]-pooled source pixels against the
    # pyramid[i]-res target.  Association is gather-bound (one random
    # device-memory read per source pixel), so pooling the source 2x at
    # the finest level quarters its cost while target precision — which
    # dominates association quantization — stays full-res.  () = all 1s.
    source_pools: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """Curless-Levoy TSDF fusion parameters.

    Reference values: voxelSize=0.02, truncation=1.0 + 0.01*z, weight cap 255,
    per-sample weight 0.1 (reference: common.h:44-50, VoxelUtils.cu:829).
    The reference's 1.0 m truncation is replaced by a conventional
    5-voxel-scale band; per-sample weight 1.0 with optional depth falloff.
    """

    voxel_size: float = 0.02
    truncation: float = 0.10       # meters (base truncation band)
    trunc_scale: float = 0.01      # truncation += trunc_scale * depth
    max_weight: float = 255.0
    weight_sample: float = 1.0     # weight of one observation
    depth_weight_falloff: bool = True  # Niessner depth-dependent weighting


@dataclasses.dataclass(frozen=True)
class DenseGridConfig:
    """Dense (non-hashed) TSDF volume — the config-1 baseline map."""

    dims: Tuple[int, int, int] = (128, 128, 128)
    # world-space position of voxel (0,0,0) center, meters
    origin: Tuple[float, float, float] = (-1.28, -1.28, 0.0)


@dataclasses.dataclass(frozen=True)
class HashConfig:
    """Voxel block hash table geometry.

    Reference demo scale: 5000 buckets x 5 slots, 1000 blocks of 8^3 voxels
    (reference: common.h:39-44); the paper-scale commented defaults were
    ~500k buckets / 1M blocks (VoxelDataStructures.h:36-39).  We default to
    an intermediate production scale that fits comfortably in HBM.
    """

    num_buckets: int = 32768
    bucket_size: int = 4
    num_blocks: int = 16384        # allocatable 8^3 voxel blocks
    block_size: int = 8
    max_active: int = 8192         # padded visible-set capacity per frame
    max_new_per_frame: int = 4096  # padded allocation capacity per frame
    band_steps: int = 3            # samples along the truncation band per ray
    candidate_stride: int = 1      # pixel subsampling for allocation
    # fusion/splat process the active set in chunks of this many blocks
    # inside a dynamic-trip-count loop: cost scales with real occupancy,
    # not with the max_active padding.  Smaller chunks waste less padded
    # gather/scatter work (the dominant cost); larger chunks issue fewer
    # loop trips.  tools/ablate_step.py sweeps it.
    integrate_chunk: int = 128
    # packing bounds for block coords -> int32 key (10 bits per axis, biased)
    key_bits: int = 10

    @property
    def voxels_per_block(self) -> int:
        return self.block_size ** 3

    @property
    def table_size(self) -> int:
        return self.num_buckets * self.bucket_size


@dataclasses.dataclass(frozen=True)
class RaycastConfig:
    """Sphere-traced / DDA raycaster of the TSDF.

    The reference's raycaster was never finished (reference: README.md:4-5,
    SDFRenderer.cpp:215-254 commented out); this is the completed design from
    its notes.md three-pass plan, recast as pure device compute.
    """

    max_steps: int = 96
    step_scale: float = 0.9       # fraction of |sdf| to step (sphere tracing)
    min_step: float = 0.5         # in voxels, floor on step size
    # step through unobserved space, in voxels; must stay below
    # truncation/voxel_size or rays can jump the narrow known band
    coarse_step: float = 2.0
    near: float = 0.1
    far: float = 5.0
    normal_mode: str = "gradient"  # "gradient" | "image"
    # view-local dense cache the hash raycaster scatters visible blocks
    # into (hash_raycast.densify_active); voxels per axis
    cache_dims: Tuple[int, int, int] = (256, 256, 256)
    # frame-to-model surface prediction mode: "splat" (fast, ops/splat.py)
    # or "march" (sphere tracing through the dense cache, ops/raycast.py)
    mode: str = "splat"
    splat_band: float = 1.0        # |sdf| < band * voxel_size voxels splat
    splat_fill_rounds: int = 2     # 3x3 valid-min hole-fill passes
    splat_smooth_sigma: float = 3.0  # depth-edge gate, in voxels


@dataclasses.dataclass(frozen=True)
class GCConfig:
    """Streaming garbage collection of stale voxel blocks.

    The reference's ``deleteVoxelEntry`` is dead code (reference:
    VoxelUtils.cu:544-604 — never called); this implements what it intended.
    """

    enabled: bool = True
    interval: int = 8              # run GC every N frames
    min_weight: float = 0.5        # blocks whose max weight < this are freed
    max_blocks_per_gc: int = 1024
    # protect blocks seen within the last min_age frames: truncation-band
    # blocks that never receive a sample otherwise churn alloc/free/realloc
    # every GC interval for as long as they stay visible
    min_age: int = 16


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Out-of-frustum block streaming: evict long-unseen blocks to a host
    BlockStore, restore them when the camera revisits.

    What the original VoxelHashing paper's GPU<->host streaming did and the
    reference's dead deleteVoxelEntry (VoxelUtils.cu:544-604) could not —
    it discards data.  With streaming the reconstructable scene is bounded
    by host memory, not by ``num_blocks`` (which only needs to hold the
    working set).  Device<->host traffic is padded batched transfers every
    ``interval`` frames; see models/hash_slam.HashSLAM and
    utils/blockstore.py.
    """

    enabled: bool = False
    interval: int = 8              # evict scan every N frames
    max_age: int = 30              # frames out of frustum before eviction
    max_evict: int = 2048          # eviction batch (padded transfer size)
    max_restore: int = 2048        # restore batch (padded transfer size)
    restore_margin_px: float = 64.0  # extra frustum slack for restore query


@dataclasses.dataclass(frozen=True)
class KeyframeConfig:
    """Keyframe pose graph + bundle adjustment (north star; no reference
    counterpart — the reference drifts unboundedly, SURVEY.md §5)."""

    max_keyframes: int = 64
    max_edges: int = 256
    # grow (double) the graph capacity on demand instead of silently
    # no-opping at max_keyframes/max_edges; the grown shapes recompile the
    # BA jit O(log K) times over a run (ops/pose_graph.grow).  When off,
    # hitting capacity degrades the backend to pure odometry — surfaced
    # as a ``capacity_events`` entry and the ``saturated`` flag on
    # KeyframeSLAM, never silent.
    grow_on_capacity: bool = True
    min_rotation_deg: float = 10.0   # new keyframe if rotation exceeds this
    min_translation: float = 0.15    # ... or translation (meters) this
    ba_iters: int = 5
    ba_damping: float = 1e-4
    # Inner linear solver for the GN step.  "dense": Cholesky on the
    # materialized (6K, 6K) system — exact, O(K^2) memory / O(K^3) solve,
    # right answer for the benched K <= 256.  "cg": matrix-free
    # block-Jacobi-preconditioned conjugate gradients on the per-edge
    # 6x6 block structure — H is never materialized, each iteration is
    # O(E) gather/scatter + (K, 6, 6) block solves, so memory and
    # per-iteration cost are flat in K (ops/pose_graph.solve_delta_cg).
    # "auto" (default): dense while the graph capacity K <=
    # ba_dense_max_k, CG beyond — the switch is a static-shape decision,
    # so it costs one recompile at the capacity-growth step that crosses
    # the threshold, nothing per frame.  CG is single-device only: the
    # sharded BA path psums the dense system regardless of capacity
    # ("auto" stays dense on a mesh; explicit "cg" with a mesh raises).
    ba_solver: str = "auto"
    ba_dense_max_k: int = 128
    # CG iteration cap and relative-residual stop (||r|| <= tol * ||b||).
    # The preconditioned system is extremely well conditioned for SLAM
    # graphs (odometry chain + sparse closures): measured convergence to
    # float32 parity with the dense solve in << 64 iterations.
    ba_cg_iters: int = 64
    ba_cg_tol: float = 1e-6
    # BA scheduling: run the optimizer only once this many NEW accepted
    # loop edges have accumulated since the last run, or once the oldest
    # pending edge has waited ba_defer_frames frames (whichever first).
    # 1/0 = optimize on every closure (default, the conservative
    # behavior).  In a continuous-closure regime — every new keyframe
    # closes against an old neighbor, e.g. the second lap of a two-lap
    # sweep — per-closure BA + map reintegration dominates wall-clock
    # (tests/test_ba_defer.py); edges keep
    # accumulating in the graph while deferred, so batching the solve
    # trades only bounded correction latency for removing most of those
    # stops.  ba_defer_frames=0 disables the age trigger (edges then
    # wait for a full batch); pending BA always runs at flush().
    ba_defer_edges: int = 1
    ba_defer_frames: int = 0
    # asynchronous BA: dispatch the solve without fetching and complete
    # it at the NEXT host sync batch (_drain), where the pose fetch it
    # needs piggybacks on the drain's existing pipeline sync — one BA
    # run's pipeline drain and fetch (the solve itself is short)
    # overlaps tracking instead of stalling it.  The
    # correction lands <= sync_every frames later than the synchronous
    # path (same class of latency the deferral window already accepts);
    # keyframes inserted while the solve is in flight are re-based by
    # the completion correction.  flush() always completes synchronously.
    ba_async: bool = False
    # IRLS robust kernel on the per-edge se(3) residual norm (meters +
    # radians mixed); delta 0 = off.  Bounds (kernel "huber") or
    # essentially eliminates (kernel "gm", Geman-McClure, default) the
    # damage of a false loop closure that slips past the acceptance
    # gates (ops/pose_graph.robust_edge_weights).  Honest corrections
    # are mm-cm scale; false closures are decimeter-plus.
    ba_robust_delta: float = 0.1
    ba_robust_kernel: str = "gm"
    # asynchronous keyframe edge insertion: the candidate pair-ICP batch
    # dispatched at keyframe insert is FETCHED at the next drain (where
    # the pipeline syncs anyway) instead of blocking the insert on a
    # synchronous fetch.
    # Edge acceptance, the mutual check, and the BA trigger move with it
    # (<= sync_every frames — the latency class the BA DEFERRAL window
    # already accepts, so async only engages when deferral is on
    # (ba_defer_edges > 1 or ba_defer_frames > 0); a per-closure
    # configuration keeps synchronous, correction-latency-first inserts
    # regardless of this flag).  flush/checkpoint/BA always complete
    # pending batches first, so the graph is current wherever it is
    # consumed.
    kf_async_edges: bool = True
    # graduated non-convexity: the IRLS kernel width starts at
    # init_scale * delta and anneals geometrically to delta over
    # ba_iters.  Without it the redescending GM kernel sheds an HONEST
    # closure carrying large accumulated drift (residual >> delta)
    # exactly like a false edge; with it the wide early iterations pull
    # the graph into the closure's basin first.  <= 1 disables.
    ba_gnc_init_scale: float = 8.0
    icp_downsample: int = 2          # keyframe-pair ICP runs at this factor
    loop_radius: float = 0.8         # meters: candidate loop-closure search
    min_loop_separation: int = 3     # keyframes between loop-closure pairs
    min_loop_inliers: int = 500      # at the downsampled resolution
    max_loop_error: float = 1e-4     # mean sq point-to-plane residual gate
    # candidate gate: max angle between the two keyframes' optical axes —
    # opposite-facing keyframes share no surface and projective ICP on
    # them can only converge to wrong-basin solutions
    loop_max_angle_deg: float = 75.0
    # observability gate: min normalized smallest eigenvalue of the
    # forward solve's normal matrix (ops/icp.observability).  Sliding
    # registrations on degenerate geometry (flat walls) have a near-null
    # JTJ direction (~0); structured scenes measure >= ~1e-2.  This is
    # the direct test for what the mutual check approximated — and
    # unlike the mutual check it does not reject a well-constrained
    # forward closure because the REVERSE overlap happens to be
    # degenerate (observed failure mode at flagship scale: the reverse
    # ICP slid decimetres with no rotation).
    min_loop_obs: float = 1e-3
    # optional legacy mutual-consistency gate: register both directions
    # and require the composition near identity.  Conservative (kills
    # true closures whose reverse overlap is degenerate); off by default
    # since the observability gate.
    loop_mutual_check: bool = False
    loop_mutual_max_trans: float = 0.03   # meters
    loop_mutual_max_rot_deg: float = 2.0
    loop_weight: float = 1.0
    odometry_weight: float = 1.0
    # odometry-edge measurement between consecutive keyframes:
    # "icp" = downsampled keyframe-pair ICP (map-independent);
    # "tracked" = the frontend's frame-to-model relative pose (full-res,
    # benefits from the accumulated map).  A/B-able on the closed-sweep
    # benchmark.
    odometry_source: str = "icp"
    # propagate BA corrections into the TSDF: when a loop closure moves the
    # current keyframe by more than rebuild_min_trans/rot, rebuild the map
    # by re-integrating the stored keyframe depths at corrected poses
    # (BundleFusion-style reintegration bounded to keyframes).  Without it
    # the map keeps its drifted geometry and frame-to-model tracking
    # fights the correction.
    rebuild_map: bool = True
    rebuild_min_trans: float = 0.02   # meters
    rebuild_min_rot_deg: float = 1.0
    # incremental reintegration: once the map is keyframe-only (after the
    # first full rebuild), later BA corrections MAY de-integrate +
    # re-integrate only the ledger entries whose pose moved (the
    # Curless-Levoy average is exactly invertible below the weight cap,
    # ops/hash_ops.defuse_frame) instead of replaying all K keyframes.
    # One move costs several full-rebuild fuses, and global drift
    # corrections — what closed-sweep/endurance regimes produce — move
    # most of the ledger, so the cost model below resolves them as FULL
    # rebuilds.  The incremental path earns its keep on LOCALIZED
    # corrections moving a few entries (bench.py localized_micro) and
    # remains the exact correctness primitive for them.  Supported on all
    # backends: sharded meshes use the owner-local twin
    # (parallel/sharded.make_sharded_reintegrate) and streaming maps
    # restore a moved frame's frustums first (evict/restore preserve the
    # born stamps the de-integration gate needs, up to the residency
    # caveat in ops/hash_ops.restore_blocks).
    rebuild_incremental: bool = True
    rebuild_move_min_trans: float = 0.005   # keyframe "moved" thresholds
    rebuild_move_min_rot_deg: float = 0.25
    # cost-based rebuild choice: one incremental ledger move (born-gated
    # de-integrate + re-integrate) costs ~this many times one
    # full-rebuild keyframe fuse (bench.py localized_micro measures both
    # on the same state).  When a correction moves so much of the
    # ledger that moved * cost > num_keyframes, a fresh full rebuild is
    # cheaper AND re-bases the ring.  0 = always take the incremental
    # path when the ledger is valid (the conservative default; the
    # flagship config sets the measured ratio).
    rebuild_incremental_cost: float = 0.0
    # contribution-ledger window: every frame fused since the last FULL
    # rebuild is remembered (device depth + fused pose) so incremental
    # corrections can move its TSDF contribution exactly; if more than
    # this many frames accumulate between corrections the ledger is
    # dropped and the next correction rebuilds fully (bounds HBM at
    # ~window x 0.6 MB)
    rebuild_window: int = 64
    # tracking-lost recovery: after ``reloc_after`` consecutive untracked
    # frames, re-register the live frame against stored keyframes (ICP
    # from identity + the loop acceptance gates) and reset the live pose
    # to the best passing match.  The capability the reference's legacy
    # rigidAlignment fallback (CameraTracking.cpp:92-115) was for.
    relocalize: bool = True
    reloc_after: int = 3          # consecutive lost frames before trying
    reloc_interval: int = 2       # retry cadence while still lost
    reloc_max_candidates: int = 16  # most recent keyframes searched
    # seed each relocalization candidate with closed-form Procrustes
    # rounds (geometry/procrustes.procrustes_init — the role of the
    # reference's legacy correspondence-SVD rigidAlignment,
    # CameraTracking.cpp:92-115) before the ICP refinement: the exact
    # (non-linearized) rotation solve extends the capture basin beyond
    # what identity-start GN recovers
    reloc_procrustes: bool = True
    reloc_procrustes_rounds: int = 2
    # host<->device sync cadence of the keyframe layer: per-frame
    # decisions (keyframe insertion, lost-streak, frame refs) need the
    # tracked pose on the host, and every blocking fetch drains the
    # dispatch pipeline and leaves the device idle.  With
    # sync_every=B the layer fetches B frames' poses in ONE transfer and
    # applies the decisions retrospectively (keyframe poses stay exact;
    # BA corrections/relocalizations land up to B-1 frames late).
    # 1 = legacy per-frame behavior (tests); flagship/bench use 8.
    sync_every: int = 1
    # candidate batch width for loop-closure / odometry pair ICP: all
    # candidates run in ONE vmapped dispatch + ONE fetch instead of a
    # dispatch+fetch round per candidate.  Under vmap every lane computes
    # until ALL converge, so width is device COST, not just capacity —
    # keep it at the realistic candidate count (odometry + nearest loops)
    loop_max_batch: int = 4
    # iteration cap for the batched pair ICP (keyframe odometry + loop
    # candidates start from good inits — accumulated drift is cm-scale —
    # so they converge in a handful of GN steps; relocalization lanes
    # start from identity and share this cap)
    loop_icp_max_iters: int = 10


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level composition used by the SLAM pipelines in models/."""

    camera: CameraConfig = CameraConfig()
    frontend: FrontendConfig = FrontendConfig()
    icp: ICPConfig = ICPConfig()
    fusion: FusionConfig = FusionConfig()
    grid: DenseGridConfig = DenseGridConfig()
    hash: HashConfig = HashConfig()
    raycast: RaycastConfig = RaycastConfig()
    gc: GCConfig = GCConfig()
    keyframes: KeyframeConfig = KeyframeConfig()
    stream: StreamConfig = StreamConfig()


def tiny_config() -> PipelineConfig:
    """Small config for fast CPU tests: 80x60 image, small hash table."""
    cam = CameraConfig(width=80, height=60, fx=64.6625, fy=64.5625,
                       cx=39.7, cy=29.8)
    return PipelineConfig(
        camera=cam,
        grid=DenseGridConfig(dims=(64, 64, 64), origin=(-0.64, -0.64, 0.0)),
        hash=HashConfig(num_buckets=1024, bucket_size=4, num_blocks=1024,
                        max_active=512, max_new_per_frame=512),
        raycast=RaycastConfig(max_steps=64, cache_dims=(128, 128, 128)),
    )
