"""Committed PNG16 depth fixtures: codec -> frontend -> tracking.

The reference's shipped path consumes real 16-bit Kinect depth PNGs
(reference: Application.cpp:28-29); the build environment has no network
to fetch TUM, so tests/fixtures/kinect_png16 holds committed PNG16 frames
with full physical Kinect v1 sensor statistics (z^2 axial noise, edge
shadowing, dropouts, flying pixels, 1/8-px disparity quantization —
tools/make_depth_fixtures.py).  This test is the non-synthetic-path
gate: real PNG files on disk, decoded by the native codec, through the
robust frontend and the tracker.
"""

import os

import numpy as np
import jax.numpy as jnp

from voxelhashing_demo_tpu.config import (
    CameraConfig,
    FrontendConfig,
    FusionConfig,
    GCConfig,
    HashConfig,
    ICPConfig,
    PipelineConfig,
    RaycastConfig,
)
from voxelhashing_demo_tpu.models import hash_slam
from voxelhashing_demo_tpu.ops import preprocess as pre_ops
from voxelhashing_demo_tpu.utils import io as io_utils
from voxelhashing_demo_tpu.utils import metrics

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "fixtures", "kinect_png16")
FIX_LOOP = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "kinect_png16_loop")
N = 8
N_LOOP = 72


def _load_all():
    """Load through the TUM dataset layer (timestamp association + the
    native threaded batch decoder) — the same path `run --dataset` uses."""
    from voxelhashing_demo_tpu.utils import tum

    seq = tum.TUMSequence(FIX)
    assert len(seq) == N
    frames, poses = seq.load_all(640, 480)
    return list(frames), [np.asarray(p, np.float32) for p in poses]


def test_fixture_decode_and_sensor_statistics():
    """The files are genuine 16-bit PNGs carrying Kinect statistics:
    valid depth coverage with holes, and the disparity-quantization
    banding (few distinct codes per depth band, not a smooth field)."""
    frames, _ = _load_all()
    for raw in frames:
        assert raw.dtype == np.uint16 and raw.shape == (480, 640)
        valid = raw > 0
        assert 0.5 < valid.mean() < 0.999   # holes exist, most is valid
    raw = frames[0]
    band = raw[(raw > 9000) & (raw < 11000)]   # 1.8 - 2.2 m
    if band.size > 500:
        # ~57-unit quantization steps at 2 m: far fewer distinct codes
        # than the 2000-code band width (a smooth noisy field would fill
        # hundreds)
        assert len(np.unique(band)) < 80, len(np.unique(band))
    # native and pure-python decoders agree bit-for-bit when both exist
    p = os.path.join(FIX, "depth", "0.000000.png")
    py = io_utils.read_depth_png(p, native=False)
    np.testing.assert_array_equal(frames[0], py)


def test_tracking_on_fixture_frames():
    """Full pipeline over the decoded fixture files (downsampled 4x for
    CPU-test speed; codec + frontend see the full-res sensor data)."""
    frames, poses = _load_all()
    full_cam = CameraConfig()           # the fixtures' 640x480 fr1 model
    cam = full_cam.scaled(4)            # 160x120
    config = PipelineConfig(
        camera=cam,
        frontend=FrontendConfig(bilateral=True, outlier_reject=True),
        icp=ICPConfig(pyramid=(2, 1), pyramid_iters=(8, 4),
                      huber_delta=0.01),
        fusion=FusionConfig(voxel_size=0.03, truncation=0.12),
        hash=HashConfig(num_buckets=4096, bucket_size=4, num_blocks=4096,
                        max_active=2048, max_new_per_frame=2048),
        raycast=RaycastConfig(max_steps=96, cache_dims=(160, 160, 160)),
        gc=GCConfig(enabled=True, interval=8),
    )
    slam = hash_slam.HashSLAM(config)
    for raw in frames:
        d4 = pre_ops.downsample_depth(
            jnp.asarray(raw).astype(jnp.float32) / full_cam.depth_scale, 4
        )
        slam.process(jnp.asarray(
            np.round(np.asarray(d4) * full_cam.depth_scale)
        ).astype(jnp.uint16))
    tracked = sum(bool(i.tracked) for i in slam.infos)
    assert tracked >= N - 1, tracked
    gt_rel = [np.linalg.inv(poses[0]) @ p for p in poses]
    ate = metrics.ate_rmse(slam.trajectory, gt_rel, align=False)
    assert ate < 0.05, f"ATE on Kinect-statistics fixtures: {ate}"


def test_keyframe_backend_closes_loop_on_fixture_files():
    """The LOOP fixture sequence (committed quarter-res PNG16 files of a
    full 360-degree noisy sweep, tools/make_depth_fixtures.py) drives
    the keyframe backend end to end on the disk-file path: keyframes
    insert, the end-of-sweep revisit passes the loop acceptance gates
    (observability + robust kernels), BA runs, and the corrected
    trajectory closes the ring."""
    import dataclasses

    from voxelhashing_demo_tpu.models import keyframe_slam
    from voxelhashing_demo_tpu.utils import tum

    seq = tum.TUMSequence(FIX_LOOP)
    assert len(seq) == N_LOOP
    cam = CameraConfig().scaled(4)
    frames, poses = seq.load_all(cam.width, cam.height)
    config = PipelineConfig(
        camera=cam,
        frontend=FrontendConfig(bilateral=True, outlier_reject=True),
        icp=ICPConfig(pyramid=(2, 1), pyramid_iters=(8, 4),
                      huber_delta=0.01),
        fusion=FusionConfig(voxel_size=0.03, truncation=0.12),
        hash=HashConfig(num_buckets=4096, bucket_size=4, num_blocks=4096,
                        max_active=2048, max_new_per_frame=2048),
        raycast=RaycastConfig(max_steps=96, cache_dims=(160, 160, 160)),
        gc=GCConfig(enabled=True, interval=8),
    )
    config = dataclasses.replace(
        config,
        keyframes=dataclasses.replace(
            config.keyframes,
            min_loop_separation=6, loop_radius=0.35,
            min_loop_inliers=300,
        ),
    )
    slam = keyframe_slam.KeyframeSLAM(config)
    for raw in frames:
        slam.process(jnp.asarray(np.asarray(raw)))
    traj = slam.trajectory()
    tracked = sum(bool(i.tracked) for i in slam.infos)
    assert tracked >= N_LOOP - 2, tracked
    assert len(slam.keyframes) >= 8
    loop_edges = slam._n_edges - (len(slam.keyframes) - 1)
    assert loop_edges >= 1, "end-of-sweep closure must fire on files"
    assert len(slam.ba_events) >= 1
    assert all(np.isfinite(t).all() for t in traj)
    gt_rel = [np.linalg.inv(np.asarray(poses[0])) @ np.asarray(p)
              for p in poses]
    ate = metrics.ate_rmse(traj, gt_rel, align=False)
    assert ate < 0.08, f"backend ATE on loop fixture files: {ate}"
