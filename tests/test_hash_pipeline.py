"""End-to-end voxel-hash SLAM (the flagship, BASELINE.json config 2):
synthetic sequence -> frame-to-model tracking + hash fusion + GC + raycast,
ATE-checked."""

import jax.numpy as jnp
import numpy as np

from voxelhashing_demo_tpu.config import (
    CameraConfig,
    FusionConfig,
    GCConfig,
    HashConfig,
    PipelineConfig,
    RaycastConfig,
)
from voxelhashing_demo_tpu.models import hash_slam
from voxelhashing_demo_tpu.utils import metrics, synthetic

CFG = PipelineConfig(
    camera=CameraConfig(width=160, height=120, fx=129.3, fy=129.1,
                        cx=79.65, cy=59.8),
    fusion=FusionConfig(voxel_size=0.02, truncation=0.08),
    hash=HashConfig(num_buckets=8192, bucket_size=4, num_blocks=8192,
                    max_active=4096, max_new_per_frame=4096),
    raycast=RaycastConfig(max_steps=128, cache_dims=(192, 192, 192)),
    gc=GCConfig(enabled=True, interval=4),
)


def test_hash_slam_sequence():
    num_frames = 10
    depths, gt_poses = synthetic.make_sequence(
        CFG.camera, num_frames, trans_amp=0.05, rot_amp_deg=2.5
    )
    slam = hash_slam.HashSLAM(CFG)
    for d in depths:
        slam.process(d)

    assert not bool(slam.infos[0].tracked)
    assert all(bool(i.tracked) for i in slam.infos[2:])

    # map stats sane: blocks allocated once, active set nonempty, no leak
    assert int(slam.infos[0].blocks_allocated) > 100
    assert int(slam.infos[-1].blocks_allocated) < int(
        slam.infos[0].blocks_allocated
    )
    assert int(slam.infos[-1].blocks_active) > 100
    assert int(slam.infos[-1].free_blocks) > 0

    ate = metrics.ate_rmse(slam.trajectory, gt_poses, align=False)
    assert ate < 0.012, f"ATE {ate} m"

    out = slam.render()
    d_true = synthetic.render_depth(jnp.asarray(gt_poses[-1]), CFG.camera)
    both = np.asarray(out.hit) & (np.asarray(d_true) > 0)
    err = np.abs(np.asarray(out.depth) - np.asarray(d_true))[both]
    assert np.median(err) < 2 * CFG.fusion.voxel_size


def test_hash_slam_gc_runs():
    depths, _ = synthetic.make_sequence(CFG.camera, 5, trans_amp=0.0,
                                        rot_amp_deg=0.0)
    slam = hash_slam.HashSLAM(CFG)
    for d in depths:
        slam.process(d)
    # GC fired at frame index interval-1 (static scene: nothing to free)
    gc_frames = [int(i.blocks_freed) for i in slam.infos]
    assert len(gc_frames) == 5
    # stable map: allocations settle to ~zero
    assert int(slam.infos[-1].blocks_allocated) < 20


def test_moderate_motion_tracks():
    """Moderately large inter-frame motion with direction reversals (the
    sinusoid) must track.  This is the regression guard for the RACED
    constant-velocity prior: a naive always-prior start lands ICP in wrong
    local minima of this symmetric scene on reversals; racing it against
    the identity start (ops/icp.pick_better) keeps reversals safe."""
    num_frames = 8
    depths, gt_poses = synthetic.make_sequence(
        CFG.camera, num_frames, trans_amp=0.12, rot_amp_deg=6.0
    )
    slam = hash_slam.HashSLAM(CFG)
    for d in depths:
        slam.process(d)
    assert sum(bool(i.tracked) for i in slam.infos) >= num_frames - 1
    ate = metrics.ate_rmse(slam.trajectory, gt_poses, align=False)
    assert ate < 0.03, f"moderate-motion ATE {ate}"


import dataclasses  # noqa: E402

_PYR_ICP = dataclasses.replace(
    CFG.icp, pyramid=(4, 2, 1), pyramid_iters=(8, 4, 2)
)


def test_fast_motion_tracks():
    """2x the moderate test's amplitude at unchanged
    per-level iteration caps, with the flagship pyramid schedule."""
    num_frames = 16
    cfg = dataclasses.replace(CFG, icp=_PYR_ICP)
    depths, gt_poses = synthetic.make_sequence(
        CFG.camera, num_frames, trans_amp=0.24, rot_amp_deg=12.0
    )
    slam = hash_slam.HashSLAM(cfg)
    for d in depths:
        slam.process(d)
    assert sum(bool(i.tracked) for i in slam.infos) >= num_frames - 1
    ate = metrics.ate_rmse(slam.trajectory, gt_poses, align=False)
    assert ate < 0.03, f"fast-motion ATE {ate}"


def test_motion_prior_helps_on_acceleration():
    """Accelerating constant-direction motion (make_ramp_sequence) is the
    regime where the constant-velocity prior is load-bearing: with it the
    sequence tracks tightly; identity-only initialization drifts several-x
    worse once per-frame motion exceeds its convergence basin."""
    depths, gt_poses = synthetic.make_ramp_sequence(
        CFG.camera, 12, max_trans_step=0.11, max_rot_step_deg=5.5
    )
    ates = {}
    for prior in (True, False):
        cfg = dataclasses.replace(
            CFG, icp=dataclasses.replace(_PYR_ICP, use_motion_prior=prior)
        )
        slam = hash_slam.HashSLAM(cfg)
        for d in depths:
            slam.process(d)
        ates[prior] = metrics.ate_rmse(slam.trajectory, gt_poses,
                                       align=False)
    assert ates[True] < 0.035, f"prior ATE {ates[True]}"
    assert ates[False] > 2.0 * ates[True], (
        f"prior not load-bearing: {ates}"
    )


def test_scan_chunk_matches_sequential():
    """process_chunk (lax.scan over stacked frames, one dispatch) must give
    the same trajectory and map as per-frame process."""
    import jax

    num_frames = 6
    depths, _ = synthetic.make_sequence(
        CFG.camera, num_frames, trans_amp=0.05, rot_amp_deg=2.5
    )
    seq = hash_slam.HashSLAM(CFG)
    for d in depths:
        seq.process(d)

    chunked = hash_slam.HashSLAM(CFG)
    stack = jnp.stack([jnp.asarray(d) for d in depths])
    infos = chunked.process_chunk(stack)

    assert infos.pose.shape[0] == num_frames
    assert len(chunked.trajectory) == num_frames
    for a, b in zip(seq.trajectory, chunked.trajectory):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(seq.state.hmap.tsdf),
        np.asarray(chunked.state.hmap.tsdf),
        atol=1e-5,
    )
    assert int(seq.state.hmap.free_top) == int(chunked.state.hmap.free_top)
    # mixing modes keeps working (scan state feeds per-frame step)
    info = chunked.process(depths[0])
    assert bool(jnp.all(jnp.isfinite(info.pose)))
