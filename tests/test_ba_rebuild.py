"""BA corrections must reach the map.

Two levels:
- mechanism: after a known rigid correction D of every keyframe pose,
  ``_rebuild_map`` produces a map that renders identically from the
  correspondingly-moved viewpoint (the map FOLLOWS the correction).
- end-to-end: inject a drift step mid-sequence; loop closure + BA correct
  the trajectory, and with rebuild_map the subsequent frames track the
  corrected model instead of fighting the stale one (measured ~3x post-BA
  ATE improvement).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp

from voxelhashing_demo_tpu.config import (
    CameraConfig,
    FusionConfig,
    GCConfig,
    HashConfig,
    ICPConfig,
    KeyframeConfig,
    PipelineConfig,
    RaycastConfig,
)
from voxelhashing_demo_tpu.geometry import se3
from voxelhashing_demo_tpu.models import keyframe_slam
from voxelhashing_demo_tpu.utils import metrics, synthetic

CAM = CameraConfig(width=160, height=120, fx=129.3, fy=129.1,
                   cx=79.65, cy=59.8)


def _cfg(rebuild: bool) -> PipelineConfig:
    return PipelineConfig(
        camera=CAM,
        icp=ICPConfig(pyramid=(4, 2, 1), pyramid_iters=(8, 4, 2)),
        fusion=FusionConfig(voxel_size=0.03, truncation=0.12),
        hash=HashConfig(num_buckets=4096, bucket_size=4, num_blocks=4096,
                        max_active=2048, max_new_per_frame=2048),
        raycast=RaycastConfig(max_steps=96, cache_dims=(160, 160, 160)),
        gc=GCConfig(enabled=True, interval=8, min_age=12),
        keyframes=KeyframeConfig(
            max_keyframes=32, max_edges=128,
            min_rotation_deg=5.0, min_translation=0.06,
            icp_downsample=2, loop_radius=0.6, min_loop_separation=6,
            min_loop_inliers=800, max_loop_error=1e-4, ba_iters=8,
            rebuild_map=rebuild, rebuild_min_trans=0.03,
        ),
    )


def test_rebuild_map_follows_correction():
    """Move every keyframe pose by a rigid D and rebuild: rendering from
    D @ pose must reproduce the original render from pose (same relative
    view), which is exactly what post-BA tracking needs."""
    cfg = _cfg(True)
    depths, _ = synthetic.make_room_sweep(CAM, 10, sweep_deg=40.0)
    slam = keyframe_slam.KeyframeSLAM(cfg)
    for d in depths:
        slam.process(d)
    assert len(slam.keyframes) >= 2

    render = keyframe_slam.make_render_model(cfg)
    pose0 = slam.state.pose
    before = render(slam.state.hmap, pose0)

    D = jnp.asarray(se3.exp(jnp.asarray(
        np.array([0.05, -0.04, 0.03, 0.0, np.deg2rad(3.0), 0.0],
                 np.float32))))
    # the misalignment a stale map would cause: render the OLD map from
    # the corrected viewpoint
    stale = render(slam.state.hmap, D @ pose0)

    slam.graph = slam.graph._replace(
        poses=jnp.einsum("ij,kjl->kil", D, slam.graph.poses)
    )
    slam.state = slam.state._replace(pose=D @ pose0)
    slam._rebuild_map()
    after = render(slam.state.hmap, D @ pose0)

    both = (np.asarray(before.depth) > 0) & (np.asarray(after.depth) > 0)
    assert both.mean() > 0.5
    err = np.abs(np.asarray(after.depth) - np.asarray(before.depth))[both]
    both_stale = (np.asarray(before.depth) > 0) & (
        np.asarray(stale.depth) > 0
    )
    err_stale = np.abs(
        np.asarray(stale.depth) - np.asarray(before.depth)
    )[both_stale]
    # rebuilt map follows the correction to voxel precision; the stale map
    # is misaligned by the full correction parallax
    assert np.median(err) < 1.5 * cfg.fusion.voxel_size, np.median(err)
    assert np.median(err_stale) > 3.0 * np.median(err)


def test_rebuild_improves_post_ba_tracking():
    """Drift step injected mid-sweep; loop closures + BA correct it.  With
    rebuild_map the map is reintegrated at corrected poses and subsequent
    frames benefit; without it they fight the stale model.  Measured at
    this scale: with the r2 loop gates the gap was 6.1 vs 11.0 mm post-BA
    ATE (pre-gates 155 vs 778 mm); with the r3 robust (Geman-McClure) BA
    the stale-map run recovers its tail too (6.1 vs 12.3 mm whole-
    trajectory); with the r3 contribution ledger + GNC both runs sit near
    the scenario's ~10 mm floor (10.3 vs 11.9).  The end-to-end assertion
    is therefore monotone (rebuild never worse, both within the envelope);
    the mechanism-level necessity of rebuild is pinned separately by
    test_rebuild_map_follows_correction."""
    n = 40
    depths, gt = synthetic.make_room_sweep(CAM, n, sweep_deg=140.0)
    D = jnp.asarray(se3.exp(jnp.asarray(
        np.array([0.04, -0.03, 0.025, 0.0, np.deg2rad(2.0), 0.0],
                 np.float32))))

    results = {}
    for rebuild in (True, False):
        slam = keyframe_slam.KeyframeSLAM(_cfg(rebuild))
        for i, d in enumerate(depths):
            if i == 18:  # simulate accumulated drift reaching the tracker
                slam.state = slam.state._replace(pose=D @ slam.state.pose)
            slam.process(d)
        traj = slam.trajectory()
        results[rebuild] = (
            metrics.ate_rmse(traj, gt),
            metrics.ate_rmse(traj[-10:], gt[-10:]),
            sum(e["map_rebuilt"] for e in slam.ba_events),
            len(slam.ba_events),
        )

    ate_r, post_r, rebuilds, ba_r = results[True]
    ate_p, post_p, _, ba_p = results[False]
    assert ba_r > 0 and ba_p > 0, "loop closures must fire in this scenario"
    assert rebuilds > 0, "corrections above threshold must rebuild"
    assert ate_r < 0.05, f"rebuild ATE {ate_r}"
    assert post_r < 0.05, f"rebuild post-BA ATE {post_r}"
    # rebuild must never be worse than fighting a stale map
    assert ate_r < 1.15 * ate_p + 0.002, (ate_r, ate_p)
    assert post_r < 1.3 * post_p + 0.002, (post_r, post_p)
