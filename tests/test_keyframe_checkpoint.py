"""Keyframe-backend durability: checkpoint mid-sweep,
resume, and the backend keeps its full capability — loop closures against
PRE-checkpoint keyframes still fire, map rebuilds still work, and the
trajectory matches the uninterrupted run.

The reference's only persistence is a debug text dump
(reference: SDFRenderer.cpp:71-110 printSDFdata).
"""

import dataclasses
import os

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
from voxelhashing_demo_tpu.utils import checkpoint as ck
from voxelhashing_demo_tpu.utils import metrics, synthetic

CAM = CameraConfig(width=160, height=120, fx=129.3, fy=129.1,
                   cx=79.65, cy=59.8)


def _cfg() -> PipelineConfig:
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
            rebuild_map=True, rebuild_min_trans=0.03,
            # full rebuilds only: the incremental contribution ledger is
            # deliberately NOT persisted across restarts (its ring holds
            # device arrays), so exact resume-equivalence is the promise
            # of the full-rebuild mode
            rebuild_incremental=False,
        ),
    )


def _drift_scenario(n=40):
    depths, gt = synthetic.make_room_sweep(CAM, n, sweep_deg=140.0)
    D = jnp.asarray(se3.exp(jnp.asarray(
        np.array([0.04, -0.03, 0.025, 0.0, np.deg2rad(2.0), 0.0],
                 np.float32))))
    return depths, gt, D


def _run(slam, depths, D, start, stop):
    for i in range(start, stop):
        if i == 18:  # simulate accumulated drift reaching the tracker
            slam.state = slam.state._replace(pose=D @ slam.state.pose)
        slam.process(depths[i])
    return slam


def test_roundtrip_preserves_backend_state(tmp_path):
    depths, _, D = _drift_scenario(16)
    slam = _run(keyframe_slam.KeyframeSLAM(_cfg()), depths, D, 0, 16)
    path = os.path.join(tmp_path, "kf.npz")
    ck.save_keyframe_slam(path, slam)
    back = ck.load_keyframe_slam(path)

    assert len(back.keyframes) == len(slam.keyframes)
    for a, b in zip(slam.keyframes, back.keyframes):
        assert a.index == b.index and a.frame_index == b.frame_index
        np.testing.assert_array_equal(a.depth_np(), b.depth_np())
        # downsampled ICP frames recompute deterministically
        np.testing.assert_allclose(
            np.asarray(a.frame.depth), np.asarray(b.frame.depth),
            atol=1e-6,
        )
    np.testing.assert_array_equal(
        np.asarray(slam.graph.poses), np.asarray(back.graph.poses)
    )
    assert int(back.graph.num_edges) == int(slam.graph.num_edges)
    assert len(back._frame_refs) == len(slam._frame_refs)
    for (ka, ra), (kb, rb) in zip(slam._frame_refs, back._frame_refs):
        assert ka == kb
        np.testing.assert_allclose(np.asarray(ra), rb, atol=1e-6)
    assert back.ba_events == slam.ba_events
    assert back._frame_idx == slam._frame_idx
    np.testing.assert_array_equal(
        np.asarray(back.state.pose), np.asarray(slam.state.pose)
    )
    np.testing.assert_array_equal(
        np.asarray(back.state.hmap.tsdf), np.asarray(slam.state.hmap.tsdf)
    )


def test_resume_keeps_loop_closure_capability(tmp_path):
    """Checkpoint BEFORE the drift/loop-closure events; after resume, loop
    closures against pre-checkpoint keyframes must fire, BA must rebuild
    the map, and the trajectory must match the uninterrupted run."""
    n, cut = 40, 15
    depths, gt, D = _drift_scenario(n)

    # uninterrupted
    full = _run(keyframe_slam.KeyframeSLAM(_cfg()), depths, D, 0, n)
    assert len(full.ba_events) > 0, "scenario must close loops"

    # interrupted at `cut` (before the drift injection at 18)
    first = _run(keyframe_slam.KeyframeSLAM(_cfg()), depths, D, 0, cut)
    n_kf_at_cut = len(first.keyframes)
    path = os.path.join(tmp_path, "mid.npz")
    ck.save_keyframe_slam(path, first)

    resumed = ck.load_keyframe_slam(path)
    assert resumed._frame_idx == cut
    _run(resumed, depths, D, cut, n)

    # loop closures fired AFTER resume ...
    post = [e for e in resumed.ba_events if e["frame"] >= cut]
    assert post, "loop closure must fire after resume"
    assert any(e["map_rebuilt"] for e in post), "BA must rebuild the map"
    # ... against PRE-checkpoint keyframes (a loop edge, i.e. non-adjacent,
    # whose older endpoint predates the checkpoint)
    eij = np.asarray(resumed.graph.edges_ij[: int(resumed.graph.num_edges)])
    loops = eij[np.abs(eij[:, 1] - eij[:, 0]) > 1]
    assert len(loops) > 0
    assert (loops.min(axis=1) < n_kf_at_cut).any(), loops

    # trajectory matches the uninterrupted run
    t_full = full.trajectory()
    t_res = resumed.trajectory()
    assert len(t_res) == n
    err = max(
        float(np.linalg.norm(np.asarray(a)[:3, 3] - np.asarray(b)[:3, 3]))
        for a, b in zip(t_full, t_res)
    )
    assert err < 1e-3, f"resumed trajectory diverged: {err}"
    # and both runs land within the quality bound of the scenario
    ate = metrics.ate_rmse(t_res, gt)
    assert ate < 0.25, ate
