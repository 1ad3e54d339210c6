"""De-integration and incremental BA reintegration.

The Curless-Levoy weighted average is exactly invertible below the weight
cap: regenerating a fused frame's samples (same depth + pose) and applying
the inverse update removes its contribution bit-for-bit
(ops/hash_ops.defuse_frame, gated to rows that existed when it was fused
via HashMap.born).  On top of that, keyframe_slam replays only MOVED
keyframes after a BA correction instead of rebuilding the whole map.
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
    tiny_config,
)
from voxelhashing_demo_tpu.geometry import se3
from voxelhashing_demo_tpu.ops import hash_ops
from voxelhashing_demo_tpu.ops import preprocess as pre_ops
from voxelhashing_demo_tpu.utils import metrics, synthetic


def _fuse(hmap, cfg, depth_raw, pose, frame_idx):
    frame = pre_ops.preprocess(jnp.asarray(depth_raw), cfg.camera)
    hmap, _, _ = hash_ops.fuse_frame(
        hmap, frame, jnp.asarray(pose), cfg.camera, cfg.hash, cfg.fusion,
        frame_idx=frame_idx,
    )
    return hmap


def _rows_by_key(hmap):
    keys = np.asarray(hmap.keys)
    ptrs = np.asarray(hmap.ptrs)
    occ = ptrs >= 0
    return {
        int(k): int(p) for k, p in zip(keys[occ], ptrs[occ])
    }


def test_defuse_is_exact_inverse():
    """fuse(A); fuse(B); defuse(B)  ==  fuse(A), voxel for voxel."""
    cfg = tiny_config()
    depths, poses = synthetic.make_sequence(
        cfg.camera, 2, trans_amp=0.06, rot_amp_deg=4.0
    )

    only_a = _fuse(hash_ops.create(cfg.hash), cfg, depths[0], poses[0], 0)

    both = _fuse(hash_ops.create(cfg.hash), cfg, depths[0], poses[0], 0)
    both = _fuse(both, cfg, depths[1], poses[1], 1)
    frame_b = pre_ops.preprocess(jnp.asarray(depths[1]), cfg.camera)
    undone = hash_ops.defuse_frame(
        both, frame_b, jnp.asarray(poses[1]), cfg.camera, cfg.hash,
        cfg.fusion, frame_born=1,
    )

    rows_a = _rows_by_key(only_a)
    rows_u = _rows_by_key(undone)
    # every A-block must exist and match A's content exactly
    t_a, w_a = np.asarray(only_a.tsdf), np.asarray(only_a.weight)
    t_u, w_u = np.asarray(undone.tsdf), np.asarray(undone.weight)
    assert set(rows_a) <= set(rows_u)
    for key, pa in rows_a.items():
        pu = rows_u[key]
        np.testing.assert_allclose(w_u[pu], w_a[pa], atol=1e-4)
        live = w_a[pa] > 0
        np.testing.assert_allclose(
            t_u[pu][live], t_a[pa][live], atol=5e-4
        )
        # voxels A never observed must return to the unobserved state
        assert np.abs(w_u[pu][~live]).max(initial=0.0) < 1e-4
    # blocks allocated only by B keep zero weight after the defuse
    for key, pu in rows_u.items():
        if key not in rows_a:
            assert w_u[pu].max() < 1e-4
    # band_min is maintained consistently (recomputed rows match content)
    bm = np.asarray(undone.band_min)
    for key, pu in rows_u.items():
        live = w_u[pu] > 0
        expect = np.abs(t_u[pu][live]).min() if live.any() else np.inf
        assert bm[pu] == np.float32(expect) or (
            np.isinf(bm[pu]) and not live.any()
        )


def test_defuse_born_gate_skips_younger_rows():
    """Rows allocated AFTER the defused frame must be untouched (they
    never received its samples)."""
    cfg = tiny_config()
    depths, poses = synthetic.make_sequence(
        cfg.camera, 2, trans_amp=0.20, rot_amp_deg=10.0
    )
    # fuse B first (born 0), then A (born 1): defusing "A as of time 0"
    # must not touch rows born at time 1
    hmap = _fuse(hash_ops.create(cfg.hash), cfg, depths[1], poses[1], 0)
    keys_b = set(_rows_by_key(hmap))
    hmap = _fuse(hmap, cfg, depths[0], poses[0], 1)
    before_t = np.asarray(hmap.tsdf).copy()
    before_w = np.asarray(hmap.weight).copy()

    frame_b = pre_ops.preprocess(jnp.asarray(depths[1]), cfg.camera)
    undone = hash_ops.defuse_frame(
        hmap, frame_b, jnp.asarray(poses[1]), cfg.camera, cfg.hash,
        cfg.fusion, frame_born=0,
    )
    rows = _rows_by_key(undone)
    t_u, w_u = np.asarray(undone.tsdf), np.asarray(undone.weight)
    born = np.asarray(undone.born)
    for key, p in rows.items():
        if born[p] > 0:  # allocated by the later fuse — must be untouched
            np.testing.assert_array_equal(t_u[p], before_t[p])
            np.testing.assert_array_equal(w_u[p], before_w[p])


CAM = CameraConfig(width=160, height=120, fx=129.3, fy=129.1,
                   cx=79.65, cy=59.8)


def _cfg(incremental: bool) -> PipelineConfig:
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
            rebuild_incremental=incremental,
        ),
    )


def test_incremental_matches_full_rebuild():
    """Drift scenario with repeated BA corrections: the incremental path
    (first correction full, later ones reintegrating only moved keyframes)
    must land within the full-rebuild run's quality envelope."""
    from voxelhashing_demo_tpu.models import keyframe_slam

    n = 48
    depths, gt = synthetic.make_room_sweep(CAM, n, sweep_deg=150.0)
    D1 = jnp.asarray(se3.exp(jnp.asarray(
        np.array([0.04, -0.03, 0.025, 0.0, np.deg2rad(2.0), 0.0],
                 np.float32))))
    D2 = jnp.asarray(se3.exp(jnp.asarray(
        np.array([-0.03, 0.025, -0.02, 0.0, np.deg2rad(-1.5), 0.0],
                 np.float32))))

    results = {}
    for incremental in (True, False):
        slam = keyframe_slam.KeyframeSLAM(_cfg(incremental))
        for i, d in enumerate(depths):
            if i == 18:
                slam.state = slam.state._replace(pose=D1 @ slam.state.pose)
            if i == 34:
                slam.state = slam.state._replace(pose=D2 @ slam.state.pose)
            slam.process(d)
        modes = [e["rebuild_mode"] for e in slam.ba_events
                 if e["map_rebuilt"]]
        results[incremental] = (
            metrics.ate_rmse(slam.trajectory(), gt), modes,
            sum(e.get("keyframes_reintegrated", 0) for e in slam.ba_events),
        )

    ate_inc, modes_inc, n_reint = results[True]
    ate_full, modes_full, _ = results[False]
    assert all(m == "full" for m in modes_full)
    assert modes_inc and modes_inc[0] == "full"
    assert "incremental" in modes_inc, modes_inc
    # incremental must move fewer ledger entries (keyframes + ring
    # frames) than full replays of everything would
    full_replays = sum(1 for m in modes_inc if m == "incremental")
    cfg = _cfg(True)
    assert n_reint < full_replays * (
        cfg.keyframes.max_keyframes + cfg.keyframes.rebuild_window
    )
    assert ate_inc < 0.25, ate_inc
    assert ate_inc < max(1.5 * ate_full, ate_full + 0.02), (
        ate_inc, ate_full,
    )


def test_incremental_ledger_matches_from_scratch_map():
    """The decisive consistency check for incremental reintegration: after
    a run with live fusion + multiple BA corrections, the incrementally
    maintained TSDF must render like a map built FROM SCRATCH from the
    same contributions (ledgered keyframes + ring frames) at their final
    corrected poses.  Stale contributions left at drifted poses, phantom
    de-integrations (subtracting samples never added), or dropped ring
    frames all show up as render divergence here."""
    from voxelhashing_demo_tpu.models import keyframe_slam
    from voxelhashing_demo_tpu.ops import hash_ops

    n = 48
    depths, gt = synthetic.make_room_sweep(CAM, n, sweep_deg=150.0)
    D1 = jnp.asarray(se3.exp(jnp.asarray(
        np.array([0.04, -0.03, 0.025, 0.0, np.deg2rad(2.0), 0.0],
                 np.float32))))
    D2 = jnp.asarray(se3.exp(jnp.asarray(
        np.array([-0.03, 0.025, -0.02, 0.0, np.deg2rad(-1.5), 0.0],
                 np.float32))))
    cfg = _cfg(True)
    slam = keyframe_slam.KeyframeSLAM(cfg)
    for i, d in enumerate(depths):
        if i == 18:
            slam.state = slam.state._replace(pose=D1 @ slam.state.pose)
        if i == 34:
            slam.state = slam.state._replace(pose=D2 @ slam.state.pose)
        slam.process(d)
    slam.flush()
    modes = [e["rebuild_mode"] for e in slam.ba_events if e["map_rebuilt"]]
    assert "incremental" in modes, modes
    assert not slam._ring_overflow
    assert not any(e.get("reintegration_saturated")
                   for e in slam.ba_events)

    # reference: same contributions, fused from scratch at their FINAL
    # corrected poses
    fuse = keyframe_slam.make_fuse_only(cfg)
    poses = slam._poses_np
    ref = hash_ops.create(cfg.hash)
    for rec in slam.keyframes:
        if rec.map_pose is None:
            continue   # post-rebuild keyframe: contribution is its ring entry
        ref = fuse(ref, rec.depth_dev, jnp.asarray(poses[rec.index]),
                   jnp.int32(rec.frame_index))
    for ent in slam._ring:
        target = (poses[ent.kf] @ ent.rel).astype(np.float32)
        ref = fuse(ref, ent.depth, jnp.asarray(target),
                   jnp.int32(ent.frame_index))

    render = keyframe_slam.make_render_model(cfg)
    a = render(slam.state.hmap, slam.state.pose)
    b = render(ref, slam.state.pose)
    da, db = np.asarray(a.depth), np.asarray(b.depth)
    both = (da > 0) & (db > 0)
    assert both.mean() > 0.5
    med = np.median(np.abs(da - db)[both])
    # ledger entries may sit up to rebuild_move_min_trans from their
    # corrected pose (unmoved-below-threshold slack) — sub-voxel here
    assert med < 1.0 * cfg.fusion.voxel_size, med
    # coverage must agree too (no dropped/phantom contributions)
    assert (da > 0).mean() > 0.9 * (db > 0).mean()
    assert (db > 0).mean() > 0.9 * (da > 0).mean()
