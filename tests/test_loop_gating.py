"""Loop-closure candidate/edge gating.

Position radius alone admits opposite-facing keyframes (no shared
surface) and degenerate registrations that pass the residual gate; the
gates — optical-axis angle + solution OBSERVABILITY (smallest eigenvalue
of the forward solve's normal matrix) — reject both.  The r2 mutual
(forward/reverse) check remains as an optional stricter mode; it was
demoted after measurement showed it rejecting true closures whose
REVERSE overlap is degenerate (the reverse ICP slid decimetres with no
rotation at flagship scale)."""

import dataclasses

import numpy as np
import jax.numpy as jnp

from voxelhashing_demo_tpu.config import tiny_config
from voxelhashing_demo_tpu.geometry import se3
from voxelhashing_demo_tpu.models import keyframe_slam
from voxelhashing_demo_tpu.ops import icp as icp_ops
from voxelhashing_demo_tpu.ops import preprocess as pre_ops
from voxelhashing_demo_tpu.utils import synthetic


def _slam(**kf_overrides):
    base = tiny_config()
    config = dataclasses.replace(
        base,
        keyframes=dataclasses.replace(
            base.keyframes,
            min_loop_separation=0,
            loop_radius=1.0,
            min_loop_inliers=10,
            max_loop_error=1e-2,
            **kf_overrides,
        ),
    )
    return keyframe_slam.KeyframeSLAM(config)


def _seed_keyframe(slam, pose):
    """Insert one keyframe record directly (bypassing tracking)."""
    d, _ = synthetic.make_sequence(slam.config.camera, 1, trans_amp=0.0,
                                   rot_amp_deg=0.0)
    frame = pre_ops.preprocess(jnp.asarray(d[0]), slam.config.camera)
    small = slam._downsample(frame)
    slam._add_pose(np.asarray(pose, dtype=np.float32))
    slam.keyframes.append(
        keyframe_slam._KeyframeRecord(
            index=len(slam.keyframes), frame_index=0, frame=small,
            depth_raw=np.asarray(d[0], np.uint16),
        )
    )
    return small, np.asarray(d[0], np.uint16), frame


def _fake_batch(calls):
    """_dispatch_batch stub recording candidate counts; nothing passes
    gates (packed (C, 19): error fails max_loop_error, count fails
    min_loop_inliers, observability fails min_loop_obs)."""

    def fake(direction, small, cand_frames, inits, width):
        calls.append((direction, len(cand_frames)))
        C = width
        out = np.zeros((C, 19), np.float32)
        out[:, :16] = np.eye(4, dtype=np.float32).reshape(16)
        out[:, 16] = 1.0
        return out

    return fake


def test_angle_gate_skips_opposite_facing():
    slam = _slam(loop_max_angle_deg=75.0)
    _seed_keyframe(slam, np.eye(4, dtype=np.float32))

    calls = []
    slam._dispatch_batch = _fake_batch(calls)
    # same position, camera turned 180 degrees: only the odometry
    # candidate reaches the batch (the flipped keyframe is angle-gated)
    flipped = np.asarray(se3.exp(jnp.asarray(
        np.array([0, 0, 0, 0, np.pi, 0], np.float32))))
    d, _ = synthetic.make_sequence(slam.config.camera, 1)
    slam._insert_keyframe(flipped.astype(np.float32), d[0])
    slam._complete_kf_edges()
    assert calls and calls[-1] == ("fwd", 1), calls

    # co-oriented new keyframe: both previous keyframes are candidates
    calls.clear()
    slam._insert_keyframe(np.eye(4, dtype=np.float32), d[0])
    slam._complete_kf_edges()
    assert calls and calls[-1][1] >= 2, calls


def test_observability_separates_walls_from_structure():
    """The gate's physics: a flat wall leaves translation-along-the-wall
    unconstrained (lambda_min ~ 0) while a structured scene pins all six
    dofs (lambda_min >= ~1e-2).  Measured here with the real ICP."""
    cfg = tiny_config()
    cam = cfg.camera

    def flat_sdf(p):
        return 2.0 - p[..., 2]

    d0 = synthetic.render_depth(jnp.eye(4), cam, sdf=flat_sdf)
    g0 = pre_ops.preprocess(synthetic.depth_to_raw(d0, cam), cam)
    T1 = np.asarray(se3.exp(jnp.asarray(
        np.array([0.05, 0, 0, 0, 0, 0], np.float32))))
    d1 = synthetic.render_depth(jnp.asarray(T1), cam, sdf=flat_sdf)
    g1 = pre_ops.preprocess(synthetic.depth_to_raw(d1, cam), cam)
    res = icp_ops.icp_align(g1, g0, cam, cfg.icp, init_T=jnp.asarray(T1))
    obs_flat = float(icp_ops.observability(res))
    assert res.count > 1000            # plenty of "inliers" ...
    assert obs_flat < 1e-4, obs_flat   # ... but the solve is degenerate

    depths, poses = synthetic.make_sequence(cam, 2, trans_amp=0.06,
                                            rot_amp_deg=3.0)
    f0 = pre_ops.preprocess(jnp.asarray(depths[0]), cam)
    f1 = pre_ops.preprocess(jnp.asarray(depths[1]), cam)
    init = jnp.asarray(
        np.linalg.inv(np.asarray(poses[0])) @ np.asarray(poses[1])
    )
    res = icp_ops.icp_align(f1, f0, cam, cfg.icp, init_T=init)
    obs_struct = float(icp_ops.observability(res))
    assert obs_struct > 1e-2, obs_struct
    assert obs_struct > 100 * max(obs_flat, 1e-12)


def test_edge_gates_use_observability():
    slam = _slam()
    T = np.eye(4, dtype=np.float32)
    ok = slam._edge_ok_np(T, err=1e-5, cnt=1000, obs=1e-2)
    assert ok
    assert not slam._edge_ok_np(T, err=1e-5, cnt=1000, obs=1e-5)
    assert not slam._edge_ok_np(T, err=1.0, cnt=1000, obs=1e-2)
    assert not slam._edge_ok_np(T, err=1e-5, cnt=1, obs=1e-2)
    bad = T.copy()
    bad[0, 0] = np.nan
    assert not slam._edge_ok_np(bad, err=1e-5, cnt=1000, obs=1e-2)


def test_mutual_gate_optional_mode():
    """loop_mutual_check=True still runs the reverse batch and rejects
    inconsistent compositions."""
    slam = _slam(loop_mutual_check=True)
    # consistent composition ~ identity
    comp = np.asarray(se3.exp(jnp.asarray(
        np.array([0.01, 0, 0, 0, 0.005, 0], np.float32))))
    assert slam._mutual_ok_np(comp)
    # slid 8 cm
    comp = np.asarray(se3.exp(jnp.asarray(
        np.array([0.08, 0, 0, 0, 0, 0], np.float32))))
    assert not slam._mutual_ok_np(comp)

    _seed_keyframe(slam, np.eye(4, dtype=np.float32))
    d, _ = synthetic.make_sequence(slam.config.camera, 1)

    T_fwd = np.asarray(se3.exp(jnp.asarray(
        np.array([0.05, 0, 0, 0, 0.02, 0], np.float32)))).astype(np.float32)

    def batch_factory(rev_T):
        def fake(direction, small, cand_frames, inits, width):
            C = width
            T = T_fwd if direction == "fwd" else rev_T
            out = np.zeros((C, 19), np.float32)
            out[:, :16] = T.reshape(16)
            out[:, 16] = 1e-6
            out[:, 17] = 1e4
            out[:, 18] = 1e-1
            return out
        return fake

    # consistent reverse -> loop edge accepted (odometry candidate is the
    # same keyframe here, so the edge count grows by 2: odo + loop)
    slam._dispatch_batch = batch_factory(np.linalg.inv(T_fwd))
    before = slam._n_edges
    slam._insert_keyframe(np.eye(4, dtype=np.float32), d[0])
    slam._complete_kf_edges()
    assert slam._n_edges == before + 2

    # inconsistent reverse (slid): loop edge rejected, odometry stays
    slam._dispatch_batch = batch_factory(
        np.linalg.inv(T_fwd)
        @ np.asarray(se3.exp(jnp.asarray(
            np.array([0.08, 0, 0, 0, 0, 0], np.float32))))
    )
    before = slam._n_edges
    slam._insert_keyframe(np.eye(4, dtype=np.float32), d[0])
    slam._complete_kf_edges()
    assert slam._n_edges == before + 1


def test_real_pair_passes_gates():
    """A genuine structured-scene pair must pass the default gates end to
    end (the gates must not reject true closures)."""
    slam = _slam()
    depths, poses = synthetic.make_sequence(
        slam.config.camera, 2, trans_amp=0.06, rot_amp_deg=3.0
    )
    f0 = slam._downsample(pre_ops.preprocess(jnp.asarray(depths[0]),
                                             slam.config.camera))
    f1 = slam._downsample(pre_ops.preprocess(jnp.asarray(depths[1]),
                                             slam.config.camera))
    init = np.asarray(
        np.linalg.inv(np.asarray(poses[0])) @ np.asarray(poses[1])
    ).astype(np.float32)
    Ts, errs, cnts, obs = slam._run_batch("fwd", f1, [f0], [init], 4)
    assert slam._edge_ok_np(Ts[0], errs[0], cnts[0], obs[0]), (
        errs[0], cnts[0], obs[0],
    )
