"""Deferred-BA scheduling (KeyframeConfig.ba_defer_edges/_frames).

In a continuous-closure regime (every keyframe insert accepts a loop
edge — lap 2 of an endurance run) per-closure BA + reintegration
dominated wall-clock.  The
deferral window batches accepted closures into one solve: these tests
pin the trigger semantics (edge-count batch, age bound, forced flush)
by stubbing the candidate ICP so every insert accepts a loop edge.
"""

import dataclasses

import numpy as np

from voxelhashing_demo_tpu.config import tiny_config
from voxelhashing_demo_tpu.models import keyframe_slam
from voxelhashing_demo_tpu.utils import synthetic


def _make_slam(**kf_overrides):
    base = tiny_config()
    kw = dict(
        # insert a keyframe every frame; every older keyframe is a
        # loop candidate
        min_rotation_deg=0.0, min_translation=0.0,
        min_loop_separation=0, loop_radius=10.0,
        loop_max_angle_deg=180.0,
        rebuild_map=False,      # isolate the scheduling logic
        sync_every=1,
    )
    kw.update(kf_overrides)
    config = dataclasses.replace(
        base, keyframes=dataclasses.replace(base.keyframes, **kw)
    )
    slam = keyframe_slam.KeyframeSLAM(config)

    def fake_dispatch(direction, small, cand_frames, inits, width):
        # packed (C, 19) result the completion path unpacks: identity
        # transforms, tiny error, huge count, full observability —
        # every candidate passes the gates
        C = width
        out = np.zeros((C, 19), np.float32)
        out[:, :16] = np.eye(4, dtype=np.float32).reshape(16)
        out[:, 16] = 1e-6
        out[:, 17] = 1e6
        out[:, 18] = 1.0
        return out

    slam._ensure_batch_icps = lambda: None
    slam._dispatch_batch = fake_dispatch
    slam._kf_pre = lambda d: None
    return slam


def _drive(slam, n=10):
    depths, _ = synthetic.make_sequence(
        slam.config.camera, n, trans_amp=0.02, rot_amp_deg=1.0
    )
    for d in depths:
        slam.process(d)
    return slam


def test_sync_edge_mode_matches_async():
    """kf_async_edges=False (synchronous inserts) must produce the same
    graph as the async path once both are flushed — and async must NOT
    engage in a per-closure (ba_defer 1/0) configuration, which chose
    correction-latency-first semantics."""
    a = _drive(_make_slam(ba_defer_edges=3))
    s = _drive(_make_slam(ba_defer_edges=3, kf_async_edges=False))
    assert a._kf_pending, "async must engage under deferral"
    a.flush()
    s.flush()
    assert not a._kf_pending
    assert a._n_edges == s._n_edges
    assert a._n_poses == s._n_poses
    np.testing.assert_allclose(
        np.asarray(a.graph.edges_T[: a._n_edges]),
        np.asarray(s.graph.edges_T[: s._n_edges]), atol=1e-6,
    )
    # per-closure config: inserts stay synchronous even with the flag on
    p = _drive(_make_slam())
    assert not p._kf_pending
    assert len(p.ba_events) >= 3


def test_default_is_per_closure_ba():
    slam = _drive(_make_slam())
    # every insert after the second keyframe accepts a loop edge and,
    # with the default (1, 0) window, runs BA immediately
    assert len(slam.ba_events) >= 3
    assert slam._pending_ba_edges == 0


def test_edge_batch_defers_and_flush_forces():
    a = _drive(_make_slam())
    b = _drive(_make_slam(ba_defer_edges=3))
    assert 1 <= len(b.ba_events) < len(a.ba_events)
    # a leftover pending closure (if any) is resolved by flush()
    a.flush()
    b.flush()
    assert b._pending_ba_edges == 0
    # nothing lost: the deferred edges are all in the graph
    assert b._n_edges == a._n_edges


def test_age_trigger_bounds_latency():
    c = _drive(_make_slam(ba_defer_edges=999, ba_defer_frames=4))
    a = _drive(_make_slam())
    assert 1 <= len(c.ba_events) < len(a.ba_events)
    # the oldest pending closure never waits more than the age bound
    # (events record the frame at which BA actually ran)
    frames = [e["frame"] for e in c.ba_events]
    assert frames[0] <= 2 + 4  # first closure frame + bound


def test_fully_deferred_runs_only_at_flush():
    d = _drive(_make_slam(ba_defer_edges=999, ba_defer_frames=0))
    assert len(d.ba_events) == 0
    assert d._pending_ba_edges > 0
    d.flush()
    assert len(d.ba_events) == 1
    assert d._pending_ba_edges == 0


def test_async_ba_completes_at_next_drain():
    """kcfg.ba_async: the solve dispatched at the trigger completes at a
    later drain (or at flush), produces the same event record fields,
    and leaves no in-flight state behind."""
    slam = _drive(_make_slam(ba_defer_edges=3, ba_async=True, sync_every=2),
                  n=12)
    slam.flush()
    assert slam._ba_inflight is None
    assert len(slam.ba_events) >= 1
    for e in slam.ba_events:
        assert "ba_s" in e and "rebuild_s" in e
        assert np.isfinite(e["chi2_final"])
    assert np.all(np.isfinite(slam._poses_np))


def test_async_ba_rebases_keyframes_inserted_in_flight():
    """A keyframe inserted while the solve is in flight is re-based by
    the completion correction: afterwards the host mirror and the device
    graph agree row for row."""
    import jax.numpy as jnp

    slam = _drive(_make_slam(ba_defer_edges=2, ba_async=True, sync_every=4),
                  n=14)
    slam.flush()
    assert slam._ba_inflight is None
    n = slam._n_poses
    np.testing.assert_allclose(
        np.asarray(slam.graph.poses[:n]), slam._poses_np[:n], atol=1e-5
    )


def test_async_matches_sync_on_real_sequence():
    """End-to-end on real synthetic tracking (no stubs): async BA yields
    a finite trajectory with ATE in the same band as the synchronous
    path."""
    import dataclasses

    from voxelhashing_demo_tpu.config import tiny_config
    from voxelhashing_demo_tpu.utils import metrics

    results = {}
    for use_async in (False, True):
        base = tiny_config()
        config = dataclasses.replace(
            base,
            keyframes=dataclasses.replace(
                base.keyframes,
                min_rotation_deg=2.0, min_translation=0.03,
                icp_downsample=2, min_loop_inliers=150,
                max_loop_error=5e-4, loop_radius=1.0,
                min_loop_separation=2, ba_iters=5,
                sync_every=4, ba_async=use_async,
            ),
        )
        depths, gt = synthetic.make_sequence(
            config.camera, 10, trans_amp=0.10, rot_amp_deg=5.0
        )
        slam = keyframe_slam.KeyframeSLAM(config)
        for d in depths:
            slam.process(d)
        traj = slam.trajectory()
        assert all(np.all(np.isfinite(T)) for T in traj)
        results[use_async] = metrics.ate_rmse(traj, gt)
    assert results[True] < 0.05, results
    assert results[True] < results[False] + 0.02
