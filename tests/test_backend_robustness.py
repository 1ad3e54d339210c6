"""Backend robustness: Huber BA vs false loop edges, graph capacity
growth (no silent saturation), and tracking-lost relocalization.

No reference counterpart for any of this — the
reference has no backend and its only recovery mechanism is the legacy
``rigidAlignment`` SVD fallback (reference: CameraTracking.cpp:92-115),
whose role the relocalizer takes over.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np

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
from voxelhashing_demo_tpu.ops import pose_graph
from voxelhashing_demo_tpu.utils import metrics, synthetic


def _ring_poses(K: int, radius: float = 1.0):
    poses = []
    for i in range(K):
        a = 2 * np.pi * i / K
        xi = np.array(
            [radius * np.cos(a), 0.0, radius * np.sin(a), 0.0, a, 0.0],
            dtype=np.float32,
        )
        poses.append(np.asarray(se3.exp(jnp.asarray(xi))))
    return poses


def _rel(Ta, Tb):
    return np.asarray(se3.inverse(jnp.asarray(Ta)) @ jnp.asarray(Tb))


def _drifted_ring_graph(K=8, seed=0, max_edges=None):
    """Ring graph with noisy-odometry initial estimates, clean odometry
    measurements, and the true loop edge closing the ring."""
    gt = _ring_poses(K)
    rng = np.random.RandomState(seed)
    graph = pose_graph.create(max_keyframes=K, max_edges=max_edges or K + 4)
    est = [gt[0]]
    for i in range(K - 1):
        z = _rel(gt[i], gt[i + 1])
        noise = np.concatenate(
            [rng.normal(0, 0.02, 3), rng.normal(0, 0.01, 3)]
        ).astype(np.float32)
        est.append(est[-1] @ (z @ np.asarray(se3.exp(jnp.asarray(noise)))))
    for T in est:
        graph = pose_graph.add_pose(graph, jnp.asarray(T))
    for i in range(K - 1):
        graph = pose_graph.add_edge(
            graph, i, i + 1, jnp.asarray(_rel(gt[i], gt[i + 1]))
        )
    graph = pose_graph.add_edge(
        graph, K - 1, 0, jnp.asarray(_rel(gt[K - 1], gt[0]))
    )
    return graph, gt


def test_robust_kernel_rejects_false_loop_edge():
    """A gate-passing false loop closure (wrong by ~0.5 m) must not corrupt
    the graph when the robust kernel is on; with it off, it does.  The
    default Geman-McClure kernel sheds the edge almost entirely; Huber
    bounds its influence."""
    ates = {}
    for delta, kernel in ((0.0, "gm"), (0.1, "huber"), (0.1, "gm")):
        graph, gt = _drifted_ring_graph()
        # the false closure: claims keyframes 2 and 6 coincide-ish, when
        # they are actually ~2 m apart on the ring
        false_T = np.asarray(
            se3.exp(jnp.asarray(np.array(
                [0.5, -0.3, 0.2, 0.0, 0.3, 0.0], np.float32)))
        )
        graph = pose_graph.add_edge(graph, 2, 6, jnp.asarray(false_T))
        cfg = KeyframeConfig(ba_iters=10, ba_robust_delta=delta,
                             ba_robust_kernel=kernel)
        out, info = pose_graph.optimize(graph, cfg)
        K = len(gt)
        ates[(delta, kernel)] = metrics.ate_rmse(
            [np.asarray(p) for p in out.poses[:K]], gt, align=False
        )
        assert np.all(np.isfinite(np.asarray(out.poses)))
    plain = ates[(0.0, "gm")]
    assert ates[(0.1, "gm")] < 0.005, ates        # GM: edge fully shed
    assert ates[(0.1, "huber")] < 0.05, ates      # Huber: bounded influence
    assert ates[(0.1, "gm")] < 0.05 * plain, ates
    assert ates[(0.1, "huber")] < 0.3 * plain, ates


def test_robust_kernel_keeps_true_loop_closure_working():
    """The robust kernel must not reject honest drift corrections: with
    only true edges, robust-on converges as well as robust-off."""
    graph, gt = _drifted_ring_graph()
    cfg = KeyframeConfig(ba_iters=10, ba_robust_delta=0.1)
    out, info = pose_graph.optimize(graph, cfg)
    K = len(gt)
    ate = metrics.ate_rmse(
        [np.asarray(p) for p in out.poses[:K]], gt, align=False
    )
    assert ate < 1e-3, ate
    assert float(info.chi2_final) < float(info.chi2_initial)


def test_grow_preserves_graph_and_optimization():
    """grow() must preserve contents bit-exactly and leave the optimum
    unchanged (padding edges have weight 0)."""
    graph, gt = _drifted_ring_graph()
    big = pose_graph.grow(graph, 32, 64)
    assert big.poses.shape == (32, 4, 4)
    assert big.edges_ij.shape == (64, 2)
    K = graph.poses.shape[0]
    E = graph.edges_ij.shape[0]
    np.testing.assert_array_equal(np.asarray(big.poses[:K]),
                                  np.asarray(graph.poses))
    np.testing.assert_array_equal(np.asarray(big.edges_ij[:E]),
                                  np.asarray(graph.edges_ij))
    assert int(big.num_poses) == int(graph.num_poses)
    assert int(big.num_edges) == int(graph.num_edges)

    cfg = KeyframeConfig(ba_iters=8)
    small_opt, _ = pose_graph.optimize(graph, cfg)
    big_opt, _ = pose_graph.optimize(big, cfg)
    np.testing.assert_allclose(
        np.asarray(big_opt.poses[:K]), np.asarray(small_opt.poses),
        atol=1e-5,
    )

    try:
        pose_graph.grow(big, 4, 4)
        assert False, "shrinking grow must raise"
    except ValueError:
        pass


def _kf_cfg(**kf_overrides) -> PipelineConfig:
    base = tiny_config()
    kw = dict(
        min_rotation_deg=2.0,
        min_translation=0.03,
        icp_downsample=2,
        min_loop_inliers=150,
        max_loop_error=5e-4,
        loop_radius=1.0,
        min_loop_separation=2,
        ba_iters=5,
    )
    kw.update(kf_overrides)
    return dataclasses.replace(
        base, keyframes=dataclasses.replace(base.keyframes, **kw)
    )


def test_keyframe_capacity_grows_on_demand():
    """More keyframe insertions than the initial capacity: the graph
    doubles instead of silently dropping keyframes."""
    from voxelhashing_demo_tpu.models import keyframe_slam

    config = _kf_cfg(max_keyframes=2, max_edges=2)
    depths, gt = synthetic.make_sequence(
        config.camera, 10, trans_amp=0.10, rot_amp_deg=5.0
    )
    slam = keyframe_slam.KeyframeSLAM(config)
    for d in depths:
        slam.process(d)

    assert len(slam.keyframes) > 2, "growth must admit keyframes past cap"
    assert slam.graph.poses.shape[0] >= len(slam.keyframes)
    assert int(slam.graph.num_poses) == len(slam.keyframes)
    assert not slam.saturated
    kinds = {e["kind"] for e in slam.capacity_events}
    assert "grow_keyframes" in kinds and "grow_edges" in kinds
    # the grown-graph trajectory still tracks
    ate = metrics.ate_rmse(slam.trajectory(), gt)
    assert ate < 0.05, ate


def test_keyframe_saturation_is_surfaced():
    """With growth disabled, hitting capacity must set the saturated flag
    and log an event — never a silent no-op."""
    from voxelhashing_demo_tpu.models import keyframe_slam

    config = _kf_cfg(max_keyframes=2, max_edges=8, grow_on_capacity=False)
    depths, _ = synthetic.make_sequence(
        config.camera, 8, trans_amp=0.10, rot_amp_deg=5.0
    )
    slam = keyframe_slam.KeyframeSLAM(config)
    for d in depths:
        slam.process(d)

    assert len(slam.keyframes) == 2
    assert slam.saturated
    assert any(e["kind"] == "saturated_keyframes"
               for e in slam.capacity_events)


CAM = CameraConfig(width=160, height=120, fx=129.3, fy=129.1,
                   cx=79.65, cy=59.8)


def _reloc_cfg() -> PipelineConfig:
    return PipelineConfig(
        camera=CAM,
        icp=ICPConfig(pyramid=(4, 2, 1), pyramid_iters=(8, 4, 2)),
        fusion=FusionConfig(voxel_size=0.03, truncation=0.12),
        hash=HashConfig(num_buckets=4096, bucket_size=4, num_blocks=4096,
                        max_active=2048, max_new_per_frame=2048),
        raycast=RaycastConfig(max_steps=96, cache_dims=(160, 160, 160)),
        gc=GCConfig(enabled=False),
        keyframes=KeyframeConfig(
            max_keyframes=64, max_edges=256,
            min_rotation_deg=4.0, min_translation=0.05,
            icp_downsample=2, loop_radius=0.6, min_loop_separation=6,
            min_loop_inliers=800, max_loop_error=1e-4, ba_iters=8,
            relocalize=True, reloc_after=2, reloc_interval=1,
            reloc_max_candidates=32,
        ),
    )


def test_relocalization_recovers_kidnapped_camera():
    """Sweep a room, black out the sensor, resume at a much earlier part
    of the sweep (kidnapped camera): frame-to-model ICP diverges against
    the stale model; the relocalizer re-registers against stored keyframes
    and the pipeline continues tracking from the recovered pose."""
    from voxelhashing_demo_tpu.models import keyframe_slam

    config = _reloc_cfg()
    sweep = 90.0
    n1 = 16

    def room_frame(phase):
        T = synthetic.room_sweep_pose(phase, sweep)
        d = synthetic.render_depth(jnp.asarray(T), CAM,
                                   sdf=synthetic.room_sdf)
        return np.asarray(synthetic.depth_to_raw(d, CAM)), T

    T0_inv = np.linalg.inv(synthetic.room_sweep_pose(0.0, sweep))
    seq, gt = [], []
    for i in range(n1):                       # sweep 0 -> ~84 degrees
        d, T = room_frame(i / n1)
        seq.append(d)
        gt.append((T0_inv @ T).astype(np.float32))
    blackout = np.zeros_like(seq[0])
    for _ in range(3):                        # sensor blackout
        seq.append(blackout)
        gt.append(None)
    for i in range(6):                        # kidnapped back to ~13 deg
        d, T = room_frame(0.145 + 0.02 * i)
        seq.append(d)
        gt.append((T0_inv @ T).astype(np.float32))

    slam = keyframe_slam.KeyframeSLAM(config)
    for d in seq:
        slam.process(d)

    assert len(slam.keyframes) >= 6
    assert len(slam.relocalizations) >= 1, "relocalization must fire"
    # blackout + kidnap frames were untracked
    lost = [i for i, info in enumerate(slam.infos) if not bool(info.tracked)]
    assert len(lost) >= 3
    # after recovery the tail tracks again
    tail = slam.infos[-3:]
    assert all(bool(i.tracked) for i in tail), \
        [bool(i.tracked) for i in slam.infos]
    # and the recovered poses are near ground truth (absolute, unaligned)
    traj = slam.trajectory()
    err = [
        float(np.linalg.norm(np.asarray(traj[i])[:3, 3] - gt[i][:3, 3]))
        for i in range(len(seq) - 3, len(seq))
    ]
    assert max(err) < 0.10, err


def test_sync_every_batching_equivalence():
    """kcfg.sync_every batches the host-side bookkeeping (pose fetches)
    without changing the backend's decisions: with BA out of the picture
    the keyframe set, graph, and trajectory match sync_every=1 exactly;
    with in-batch BA the only drift is corrections landing <=B-1 frames
    late (sub-mm on this scenario)."""
    from voxelhashing_demo_tpu.models import keyframe_slam

    def run(b, with_ba):
        config = _kf_cfg(
            sync_every=b,
            **({} if with_ba else {"loop_radius": 0.0}),  # no closures
        )
        depths, gt = synthetic.make_sequence(
            config.camera, 10, trans_amp=0.10, rot_amp_deg=5.0
        )
        slam = keyframe_slam.KeyframeSLAM(config)
        for d in depths:
            slam.process(d)
        traj = slam.trajectory()   # flushes pending bookkeeping
        return (
            len(slam.keyframes),
            [r.frame_index for r in slam.keyframes],
            slam._n_edges,
            len(slam.ba_events),
            traj,
            metrics.ate_rmse(traj, gt),
        )

    # BA-free: bit-equivalent decisions and trajectory
    k1, f1, e1, _, t1, a1 = run(1, with_ba=False)
    k4, f4, e4, _, t4, a4 = run(4, with_ba=False)
    assert (k1, f1, e1) == (k4, f4, e4)
    assert len(t1) == len(t4) == 10
    err = max(
        float(np.linalg.norm(np.asarray(a)[:3, 3] - np.asarray(b_)[:3, 3]))
        for a, b_ in zip(t1, t4)
    )
    assert err < 1e-5, err

    # with BA: same keyframes/edges; corrections land <=B-1 frames late,
    # bending the trajectory sub-mm at this scale
    k1, f1, e1, ba1, t1, a1 = run(1, with_ba=True)
    k4, f4, e4, ba4, t4, a4 = run(4, with_ba=True)
    assert (k1, f1) == (k4, f4)
    assert ba1 > 0 and ba4 > 0
    err = max(
        float(np.linalg.norm(np.asarray(a)[:3, 3] - np.asarray(b_)[:3, 3]))
        for a, b_ in zip(t1, t4)
    )
    assert err < 8e-3, err
    assert abs(a1 - a4) < 3e-3


def _big_drift_graph(noise_scale, seed=3):
    """Noisy odometry MEASUREMENTS + integrated init: the clean loop edge
    carries ALL the accumulated drift (the realistic large-drift shape)."""
    K = 8
    gt = _ring_poses(K)
    rng = np.random.RandomState(seed)
    g = pose_graph.create(K, K + 4)
    est, meas = [gt[0]], []
    for i in range(K - 1):
        z = _rel(gt[i], gt[i + 1])
        n_ = np.concatenate(
            [rng.normal(0, 0.02 * noise_scale, 3),
             rng.normal(0, 0.01 * noise_scale, 3)]
        ).astype(np.float32)
        zn = z @ np.asarray(se3.exp(jnp.asarray(n_)))
        meas.append(zn)
        est.append(est[-1] @ zn)
    for T in est:
        g = pose_graph.add_pose(g, jnp.asarray(T))
    for i in range(K - 1):
        g = pose_graph.add_edge(g, i, i + 1, jnp.asarray(meas[i]))
    g = pose_graph.add_edge(g, K - 1, 0, jnp.asarray(_rel(gt[K - 1], gt[0])))
    return g, gt


def test_gnc_recovers_large_honest_drift():
    """The redescending GM kernel sheds an HONEST closure whose residual
    is far above delta; graduated non-convexity (wide kernel annealed to
    delta) keeps its pull.  At loop residual ~0.66 (odometry noise x15)
    plain GM leaves the drift essentially uncorrected while GNC recovers
    a further ~25%; the false-edge rejection is unaffected (pinned by
    test_robust_kernel_rejects_false_loop_edge, which runs with the same
    default GNC)."""
    ates = {}
    for gnc in (1.0, 8.0):
        g, gt = _big_drift_graph(15.0)
        cfg = KeyframeConfig(ba_iters=8, ba_gnc_init_scale=gnc)
        out, _ = pose_graph.optimize(g, cfg)
        a0 = metrics.ate_rmse([np.asarray(p) for p in g.poses[:8]], gt,
                              align=False)
        ates[gnc] = metrics.ate_rmse(
            [np.asarray(p) for p in out.poses[:8]], gt, align=False
        )
    assert ates[8.0] < 0.85 * ates[1.0], ates
