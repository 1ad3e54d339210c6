"""Pose graph BA tests: analytic ring graph + keyframe SLAM end-to-end.

No reference counterpart exists (the reference has no backend at all,
SURVEY.md §5) — these tests validate the north-star component against
synthetic ground truth.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np

from voxelhashing_demo_tpu.config import KeyframeConfig, tiny_config
from voxelhashing_demo_tpu.geometry import se3
from voxelhashing_demo_tpu.ops import pose_graph
from voxelhashing_demo_tpu.utils import metrics


def _ring_poses(K: int, radius: float = 1.0):
    """Ground-truth poses on a circle, camera yawing around +y."""
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


def test_optimize_corrects_odometry_drift():
    K = 8
    gt = _ring_poses(K)
    rng = np.random.RandomState(0)

    graph = pose_graph.create(max_keyframes=K, max_edges=K + 2)
    # initial estimates: integrate noisy odometry (drift accumulates)
    est = [gt[0]]
    for i in range(K - 1):
        z = _rel(gt[i], gt[i + 1])
        noise = np.concatenate(
            [rng.normal(0, 0.02, 3), rng.normal(0, 0.01, 3)]
        ).astype(np.float32)
        z_noisy = z @ np.asarray(se3.exp(jnp.asarray(noise)))
        est.append(est[-1] @ z_noisy)

    for T in est:
        graph = pose_graph.add_pose(graph, jnp.asarray(T))
    for i in range(K - 1):
        z = _rel(gt[i], gt[i + 1])  # noise-free measurements
        graph = pose_graph.add_edge(graph, i, i + 1, jnp.asarray(z))
    # loop closure: last keyframe back to the anchor
    graph = pose_graph.add_edge(
        graph, K - 1, 0, jnp.asarray(_rel(gt[K - 1], gt[0]))
    )

    cfg = KeyframeConfig(ba_iters=10)
    ate_before = metrics.ate_rmse(
        [np.asarray(p) for p in graph.poses[:K]], gt, align=False
    )
    graph_opt, info = pose_graph.optimize(graph, cfg)
    ate_after = metrics.ate_rmse(
        [np.asarray(p) for p in graph_opt.poses[:K]], gt, align=False
    )

    assert float(info.chi2_final) < 1e-8
    assert float(info.chi2_final) < float(info.chi2_initial)
    assert ate_after < 0.1 * ate_before
    assert ate_after < 1e-3
    # anchor stays put
    np.testing.assert_allclose(
        np.asarray(graph_opt.poses[0]), gt[0], atol=1e-4
    )


def test_residuals_zero_at_ground_truth():
    K = 6
    gt = _ring_poses(K)
    graph = pose_graph.create(K, K)
    for T in gt:
        graph = pose_graph.add_pose(graph, jnp.asarray(T))
    for i in range(K - 1):
        graph = pose_graph.add_edge(
            graph, i, i + 1, jnp.asarray(_rel(gt[i], gt[i + 1]))
        )
    r = pose_graph.edge_residuals(
        graph.poses, graph.edges_ij, graph.edges_T
    )
    w_r = r * graph.edges_w[:, None]
    np.testing.assert_allclose(np.asarray(w_r), 0.0, atol=1e-5)


def test_empty_and_padded_graph_is_noop():
    graph = pose_graph.create(4, 4)
    graph = pose_graph.add_pose(graph, jnp.eye(4))
    cfg = KeyframeConfig(ba_iters=3)
    out, info = pose_graph.optimize(graph, cfg)
    assert np.all(np.isfinite(np.asarray(out.poses)))
    assert float(info.chi2_final) == 0.0
    np.testing.assert_allclose(np.asarray(out.poses[0]), np.eye(4), atol=1e-5)


def test_capacity_limits_are_safe():
    graph = pose_graph.create(2, 1)
    for _ in range(4):
        graph = pose_graph.add_pose(graph, jnp.eye(4))
        graph = pose_graph.add_edge(graph, 0, 1, jnp.eye(4))
    assert int(graph.num_poses) == 2
    assert int(graph.num_edges) == 1


def _dense_normal_equations(graph, robust_delta=None, kernel="gm"):
    """Reference implementation: differentiate the FULL residual stack
    against all K*6 twists at once ((E, 6, K, 6) Jacobian) — the pre-r4
    O(E*K) build the block-sparse path must reproduce."""
    import jax

    K = graph.poses.shape[0]
    ew = (pose_graph.robust_edge_weights(graph, robust_delta, kernel)
          if robust_delta is not None else graph.edges_w)

    def residual_of_twists(xis):
        P = jax.vmap(lambda T, xi: T @ se3.exp(xi))(graph.poses, xis)
        return pose_graph.edge_residuals(
            P, graph.edges_ij, graph.edges_T
        )

    zeros = jnp.zeros((K, 6), dtype=jnp.float32)
    r = residual_of_twists(zeros)
    J = jax.jacfwd(residual_of_twists)(zeros)
    E = r.shape[0]
    Jf = J.reshape(E * 6, K * 6)
    w = jnp.repeat(ew, 6)
    Hn = (Jf * w[:, None]).T @ Jf
    bn = (Jf * w[:, None]).T @ r.reshape(-1)
    chi2 = jnp.sum(w * r.reshape(-1) ** 2)
    return Hn, bn, chi2


def _random_graph(K, E, cap_K=None, cap_E=None, seed=3):
    """Noisy random graph: poses perturbed off a ring, random edges with
    measurements taken at the ground truth (nonzero residuals)."""
    rng = np.random.RandomState(seed)
    gt = _ring_poses(K)
    graph = pose_graph.create(cap_K or K, cap_E or E)
    for T in gt:
        noise = np.concatenate(
            [rng.normal(0, 0.05, 3), rng.normal(0, 0.03, 3)]
        ).astype(np.float32)
        graph = pose_graph.add_pose(
            graph, jnp.asarray(T @ np.asarray(se3.exp(jnp.asarray(noise))))
        )
    for _ in range(E):
        i, j = rng.choice(K, size=2, replace=False)
        graph = pose_graph.add_edge(
            graph, int(i), int(j), jnp.asarray(_rel(gt[i], gt[j])),
            float(rng.uniform(0.5, 2.0)),
        )
    return graph


def test_block_sparse_build_matches_dense_jacfwd():
    """The O(E) block-sparse normal-equation build must reproduce the
    dense O(E*K) jacfwd build (same H, b, chi2) — including with padded
    capacity and IRLS robust weights."""
    graph = _random_graph(K=7, E=12, cap_K=12, cap_E=20)
    for delta in (None, 0.1):
        Hs, bs, c2s = pose_graph.build_normal_equations(graph, delta)
        Hd, bd, c2d = _dense_normal_equations(graph, delta)
        np.testing.assert_allclose(np.asarray(Hs), np.asarray(Hd),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(bs), np.asarray(bd),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(float(c2s), float(c2d), rtol=1e-5)


def test_cg_step_matches_dense_solve():
    """One GN step via matrix-free block-Jacobi CG must reproduce the
    dense Cholesky step (same damped, anchored system) — including with
    IRLS robust weights: the scale-proof solver must hit equal
    convergence, not just 'converge'."""
    import jax

    graph = _random_graph(K=9, E=16, cap_K=16, cap_E=24)
    for delta in (None, 0.1):
        cfg = KeyframeConfig(ba_cg_iters=200, ba_cg_tol=1e-7)
        H, b, _ = pose_graph.build_normal_equations(graph, delta)
        K = graph.poses.shape[0]
        anchor = jnp.zeros((K * 6,)).at[:6].set(1e6)
        A = H + jnp.diag(anchor) + cfg.ba_damping * jnp.eye(K * 6)
        dense = np.asarray(
            jax.scipy.linalg.solve(A, -b, assume_a="pos")
        ).reshape(K, 6)
        cg = np.asarray(pose_graph.solve_delta_cg(graph, delta, cfg))
        np.testing.assert_allclose(cg, dense, rtol=1e-3, atol=1e-5)


def test_cg_optimize_equal_convergence():
    """Full optimize() with ba_solver='cg' reaches the dense solver's
    basin on the drifted-ring problem: same chi2 class, same ATE class,
    pads untouched, anchor fixed."""
    K, cap = 24, 48
    gt = _ring_poses(K)
    rng = np.random.RandomState(5)
    est = [gt[0]]
    for i in range(K - 1):
        z = _rel(gt[i], gt[i + 1])
        noise = np.concatenate(
            [rng.normal(0, 0.02, 3), rng.normal(0, 0.01, 3)]
        ).astype(np.float32)
        est.append(est[-1] @ (z @ np.asarray(se3.exp(jnp.asarray(noise)))))
    graph = pose_graph.create(cap, 2 * cap)
    for T in est:
        graph = pose_graph.add_pose(graph, jnp.asarray(T))
    for i in range(K - 1):
        graph = pose_graph.add_edge(
            graph, i, i + 1, jnp.asarray(_rel(gt[i], gt[i + 1]))
        )
    graph = pose_graph.add_edge(
        graph, K - 1, 0, jnp.asarray(_rel(gt[K - 1], gt[0]))
    )

    outs = {}
    for solver in ("dense", "cg"):
        cfg = KeyframeConfig(ba_iters=10, ba_solver=solver)
        out, info = pose_graph.optimize(graph, cfg)
        outs[solver] = (out, float(info.chi2_final))
    assert outs["cg"][1] < 1e-7
    assert outs["cg"][1] < 10 * max(outs["dense"][1], 1e-10) + 1e-9
    np.testing.assert_allclose(
        np.asarray(outs["cg"][0].poses[:K]),
        np.asarray(outs["dense"][0].poses[:K]),
        atol=5e-4,
    )
    np.testing.assert_allclose(
        np.asarray(outs["cg"][0].poses[cap - 8:]),
        np.broadcast_to(np.eye(4, dtype=np.float32), (8, 4, 4)),
        atol=1e-5,
    )


def test_auto_solver_switches_at_capacity():
    """'auto' must trace the dense solve below ba_dense_max_k and the
    matrix-free CG solve above it (a static, capacity-keyed choice)."""
    import jax

    small = pose_graph.create(8, 8)
    big = pose_graph.create(16, 8)
    cfg = KeyframeConfig(ba_iters=1, ba_dense_max_k=8)
    txt_small = str(
        jax.make_jaxpr(lambda g: pose_graph.optimize(g, cfg))(small)
    )
    txt_big = str(
        jax.make_jaxpr(lambda g: pose_graph.optimize(g, cfg))(big)
    )
    # the dense path factors a (6K, 6K) Cholesky; CG never builds one
    assert "cholesky" in txt_small
    assert "48,48" in txt_small.replace(" ", "")
    assert "96,96" not in txt_big.replace(" ", "")


def test_optimize_at_k256_capacity():
    """BA at large padded capacity (an O(E*K) build would force callers
    to right-size capacity; the block-sparse build must make K=256
    routine).  64 real poses in a 256-capacity
    graph: drift corrected, pads untouched."""
    K, cap = 64, 256
    gt = _ring_poses(K)
    rng = np.random.RandomState(1)
    graph = pose_graph.create(cap, 2 * cap)
    est = [gt[0]]
    for i in range(K - 1):
        z = _rel(gt[i], gt[i + 1])
        noise = np.concatenate(
            [rng.normal(0, 0.01, 3), rng.normal(0, 0.005, 3)]
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
    ate_before = metrics.ate_rmse(
        [np.asarray(p) for p in graph.poses[:K]], gt, align=False
    )
    out, info = pose_graph.optimize(graph, KeyframeConfig(ba_iters=10))
    ate_after = metrics.ate_rmse(
        [np.asarray(p) for p in out.poses[:K]], gt, align=False
    )
    assert ate_after < 0.1 * ate_before
    assert ate_after < 2e-3
    # padded rows stay identity
    np.testing.assert_allclose(
        np.asarray(out.poses[K:]),
        np.broadcast_to(np.eye(4, dtype=np.float32), (cap - K, 4, 4)),
        atol=1e-5,
    )


def test_cg_at_k512_capacity():
    """Scale smoke at a capacity the dense solver never ran: 128 real
    poses in a 512-capacity graph (auto picks CG above ba_dense_max_k).
    The drifted two-ring chain with crossing closures must converge to
    the same chi2 class as small graphs, pads untouched."""
    K, cap = 128, 512
    gt = _ring_poses(K)
    rng = np.random.RandomState(7)
    est = [gt[0]]
    for i in range(K - 1):
        z = _rel(gt[i], gt[i + 1])
        noise = np.concatenate(
            [rng.normal(0, 0.01, 3), rng.normal(0, 0.005, 3)]
        ).astype(np.float32)
        est.append(est[-1] @ (z @ np.asarray(se3.exp(jnp.asarray(noise)))))
    graph = pose_graph.create(cap, 2 * cap)
    for T in est:
        graph = pose_graph.add_pose(graph, jnp.asarray(T))
    for i in range(K - 1):
        graph = pose_graph.add_edge(
            graph, i, i + 1, jnp.asarray(_rel(gt[i], gt[i + 1]))
        )
    # loop closures: ring closure + cross-ring chords every 16 poses
    graph = pose_graph.add_edge(
        graph, K - 1, 0, jnp.asarray(_rel(gt[K - 1], gt[0]))
    )
    for i in range(0, K - K // 2, 16):
        j = i + K // 2
        graph = pose_graph.add_edge(
            graph, i, j, jnp.asarray(_rel(gt[i], gt[j]))
        )

    cfg = KeyframeConfig(ba_iters=10)
    assert cap > cfg.ba_dense_max_k   # auto must route to CG here
    ate_before = metrics.ate_rmse(
        [np.asarray(p) for p in graph.poses[:K]], gt, align=False
    )
    out, info = pose_graph.optimize(graph, cfg)
    ate_after = metrics.ate_rmse(
        [np.asarray(p) for p in out.poses[:K]], gt, align=False
    )
    assert float(info.chi2_final) < 1e-6
    assert ate_after < 0.1 * ate_before
    assert ate_after < 5e-3
    np.testing.assert_allclose(
        np.asarray(out.poses[cap - 16:]),
        np.broadcast_to(np.eye(4, dtype=np.float32), (16, 4, 4)),
        atol=1e-5,
    )


def test_keyframe_slam_end_to_end():
    from voxelhashing_demo_tpu.models import keyframe_slam
    from voxelhashing_demo_tpu.utils import synthetic

    base = tiny_config()
    config = dataclasses.replace(
        base,
        keyframes=dataclasses.replace(
            base.keyframes,
            min_rotation_deg=2.0,
            min_translation=0.03,
            icp_downsample=2,
            min_loop_inliers=150,
            max_loop_error=5e-4,
            loop_radius=1.0,
            min_loop_separation=2,
            ba_iters=5,
        ),
    )
    cam = config.camera
    n = 10
    depths, gt = synthetic.make_sequence(
        cam, n, trans_amp=0.10, rot_amp_deg=5.0
    )

    slam = keyframe_slam.KeyframeSLAM(config)
    for d in depths:
        slam.process(d)

    traj = slam.trajectory()
    assert len(traj) == n
    assert len(slam.keyframes) >= 2
    assert int(slam.graph.num_edges) >= len(slam.keyframes) - 1
    for T in traj:
        assert np.all(np.isfinite(T))
    ate = metrics.ate_rmse(traj, gt)
    assert ate < 0.05, f"keyframe SLAM ATE too high: {ate}"
