"""Multi-chip sharded SLAM on a virtual 8-device CPU mesh: the sharded step
must reproduce the single-chip pipeline (same allocations, matching
trajectory) while actually partitioning the map."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from voxelhashing_demo_tpu.config import (
    CameraConfig,
    FusionConfig,
    GCConfig,
    HashConfig,
    ICPConfig,
    PipelineConfig,
    RaycastConfig,
)
from voxelhashing_demo_tpu.models import hash_slam
from voxelhashing_demo_tpu.parallel import sharded
from voxelhashing_demo_tpu.utils import metrics, synthetic

N_DEV = 8

CFG = PipelineConfig(
    camera=CameraConfig(width=80, height=64, fx=64.6, fy=64.6, cx=39.65,
                        cy=31.8),
    fusion=FusionConfig(voxel_size=0.04, truncation=0.16),
    hash=HashConfig(num_buckets=2048, bucket_size=4, num_blocks=2048,
                    max_active=1024, max_new_per_frame=1024),
    raycast=RaycastConfig(max_steps=96, cache_dims=(128, 128, 128)),
    gc=GCConfig(enabled=True, interval=4),
)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= N_DEV, "conftest must provide 8 CPU devices"
    return sharded.make_mesh(N_DEV)


def test_mesh_has_8_devices(mesh):
    assert mesh.devices.size == N_DEV


def test_sharded_state_is_partitioned(mesh):
    state = sharded.create_sharded(CFG, mesh)
    # the map arrays must actually be sharded over the mesh
    shard_devs = {s.device for s in state.hmap.tsdf.addressable_shards}
    assert len(shard_devs) == N_DEV
    assert state.hmap.keys.shape == (CFG.hash.table_size,)
    assert state.hmap.free_top.shape == (N_DEV,)
    # pose replicated
    np.testing.assert_allclose(state.pose, np.eye(4))


# the flagship's tracker: a 3-level pyramid whose finest level MEAN-pools
# the source 2x (ops/icp.icp_align_pyramid); the sharded twin must pool
# the same way or it tracks a different solution from the first frame
PYRAMID_CFG = dataclasses.replace(
    CFG, icp=ICPConfig(pyramid=(4, 2, 1), pyramid_iters=(8, 4, 2),
                       source_pools=(1, 1, 2), huber_delta=0.01),
)


@pytest.mark.parametrize("cfg", [CFG, PYRAMID_CFG],
                         ids=["single_level", "pyramid_pooled"])
def test_sharded_matches_single_chip(mesh, cfg):
    num_frames = 6
    depths, gt = synthetic.make_sequence(cfg.camera, num_frames,
                                         trans_amp=0.04, rot_amp_deg=2.0)

    single = hash_slam.HashSLAM(cfg)
    multi = sharded.ShardedHashSLAM(cfg, mesh)
    for d in depths:
        single.process(d)
        multi.process(d)

    # identical allocation decisions (deterministic routing)
    for i in range(num_frames):
        assert int(single.infos[i].blocks_allocated) == int(
            multi.infos[i].blocks_allocated
        ), f"frame {i} alloc mismatch"
        assert int(single.infos[i].blocks_active) == int(
            multi.infos[i].blocks_active
        ), f"frame {i} active mismatch"

    # trajectories agree to numerical tolerance (psum reduction order)
    for i in range(num_frames):
        np.testing.assert_allclose(
            np.asarray(multi.infos[i].pose),
            np.asarray(single.infos[i].pose),
            atol=5e-4,
        )

    # and both track the ground truth
    ate_multi = metrics.ate_rmse(multi.trajectory, gt, align=False)
    assert ate_multi < 0.02, f"sharded ATE {ate_multi}"


def test_sharded_map_partition_is_disjoint_and_complete(mesh):
    depths, _ = synthetic.make_sequence(CFG.camera, 2, trans_amp=0.02,
                                        rot_amp_deg=1.0)
    single = hash_slam.HashSLAM(CFG)
    multi = sharded.ShardedHashSLAM(CFG, mesh)
    for d in depths:
        single.process(d)
        multi.process(d)

    from voxelhashing_demo_tpu.geometry import coords

    # single-chip allocated block set
    keys_s = np.asarray(single.state.hmap.keys)
    occ_s = set(keys_s[keys_s != int(coords.EMPTY_KEY)].tolist())

    # sharded allocated block set (global array gathers all shards)
    keys_m = np.asarray(multi.state.hmap.keys)
    occ_m = keys_m[keys_m != int(coords.EMPTY_KEY)]
    assert len(occ_m) == len(set(occ_m.tolist())), "block stored twice"
    assert set(occ_m.tolist()) == occ_s, "sharded block set != single chip"

    # each key lives on its owner's shard
    lcfg = sharded.local_hash_config(CFG.hash, N_DEV)
    per_dev = keys_m.reshape(N_DEV, -1)
    for dev in range(N_DEV):
        k = per_dev[dev]
        k = k[k != int(coords.EMPTY_KEY)]
        blocks = np.asarray(coords.unpack_block_key(jnp.asarray(k)))
        owners = np.asarray(
            coords.spatial_hash(jnp.asarray(blocks), CFG.hash.num_buckets)
        ) % N_DEV
        assert (owners == dev).all(), f"foreign block on device {dev}"


def test_sharded_ba_matches_single_device(mesh):
    """Edge-sharded psum-ed BA must reproduce the single-device optimize."""
    from voxelhashing_demo_tpu.config import KeyframeConfig
    from voxelhashing_demo_tpu.geometry import se3
    from voxelhashing_demo_tpu.ops import pose_graph

    rng = np.random.RandomState(1)
    K = 6
    gt = []
    for i in range(K):
        a = 2 * np.pi * i / K
        xi = np.array([np.cos(a), 0, np.sin(a), 0, a, 0], dtype=np.float32)
        gt.append(np.asarray(se3.exp(jnp.asarray(xi))))

    graph = pose_graph.create(K, 10)  # 10 edges: not a multiple of 8
    est = [gt[0]]
    for i in range(K - 1):
        z = np.asarray(se3.inverse(jnp.asarray(gt[i])) @ jnp.asarray(gt[i + 1]))
        noise = np.concatenate(
            [rng.normal(0, 0.02, 3), rng.normal(0, 0.01, 3)]
        ).astype(np.float32)
        est.append(est[-1] @ (z @ np.asarray(se3.exp(jnp.asarray(noise)))))
    for T in est:
        graph = pose_graph.add_pose(graph, jnp.asarray(T))
    for i in range(K - 1):
        z = np.asarray(se3.inverse(jnp.asarray(gt[i])) @ jnp.asarray(gt[i + 1]))
        graph = pose_graph.add_edge(graph, i, i + 1, jnp.asarray(z))
    graph = pose_graph.add_edge(
        graph, K - 1, 0,
        jnp.asarray(np.asarray(se3.inverse(jnp.asarray(gt[K - 1]))
                               @ jnp.asarray(gt[0]))),
    )

    cfg = KeyframeConfig(ba_iters=6)
    g_single, info_s = pose_graph.optimize(graph, cfg)
    g_shard, info_m = sharded.optimize_graph_sharded(graph, cfg, mesh)

    np.testing.assert_allclose(
        np.asarray(g_shard.poses), np.asarray(g_single.poses), atol=1e-4
    )
    np.testing.assert_allclose(
        float(info_m.chi2_final), float(info_s.chi2_final), atol=1e-6
    )
    assert float(info_m.chi2_final) < 0.01 * float(info_m.chi2_initial)

    # the sharded path is dense-only by design: an explicit CG request
    # is rejected rather than silently downgraded
    import dataclasses
    import pytest

    with pytest.raises(ValueError, match="single-device"):
        sharded.optimize_graph_sharded(
            graph, dataclasses.replace(cfg, ba_solver="cg"), mesh
        )


def test_sharded_keyframe_slam(mesh):
    """Keyframe SLAM over the sharded frontend + distributed BA."""
    import dataclasses

    from voxelhashing_demo_tpu.models import keyframe_slam

    cfg = dataclasses.replace(
        CFG,
        keyframes=dataclasses.replace(
            CFG.keyframes,
            min_rotation_deg=2.0,
            min_translation=0.03,
            icp_downsample=2,
            min_loop_inliers=100,
            max_loop_error=5e-4,
            min_loop_separation=2,
        ),
    )
    depths, gt = synthetic.make_sequence(cfg.camera, 8, trans_amp=0.08,
                                         rot_amp_deg=4.0)
    slam = keyframe_slam.KeyframeSLAM(cfg, mesh=mesh)
    for d in depths:
        slam.process(d)
    traj = slam.trajectory()
    assert len(traj) == 8
    assert len(slam.keyframes) >= 2
    assert all(np.all(np.isfinite(T)) for T in traj)
    ate = metrics.ate_rmse(traj, gt)
    assert ate < 0.06, f"sharded keyframe ATE {ate}"


def test_sharded_chunked_fusion_and_splat(mesh):
    """Exercise the dynamic-trip-count chunked integrate/splat under
    shard_map (device-varying trip counts)."""
    import dataclasses

    cfg = dataclasses.replace(
        CFG,
        hash=dataclasses.replace(CFG.hash, integrate_chunk=32),
        icp=dataclasses.replace(CFG.icp, pyramid=(2, 1),
                                pyramid_iters=(6, 4)),
    )
    depths, gt = synthetic.make_sequence(cfg.camera, 5, trans_amp=0.04,
                                         rot_amp_deg=2.0)
    slam = sharded.ShardedHashSLAM(cfg, mesh)
    for d in depths:
        info = slam.process(d)
    assert bool(info.tracked)
    assert int(info.blocks_active) > 50
    ate = metrics.ate_rmse(slam.trajectory, gt, align=False)
    assert ate < 0.02, f"ATE {ate}"


def test_sharded_incremental_reintegration(mesh):
    """A BA correction on the SHARDED backend takes the incremental path
    (owner-local make_sharded_reintegrate) and the moved map matches a
    from-scratch sharded rebuild at the corrected poses."""
    import dataclasses

    from voxelhashing_demo_tpu.geometry import se3
    from voxelhashing_demo_tpu.models import keyframe_slam

    cfg = dataclasses.replace(
        CFG,
        keyframes=dataclasses.replace(
            CFG.keyframes, min_rotation_deg=2.0, min_translation=0.03,
            rebuild_incremental=True,
        ),
    )
    depths, _ = synthetic.make_sequence(cfg.camera, 8, trans_amp=0.08,
                                        rot_amp_deg=4.0)
    slam = keyframe_slam.KeyframeSLAM(cfg, mesh=mesh)
    for d in depths:
        slam.process(d)
    slam.flush()
    assert len(slam.keyframes) >= 2
    slam._rebuild_map()                 # seed the contribution ledger
    assert slam._map_ledgered

    D = np.asarray(se3.exp(jnp.asarray(np.array(
        [0.03, -0.02, 0.02, 0.0, np.deg2rad(1.5), 0.0], np.float32
    ))))
    slam._poses_np[: slam._n_poses] = D @ slam._poses_np[: slam._n_poses]
    slam.graph = slam.graph._replace(
        poses=jnp.einsum("ij,kjl->kil", jnp.asarray(D), slam.graph.poses)
    )
    slam.state = slam.state._replace(pose=jnp.asarray(D) @ slam.state.pose)
    n, n_sat = slam._incremental_reintegrate()
    assert n > 0
    assert n_sat == 0

    # reference: fresh sharded map, every ledger contribution fused at
    # its corrected pose
    fuse = sharded.make_sharded_fuse_only(cfg, mesh)
    poses = slam._poses_np
    ref = sharded.create_sharded(cfg, mesh).hmap
    for rec in slam.keyframes:
        if rec.map_pose is None:
            continue
        ref = fuse(ref, rec.depth_dev, jnp.asarray(poses[rec.index]),
                   jnp.int32(rec.frame_index))
    for ent in slam._ring:
        target = (poses[ent.kf] @ ent.rel).astype(np.float32)
        ref = fuse(ref, ent.depth, jnp.asarray(target),
                   jnp.int32(ent.frame_index))

    render = sharded.make_sharded_render_model(cfg, mesh)
    a = render(slam.state.hmap, slam.state.pose)
    b = render(ref, slam.state.pose)
    da, db = np.asarray(a.depth), np.asarray(b.depth)
    both = (da > 0) & (db > 0)
    assert both.mean() > 0.4
    med = np.median(np.abs(da - db)[both])
    assert med < 1.0 * cfg.fusion.voxel_size, med


def test_sharded_live_render_matches_single_chip(mesh, tmp_path):
    """Live render() over the sharded map equals the single-chip render
    of the SAME map content (canonical conversion via checkpoint):
    per-device splat + pmin merge is a distributed z-buffer, and min is
    order-independent, so the merged image must match bit-for-bit up to
    float tolerance (reference: SDFRenderer.cpp:210 — the render pass
    the reference never finished, live multi-chip here)."""
    from voxelhashing_demo_tpu.utils import checkpoint

    depths, _ = synthetic.make_sequence(CFG.camera, 5, trans_amp=0.04,
                                        rot_amp_deg=2.0)
    slam = sharded.ShardedHashSLAM(CFG, mesh)
    for d in depths:
        slam.process(d)

    out_s = slam.render()  # current pose
    # same map, canonical single-chip layout
    path = str(tmp_path / "m.npz")
    checkpoint.save_slam(path, slam)
    single, _ = checkpoint.load_slam(path)
    out_1 = single.render(np.asarray(slam.state.pose))

    hit_s = np.asarray(out_s.hit)
    hit_1 = np.asarray(out_1.hit)
    assert hit_s.shape == hit_1.shape == (CFG.camera.height,
                                          CFG.camera.width)
    assert hit_s.mean() > 0.5, "render must hit the synthetic scene"
    np.testing.assert_array_equal(hit_s, hit_1)
    np.testing.assert_allclose(np.asarray(out_s.depth),
                               np.asarray(out_1.depth), atol=1e-5)
    np.testing.assert_allclose(np.asarray(out_s.normals),
                               np.asarray(out_1.normals), atol=1e-4)

    # arbitrary-viewpoint render through the keyframe backend facade
    from voxelhashing_demo_tpu.models import keyframe_slam

    k = keyframe_slam.KeyframeSLAM(CFG, mesh=mesh)
    for d in depths[:2]:
        k.process(d)
    out_k = k.render(np.eye(4, dtype=np.float32))
    assert np.asarray(out_k.hit).mean() > 0.3
