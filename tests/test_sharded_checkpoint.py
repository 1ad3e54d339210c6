"""Sharded checkpoint/resume.

Save a mid-sequence sharded run, restore onto a fresh mesh, continue: the
trajectory must be bit-identical to the uninterrupted run.  Also: the
single-chip canonical view of a sharded checkpoint renders/continues
(topology-free load)."""

import numpy as np
import jax.numpy as jnp

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
from voxelhashing_demo_tpu.utils import checkpoint, synthetic

CFG = PipelineConfig(
    camera=CameraConfig(width=160, height=120, fx=129.3, fy=129.1,
                        cx=79.65, cy=59.8),
    icp=ICPConfig(pyramid=(4, 2, 1), pyramid_iters=(8, 4, 2)),
    fusion=FusionConfig(voxel_size=0.02, truncation=0.08),
    hash=HashConfig(num_buckets=8192, bucket_size=4, num_blocks=8192,
                    max_active=4096, max_new_per_frame=4096),
    raycast=RaycastConfig(max_steps=96, cache_dims=(192, 192, 192)),
    gc=GCConfig(enabled=True, interval=4),
)


def test_sharded_checkpoint_bit_identical_resume(tmp_path):
    num_frames, cut = 10, 5
    depths, _ = synthetic.make_sequence(CFG.camera, num_frames,
                                        trans_amp=0.05, rot_amp_deg=2.5)
    mesh = sharded.make_mesh(8)

    full = sharded.ShardedHashSLAM(CFG, mesh)
    for d in depths:
        full.process(d)

    half = sharded.ShardedHashSLAM(CFG, mesh)
    for d in depths[:cut]:
        half.process(d)
    path = str(tmp_path / "sharded.npz")
    checkpoint.save_slam(path, half)

    resumed = checkpoint.load_sharded_slam(path)
    assert resumed.mesh.devices.size == 8
    assert len(resumed.trajectory) == cut
    for d in depths[cut:]:
        resumed.process(d)

    for a, b in zip(full.trajectory, resumed.trajectory):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(
        np.asarray(full.state.hmap.tsdf), np.asarray(resumed.state.hmap.tsdf)
    )
    np.testing.assert_array_equal(
        np.asarray(full.state.hmap.keys), np.asarray(resumed.state.hmap.keys)
    )


def test_sharded_checkpoint_single_chip_view(tmp_path):
    """load_slam on a sharded checkpoint gives a working single-chip twin:
    same occupied content, renders, and continues processing."""
    depths, _ = synthetic.make_sequence(CFG.camera, 6, trans_amp=0.05,
                                        rot_amp_deg=2.5)
    mesh = sharded.make_mesh(8)
    s = sharded.ShardedHashSLAM(CFG, mesh)
    for d in depths:
        s.process(d)
    path = str(tmp_path / "sharded2.npz")
    checkpoint.save_slam(path, s)

    single, _ = checkpoint.load_slam(path)
    assert isinstance(single, hash_slam.HashSLAM)
    # content-identical map: same key set, same per-block payload
    sk = np.asarray(s.state.hmap.keys)
    sp = np.asarray(s.state.hmap.ptrs)
    localT = sk.shape[0] // 8
    localB = np.asarray(s.state.hmap.tsdf).shape[0] // 8
    occ = np.nonzero(sp >= 0)[0]
    rows = (occ // localT) * localB + sp[occ]
    sh_payload = {
        int(k): np.asarray(s.state.hmap.tsdf)[r]
        for k, r in zip(sk[occ], rows)
    }
    uk = np.asarray(single.state.hmap.keys)
    up = np.asarray(single.state.hmap.ptrs)
    uocc = np.nonzero(up >= 0)[0]
    assert set(int(k) for k in uk[uocc]) == set(sh_payload)
    ut = np.asarray(single.state.hmap.tsdf)
    for slot in uocc:
        np.testing.assert_array_equal(
            ut[up[slot]], sh_payload[int(uk[slot])]
        )
    # it keeps working as a normal single-chip SLAM
    info = single.process(depths[-1])
    assert bool(jnp.all(jnp.isfinite(info.pose)))
    out = single.render()
    assert float(np.asarray(out.hit).mean()) > 0.3


def test_sharded_keyframe_checkpoint_roundtrip(tmp_path):
    """The keyframe backend checkpoints/resumes on a mesh too: inner
    sharded state restores bit-identically and the backend records
    (keyframes, refs, graph) survive."""
    import dataclasses

    from voxelhashing_demo_tpu.models import keyframe_slam

    mesh = sharded.make_mesh(8)
    cfg = dataclasses.replace(
        CFG,
        keyframes=dataclasses.replace(
            CFG.keyframes,
            min_rotation_deg=2.0,
            min_translation=0.03,
            icp_downsample=2,
            min_loop_inliers=150,
            max_loop_error=5e-4,
            min_loop_separation=2,
        ),
    )
    depths, gt = synthetic.make_sequence(cfg.camera, 8, trans_amp=0.10,
                                         rot_amp_deg=5.0)

    full = keyframe_slam.KeyframeSLAM(cfg, mesh=mesh)
    for d in depths:
        full.process(d)

    first = keyframe_slam.KeyframeSLAM(cfg, mesh=mesh)
    for d in depths[:5]:
        first.process(d)
    path = str(tmp_path / "kf_sharded.npz")
    checkpoint.save_keyframe_slam(path, first)

    back = checkpoint.load_keyframe_slam(path, mesh=mesh)
    assert back.mesh is mesh
    assert len(back.keyframes) == len(first.keyframes)
    np.testing.assert_array_equal(
        np.asarray(back.graph.poses), np.asarray(first.graph.poses)
    )
    for d in depths[5:]:
        back.process(d)

    t_full = full.trajectory()
    t_back = back.trajectory()
    assert len(t_back) == len(t_full)
    err = max(
        float(np.linalg.norm(np.asarray(a)[:3, 3] - np.asarray(b)[:3, 3]))
        for a, b in zip(t_full, t_back)
    )
    assert err < 1e-5, f"sharded keyframe resume diverged: {err}"


def test_sharded_keyframe_batched_sync(tmp_path):
    """The keyframe layer's batched host sync (sync_every > 1) composes
    with the sharded driver: same keyframe decisions as per-frame sync."""
    import dataclasses

    from voxelhashing_demo_tpu.models import keyframe_slam

    mesh = sharded.make_mesh(8)
    results = {}
    for b in (1, 4):
        cfg = dataclasses.replace(
            CFG,
            keyframes=dataclasses.replace(
                CFG.keyframes,
                min_rotation_deg=2.0, min_translation=0.03,
                icp_downsample=2, min_loop_inliers=150,
                max_loop_error=5e-4, min_loop_separation=2,
                loop_radius=0.0,    # BA-free: decisions must match exactly
                sync_every=b,
            ),
        )
        depths, gt = synthetic.make_sequence(cfg.camera, 8,
                                             trans_amp=0.10,
                                             rot_amp_deg=5.0)
        slam = keyframe_slam.KeyframeSLAM(cfg, mesh=mesh)
        for d in depths:
            slam.process(d)
        traj = slam.trajectory()
        results[b] = (len(slam.keyframes),
                      [r.frame_index for r in slam.keyframes],
                      slam._n_edges, traj)

    k1, f1, e1, t1 = results[1]
    k4, f4, e4, t4 = results[4]
    assert (k1, f1, e1) == (k4, f4, e4)
    err = max(
        float(np.linalg.norm(np.asarray(a)[:3, 3] - np.asarray(b_)[:3, 3]))
        for a, b_ in zip(t1, t4)
    )
    assert err < 1e-5, err


def test_per_process_shard_checkpoint_roundtrip(tmp_path):
    """save_slam(per_process=True) writes this process's shard file with
    no cross-process gather; load_sharded_slam auto-detects it and the
    resumed run is bit-identical to resuming the global checkpoint
    (single-process: local == global, so the pp code path is fully
    exercised; the 2-process twin lives in tests/mp_worker.py)."""
    depths, _ = synthetic.make_sequence(CFG.camera, 6, trans_amp=0.05,
                                        rot_amp_deg=2.5)
    mesh = sharded.make_mesh(8)
    slam = sharded.ShardedHashSLAM(CFG, mesh)
    for d in depths[:4]:
        slam.process(d)

    base = str(tmp_path / "pp.npz")
    checkpoint.save_slam(base, slam, per_process=True)
    import os

    pp = checkpoint.per_process_path(base)
    assert os.path.exists(pp) and not os.path.exists(base)
    checkpoint.save_slam(str(tmp_path / "global.npz"), slam)

    a = checkpoint.load_sharded_slam(base)      # auto-detects the shard
    b = checkpoint.load_sharded_slam(str(tmp_path / "global.npz"))
    for d in depths[4:]:
        a.process(d)
        b.process(d)
    np.testing.assert_array_equal(np.asarray(a.state.pose),
                                  np.asarray(b.state.pose))
    np.testing.assert_array_equal(np.asarray(a.state.hmap.keys),
                                  np.asarray(b.state.hmap.keys))
    np.testing.assert_array_equal(np.asarray(a.state.hmap.tsdf),
                                  np.asarray(b.state.hmap.tsdf))


def test_per_process_keyframe_checkpoint_roundtrip(tmp_path):
    """save_keyframe_slam(per_process=True) + load_keyframe_slam(mesh=)
    round-trips through the shard-file path: the backend records
    (keyframes, graph, refs) ride the replicated leaves of this
    process's shard."""
    import dataclasses
    import os

    from voxelhashing_demo_tpu.models import keyframe_slam

    mesh = sharded.make_mesh(8)
    cfg = dataclasses.replace(
        CFG,
        keyframes=dataclasses.replace(
            CFG.keyframes, min_rotation_deg=2.0, min_translation=0.03,
            icp_downsample=2,
        ),
    )
    depths, _ = synthetic.make_sequence(cfg.camera, 6, trans_amp=0.10,
                                        rot_amp_deg=5.0)
    slam = keyframe_slam.KeyframeSLAM(cfg, mesh=mesh)
    for d in depths:
        slam.process(d)

    base = str(tmp_path / "kf_pp.npz")
    checkpoint.save_keyframe_slam(base, slam, per_process=True)
    assert os.path.exists(checkpoint.per_process_path(base))
    assert not os.path.exists(base)

    back = checkpoint.load_keyframe_slam(base, mesh=mesh)
    assert len(back.keyframes) == len(slam.keyframes)
    np.testing.assert_array_equal(
        np.asarray(back.graph.poses), np.asarray(slam.graph.poses)
    )
    np.testing.assert_array_equal(
        np.asarray(back.state.hmap.keys), np.asarray(slam.state.hmap.keys)
    )
