"""Out-of-frustum block streaming: evict to host, restore on revisit.

The reference's fixed-size GPU hash caps the scene at num_blocks (its
deleteVoxelEntry is dead code AND discards data, reference:
VoxelUtils.cu:544-604).  Streaming (ops/hash_ops.evict_stale /
restore_blocks + utils/blockstore.BlockStore) bounds the device map by the
working set only: total observed geometry here exceeds 2x num_blocks and
the run survives where the non-streaming twin collapses."""

import jax
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
    StreamConfig,
)
from voxelhashing_demo_tpu.geometry import coords
from voxelhashing_demo_tpu.models import hash_slam
from voxelhashing_demo_tpu.ops import hash_ops
from voxelhashing_demo_tpu.utils import metrics, synthetic

CAM = CameraConfig(width=160, height=120, fx=129.3, fy=129.1,
                   cx=79.65, cy=59.8)


def test_evict_restore_bit_exact(tiny_cfg):
    """Evicted payload restores bit-exactly (the device map after
    evict+restore equals the map before, row permutation aside)."""
    cfg = tiny_cfg.hash
    hmap = hash_ops.create(cfg)
    blocks = jnp.array([[i % 7, i // 7, 0] for i in range(30)], jnp.int32)
    keys = coords.pack_block_key(blocks, cfg.key_bits)
    hmap, n = hash_ops.insert_blocks(hmap, cfg, keys, frame_idx=0)
    assert int(n) == 30

    ptrs, found = hash_ops.lookup_keys(hmap, cfg, keys)
    assert bool(jnp.all(found))
    rng = np.random.default_rng(1)
    tvals = jnp.asarray(rng.uniform(-1, 1, (30, cfg.voxels_per_block))
                        .astype(np.float32))
    wvals = jnp.asarray(rng.uniform(0, 9, (30, cfg.voxels_per_block))
                        .astype(np.float32))
    hmap = hmap._replace(
        tsdf=hmap.tsdf.at[ptrs].set(tvals),
        weight=hmap.weight.at[ptrs].set(wvals),
    )
    free0 = int(hmap.free_top)

    hmap, ekeys, etsdf, eweight, eborn, ne = hash_ops.evict_stale(
        hmap, cfg, 40, 30, 64
    )
    assert int(ne) == 30
    assert int(hmap.free_top) == free0 + 30
    _, found = hash_ops.lookup_keys(hmap, cfg, keys)
    assert not bool(jnp.any(found))

    hmap, acc = hash_ops.restore_blocks(hmap, cfg, ekeys, etsdf, eweight, 41)
    live = np.asarray(ekeys) != int(hash_ops.EMPTY_KEY)
    assert np.asarray(acc)[live].all()
    ptrs, found = hash_ops.lookup_keys(hmap, cfg, keys)
    assert bool(jnp.all(found))
    np.testing.assert_array_equal(np.asarray(hmap.tsdf[ptrs]),
                                  np.asarray(tvals))
    np.testing.assert_array_equal(np.asarray(hmap.weight[ptrs]),
                                  np.asarray(wvals))
    assert int(hmap.free_top) == free0


def test_restore_merges_reallocated_block(tiny_cfg):
    """A key re-allocated fresh after eviction weight-merges with the
    stored payload instead of losing either copy."""
    cfg = tiny_cfg.hash
    hmap = hash_ops.create(cfg)
    key = coords.pack_block_key(jnp.array([[1, 2, 3]], jnp.int32),
                                cfg.key_bits)
    V = cfg.voxels_per_block
    stored_t = jnp.full((1, V), 0.5, jnp.float32)
    stored_w = jnp.full((1, V), 4.0, jnp.float32)
    # device copy: freshly re-observed
    hmap, _ = hash_ops.insert_blocks(hmap, cfg, key, frame_idx=10)
    ptr, _ = hash_ops.lookup_keys(hmap, cfg, key)
    hmap = hmap._replace(
        tsdf=hmap.tsdf.at[ptr].set(-0.25),
        weight=hmap.weight.at[ptr].set(1.0),
    )
    hmap, acc = hash_ops.restore_blocks(hmap, cfg, key, stored_t, stored_w,
                                        11)
    assert bool(acc[0])
    fused = (-0.25 * 1.0 + 0.5 * 4.0) / 5.0
    np.testing.assert_allclose(np.asarray(hmap.tsdf[ptr])[0], fused,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(hmap.weight[ptr])[0], 5.0)


def _stream_cfg(enabled: bool) -> PipelineConfig:
    return PipelineConfig(
        camera=CAM,
        icp=ICPConfig(pyramid=(4, 2, 1), pyramid_iters=(8, 4, 2)),
        fusion=FusionConfig(voxel_size=0.03, truncation=0.12),
        hash=HashConfig(num_buckets=2048, bucket_size=4, num_blocks=512,
                        max_active=1024, max_new_per_frame=1024),
        raycast=RaycastConfig(max_steps=96, cache_dims=(160, 160, 160)),
        gc=GCConfig(enabled=True, interval=4, min_age=12),
        stream=StreamConfig(enabled=enabled, interval=2, max_age=6,
                            max_evict=512, max_restore=512),
    )


def _out_and_back():
    """150-degree room pan and return: total geometry ~2x the 512-block
    device map; the way back revisits everything evicted on the way out."""
    fwd, gt_fwd = synthetic.make_room_sweep(CAM, 36, sweep_deg=150.0)
    return fwd + fwd[-2::-1], gt_fwd + gt_fwd[-2::-1]


def _run(slam, depths, gt):
    from voxelhashing_demo_tpu.parallel import distributed

    for d in depths:
        slam.process(d)
    if getattr(slam, "store", None) is not None:
        # quiesce the pipelined cycle so in-flight evicted payload lands
        # in the store before the accounting below
        slam.stream_sync()
    ate = metrics.ate_rmse(slam.trajectory, gt, align=False)
    # fetch, not np.asarray: the sharded map is not fully addressable
    # under multi-process (this helper is shared with tests/mp_worker.py)
    dev_keys = set(
        int(k) for k in distributed.fetch(slam.state.hmap.keys)
        if k != int(hash_ops.EMPTY_KEY)
    )
    return ate, dev_keys


def test_streaming_unlocks_beyond_capacity_scenes():
    """End-to-end: with streaming the 2x-capacity out-and-back tracks
    (ATE ~67 mm at quarter res); without it the heap exhausts mid-pan and
    tracking collapses (measured 1.6 m ATE)."""
    depths, gt = _out_and_back()

    slam = hash_slam.HashSLAM(_stream_cfg(True))
    ate_s, dev_keys = _run(slam, depths, gt)
    distinct = len(set(slam.store._index) | dev_keys)
    assert ate_s < 0.1, f"streaming ATE {ate_s}"
    assert distinct >= 2 * slam.config.hash.num_blocks, distinct
    assert slam.store.total_restored > 100
    assert slam.store.total_evicted > slam.config.hash.num_blocks

    plain = hash_slam.HashSLAM(_stream_cfg(False))
    ate_p, _ = _run(plain, depths, gt)
    assert int(plain.infos[-1].free_blocks) == 0  # heap exhausted
    assert ate_p > 3.0 * ate_s, (ate_p, ate_s)


def test_streaming_sharded_matches():
    """The sharded twin runs the same beyond-capacity workload through the
    same global BlockStore (per-device evict, owner-routed restore)."""
    from voxelhashing_demo_tpu.parallel import sharded

    depths, gt = _out_and_back()
    mesh = sharded.make_mesh(8)
    slam = sharded.ShardedHashSLAM(_stream_cfg(True), mesh)
    ate, dev_keys = _run(slam, depths, gt)
    distinct = len(set(slam.store._index) | dev_keys)
    assert ate < 0.1, f"sharded streaming ATE {ate}"
    assert distinct >= 2 * slam.config.hash.num_blocks
    assert slam.store.total_restored > 100


def test_streaming_composes_with_keyframe_backend():
    """BASELINE config-5 regime (multi-room + backend): the keyframe layer
    wraps the streaming HashSLAM driver, so the beyond-capacity workload
    runs with keyframing/loop-closure active on top of evict/restore."""
    import dataclasses

    from voxelhashing_demo_tpu.models import keyframe_slam

    depths, gt = _out_and_back()
    base = _stream_cfg(True)
    cfg = dataclasses.replace(
        base,
        keyframes=dataclasses.replace(
            base.keyframes, min_rotation_deg=8.0, min_translation=0.10,
            # deliberately undersized: the multi-room sweep must GROW the
            # graph past this instead of silently degrading to odometry
            #
            max_keyframes=4, max_edges=8,
        ),
    )
    slam = keyframe_slam.KeyframeSLAM(cfg)
    for d in depths:
        slam.process(d)
    ate = metrics.ate_rmse(slam.trajectory(), gt, align=False)
    assert ate < 0.1, f"keyframe+streaming ATE {ate}"
    assert len(slam.keyframes) > 4, "graph must grow past max_keyframes"
    assert not slam.saturated
    assert any(e["kind"] == "grow_keyframes" for e in slam.capacity_events)
    # the return leg re-registers against outbound keyframes: loop edges
    # exist on the GROWN graph (odometry edges = K-1, extras are loops)
    assert slam._n_edges > len(slam.keyframes) - 1, (
        slam._n_edges, len(slam.keyframes),
    )
    store = slam._driver.store
    assert store is not None and store.total_evicted > 0
    # a BA map rebuild swaps in a FRESH store (the keyframe depths are
    # the durable record), resetting its counters — restores must have
    # happened OR a rebuild explains their absence
    assert (store.total_restored > 0
            or any(e["map_rebuilt"] for e in slam.ba_events))


def test_streaming_checkpoint_roundtrip(tmp_path):
    """Checkpoint mid-sequence with a live BlockStore; resume continues
    with the same store contents and the same trajectory."""
    from voxelhashing_demo_tpu.utils import checkpoint

    depths, gt = _out_and_back()
    cut = 40
    a = hash_slam.HashSLAM(_stream_cfg(True))
    for d in depths[:cut]:
        a.process(d)
    path = str(tmp_path / "stream.npz")
    checkpoint.save_slam(path, a)

    b, _ = checkpoint.load_slam(path)
    assert b.store is not None
    assert len(b.store) == len(a.store)
    for d in depths[cut:]:
        a.process(d)
        b.process(d)
    for pa, pb in zip(a.trajectory[cut:], b.trajectory[cut:]):
        np.testing.assert_allclose(np.asarray(pa), np.asarray(pb),
                                   atol=1e-5)


def test_bucket_helper():
    from voxelhashing_demo_tpu.models.hash_slam import _bucket

    assert _bucket(1, 2048) == 1
    assert _bucket(2, 2048) == 2
    assert _bucket(3, 2048) == 4
    assert _bucket(100, 2048) == 128
    assert _bucket(2048, 2048) == 2048
    assert _bucket(5000, 2048) == 2048  # capped
    # floor bounds the number of distinct jit shapes (restore path)
    assert _bucket(3, 2048, floor=256) == 256
    assert _bucket(300, 2048, floor=256) == 512
    assert _bucket(10, 64, floor=256) == 64  # cap wins over floor


def test_packed_restore_roundtrip(tiny_cfg):
    """The single packed upload [key-bits | tsdf | weight | born]
    restores bit-exactly through the bucketed jit (key int32 bits survive
    the float32 view on both ends — including the EMPTY_KEY padding
    sentinel 0x7FFFFFFF, which is a NaN bit pattern: the host->device
    transfer must not canonicalize it)."""
    import dataclasses

    from voxelhashing_demo_tpu.models import hash_slam as hs
    from voxelhashing_demo_tpu.geometry.coords import EMPTY_KEY

    cfg = dataclasses.replace(tiny_cfg)
    V = cfg.hash.voxels_per_block
    rng = np.random.default_rng(0)
    n, b = 3, 4
    tsdf = rng.normal(size=(n, V)).astype(np.float32) * 0.05
    weight = rng.uniform(1, 5, size=(n, V)).astype(np.float32)
    born = np.array([0, 7, 123], np.int32)

    packed = np.zeros((b, 2 + 2 * V), np.float32)
    packed[:, 0] = np.full(b, EMPTY_KEY, np.int32).view(np.float32)
    packed[:n, 1 : 1 + V] = tsdf
    packed[:n, 1 + V : 1 + 2 * V] = weight
    packed[:n, 1 + 2 * V] = born.astype(np.float32)

    # EMPTY_KEY's float32 bit pattern is a NaN payload: assert the raw
    # bits survive the host->device round-trip on this platform
    dev_bits = np.asarray(
        jax.lax.bitcast_convert_type(jnp.asarray(packed[:, 0]), jnp.int32)
    )
    np.testing.assert_array_equal(dev_bits, np.full(b, EMPTY_KEY))

    # keys must be valid packed block keys for restore's bucket probe:
    # use real packed coords instead of arbitrary ints
    from voxelhashing_demo_tpu.geometry import coords as coords_mod

    blocks = np.array([[1, 2, 3], [-4, 5, -6], [7, -8, 9]], np.int32)
    keys = np.asarray(
        coords_mod.pack_block_key(jnp.asarray(blocks), cfg.hash.key_bits)
    )
    packed[:n, 0] = keys.view(np.float32)

    restore = hs.make_restore(cfg, b)
    hmap, accepted = restore(
        hash_ops.create(cfg.hash), jnp.asarray(packed), jnp.int32(99)
    )
    acc = np.asarray(accepted)
    assert acc[:n].all() and not acc[n:].any()
    from voxelhashing_demo_tpu.ops.hash_ops import lookup_keys

    ptrs, found = lookup_keys(hmap, cfg.hash, jnp.asarray(keys))
    assert bool(np.asarray(found).all())
    got_t = np.asarray(hmap.tsdf)[np.asarray(ptrs)]
    got_w = np.asarray(hmap.weight)[np.asarray(ptrs)]
    np.testing.assert_array_equal(got_t, tsdf)
    np.testing.assert_array_equal(got_w, weight)
    # born stamps come back verbatim, not stamped "now" (frame 99)
    np.testing.assert_array_equal(
        np.asarray(hmap.born)[np.asarray(ptrs)], born
    )


def test_pull_roundtrip(tiny_cfg):
    """The combined streaming pull [sync | key-bits | payload] decodes
    bit-exactly on the host: int32 keys travel as raw float32 bit
    patterns (including EMPTY_KEY = 0x7FFFFFFF, a NaN payload the D2H
    path must not canonicalize) and the payload rows come back
    verbatim."""
    from voxelhashing_demo_tpu.models import hash_slam as hs

    cfg = tiny_cfg
    V = cfg.hash.voxels_per_block
    R = cfg.stream.max_restore
    b = 4
    rng = np.random.default_rng(3)
    keys = np.array(
        [123456, -1, int(hash_ops.EMPTY_KEY), 77], np.int32
    )
    payload = rng.normal(size=(b, 2 * V + 1)).astype(np.float32)
    sync = rng.normal(size=(33 + R,)).astype(np.float32)

    out = np.asarray(hs.make_pull(cfg, b)(
        jnp.asarray(sync), jnp.asarray(keys), jnp.asarray(payload)
    ))
    S = 33 + R
    np.testing.assert_array_equal(out[:S], sync)
    np.testing.assert_array_equal(out[S : S + b].view(np.int32), keys)
    np.testing.assert_array_equal(
        out[S + b :].reshape(b, 2 * V + 1), payload
    )


def test_born_survives_evict_restore_for_exact_defuse(tiny_cfg):
    """The streaming-exactness foundation: a frame fused at t=0, whose
    rows were evicted and restored later, must still de-integrate
    EXACTLY (the born gate needs the ORIGINAL allocation stamps, which
    evict/restore preserve)."""
    from voxelhashing_demo_tpu.ops import preprocess as pre_ops

    cfg = tiny_cfg
    depths, poses = synthetic.make_sequence(
        cfg.camera, 2, trans_amp=0.06, rot_amp_deg=4.0
    )

    def fuse(hmap, i, frame_idx):
        frame = pre_ops.preprocess(jnp.asarray(depths[i]), cfg.camera)
        hmap, _, _ = hash_ops.fuse_frame(
            hmap, frame, jnp.asarray(poses[i]), cfg.camera, cfg.hash,
            cfg.fusion, frame_idx=frame_idx,
        )
        return hmap

    only_a = fuse(hash_ops.create(cfg.hash), 0, 0)

    both = fuse(hash_ops.create(cfg.hash), 0, 0)
    both = fuse(both, 1, 1)
    # evict EVERYTHING (age 0 at frame 50), then restore at frame 51
    both, ekeys, etsdf, eweight, eborn, ne = hash_ops.evict_stale(
        both, cfg.hash, 50, 0, 512
    )
    assert int(ne) > 0
    both, acc = hash_ops.restore_blocks(
        both, cfg.hash, ekeys, etsdf, eweight, 51, born_rows=eborn
    )
    live = np.asarray(ekeys) != int(hash_ops.EMPTY_KEY)
    assert np.asarray(acc)[live].all()

    frame_b = pre_ops.preprocess(jnp.asarray(depths[1]), cfg.camera)
    undone = hash_ops.defuse_frame(
        both, frame_b, jnp.asarray(poses[1]), cfg.camera, cfg.hash,
        cfg.fusion, frame_born=1,
    )

    # every A-row's content must match the A-only map exactly
    def rows_by_key(hmap):
        keys = np.asarray(hmap.keys)
        ptrs = np.asarray(hmap.ptrs)
        occ = ptrs >= 0
        return {int(k): int(p) for k, p in zip(keys[occ], ptrs[occ])}

    rows_a = rows_by_key(only_a)
    rows_u = rows_by_key(undone)
    assert set(rows_a) <= set(rows_u)
    t_a, w_a = np.asarray(only_a.tsdf), np.asarray(only_a.weight)
    t_u, w_u = np.asarray(undone.tsdf), np.asarray(undone.weight)
    for key, pa in rows_a.items():
        pu = rows_u[key]
        np.testing.assert_allclose(w_u[pu], w_a[pa], atol=1e-4)
        lv = w_a[pa] > 0
        np.testing.assert_allclose(t_u[pu][lv], t_a[pa][lv], atol=5e-4)
    # blocks allocated only by B return to zero weight
    for key, pu in rows_u.items():
        if key not in rows_a:
            assert w_u[pu].max() < 1e-4


def test_async_spill_landing_matches_sync():
    """The rebuild's worker-thread spill landing (spill_finish_async)
    must leave the store and device map IDENTICAL to the synchronous
    path after stream_sync — the async path only moves the payload pull
    off the caller's critical path."""
    import dataclasses

    from voxelhashing_demo_tpu.models import keyframe_slam

    base = _stream_cfg(True)
    cfg = dataclasses.replace(
        base,
        keyframes=dataclasses.replace(
            base.keyframes, min_rotation_deg=8.0, min_translation=0.10,
        ),
    )
    depths, _ = synthetic.make_room_sweep(CAM, 20, sweep_deg=150.0)

    def snapshot(async_path: bool):
        slam = keyframe_slam.KeyframeSLAM(cfg)
        for d in depths:
            slam.process(d)
        slam.flush()
        if not async_path:
            # hide the async method: _rebuild_map then takes the
            # synchronous spill_finish branch
            slam._driver.spill_finish_async = None
        slam._rebuild_map()
        slam._driver.stream_sync()
        store = slam._driver.store
        rows = {
            int(k): store.rows_for(np.asarray([k], np.int32))
            for k in sorted(store._index)
        }
        dev = {
            int(k) for k in np.asarray(slam.state.hmap.keys)
            if k != int(hash_ops.EMPTY_KEY)
        }
        return rows, dev

    rows_a, dev_a = snapshot(async_path=True)
    rows_s, dev_s = snapshot(async_path=False)
    assert dev_a == dev_s
    assert set(rows_a) == set(rows_s)
    for k in rows_a:
        for x, y in zip(rows_a[k], rows_s[k]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_streaming_incremental_reintegration():
    """A BA correction on a STREAMING map takes the incremental path:
    moved frames restore their frustums from the host store first (with
    preserved born stamps), then de/re-integrate — and the result matches
    a from-scratch map fused at the corrected poses."""
    import dataclasses

    from voxelhashing_demo_tpu.geometry import se3
    from voxelhashing_demo_tpu.models import keyframe_slam

    base = _stream_cfg(True)
    cfg = dataclasses.replace(
        base,
        keyframes=dataclasses.replace(
            base.keyframes, min_rotation_deg=8.0, min_translation=0.10,
            rebuild_incremental=True,
        ),
    )
    depths, gt = synthetic.make_room_sweep(CAM, 24, sweep_deg=150.0)
    slam = keyframe_slam.KeyframeSLAM(cfg)
    for d in depths[:16]:
        slam.process(d)
    slam.flush()
    assert len(slam.keyframes) >= 2
    # seed the ledger with a full (streaming) rebuild, then keep going
    slam._rebuild_map()
    assert slam._map_ledgered
    for d in depths[16:]:
        slam.process(d)
    slam.flush()
    store = slam._driver.store
    assert store is not None and len(store) > 0, \
        "scenario must actually stream"

    # move every pose by a rigid D and take the incremental path
    D = np.asarray(se3.exp(jnp.asarray(np.array(
        [0.04, -0.03, 0.02, 0.0, np.deg2rad(2.0), 0.0], np.float32
    ))))
    slam._poses_np[: slam._n_poses] = (
        D @ slam._poses_np[: slam._n_poses]
    )
    slam.graph = slam.graph._replace(
        poses=jnp.einsum("ij,kjl->kil", jnp.asarray(D), slam.graph.poses)
    )
    slam.state = slam.state._replace(
        pose=jnp.asarray(D) @ slam.state.pose
    )
    n, n_sat = slam._incremental_reintegrate()
    assert n > 0

    # reference: same ledger contributions fused from scratch at the
    # corrected poses into a NON-streaming map of ample capacity
    ref_cfg = dataclasses.replace(
        cfg,
        hash=dataclasses.replace(cfg.hash, num_blocks=4096),
        stream=dataclasses.replace(cfg.stream, enabled=False),
    )
    fuse = keyframe_slam.make_fuse_only(ref_cfg)
    poses = slam._poses_np
    ref = hash_ops.create(ref_cfg.hash)
    for rec in slam.keyframes:
        if rec.map_pose is None:
            continue
        ref = fuse(ref, rec.depth_dev, jnp.asarray(poses[rec.index]),
                   jnp.int32(rec.frame_index))
    for ent in slam._ring:
        target = (poses[ent.kf] @ ent.rel).astype(np.float32)
        ref = fuse(ref, ent.depth, jnp.asarray(target),
                   jnp.int32(ent.frame_index))

    render_ref = keyframe_slam.make_render_model(ref_cfg)
    a = slam._render_model(slam.state.hmap, slam.state.pose)
    b = render_ref(ref, slam.state.pose)
    da, db = np.asarray(a.depth), np.asarray(b.depth)
    both = (da > 0) & (db > 0)
    assert both.mean() > 0.4
    med = np.median(np.abs(da - db)[both])
    assert med < 1.0 * cfg.fusion.voxel_size, med
