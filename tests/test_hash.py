"""Unit + property tests for the deterministic voxel block hash table
(replacement for the reference's atomic/spinlock table, VoxelUtils.cu)."""

import jax.numpy as jnp
import numpy as np

from voxelhashing_demo_tpu.config import CameraConfig, FusionConfig, HashConfig
from voxelhashing_demo_tpu.geometry import coords, se3
from voxelhashing_demo_tpu.ops import hash_ops

CFG = HashConfig(num_buckets=256, bucket_size=4, num_blocks=512,
                 max_active=256, max_new_per_frame=256)


def keys_of(blocks):
    return coords.pack_block_key(jnp.asarray(blocks, dtype=jnp.int32))


def check_invariants(hmap, cfg=CFG):
    """Occupied slots must form a prefix of each bucket; fill counts match;
    ptrs are unique; free list is consistent."""
    keys = np.asarray(hmap.keys).reshape(cfg.num_buckets, cfg.bucket_size)
    ptrs = np.asarray(hmap.ptrs).reshape(cfg.num_buckets, cfg.bucket_size)
    fill = np.asarray(hmap.bucket_fill)
    occ = keys != int(coords.EMPTY_KEY)
    for b in range(cfg.num_buckets):
        n = occ[b].sum()
        assert fill[b] == n
        assert occ[b][:n].all(), f"bucket {b} not prefix-compacted"
        assert not occ[b][n:].any()
    used = ptrs[occ]
    assert len(np.unique(used)) == len(used), "duplicate block ptrs"
    assert (used >= 0).all() and (used < cfg.num_blocks).all()
    free = np.asarray(hmap.free_list)[: int(hmap.free_top)]
    assert len(np.intersect1d(free, used)) == 0, "allocated ptr on free list"
    assert len(free) + len(used) == cfg.num_blocks


def test_insert_and_lookup():
    hmap = hash_ops.create(CFG)
    blocks = jnp.array([[0, 0, 0], [1, 2, 3], [-5, 7, -2], [100, -100, 50]],
                       dtype=jnp.int32)
    hmap, n = hash_ops.insert_blocks(hmap, CFG, keys_of(blocks))
    assert int(n) == 4
    ptr, found = hash_ops.lookup_blocks(hmap, CFG, blocks)
    assert bool(jnp.all(found))
    assert len(np.unique(np.asarray(ptr))) == 4
    # absent block not found
    _, found2 = hash_ops.lookup_blocks(hmap, CFG, jnp.array([[9, 9, 9]]))
    assert not bool(found2[0])
    check_invariants(hmap)


def test_insert_idempotent():
    hmap = hash_ops.create(CFG)
    blocks = jnp.array([[1, 1, 1], [2, 2, 2]], dtype=jnp.int32)
    hmap, n1 = hash_ops.insert_blocks(hmap, CFG, keys_of(blocks))
    ptr1, _ = hash_ops.lookup_blocks(hmap, CFG, blocks)
    hmap, n2 = hash_ops.insert_blocks(hmap, CFG, keys_of(blocks))
    ptr2, _ = hash_ops.lookup_blocks(hmap, CFG, blocks)
    assert int(n1) == 2 and int(n2) == 0
    np.testing.assert_array_equal(ptr1, ptr2)
    check_invariants(hmap)


def test_insert_with_duplicates_in_batch():
    hmap = hash_ops.create(CFG)
    blocks = jnp.array([[3, 3, 3]] * 10 + [[4, 4, 4]] * 5, dtype=jnp.int32)
    hmap, n = hash_ops.insert_blocks(hmap, CFG, keys_of(blocks))
    assert int(n) == 2
    check_invariants(hmap)


def test_insert_order_independence():
    """Same candidate set in any order -> identical table state."""
    rng = np.random.default_rng(0)
    blocks = rng.integers(-20, 20, size=(100, 3)).astype(np.int32)
    k = keys_of(blocks)
    h1, _ = hash_ops.insert_blocks(hash_ops.create(CFG), CFG, k)
    perm = rng.permutation(100)
    h2, _ = hash_ops.insert_blocks(hash_ops.create(CFG), CFG, k[perm])
    np.testing.assert_array_equal(h1.keys, h2.keys)
    np.testing.assert_array_equal(h1.ptrs, h2.ptrs)
    np.testing.assert_array_equal(h1.free_top, h2.free_top)


def _same_bucket_blocks(n, num_buckets):
    """Brute-force n distinct in-key-range blocks hashing to one bucket."""
    target = int(coords.spatial_hash(jnp.array([0, 0, 0]), num_buckets))
    grid = np.stack(np.meshgrid(np.arange(64), np.arange(64)), -1).reshape(-1, 2)
    blocks = np.concatenate([grid, np.zeros((len(grid), 1), int)], -1)
    h = np.asarray(coords.spatial_hash(jnp.asarray(blocks, jnp.int32),
                                       num_buckets))
    return blocks[h == target][:n].astype(np.int32)


def test_bucket_overflow_drops_deterministically():
    cands = _same_bucket_blocks(CFG.bucket_size + 3, CFG.num_buckets)
    assert len(cands) == CFG.bucket_size + 3
    hmap = hash_ops.create(CFG)
    hmap, n = hash_ops.insert_blocks(hmap, CFG, keys_of(cands))
    assert int(n) == CFG.bucket_size  # bucket can hold only bucket_size
    check_invariants(hmap)
    # retry inserts the rest nowhere (bucket still full), count 0
    hmap, n2 = hash_ops.insert_blocks(hmap, CFG, keys_of(cands))
    assert int(n2) == 0


def test_heap_exhaustion():
    small = HashConfig(num_buckets=256, bucket_size=4, num_blocks=8,
                       max_active=16, max_new_per_frame=64)
    rng = np.random.default_rng(1)
    blocks = rng.integers(-50, 50, size=(32, 3)).astype(np.int32)
    blocks = np.unique(blocks, axis=0)
    hmap = hash_ops.create(small)
    hmap, n = hash_ops.insert_blocks(hmap, small, keys_of(blocks))
    assert int(n) == 8  # only 8 blocks available
    assert int(hmap.free_top) == 0
    check_invariants(hmap, small)


def test_gc_frees_zero_weight_blocks():
    hmap = hash_ops.create(CFG)
    blocks = jnp.array([[1, 0, 0], [2, 0, 0], [3, 0, 0]], dtype=jnp.int32)
    hmap, _ = hash_ops.insert_blocks(hmap, CFG, keys_of(blocks))
    # give one block weight
    ptr, _ = hash_ops.lookup_blocks(hmap, CFG, blocks[:1])
    hmap = hmap._replace(weight=hmap.weight.at[ptr[0], 0].set(5.0))

    hmap, n_freed = hash_ops.garbage_collect(hmap, CFG, min_weight=0.5,
                                             max_free=64)
    assert int(n_freed) == 2
    _, found = hash_ops.lookup_blocks(hmap, CFG, blocks)
    np.testing.assert_array_equal(found, [True, False, False])
    check_invariants(hmap)
    # freed blocks can be re-allocated
    hmap, n = hash_ops.insert_blocks(hmap, CFG, keys_of(blocks[1:]))
    assert int(n) == 2
    check_invariants(hmap)


def test_gc_prefix_recompaction_same_bucket():
    # two entries in one bucket; free the first -> second must shift down
    cands = _same_bucket_blocks(2, CFG.num_buckets)
    hmap = hash_ops.create(CFG)
    hmap, _ = hash_ops.insert_blocks(hmap, CFG, keys_of(cands))
    # weight only the SECOND inserted entry
    ptr, _ = hash_ops.lookup_blocks(hmap, CFG, jnp.array([cands[1]]))
    hmap = hmap._replace(weight=hmap.weight.at[ptr[0], 0].set(5.0))
    hmap, n_freed = hash_ops.garbage_collect(hmap, CFG, 0.5, 64)
    assert int(n_freed) == 1
    _, found = hash_ops.lookup_blocks(
        hmap, CFG, jnp.asarray(cands, dtype=jnp.int32))
    np.testing.assert_array_equal(found, [False, True])
    check_invariants(hmap)


CAM = CameraConfig(width=80, height=60, fx=64.6, fy=64.6, cx=39.5, cy=29.5)
FUS = FusionConfig(voxel_size=0.04, truncation=0.12)
HCFG = HashConfig(num_buckets=2048, bucket_size=4, num_blocks=2048,
                  max_active=1024, max_new_per_frame=1024)


def _plane_frame(z=1.5):
    from voxelhashing_demo_tpu.ops import preprocess as pre
    depth = jnp.full((CAM.height, CAM.width), z, dtype=jnp.float32)
    return pre.preprocess_metric(depth, CAM)


def test_fuse_frame_allocates_band_and_integrates():
    frame = _plane_frame(1.5)
    hmap = hash_ops.create(HCFG)
    hmap, active, n_alloc = hash_ops.fuse_frame(
        hmap, frame, se3.identity(), CAM, HCFG, FUS)
    assert int(n_alloc) > 10
    assert int(active.count) == int(n_alloc)
    check_invariants(hmap, HCFG)

    # sdf at the surface ~0, in front positive
    surf = jnp.array([[0.0, 0.0, 1.5]])
    front = jnp.array([[0.0, 0.0, 1.42]])
    for pt, expect in ((surf, 0.0), (front, 0.08)):
        vox = coords.world2voxel(pt, FUS.voxel_size)
        block = coords.voxel2block(vox, HCFG.block_size)
        ptr, found = hash_ops.lookup_blocks(hmap, HCFG, block)
        assert bool(found[0])
        local = vox - coords.block2voxel(block, HCFG.block_size)
        lin = coords.linearize_voxel(local, HCFG.block_size)
        sdf = float(hmap.tsdf[ptr[0], lin[0]])
        w = float(hmap.weight[ptr[0], lin[0]])
        assert w > 0
        assert abs(sdf - expect) < 1.5 * FUS.voxel_size, (expect, sdf)


def test_fuse_frame_repeat_stable():
    frame = _plane_frame(1.5)
    hmap = hash_ops.create(HCFG)
    hmap, _, n1 = hash_ops.fuse_frame(hmap, frame, se3.identity(), CAM,
                                      HCFG, FUS)
    tsdf_after_1 = np.asarray(hmap.tsdf).copy()
    hmap, _, n2 = hash_ops.fuse_frame(hmap, frame, se3.identity(), CAM,
                                      HCFG, FUS)
    assert int(n2) == 0  # nothing new to allocate
    # same observation fused twice -> same sdf values
    np.testing.assert_allclose(np.asarray(hmap.tsdf), tsdf_after_1,
                               atol=1e-5)
    check_invariants(hmap, HCFG)


def test_compact_visible_only_in_frustum():
    hmap = hash_ops.create(HCFG)
    # one block in front of the camera, one far behind
    blocks = jnp.array([[0, 0, 12], [0, 0, -50]], dtype=jnp.int32)
    hmap, _ = hash_ops.insert_blocks(hmap, HCFG, keys_of(blocks))
    active = hash_ops.compact_visible(hmap, HCFG, se3.identity(), CAM, FUS)
    assert int(active.count) == 1
    got = np.asarray(active.blocks[0])
    np.testing.assert_array_equal(got, [0, 0, 12])


def test_integration_order_independent():
    """The deterministic fusion pipeline is order-independent: fusing the
    same frames in a different order yields the same TSDF field.  This is
    the property the reference's lock-retry hash insert cannot give
    (VoxelUtils.cu:444-455 drops contended inserts by schedule luck) —
    SURVEY.md §5 race-detection row."""
    import numpy as np

    from voxelhashing_demo_tpu.config import (CameraConfig, FusionConfig,
                                              HashConfig)
    from voxelhashing_demo_tpu.ops import hash_ops, hash_raycast
    from voxelhashing_demo_tpu.ops import preprocess as pre
    from voxelhashing_demo_tpu.utils import synthetic

    cam = CameraConfig(width=80, height=60, fx=64.6, fy=64.5, cx=39.7,
                       cy=29.8)
    fus = FusionConfig(voxel_size=0.04, truncation=0.16)
    hcfg = HashConfig(num_buckets=2048, bucket_size=4, num_blocks=2048,
                      max_active=1024, max_new_per_frame=1024)

    frames = []
    for t in (0.0, 0.4, 0.8):
        T = jnp.asarray(synthetic.orbit_pose(t, 0.05, 3.0))
        d = synthetic.render_depth(T, cam)
        frames.append((pre.preprocess_metric(d, cam), T))

    def fuse_in_order(order):
        hmap = hash_ops.create(hcfg)
        for i in order:
            f, T = frames[i]
            hmap, _, _ = hash_ops.fuse_frame(hmap, f, T, cam, hcfg, fus)
        return hmap

    m_a = fuse_in_order([0, 1, 2])
    m_b = fuse_in_order([2, 0, 1])

    rng = np.random.default_rng(1)
    pts = jnp.asarray(
        rng.uniform([-0.6, -0.4, 1.0], [0.6, 0.6, 2.4], size=(512, 3)),
        dtype=jnp.float32,
    )
    s_a, w_a = hash_raycast.sample_hash_trilinear(m_a, hcfg, fus, pts)
    s_b, w_b = hash_raycast.sample_hash_trilinear(m_b, hcfg, fus, pts)
    known = (np.asarray(w_a) > 0) | (np.asarray(w_b) > 0)
    assert known.sum() > 50
    np.testing.assert_allclose(np.asarray(s_a)[known],
                               np.asarray(s_b)[known], atol=1e-5)
    np.testing.assert_allclose(np.asarray(w_a)[known],
                               np.asarray(w_b)[known], atol=1e-4)


def test_integrate_gather_matches_numpy_at_640x480():
    """One 128-block chunk of ``integrate`` at the flagship image size
    against numpy indexing of the depth image and the Curless-Levoy
    update (chip_smoke.ref_integrate, the reference the card is held to).
    Voxels within 1e-3 px of a rounding edge are left out: float32 may
    round them to the neighbouring pixel."""
    import chip_smoke
    from voxelhashing_demo_tpu.ops import preprocess as pre
    from voxelhashing_demo_tpu.utils import synthetic

    cam = CameraConfig()
    assert (cam.width, cam.height) == (640, 480)
    hcfg = HashConfig(num_buckets=8192, bucket_size=4, num_blocks=8192,
                      max_active=4096, max_new_per_frame=4096)
    fus = FusionConfig(voxel_size=0.02, truncation=0.08)
    depths, gt = synthetic.make_room_sweep(cam, 2, sweep_deg=20.0,
                                           noise_seed=1)
    frames = [pre.preprocess(jnp.asarray(d), cam) for d in depths]
    poses = [jnp.asarray(T) for T in gt]
    hmap = hash_ops.create(hcfg)
    for f, T in zip(frames, poses):
        hmap, active, _ = hash_ops.fuse_frame(hmap, f, T, cam, hcfg, fus)
    C = hcfg.integrate_chunk
    assert int(active.count) >= C
    chunk = hash_ops.ActiveSet(blocks=active.blocks[:C],
                               ptrs=active.ptrs[:C], count=jnp.int32(C))
    out = hash_ops.integrate(hmap, chunk, hcfg, frames[0].depth, poses[1],
                             cam, fus)
    ptrs = np.asarray(chunk.ptrs)
    ts, ws, cmp = chip_smoke.ref_integrate(
        np.asarray(chunk.blocks), ptrs, np.asarray(hmap.tsdf),
        np.asarray(hmap.weight), np.asarray(frames[0].depth),
        np.asarray(poses[1]), cam, hcfg, fus)
    assert cmp.mean() > 0.99
    assert np.any(np.asarray(out.weight)[ptrs] != np.asarray(hmap.weight)[ptrs])
    np.testing.assert_allclose(np.asarray(out.tsdf)[ptrs][cmp], ts[cmp],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.asarray(out.weight)[ptrs][cmp], ws[cmp],
                               atol=1e-5, rtol=0)
