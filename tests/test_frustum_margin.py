"""Near-range frustum coverage: the z-adaptive margin in block_in_frustum.

A 16 cm block at 0.3-0.5 m with fx~517 projects ~140-280 px of extent; a
fixed pixel margin culls border blocks whose centers fall off-screen while
their voxels still project inside, causing integration/splat seams at image
borders at close range.  The margin must scale
with block_radius * f / z.
"""

import jax.numpy as jnp
import numpy as np

from voxelhashing_demo_tpu.config import (CameraConfig, FusionConfig,
                                          HashConfig)
from voxelhashing_demo_tpu.geometry import coords, se3
from voxelhashing_demo_tpu.ops import hash_ops
from voxelhashing_demo_tpu.ops.preprocess import preprocess_metric

CAM = CameraConfig()  # full 640x480 TUM fr1 intrinsics
FUSION = FusionConfig()
CFG = HashConfig(num_buckets=16384, bucket_size=4, num_blocks=8192,
                 max_active=8192, max_new_per_frame=8192,
                 candidate_stride=4)


def _wall_frame(z: float):
    depth = jnp.full((CAM.height, CAM.width), z, dtype=jnp.float32)
    return preprocess_metric(depth, CAM)


def test_near_wall_blocks_all_in_frustum():
    """Every block containing a valid back-projected vertex of a 0.3 m
    wall must pass the frustum test (identity pose: world == camera)."""
    frame = _wall_frame(0.3)
    verts = frame.vertices.reshape(-1, 3)
    valid = frame.depth.reshape(-1) > 0
    blocks = coords.world2block(verts, FUSION.voxel_size, CFG.block_size)
    inside = hash_ops.block_in_frustum(
        blocks, se3.identity(), CAM, CFG, FUSION
    )
    missed = int(jnp.sum(valid & ~inside))
    assert missed == 0, f"{missed} vertex-containing blocks culled"


def test_near_wall_integration_covers_borders():
    """Fusing a 0.35 m wall must write weight into the blocks at all four
    image corners — no border seams (alloc finds them; the frustum test
    must not cull them out of the active set)."""
    frame = _wall_frame(0.35)
    hmap = hash_ops.create(CFG)
    hmap, active, n_alloc = hash_ops.fuse_frame(
        hmap, frame, se3.identity(), CAM, CFG, FUSION
    )
    assert int(n_alloc) > 0

    corners = [(1, 1), (1, CAM.width - 2), (CAM.height - 2, 1),
               (CAM.height - 2, CAM.width - 2)]
    pts = jnp.stack([frame.vertices[v, u] for v, u in corners])
    blocks = coords.world2block(pts, FUSION.voxel_size, CFG.block_size)
    ptr, found = hash_ops.lookup_blocks(hmap, CFG, blocks)
    assert bool(jnp.all(found)), "corner blocks were never allocated"
    w = np.asarray(hmap.weight)[np.asarray(ptr)]
    assert (w.max(axis=1) > 0).all(), (
        "corner blocks allocated but not integrated (frustum-culled)"
    )
