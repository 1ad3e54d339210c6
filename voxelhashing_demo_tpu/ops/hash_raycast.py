"""Raycasting the voxel-hashed TSDF.

The reference's renderer tried to solve "raycast a hash table" on GPU by
rasterizing visible-block cubes into front/back depth textures and DDA-ing
between them per fragment (reference: notes.md:3-16, raycastSDF.frag:121-177)
— and never worked (README.md:4-5).

The design here goes through a **view-local dense cache**: each
frame, the visible blocks (the same compacted set fusion uses) are scattered
into a camera-centered dense grid in HBM — the moral equivalent of the
reference's GL "SDF volume" buffer (SDFRenderer.cpp:59-61) that fusion wrote
into, except rebuilt per view so the raycaster is just the dense sphere
tracer (raycast.py) with zero per-step hash probes.  Scatter cost is
max_active x 512 elements, tiny next to the raycast itself; ray marching
then runs at dense-grid speed with per-ray adaptive stepping.

A direct per-sample hash-probe sampler is also provided
(``sample_hash_trilinear``) as the semantics reference for tests.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import CameraConfig, FusionConfig, HashConfig, RaycastConfig
from ..geometry import coords
from .hash_ops import ActiveSet, HashMap, FREE_PTR, _local_offsets
from .raycast import RaycastOutput, raycast_dense
from .tsdf import DenseTSDF


def sample_hash_trilinear(
    hmap: HashMap,
    cfg: HashConfig,
    fusion: FusionConfig,
    pos_world: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Direct trilinear (sdf, weight) sampling through the hash table.

    Per sample: 8 corner voxels -> 8 block lookups -> voxel gathers.  The
    GLSL mirror of this in the reference is raycastSDF.frag:91-118 (nearest
    neighbor only).  Used for testing; the fast path is the dense cache.
    """
    g = pos_world / fusion.voxel_size
    base = jnp.floor(g).astype(jnp.int32)
    frac = g - base

    acc_s = 0.0
    acc_w = 0.0
    min_w = jnp.inf
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                vox = base + jnp.array([dx, dy, dz], dtype=jnp.int32)
                block = coords.voxel2block(vox, cfg.block_size)
                keys = coords.pack_block_key(block, cfg.key_bits)
                bucket = coords.spatial_hash(block, cfg.num_buckets)
                bidx = bucket * cfg.bucket_size
                ptr = jnp.full(keys.shape, FREE_PTR, dtype=jnp.int32)
                for s in range(cfg.bucket_size):
                    slot_key = hmap.keys[bidx + s]
                    hit = slot_key == keys
                    ptr = jnp.where(hit, hmap.ptrs[bidx + s], ptr)
                found = ptr != FREE_PTR
                local = vox - coords.block2voxel(block, cfg.block_size)
                lin = coords.linearize_voxel(local, cfg.block_size)
                safe_ptr = jnp.clip(ptr, 0, hmap.tsdf.shape[0] - 1)
                s_val = jnp.where(found, hmap.tsdf[safe_ptr, lin], 0.0)
                w_val = jnp.where(found, hmap.weight[safe_ptr, lin], 0.0)
                wt = (
                    (frac[..., 0] if dx else 1 - frac[..., 0])
                    * (frac[..., 1] if dy else 1 - frac[..., 1])
                    * (frac[..., 2] if dz else 1 - frac[..., 2])
                )
                acc_s = acc_s + wt * s_val
                acc_w = acc_w + wt * w_val
                min_w = jnp.minimum(min_w, w_val)

    known = min_w > 0
    return jnp.where(known, acc_s, 0.0), jnp.where(known, acc_w, 0.0)


def densify_active(
    hmap: HashMap,
    active: ActiveSet,
    cfg: HashConfig,
    fusion: FusionConfig,
    T_wc: jnp.ndarray,
    cache_dims: Tuple[int, int, int],
) -> DenseTSDF:
    """Scatter the visible blocks into a view-local dense cache.

    The cache is centered *ahead of* the camera along its optical axis
    (rays only travel forward — centering on the camera position would
    waste half the volume behind it), snapped to the block grid so cache
    voxel indices align with global voxel coords.  Blocks outside the cache
    are dropped (they are beyond raycast range).  Returns a DenseTSDF
    usable by raycast_dense.
    """
    safe_ptr = jnp.clip(active.ptrs, 0, hmap.tsdf.shape[0] - 1)
    return densify_rows(
        active.blocks,
        hmap.tsdf[safe_ptr],
        hmap.weight[safe_ptr],
        active.ptrs != FREE_PTR,
        cfg,
        fusion,
        T_wc,
        cache_dims,
    )


def densify_rows(
    blocks: jnp.ndarray,      # (A, 3) block coords
    src_sdf: jnp.ndarray,     # (A, V) tsdf rows
    src_w: jnp.ndarray,       # (A, V) weight rows
    row_valid: jnp.ndarray,   # (A,) bool
    cfg: HashConfig,
    fusion: FusionConfig,
    T_wc: jnp.ndarray,
    cache_dims: Tuple[int, int, int],
) -> DenseTSDF:
    """Core cache builder from explicit block rows — shared by the local
    path (densify_active) and the multi-chip path, where rows arrive via an
    all-gather of every device's visible shard (parallel/sharded.py)."""
    dims = jnp.array(cache_dims, dtype=jnp.int32)
    extent = jnp.min(dims).astype(jnp.float32) * fusion.voxel_size
    cam_pos = T_wc[:3, 3]
    forward = T_wc[:3, 2]  # camera +z axis in world frame
    center = cam_pos + forward * (0.45 * extent)
    # snap origin so voxel indices align with global voxel coords
    center_block = coords.world2block(
        center, fusion.voxel_size, cfg.block_size
    )
    origin_block = center_block - (dims // (2 * cfg.block_size))
    origin_voxel = coords.block2voxel(origin_block, cfg.block_size)

    local = _local_offsets(cfg.block_size)                     # (V, 3)
    vox = (
        coords.block2voxel(blocks, cfg.block_size)[:, None, :] + local
    )                                                          # (A, V, 3)
    rel = vox - origin_voxel                                   # cache coords
    in_cache = row_valid[:, None] & jnp.all(
        (rel >= 0) & (rel < dims), axis=-1
    )

    flat = (
        rel[..., 0] * cache_dims[1] * cache_dims[2]
        + rel[..., 1] * cache_dims[2]
        + rel[..., 2]
    )
    n_cells = cache_dims[0] * cache_dims[1] * cache_dims[2]
    flat = jnp.where(in_cache, flat, n_cells)                  # OOB -> drop

    sdf = jnp.full((n_cells,), fusion.truncation, dtype=jnp.float32)
    wgt = jnp.zeros((n_cells,), dtype=jnp.float32)
    sdf = sdf.at[flat.reshape(-1)].set(src_sdf.reshape(-1), mode="drop")
    wgt = wgt.at[flat.reshape(-1)].set(src_w.reshape(-1), mode="drop")

    return DenseTSDF(
        sdf=sdf.reshape(cache_dims),
        weight=wgt.reshape(cache_dims),
        origin=coords.voxel2world(origin_voxel, fusion.voxel_size).astype(
            jnp.float32
        ),
        voxel_size=jnp.float32(fusion.voxel_size),
    )


@partial(jax.jit, static_argnames=("cfg", "cam", "rc", "fusion", "cache_dims"))
def raycast_hash(
    hmap: HashMap,
    active: ActiveSet,
    cfg: HashConfig,
    T_wc: jnp.ndarray,
    cam: CameraConfig,
    rc: RaycastConfig,
    fusion: FusionConfig,
    cache_dims: Tuple[int, int, int] = (256, 256, 256),
) -> RaycastOutput:
    """Render the hashed TSDF from pose T_wc via the dense-cache path."""
    cache = densify_active(hmap, active, cfg, fusion, T_wc, cache_dims)
    return raycast_dense(cache, T_wc, cam, rc, fusion)
