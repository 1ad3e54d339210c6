"""World / voxel / block coordinate algebra.

Vectorized jnp re-expression of the device coordinate helpers in the
reference (reference: VoxelUtils.cu:250-326), preserving their exact
integer semantics:

- ``world2voxel`` rounds half-away-from-zero via a sign-dependent 0.5 offset
  then truncation (reference: VoxelUtils.cu:281-287).
- ``voxel2block`` is floor division including the negative-coordinate
  correction (reference: VoxelUtils.cu:266-278) — exactly
  ``jnp.floor_divide`` semantics.
- ``linearize_voxel`` is z-major within an 8^3 block
  (reference: VoxelUtils.cu:311-326).
- ``spatial_hash`` is the Teschner/Niessner 3-prime XOR hash with negative
  wrap (reference: VoxelUtils.cu:250-259).

All functions operate on arrays of shape (..., 3) and are shape-polymorphic.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

HASH_P0 = 73856093
HASH_P1 = 19349669
HASH_P2 = 83492791


def world2voxel(points: jnp.ndarray, voxel_size: float) -> jnp.ndarray:
    """World position (meters) -> integer voxel coordinate.

    Round-half-away-from-zero, matching reference VoxelUtils.cu:281-287:
    ``int3(p/size + copysign(0.5, p))`` with C float->int truncation.
    """
    p = points / voxel_size
    offset = jnp.where(p >= 0, 0.5, -0.5)
    return jnp.trunc(p + offset).astype(jnp.int32)


def voxel2block(voxel: jnp.ndarray, block_size: int) -> jnp.ndarray:
    """Voxel coordinate -> containing block coordinate (floor division).

    Matches reference VoxelUtils.cu:266-278 (truncating division with the
    explicit negative correction == floor division).
    """
    return jnp.floor_divide(voxel, block_size).astype(jnp.int32)


def block2voxel(block: jnp.ndarray, block_size: int) -> jnp.ndarray:
    """Block coordinate -> its minimum-corner voxel coordinate
    (reference: VoxelUtils.cu:289-293)."""
    return (block * block_size).astype(jnp.int32)


def voxel2world(voxel: jnp.ndarray, voxel_size: float) -> jnp.ndarray:
    """Voxel coordinate -> world position of the voxel center... the
    reference uses plain scaling (VoxelUtils.cu:295-299); kept identical so
    world2voxel(voxel2world(v)) == v round-trips."""
    return voxel.astype(jnp.float32) * voxel_size


def block2world(block: jnp.ndarray, voxel_size: float, block_size: int) -> jnp.ndarray:
    """Block coordinate -> world position of its min corner
    (reference: VoxelUtils.cu:301-304)."""
    return voxel2world(block2voxel(block, block_size), voxel_size)


def world2block(points: jnp.ndarray, voxel_size: float, block_size: int) -> jnp.ndarray:
    """World position -> containing block (reference: VoxelUtils.cu:306-309)."""
    return voxel2block(world2voxel(points, voxel_size), block_size)


def linearize_voxel(local: jnp.ndarray, block_size: int) -> jnp.ndarray:
    """In-block (x, y, z) -> linear index, z-major
    (reference: VoxelUtils.cu:311-317)."""
    return (
        local[..., 2] * block_size * block_size
        + local[..., 1] * block_size
        + local[..., 0]
    ).astype(jnp.int32)


def delinearize_voxel(index: jnp.ndarray, block_size: int) -> jnp.ndarray:
    """Linear index -> in-block (x, y, z) (reference: VoxelUtils.cu:319-326)."""
    x = index % block_size
    y = (index // block_size) % block_size
    z = index // (block_size * block_size)
    return jnp.stack([x, y, z], axis=-1).astype(jnp.int32)


def spatial_hash(block: jnp.ndarray, num_buckets: int) -> jnp.ndarray:
    """Teschner 3-prime XOR hash of block coords -> bucket index in
    [0, num_buckets) (reference: VoxelUtils.cu:250-259).

    int32 overflow wraps identically to the CUDA version; the final modulo
    wraps negatives to non-negative.
    """
    h = (
        (block[..., 0] * HASH_P0)
        ^ (block[..., 1] * HASH_P1)
        ^ (block[..., 2] * HASH_P2)
    )
    return jnp.mod(h, num_buckets).astype(jnp.int32)


def pack_block_key(block: jnp.ndarray, key_bits: int = 10) -> jnp.ndarray:
    """Pack a block coordinate into a single non-negative int32 key.

    Each axis gets ``key_bits`` bits with a +2^(bits-1) bias.  Coordinates
    outside the representable range map to the EMPTY_KEY sentinel (i.e. are
    dropped, never aliased onto in-range blocks).  The working volume at
    8-voxel blocks x 2 cm voxels and 10 bits spans +-82 m — ample for SLAM.
    """
    bias = 1 << (key_bits - 1)
    lim = (1 << key_bits) - 1
    b = block + bias
    in_range = jnp.all((b >= 0) & (b <= lim), axis=-1)
    b = jnp.clip(b, 0, lim)
    key = (
        (b[..., 0] << (2 * key_bits)) | (b[..., 1] << key_bits) | b[..., 2]
    ).astype(jnp.int32)
    return jnp.where(in_range, key, EMPTY_KEY)


def unpack_block_key(key: jnp.ndarray, key_bits: int = 10) -> jnp.ndarray:
    """Inverse of pack_block_key."""
    bias = 1 << (key_bits - 1)
    mask = (1 << key_bits) - 1
    x = ((key >> (2 * key_bits)) & mask) - bias
    y = ((key >> key_bits) & mask) - bias
    z = (key & mask) - bias
    return jnp.stack([x, y, z], axis=-1).astype(jnp.int32)


# host-side scalar, NOT a jnp array: a module-level device array would be
# embedded as an on-device constant in every program that closes over it
EMPTY_KEY = np.int32(0x7FFFFFFF)
