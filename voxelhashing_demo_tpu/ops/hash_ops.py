"""Voxel block hash table as pure, deterministic batched array ops.

Atomic-free redesign of the reference's GPU hash table
(reference: VoxelUtils.cu — the component SURVEY.md section 2a inventories).
The reference is built on atomics: per-bucket spinlocks for insert
(atomicExch mutex, VoxelUtils.cu:444-445), an atomic free-list heap
(atomicSub/Add on heapCounter, :328-341), and atomic-counter stream
compaction (:718-768).  Failed lock acquisition silently drops the insert,
to be retried next frame (:444-455) — racy by design.

Here every per-frame mutation is a deterministic batched transform:

- insert  = pack coords to int32 keys -> sort -> unique -> vectorized bucket
            probe -> rank-within-bucket by segmented scan -> free-list slots
            assigned by cumsum.  Bucket overflow and heap exhaustion drop
            candidates exactly like the reference's failed locks — but
            deterministically (the same inputs always drop the same keys).
- compact = visibility mask -> cumsum -> scatter
            (replaces flattenKernel's shared/global atomic counters).
- free/GC = mask -> per-bucket re-compaction -> freed ptrs pushed back on
            the stack (implements the reference's dead deleteVoxelEntry,
            VoxelUtils.cu:544-604, and the GC it never had).

Data layout (structure-of-arrays, static shapes):
- ``keys/ptrs``: [num_buckets * bucket_size] — packed block key and block
  storage index per slot (reference VoxelEntry {pos, ptr, offset},
  VoxelDataStructures.h:19-26; the linked-list ``offset`` is gone — its
  #ifdef path was never compiled in the reference, VoxelUtils.cu:384-411).
- invariant: the occupied slots of each bucket are a *prefix* of the bucket
  (maintained by insert and GC re-compaction), so insertion is
  ``fill + rank`` with no probing for gaps.
- ``tsdf/weight``: [num_blocks, 512] rows, one 8^3 block per row, so a
  block's voxels are one contiguous row gather.
- ``free_list``: stack of free block rows; ``free_top`` replaces the
  atomic heapCounter.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

import numpy as np

from ..config import CameraConfig, FusionConfig, HashConfig
from ..geometry import coords, se3
from ..geometry import camera as cam_geom
from .preprocess import Frame
from .tsdf import sample_weight

FREE_PTR = np.int32(-1)  # host-side scalar (see coords.EMPTY_KEY)
EMPTY_KEY = coords.EMPTY_KEY


class HashMap(NamedTuple):
    """Functional voxel block hash map state (a pytree)."""

    keys: jnp.ndarray         # [T] int32 packed block keys; EMPTY_KEY free
    ptrs: jnp.ndarray         # [T] int32 block row index; -1 free
    bucket_fill: jnp.ndarray  # [num_buckets] int32 occupied prefix length
    free_list: jnp.ndarray    # [num_blocks] int32 stack of free rows
    free_top: jnp.ndarray     # () int32 number of free rows
    tsdf: jnp.ndarray         # [num_blocks, 512] float32
    weight: jnp.ndarray       # [num_blocks, 512] float32
    last_seen: jnp.ndarray    # [num_blocks] int32 frame idx last in frustum
    # min |sdf| over weighted voxels per row (inf = no weighted voxel):
    # maintained by integrate/insert/restore so the splat can skip blocks
    # with no surface-band voxel without re-reading their rows — those
    # blocks contribute zero scatter updates, so the filter is bit-exact
    band_min: jnp.ndarray     # [num_blocks] float32
    # frame idx when the row was (re)allocated: the de-integration gate.
    # A frame integrated at time t touched exactly the rows with
    # born <= t, so de-integrating it later (BundleFusion-style
    # reintegration after a BA correction) must skip younger rows —
    # they never received its samples (models/keyframe_slam).
    born: jnp.ndarray         # [num_blocks] int32


class ActiveSet(NamedTuple):
    """Padded visible-block set (replaces d_compactifiedHashTable)."""

    blocks: jnp.ndarray   # [max_active, 3] int32 block coords (garbage pad)
    ptrs: jnp.ndarray     # [max_active] int32 block rows; -1 pad
    count: jnp.ndarray    # () int32


def create(cfg: HashConfig) -> HashMap:
    """Fresh empty map (reference: deviceAllocate + reset kernels,
    VoxelUtils.cu:151-222; the identity-permutation heap init :161-166)."""
    T = cfg.table_size
    V = cfg.voxels_per_block
    return HashMap(
        keys=jnp.full((T,), EMPTY_KEY, dtype=jnp.int32),
        ptrs=jnp.full((T,), FREE_PTR, dtype=jnp.int32),
        bucket_fill=jnp.zeros((cfg.num_buckets,), dtype=jnp.int32),
        free_list=jnp.arange(cfg.num_blocks, dtype=jnp.int32),
        free_top=jnp.int32(cfg.num_blocks),
        tsdf=jnp.zeros((cfg.num_blocks, V), dtype=jnp.float32),
        weight=jnp.zeros((cfg.num_blocks, V), dtype=jnp.float32),
        last_seen=jnp.zeros((cfg.num_blocks,), dtype=jnp.int32),
        band_min=jnp.full((cfg.num_blocks,), jnp.inf, dtype=jnp.float32),
        born=jnp.zeros((cfg.num_blocks,), dtype=jnp.int32),
    )


# --------------------------------------------------------------------------
# lookup
# --------------------------------------------------------------------------

def default_bucket_fn(cfg: HashConfig):
    """Block coords (..., 3) -> bucket index.  The sharded path overrides
    this with global-hash // n_devices (parallel/sharded.py)."""
    return lambda blocks: coords.spatial_hash(blocks, cfg.num_buckets)


def lookup_keys(
    hmap: HashMap, cfg: HashConfig, query_keys: jnp.ndarray, bucket_fn=None
):
    """Vectorized probe: packed keys (N,) -> (ptr (N,), found (N,)).

    Replaces getVoxelEntry4Block's linear slot scan
    (reference: VoxelUtils.cu:362-414) with a static unrolled compare over
    the bucket's slots.
    """
    bucket_fn = bucket_fn or default_bucket_fn(cfg)
    blocks = coords.unpack_block_key(query_keys, cfg.key_bits)
    bucket = bucket_fn(blocks)
    base = bucket * cfg.bucket_size
    ptr = jnp.full(query_keys.shape, FREE_PTR, dtype=jnp.int32)
    found = jnp.zeros(query_keys.shape, dtype=bool)
    for s in range(cfg.bucket_size):
        slot_key = hmap.keys[base + s]
        hit = (slot_key == query_keys) & (query_keys != EMPTY_KEY)
        ptr = jnp.where(hit, hmap.ptrs[base + s], ptr)
        found = found | hit
    return ptr, found


def lookup_blocks(hmap: HashMap, cfg: HashConfig, blocks: jnp.ndarray):
    """Block coords (..., 3) -> (ptr, found)."""
    keys = coords.pack_block_key(blocks, cfg.key_bits)
    return lookup_keys(hmap, cfg, keys.reshape(-1))


# --------------------------------------------------------------------------
# candidate generation (which blocks does this depth frame touch?)
# --------------------------------------------------------------------------

def frame_candidate_keys(
    frame: Frame,
    T_wc: jnp.ndarray,
    cam: CameraConfig,
    cfg: HashConfig,
    fusion: FusionConfig,
) -> jnp.ndarray:
    """Packed block keys touched by the depth frame's truncation band.

    The reference allocates only the block containing each back-projected
    vertex (allocBlocksKernel, VoxelUtils.cu:606-716) — its full
    truncation-band DDA is commented out (:637-703).  We implement the
    intended band: ``band_steps`` samples along each viewing ray spanning
    +-truncation around the measured surface, so near-surface blocks on
    both sides get allocated (required for raycastable TSDF).

    Returns a flat int32 key array (invalid rays -> EMPTY_KEY).
    """
    stride = cfg.candidate_stride
    verts = frame.vertices[::stride, ::stride]          # (h, w, 3) cam frame
    depth = frame.depth[::stride, ::stride]
    valid = depth > 0

    # unit view ray per pixel
    ray_len = jnp.linalg.norm(verts, axis=-1)
    inv_len = jnp.where(valid, 1.0 / jnp.maximum(ray_len, 1e-9), 0.0)
    ray_dir = verts * inv_len[..., None]

    trunc = fusion.truncation + fusion.trunc_scale * depth
    steps = jnp.linspace(-1.0, 1.0, cfg.band_steps, dtype=jnp.float32)

    # (band, h, w, 3) camera-frame band samples
    samples = (
        verts[None]
        + ray_dir[None] * (steps[:, None, None, None] * trunc[None, ..., None])
    )
    world = se3.apply(T_wc, samples.reshape(-1, 3))
    blocks = coords.world2block(
        world, fusion.voxel_size, cfg.block_size
    )
    keys = coords.pack_block_key(blocks, cfg.key_bits)
    valid_flat = jnp.broadcast_to(valid[None], (cfg.band_steps,) + valid.shape)
    return jnp.where(valid_flat.reshape(-1), keys, EMPTY_KEY)


# --------------------------------------------------------------------------
# insert (allocation)
# --------------------------------------------------------------------------

def _unique_compact(keys: jnp.ndarray, max_out: int) -> jnp.ndarray:
    """Sort + adjacent-diff unique + cumsum compaction of packed keys.

    Returns (max_out,) unique keys padded with EMPTY_KEY.  Overflow beyond
    max_out is dropped deterministically (smallest keys win) — the
    reference's analog is a failed bucket lock (retry next frame).
    """
    s = jnp.sort(keys)
    first = jnp.concatenate(
        [jnp.array([True]), s[1:] != s[:-1]]
    ) & (s != EMPTY_KEY)
    pos = jnp.cumsum(first) - 1
    idx = jnp.where(first, pos, max_out)                 # OOB -> dropped
    out = jnp.full((max_out + 1,), EMPTY_KEY, dtype=jnp.int32)
    out = out.at[idx].set(s, mode="drop")
    return out[:max_out]


def insert_blocks(
    hmap: HashMap, cfg: HashConfig, cand_keys: jnp.ndarray, bucket_fn=None,
    frame_idx: jnp.ndarray | int = 0,
) -> Tuple[HashMap, jnp.ndarray]:
    """Insert up to max_new unique candidate keys; returns (map, n_inserted).

    Deterministic replacement for insertVoxelEntry's spinlock protocol
    (reference: VoxelUtils.cu:417-541): bucket ranks come from a segmented
    scan over bucket-sorted keys, heap slots from a cumsum over the free
    stack, so the same frame always allocates the same blocks.

    ``frame_idx`` stamps last_seen on the new rows: freshly allocated
    blocks count as seen now, which protects them from GC churn (alloc ->
    free -> re-alloc of truncation-band blocks that never receive a
    sample) until they genuinely age out of view.
    """
    bucket_fn = bucket_fn or default_bucket_fn(cfg)
    uniq = _unique_compact(cand_keys, cfg.max_new_per_frame)

    # which of the unique keys are genuinely new?
    _, found = lookup_keys(hmap, cfg, uniq, bucket_fn)
    new_mask = (~found) & (uniq != EMPTY_KEY)

    blocks = coords.unpack_block_key(uniq, cfg.key_bits)
    bucket = bucket_fn(blocks)
    bucket = jnp.where(new_mask, bucket, cfg.num_buckets)  # sort invalid last

    # sort by bucket; segmented rank within each bucket
    order = jnp.argsort(bucket)
    b_sorted = bucket[order]
    n = uniq.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    seg_start = jnp.concatenate(
        [jnp.array([True]), b_sorted[1:] != b_sorted[:-1]]
    )
    start_pos = jax.lax.associative_scan(
        jnp.maximum, jnp.where(seg_start, pos, 0)
    )
    rank_sorted = pos - start_pos
    valid_sorted = b_sorted < cfg.num_buckets

    fill_sorted = hmap.bucket_fill[jnp.clip(b_sorted, 0, cfg.num_buckets - 1)]
    slot_sorted = fill_sorted + rank_sorted
    ok = valid_sorted & (slot_sorted < cfg.bucket_size)

    # heap assignment in the same (sorted) order => within a bucket, heap
    # failures are a suffix of its ranks, preserving the prefix invariant
    alloc_rank = jnp.cumsum(ok.astype(jnp.int32)) - 1
    ok = ok & (alloc_rank < hmap.free_top)
    n_alloc = jnp.sum(ok.astype(jnp.int32))

    new_ptrs = hmap.free_list[
        jnp.clip(hmap.free_top - 1 - alloc_rank, 0, hmap.free_list.shape[0] - 1)
    ]

    # scatter table entries (drop failures via OOB index)
    table_idx = jnp.where(
        ok,
        jnp.clip(b_sorted, 0, cfg.num_buckets - 1) * cfg.bucket_size
        + jnp.clip(slot_sorted, 0, cfg.bucket_size - 1),
        hmap.keys.shape[0],
    )
    keys_sorted = uniq[order]
    keys_new = hmap.keys.at[table_idx].set(keys_sorted, mode="drop")
    ptrs_new = hmap.ptrs.at[table_idx].set(new_ptrs, mode="drop")

    # bucket fill counts
    fill_add_idx = jnp.where(ok, b_sorted, cfg.num_buckets)
    bucket_fill = hmap.bucket_fill.at[fill_add_idx].add(1, mode="drop")

    # zero-init freshly allocated rows (they may hold stale data from a
    # previously freed block)
    row_idx = jnp.where(ok, new_ptrs, hmap.tsdf.shape[0])
    tsdf = hmap.tsdf.at[row_idx].set(0.0, mode="drop")
    weight = hmap.weight.at[row_idx].set(0.0, mode="drop")
    last_seen = hmap.last_seen.at[row_idx].set(
        jnp.int32(frame_idx), mode="drop"
    )
    band_min = hmap.band_min.at[row_idx].set(jnp.inf, mode="drop")
    born = hmap.born.at[row_idx].set(jnp.int32(frame_idx), mode="drop")

    return (
        hmap._replace(
            keys=keys_new,
            ptrs=ptrs_new,
            bucket_fill=bucket_fill,
            free_top=hmap.free_top - n_alloc,
            tsdf=tsdf,
            weight=weight,
            last_seen=last_seen,
            band_min=band_min,
            born=born,
        ),
        n_alloc,
    )


# --------------------------------------------------------------------------
# visible-set compaction
# --------------------------------------------------------------------------

def block_in_frustum(
    blocks: jnp.ndarray,
    T_wc: jnp.ndarray,
    cam: CameraConfig,
    cfg: HashConfig,
    fusion: FusionConfig,
    margin_px: float = 4.0,
) -> jnp.ndarray:
    """Conservative frustum test of block *centers* with a z-adaptive margin.

    The reference tests only the min corner with no margin and with a
    suspect transform direction (blockInFrustum, VoxelUtils.cu:343-359,
    author's own TODO at :348).  Here the pixel margin scales with the
    block's projected extent, radius * f / z (a 16 cm block at 0.5 m with
    fx~517 projects ~140 px): a fixed margin under-covers near blocks whose
    center is off-screen while voxels still project inside, producing
    integration/splat seams at image borders at close range.  ``margin_px``
    is constant extra slack on top.
    """
    half = 0.5 * cfg.block_size * fusion.voxel_size
    radius = half * 1.7320508  # bounding-sphere radius of the block
    center = (
        coords.block2world(blocks, fusion.voxel_size, cfg.block_size) + half
    )
    pc = se3.apply(se3.inverse(T_wc), center)
    z = pc[..., 2]
    safe_z = jnp.maximum(z, 1e-6)
    u = pc[..., 0] / safe_z * cam.fx + cam.cx
    v = pc[..., 1] / safe_z * cam.fy + cam.cy
    # projected block radius in pixels; z clamped so blocks hugging the
    # camera get an effectively unbounded margin (conservative)
    zm = jnp.maximum(z, 0.05)
    mu = margin_px + radius * cam.fx / zm
    mv = margin_px + radius * cam.fy / zm
    near = cam.depth_min - 2.0 * half
    far = cam.depth_max + 2.0 * half
    return (
        (z > near)
        & (z < far)
        & (u >= -mu)
        & (u < cam.width + mu)
        & (v >= -mv)
        & (v < cam.height + mv)
    )


def compact_visible(
    hmap: HashMap,
    cfg: HashConfig,
    T_wc: jnp.ndarray,
    cam: CameraConfig,
    fusion: FusionConfig,
) -> ActiveSet:
    """Stream-compact allocated, in-frustum entries into a padded array.

    cumsum + scatter replacement for flattenKernel's two-level atomic
    counters (reference: VoxelUtils.cu:718-768).
    """
    blocks_all = coords.unpack_block_key(hmap.keys, cfg.key_bits)
    mask = (hmap.ptrs != FREE_PTR) & block_in_frustum(
        blocks_all, T_wc, cam, cfg, fusion
    )
    pos = jnp.cumsum(mask.astype(jnp.int32)) - 1
    idx = jnp.where(mask & (pos < cfg.max_active), pos, cfg.max_active)
    out_blocks = jnp.zeros((cfg.max_active + 1, 3), dtype=jnp.int32)
    out_ptrs = jnp.full((cfg.max_active + 1,), FREE_PTR, dtype=jnp.int32)
    out_blocks = out_blocks.at[idx].set(blocks_all, mode="drop")
    out_ptrs = out_ptrs.at[idx].set(hmap.ptrs, mode="drop")
    count = jnp.minimum(jnp.sum(mask.astype(jnp.int32)), cfg.max_active)
    return ActiveSet(
        blocks=out_blocks[:-1], ptrs=out_ptrs[:-1], count=count
    )


# --------------------------------------------------------------------------
# TSDF fusion over the active set
# --------------------------------------------------------------------------

def _local_offsets(block_size: int) -> jnp.ndarray:
    """(V, 3) in-block voxel offsets in linearization order (z-major,
    reference VoxelUtils.cu:311-326)."""
    return coords.delinearize_voxel(
        jnp.arange(block_size**3, dtype=jnp.int32), block_size
    )


def _integrate_rows(
    hmap: HashMap,
    blocks: jnp.ndarray,    # (C, 3)
    ptrs: jnp.ndarray,      # (C,)
    cfg: HashConfig,
    depth_m: jnp.ndarray,
    T_cw: jnp.ndarray,
    cam: CameraConfig,
    fusion: FusionConfig,
    sign: int = 1,
    max_born: jnp.ndarray | None = None,
) -> HashMap:
    """Fuse one chunk of block rows (the reference's
    integrateDepthMapKernel math, VoxelUtils.cu:789-852).

    ``sign=-1`` DE-integrates: the Curless-Levoy running average is
    exactly invertible below the weight cap, so re-generating the same
    samples (same depth frame, same pose) and subtracting removes this
    frame's contribution bit-for-bit.  ``max_born`` gates updates to rows
    allocated at or before that frame index (see HashMap.born)."""
    C = ptrs.shape[0]
    V = cfg.voxels_per_block
    local = _local_offsets(cfg.block_size)                 # (V, 3)

    vox = coords.block2voxel(blocks, cfg.block_size)[:, None, :] + local
    world = coords.voxel2world(vox, fusion.voxel_size)
    pc = se3.apply(T_cw, world.reshape(-1, 3)).reshape(C, V, 3)
    ij, in_img = cam_geom.project_nearest(pc, cam)

    u = jnp.clip(ij[..., 0], 0, cam.width - 1)
    v = jnp.clip(ij[..., 1], 0, cam.height - 1)
    row_valid = ptrs != FREE_PTR
    depth = depth_m[v, u]                                  # (C, V) gather

    z = pc[..., 2]
    sdf = depth - z
    trunc = fusion.truncation + fusion.trunc_scale * depth
    safe_ptr = jnp.clip(ptrs, 0, hmap.tsdf.shape[0] - 1)
    valid = (
        row_valid[:, None]
        & in_img
        & (depth > 0)
        & (z > 0)
        & (sdf > -trunc)
    )
    if max_born is not None:
        valid = valid & (hmap.born[safe_ptr] <= max_born)[:, None]
    sdf = jnp.clip(sdf, -trunc, trunc)

    w_new = jnp.where(valid, sample_weight(depth, cam, fusion), 0.0)

    old_sdf = hmap.tsdf[safe_ptr]                          # (C, V) row gather
    old_w = hmap.weight[safe_ptr]
    if sign > 0:
        w_sum = old_w + w_new
        fused = jnp.where(
            w_new > 0,
            (old_sdf * old_w + sdf * w_new) / jnp.maximum(w_sum, 1e-12),
            old_sdf,
        )
        new_w = jnp.where(
            w_new > 0, jnp.minimum(w_sum, fusion.max_weight), old_w
        )
    else:
        # inverse update: voxels whose weight falls to ~0 return to the
        # unobserved state (sdf 0, weight 0)
        w_rem = jnp.maximum(old_w - w_new, 0.0)
        fused = jnp.where(
            w_new > 0,
            jnp.where(
                w_rem > 1e-6,
                (old_sdf * old_w - sdf * w_new) / jnp.maximum(w_rem, 1e-12),
                0.0,
            ),
            old_sdf,
        )
        new_w = jnp.where(w_new > 0, w_rem, old_w)
        # float error at tiny w_rem can push the recovered value outside
        # the representable band; clamp to the global truncation bound
        tmax = fusion.truncation + fusion.trunc_scale * cam.depth_max
        fused = jnp.clip(fused, -tmax, tmax)

    row_idx = jnp.where(row_valid, ptrs, hmap.tsdf.shape[0])
    tsdf = hmap.tsdf.at[row_idx].set(fused, mode="drop")
    weight = hmap.weight.at[row_idx].set(new_w, mode="drop")
    row_min = jnp.min(
        jnp.where(new_w > 0, jnp.abs(fused), jnp.inf), axis=1
    )
    band_min = hmap.band_min.at[row_idx].set(row_min, mode="drop")
    return hmap._replace(tsdf=tsdf, weight=weight, band_min=band_min)


def integrate(
    hmap: HashMap,
    active: ActiveSet,
    cfg: HashConfig,
    depth_m: jnp.ndarray,
    T_wc: jnp.ndarray,
    cam: CameraConfig,
    fusion: FusionConfig,
    sign: int = 1,
    max_born: jnp.ndarray | None = None,
) -> HashMap:
    """Curless-Levoy fusion over the padded active set.

    Replaces the reference's dynamic one-CUDA-block-per-visible-block
    launch (integrateDepthMapKernel, VoxelUtils.cu:844-846: grid size =
    numOccupiedBlocks).  XLA needs static shapes, so the padded set is
    processed in fixed-size chunks inside a ``lax.while_loop`` whose trip
    count is dynamic — only ceil(count/chunk) chunks execute, recovering
    the reference's occupancy-proportional cost instead of paying for
    max_active padding every frame.
    """
    A = active.ptrs.shape[0]
    C = min(cfg.integrate_chunk, A)
    while A % C:  # chunks must tile the padded set exactly (no re-fusing)
        C //= 2
    T_cw = se3.inverse(T_wc)
    if C == A:
        return _integrate_rows(
            hmap, active.blocks, active.ptrs, cfg, depth_m, T_cw, cam,
            fusion, sign, max_born,
        )

    def cond(carry):
        i, _ = carry
        return i * C < active.count

    def body(carry):
        i, m = carry
        blocks = jax.lax.dynamic_slice(active.blocks, (i * C, 0), (C, 3))
        ptrs = jax.lax.dynamic_slice(active.ptrs, (i * C,), (C,))
        m = _integrate_rows(m, blocks, ptrs, cfg, depth_m, T_cw, cam,
                            fusion, sign, max_born)
        return (i + 1, m)

    # i0 derives from count so its device-varying type matches the loop
    # condition under shard_map (each device runs its own trip count)
    i0 = active.count * 0
    _, hmap = jax.lax.while_loop(cond, body, (i0, hmap))
    return hmap


# --------------------------------------------------------------------------
# garbage collection (free stale blocks)
# --------------------------------------------------------------------------

def _free_marked(
    hmap: HashMap, cfg: HashConfig, stale: jnp.ndarray, max_free: int
) -> Tuple[HashMap, jnp.ndarray, jnp.ndarray]:
    """Free up to ``max_free`` of the marked table slots: push their rows
    back on the stack, clear the entries, re-compact every bucket's slots
    to a prefix.  Returns (map, freeing_mask (T,), n_freed).  Shared tail
    of garbage_collect and evict_stale."""
    T = hmap.keys.shape[0]
    # cap the number freed per call (bounds the free-stack scatter)
    stale_rank = jnp.cumsum(stale.astype(jnp.int32)) - 1
    freeing = stale & (stale_rank < max_free)
    n_free = jnp.sum(freeing.astype(jnp.int32))

    # push freed rows onto the stack
    stack_idx = jnp.where(
        freeing, hmap.free_top + stale_rank, hmap.free_list.shape[0]
    )
    free_list = hmap.free_list.at[stack_idx].set(hmap.ptrs, mode="drop")

    # clear freed entries
    keys = jnp.where(freeing, EMPTY_KEY, hmap.keys)
    ptrs = jnp.where(freeing, FREE_PTR, hmap.ptrs)

    # re-compact each bucket to a prefix (stable within the bucket)
    S = cfg.bucket_size
    kb = keys.reshape(cfg.num_buckets, S)
    pb = ptrs.reshape(cfg.num_buckets, S)
    keep = kb != EMPTY_KEY
    # stable order: occupied slots first, preserving relative order
    order = jnp.argsort(~keep, axis=1, stable=True)
    kb = jnp.take_along_axis(kb, order, axis=1)
    pb = jnp.take_along_axis(pb, order, axis=1)
    bucket_fill = jnp.sum(keep.astype(jnp.int32), axis=1)

    return (
        hmap._replace(
            keys=kb.reshape(T),
            ptrs=pb.reshape(T),
            bucket_fill=bucket_fill,
            free_list=free_list,
            free_top=hmap.free_top + n_free,
        ),
        freeing,
        n_free,
    )


def garbage_collect(
    hmap: HashMap,
    cfg: HashConfig,
    min_weight: float,
    max_free: int,
    frame_idx: jnp.ndarray | int | None = None,
    min_age: int = 0,
) -> Tuple[HashMap, jnp.ndarray]:
    """Free blocks whose maximum voxel weight is below ``min_weight``.

    Implements what the reference's dead deleteVoxelEntry intended
    (VoxelUtils.cu:544-604) as a whole-table batched op: mark, re-compact
    every bucket's slots (preserving the prefix invariant), push freed rows
    back on the stack.  Returns (map, n_freed).

    With ``frame_idx``/``min_age``, blocks seen within the last ``min_age``
    frames are protected: truncation-band blocks that never receive a
    sample otherwise churn (freed every GC, re-allocated next frame) for
    as long as they stay in view.
    """
    allocated = hmap.ptrs != FREE_PTR
    safe_ptr = jnp.clip(hmap.ptrs, 0, hmap.tsdf.shape[0] - 1)
    # per-row max first (streaming reduce), then a scalar gather per slot —
    # gathering whole rows per table slot would read the map many times over
    row_max_w = jnp.max(hmap.weight, axis=-1)              # (num_blocks,)
    block_w = row_max_w[safe_ptr]                          # (T,)
    stale = allocated & (block_w < min_weight)
    if frame_idx is not None and min_age > 0:
        age = jnp.int32(frame_idx) - hmap.last_seen[safe_ptr]
        stale = stale & (age >= min_age)

    hmap, _, n_free = _free_marked(hmap, cfg, stale, max_free)
    return hmap, n_free


def touch_active(
    hmap: HashMap, active: ActiveSet, frame_idx: jnp.ndarray | int
) -> HashMap:
    """Stamp the visible set's rows with the current frame index (the
    recency signal eviction and GC-protection key on)."""
    row_idx = jnp.where(
        active.ptrs != FREE_PTR, active.ptrs, hmap.last_seen.shape[0]
    )
    return hmap._replace(
        last_seen=hmap.last_seen.at[row_idx].set(
            jnp.int32(frame_idx), mode="drop"
        )
    )


def evict_stale(
    hmap: HashMap,
    cfg: HashConfig,
    frame_idx: jnp.ndarray | int,
    max_age: int,
    max_evict: int,
) -> Tuple[HashMap, jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray,
           jnp.ndarray]:
    """Evict blocks out of the frustum for more than ``max_age`` frames:
    copy their payload out and free them.

    Returns (map, keys (max_evict,), tsdf (max_evict, V), weight
    (max_evict, V), born (max_evict,), n_evicted); key EMPTY_KEY marks
    padding.  The host moves the payload into a BlockStore
    (utils/blockstore.py) and restores it on revisit — the out-of-core
    streaming the reference's fixed-size GPU hash could not do (its dead
    deleteVoxelEntry, VoxelUtils.cu:544-604, DISCARDS data; the original
    VoxelHashing paper's GPU<->host streaming is the design this
    implements, recast as padded batched transfers).  ``born`` rides
    along so a restore can reinstate the row's original allocation stamp
    — what keeps born-gated incremental reintegration
    (models/keyframe_slam) exact across evict/restore cycles.

    Unlike garbage_collect this keeps well-observed geometry: weight does
    not gate eviction, only recency does.
    """
    allocated = hmap.ptrs != FREE_PTR
    safe_ptr = jnp.clip(hmap.ptrs, 0, hmap.tsdf.shape[0] - 1)
    age = jnp.int32(frame_idx) - hmap.last_seen[safe_ptr]
    stale = allocated & (age > max_age)

    # rank BEFORE freeing so payload gather indices match _free_marked's cap
    hmap2, freeing, n_evict = _free_marked(hmap, cfg, stale, max_evict)

    # gather the evicted payload from the PRE-free map (rows untouched by
    # _free_marked — freeing only edits table/stack metadata)
    rank = jnp.cumsum(freeing.astype(jnp.int32)) - 1
    out_idx = jnp.where(freeing, rank, max_evict)
    out_keys = jnp.full((max_evict + 1,), EMPTY_KEY, dtype=jnp.int32)
    out_keys = out_keys.at[out_idx].set(hmap.keys, mode="drop")[:max_evict]
    out_ptrs = jnp.zeros((max_evict + 1,), dtype=jnp.int32)
    out_ptrs = out_ptrs.at[out_idx].set(safe_ptr, mode="drop")[:max_evict]
    out_tsdf = hmap.tsdf[out_ptrs]                       # (max_evict, V)
    out_weight = hmap.weight[out_ptrs]
    out_born = hmap.born[out_ptrs]
    pad = out_keys == EMPTY_KEY
    out_tsdf = jnp.where(pad[:, None], 0.0, out_tsdf)
    out_weight = jnp.where(pad[:, None], 0.0, out_weight)
    out_born = jnp.where(pad, 0, out_born)
    return hmap2, out_keys, out_tsdf, out_weight, out_born, n_evict


def restore_blocks(
    hmap: HashMap,
    cfg: HashConfig,
    keys: jnp.ndarray,          # (R,) unique packed keys; EMPTY_KEY pad
    tsdf_rows: jnp.ndarray,     # (R, V)
    weight_rows: jnp.ndarray,   # (R, V)
    frame_idx: jnp.ndarray | int,
    bucket_fn=None,
    max_weight: float = 255.0,
    born_rows: jnp.ndarray | None = None,   # (R,) original born stamps
) -> Tuple[HashMap, jnp.ndarray]:
    """Re-insert evicted blocks with their stored payload.

    Keys not in the table are inserted and their rows written verbatim
    (bit-exact restore).  Keys already present — the block was re-allocated
    fresh after eviction because the camera revisited before the store's
    frustum prediction fired — are weight-MERGED (Curless-Levoy combine of
    the two weighted averages), the same merge VoxelHashing's host<->GPU
    chunk streaming performs.  Returns (map, accepted (R,) bool): accepted
    keys are now fully on-device and the host must drop its copy; rejected
    ones (bucket overflow / heap exhaustion) stay in the store for retry.

    ``born_rows`` reinstates each row's ORIGINAL allocation stamp (carried
    out by evict_stale): inserted rows take it verbatim; merged rows take
    the MIN of the stored and live stamps (the merged payload contains
    samples from both histories, so de-integration gated at either epoch
    must reach the row).  Without it born is stamped "now", which keeps
    the map safe but makes frames fused before the eviction invisible to
    the born gate — the caller must then fall back to a full rebuild
    (models/keyframe_slam surfaces this as a ledger invalidation).

    RESIDENCY CAVEAT (bounded approximation): the born
    stamp records the row's allocation EPOCH, not its device-residency
    history.  A frame whose frustum covered this block while it was
    off-device (evicted, and a fresh allocation skipped — e.g.
    max_new_per_frame exhausted) fused nothing into it, yet passes the
    born<=frame de-integration gate once the block is restored with its
    original stamp: de-integrating that frame then subtracts a
    contribution that was never added.  The window is narrow (the block
    must be evicted AND revisited AND un-allocatable in the same frames)
    and each occurrence perturbs only that frame's per-voxel sample, but
    incremental reintegration across streaming is therefore exact only
    up to restore-lag frames — not bit-exact in every interleaving.
    Callers needing strict exactness use a full rebuild (which re-fuses
    from the durable keyframe depths and re-stamps everything).
    """
    bucket_fn = bucket_fn or default_bucket_fn(cfg)
    R = keys.shape[0]
    N = hmap.tsdf.shape[0]

    ptr_found, found = lookup_keys(hmap, cfg, keys, bucket_fn)

    # --- merge payload into rows that already exist ------------------------
    m_ptr = jnp.clip(ptr_found, 0, N - 1)
    old_t = hmap.tsdf[m_ptr]
    old_w = hmap.weight[m_ptr]
    w_sum = old_w + weight_rows
    merged_t = jnp.where(
        weight_rows > 0,
        (old_t * old_w + tsdf_rows * weight_rows)
        / jnp.maximum(w_sum, 1e-12),
        old_t,
    )
    merged_w = jnp.minimum(w_sum, jnp.float32(max_weight))
    m_idx = jnp.where(found, ptr_found, N)
    tsdf = hmap.tsdf.at[m_idx].set(merged_t, mode="drop")
    weight = hmap.weight.at[m_idx].set(
        jnp.where(found[:, None], merged_w, old_w), mode="drop"
    )
    m_min = jnp.min(
        jnp.where(merged_w > 0, jnp.abs(merged_t), jnp.inf), axis=1
    )
    band_min = hmap.band_min.at[m_idx].set(m_min, mode="drop")
    hmap = hmap._replace(tsdf=tsdf, weight=weight, band_min=band_min)
    if born_rows is not None:
        merged_born = jnp.minimum(hmap.born[m_ptr], born_rows)
        hmap = hmap._replace(
            born=hmap.born.at[m_idx].set(merged_born, mode="drop")
        )

    # --- insert the genuinely new keys, payload following the sort ---------
    want = (keys != EMPTY_KEY) & ~found
    blocks = coords.unpack_block_key(keys, cfg.key_bits)
    bucket = jnp.where(want, bucket_fn(blocks), cfg.num_buckets)
    order = jnp.argsort(bucket)
    b_sorted = bucket[order]
    keys_sorted = keys[order]

    pos = jnp.arange(R, dtype=jnp.int32)
    seg_start = jnp.concatenate(
        [jnp.array([True]), b_sorted[1:] != b_sorted[:-1]]
    )
    start_pos = jax.lax.associative_scan(
        jnp.maximum, jnp.where(seg_start, pos, 0)
    )
    rank_sorted = pos - start_pos
    valid_sorted = b_sorted < cfg.num_buckets

    fill_sorted = hmap.bucket_fill[jnp.clip(b_sorted, 0, cfg.num_buckets - 1)]
    slot_sorted = fill_sorted + rank_sorted
    ok = valid_sorted & (slot_sorted < cfg.bucket_size)
    alloc_rank = jnp.cumsum(ok.astype(jnp.int32)) - 1
    ok = ok & (alloc_rank < hmap.free_top)
    n_alloc = jnp.sum(ok.astype(jnp.int32))

    new_ptrs = hmap.free_list[
        jnp.clip(hmap.free_top - 1 - alloc_rank, 0, hmap.free_list.shape[0] - 1)
    ]
    table_idx = jnp.where(
        ok,
        jnp.clip(b_sorted, 0, cfg.num_buckets - 1) * cfg.bucket_size
        + jnp.clip(slot_sorted, 0, cfg.bucket_size - 1),
        hmap.keys.shape[0],
    )
    keys_new = hmap.keys.at[table_idx].set(keys_sorted, mode="drop")
    ptrs_new = hmap.ptrs.at[table_idx].set(new_ptrs, mode="drop")
    fill_add_idx = jnp.where(ok, b_sorted, cfg.num_buckets)
    bucket_fill = hmap.bucket_fill.at[fill_add_idx].add(1, mode="drop")

    row_idx = jnp.where(ok, new_ptrs, N)
    t_sorted = tsdf_rows[order]
    w_sorted = weight_rows[order]
    tsdf = hmap.tsdf.at[row_idx].set(t_sorted, mode="drop")
    weight = hmap.weight.at[row_idx].set(w_sorted, mode="drop")
    last_seen = hmap.last_seen.at[row_idx].set(
        jnp.int32(frame_idx), mode="drop"
    )
    ins_min = jnp.min(
        jnp.where(w_sorted > 0, jnp.abs(t_sorted), jnp.inf), axis=1
    )
    band_min = hmap.band_min.at[row_idx].set(ins_min, mode="drop")
    # inserted rows reinstate their original allocation stamp when the
    # store carried it (exact born-gated reintegration across streaming);
    # otherwise conservatively stamp "now"
    if born_rows is not None:
        born_sorted = born_rows[order]
    else:
        born_sorted = jnp.full((R,), jnp.int32(frame_idx))
    born = hmap.born.at[row_idx].set(born_sorted, mode="drop")

    # accepted mask back in input order: inserted-now OR merged-into-existing
    ok_in = jnp.zeros((R,), dtype=bool).at[order].set(ok)
    accepted = ok_in | (found & (keys != EMPTY_KEY))
    return (
        hmap._replace(
            keys=keys_new,
            ptrs=ptrs_new,
            bucket_fill=bucket_fill,
            free_top=hmap.free_top - n_alloc,
            tsdf=tsdf,
            weight=weight,
            last_seen=last_seen,
            band_min=band_min,
            born=born,
        ),
        accepted,
    )


# --------------------------------------------------------------------------
# whole-frame map update
# --------------------------------------------------------------------------

def allocate_from_frame(
    hmap: HashMap,
    frame: Frame,
    T_wc: jnp.ndarray,
    cam: CameraConfig,
    cfg: HashConfig,
    fusion: FusionConfig,
    bucket_fn=None,
    frame_idx: jnp.ndarray | int = 0,
) -> Tuple[HashMap, jnp.ndarray]:
    """Per-frame allocation (reference: allocBlocks, VoxelUtils.cu:708-716)."""
    cand = frame_candidate_keys(frame, T_wc, cam, cfg, fusion)
    return insert_blocks(hmap, cfg, cand, bucket_fn, frame_idx)


def fuse_frame(
    hmap: HashMap,
    frame: Frame,
    T_wc: jnp.ndarray,
    cam: CameraConfig,
    cfg: HashConfig,
    fusion: FusionConfig,
    frame_idx: jnp.ndarray | int = 0,
) -> Tuple[HashMap, ActiveSet, jnp.ndarray]:
    """alloc -> compact -> integrate: the reference's per-frame
    ``SDF_Hashtable::integrate`` sequence (SDF_Hashtable.cpp:11-40) as one
    fused on-device computation.  Returns (map, active_set, n_allocated).
    ``frame_idx`` stamps visibility recency for eviction/GC protection."""
    hmap, n_alloc = allocate_from_frame(
        hmap, frame, T_wc, cam, cfg, fusion, frame_idx=frame_idx
    )
    active = compact_visible(hmap, cfg, T_wc, cam, fusion)
    hmap = touch_active(hmap, active, frame_idx)
    hmap = integrate(hmap, active, cfg, frame.depth, T_wc, cam, fusion)
    return hmap, active, n_alloc


def defuse_frame(
    hmap: HashMap,
    frame: Frame,
    T_wc: jnp.ndarray,
    cam: CameraConfig,
    cfg: HashConfig,
    fusion: FusionConfig,
    frame_born: jnp.ndarray | int,
) -> HashMap:
    """Remove a previously fused frame's contribution: regenerate its
    samples at the SAME pose/depth and apply the inverse Curless-Levoy
    update to the rows that existed when it was fused (born <=
    ``frame_born``).  Exact below the weight cap PROVIDED the visible set
    at this pose fits ``max_active`` — a saturated compaction truncates
    which rows are processed (callers must check ``ActiveSet.count`` and
    surface it; models/keyframe_slam reports ``reintegration_saturated``).
    The enabling primitive of BundleFusion-style incremental
    reintegration after BA corrections
    (models/keyframe_slam._incremental_reintegrate).  No allocation, no
    visibility stamping: this is pure subtraction."""
    active = compact_visible(hmap, cfg, T_wc, cam, fusion)
    return integrate(
        hmap, active, cfg, frame.depth, T_wc, cam, fusion,
        sign=-1, max_born=jnp.int32(frame_born),
    )
