"""Multi-chip SLAM: map sharding + collectives over a jax.sharding.Mesh.

The reference is strictly single-GPU (SURVEY.md section 2b — no NCCL/MPI
anywhere); this module is the framework's scaling dimension, built with
shard_map + XLA collectives (NCCL between GPUs), per BASELINE.json's north
star.

Sharding layout over a 1-D device mesh ("d", n):

- **Hash table / block heap (map parallelism):** bucket b of the global
  table lives on device b % n; each device holds an independent local table
  of num_buckets/n buckets, its own free-block heap, and num_blocks/n TSDF
  rows.  A block's owner is a pure function of its coordinates, so
  allocation routes candidates by ``hash(block) % n`` with no communication
  other than each device masking the (replicated) candidate set to its own
  keys.  Fusion is fully local: every voxel belongs to exactly one owner.
- **Image work (data/spatial parallelism):** ICP residual evaluation and
  raycasting shard the image rows over devices.
- **Collectives:** the 6x6 GN normal equations are ``psum``-reduced across
  devices each ICP iteration (27 floats of traffic — the all-reduce the
  reference's cuBLAS syrk performed on-chip); the visible-block halo is
  ``all_gather``-ed for the view-local raycast cache; model maps are
  ``all_gather``-ed back to full images.

Everything runs inside ONE shard_map-ped jit per frame.
"""

from __future__ import annotations

import dataclasses
import functools
from functools import partial
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import HashConfig, PipelineConfig
from ..geometry import coords, se3
from ..ops import hash_ops, hash_raycast, icp as icp_ops
from ..ops import preprocess as pre_ops
from ..ops import raycast as rc_ops
from ..ops import splat as splat_ops
from ..ops.hash_ops import FREE_PTR, HashMap
from ..ops.preprocess import Frame
from ..models.hash_slam import HashSLAMState, StepInfo

AXIS = "d"


def make_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the GLOBAL device list — under multi-process JAX
    ``jax.devices()`` spans every host's chips, so the same call builds
    the 2-host BASELINE config-4/5 mesh (after
    ``distributed.initialize()``) and the single-process test mesh
    (no local-devices-only assumption)."""
    from . import distributed

    return distributed.global_mesh(n_devices)


def _owner_np(blocks: "np.ndarray", num_buckets: int, n: int):
    """Host-side twin of ``_owner`` (same int32-wraparound Teschner hash)
    for routing restore batches to owning devices without a device
    round-trip."""
    import numpy as np

    b = blocks.astype(np.int32)
    with np.errstate(over="ignore"):
        h = (
            (b[:, 0] * np.int32(coords.HASH_P0))
            ^ (b[:, 1] * np.int32(coords.HASH_P1))
            ^ (b[:, 2] * np.int32(coords.HASH_P2))
        )
    return (h % np.int32(num_buckets)) % np.int32(n)


def local_hash_config(cfg: HashConfig, n: int) -> HashConfig:
    """Per-device shard of the global hash geometry."""
    assert cfg.num_buckets % n == 0, "num_buckets must divide by mesh size"
    assert cfg.num_blocks % n == 0
    assert cfg.max_active % n == 0
    assert cfg.max_new_per_frame % n == 0
    return dataclasses.replace(
        cfg,
        num_buckets=cfg.num_buckets // n,
        num_blocks=cfg.num_blocks // n,
        max_active=cfg.max_active // n,
        max_new_per_frame=cfg.max_new_per_frame // n,
    )


def _owner(blocks: jnp.ndarray, cfg: HashConfig, n: int) -> jnp.ndarray:
    """Owning device of each block: global bucket mod n."""
    return coords.spatial_hash(blocks, cfg.num_buckets) % n


def _local_bucket_fn(cfg: HashConfig, n: int):
    """Global bucket // n is the owner-local bucket index (valid only for
    keys already routed to their owner)."""
    return lambda blocks: coords.spatial_hash(blocks, cfg.num_buckets) // n


def _map_spec() -> HashMap:
    """PartitionSpec pytree for the sharded HashMap."""
    return HashMap(
        keys=P(AXIS),
        ptrs=P(AXIS),
        bucket_fill=P(AXIS),
        free_list=P(AXIS),
        free_top=P(AXIS),        # shape (n,) globally, (1,) per device
        tsdf=P(AXIS),
        weight=P(AXIS),
        last_seen=P(AXIS),
        band_min=P(AXIS),
        born=P(AXIS),
    )


def _state_spec() -> HashSLAMState:
    return HashSLAMState(
        hmap=_map_spec(),
        pose=P(),
        model=Frame(vertices=P(AXIS), normals=P(AXIS), depth=P(AXIS)),
        frame_idx=P(),
        vel=P(),
    )


def create_sharded(config: PipelineConfig, mesh: Mesh) -> HashSLAMState:
    """Initial SLAM state with the map sharded over the mesh."""
    n = mesh.devices.size
    lcfg = local_hash_config(config.hash, n)
    cam = config.camera
    H, W = cam.height, cam.width

    @partial(
        jax.shard_map, mesh=mesh, in_specs=(), out_specs=_state_spec()
    )
    def _init():
        local = hash_ops.create(lcfg)
        local = local._replace(
            free_top=jnp.full((1,), lcfg.num_blocks, dtype=jnp.int32)
        )
        h = H // n  # the model maps live row-sharded over the mesh
        empty = Frame(
            vertices=jnp.zeros((h, W, 3), dtype=jnp.float32),
            normals=jnp.zeros((h, W, 3), dtype=jnp.float32),
            depth=jnp.zeros((h, W), dtype=jnp.float32),
        )
        return HashSLAMState(
            hmap=local,
            pose=se3.identity(),
            model=empty,
            frame_idx=jnp.int32(0),
            vel=se3.identity(),
        )

    return jax.jit(_init)()


def _icp_level_sharded(src_l: Frame, tgt_l: Frame, lcam, cfg, n: int,
                       max_iters: int, T0):
    """One pyramid level of row-sharded GN with psum-ed normal equations.

    When the level's rows do not divide over the mesh, every device runs
    the full image identically (no psum needed — replicated compute gives
    replicated results)."""
    src_h = src_l.depth.shape[0]  # may be pooled coarser than the target
    shard = (src_h % n) == 0
    if shard:
        i = jax.lax.axis_index(AXIS)
        h = src_h // n

        def rows(x):
            return jax.lax.dynamic_slice_in_dim(x, i * h, h, axis=0)

        src_l = Frame(
            vertices=rows(src_l.vertices),
            normals=rows(src_l.normals),
            depth=rows(src_l.depth),
        )

    tgt_packed = icp_ops.pack_target(tgt_l)  # hoisted out of the GN loop

    def gn(T):
        p, n_t, r, valid = icp_ops.associate(
            T, src_l, tgt_l, lcam, cfg, tgt_packed
        )
        sys = icp_ops.build_normal_system(p, n_t, r, valid, cfg.huber_delta)
        # always reduce so the loop carry is device-invariant; replicated
        # (non-sharded) levels just divide the n-fold sum back out
        s = 1.0 if shard else 1.0 / n
        sys = icp_ops.NormalSystem(
            JTJ=jax.lax.psum(sys.JTJ, AXIS) * s,
            JTr=jax.lax.psum(sys.JTr, AXIS) * s,
            error=jax.lax.psum(sys.error, AXIS) * s,
            count=jax.lax.psum(sys.count, AXIS) * s,
        )
        delta = icp_ops.solve_normal_system(sys, cfg.damping)
        return se3.compose(se3.exp(delta), T), sys, jnp.sum(delta * delta)

    def cond(state):
        T, it, dnorm, err, cnt, JTJ = state
        return (it < max_iters) & (dnorm > cfg.update_tol**2)

    def body(state):
        T, it, dnorm, err, cnt, _ = state
        T_new, sys, d2 = gn(T)
        mse = sys.error / jnp.maximum(sys.count, 1.0)
        return (T_new, it + 1, d2, mse, sys.count, sys.JTJ)

    init = (
        T0,
        jnp.int32(0),
        jnp.float32(jnp.inf),
        jnp.float32(jnp.inf),
        jnp.float32(0.0),
        jnp.zeros((6, 6), dtype=jnp.float32),
    )
    T, iters, _, err, count, JTJ = jax.lax.while_loop(cond, body, init)
    return icp_ops.ICPResult(
        transform=T, error=err, count=count, iters=iters, JTJ=JTJ
    )


def _score_sharded(T, src_l: Frame, tgt_l: Frame, lcam, cfg, packed, n: int):
    """Row-sharded alignment_score_sums, psum-reduced to replicated sums.

    The psum is required for type soundness, not just speed: all_gather
    outputs (the target pyramid) are device-VARYING in shard_map's
    replication checker even though their values agree, so a plain jnp.sum
    score would poison the raced-prior selection's replication inference.
    """
    h = src_l.depth.shape[0]
    if h % n == 0:
        i = jax.lax.axis_index(AXIS)
        hh = h // n

        def rows(x):
            return jax.lax.dynamic_slice_in_dim(x, i * hh, hh, axis=0)

        src_l = Frame(vertices=rows(src_l.vertices),
                      normals=rows(src_l.normals), depth=rows(src_l.depth))
        num, den = icp_ops.alignment_score_sums(
            T, src_l, tgt_l, lcam, cfg, packed
        )
        return jax.lax.psum(num, AXIS), jax.lax.psum(den, AXIS)
    num, den = icp_ops.alignment_score_sums(
        T, src_l, tgt_l, lcam, cfg, packed
    )
    return jax.lax.psum(num, AXIS) / n, jax.lax.psum(den, AXIS) / n


def _icp_sharded(src: Frame, tgt_shard: Frame, cam, cfg, n: int,
                 prior_T=None):
    """Coarse-to-fine row-sharded point-to-plane ICP (the multi-chip twin
    of ops.icp.icp_align_pyramid, including the raced constant-velocity
    prior at the coarsest level).

    src arrives replicated; the target model arrives row-sharded and is
    all-gathered once (projective association can land a source point
    anywhere in it), then both are downsampled per pyramid level.
    """
    from ..ops.preprocess import (downsample_depth, downsample_depth_mean,
                                  preprocess_metric)

    def full(x):
        return jax.lax.all_gather(x, AXIS, tiled=True)

    tgt_depth = full(tgt_shard.depth)

    levels = sorted(set(cfg.pyramid), reverse=True)
    iters = cfg.pyramid_iters
    if len(iters) != len(levels):
        iters = (cfg.max_iters,) * len(levels)
    pools = cfg.source_pools
    if len(pools) != len(levels):
        pools = (1,) * len(levels)

    T = se3.identity()
    result = None
    for li, (factor, max_it, pool) in enumerate(zip(levels, iters, pools)):
        lcam = cam.scaled(factor) if factor > 1 else cam
        # source-side pooling, as ops/icp.icp_align_pyramid: a pooled
        # source is MEAN-pooled, a plain pyramid level min-pooled
        sfactor = factor * pool
        if pool > 1:
            d_s = downsample_depth_mean(src.depth, sfactor)
        elif sfactor > 1:
            d_s = downsample_depth(src.depth, sfactor)
        else:
            d_s = src.depth
        d_t = downsample_depth(tgt_depth, factor) if factor > 1 else tgt_depth
        src_l = preprocess_metric(
            d_s, cam.scaled(sfactor) if sfactor > 1 else cam
        )
        tgt_l = preprocess_metric(d_t, lcam)
        result = _icp_level_sharded(src_l, tgt_l, lcam, cfg, n, max_it, T)
        if li == 0 and prior_T is not None:
            raced = _icp_level_sharded(
                src_l, tgt_l, lcam, cfg, n, max_it, prior_T
            )
            packed = icp_ops.pack_target(tgt_l)
            sn, sd = _score_sharded(
                raced.transform, src_l, tgt_l, lcam, cfg, packed, n
            )
            bn, bd = _score_sharded(
                result.transform, src_l, tgt_l, lcam, cfg, packed, n
            )
            result = icp_ops.pick_by_score(
                raced, result,
                sn / jnp.maximum(sd, 1.0), bn / jnp.maximum(bd, 1.0),
            )
        T = result.transform
    return result


def _raycast_model_sharded(
    hmap: HashMap, lcfg: HashConfig, T_wc, config: PipelineConfig, n: int
):
    """Surface prediction over the sharded map.

    Splat mode (default): each device splats its own visible rows into a
    full-resolution z-buffer and the buffers merge with one ``pmin``
    collective — the multi-chip depth test.  March mode: all-gather the
    visible halo, build the view-local dense cache, sphere-trace my rows.
    """
    cam = config.camera
    active = hash_ops.compact_visible(hmap, lcfg, T_wc, cam, config.fusion)

    safe_ptr = jnp.clip(active.ptrs, 0, hmap.tsdf.shape[0] - 1)
    rows_sdf = hmap.tsdf[safe_ptr]
    rows_w = hmap.weight[safe_ptr]
    row_valid = active.ptrs != FREE_PTR

    i = jax.lax.axis_index(AXIS)
    h = cam.height // n

    def rows(x):
        return jax.lax.dynamic_slice_in_dim(x, i * h, h, axis=0)

    if config.raycast.mode == "splat":
        depth = splat_ops.splat_depth_from_map(
            hmap, active, lcfg, T_wc, cam, config.raycast, config.fusion,
        )
        # merge the per-device z-buffers (0 = no estimate -> +inf for min)
        depth = jax.lax.pmin(
            jnp.where(depth > 0, depth, jnp.inf), AXIS
        )
        depth = jnp.where(jnp.isfinite(depth), depth, 0.0)
        out = splat_ops.finalize_depth(
            depth, cam, config.raycast, config.fusion
        )
        model = Frame(
            vertices=rows(out.points),
            normals=rows(out.normals),
            depth=rows(out.depth),
        )
        return model, active

    # halo exchange: every device's visible shard -> all devices
    blocks_all = jax.lax.all_gather(active.blocks, AXIS).reshape(-1, 3)
    sdf_all = jax.lax.all_gather(rows_sdf, AXIS).reshape(
        -1, lcfg.voxels_per_block
    )
    w_all = jax.lax.all_gather(rows_w, AXIS).reshape(
        -1, lcfg.voxels_per_block
    )
    valid_all = jax.lax.all_gather(row_valid, AXIS).reshape(-1)

    cache = hash_raycast.densify_rows(
        blocks_all, sdf_all, w_all, valid_all, lcfg, config.fusion, T_wc,
        config.raycast.cache_dims,
    )

    # raycast my rows
    from ..geometry import camera as cam_geom

    i = jax.lax.axis_index(AXIS)
    h = cam.height // n
    rays = jax.lax.dynamic_slice_in_dim(
        cam_geom.pixel_rays(cam), i * h, h, axis=0
    )
    out = rc_ops.raycast_rays(cache, T_wc, rays, config.raycast)

    # the model stays row-sharded; consumers (next frame's ICP) gather it
    model = Frame(
        vertices=out.points, normals=out.normals, depth=out.depth
    )
    return model, active


def make_sharded_step(config: PipelineConfig, mesh: Mesh):
    """Build the jitted multi-chip frame step for this mesh."""
    n = mesh.devices.size
    lcfg = local_hash_config(config.hash, n)
    cam = config.camera
    assert cam.height % n == 0, "image height must divide by mesh size"
    bucket_fn = _local_bucket_fn(config.hash, n)

    def _local_step(state: HashSLAMState, depth_raw: jnp.ndarray):
        my = jax.lax.axis_index(AXIS)
        frame = pre_ops.preprocess(depth_raw, cam, config.frontend)

        # --- track: row-sharded ICP, psum-ed normal equations ------------
        model_valid = (
            jax.lax.psum(jnp.sum(state.model.depth > 0), AXIS) > 100
        )
        result = _icp_sharded(
            frame, state.model, cam, config.icp, n,
            prior_T=state.vel if config.icp.use_motion_prior else None,
        )
        ok = (
            model_valid
            & (result.count > 100)
            & jnp.all(jnp.isfinite(result.transform))
            & icp_ops.motion_plausible(result.transform, config.icp)
        )
        T_rel = jnp.where(ok, result.transform, se3.identity())
        pose_new = se3.compose(state.pose, T_rel)

        # --- GC: local (before fusion, matching models/hash_slam.step) ----
        if config.gc.enabled:
            do_gc = (state.frame_idx % config.gc.interval) == (
                config.gc.interval - 1
            )
            hmap, n_freed = jax.lax.cond(
                do_gc,
                lambda m: hash_ops.garbage_collect(
                    m, lcfg, config.gc.min_weight,
                    config.gc.max_blocks_per_gc,
                    frame_idx=state.frame_idx, min_age=config.gc.min_age,
                ),
                lambda m: (
                    m,
                    jax.lax.pcast(jnp.int32(0), (AXIS,), to="varying"),
                ),
                state.hmap,
            )
        else:
            hmap, n_freed = state.hmap, jnp.int32(0)

        # --- allocate: route candidates to their owner -------------------
        cand = hash_ops.frame_candidate_keys(
            frame, pose_new, cam, lcfg, config.fusion
        )
        cand_blocks = coords.unpack_block_key(cand, lcfg.key_bits)
        mine = (
            _owner(cand_blocks, config.hash, n) == my
        ) & (cand != hash_ops.EMPTY_KEY)
        cand = jnp.where(mine, cand, hash_ops.EMPTY_KEY)
        hmap, n_alloc = hash_ops.insert_blocks(
            hmap, lcfg, cand, bucket_fn, frame_idx=state.frame_idx
        )

        # --- fuse: fully local (each block has one owner) ----------------
        active = hash_ops.compact_visible(
            hmap, lcfg, pose_new, cam, config.fusion
        )
        hmap = hash_ops.touch_active(hmap, active, state.frame_idx)
        hmap = hash_ops.integrate(
            hmap, active, lcfg, frame.depth, pose_new, cam, config.fusion
        )

        # --- raycast: halo all_gather + row-sharded march ----------------
        model, _ = _raycast_model_sharded(hmap, lcfg, pose_new, config, n)

        new_state = HashSLAMState(
            hmap=hmap,
            pose=pose_new,
            model=model,
            frame_idx=state.frame_idx + 1,
            vel=T_rel,
        )
        info = StepInfo(
            pose=pose_new,
            icp_error=result.error,
            icp_count=result.count,
            icp_iters=result.iters,
            tracked=ok,
            blocks_allocated=jax.lax.psum(n_alloc, AXIS),
            blocks_active=jax.lax.psum(active.count, AXIS),
            blocks_freed=jax.lax.psum(n_freed, AXIS),
            free_blocks=jax.lax.psum(hmap.free_top[0], AXIS),
            valid_px=jnp.sum(frame.depth > 0).astype(jnp.int32),
        )
        return new_state, info

    info_spec = StepInfo(
        pose=P(), icp_error=P(), icp_count=P(), icp_iters=P(), tracked=P(),
        blocks_allocated=P(), blocks_active=P(), blocks_freed=P(),
        free_blocks=P(), valid_px=P(),
    )
    sharded = jax.shard_map(
        _local_step,
        mesh=mesh,
        in_specs=(_state_spec(), P()),
        out_specs=(_state_spec(), info_spec),
    )
    # donate the state: the sharded map updates in place on every device
    return jax.jit(sharded, donate_argnums=0)


def make_sharded_fuse_only(config: PipelineConfig, mesh: Mesh):
    """Sharded fuse-only step (no tracking): integrate one raw depth frame
    at a given pose — the map-rebuild primitive for post-BA reintegration
    (models/keyframe_slam._rebuild_map)."""
    n = mesh.devices.size
    lcfg = local_hash_config(config.hash, n)
    cam = config.camera
    bucket_fn = _local_bucket_fn(config.hash, n)

    def _local(hmap, depth_raw, pose, frame_idx):
        my = jax.lax.axis_index(AXIS)
        frame = pre_ops.preprocess(depth_raw, cam, config.frontend)
        cand = hash_ops.frame_candidate_keys(
            frame, pose, cam, lcfg, config.fusion
        )
        cand_blocks = coords.unpack_block_key(cand, lcfg.key_bits)
        mine = (
            _owner(cand_blocks, config.hash, n) == my
        ) & (cand != hash_ops.EMPTY_KEY)
        cand = jnp.where(mine, cand, hash_ops.EMPTY_KEY)
        hmap, _ = hash_ops.insert_blocks(
            hmap, lcfg, cand, bucket_fn, frame_idx=frame_idx
        )
        active = hash_ops.compact_visible(hmap, lcfg, pose, cam,
                                          config.fusion)
        hmap = hash_ops.touch_active(hmap, active, frame_idx)
        hmap = hash_ops.integrate(
            hmap, active, lcfg, frame.depth, pose, cam, config.fusion
        )
        return hmap

    fn = jax.shard_map(
        _local,
        mesh=mesh,
        in_specs=(_map_spec(), P(), P(), P()),
        out_specs=_map_spec(),
    )
    return jax.jit(fn, donate_argnums=0)


def make_sharded_reintegrate(config: PipelineConfig, mesh: Mesh):
    """Sharded twin of models/keyframe_slam.make_reintegrate: born-gated
    de-integrate at the old pose + re-integrate at the new pose of one
    stored frame depth, each device moving only its own rows (fusion is
    owner-local, so no collectives beyond the saturation flag).

    Returns (map, count): the count is the GLOBAL max_active when ANY
    device's visible-set compaction hit its local cap (the caller's
    ``count >= max_active`` saturation test then fires exactly like the
    single-chip path), else the psum of the per-device counts.
    """
    n = mesh.devices.size
    lcfg = local_hash_config(config.hash, n)
    cam = config.camera

    def _local(hmap, depth_raw, T_old, T_new, frame_born):
        frame = pre_ops.preprocess(depth_raw, cam, config.frontend)
        a_old = hash_ops.compact_visible(hmap, lcfg, T_old, cam,
                                         config.fusion)
        hmap = hash_ops.integrate(
            hmap, a_old, lcfg, frame.depth, T_old, cam, config.fusion,
            sign=-1, max_born=jnp.int32(frame_born),
        )
        a_new = hash_ops.compact_visible(hmap, lcfg, T_new, cam,
                                         config.fusion)
        hmap = hash_ops.integrate(
            hmap, a_new, lcfg, frame.depth, T_new, cam, config.fusion,
            max_born=jnp.int32(frame_born),
        )
        local_max = jnp.maximum(a_old.count, a_new.count)
        saturated = jax.lax.psum(
            (local_max >= lcfg.max_active).astype(jnp.int32), AXIS
        ) > 0
        count = jnp.where(
            saturated,
            jnp.int32(config.hash.max_active),
            jax.lax.psum(local_max, AXIS),
        )
        return hmap, count

    fn = jax.shard_map(
        _local,
        mesh=mesh,
        in_specs=(_map_spec(), P(), P(), P(), P()),
        out_specs=(_map_spec(), P()),
    )
    return jax.jit(fn, donate_argnums=0)


@functools.lru_cache(maxsize=None)
def make_sharded_render_model(config: PipelineConfig, mesh: Mesh):
    """Sharded surface prediction at an arbitrary pose (row-sharded model
    Frame) — refreshes tracking input after a map rebuild.  Memoized so
    the keyframe backend's warmed instance and ``make_sharded_render``
    share ONE executable."""
    n = mesh.devices.size
    lcfg = local_hash_config(config.hash, n)

    def _local(hmap, pose):
        model, _ = _raycast_model_sharded(hmap, lcfg, pose, config, n)
        return model

    fn = jax.shard_map(
        _local,
        mesh=mesh,
        in_specs=(_map_spec(), P()),
        out_specs=Frame(vertices=P(AXIS), normals=P(AXIS), depth=P(AXIS)),
    )
    return jax.jit(fn)


def make_sharded_render(config: PipelineConfig, mesh: Mesh):
    """LIVE render of the sharded map at an arbitrary pose — the
    multi-chip twin of models/hash_slam.HashSLAM.render (reference:
    SDFRenderer.cpp:210 render, finished here where the reference broke).

    Reuses the tracking surface-prediction EXECUTABLE
    (``make_sharded_render_model``: per-device splat + one ``pmin``
    z-buffer merge, or halo all-gather + sphere trace) — identical
    per-pixel values to the single-chip renderer over the same map
    content (min is order-independent), already covered by the backend's
    ``warm_compile`` — and wraps the row-sharded Frame into a
    RaycastOutput (one eager elementwise op for the hit mask)."""
    model_fn = make_sharded_render_model(config, mesh)

    def render(hmap, pose):
        m = model_fn(hmap, pose)
        return rc_ops.RaycastOutput(
            depth=m.depth, points=m.vertices, normals=m.normals,
            hit=m.depth > 0,
        )

    return render


def make_sharded_evict(config: PipelineConfig, mesh: Mesh):
    """Jitted sharded eviction scan: each device evicts its own stale rows
    (max_evict/n per device) — no collectives beyond the count psum; the
    padded payload comes back axis-sharded and the host concatenates it
    into the BlockStore.  As in the single-chip twin
    (models/hash_slam.make_evict), the replicated ``sync`` output packs
    [n_evicted, pose(16), vel(16), accepted_prev(max_restore)] so the
    streaming cycle needs ONE blocking fetch."""
    n = mesh.devices.size
    lcfg = local_hash_config(config.hash, n)
    s = config.stream
    assert s.max_evict % n == 0

    def _local(hmap, frame_idx, pose, vel):
        hmap, keys, tsdf, weight, born, cnt = hash_ops.evict_stale(
            hmap, lcfg, frame_idx, s.max_age, s.max_evict // n
        )
        sync = jnp.concatenate([
            jax.lax.psum(cnt, AXIS).astype(jnp.float32)[None],
            pose.reshape(16),
            vel.reshape(16),
        ])
        return hmap, keys, tsdf, weight, born, sync

    fn = jax.shard_map(
        _local,
        mesh=mesh,
        in_specs=(_map_spec(), P(), P(), P()),
        out_specs=(_map_spec(), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P()),
    )
    return jax.jit(fn, donate_argnums=0)


def make_sharded_restore(config: PipelineConfig, mesh: Mesh):
    """Jitted sharded restore: the key/payload batch arrives OWNER-ROUTED
    and axis-sharded — the host routes each stored key to its owning
    device's ``max_restore/n`` slice by the same hash-mod-n the allocator
    uses (``_owner_np``), so there is no payload broadcast and no psum;
    the accepted mask comes back axis-sharded, aligned with the routed
    batch.  Multi-host ready: each process contributes only its local
    devices' slices (distributed.shard_rows_to_global), and restore
    executes owner-locally.  A defensive on-device owner mask keeps a
    mis-routed key from poisoning a foreign local table."""
    n = mesh.devices.size
    lcfg = local_hash_config(config.hash, n)
    bucket_fn = _local_bucket_fn(config.hash, n)
    assert config.stream.max_restore % n == 0

    def _local(hmap, keys, tsdf, weight, born, frame_idx):
        my = jax.lax.axis_index(AXIS)
        blocks = coords.unpack_block_key(keys, lcfg.key_bits)
        mine = (
            _owner(blocks, config.hash, n) == my
        ) & (keys != hash_ops.EMPTY_KEY)
        keys_m = jnp.where(mine, keys, hash_ops.EMPTY_KEY)
        hmap, accepted = hash_ops.restore_blocks(
            hmap, lcfg, keys_m, tsdf, weight, frame_idx, bucket_fn,
            max_weight=config.fusion.max_weight, born_rows=born,
        )
        return hmap, accepted & mine

    fn = jax.shard_map(
        _local,
        mesh=mesh,
        in_specs=(_map_spec(), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P()),
        out_specs=(_map_spec(), P(AXIS)),
    )
    return jax.jit(fn, donate_argnums=0)


@functools.lru_cache(maxsize=None)
def make_sharded_spill_evict(config: PipelineConfig, mesh: Mesh,
                             cap_per_dev: int):
    """Sharded twin of models/hash_slam.make_spill_evict: each device
    appends its own evictions into its ``cap_per_dev``-row slice of the
    spill buffer (owner-local, no collectives).  Per-device counts ride
    as a (n,)-sharded vector."""
    n = mesh.devices.size
    lcfg = local_hash_config(config.hash, n)
    s = config.stream

    def _local(hmap, frame_idx, sk, sp, cnt):
        hmap, keys, tsdf, weight, born, m = hash_ops.evict_stale(
            hmap, lcfg, frame_idx, s.max_age, s.max_evict // n
        )
        payload = jnp.concatenate(
            [tsdf, weight, born.astype(jnp.float32)[:, None]], axis=1
        )
        pos = jnp.arange(keys.shape[0], dtype=jnp.int32)
        idx = jnp.where(pos < m, cnt[0] + pos, cap_per_dev)
        sk = sk.at[idx].set(keys, mode="drop")
        sp = sp.at[idx].set(payload, mode="drop")
        return hmap, sk, sp, cnt + m

    fn = jax.shard_map(
        _local,
        mesh=mesh,
        in_specs=(_map_spec(), P(), P(AXIS), P(AXIS), P(AXIS)),
        out_specs=(_map_spec(), P(AXIS), P(AXIS), P(AXIS)),
    )
    return jax.jit(fn, donate_argnums=(0, 2, 3))


def optimize_graph_sharded(graph, kcfg, mesh):
    """Distributed bundle adjustment: edges sharded over the mesh, normal
    equations ``psum``-reduced, identical solve replicated on every device.

    The reference has no backend at all (SURVEY.md §5); this is the
    distributed-BA reduction of the north star (BASELINE.json configs 4-5).
    Returns (optimized PoseGraph, BAInfo), numerically identical to the
    single-device ``ops.pose_graph.optimize`` with its DENSE solver
    (same H, same solve).  The sharded path is dense-only by design —
    at the K where the matrix-free CG solver matters the edge build no
    longer dominates and sharding it stops paying (see
    ``pose_graph.solve_delta_cg``); ``ba_solver="auto"`` therefore
    stays dense here regardless of capacity, and an EXPLICIT
    ``ba_solver="cg"`` with a mesh is rejected rather than silently
    downgraded.
    """
    from ..ops import pose_graph

    if kcfg.ba_solver == "cg":
        raise ValueError(
            "ba_solver='cg' is single-device only; the sharded BA path "
            "psums the dense normal equations (use 'auto' or 'dense' "
            "with a mesh)"
        )

    n = mesh.devices.size
    E = graph.edges_ij.shape[0]
    pad = (-E) % n
    if pad:
        # padding edges are (0, 0, I, w=0): exactly zero residual/Jacobian
        I = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (pad, 4, 4))
        graph = graph._replace(
            edges_ij=jnp.concatenate(
                [graph.edges_ij, jnp.zeros((pad, 2), jnp.int32)]
            ),
            edges_T=jnp.concatenate([graph.edges_T, I]),
            edges_w=jnp.concatenate(
                [graph.edges_w, jnp.zeros((pad,), jnp.float32)]
            ),
        )

    def _local(poses, num_poses, eij, eT, ew):
        def make(p):
            return pose_graph.PoseGraph(
                poses=p, num_poses=num_poses, edges_ij=eij, edges_T=eT,
                edges_w=ew, num_edges=jnp.int32(eij.shape[0]),
            )

        def chi2(p):
            return jax.lax.psum(
                pose_graph._chi2(make(p)), AXIS
            )

        chi2_0 = chi2(poses)

        def body(i, p):
            H, b, _ = pose_graph.build_normal_equations(
                make(p), pose_graph.gnc_delta(kcfg, i),
                kcfg.ba_robust_kernel
            )
            H = jax.lax.psum(H, AXIS)
            b = jax.lax.psum(b, AXIS)
            return pose_graph.apply_update(make(p), H, b, kcfg).poses

        poses = jax.lax.fori_loop(0, kcfg.ba_iters, body, poses)
        return poses, chi2_0, chi2(poses)

    fn = jax.jit(
        jax.shard_map(
            _local,
            mesh=mesh,
            in_specs=(P(), P(), P(AXIS), P(AXIS), P(AXIS)),
            out_specs=(P(), P(), P()),
        )
    )
    poses, c0, c1 = fn(
        graph.poses, graph.num_poses, graph.edges_ij, graph.edges_T,
        graph.edges_w,
    )
    out = graph._replace(poses=poses)
    if pad:
        out = out._replace(
            edges_ij=out.edges_ij[:E],
            edges_T=out.edges_T[:E],
            edges_w=out.edges_w[:E],
        )
    info = pose_graph.BAInfo(
        chi2_initial=c0, chi2_final=c1, iters=jnp.int32(kcfg.ba_iters)
    )
    return out, info


class ShardedHashSLAM:
    """Host-side wrapper: multi-chip voxel-hash SLAM over a device mesh.

    Streaming (config.stream.enabled) works exactly as in the single-chip
    HashSLAM wrapper — one global host BlockStore; eviction pulls each
    device's stale rows (axis-sharded padded batch), restore broadcasts
    the batch and owner-routes it on device — including the PIPELINED
    cycle (models/hash_slam.HashSLAM docstring): restore batches are
    queried+uploaded one interval ahead, evicted payloads land one cycle
    late with ``copy_to_host_async`` pre-shipping the bytes, and the
    pose/velocity/count/accepted sync is ONE packed fetch."""

    def __init__(self, config: PipelineConfig, mesh: Mesh):
        self.config = config
        self.mesh = mesh
        self.state = create_sharded(config, mesh)
        self._step = make_sharded_step(config, mesh)
        self.trajectory = []
        self.infos = []
        self.store = None
        if config.stream.enabled:
            from ..utils.blockstore import BlockStore

            self.store = BlockStore(config.hash)
            self._evict = make_sharded_evict(config, mesh)
            self._restore = make_sharded_restore(config, mesh)
            self._init_stream_runtime()

    def _init_stream_runtime(self) -> None:
        """Pipelining state (also called by checkpoint loaders)."""
        self._prefetch = None        # (placed_keys_np, uploaded arrays)
        self._pending_evict = None   # device (keys, tsdf, weight, born)

    def _local_positions(self):
        """Mesh-axis positions of this process's devices (ascending).
        Single-process: every position — which is why the per-process
        store/routing paths are fully exercised by the test suite."""
        pi = jax.process_index()
        return [i for i, d in enumerate(self.mesh.devices.flat)
                if d.process_index == pi]

    def _pack_restore(self, keys):
        """Owner-route the stored keys into per-device slices of the
        axis-sharded restore batch (this process contributes its LOCAL
        devices' slices).  Keys overflowing a device's ``max_restore/n``
        slice stay in the store for retry.  Returns
        (placed_keys, uploaded): ``placed_keys`` (flat, EMPTY_KEY pads)
        aligns row-for-row with this process's slice of the accepted
        mask."""
        import numpy as np

        from ..utils.blockstore import unpack_keys_np
        from . import distributed

        s = self.config.stream
        n = self.mesh.devices.size
        cap = s.max_restore // n
        V = self.config.hash.voxels_per_block
        locs = self._local_positions()
        pos_of = {p: j for j, p in enumerate(locs)}
        L = len(locs)

        placed = np.full((L, cap), int(hash_ops.EMPTY_KEY), np.int32)
        tsdf_l = np.zeros((L, cap, V), np.float32)
        weight_l = np.zeros((L, cap, V), np.float32)
        born_l = np.zeros((L, cap), np.int32)
        if keys.size:
            blocks = unpack_keys_np(keys, self.config.hash.key_bits)
            owner = _owner_np(blocks, self.config.hash.num_buckets, n)
            tsdf, weight, born = self.store.rows_for(keys)
            fill = np.zeros(L, np.int64)
            for i in range(keys.shape[0]):
                j = pos_of.get(int(owner[i]))
                if j is None:
                    continue   # foreign block (shouldn't occur: the
                    # per-process store only holds local evictions)
                f = fill[j]
                if f >= cap:
                    continue   # slice overflow: retried next cycle
                placed[j, f] = keys[i]
                tsdf_l[j, f] = tsdf[i]
                weight_l[j, f] = weight[i]
                born_l[j, f] = born[i]
                fill[j] += 1
        uploaded = tuple(
            distributed.shard_rows_to_global(
                a.reshape(L * cap, *a.shape[2:]), self.mesh, P(AXIS)
            )
            for a in (placed, tsdf_l, weight_l, born_l)
        )
        return placed.reshape(-1), uploaded

    def _dispatch_restore(self, uploaded):
        keys_d, tsdf_d, weight_d, born_d = uploaded
        hmap, accepted = self._restore(
            self.state.hmap, keys_d, tsdf_d, weight_d, born_d,
            self.state.frame_idx,
        )
        self.state = self.state._replace(hmap=hmap)
        return accepted

    def _take_accepted(self, placed, accepted) -> None:
        """Drop the accepted routed keys from this process's store
        (``accepted`` is axis-sharded, aligned with ``placed``)."""
        import numpy as np

        from . import distributed

        acc = distributed.local_rows(accepted)
        live = placed != int(hash_ops.EMPTY_KEY)
        if live.any():
            self.store.take(placed[live], np.asarray(acc)[live])

    def _land_pending_evict(self) -> None:
        import numpy as np

        from . import distributed

        if self._pending_evict is None:
            return
        keys, tsdf, weight, born = self._pending_evict
        self._pending_evict = None
        # per-process store shard: only this process's devices' rows
        self.store.add(
            distributed.local_rows(keys), distributed.local_rows(tsdf),
            distributed.local_rows(weight), distributed.local_rows(born),
        )

    def stream_sync(self) -> None:
        """Quiesce the pipelined streaming cycle (interface twin of
        models/hash_slam.HashSLAM.stream_sync)."""
        if self.store is None:
            return
        if self._prefetch is not None:
            placed, uploaded = self._prefetch
            self._prefetch = None
            accepted = self._dispatch_restore(uploaded)
            self._take_accepted(placed, accepted)
        self._land_pending_evict()

    def _stream_cycle(self, horizon: int | None = None) -> None:
        import numpy as np

        from . import distributed

        s = self.config.stream
        # 1. dispatch the restore prepared last cycle
        acc = None
        placed_prev = None
        if self._prefetch is not None:
            placed_prev, uploaded = self._prefetch
            self._prefetch = None
            acc = self._dispatch_restore(uploaded)
        # 2. evict with the packed sync [n | pose | vel]
        hmap, keys_e, tsdf_e, weight_e, born_e, sync = self._evict(
            self.state.hmap, self.state.frame_idx, self.state.pose,
            self.state.vel,
        )
        self.state = self.state._replace(hmap=hmap)
        # 3. land last cycle's evicted payload into the process-local
        #    store shard
        self._land_pending_evict()
        # 4. the sync fetch (replicated -> identical on every process)
        arr = np.asarray(sync)
        n = int(arr[0])
        pose = arr[1:17].reshape(4, 4)
        vel = arr[17:33].reshape(4, 4)
        if placed_prev is not None:
            self._take_accepted(placed_prev, acc)
        # 5. hold this cycle's evicted payload for next cycle's landing
        #    (n is a psum -> the gate is process-symmetric)
        if n > 0:
            self._pending_evict = (keys_e, tsdf_e, weight_e, born_e)
        # 6. query + upload the next cycle's restore batch.  The query
        #    runs on the process-local store shard; under multi-process
        #    ALL processes must dispatch the restore together, so a
        #    prefetch (possibly empty on this process) is created
        #    whenever any process might have one.
        hor = 2 * s.interval if horizon is None else horizon
        pred = pose @ np.linalg.matrix_power(vel, hor)
        keys = (self.store.query_frustum(
            pred, self.config.camera, self.config.fusion,
            s.restore_margin_px, s.max_restore,
        ) if len(self.store) else np.zeros(0, np.int32))
        if keys.size or distributed.is_multiprocess():
            self._prefetch = self._pack_restore(keys)

    def _restore_keys(self, keys) -> None:
        """Synchronously restore the given stored keys onto their owning
        devices; used by the keyframe backend's incremental reintegration
        (interface twin of models/hash_slam.HashSLAM._restore_keys).
        Under multi-process every process must call this together (the
        restore dispatch is collective) — with its own process-local key
        set, possibly empty."""
        import numpy as np

        from . import distributed

        # the sync may dispatch a prefetched restore that TAKES some of
        # the requested keys out of the store (they are on-device now,
        # which is what the caller wanted) — drop them from the batch
        self.stream_sync()
        if keys.size:
            keys = keys[np.fromiter(
                (int(k) in self.store._index for k in keys),
                bool, keys.shape[0],
            )]
        if keys.size == 0 and not distributed.is_multiprocess():
            return
        placed, uploaded = self._pack_restore(keys)
        accepted = self._dispatch_restore(uploaded)
        self._take_accepted(placed, accepted)

    def _evict_into(self, hmap, frame_idx, store):
        """Run the sharded eviction jit and move the payload into
        ``store`` synchronously (interface shared with the single-chip
        driver for the keyframe backend's map rebuild)."""
        import numpy as np

        from . import distributed

        I = jnp.eye(4, dtype=jnp.float32)
        hmap, keys, tsdf, weight, born, sync = self._evict(
            hmap, frame_idx, I, I
        )
        if int(np.asarray(sync[0])) > 0:
            store.add(
                distributed.local_rows(keys),
                distributed.local_rows(tsdf),
                distributed.local_rows(weight),
                distributed.local_rows(born),
            )
        return hmap

    # -- rebuild spill session (interface twin of HashSLAM's) ---------------

    def spill_begin(self) -> dict:
        """Per-device spill buffers for a streaming map rebuild (see
        models/hash_slam.HashSLAM.spill_begin)."""
        import numpy as np

        from ..geometry.coords import EMPTY_KEY
        from . import distributed

        n = self.mesh.devices.size
        cap = max(4 * self.config.hash.num_blocks // n, 1)
        V = self.config.hash.voxels_per_block
        return {
            "cap": cap,
            "keys": distributed.shard_rows_to_global(
                np.full((n * cap,), int(EMPTY_KEY), np.int32),
                self.mesh, P(AXIS),
            ),
            "payload": distributed.shard_rows_to_global(
                np.zeros((n * cap, 2 * V + 1), np.float32),
                self.mesh, P(AXIS),
            ),
            "count": distributed.shard_rows_to_global(
                np.zeros((n,), np.int32), self.mesh, P(AXIS),
            ),
        }

    def spill_evict(self, hmap, frame_idx, spill: dict):
        fn = make_sharded_spill_evict(self.config, self.mesh,
                                      spill["cap"])
        hmap, k, p, c = fn(
            hmap, jnp.int32(frame_idx), spill["keys"],
            spill["payload"], spill["count"],
        )
        spill.update(keys=k, payload=p, count=c)
        return hmap

    def spill_finish(self, spill: dict, store) -> int:
        """Land each LOCAL device's spilled rows into the (per-process)
        store; returns rows dropped to per-device overflow."""
        import numpy as np

        from . import distributed

        counts = distributed.local_rows(spill["count"])
        keys = distributed.local_rows(spill["keys"])
        payload = distributed.local_rows(spill["payload"])
        cap = spill["cap"]
        V = self.config.hash.voxels_per_block
        overflow = 0
        for j, c in enumerate(np.asarray(counts)):
            m = int(min(int(c), cap))
            overflow += max(0, int(c) - cap)
            if m == 0:
                continue
            seg = slice(j * cap, j * cap + m)
            p = payload[seg]
            store.add(keys[seg], p[:, :V], p[:, V : 2 * V],
                      p[:, 2 * V].astype(np.int32))
        return overflow

    def render(self, pose=None) -> rc_ops.RaycastOutput:
        """Live render from an arbitrary viewpoint (defaults to current
        pose) — interface twin of models/hash_slam.HashSLAM.render; the
        output is row-sharded over the mesh (np.asarray /
        distributed.fetch reassembles the full image)."""
        pose = self.state.pose if pose is None else jnp.asarray(pose)
        return make_sharded_render(self.config, self.mesh)(
            self.state.hmap, pose
        )

    def process(self, depth_raw) -> StepInfo:
        if (self.store is not None
                and len(self.trajectory) % self.config.stream.interval
                == 0):
            self._stream_cycle()
        self.state, info = self._step(self.state, jnp.asarray(depth_raw))
        self.trajectory.append(info.pose)
        self.infos.append(info)
        return info
