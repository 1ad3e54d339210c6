"""Voxel-hash SLAM pipeline — the flagship model (BASELINE.json config 2).

Per-frame step, all inside one jitted computation:

    preprocess -> frame-to-model ICP -> hash alloc/compact/integrate
    -> (periodic GC) -> raycast model via the view-local dense cache

This is the reference's full intended system (SDF_Hashtable::integrate per
frame, SDF_Hashtable.cpp:11-40, plus the Align and raycast stages it never
wired together) with unbounded-scene storage via the deterministic hash
table and streaming garbage collection the reference lacked.
"""

from __future__ import annotations

import functools
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import PipelineConfig
from ..geometry import se3
from ..ops import hash_ops
from ..ops import hash_raycast
from ..ops import icp as icp_ops
from ..ops import preprocess as pre_ops
from ..ops import raycast as rc_ops
from ..ops import splat as splat_ops


class HashSLAMState(NamedTuple):
    hmap: hash_ops.HashMap
    pose: jnp.ndarray           # (4, 4) camera-to-world of last frame
    model: pre_ops.Frame        # raycast model maps in last camera frame
    frame_idx: jnp.ndarray      # () int32
    vel: jnp.ndarray            # (4, 4) last tracked frame-to-frame motion


class StepInfo(NamedTuple):
    pose: jnp.ndarray
    icp_error: jnp.ndarray
    icp_count: jnp.ndarray
    icp_iters: jnp.ndarray
    tracked: jnp.ndarray
    blocks_allocated: jnp.ndarray   # this frame
    blocks_active: jnp.ndarray      # visible set size
    blocks_freed: jnp.ndarray       # by GC this frame
    free_blocks: jnp.ndarray        # heap headroom
    valid_px: jnp.ndarray           # valid depth pixels after prefilter


def create(config: PipelineConfig) -> HashSLAMState:
    cam = config.camera
    H, W = cam.height, cam.width
    empty = pre_ops.Frame(
        vertices=jnp.zeros((H, W, 3), dtype=jnp.float32),
        normals=jnp.zeros((H, W, 3), dtype=jnp.float32),
        depth=jnp.zeros((H, W), dtype=jnp.float32),
    )
    return HashSLAMState(
        hmap=hash_ops.create(config.hash),
        pose=se3.identity(),
        model=empty,
        frame_idx=jnp.int32(0),
        vel=se3.identity(),
    )


@partial(jax.jit, static_argnames=("config",))
def step(
    state: HashSLAMState,
    depth_raw: jnp.ndarray,
    config: PipelineConfig,
):
    """One SLAM frame.  depth_raw: (H, W) uint16 in camera units."""
    cam = config.camera
    hcfg = config.hash
    frame = pre_ops.preprocess(depth_raw, cam, config.frontend)

    # --- track (frame-to-model) -------------------------------------------
    # constant-velocity prior: start the GN iteration at last frame's
    # tracked motion instead of identity — what keeps the linearization
    # inside its basin under fast motion (no reference counterpart: the
    # reference re-starts every Align at identity, CameraTracking.cpp:30)
    model_valid = jnp.sum(state.model.depth > 0) > 100
    prior = state.vel if config.icp.use_motion_prior else None
    if len(config.icp.pyramid) > 1:
        result = icp_ops.icp_align_pyramid(
            frame.depth, state.model.depth, cam, config.icp,
            src_full=frame, tgt_full=state.model, prior_T=prior,
        )
    else:
        result = icp_ops.icp_align(frame, state.model, cam, config.icp)
        if prior is not None:
            raced = icp_ops.icp_align(frame, state.model, cam, config.icp,
                                      init_T=prior)
            packed = icp_ops.pack_target(state.model)
            sn, sd = icp_ops.alignment_score_sums(
                raced.transform, frame, state.model, cam, config.icp,
                packed)
            bn, bd = icp_ops.alignment_score_sums(
                result.transform, frame, state.model, cam, config.icp,
                packed)
            result = icp_ops.pick_by_score(
                raced, result,
                sn / jnp.maximum(sd, 1.0), bn / jnp.maximum(bd, 1.0),
            )
    ok = (
        model_valid
        & (result.count > 100)
        & jnp.all(jnp.isfinite(result.transform))
        & icp_ops.motion_plausible(result.transform, config.icp)
    )
    T_rel = jnp.where(ok, result.transform, se3.identity())
    pose_new = se3.compose(state.pose, T_rel)

    # --- periodic garbage collection (before fusion, so the visible set
    # and the splat never reference rows freed this frame) ------------------
    if config.gc.enabled:
        def run_gc(m):
            return hash_ops.garbage_collect(
                m, hcfg, config.gc.min_weight, config.gc.max_blocks_per_gc,
                frame_idx=state.frame_idx, min_age=config.gc.min_age,
            )

        def no_gc(m):
            return m, jnp.int32(0)

        do_gc = (state.frame_idx % config.gc.interval) == (
            config.gc.interval - 1
        )
        hmap, n_freed = jax.lax.cond(do_gc, run_gc, no_gc, state.hmap)
    else:
        hmap, n_freed = state.hmap, jnp.int32(0)

    # --- map update: alloc -> compact -> integrate ------------------------
    hmap, active, n_alloc = hash_ops.fuse_frame(
        hmap, frame, pose_new, cam, hcfg, config.fusion,
        frame_idx=state.frame_idx,
    )

    # --- surface prediction for the next frame's tracking ------------------
    if config.raycast.mode == "splat":
        rc = splat_ops.splat_raycast(
            hmap, active, hcfg, pose_new, cam, config.raycast, config.fusion
        )
    else:
        rc = hash_raycast.raycast_hash(
            hmap,
            active,
            hcfg,
            pose_new,
            cam,
            config.raycast,
            config.fusion,
            cache_dims=config.raycast.cache_dims,
        )
    model = rc_ops.model_frame(rc)

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
        blocks_allocated=n_alloc,
        blocks_active=active.count,
        blocks_freed=n_freed,
        free_blocks=hmap.free_top,
        # rides the keyframe layer's batched drain fetch so the
        # relocalizer's blackout gate needs no extra fetch
        valid_px=jnp.sum(frame.depth > 0).astype(jnp.int32),
    )
    return new_state, info


@functools.lru_cache(maxsize=None)
def make_step(config: PipelineConfig):
    """Jitted step with the state buffers DONATED: the big map arrays
    (tsdf/weight, 100s of MB at production scale) update in place instead
    of being copied every frame.  Callers must drop their reference to the
    passed-in state (the wrappers below reassign it)."""
    return jax.jit(
        lambda s, d: step(s, d, config), donate_argnums=0
    )


@functools.lru_cache(maxsize=None)
def make_scan_step(config: PipelineConfig):
    """Jitted multi-frame step: ``lax.scan`` of ``step`` over a stacked
    (K, H, W) depth chunk, state donated.

    One dispatch per K frames instead of per frame, with bit-identical
    per-frame results (tests/test_stream.py).  Async per-frame dispatches
    already pipeline and hide their dispatch cost, so this helps when
    dispatch cannot pipeline (synchronous hosts) and for deterministic
    batch replay; bench.py reports both modes.  Returns (state, StepInfo
    stacked along axis 0).
    """

    def chunk(state, depths):
        return jax.lax.scan(
            lambda s, d: step(s, d, config), state, depths
        )

    return jax.jit(chunk, donate_argnums=0)


@functools.lru_cache(maxsize=None)
def make_evict(config: PipelineConfig):
    """Jitted eviction scan (state donated): pops blocks unseen for
    stream.max_age frames out of the map.

    Returns (map, keys, payload [tsdf | weight | born], sync) where
    ``sync`` is ONE small packed array
    ``[n_evicted, pose(16), vel(16), accepted_prev(max_restore)]`` — the
    streaming cycle's single blocking fetch.  Folding the pose/velocity
    (for the next restore's frustum prediction) and the previous
    restore's accepted mask into the eviction count fetch takes the
    cycle from 3 blocking fetches to 1.  The payload stays ON DEVICE so
    the host can pull a bucket-sized slice after reading ``n`` —
    fetching the full padded batch would move ~8 MB per evict cycle
    regardless of how few blocks evicted."""
    s = config.stream

    def evict(hmap, frame_idx, pose, vel, accepted_prev):
        hmap, keys, tsdf, weight, born, n = hash_ops.evict_stale(
            hmap, config.hash, frame_idx, s.max_age, s.max_evict
        )
        # born rides as a float column (exact for frame counts < 2^24)
        payload = jnp.concatenate(
            [tsdf, weight, born.astype(jnp.float32)[:, None]], axis=1
        )
        sync = jnp.concatenate([
            n.astype(jnp.float32)[None],
            pose.reshape(16),
            vel.reshape(16),
            accepted_prev.astype(jnp.float32),
        ])
        return hmap, keys, payload, sync

    return jax.jit(evict, donate_argnums=0)


@functools.lru_cache(maxsize=None)
def make_restore(config: PipelineConfig, batch: int):
    """Jitted restore for a ``batch``-sized padded upload (state donated):
    re-inserts stored blocks with their payload; returns (map, accepted)
    with ``accepted`` padded to a FIXED (max_restore,) shape so the next
    eviction cycle can fold it into its packed sync fetch regardless of
    which bucket produced it.  Compiled per power-of-two bucket so a
    handful of restored blocks does not cost a full max_restore-sized
    host->device transfer, and the whole batch arrives as ONE packed
    array [keys-bits | tsdf | weight | born] — each separate
    host->device upload pays a fixed per-transfer cost.  ``born`` restores
    each row's original allocation stamp (de-integration across
    streaming stays exact up to the residency caveat in
    ops/hash_ops.restore_blocks)."""
    V = config.hash.voxels_per_block
    R = config.stream.max_restore

    def restore(hmap, packed, frame_idx):
        keys = jax.lax.bitcast_convert_type(packed[:, 0], jnp.int32)
        tsdf = packed[:, 1 : 1 + V]
        weight = packed[:, 1 + V : 1 + 2 * V]
        born = packed[:, 1 + 2 * V].astype(jnp.int32)
        hmap, accepted = hash_ops.restore_blocks(
            hmap, config.hash, keys, tsdf, weight, frame_idx,
            max_weight=config.fusion.max_weight, born_rows=born,
        )
        acc_full = jnp.zeros((R,), dtype=bool)
        acc_full = jax.lax.dynamic_update_slice(
            acc_full, accepted[: min(batch, R)], (0,)
        )
        return hmap, acc_full

    return jax.jit(restore, donate_argnums=0)


@functools.lru_cache(maxsize=None)
def make_spill_evict(config: PipelineConfig, cap: int):
    """Jitted evict-and-append into a device-side SPILL buffer (map and
    spill donated).

    The streaming map rebuild (keyframe backend) evicts after every
    keyframe fuse; pulling each batch host-side separately would block
    once per keyframe.  Appending each round's evictions into a ``cap``-row device buffer instead makes the
    whole rebuild ONE pull (models/keyframe_slam._rebuild_map).  Rows
    beyond ``cap`` are dropped; the returned count keeps growing so the
    caller can detect and surface the overflow."""
    s = config.stream

    def evict_append(hmap, frame_idx, spill_keys, spill_payload, count):
        hmap, keys, tsdf, weight, born, n = hash_ops.evict_stale(
            hmap, config.hash, frame_idx, s.max_age, s.max_evict
        )
        payload = jnp.concatenate(
            [tsdf, weight, born.astype(jnp.float32)[:, None]], axis=1
        )
        pos = jnp.arange(keys.shape[0], dtype=jnp.int32)
        idx = jnp.where(pos < n, count + pos, cap)
        spill_keys = spill_keys.at[idx].set(keys, mode="drop")
        spill_payload = spill_payload.at[idx].set(payload, mode="drop")
        return hmap, spill_keys, spill_payload, count + n

    return jax.jit(evict_append, donate_argnums=(0, 2, 3))


@functools.lru_cache(maxsize=None)
def make_spill_head(config: PipelineConfig, cap: int):
    """Jitted D2H pack of a spill buffer's [count | keys-bits]: one
    32 KB-class transfer instead of two blocking pulls (the count fetch
    that sizes the payload bucket and a separate keys fetch)."""

    def head(count, keys):
        return jnp.concatenate([
            count[None].astype(jnp.float32),
            jax.lax.bitcast_convert_type(keys, jnp.float32),
        ])

    return jax.jit(head)


@functools.lru_cache(maxsize=None)
def make_pull(config: PipelineConfig, batch: int):
    """Jitted D2H pack for the streaming cycle: concatenates the sync
    record with a ``batch``-row evicted payload (keys as float32 bit
    patterns) so both ride ONE device->host transfer: each D2H transfer
    has a fixed cost regardless of size, so the cycle keeps the count of
    transfers down."""

    def pull(sync, keys, payload):
        return jnp.concatenate([
            sync,
            jax.lax.bitcast_convert_type(keys, jnp.float32),
            payload.reshape(-1),
        ])

    return jax.jit(pull)


def _bucket(n: int, cap: int, floor: int = 1) -> int:
    """Smallest power of two >= n, floored and capped.

    The floor bounds how many distinct batch shapes (= jit compiles) a
    run can produce: padding a restore batch up to 256 rows costs little
    transfer, while each extra bucket shape costs a mid-run compile."""
    b = max(1, floor)
    while b < n:
        b *= 2
    return min(b, cap)


class HashSLAM:
    """Host-side convenience wrapper accumulating the trajectory.

    With ``config.stream.enabled`` the wrapper also runs the out-of-core
    streaming loop around the jitted step, PIPELINED so the device never
    waits on the host.  Each ``stream.interval``-frame cycle is split so
    its one blocking transfer overlaps step execution (H2D uploads are
    dispatched asynchronously; D2H transfers happen at fetch time):

    - at the interval boundary, ``_cycle_dispatch`` enqueues device work
      only: the restore of the batch uploaded LAST cycle, the eviction
      scan, and a packed pull that concatenates the cycle's sync record
      [n_evicted | pose | vel | accepted] with the PREVIOUS cycle's
      evicted payload — one D2H transfer instead of three;
    - half an interval later, ``_cycle_complete`` fetches that one
      array (its transfer rides alongside the in-flight steps), lands
      the payload in the BlockStore, takes the accepted restore keys,
      and queries + uploads the NEXT restore batch at the
      constant-velocity-predicted frustum — giving the upload the
      remaining half interval to ship before its restore dispatches.
    """

    def __init__(self, config: PipelineConfig):
        self.config = config
        self.state = create(config)
        self._step = make_step(config)
        self._scan_step = None  # built lazily by process_chunk
        self.trajectory = []
        self.infos = []
        self.store = None
        if config.stream.enabled:
            from ..utils.blockstore import BlockStore

            self.store = BlockStore(config.hash)
            self._evict = make_evict(config)
            self._restore_jits = {}   # bucket size -> jit
            self._init_stream_runtime()

    def _init_stream_runtime(self) -> None:
        """Pipelining state for the streaming cycle (also called by the
        checkpoint loaders, which construct via ``__new__``)."""
        import concurrent.futures

        # (keys_np, packed_device_array, bucket): restore queried+uploaded
        # last cycle, dispatched next cycle
        self._prefetch = None
        # (keys_dev, payload_dev, bucket): evicted last cycle, pulled as
        # part of the next cycle's combined fetch
        self._pending_evict = None
        # (combined_dev, taken_keys, prev_bucket, keys_dev, payload_dev):
        # dispatched at the boundary, fetched by the completion worker
        self._inflight = None
        # single worker running _complete_work off the dispatch thread:
        # the combined fetch blocks until the device reaches it, and a
        # blocked host thread cannot dispatch the interval's remaining
        # steps — the device would run dry.  The cycle protocol serializes all
        # store/prefetch access: the worker is joined before any other
        # streaming-state use (_join_complete).
        self._stream_worker = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="stream-complete"
        )
        self._completing = None   # in-flight Future from the worker
        self._zero_accept = jnp.zeros(
            (self.config.stream.max_restore,), dtype=bool
        )

    def _restore_for(self, batch: int):
        if batch not in self._restore_jits:
            self._restore_jits[batch] = make_restore(self.config, batch)
        return self._restore_jits[batch]

    def _pack_restore(self, keys):
        """Build the packed [keys-bits | tsdf | weight | born] upload for
        the given stored keys.  Returns (packed_np, bucket)."""
        import numpy as np

        s = self.config.stream
        tsdf, weight, born = self.store.rows_for(keys)
        # pad only to the bucket size (uploading the full max_restore
        # padding cost ~8 MB host->device per cycle) and pack keys +
        # payload into ONE upload; the 256 floor bounds compile variety
        b = _bucket(keys.shape[0], s.max_restore, floor=256)
        from ..geometry.coords import EMPTY_KEY

        V = self.config.hash.voxels_per_block
        packed = np.zeros((b, 2 + 2 * V), np.float32)
        packed[:, 0] = np.full(b, EMPTY_KEY, np.int32).view(np.float32)
        m = keys.shape[0]
        packed[:m, 0] = keys.view(np.float32)
        packed[:m, 1 : 1 + V] = tsdf
        packed[:m, 1 + V : 1 + 2 * V] = weight
        packed[:m, 1 + 2 * V] = born.astype(np.float32)
        return packed, b

    def _join_complete(self) -> None:
        """Wait for the completion worker (re-raising its exceptions);
        afterward _prefetch/_pending_evict/store are current."""
        if self._completing is not None:
            f = self._completing
            self._completing = None
            f.result()

    def stream_sync(self) -> None:
        """Quiesce the streaming pipeline: complete any in-flight cycle,
        dispatch any prefetched restore (taking its accepted keys out of
        the store), and land any un-pulled evicted payload.  Callers
        that swap the store, snapshot it (checkpointing), or need the
        device map fully current (incremental reintegration) must run
        this first."""
        import numpy as np

        if self.store is None:
            return
        self._cycle_complete()
        self._join_complete()
        if self._prefetch is not None:
            keys, packed_dev, b = self._prefetch
            self._prefetch = None
            hmap, accepted = self._restore_for(b)(
                self.state.hmap, packed_dev, self.state.frame_idx,
            )
            self.state = self.state._replace(hmap=hmap)
            self.store.take(keys, np.asarray(accepted)[: keys.shape[0]])
        if self._pending_evict is not None:
            keys_dev, payload_dev, b = self._pending_evict
            self._pending_evict = None
            V = self.config.hash.voxels_per_block
            arr = np.asarray(payload_dev)
            self.store.add(np.asarray(keys_dev), arr[:, :V],
                           arr[:, V : 2 * V],
                           arr[:, 2 * V].astype(np.int32))

    def warm_stream(self) -> None:
        """Compile every jit the streaming cycle can reach — the evict
        scan, the restore at every bucket size the 256 floor admits, and
        the pull packer at every evict bucket the 128 floor admits —
        against scratch state (this instance's map/store are untouched).

        The public warm-up path for benchmarks/latency-sensitive
        callers (twin of KeyframeSLAM.warm_compile): a cold restore
        compile costs seconds, and a short warm-up sweep never triggers a
        restore (eviction age gating), so without this the compile lands
        mid-measurement."""
        import numpy as np

        if self.store is None:
            return
        from ..geometry.coords import EMPTY_KEY
        from ..ops import hash_ops as _hash_ops

        s = self.config.stream
        V = self.config.hash.voxels_per_block
        I = jnp.eye(4, dtype=jnp.float32)
        hm = _hash_ops.create(self.config.hash)
        hm, keys_e, payload, sync = self._evict(
            hm, jnp.int32(0), I, I, self._zero_accept
        )
        b = _bucket(1, s.max_restore, floor=256)
        while True:
            packed = np.zeros((b, 2 + 2 * V), np.float32)
            packed[:, 0] = np.full(b, EMPTY_KEY, np.int32).view(
                np.float32
            )
            hm, acc = self._restore_for(b)(
                hm, jnp.asarray(packed), jnp.int32(0)
            )
            if b >= s.max_restore:
                break
            b *= 2
        b = _bucket(1, s.max_evict, floor=128)
        while True:
            out = make_pull(self.config, b)(
                sync, keys_e[:b], payload[:b]
            )
            if b >= s.max_evict:
                break
            b *= 2
        # rebuild spill path (the keyframe backend's streaming rebuild),
        # including the [count | keys] head pull spill_finish opens with
        spill = self.spill_begin()
        hm = self.spill_evict(hm, 0, spill)
        head = make_spill_head(self.config, spill["cap"])(
            spill["count"], spill["keys"]
        )
        # one scalar fetch waits for the whole compile+execute chain
        _ = float(np.asarray(out.ravel()[0]))
        _ = float(np.asarray(acc.ravel()[0]))
        _ = float(np.asarray(head[0]))
        del hm, keys_e, payload, spill

    def _cycle_dispatch(self) -> None:
        """Interval-boundary half of the streaming cycle: device
        dispatches only (plus joining the previous cycle's completion
        worker, normally long done)."""
        self._join_complete()
        st = self.state
        # dispatch the restore prepared last cycle (its packed payload
        # has been shipping host->device since mid-interval)
        acc = self._zero_accept
        taken_keys = None
        if self._prefetch is not None:
            keys, packed_dev, b = self._prefetch
            self._prefetch = None
            hmap, acc = self._restore_for(b)(
                st.hmap, packed_dev, st.frame_idx
            )
            st = st._replace(hmap=hmap)
            taken_keys = keys
        # evict; the packed sync record rides out with it
        hmap, keys_e, payload, sync = self._evict(
            st.hmap, st.frame_idx, st.pose, st.vel, acc
        )
        self.state = st._replace(hmap=hmap)
        # pack last cycle's evicted payload INTO the sync pull: one D2H
        # transfer carries both (the transfer's fixed cost dominates)
        pend = self._pending_evict
        self._pending_evict = None
        if pend is not None:
            pk, pp, pb = pend
            combined = make_pull(self.config, pb)(sync, pk, pp)
        else:
            pb = 0
            combined = sync
        self._inflight = (combined, taken_keys, pb, keys_e, payload)

    def _cycle_complete(self, horizon: int | None = None) -> None:
        """Mid-interval half of the streaming cycle, handed to the
        completion worker so the fetch's transfer never blocks step
        dispatch: the ONE blocking fetch, host store bookkeeping, and
        the next restore batch's query + upload.  ``horizon``: frames
        ahead of the boundary pose to predict the next restore frustum
        (default 2x interval)."""
        if self._inflight is None:
            return
        inflight = self._inflight
        self._inflight = None
        self._join_complete()   # never two completions in flight
        self._completing = self._stream_worker.submit(
            self._complete_work, inflight, horizon
        )

    def _complete_work(self, inflight, horizon: int | None) -> None:
        """Completion-worker body (see _cycle_complete).  Runs off the
        dispatch thread; only touches streaming state the cycle protocol
        serializes behind _join_complete."""
        import numpy as np

        combined, taken_keys, pb, keys_e, payload = inflight
        s = self.config.stream
        V = self.config.hash.voxels_per_block
        S = 33 + s.max_restore
        arr = np.asarray(combined)
        n = int(arr[0])
        pose = arr[1:17].reshape(4, 4)
        vel = arr[17:33].reshape(4, 4)
        if taken_keys is not None:
            self.store.take(
                taken_keys, arr[33 : 33 + taken_keys.shape[0]] > 0.5
            )
        if pb:
            # decode the appended payload (keys travel as raw float32
            # bit patterns; the D2H path preserves them bit-exactly —
            # tests/test_streaming.py::test_pull_roundtrip)
            keys_np = arr[S : S + pb].view(np.int32)
            pay = arr[S + pb : S + pb + pb * (2 * V + 1)].reshape(
                pb, 2 * V + 1
            )
            self.store.add(keys_np, pay[:, :V], pay[:, V : 2 * V],
                           pay[:, 2 * V].astype(np.int32))
        # keep this cycle's evicted payload for the NEXT cycle's pull
        # (the blocks are off-map either way, and store.add/restore
        # merge safely if the camera re-observes them in the gap).  The
        # 128 floor bounds pull-jit shape variety, like the restore's
        # 256 floor (transfer cost is dominated by the fixed per-call
        # cost, so the extra padded rows are free)
        if n > 0:
            b = _bucket(n, s.max_evict, floor=128)
            self._pending_evict = (keys_e[:b], payload[:b], b)
        # query + upload the NEXT cycle's restore batch: frustum at the
        # constant-velocity pose ``horizon`` frames ahead of the
        # boundary (the restore dispatches one interval after the
        # boundary, covering the interval beyond; margin + max_age
        # absorb prediction slack, and the upload gets the remaining
        # half interval to ship)
        if len(self.store):
            hor = 2 * s.interval if horizon is None else horizon
            pred = pose @ np.linalg.matrix_power(vel, hor)
            keys = self.store.query_frustum(
                pred, self.config.camera, self.config.fusion,
                s.restore_margin_px, s.max_restore,
            )
            if keys.size:
                packed, b = self._pack_restore(keys)
                self._prefetch = (keys, jnp.asarray(packed), b)

    def _restore_keys(self, keys) -> None:
        """Synchronously restore the given stored keys onto the device
        (ONE packed upload); used by the keyframe backend's incremental
        reintegration (which must pull a moved frame's frustums back
        on-device before de-integrating).  Quiesces the streaming
        pipeline first so the map and store are current."""
        import numpy as np

        # the sync may dispatch a prefetched restore that TAKES some of
        # the requested keys out of the store (they are on-device now,
        # which is what the caller wanted) — drop them from the batch
        self.stream_sync()
        if keys.size:
            keys = keys[np.fromiter(
                (int(k) in self.store._index for k in keys),
                bool, keys.shape[0],
            )]
        if keys.size == 0:
            return
        packed, b = self._pack_restore(keys)
        hmap, accepted = self._restore_for(b)(
            self.state.hmap, jnp.asarray(packed), self.state.frame_idx,
        )
        self.state = self.state._replace(hmap=hmap)
        self.store.take(keys, np.asarray(accepted)[: keys.shape[0]])

    def _evict_into(self, hmap, frame_idx, store):
        """Run the eviction jit and move the evicted payload into
        ``store`` (bucket-sized device pull), synchronously.  Used by the
        keyframe backend's map rebuild (which streams a fresh map into a
        fresh store)."""
        import numpy as np

        hmap, keys, payload, sync = self._evict(
            hmap, frame_idx,
            jnp.eye(4, dtype=jnp.float32), jnp.eye(4, dtype=jnp.float32),
            self._zero_accept,
        )
        n = int(np.asarray(sync[0]))
        if n > 0:
            # pull only a bucket-sized slice of the padded payload
            b = _bucket(n, self.config.stream.max_evict)
            V = self.config.hash.voxels_per_block
            arr = np.asarray(payload[:b])
            store.add(np.asarray(keys[:b]), arr[:, :V],
                      arr[:, V : 2 * V],
                      arr[:, 2 * V].astype(np.int32))
        return hmap

    # -- rebuild spill session (keyframe backend's streaming map rebuild) --

    def spill_begin(self) -> dict:
        """Fresh device spill buffer for a streaming map rebuild: evicted
        rows accumulate ON DEVICE across the rebuild's per-keyframe
        evictions and land in the host store with ONE pull
        (``spill_finish``) instead of one blocking pull per round."""
        from ..geometry.coords import EMPTY_KEY

        cap = 4 * self.config.hash.num_blocks
        V = self.config.hash.voxels_per_block
        return {
            "cap": cap,
            "keys": jnp.full((cap,), EMPTY_KEY, jnp.int32),
            "payload": jnp.zeros((cap, 2 * V + 1), jnp.float32),
            "count": jnp.int32(0),
        }

    def spill_evict(self, hmap, frame_idx, spill: dict):
        """Evict stale blocks from ``hmap`` into the spill buffer
        (device dispatch only, no host sync)."""
        fn = make_spill_evict(self.config, spill["cap"])
        hmap, k, p, c = fn(
            hmap, jnp.int32(frame_idx), spill["keys"],
            spill["payload"], spill["count"],
        )
        spill.update(keys=k, payload=p, count=c)
        return hmap

    def spill_finish(self, spill: dict, store) -> int:
        """Pull the spill buffer into ``store``.  Two transfers: a
        32 KB-class [count | keys] head (which also drains the rebuild's
        queued fuse/evict dispatches) sizes the payload bucket, then the
        payload rows ride one sized pull.  Returns the number of rows
        DROPPED to buffer overflow (0 normally; the caller surfaces it,
        never silent)."""
        import numpy as np

        head = np.asarray(make_spill_head(self.config, spill["cap"])(
            spill["count"], spill["keys"]
        ))
        n = int(head[0])
        if n == 0:
            return 0
        cap = spill["cap"]
        keys_np = head[1:].view(np.int32)
        b = _bucket(min(n, cap), cap)
        V = self.config.hash.voxels_per_block
        arr = np.asarray(spill["payload"][:b])
        store.add(keys_np[:b], arr[:, :V],
                  arr[:, V : 2 * V], arr[:, 2 * V].astype(np.int32))
        return max(0, n - cap)

    def spill_finish_async(self, spill: dict, store, on_overflow=None):
        """Land the spill buffer into ``store`` on the streaming
        completion worker instead of blocking the caller — the payload
        pull is the rebuild's largest transfer, and nothing downstream
        of a rebuild
        needs the HOST copy immediately: the device map is already
        rebuilt and the caller may swap ``store`` in as the live store
        right away.  Every consumer that touches the store first goes
        through ``stream_sync``/``_join_complete`` (cycle boundaries,
        checkpointing, incremental reintegration, accounting), all of
        which join this work — same serialization contract as the cycle
        completion itself.  ``on_overflow`` (optional) is invoked from
        the worker with the dropped-row count if the buffer overflowed."""
        self._join_complete()

        def work():
            overflow = self.spill_finish(spill, store)
            if overflow and on_overflow is not None:
                on_overflow(overflow)

        self._completing = self._stream_worker.submit(work)

    def process(self, depth_raw) -> StepInfo:
        if self.store is not None:
            s = self.config.stream
            i = len(self.trajectory) % s.interval
            if i == 0:
                # catch-up completion guards short intervals + partial
                # intervals after process_chunk (no-op when already done)
                self._cycle_complete()
                self._cycle_dispatch()
            elif i == max(s.interval // 2, 1):
                self._cycle_complete()
        self.state, info = self._step(self.state, jnp.asarray(depth_raw))
        self.trajectory.append(info.pose)
        self.infos.append(info)
        return info

    def process_chunk(self, depths_raw) -> StepInfo:
        """Process a stacked (K, H, W) chunk of frames in ONE device
        dispatch (jitted ``lax.scan``); per-frame results are identical to
        K ``process`` calls.  Returns the stacked StepInfo.

        With streaming enabled, one streaming cycle runs at each chunk
        boundary (the in-chunk frames share one restore prediction,
        looking a full chunk + interval ahead); the cycle completes at
        the next boundary, so its fetch overlaps the chunk's scan."""
        depths_raw = jnp.asarray(depths_raw)
        if self.store is not None:
            k = int(depths_raw.shape[0])
            self._cycle_complete(
                horizon=k + self.config.stream.interval
            )
            self._cycle_dispatch()
        if self._scan_step is None:
            self._scan_step = make_scan_step(self.config)
        self.state, infos = self._scan_step(self.state, depths_raw)
        k = int(infos.pose.shape[0])
        for i in range(k):
            self.trajectory.append(infos.pose[i])
            self.infos.append(jax.tree.map(lambda x, i=i: x[i], infos))
        return infos

    def render(self, pose=None) -> rc_ops.RaycastOutput:
        """Render from an arbitrary viewpoint (defaults to current pose),
        honoring the configured surface-prediction mode."""
        pose = self.state.pose if pose is None else jnp.asarray(pose)
        active = hash_ops.compact_visible(
            self.state.hmap, self.config.hash, pose, self.config.camera,
            self.config.fusion,
        )
        if self.config.raycast.mode == "splat":
            return splat_ops.splat_raycast(
                self.state.hmap, active, self.config.hash, pose,
                self.config.camera, self.config.raycast, self.config.fusion,
            )
        return hash_raycast.raycast_hash(
            self.state.hmap, active, self.config.hash, pose,
            self.config.camera, self.config.raycast, self.config.fusion,
            cache_dims=self.config.raycast.cache_dims,
        )
