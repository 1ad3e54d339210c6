"""Keyframe SLAM: voxel-hash frame-to-model tracking + pose graph BA.

The reference tracks frame-to-frame with no global backend of any kind —
its drift is unbounded and loop closure is impossible (SURVEY.md §5; the
whole tracking stack is CameraTracking.cpp:26-69).  This model composes the
flagship HashSLAM pipeline with the missing backend:

- **Keyframe selection** by relative-motion thresholds.
- **Odometry edges** between consecutive keyframes, refined by an ICP run
  on the stored (downsampled) keyframe depth pairs.
- **Loop-closure edges**: older keyframes within ``loop_radius`` are
  re-registered by ICP (initialized from the current estimates) and, if the
  registration passes the inlier/error/OBSERVABILITY gates
  (ops/icp.observability — sliding-degenerate solves have a near-null
  normal-matrix direction), constrain the graph.
- **Pose graph optimization** (ops/pose_graph.py, IRLS robust kernels)
  whenever a loop edge is accepted; the correction is propagated to the
  live tracking pose, every non-keyframe pose is stored *relative to its
  keyframe* so the whole trajectory is corrected retroactively, and the
  map follows: full rebuild on the first significant correction, exact
  de-integrate/re-integrate of only MOVED keyframes after
  (hash_ops.defuse_frame).
- **Tracking-lost recovery**: after a streak of motion-gate failures the
  live frame re-registers against stored keyframes and the pose + model
  reset (the role of the reference's dead rigidAlignment fallback).

Host/device split, designed so a blocking fetch never stalls dispatch
pipelining: the jitted pipeline step dispatches immediately per frame,
while the host-side bookkeeping (keyframe decisions, refs, lost-streak)
drains every ``sync_every`` frames from ONE batched pose fetch, against
host mirrors of the graph.  All candidate registrations (odometry +
loops, relocalization) run as one vmapped ICP dispatch + one fetch; every
multi-op host-side chain is jitted (an eager chain pays one dispatch per
op).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PipelineConfig
from ..geometry import se3
from ..ops import hash_ops
from ..ops import icp as icp_ops
from ..ops import pose_graph
from ..ops import preprocess as pre_ops
from ..ops import raycast as rc_ops
from . import hash_slam


@functools.lru_cache(maxsize=None)
def make_fuse_only(config: PipelineConfig):
    """Jitted fuse-only step (no tracking): integrate one raw depth frame
    at a GIVEN pose.  Used to rebuild the map from stored keyframe depths
    after a BA correction.

    Config-memoized (configs are frozen/hashable): every KeyframeSLAM
    instance with the same config shares ONE jit object, so a warm-up
    instance's compiles (``warm_compile``) carry over to the measured
    instance instead of recompiling per instance."""

    def fuse(hmap, depth_raw, pose, frame_idx):
        frame = pre_ops.preprocess(depth_raw, config.camera, config.frontend)
        hmap, _, _ = hash_ops.fuse_frame(
            hmap, frame, pose, config.camera, config.hash, config.fusion,
            frame_idx=frame_idx,
        )
        return hmap

    return jax.jit(fuse, donate_argnums=0)


@functools.lru_cache(maxsize=None)
def make_reintegrate(config: PipelineConfig):
    """Jitted de-integrate-at-old-pose + re-integrate-at-new-pose of one
    stored frame depth (state donated).  Both passes are gated to rows
    that existed when the frame was originally fused (born <=
    ``frame_born``, see ops/hash_ops.HashMap.born) and allocate nothing,
    so repeated incremental corrections stay self-consistent.  Returns
    (map, max visible-set count): a count at max_active means the frustum
    compaction truncated and the move was not exact — the caller surfaces
    it (never silent)."""

    def reint(hmap, depth_raw, T_old, T_new, frame_born):
        frame = pre_ops.preprocess(depth_raw, config.camera,
                                   config.frontend)
        a_old = hash_ops.compact_visible(
            hmap, config.hash, T_old, config.camera, config.fusion
        )
        hmap = hash_ops.integrate(
            hmap, a_old, config.hash, frame.depth, T_old, config.camera,
            config.fusion, sign=-1, max_born=jnp.int32(frame_born),
        )
        a_new = hash_ops.compact_visible(
            hmap, config.hash, T_new, config.camera, config.fusion
        )
        hmap = hash_ops.integrate(
            hmap, a_new, config.hash, frame.depth, T_new, config.camera,
            config.fusion, max_born=jnp.int32(frame_born),
        )
        return hmap, jnp.maximum(a_old.count, a_new.count)

    return jax.jit(reint, donate_argnums=0)


@functools.lru_cache(maxsize=None)
def make_render_model(config: PipelineConfig):
    """Jitted surface prediction at an arbitrary pose (the model Frame the
    next tracking step needs after a map rebuild).  Config-memoized."""
    from ..ops import hash_raycast, splat as splat_ops

    def render(hmap, pose):
        active = hash_ops.compact_visible(
            hmap, config.hash, pose, config.camera, config.fusion
        )
        if config.raycast.mode == "splat":
            rc = splat_ops.splat_raycast(
                hmap, active, config.hash, pose, config.camera,
                config.raycast, config.fusion,
            )
        else:
            rc = hash_raycast.raycast_hash(
                hmap, active, config.hash, pose, config.camera,
                config.raycast, config.fusion,
                cache_dims=config.raycast.cache_dims,
            )
        return rc_ops.model_frame(rc)

    return jax.jit(render)


@functools.lru_cache(maxsize=None)
def _make_batch_icps(lcam, icp_config, loop_icp_max_iters: int):
    """(fwd, rev) vmapped candidate-ICP jits at the keyframe resolution.
    Memoized on (camera, icp config, iter cap) — hashable frozen
    dataclasses — so every instance with the same config shares them."""
    import dataclasses as _dc

    icfg = _dc.replace(icp_config, max_iters=loop_icp_max_iters)

    def pack(res):
        return jnp.concatenate(
            [res.transform.reshape(-1, 16),
             res.error[:, None], res.count[:, None],
             icp_ops.observability(res)[:, None]], axis=1
        )

    def stack(frames):
        # tuple-of-Frames -> stacked Frame, INSIDE the jit (an eager
        # per-array stack is a dispatch each)
        return jax.tree.map(lambda *xs: jnp.stack(xs), *frames)

    def fwd(src, frames, inits):
        return pack(jax.vmap(
            lambda t, i: icp_ops.icp_align(src, t, lcam, icfg, init_T=i)
        )(stack(frames), inits))

    def rev(frames, tgt, inits):
        return pack(jax.vmap(
            lambda s, i: icp_ops.icp_align(s, tgt, lcam, icfg, init_T=i)
        )(stack(frames), inits))

    return jax.jit(fwd), jax.jit(rev)


@functools.lru_cache(maxsize=None)
def _make_batch_procrustes(lcam, icp_config, rounds: int):
    """Closed-form Procrustes initializer over a padded candidate batch
    (one dispatch for all relocalization candidates).  Zero-pad frames
    solve to identity (total weight 0).

    The candidate axis runs as ``lax.map`` with batch_size 4 rather than
    one vmap over all candidates: a batch of 4 candidates x 7 yaw
    hypotheses bounds the fused program's width and its working set,
    and the relocalizer only runs while tracking is lost.  Whether one
    wide vmap is faster on the GPU is an open measurement."""
    from ..geometry import procrustes as proc

    def inits(src, frames):
        stackf = jax.tree.map(lambda *xs: jnp.stack(xs), *frames)
        return jax.lax.map(
            lambda t: proc.procrustes_init_raced(src, t, lcam, icp_config,
                                                 rounds=rounds),
            stackf, batch_size=4,
        )

    return jax.jit(inits)


@functools.lru_cache(maxsize=None)
def _make_kf_pre(cam, frontend, downsample: int, lcam):
    """Jitted preprocess + downsample for keyframe insertion (memoized;
    the eager chain would cost ~100 dispatches)."""

    def kf_pre(depth_raw):
        frame = pre_ops.preprocess(depth_raw, cam, frontend)
        if downsample == 1:
            return frame
        d = pre_ops.downsample_depth(frame.depth, downsample)
        return pre_ops.preprocess_metric(d, lcam)

    return jax.jit(kf_pre)


def _make_laps():
    """Wall-clock lap recorder shared by the insert/rebuild telemetry:
    returns ``(laps, lap)`` where ``lap(name)`` accumulates the time
    since the previous lap into ``laps[name]`` (repeat names add up)."""
    import time as _time

    laps = {}
    state = {"t": _time.perf_counter()}

    def lap(name):
        now = _time.perf_counter()
        laps[name] = round(laps.get(name, 0.0) + (now - state["t"]), 4)
        state["t"] = now

    return laps, lap


@functools.lru_cache(maxsize=None)
def _ba_pack(K: int):
    """Jitted fixed-shape pack of a BA solve's outputs — full (K, 4, 4)
    poses + chi2 pair — so ONE transfer (and one compiled op shape,
    keyed by the graph capacity only) serves every post-solve fetch; see
    KeyframeSLAM._fetch_ba for the motivation."""

    def pack(poses, c0, c1):
        return jnp.concatenate(
            [poses.reshape(-1), jnp.stack([c0, c1])]
        )

    return jax.jit(pack)


def _rot_deg_np(T: np.ndarray) -> float:
    """Rotation angle of a 4x4 (or 3x3) transform, degrees, pure numpy."""
    c = (float(np.trace(np.asarray(T)[:3, :3])) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


@dataclass
class _KeyframeRecord:
    index: int                 # keyframe id == pose index in the graph
    frame_index: int           # global frame number
    frame: pre_ops.Frame       # downsampled preprocessed frame (for ICP)
    # raw uint16 depth on the HOST — only checkpointing needs it, and the
    # device->host pull is a blocking 600 KB fetch per keyframe, so it is
    # materialized lazily (depth_np) instead of at insertion time
    depth_raw: np.ndarray = None
    # device-resident copy: rebuild/reintegration re-fuse keyframe depths
    # repeatedly, and a host->device upload per use would cost a transfer
    # every BA correction
    depth_dev: jnp.ndarray = None
    # ledger: the pose at which this keyframe's contribution currently
    # sits in the TSDF (set by a full rebuild, updated by incremental
    # reintegration; None = not individually tracked in the map)
    map_pose: np.ndarray = None

    def depth_np(self) -> np.ndarray:
        if self.depth_raw is None:
            self.depth_raw = np.asarray(self.depth_dev).astype(np.uint16)
        return self.depth_raw


@dataclass
class _RingEntry:
    """One live-fused frame in the post-rebuild contribution ledger: the
    TSDF holds its samples at ``map_pose`` (the pose the jitted step
    actually fused at — which may differ from the corrected trajectory
    pose when a BA correction or relocalization landed after dispatch);
    its corrected pose is always ``graph_pose[kf] @ rel``."""

    frame_index: int
    kf: int                    # reference keyframe id
    rel: np.ndarray            # pose relative to that keyframe
    depth: jnp.ndarray         # device uint16 depth
    map_pose: np.ndarray       # where its contribution currently sits


class KeyframeSLAM:
    """Host-side orchestrator around the jitted pipeline + BA.

    Pass a ``jax.sharding.Mesh`` to run the frontend on the sharded
    multi-chip pipeline (parallel/sharded.py) and the backend through the
    edge-sharded distributed BA — same keyframe logic either way.
    """

    def __init__(self, config: PipelineConfig, mesh=None):
        self.config = config
        self.kcfg = config.keyframes
        self.mesh = mesh
        if mesh is None:
            # wrap the full HashSLAM driver: the keyframe layer composes
            # with everything it provides (incl. out-of-core streaming,
            # the BASELINE config-5 multi-room regime)
            self._inner = hash_slam.HashSLAM(config)
        else:
            from ..parallel import sharded as sharded_mod

            self._sharded = sharded_mod.ShardedHashSLAM(config, mesh)
        self.graph = pose_graph.create(
            self.kcfg.max_keyframes, self.kcfg.max_edges
        )
        self._init_runtime_state()

    def _init_runtime_state(self) -> None:
        """Fresh bookkeeping + lazy-jit state.  Shared by ``__init__`` and
        ``checkpoint.load_keyframe_slam`` (which constructs via __new__) so
        the two can never drift apart; requires config/kcfg/graph set."""
        self.keyframes: List[_KeyframeRecord] = []
        # per-frame: (keyframe id, relative pose in that keyframe's frame)
        self._frame_refs: List[tuple] = []
        self.infos = []
        self.ba_events = []
        self._last_rebuild_detail = None
        # per-insert wall-clock laps (pre/cand/fwd/rev) — the backend's
        # in-loop hitch budget lives in these
        self._kf_insert_s: List[dict] = []
        # deferred keyframe candidate batches (kcfg.kf_async_edges):
        # dispatched at insert, landed by _complete_kf_edges
        self._kf_pending: List[dict] = []
        # graph capacity growth / saturation record (never silent).
        # With kcfg.grow_on_capacity the graph
        # doubles on demand and ``saturated`` stays False; without it,
        # hitting capacity sets ``saturated`` and logs one event per kind.
        self.capacity_events: List[dict] = []
        self.saturated = False
        # tracking-lost recovery bookkeeping (kcfg.relocalize)
        self.relocalizations: List[dict] = []
        self._lost_streak = 0
        self._lcam = self.config.camera.scaled(self.kcfg.icp_downsample)
        self._frame_idx = 0
        self._fuse_only = None      # built lazily on first rebuild
        self._render_model = None
        self._reintegrate = None    # built lazily (incremental rebuild)
        # contribution ledger: valid once a full rebuild has accounted
        # for every TSDF contribution (keyframe map_poses) and the ring
        # has tracked every live-fused frame since.  The precondition for
        # exact incremental reintegration; overflow of the bounded ring
        # invalidates it until the next full rebuild.
        self._map_ledgered = False
        self._ring: List[_RingEntry] = []
        self._ring_overflow = False
        # incremented by every full rebuild: a frame fused into an older
        # epoch's map has no contribution in the current one (the rebuild
        # dropped it), so it must not enter the ring
        self._map_epoch = 0
        # pipelining state (kcfg.sync_every): frames whose host-side
        # bookkeeping hasn't run yet, and host mirrors of the device
        # graph so per-frame decisions never block on a device fetch
        self._pending: List[tuple] = []
        # BA scheduling (kcfg.ba_defer_edges/_frames): accepted loop
        # edges accumulate here until the batch/age trigger runs the
        # optimizer (one solve + one reintegration pass for the burst)
        self._pending_ba_edges = 0
        self._pending_ba_since = 0
        # in-flight async BA (kcfg.ba_async): dispatched solve awaiting
        # completion at the next drain
        self._ba_inflight = None
        self._poses_np = np.broadcast_to(
            np.eye(4, dtype=np.float32),
            (self.graph.poses.shape[0], 4, 4),
        ).copy()
        self._n_poses = 0
        self._n_edges = 0
        self._batch_fwd = None      # vmapped candidate-ICP jits (lazy)
        self._batch_rev = None
        self._zero_small = None
        self._kf_pre = None         # jitted preprocess+downsample
        self._jit_add_pose = None
        self._jit_add_edge = None
        self._pack_drain = None     # jitted drain packing (per batch size)

    # -- backend dispatch (single-chip vs sharded) ----------------------------

    def _run_step(self, depth_raw) -> hash_slam.StepInfo:
        if self.mesh is None:
            return self._inner.process(depth_raw)
        return self._sharded.process(depth_raw)

    @property
    def _driver(self):
        return self._inner if self.mesh is None else self._sharded

    @property
    def state(self):
        return self._driver.state

    @state.setter
    def state(self, value) -> None:
        self._driver.state = value

    @property
    def _pose(self) -> jnp.ndarray:
        return self._driver.state.pose

    def _apply_correction(self, correction) -> None:
        d = self._driver
        d.state = d.state._replace(
            pose=se3.compose(jnp.asarray(correction), d.state.pose)
        )

    def _run_ba(self):
        if self.mesh is None:
            return pose_graph.optimize(self.graph, self.kcfg)
        from ..parallel import sharded as sharded_mod

        return sharded_mod.optimize_graph_sharded(
            self.graph, self.kcfg, self.mesh
        )

    # -- graph capacity -----------------------------------------------------

    def _mark_saturated(self, kind: str) -> None:
        self.saturated = True
        if not any(e.get("kind") == f"saturated_{kind}"
                   for e in self.capacity_events):
            self.capacity_events.append({
                "frame": self._frame_idx,
                "kind": f"saturated_{kind}",
                "capacity": (self.graph.poses.shape[0] if kind == "keyframes"
                             else self.graph.edges_ij.shape[0]),
            })

    def _ensure_pose_capacity(self) -> bool:
        """True if a pose slot is available (growing the graph if allowed).
        Counts come from host mirrors — no device fetch."""
        K = self.graph.poses.shape[0]
        if self._n_poses < K:
            return True
        if not self.kcfg.grow_on_capacity:
            self._mark_saturated("keyframes")
            return False
        self.graph = pose_graph.grow(
            self.graph, K * 2, self.graph.edges_ij.shape[0]
        )
        self._poses_np = np.concatenate([
            self._poses_np,
            np.broadcast_to(np.eye(4, dtype=np.float32), (K, 4, 4)),
        ])
        self.capacity_events.append({
            "frame": self._frame_idx, "kind": "grow_keyframes",
            "capacity": K * 2,
        })
        return True

    def _ensure_edge_capacity(self) -> bool:
        E = self.graph.edges_ij.shape[0]
        if self._n_edges < E:
            return True
        if not self.kcfg.grow_on_capacity:
            self._mark_saturated("edges")
            return False
        self.graph = pose_graph.grow(
            self.graph, self.graph.poses.shape[0], E * 2
        )
        self.capacity_events.append({
            "frame": self._frame_idx, "kind": "grow_edges",
            "capacity": E * 2,
        })
        return True

    def _add_pose(self, T_np: np.ndarray) -> None:
        # jitted: the eager version is ~5 dispatches per call
        if self._jit_add_pose is None:
            self._jit_add_pose = jax.jit(pose_graph.add_pose)
            self._jit_add_edge = jax.jit(pose_graph.add_edge)
        self.graph = self._jit_add_pose(
            self.graph, jnp.asarray(T_np, dtype=jnp.float32)
        )
        self._poses_np[self._n_poses] = T_np
        self._n_poses += 1

    def _add_edge(self, i: int, j: int, T_np, weight: float) -> None:
        self.graph = self._jit_add_edge(
            self.graph, i, j, jnp.asarray(T_np, dtype=jnp.float32),
            jnp.float32(weight),
        )
        self._n_edges += 1

    # -- keyframe helpers ---------------------------------------------------

    def _downsample(self, frame: pre_ops.Frame) -> pre_ops.Frame:
        f = self.kcfg.icp_downsample
        if f == 1:
            return frame
        d = pre_ops.downsample_depth(frame.depth, f)
        return pre_ops.preprocess_metric(d, self._lcam)

    def _should_insert(self, pose_np: np.ndarray) -> bool:
        if not self.keyframes:
            return True
        last = self._poses_np[self.keyframes[-1].index]
        rel = np.linalg.inv(last) @ pose_np
        return (
            _rot_deg_np(rel) > self.kcfg.min_rotation_deg
            or float(np.linalg.norm(rel[:3, 3])) > self.kcfg.min_translation
        )

    # -- batched pair ICP ---------------------------------------------------

    def _ensure_batch_icps(self):
        """Vmapped candidate-ICP jits: ALL loop/odometry/relocalization
        candidates run in ONE dispatch and their results come back in ONE
        fetch — a dispatch+fetch round per candidate drains the pipeline
        once per candidate.
        Config-memoized like the other jit factories, so instances with
        the same config share compiles."""
        if self._batch_fwd is not None:
            return
        self._batch_fwd, self._batch_rev = _make_batch_icps(
            self._lcam,
            self.config.icp,
            self.kcfg.loop_icp_max_iters,
        )
        h, w = self._lcam.height, self._lcam.width
        self._zero_small = pre_ops.Frame(
            vertices=jnp.zeros((h, w, 3), jnp.float32),
            normals=jnp.zeros((h, w, 3), jnp.float32),
            depth=jnp.zeros((h, w), jnp.float32),
        )
        self._kf_pre = _make_kf_pre(
            self.config.camera, self.config.frontend,
            self.kcfg.icp_downsample, self._lcam,
        )

    def _dispatch_batch(self, direction, small, cand_frames, inits, width):
        """Pad candidates to ``width`` and dispatch the vmapped pair ICP;
        returns the in-flight (C, 19) device array (no fetch)."""
        self._ensure_batch_icps()
        C = width
        frames = tuple(cand_frames) + (self._zero_small,) * (
            C - len(cand_frames)
        )
        inits = list(inits) + [np.eye(4, dtype=np.float32)] * (
            C - len(inits)
        )
        inits_j = jnp.asarray(np.stack(inits).astype(np.float32))
        fn = self._batch_fwd if direction == "fwd" else self._batch_rev
        return (fn(small, frames, inits_j) if direction == "fwd"
                else fn(frames, small, inits_j))

    @staticmethod
    def _unpack_batch(out_np):
        C = out_np.shape[0]
        return (out_np[:, :16].reshape(C, 4, 4), out_np[:, 16],
                out_np[:, 17], out_np[:, 18])

    def _run_batch(self, direction, small, cand_frames, inits, width):
        """Pad candidates to ``width``, run the vmapped ICP, return
        (transforms (C,4,4), errors (C,), counts (C,), observability (C,))
        as numpy — ONE dispatch, ONE fetch for the whole candidate set."""
        return self._unpack_batch(np.asarray(
            self._dispatch_batch(direction, small, cand_frames, inits,
                                 width)
        ))

    def _edge_ok_np(self, T, err, cnt, obs) -> bool:
        return (
            bool(np.isfinite(T).all())
            and cnt >= self.kcfg.min_loop_inliers
            and err <= self.kcfg.max_loop_error
            and obs >= self.kcfg.min_loop_obs
        )

    def _mutual_ok_np(self, comp) -> bool:
        return (
            float(np.linalg.norm(comp[:3, 3]))
            <= self.kcfg.loop_mutual_max_trans
            and _rot_deg_np(comp) <= self.kcfg.loop_mutual_max_rot_deg
        )

    def _insert_keyframe(self, pose_np: np.ndarray, depth_raw) -> None:
        _t, _lap = _make_laps()
        k = len(self.keyframes)
        if not self._ensure_pose_capacity():
            return
        self._ensure_batch_icps()
        # ONE jitted dispatch for preprocess + downsample: the eager
        # op-by-op version would cost ~100 dispatches
        small = self._kf_pre(jnp.asarray(depth_raw))
        self._add_pose(pose_np)
        rec = _KeyframeRecord(index=k, frame_index=self._frame_idx,
                              frame=small,
                              depth_dev=jnp.asarray(depth_raw))
        _lap("pre_s")

        loop_closed = False
        if k > 0:
            # candidate set: [0] = odometry edge to the previous keyframe,
            # [1:] = loop candidates passing the position/angle gates
            # (all host-side numpy — no device fetch)
            prev = self.keyframes[-1]
            cands = [prev]
            inits = [np.linalg.inv(self._poses_np[prev.index]) @ pose_np]
            p_new = pose_np[:3, 3]
            dir_new = pose_np[:3, 2]
            cos_gate = np.cos(np.deg2rad(self.kcfg.loop_max_angle_deg))
            scored = []
            for r in self.keyframes[
                : max(0, k - self.kcfg.min_loop_separation)
            ]:
                old = self._poses_np[r.index]
                dist = float(np.linalg.norm(old[:3, 3] - p_new))
                if dist > self.kcfg.loop_radius:
                    continue
                if float(old[:3, 2] @ dir_new) < cos_gate:
                    continue
                scored.append((dist, r))
            scored.sort(key=lambda e: e[0])
            width = max(self.kcfg.loop_max_batch, 1)
            for _, r in scored[: width - 1]:
                cands.append(r)
                inits.append(
                    np.linalg.inv(self._poses_np[r.index]) @ pose_np
                )

            _lap("cand_s")
            pending = {
                "k": k,
                "frame_idx": self._frame_idx,
                "small": small,
                "cand_idx": [c.index for c in cands],
                "cand_frames": [c.frame for c in cands],
                "inits": inits,
                "out": self._dispatch_batch(
                    "fwd", small, [c.frame for c in cands], inits, width
                ),
                "width": width,
            }
            defer_on = (self.kcfg.ba_defer_edges > 1
                        or self.kcfg.ba_defer_frames > 0)
            if self.kcfg.kf_async_edges and defer_on:
                # defer the gate fetch: the batch computes alongside the
                # next sync_every tracking steps and its results land at
                # the next drain (where the pipeline syncs anyway)
                # instead of a blocking per-insert fetch.  Edge insertion,
                # the mutual check, and the BA trigger move with it —
                # the same latency class the BA deferral window already
                # accepts, which is why async engages ONLY when deferral
                # is on: a per-closure (ba_defer 1/0) configuration
                # chose correction-latency-first semantics, and shifting
                # its BA one drain later measurably costs accuracy on the
                # loop-closing PNG16 fixtures through the CLI's
                # per-closure defaults, while the deferred flagship
                # config is bit-identical either way.
                self._kf_pending.append(pending)
            else:
                self._complete_one_kf(pending)
            _lap("fwd_s")

        self.keyframes.append(rec)
        self._kf_insert_s.append(_t)
        return self._maybe_optimize()

    def _complete_one_kf(self, p: dict) -> None:
        """Land one keyframe's candidate batch: fetch the forward pair-ICP
        results, apply the acceptance gates, run the (lazy) mutual check,
        and insert the odometry + accepted loop edges into the graph."""
        k = p["k"]
        inits = p["inits"]
        Ts, errs, cnts, obs = self._unpack_batch(np.asarray(p["out"]))
        # odometry edge: pair-ICP refinement (fall back to the
        # tracked relative pose on a failed/degenerate solve) or the
        # tracked pose directly (kcfg.odometry_source)
        meas = (Ts[0]
                if self.kcfg.odometry_source == "icp"
                and self._edge_ok_np(Ts[0], errs[0], cnts[0], obs[0])
                else inits[0])
        if self._ensure_edge_capacity():
            self._add_edge(p["cand_idx"][0], k, meas,
                           self.kcfg.odometry_weight)
        # loop candidates passing the forward gates
        n_c = len(p["cand_idx"])
        passing = [
            i for i in range(1, n_c)
            if self._edge_ok_np(Ts[i], errs[i], cnts[i], obs[i])
        ]
        if passing and self.kcfg.loop_mutual_check:
            rT, _, _, _ = self._run_batch(
                "rev", p["small"],
                [p["cand_frames"][i] for i in passing],
                [np.linalg.inv(Ts[i]) for i in passing], p["width"],
            )
            passing = [
                i for j, i in enumerate(passing)
                if np.isfinite(rT[j]).all()
                and self._mutual_ok_np(Ts[i] @ rT[j])
            ]
        loop_closed = False
        for i in passing:
            if not self._ensure_edge_capacity():
                break
            self._add_edge(p["cand_idx"][i], k, Ts[i],
                           self.kcfg.loop_weight)
            loop_closed = True
        if loop_closed:
            if self._pending_ba_edges == 0:
                # BA deferral ages from when the closure was FOUND
                self._pending_ba_since = p["frame_idx"]
            self._pending_ba_edges += 1

    def _complete_kf_edges(self) -> None:
        """Land every deferred keyframe candidate batch, in insert order.
        Runs at each drain (after its batched pose fetch, which already
        synced the pipeline), before any BA solve, and at flush/
        checkpoint boundaries — so the graph is always current wherever
        it is consumed."""
        while self._kf_pending:
            self._complete_one_kf(self._kf_pending.pop(0))

    def _maybe_optimize(self, force: bool = False):
        """Run BA if the deferral trigger fires (kcfg.ba_defer_edges
        accepted closures accumulated, or the oldest pending one waited
        kcfg.ba_defer_frames frames, or ``force``).  With kcfg.ba_async
        the solve is dispatched here and completed at the next drain;
        while one is in flight new triggers wait (pending edges keep
        accumulating).  Returns the applied correction (numpy) or None."""
        corr = None
        if force:
            # flush/checkpoint boundary: deferred keyframe batches must
            # land before the (forced) solve sees the graph
            self._complete_kf_edges()
        if self._ba_inflight is not None:
            if not force:
                return None
            corr = self._complete_ba()
        if self._pending_ba_edges <= 0:
            return corr
        waited = self._frame_idx - self._pending_ba_since
        if not (
            force
            or self._pending_ba_edges >= max(self.kcfg.ba_defer_edges, 1)
            or (self.kcfg.ba_defer_frames > 0
                and waited >= self.kcfg.ba_defer_frames)
        ):
            return corr
        # the trigger fired: land any still-deferred batches so the solve
        # includes every found edge (their pending count folds into this
        # run — zeroed below)
        self._complete_kf_edges()
        self._pending_ba_edges = 0
        if self.kcfg.ba_async and not force:
            self._dispatch_ba()
            return corr
        c2 = self._optimize()
        if corr is None:
            return c2
        return (c2 @ corr).astype(np.float32) if c2 is not None else corr

    def _fetch_ba(self, info):
        """ONE fixed-shape packed transfer for a BA solve's outputs:
        full (K, 4, 4) poses + both chi2 scalars.  A per-``n_poses``
        slice fetch (``graph.poses[:n]``) compiles a DISTINCT eager
        slice op for every keyframe count — a compile on first use of
        each count, mid-run — and a separate eager chi2 ``jnp.stack``
        fetch would compile and block once more.  The pack is keyed by the graph capacity K only (recompiles
        O(log K) times under growth), and ``warm_compile`` covers it.
        Returns (poses_np (K, 4, 4), chi2_np (2,))."""
        arr = np.asarray(_ba_pack(self.graph.poses.shape[0])(
            self.graph.poses, info.chi2_initial, info.chi2_final
        ))
        K = self.graph.poses.shape[0]
        return arr[: K * 16].reshape(K, 4, 4), arr[K * 16:]

    def _optimize(self) -> np.ndarray:
        """Run BA, propagate the last-keyframe correction to the live
        tracking pose, and — when the correction is significant — rebuild
        the map from the stored keyframe depths at their corrected poses
        (kcfg.rebuild_map).  Without the rebuild the fused TSDF keeps its
        drifted geometry and subsequent frame-to-model tracking fights the
        correction instead of benefiting from it.  Returns the correction
        (numpy) so a pending drain can retro-apply it to in-flight
        frames."""
        import time as _time

        t0 = _time.perf_counter()
        last_idx = self.keyframes[-1].index
        old_last = self._poses_np[last_idx].copy()
        self.graph, info = self._run_ba()
        # refresh the host mirror from the optimized device graph
        poses_all, chi2_np = self._fetch_ba(info)
        self._poses_np[: self._n_poses] = poses_all[: self._n_poses]
        t_ba = _time.perf_counter() - t0
        new_last = self._poses_np[last_idx]
        correction = (new_last @ np.linalg.inv(old_last)).astype(np.float32)
        self._apply_correction(jnp.asarray(correction))
        return self._post_ba(correction, info, last_idx, t_ba,
                             chi2_np=chi2_np)

    def _dispatch_ba(self) -> None:
        """Async BA (kcfg.ba_async): dispatch the solve WITHOUT fetching
        — the optimized graph arrays stay in flight on the device while
        tracking continues; ``_complete_ba`` lands the correction at the
        next drain, where the pose fetch piggybacks on the batch sync.
        Poses/edges appended while in flight sit at rows >= n0 of the
        (already optimized) graph and are re-based on completion."""
        import time as _time

        last_idx = self.keyframes[-1].index
        old_last = self._poses_np[last_idx].copy()
        n0 = self._n_poses
        self.graph, info = self._run_ba()
        self._ba_inflight = {
            "info": info, "n0": n0, "last_idx": last_idx,
            "old_last": old_last, "t0": _time.perf_counter(),
        }

    def _complete_ba(self) -> np.ndarray:
        """Fetch the in-flight solve, merge (optimized rows < n0, re-based
        rows appended since), propagate the correction, resolve the map."""
        import time as _time

        fl = self._ba_inflight
        self._ba_inflight = None
        n0 = fl["n0"]
        opt, chi2_np = self._fetch_ba(fl["info"])
        t_ba = _time.perf_counter() - fl["t0"]
        new_last = opt[fl["last_idx"]]
        correction = (
            new_last @ np.linalg.inv(fl["old_last"])
        ).astype(np.float32)
        self._poses_np[: n0] = opt[:n0]
        for i in range(n0, self._n_poses):
            self._poses_np[i] = (
                correction @ self._poses_np[i]
            ).astype(np.float32)
        if self._n_poses > n0:
            # push the re-based appended rows back to the device graph
            # (padding rows in the mirror are identity, matching create)
            self.graph = self.graph._replace(
                poses=jnp.asarray(self._poses_np)
            )
        self._apply_correction(jnp.asarray(correction))
        return self._post_ba(correction, fl["info"], fl["last_idx"], t_ba,
                             chi2_np=chi2_np)

    def _post_ba(self, correction, info, last_idx, t_ba,
                 chi2_np=None) -> np.ndarray:
        """Shared post-solve tail: map resolution (cost-based full vs
        incremental) + the BA event record."""
        import time as _time

        trans = float(np.linalg.norm(correction[:3, 3]))
        rot = _rot_deg_np(correction)
        rebuilt = False
        mode = None
        n_reint = 0
        self._t_count_moved = None   # never leak a prior event's lap
        t1 = _time.perf_counter()
        if self.kcfg.rebuild_map and (
            trans > self.kcfg.rebuild_min_trans
            or rot > self.kcfg.rebuild_min_rot_deg
        ):
            use_incremental = (
                self.kcfg.rebuild_incremental
                and self._map_ledgered
                and not self._ring_overflow
            )
            if use_incremental and self.kcfg.rebuild_incremental_cost > 0:
                # cost-based choice: a correction that moves most of the
                # ledger resolves cheaper as a fresh rebuild (one fuse
                # per keyframe) than as per-entry de/re-integration
                _tc = _time.perf_counter()
                moved = self._count_moved()
                self._t_count_moved = round(
                    _time.perf_counter() - _tc, 4
                )
                if (
                    moved * self.kcfg.rebuild_incremental_cost
                    > max(len(self.keyframes), 1)
                ):
                    use_incremental = False
            if use_incremental:
                n_reint, n_sat = self._incremental_reintegrate()
                mode = "incremental"
            else:
                self._rebuild_map()
                mode = "full"
                n_sat = 0
            rebuilt = True
        else:
            n_sat = 0

        _tc = _time.perf_counter()
        chi2 = (chi2_np if chi2_np is not None else
                np.asarray(jnp.stack([info.chi2_initial,
                                      info.chi2_final])))
        _t_chi2 = round(_time.perf_counter() - _tc, 4)
        event = {
            "frame": self._frame_idx,
            "keyframes": last_idx + 1,
            "edges": self._n_edges,
            # ONE stacked transfer (two separate float() fetches would
            # block twice)
            "chi2_initial": float(chi2[0]),
            "chi2_final": float(chi2[1]),
            "correction_trans_m": trans,
            "correction_rot_deg": rot,
            "map_rebuilt": rebuilt,
            "rebuild_mode": mode,
            "keyframes_reintegrated": n_reint,
            # host wall-clock of the solve+fetch and of the map update —
            # the endurance regime's hitch budget lives here
            "ba_s": round(t_ba, 4),
            "rebuild_s": round(_time.perf_counter() - t1, 4),
        }
        if rebuilt and mode == "full" and self._last_rebuild_detail:
            d = dict(self._last_rebuild_detail)
            d["chi2_fetch_s"] = _t_chi2
            if getattr(self, "_t_count_moved", None) is not None:
                d["count_moved_s"] = self._t_count_moved
                self._t_count_moved = None
            event["rebuild_detail"] = d
        if n_sat:
            # frustum visible-set saturation during de/re-integration:
            # compact_visible capped at max_active, so some rows the
            # frame touched may not have been moved — not exact, and
            # never silent
            event["reintegration_saturated"] = n_sat
        self.ba_events.append(event)
        return correction

    def _count_moved(self) -> int:
        """How many ledger entries (keyframes + ring frames) the current
        graph poses would move — the incremental path's dispatch count,
        host-side only (feeds the cost-based rebuild choice)."""
        new_poses = self._poses_np
        n = 0
        for rec in self.keyframes:
            if rec.map_pose is not None and self._moved(
                rec.map_pose, new_poses[rec.index]
            ):
                n += 1
        for ent in self._ring:
            if self._moved(ent.map_pose, new_poses[ent.kf] @ ent.rel):
                n += 1
        return n

    def _moved(self, a: np.ndarray, b: np.ndarray) -> bool:
        delta = np.linalg.inv(a) @ b
        return (
            float(np.linalg.norm(delta[:3, 3]))
            > self.kcfg.rebuild_move_min_trans
            or _rot_deg_np(delta) > self.kcfg.rebuild_move_min_rot_deg
        )

    def _incremental_reintegrate(self):
        """Move only the TSDF contributions whose corrected pose differs
        from where they currently sit, using the contribution ledger:
        keyframe ``map_pose`` entries (placed by the last full rebuild)
        plus the ring of every frame live-fused since.  De-integration at
        the LEDGER pose (what was actually fused — which differs from the
        graph pose for frames fused before an in-batch correction or
        relocalization landed) keeps the inverse exact.  Returns
        (n_reintegrated, n_visible_set_saturations).

        Works on all three backends: single-chip, sharded (the
        owner-local make_sharded_reintegrate twin), and streaming — for
        a streaming map the rows a moved frame touched may live in the
        host store, so they are restored (with their ORIGINAL born
        stamps, which evict/restore preserve) for both the old and new
        frustums before the move; store rows that could not be restored
        (device capacity) count as saturations, never silent.  Across
        streaming the move is exact up to the born-stamp residency
        caveat (a frame that overlooked an off-device, un-allocatable
        block still passes the born gate after restore — see
        ops/hash_ops.restore_blocks); strict exactness comes from a
        full rebuild."""
        new_poses = self._poses_np
        self._ensure_jits()
        if self._reintegrate is None:
            if self.mesh is None:
                self._reintegrate = make_reintegrate(self.config)
            else:
                from ..parallel import sharded as sharded_mod

                self._reintegrate = sharded_mod.make_sharded_reintegrate(
                    self.config, self.mesh
                )
        d = self._driver
        streaming = getattr(d, "store", None) is not None
        n = 0
        n_sat = 0
        A = self.config.hash.max_active
        # visible-set saturation count accumulated ON DEVICE with
        # fixed-shape scalar ops: a `jnp.stack(list_of_n_scalars)` fetch
        # compiles a DISTINCT op per move count n, mid-run on first use
        sat_dev = jnp.int32(0)
        miss = 0   # restore-miss count, per-process

        def restore_frustums(from_pose, to_pose):
            """Streaming: pull stored rows back on device for both the
            de-integration and re-integration frustums (ONE restore per
            pose via the driver's streaming machinery).  The query runs
            on the (process-local) store; the dispatch decision is left
            to ``_restore_keys``, which stays collective-consistent
            under multi-process (a store-emptiness early-return here
            would deadlock a peer whose shard has work)."""
            nonlocal miss
            s = self.config.stream
            # join the streaming worker BEFORE reading the store: an
            # async rebuild spill landing (spill_finish_async) may still
            # be add()ing rows on the worker thread, and query_frustum
            # reading mid-grow would mix array generations (or silently
            # miss in-flight rows, leaving the move incomplete)
            d.stream_sync()
            for pose in (from_pose, to_pose):
                keys = (d.store.query_frustum(
                    np.asarray(pose, np.float32), self.config.camera,
                    self.config.fusion, s.restore_margin_px,
                    s.max_restore,
                ) if len(d.store) else np.zeros(0, np.int32))
                d._restore_keys(keys)
                # rows still stored could not come back on device: their
                # share of the frame's contribution cannot be moved.
                # This counts only THIS process's store shard; the
                # global total is summed once at the end (psum_host)
                miss += sum(
                    1 for k in keys if int(k) in d.store._index
                )

        def move(depth_dev, frame_idx, from_pose, to_pose):
            nonlocal n, sat_dev
            if streaming:
                restore_frustums(from_pose, to_pose)
            hmap, cnt = self._reintegrate(
                d.state.hmap, depth_dev,
                jnp.asarray(from_pose, dtype=jnp.float32),
                jnp.asarray(to_pose, dtype=jnp.float32),
                jnp.int32(frame_idx),
            )
            d.state = d.state._replace(hmap=hmap)
            sat_dev = sat_dev + (cnt >= A).astype(jnp.int32)
            n += 1

        for rec in self.keyframes:
            if rec.map_pose is None:
                continue   # post-rebuild keyframe: its fusion is a ring entry
            target = new_poses[rec.index]
            if not self._moved(rec.map_pose, target):
                continue
            dep = (rec.depth_dev if rec.depth_dev is not None
                   else jnp.asarray(rec.depth_raw))
            move(dep, rec.frame_index, rec.map_pose, target)
            rec.map_pose = target.copy()
        for ent in self._ring:
            target = new_poses[ent.kf] @ ent.rel
            if not self._moved(ent.map_pose, target):
                continue
            move(ent.depth, ent.frame_index, ent.map_pose, target)
            ent.map_pose = target.astype(np.float32)
        if n:
            # ONE scalar fetch (max_active hit means the de/re-
            # integration frustum was truncated)
            n_sat += int(np.asarray(sat_dev))
            if streaming:
                # globalize the per-process restore-miss count so the
                # recorded saturation is the identical global total on
                # every process (collective; n is process-symmetric, so
                # every process reaches this together)
                from ..parallel import distributed

                n_sat += distributed.psum_host(miss)
        if n == 0:
            # nothing moved: the map is untouched, so the model rendered
            # by the last step is still valid — skip the re-render (in
            # the continuous-closure regime most small corrections fall
            # below the per-keyframe move thresholds)
            return n, n_sat
        model = self._render_model(d.state.hmap, d.state.pose)
        d.state = d.state._replace(model=model)
        return n, n_sat

    def _ensure_jits(self) -> None:
        """Lazily build the fuse-only / render-model jits (rebuild +
        relocalization share them)."""
        if self._fuse_only is not None:
            return
        if self.mesh is None:
            self._fuse_only = make_fuse_only(self.config)
            self._render_model = make_render_model(self.config)
        else:
            from ..parallel import sharded as sharded_mod

            self._fuse_only = sharded_mod.make_sharded_fuse_only(
                self.config, self.mesh
            )
            self._render_model = sharded_mod.make_sharded_render_model(
                self.config, self.mesh
            )

    def _rebuild_map(self) -> None:
        """Re-integrate every stored keyframe depth at its BA-corrected
        pose into a fresh map, then re-render the tracking model at the
        corrected live pose.  BundleFusion-style reintegration bounded to
        keyframes: non-keyframe observations are dropped, which trades a
        thinner weight field for globally consistent geometry."""
        # one fetch, and resync the host mirror (tests drive this method
        # directly after editing the device graph)
        _t, _lap = _make_laps()
        poses = np.asarray(self.graph.poses)
        self._poses_np[: self._n_poses] = poses[: self._n_poses]
        self._ensure_jits()
        _lap("pose_fetch_s")
        if self.mesh is None:
            hmap = hash_ops.create(self.config.hash)
        else:
            from ..parallel import sharded as sharded_mod

            hmap = sharded_mod.create_sharded(self.config, self.mesh).hmap
        # a streaming store holds geometry fused at the OLD (drifted)
        # poses; the keyframe depths are the durable record, so the
        # rebuild streams into a FRESH store: the full keyframe sweep
        # would not fit the device map (that is why streaming is on), so
        # eviction interleaves with reintegration exactly as it does live
        streaming = getattr(self._driver, "store", None) is not None
        new_store = None
        spill = None
        if streaming:
            from ..utils.blockstore import BlockStore

            # quiesce the driver's pipelined streaming cycle first: an
            # in-flight prefetch/evicted payload references the OLD store
            self._driver.stream_sync()
            _lap("stream_sync_s")
            new_store = BlockStore(self.config.hash)
            # evictions accumulate in a device spill buffer and land with
            # ONE host pull after the loop instead of a blocking pull
            # per keyframe
            spill = self._driver.spill_begin()
        for rec in self.keyframes:
            d = (rec.depth_dev if rec.depth_dev is not None
                 else jnp.asarray(rec.depth_raw))
            hmap = self._fuse_only(
                hmap, d,
                jnp.asarray(poses[rec.index]),
                jnp.int32(rec.frame_index),
            )
            rec.map_pose = poses[rec.index].astype(np.float32).copy()
            if streaming:
                hmap = self._driver.spill_evict(
                    hmap, rec.frame_index, spill
                )
        _lap("fuse_dispatch_s")
        model = self._render_model(hmap, self.state.pose)
        self.state = self.state._replace(hmap=hmap, model=model)
        if streaming:
            # the run's evict/restore totals survive the swap (the fresh
            # store starts at the OLD store's counters plus its own spill
            # intake) — without this the bench's composed section showed
            # restored=0 for a run whose mid-run cycles restored plenty
            new_store.total_evicted += self._driver.store.total_evicted
            new_store.total_restored += self._driver.store.total_restored
            self._driver.store = new_store
            frame = self._frame_idx

            def _overflow(n):
                # bounded geometry loss (off-frustum rows beyond the
                # spill capacity), surfaced like every capacity event
                self.capacity_events.append({
                    "frame": frame,
                    "kind": "rebuild_spill_overflow",
                    "capacity": n,
                })

            # the spill payload pull is the rebuild's largest transfer
            # (up to num_blocks x 4 KB of rows); the single-device driver
            # lands it on the streaming worker so it overlaps the
            # tracking that resumes after this correction — the sharded
            # driver stays synchronous (its cycle protocol is
            # collective, no worker thread)
            fin = getattr(self._driver, "spill_finish_async", None)
            if fin is not None:
                fin(spill, new_store, on_overflow=_overflow)
            else:
                overflow = self._driver.spill_finish(spill, new_store)
                if overflow:
                    _overflow(overflow)
            _lap("spill_finish_s")
        # the ledger now accounts for every contribution in the map;
        # fusions dispatched into the pre-rebuild map are gone with it
        self._ring = []
        self._ring_overflow = False
        self._map_ledgered = True
        self._map_epoch += 1
        self._last_rebuild_detail = _t

    # -- tracking-lost recovery ----------------------------------------------

    def _relocalize(self, depth_raw, valid_px=None):
        """Re-register the live frame against stored keyframes and reset
        the live pose to the best match passing the loop acceptance gates;
        returns the recovered pose (numpy) or None.

        The tracking capability gap the reference's legacy
        correspondence-SVD ``rigidAlignment`` fallback was meant for
        (reference: CameraTracking.cpp:92-115): frame-to-model ICP has
        diverged (occlusion blackout, kidnapped camera), so the model
        rendered at the stale pose shares no surface with the live frame.
        Keyframes are absolutely-posed snapshots — registering against
        them (from identity: a relocalizable camera is near SOME keyframe)
        recovers an absolute pose.  On success the live pose/velocity are
        reset and the model is re-rendered there so the next frame tracks
        normally."""
        self._ensure_batch_icps()
        # blackout gate: nothing to register on a (near-)empty frame.
        # ``valid_px`` (full-res count, from the batched drain fetch)
        # replaces the per-attempt device fetch; the
        # downsampled count is ~valid_px/f^2, and for a blackout gate the
        # uniform-validity approximation is exact where it matters
        # (valid_px ~ 0).  Callers without the batched count (None) pay
        # the legacy fetch.
        f = self.kcfg.icp_downsample
        small = self._kf_pre(jnp.asarray(depth_raw))
        if valid_px is None:
            valid_small = int(jnp.sum(small.depth > 0))
        else:
            valid_small = valid_px // (f * f)
        if valid_small < self.kcfg.min_loop_inliers:
            return None   # blackout frame: nothing to register
        cands = self.keyframes[-self.kcfg.reloc_max_candidates:]
        width = max(self.kcfg.reloc_max_candidates, 1)
        eye = np.eye(4, dtype=np.float32)
        inits = [eye] * len(cands)
        if self.kcfg.reloc_procrustes:
            # closed-form Procrustes seed per candidate (ONE padded
            # dispatch + ONE fetch): the exact rotation solve reaches
            # basins identity-start GN cannot (tests/test_procrustes.py)
            fn = _make_batch_procrustes(
                self._lcam, self.config.icp,
                self.kcfg.reloc_procrustes_rounds,
            )
            frames = tuple(c.frame for c in cands) + (
                self._zero_small,
            ) * (width - len(cands))
            Ts0 = np.asarray(fn(small, frames))
            inits = [Ts0[i] for i in range(len(cands))]
        Ts, errs, cnts, obs = self._run_batch(
            "fwd", small, [c.frame for c in cands], inits, width,
        )
        passing = [
            i for i in range(len(cands))
            if self._edge_ok_np(Ts[i], errs[i], cnts[i], obs[i])
        ]
        if passing and self.kcfg.loop_mutual_check:
            rT, _, _, _ = self._run_batch(
                "rev", small, [cands[i].frame for i in passing],
                [np.linalg.inv(Ts[i]) for i in passing], width,
            )
            passing = [
                i for j, i in enumerate(passing)
                if np.isfinite(rT[j]).all()
                and self._mutual_ok_np(Ts[i] @ rT[j])
            ]
        if not passing:
            return None
        best = max(passing, key=lambda i: (cnts[i], -errs[i]))
        rec = cands[best]
        pose_np = (self._poses_np[rec.index] @ Ts[best]).astype(np.float32)
        self._ensure_jits()
        d = self._driver
        pose = jnp.asarray(pose_np)
        model = self._render_model(d.state.hmap, pose)
        d.state = d.state._replace(
            pose=pose, model=model, vel=jnp.eye(4, dtype=jnp.float32)
        )
        self._lost_streak = 0
        self.relocalizations.append({
            "frame": self._frame_idx,
            "keyframe": rec.index,
            "inliers": int(cnts[best]),
            "error": float(errs[best]),
        })
        return pose_np

    # -- warmup --------------------------------------------------------------

    def warm_compile(self, depth_raw) -> None:
        """Compile every jit the steady-state loop can reach — keyframe
        preprocess, batched candidate/relocalization ICP, BA at the
        current graph capacity, fuse-only / reintegrate / model render —
        WITHOUT touching this instance's SLAM state (scratch inputs only).

        This is the public warm-up path benchmarks and latency-sensitive
        callers use so no cold compile (seconds) lands
        mid-measurement; because the jit factories are config-memoized, a
        fresh instance with the same config reuses these compiles.  The
        tracking step itself is warmed by processing a frame (e.g. on a
        throwaway instance).  Everything here goes through the same entry
        points the live paths use, so API drift in any of them breaks
        this method (and the bench smoke test), not a benchmark run."""
        d = jnp.asarray(depth_raw)
        self._ensure_jits()
        self._ensure_batch_icps()
        if self._reintegrate is None:
            if self.mesh is None:
                self._reintegrate = make_reintegrate(self.config)
            else:
                from ..parallel import sharded as sharded_mod

                self._reintegrate = sharded_mod.make_sharded_reintegrate(
                    self.config, self.mesh
                )
        I = jnp.eye(4, dtype=jnp.float32)
        if self.mesh is None:
            hm = hash_ops.create(self.config.hash)
        else:
            from ..parallel import sharded as sharded_mod

            hm = sharded_mod.create_sharded(self.config, self.mesh).hmap
        hm = self._fuse_only(hm, d, I, jnp.int32(0))
        if self._reintegrate is not None:
            hm, wcnt = self._reintegrate(hm, d, I, I, jnp.int32(0))
            # ... and the incremental path's on-device saturation
            # accumulator ops + scalar fetch
            np.asarray(jnp.int32(0) + (
                wcnt >= self.config.hash.max_active
            ).astype(jnp.int32))
        model = self._render_model(hm, I)
        small = self._kf_pre(d)
        eye = np.eye(4, dtype=np.float32)
        widths = {max(self.kcfg.loop_max_batch, 1),
                  max(self.kcfg.reloc_max_candidates, 1)}
        for w in widths:
            self._run_batch("fwd", small, [small], [eye], w)
            self._run_batch("rev", small, [small], [eye], w)
        if self.kcfg.reloc_procrustes:
            wr = max(self.kcfg.reloc_max_candidates, 1)
            fn = _make_batch_procrustes(
                self._lcam, self.config.icp,
                self.kcfg.reloc_procrustes_rounds,
            )
            frames = (small,) + (self._zero_small,) * (wr - 1)
            np.asarray(fn(small, frames))
        g, wi = self._run_ba()  # pure: compiles BA at current capacity
        # ... and the packed post-solve fetch at the same capacity
        np.asarray(_ba_pack(g.poses.shape[0])(
            g.poses, wi.chi2_initial, wi.chi2_final
        ))
        # streaming driver: every evict/restore/pull bucket jit too
        if getattr(self._driver, "store", None) is not None:
            warm_stream = getattr(self._driver, "warm_stream", None)
            if warm_stream is not None:
                warm_stream()
        # one scalar fetch waits for the whole compile+execute chain
        _sync = float(np.asarray(model.depth.ravel()[0]))
        _sync = float(np.asarray(g.poses.ravel()[0]))
        del hm, model, g, _sync

    # -- main entry ----------------------------------------------------------

    def process(self, depth_raw) -> hash_slam.StepInfo:
        """One frame: dispatch the jitted pipeline step immediately (it
        pipelines with in-flight work), defer the host-side keyframe
        bookkeeping until ``sync_every`` frames of poses can be fetched in
        ONE transfer (kcfg.sync_every; 1 = fetch per frame)."""
        d = jnp.asarray(depth_raw)
        info = self._run_step(d)
        self.infos.append(info)
        self._frame_idx += 1
        self._pending.append((d, info, self._map_epoch))
        if len(self._pending) >= max(self.kcfg.sync_every, 1):
            self._drain()
        return info

    def flush(self) -> None:
        """Run deferred bookkeeping for all in-flight frames, then any
        BA the deferral window is still holding back."""
        if self._pending:
            self._drain()
        self._maybe_optimize(force=True)

    def settle(self) -> None:
        """Land all in-flight work — pending frames, deferred keyframe
        candidate batches, an async BA solve — WITHOUT forcing the
        deferred-BA trigger.  The checkpoint-transparent boundary:
        ``save_keyframe_slam`` persists the deferral counters, so a
        resumed run fires BA at the same frame the uninterrupted run
        would have (``flush`` instead forces pending closures to solve
        NOW, which would make the saved state diverge from an
        uninterrupted run whenever a closure was in flight at the cut —
        tests/test_keyframe_checkpoint.py pins the equivalence)."""
        if self._pending:
            self._drain()
        self._complete_kf_edges()
        if self._ba_inflight is not None:
            self._complete_ba()

    def _drain(self) -> None:
        pend = self._pending
        self._pending = []
        # ONE jitted pack + ONE host fetch for the whole batch (eager
        # stacking costs ~2 dispatches per pending frame)
        if self._pack_drain is None:
            def _pack(poses, tracked, valid_px):
                return jnp.concatenate(
                    [
                        jnp.stack(poses).reshape(len(poses), 16),
                        jnp.stack(tracked).astype(jnp.float32)[:, None],
                        jnp.stack(valid_px).astype(jnp.float32)[:, None],
                    ],
                    axis=1,
                )

            self._pack_drain = jax.jit(_pack)
        # pad the batch to the fixed sync_every width so ONE compiled
        # pack shape serves every drain — the final partial drain at
        # flush (e.g. 8 leftover frames of a 200-frame run) otherwise
        # compiles a fresh per-length op mid-run
        B = max(self.kcfg.sync_every, 1)
        infos = [i for _, i, _e in pend] + [pend[-1][1]] * (
            B - len(pend)
        )
        arr = np.asarray(self._pack_drain(
            tuple(i.pose for i in infos),
            tuple(i.tracked for i in infos),
            tuple(i.valid_px for i in infos),
        ))[: len(pend)]
        frame0 = self._frame_idx - len(pend)
        saved = self._frame_idx
        corr = None   # correction accumulated within this batch
        # previous drains' deferred keyframe batches land here: the pack
        # fetch above already synced the pipeline, so theirs is a cheap
        # result pull (kcfg.kf_async_edges)
        self._complete_kf_edges()
        if self._ba_inflight is not None:
            # async BA completion: the batch fetch above already drained
            # the pipeline, so the solve is done and its pose fetch is
            # cheap; its correction retro-applies to this whole batch
            corr = self._complete_ba()
        try:
            for b, (d, info, epoch) in enumerate(pend):
                raw_pose = arr[b, :16].reshape(4, 4).astype(np.float32)
                pose_np = raw_pose if corr is None else (
                    corr @ raw_pose
                ).astype(np.float32)
                tracked = arr[b, 16] > 0.5
                valid_px = int(arr[b, 17])
                # event logs inside the per-frame logic stamp the frame's
                # own index, not the batch-end counter
                self._frame_idx = frame0 + b
                c = self._per_frame(d, pose_np, raw_pose, tracked, epoch,
                                    valid_px=valid_px)
                if c is not None:
                    corr = c if corr is None else c @ corr
        finally:
            self._frame_idx = saved

    def _per_frame(self, depth_raw, pose_np, raw_pose, tracked, epoch=None,
                   valid_px=None):
        """Deferred per-frame bookkeeping.  ``raw_pose`` is the pose the
        jitted step actually FUSED at (before any in-batch correction or
        relocalization) — the contribution ledger needs it to de-integrate
        exactly.  ``valid_px`` is the frame's valid-depth pixel count
        (from the batched drain fetch; None = unknown, the relocalizer
        then gates with its own fetch).  Returns a BA correction to
        retro-apply to later in-flight frames, or None."""
        correction = None
        if tracked:
            self._lost_streak = 0
        else:
            self._lost_streak += 1
            r = self.kcfg
            if (
                r.relocalize
                and self.keyframes
                and self._lost_streak >= r.reloc_after
                and (self._lost_streak - r.reloc_after) % r.reloc_interval
                == 0
            ):
                new_pose = self._relocalize(depth_raw, valid_px=valid_px)
                if new_pose is not None:
                    pose_np = new_pose
        if self._should_insert(pose_np):
            # preprocess only when a keyframe is actually inserted — on
            # ordinary frames the jitted step already did it internally
            correction = self._insert_keyframe(pose_np, depth_raw)
        else:
            # deferred-BA age trigger can fire between inserts
            correction = self._maybe_optimize()
        if correction is not None:
            pose_np = (correction @ pose_np).astype(np.float32)
        kf = self.keyframes[-1]
        rel = np.linalg.inv(self._poses_np[kf.index]) @ pose_np
        rel = rel.astype(np.float32)
        self._frame_refs.append((kf.index, rel))
        # contribution ledger: the step fused this frame at raw_pose;
        # remember it (bounded window) so incremental corrections can move
        # the contribution exactly.  Overflow invalidates the ledger — the
        # next significant correction rebuilds fully.  A frame fused into
        # an older map epoch has no contribution to track (the rebuild
        # dropped it).
        if epoch is None or epoch == self._map_epoch:
            if len(self._ring) < self.kcfg.rebuild_window:
                self._ring.append(_RingEntry(
                    frame_index=self._frame_idx, kf=kf.index, rel=rel,
                    depth=jnp.asarray(depth_raw), map_pose=raw_pose,
                ))
            else:
                self._ring_overflow = True
        return correction

    def render(self, pose=None):
        """Render the current map (live on both the single-chip and the
        sharded driver — the sharded path row-shards the output over the
        mesh, see parallel/sharded.make_sharded_render)."""
        return self._driver.render(pose)

    def trajectory(self) -> List[np.ndarray]:
        """Full trajectory with all BA corrections applied retroactively."""
        self.flush()
        poses = self._poses_np
        return [poses[k] @ rel for k, rel in self._frame_refs]

    def keyframe_trajectory(self) -> List[np.ndarray]:
        self.flush()
        return [self._poses_np[rec.index] for rec in self.keyframes]
