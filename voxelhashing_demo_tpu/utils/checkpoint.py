"""Checkpoint / resume: serialize the full SLAM state to a single npz.

The reference has nothing of the kind — its only persistence is a debug
text dump of the SDF volume (reference: SDFRenderer.cpp:71-110 printSDFdata
-> SDF_dump.txt).  Proper checkpointing is required here: long sequences,
restartable multi-host runs (SURVEY.md §5 failure-detection row), and
offline rendering of finished maps.

Format: one ``.npz`` holding every leaf of the state pytrees plus a JSON
header with the config (so a checkpoint is self-describing and loadable
without out-of-band knowledge).  Pure numpy on the host — device arrays are
pulled once, and restore pushes them back with ``jnp.asarray``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..config import PipelineConfig
from ..models import hash_slam
from ..ops import hash_ops, pose_graph
from ..ops import preprocess as pre_ops

FORMAT_VERSION = 1


def config_to_json(config: PipelineConfig) -> str:
    return json.dumps(
        {
            f.name: dataclasses.asdict(getattr(config, f.name))
            for f in dataclasses.fields(config)
        }
    )


def config_from_json(text: str) -> PipelineConfig:
    raw = json.loads(text)
    defaults = PipelineConfig()
    kwargs = {}
    for f in dataclasses.fields(PipelineConfig):
        sub_type = type(getattr(defaults, f.name))
        sub_fields = {sf.name for sf in dataclasses.fields(sub_type)}
        # forward/backward compatible: missing sections/fields take
        # defaults, unknown ones are ignored
        sub_kwargs = {
            k: (tuple(v) if isinstance(v, list) else v)
            for k, v in raw.get(f.name, {}).items()
            if k in sub_fields
        }
        kwargs[f.name] = sub_type(**sub_kwargs)
    return PipelineConfig(**kwargs)


def _flatten(prefix: str, tree) -> dict:
    from ..parallel import distributed

    out = {}
    for name, leaf in zip(tree._fields, tree):
        key = f"{prefix}.{name}"
        if hasattr(leaf, "_fields"):
            out.update(_flatten(key, leaf))
        else:
            # process-safe global read: np.asarray for fully-addressable
            # leaves, collective all-gather for multi-host sharded ones
            # (every process must checkpoint together)
            out[key] = distributed.fetch(leaf)
    return out


def _flatten_local(prefix: str, tree, sharded_keys: list) -> dict:
    """Per-process twin of ``_flatten``: axis-sharded leaves contribute
    only THIS process's rows (no communication) and are recorded in
    ``sharded_keys``; replicated leaves are written in full (identical
    in every process's file)."""
    from ..parallel import distributed

    out = {}
    for name, leaf in zip(tree._fields, tree):
        key = f"{prefix}.{name}"
        if hasattr(leaf, "_fields"):
            out.update(_flatten_local(key, leaf, sharded_keys))
        elif (isinstance(leaf, np.ndarray)
              or getattr(leaf, "is_fully_replicated", True)):
            out[key] = distributed.fetch(leaf)
        else:
            out[key] = distributed.local_rows(leaf)
            sharded_keys.append(key)
    return out


def per_process_path(path: str) -> str:
    """The shard filename this process reads/writes in per-process
    checkpoint mode (``save_slam(per_process=True)``)."""
    import os

    import jax

    base, ext = os.path.splitext(path)
    return (f"{base}.proc{jax.process_index()}"
            f"of{jax.process_count()}{ext or '.npz'}")


def save_slam(
    path: str,
    slam: "hash_slam.HashSLAM",
    graph: Optional[pose_graph.PoseGraph] = None,
    extra: Optional[dict] = None,
    per_process: bool = False,
) -> None:
    """Checkpoint a HashSLAM, ShardedHashSLAM, or KeyframeSLAM inner state.

    Sharded states save transparently (np.asarray gathers the global view
    of every sharded leaf); ``mesh_n`` records the mesh size so
    ``load_sharded_slam`` can restore the exact per-device layout
    (bit-identical resume) while plain ``load_slam`` converts the map
    canonically to the single-chip layout.

    ``per_process=True`` writes SHARD files instead — each process writes
    ``per_process_path(path)`` holding only its devices' rows (plus the
    replicated leaves, identical in every file) with NO cross-process
    gather, so checkpointing a multi-host map costs host-local I/O only.
    ``load_sharded_slam`` auto-detects the shard files when ``path`` is
    absent; loading requires the same process count/topology."""
    import jax

    if getattr(slam, "store", None) is not None:
        # quiesce the pipelined streaming cycle: an in-flight evicted
        # payload lives on neither the device map nor the store yet and
        # would be LOST by a snapshot taken mid-pipeline
        slam.stream_sync()
    sharded_keys: list = []
    if per_process:
        arrays = _flatten_local("state", slam.state, sharded_keys)
        path = per_process_path(path)
        arrays["pp_process_index"] = np.int64(jax.process_index())
        arrays["pp_process_count"] = np.int64(jax.process_count())
        arrays["pp_sharded_keys"] = np.frombuffer(
            json.dumps(sharded_keys).encode(), dtype=np.uint8
        )
    else:
        arrays = _flatten("state", slam.state)
    mesh = getattr(slam, "mesh", None)
    arrays["mesh_n"] = np.int64(mesh.devices.size if mesh is not None else 1)
    if graph is not None:
        # graph leaves are replicated (the BA output) — full in any mode
        arrays.update(_flatten("graph", graph))
    if slam.trajectory:
        # device poses: stack on device, fetch ONCE (a per-pose
        # np.asarray blocks once per pose).  Host poses: plain numpy
        # stack, no transfers.
        if isinstance(slam.trajectory[0], np.ndarray):
            arrays["trajectory"] = np.stack(slam.trajectory)
        else:
            arrays["trajectory"] = np.asarray(jnp.stack(slam.trajectory))
    arrays["config_json"] = np.frombuffer(
        config_to_json(slam.config).encode(), dtype=np.uint8
    )
    arrays["format_version"] = np.int64(FORMAT_VERSION)
    if getattr(slam, "store", None) is not None:
        # streaming host store: the out-of-frustum half of the map.
        # Under multi-process each store holds only this host's devices'
        # evictions, so a GLOBAL checkpoint gathers the shards into the
        # union (collective — every process checkpoints together; the
        # gate below must NOT depend on the per-process len(store));
        # per-process shard files keep their local rows as-is.
        from ..parallel import distributed

        store_arrays = slam.store.state_arrays()
        if not per_process:
            store_arrays = distributed.gather_concat_many(store_arrays)
        if store_arrays["keys"].shape[0]:
            for k, v in store_arrays.items():
                arrays[f"store.{k}"] = v
    if extra:
        for k, v in extra.items():
            arrays[f"extra.{k}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def _sharded_map_to_single(
    hmap_np: dict, config: PipelineConfig, n: int
) -> hash_ops.HashMap:
    """Canonical conversion of a gathered sharded map (n local tables,
    local row pointers) into the single-chip layout: collect every
    occupied block's (key, payload) and re-insert into a fresh table.

    The result is content-identical, not slot-identical — all consumers
    (integrate, splat, raycast, GC) are order-independent over the table,
    so rendering and continued fusion behave the same."""
    import jax.numpy as jnp_  # local alias; works on any platform

    cfg = config.hash
    keys = hmap_np["keys"]
    ptrs = hmap_np["ptrs"]
    localT = keys.shape[0] // n
    localB = hmap_np["tsdf"].shape[0] // n
    occ = np.nonzero(ptrs >= 0)[0]
    seg = occ // localT
    rows = seg * localB + ptrs[occ]
    okeys = keys[occ]
    otsdf = hmap_np["tsdf"][rows]
    oweight = hmap_np["weight"][rows]
    olast = hmap_np["last_seen"][rows]
    oborn = hmap_np["born"][rows]

    out = hash_ops.create(cfg)
    C = 4096
    for i in range(0, len(occ), C):
        k = okeys[i: i + C]
        pad = C - k.shape[0]
        k = np.concatenate([k, np.full(pad, int(hash_ops.EMPTY_KEY),
                                       np.int32)])
        t = np.concatenate(
            [otsdf[i: i + C],
             np.zeros((pad, otsdf.shape[1]), np.float32)]
        )
        w = np.concatenate(
            [oweight[i: i + C],
             np.zeros((pad, oweight.shape[1]), np.float32)]
        )
        b = np.concatenate(
            [oborn[i: i + C], np.zeros(pad, np.int32)]
        )
        out, acc = hash_ops.restore_blocks(
            out, cfg, jnp_.asarray(k), jnp_.asarray(t), jnp_.asarray(w), 0,
            max_weight=config.fusion.max_weight,
            born_rows=jnp_.asarray(b),
        )
        if not bool(np.asarray(acc)[: C - pad].all()):
            raise ValueError(
                "sharded->single conversion overflowed the single-chip "
                "table (raise hash.num_buckets/bucket_size)"
            )
        # restore_blocks stamps last_seen=frame 0; put the real values back
        p, _ = hash_ops.lookup_keys(out, cfg, jnp_.asarray(k))
        l = np.concatenate(
            [olast[i: i + C], np.zeros(pad, np.int32)]
        )
        out = out._replace(
            last_seen=out.last_seen.at[
                jnp_.where(p >= 0, p, out.last_seen.shape[0])
            ].set(jnp_.asarray(l), mode="drop")
        )
    return out


def load_slam(
    path: str,
) -> Tuple["hash_slam.HashSLAM", Optional[pose_graph.PoseGraph]]:
    """Restore a HashSLAM wrapper (and pose graph, if present).

    Sharded checkpoints (mesh_n > 1) are converted canonically to the
    single-chip layout — use ``load_sharded_slam`` for bit-identical
    multi-chip resume."""
    with np.load(path) as z:
        version = int(z["format_version"])
        if version > FORMAT_VERSION:
            raise ValueError(f"checkpoint format {version} is newer than "
                             f"supported {FORMAT_VERSION}")
        config = config_from_json(bytes(z["config_json"]).decode())
        slam = hash_slam.HashSLAM.__new__(hash_slam.HashSLAM)
        slam.config = config
        slam._step = hash_slam.make_step(config)
        slam._scan_step = None
        slam.infos = []
        slam.store = None
        if config.stream.enabled:
            from .blockstore import BlockStore

            slam._evict = hash_slam.make_evict(config)
            slam._restore_jits = {}
            if "store.keys" in z:
                slam.store = BlockStore.from_arrays(
                    config.hash, z["store.keys"], z["store.tsdf"],
                    z["store.weight"],
                    z["store.born"] if "store.born" in z else None,
                    born_default=int(z["state.frame_idx"]),
                )
            else:
                slam.store = BlockStore(config.hash)
            slam._init_stream_runtime()

        def leaf(key):
            return jnp.asarray(z[key])

        hmap_np = {
            n: np.asarray(z[f"state.hmap.{n}"])
            for n in hash_ops.HashMap._fields
            if f"state.hmap.{n}" in z
        }
        if "last_seen" not in hmap_np:
            # field added after format v1: default sanely on old files
            hmap_np["last_seen"] = np.zeros(
                z["state.hmap.free_list"].shape, dtype=np.int32
            )
        if "band_min" not in hmap_np:
            # field added after format v2: recompute from the rows
            w, t = hmap_np["weight"], hmap_np["tsdf"]
            hmap_np["band_min"] = np.where(
                w > 0, np.abs(t), np.inf
            ).min(axis=1).astype(np.float32)
        if "born" not in hmap_np:
            # field added later: age-0 default (old maps predate
            # incremental reintegration; a full rebuild restamps it)
            hmap_np["born"] = np.zeros(
                z["state.hmap.free_list"].shape, dtype=np.int32
            )
        mesh_n = int(z["mesh_n"]) if "mesh_n" in z else 1
        if mesh_n > 1:
            hmap = _sharded_map_to_single(hmap_np, config, mesh_n)
        else:
            hmap = hash_ops.HashMap(
                **{k: jnp.asarray(v) for k, v in hmap_np.items()}
            )
        model = pre_ops.Frame(
            **{n: leaf(f"state.model.{n}") for n in pre_ops.Frame._fields}
        )
        slam.state = hash_slam.HashSLAMState(
            hmap=hmap,
            pose=leaf("state.pose"),
            model=model,
            frame_idx=leaf("state.frame_idx"),
            # fields added after format v1 default sanely on old files
            vel=(leaf("state.vel") if "state.vel" in z
                 else jnp.eye(4, dtype=jnp.float32)),
        )
        slam.trajectory = (
            [jnp.asarray(p) for p in z["trajectory"]]
            if "trajectory" in z
            else []
        )
        graph = None
        if "graph.poses" in z:
            graph = pose_graph.PoseGraph(
                **{
                    n: leaf(f"graph.{n}")
                    for n in pose_graph.PoseGraph._fields
                }
            )
    return slam, graph


def load_sharded_slam(path: str, mesh=None):
    """Restore a ShardedHashSLAM for bit-identical multi-chip resume.

    The checkpoint's gathered leaves are device_put back with the exact
    sharding layout they were saved from; requires a mesh of the same size
    (``mesh_n`` in the file).  For a different topology, go through
    ``load_slam`` (canonical single-chip view) and re-shard by re-running,
    or re-save from there.

    Per-process shard checkpoints (``save_slam(per_process=True)``) are
    auto-detected when ``path`` itself is absent but this process's
    ``per_process_path(path)`` exists; they require the same process
    count/index layout they were saved from."""
    import os

    import jax
    from jax.sharding import NamedSharding

    from ..models import hash_slam
    from ..parallel import distributed, sharded

    if not os.path.exists(path) and os.path.exists(per_process_path(path)):
        path = per_process_path(path)

    with np.load(path) as z:
        config = config_from_json(bytes(z["config_json"]).decode())
        mesh_n = int(z["mesh_n"]) if "mesh_n" in z else 1
        pp_sharded = (
            set(json.loads(bytes(z["pp_sharded_keys"]).decode()))
            if "pp_sharded_keys" in z else None
        )
        if pp_sharded is not None:
            if (int(z["pp_process_count"]) != jax.process_count()
                    or int(z["pp_process_index"]) != jax.process_index()):
                raise ValueError(
                    f"per-process checkpoint shard was written by process "
                    f"{int(z['pp_process_index'])}/"
                    f"{int(z['pp_process_count'])}; this process is "
                    f"{jax.process_index()}/{jax.process_count()}"
                )
        if mesh is None:
            mesh = sharded.make_mesh(mesh_n)
        if mesh.devices.size != mesh_n:
            raise ValueError(
                f"checkpoint was saved from a {mesh_n}-device mesh; "
                f"got {mesh.devices.size} (use load_slam for the "
                f"topology-free view)"
            )

        def leaf(key, spec):
            arr = np.asarray(z[key])
            if pp_sharded is not None and key in pp_sharded:
                # this process's rows only; reassemble the global
                # axis-sharded array from per-process local data
                return distributed.shard_rows_to_global(arr, mesh, spec)
            # make_array_from_callback works identically single-process
            # and multi-host (each process materializes only the shards
            # it owns; every process must load together)
            return jax.make_array_from_callback(
                arr.shape, NamedSharding(mesh, spec),
                lambda idx, a=arr: a[idx],
            )

        map_spec = sharded._map_spec()
        hmap_kwargs = {}
        for name in hash_ops.HashMap._fields:
            k = f"state.hmap.{name}"
            if k in z:
                hmap_kwargs[name] = leaf(k, getattr(map_spec, name))
        if "last_seen" not in hmap_kwargs:
            hmap_kwargs["last_seen"] = jax.device_put(
                jnp.zeros(z["state.hmap.free_list"].shape, jnp.int32),
                NamedSharding(mesh, map_spec.last_seen),
            )
        if "band_min" not in hmap_kwargs:
            w = np.asarray(z["state.hmap.weight"])
            t = np.asarray(z["state.hmap.tsdf"])
            hmap_kwargs["band_min"] = jax.device_put(
                jnp.asarray(np.where(w > 0, np.abs(t), np.inf)
                            .min(axis=1).astype(np.float32)),
                NamedSharding(mesh, map_spec.band_min),
            )
        if "born" not in hmap_kwargs:
            hmap_kwargs["born"] = jax.device_put(
                jnp.zeros(z["state.hmap.free_list"].shape, jnp.int32),
                NamedSharding(mesh, map_spec.born),
            )
        state_spec = sharded._state_spec()
        model = pre_ops.Frame(
            **{
                n: leaf(f"state.model.{n}", getattr(state_spec.model, n))
                for n in pre_ops.Frame._fields
            }
        )
        slam = sharded.ShardedHashSLAM.__new__(sharded.ShardedHashSLAM)
        slam.config = config
        slam.mesh = mesh
        slam._step = sharded.make_sharded_step(config, mesh)
        slam.infos = []
        slam.store = None
        if config.stream.enabled:
            from .blockstore import BlockStore

            slam._evict = sharded.make_sharded_evict(config, mesh)
            slam._restore = sharded.make_sharded_restore(config, mesh)
            if "store.keys" in z:
                from ..parallel import distributed

                skeys = np.asarray(z["store.keys"])
                stsdf = np.asarray(z["store.tsdf"])
                sweight = np.asarray(z["store.weight"])
                sborn = (np.asarray(z["store.born"])
                         if "store.born" in z else None)
                if distributed.is_multiprocess() and skeys.size:
                    # the checkpoint records the global store union;
                    # this process keeps only the rows its devices own
                    # (restores route by the same owner hash, so foreign
                    # rows could never be uploaded from here — they would
                    # sit dead in the store forever)
                    from .blockstore import unpack_keys_np

                    owner = sharded._owner_np(
                        unpack_keys_np(skeys, config.hash.key_bits),
                        config.hash.num_buckets, mesh.devices.size,
                    )
                    keep = distributed.owner_process_mask(mesh, owner)
                    skeys, stsdf, sweight = (
                        skeys[keep], stsdf[keep], sweight[keep])
                    if sborn is not None:
                        sborn = sborn[keep]
                slam.store = BlockStore.from_arrays(
                    config.hash, skeys, stsdf, sweight, sborn,
                    born_default=int(z["state.frame_idx"]),
                )
            else:
                slam.store = BlockStore(config.hash)
            slam._init_stream_runtime()
        slam.state = hash_slam.HashSLAMState(
            hmap=hash_ops.HashMap(**hmap_kwargs),
            pose=leaf("state.pose", state_spec.pose),
            model=model,
            frame_idx=leaf("state.frame_idx", state_spec.frame_idx),
            vel=(leaf("state.vel", state_spec.vel) if "state.vel" in z
                 else jnp.eye(4, dtype=jnp.float32)),
        )
        slam.trajectory = (
            [jnp.asarray(p) for p in z["trajectory"]]
            if "trajectory" in z else []
        )
    return slam


def save_keyframe_slam(path: str, kslam, per_process: bool = False) -> None:
    """Checkpoint a KeyframeSLAM: inner pipeline state + pose graph +
    everything the backend needs to keep closing loops after a restart
    (not just the graph poses):

    - keyframe raw depths (uint16, compressed by savez) + frame indices —
      the durable record; the downsampled ICP frames are recomputed
      deterministically on load,
    - per-frame keyframe references (``_frame_refs``) so the full
      corrected trajectory remains reconstructible,
    - ba/capacity/relocalization event logs and the saturation flag.

    The reference's only persistence is a debug text dump
    (reference: SDFRenderer.cpp:71-110)."""
    kslam.settle()  # land in-flight work; deferred BA stays deferred
    extra = {}
    if kslam.keyframes:
        extra["kf_depths"] = np.stack(
            [r.depth_np() for r in kslam.keyframes]
        )
        extra["kf_frame_indices"] = np.array(
            [r.frame_index for r in kslam.keyframes], np.int64
        )
    if kslam._frame_refs:
        extra["refs_k"] = np.array(
            [k for k, _ in kslam._frame_refs], np.int64
        )
        extra["refs_rel"] = np.stack(
            [np.asarray(rel) for _, rel in kslam._frame_refs]
        ).astype(np.float32)
    events = {
        "ba_events": kslam.ba_events,
        "capacity_events": kslam.capacity_events,
        "relocalizations": kslam.relocalizations,
        "saturated": bool(kslam.saturated),
        "frame_idx": int(kslam._frame_idx),
        # the BA deferral counters survive the checkpoint (settle does
        # NOT force pending closures to solve), so a resumed run fires
        # BA at the frame the uninterrupted run would have
        "pending_ba_edges": int(kslam._pending_ba_edges),
        "pending_ba_since": int(kslam._pending_ba_since),
        # the contribution ledger (keyframe map_poses + live-frame ring)
        # is NOT persisted: a resumed run starts unledgered and its first
        # significant correction performs a full rebuild
    }
    extra["events_json"] = np.frombuffer(
        json.dumps(events).encode(), dtype=np.uint8
    )
    save_slam(path, kslam._driver, graph=kslam.graph, extra=extra,
              per_process=per_process)


def load_keyframe_slam(path: str, mesh=None):
    """Restore a KeyframeSLAM for a full-capability resume: loop closures
    against pre-checkpoint keyframes still fire and map rebuilds still
    work (tests/test_keyframe_checkpoint.py).  Pass ``mesh`` to resume the
    sharded frontend/backend (inner state restored bit-identically via
    ``load_sharded_slam``)."""
    import jax.numpy as jnp_

    from ..models import keyframe_slam as km

    if mesh is not None:
        inner = load_sharded_slam(path, mesh)
        import os

        if not os.path.exists(path):
            # per-process shard checkpoint (the graph/extra leaves are
            # replicated, so this process's shard holds them in full)
            path = per_process_path(path)
        with np.load(path) as z:
            if "graph.poses" not in z:
                raise ValueError(f"{path} is not a keyframe checkpoint")
            graph = pose_graph.PoseGraph(
                **{
                    n: jnp_.asarray(z[f"graph.{n}"])
                    for n in pose_graph.PoseGraph._fields
                }
            )
    else:
        inner, graph = load_slam(path)
        if graph is None:
            raise ValueError(f"{path} is not a keyframe checkpoint")
    config = inner.config

    k = km.KeyframeSLAM.__new__(km.KeyframeSLAM)
    k.config = config
    k.kcfg = config.keyframes
    k.mesh = mesh
    if mesh is None:
        k._inner = inner
    else:
        k._sharded = inner
    k.graph = graph
    k._init_runtime_state()
    # restore the host mirrors from the loaded graph
    k._poses_np = np.asarray(graph.poses).astype(np.float32).copy()
    k._n_poses = int(graph.num_poses)
    k._n_edges = int(graph.num_edges)

    with np.load(path) as z:
        if "extra.kf_depths" in z:
            depths = np.asarray(z["extra.kf_depths"])
            fidx = np.asarray(z["extra.kf_frame_indices"])
            # recompute the downsampled ICP frames through the SAME jit
            # the live run uses (_kf_pre): an eager recomputation differs
            # in float association order and bends post-resume pair ICP
            # by ~mm
            k._ensure_batch_icps()
            for i in range(depths.shape[0]):
                dev = jnp_.asarray(depths[i])
                k.keyframes.append(
                    km._KeyframeRecord(
                        index=i,
                        frame_index=int(fidx[i]),
                        frame=k._kf_pre(dev),
                        depth_raw=depths[i],
                        depth_dev=dev,
                    )
                )
        if "extra.refs_k" in z:
            refs_k = np.asarray(z["extra.refs_k"])
            refs_rel = np.asarray(z["extra.refs_rel"])
            k._frame_refs = [
                (int(refs_k[i]), refs_rel[i]) for i in range(len(refs_k))
            ]
        if "extra.events_json" in z:
            events = json.loads(bytes(z["extra.events_json"]).decode())
            k.ba_events = events.get("ba_events", [])
            k.capacity_events = events.get("capacity_events", [])
            k.relocalizations = events.get("relocalizations", [])
            k.saturated = bool(events.get("saturated", False))
            k._frame_idx = int(events.get("frame_idx", len(k._frame_refs)))
            k._pending_ba_edges = int(events.get("pending_ba_edges", 0))
            k._pending_ba_since = int(
                events.get("pending_ba_since", k._frame_idx)
            )
            # _map_ledgered stays False (set by _init_runtime_state): the
            # contribution ledger does not survive a restart, so the first
            # significant correction after resume rebuilds fully
    return k


def export_trajectory_tum(path: str, poses: List, timestamps=None) -> None:
    """Write a trajectory in TUM format: ``t tx ty tz qx qy qz qw``.

    Interoperates with the standard TUM evaluation tooling; timestamps
    default to the frame index.
    """
    from .tum import matrix_to_quat

    lines = []
    for i, T in enumerate(poses):
        T = np.asarray(T)
        t = timestamps[i] if timestamps is not None else float(i)
        qx, qy, qz, qw = matrix_to_quat(T[:3, :3])
        lines.append(
            f"{t:.6f} {T[0,3]:.6f} {T[1,3]:.6f} {T[2,3]:.6f} "
            f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}"
        )
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def dump_sdf(path: str, hmap: hash_ops.HashMap, cfg) -> int:
    """Text dump of occupied blocks and their TSDF values — parity with the
    reference's printSDFdata (SDFRenderer.cpp:71-110 -> SDF_dump.txt).
    Returns the number of occupied blocks written."""
    from ..geometry import coords

    keys = np.asarray(hmap.keys)
    ptrs = np.asarray(hmap.ptrs)
    occ = np.nonzero(ptrs >= 0)[0]
    blocks = np.asarray(
        coords.unpack_block_key(jnp.asarray(keys[occ]), cfg.key_bits)
    )
    tsdf = np.asarray(hmap.tsdf)
    weight = np.asarray(hmap.weight)
    with open(path, "w") as f:
        f.write(f"# occupied blocks: {len(occ)}\n")
        for b, slot in enumerate(occ):
            p = ptrs[slot]
            f.write(
                f"block {tuple(int(x) for x in blocks[b])} ptr {int(p)} "
                f"maxw {weight[p].max():.3f}\n"
            )
            nz = np.nonzero(weight[p] > 0)[0]
            for v in nz:
                f.write(f"  {v} {tsdf[p, v]:.5f} {weight[p, v]:.2f}\n")
    return len(occ)
