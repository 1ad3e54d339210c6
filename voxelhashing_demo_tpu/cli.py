"""Command-line entry point — the framework's application layer.

The reference's L5/L6 layers (DepthMain.cpp `main` + Application.cpp) load
two hard-coded depth PNGs, preprocess, (skip the commented-out Align,
Application.cpp:75), integrate at identity, dump the SDF, and spin an SDL
render loop.  This CLI is the completed, scriptable equivalent:

    python -m voxelhashing_demo_tpu demo  t0.png t1.png --out out/
        two-frame pipeline (DepthMain parity — with Align actually wired)
    python -m voxelhashing_demo_tpu run   --dataset DIR | --synthetic N
        full SLAM over a TUM sequence or synthetic scene; trajectory,
        metrics, checkpoint, renders
    python -m voxelhashing_demo_tpu render --checkpoint ck.npz --orbit 12
        offline orbit renders of a saved map (the render-loop equivalent)
    python -m voxelhashing_demo_tpu info  --checkpoint ck.npz
        checkpoint summary (map occupancy, trajectory length)

Every command prints one JSON line of structured results at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


# Standard TUM RGB-D camera calibrations (ROS defaults per sequence
# family, vision.in.tum.de/data/datasets/rgbd-dataset/file_formats).
# The reference hard-codes fr1 only (common.h:7-10).
INTRINSIC_PRESETS = {
    "fr1": (517.3, 516.5, 318.6, 255.3),
    "fr2": (520.9, 521.0, 325.1, 249.7),
    "fr3": (535.4, 539.2, 320.1, 247.6),
}


def _default_config(args) -> "PipelineConfig":
    from .config import (CameraConfig, GCConfig, HashConfig, ICPConfig,
                         KeyframeConfig, PipelineConfig, StreamConfig)

    cam = CameraConfig()
    preset = getattr(args, "preset", "")
    if preset:
        fx, fy, cx, cy = INTRINSIC_PRESETS[preset]
        cam = CameraConfig(fx=fx, fy=fy, cx=cx, cy=cy)
    if getattr(args, "intrinsics", ""):
        vals = [float(v) for v in args.intrinsics.split(",")]
        if len(vals) != 4:
            raise SystemExit("--intrinsics expects FX,FY,CX,CY")
        import dataclasses as _dc

        cam = _dc.replace(cam, fx=vals[0], fy=vals[1], cx=vals[2],
                          cy=vals[3])
    if args.small:
        # quarter-resolution of whatever calibration was selected above —
        # a full CameraConfig replacement here would silently discard an
        # explicit --preset/--intrinsics
        cam = cam.scaled(4)
    stream = StreamConfig(enabled=bool(getattr(args, "stream", False)))
    kf = KeyframeConfig()
    if getattr(args, "kf_rotation", None) is not None:
        import dataclasses as _dc

        kf = _dc.replace(kf, min_rotation_deg=args.kf_rotation)
    if getattr(args, "kf_translation", None) is not None:
        import dataclasses as _dc

        kf = _dc.replace(kf, min_translation=args.kf_translation)
    return PipelineConfig(
        camera=cam,
        icp=ICPConfig(pyramid=(4, 2, 1), pyramid_iters=(10, 5, 4)),
        hash=HashConfig(num_buckets=65536, bucket_size=4, num_blocks=65536,
                        max_active=4096, max_new_per_frame=4096,
                        candidate_stride=2),
        gc=GCConfig(enabled=True, interval=8),
        keyframes=kf,
        stream=stream,
    )


def _emit(result: dict) -> None:
    print(json.dumps(result))


# --------------------------------------------------------------------------
# demo: two-frame pipeline (reference Application.cpp parity)
# --------------------------------------------------------------------------

def cmd_demo(args) -> None:
    import jax.numpy as jnp

    from .models import hash_slam
    from .ops import icp as icp_ops
    from .ops import preprocess as pre_ops
    from .utils import checkpoint as ck
    from .utils import io as depth_io
    from .utils import synthetic, viz

    config = _default_config(args)
    cam = config.camera
    os.makedirs(args.out, exist_ok=True)

    if args.frames:
        t0 = depth_io.read_depth_png(args.frames[0])
        t1 = depth_io.read_depth_png(args.frames[1])
    else:
        # the reference's assets/T0.png, T1.png are absent from its repo
        # (Application.cpp:28-29); synthesize an equivalent pair
        depths, _ = synthetic.make_sequence(cam, 2, trans_amp=0.04,
                                            rot_amp_deg=2.0)
        t0, t1 = np.asarray(depths[0]), np.asarray(depths[1])

    f0 = pre_ops.preprocess(jnp.asarray(t0), cam)
    f1 = pre_ops.preprocess(jnp.asarray(t1), cam)

    # Align — the call the reference ships commented out (Application.cpp:75)
    res = icp_ops.icp_align(f1, f0, cam, config.icp)
    T_rel = np.asarray(res.transform)

    slam = hash_slam.HashSLAM(config)
    slam.process(jnp.asarray(t0))
    slam.process(jnp.asarray(t1))

    n_blocks = ck.dump_sdf(
        os.path.join(args.out, "SDF_dump.txt"), slam.state.hmap, config.hash
    )
    out = slam.render()
    viz.write_png_rgb(os.path.join(args.out, "render.png"),
                      viz.shade_rgb(out))
    viz.write_png_rgb(os.path.join(args.out, "normals.png"),
                      viz.normal_rgb(out.normals, out.hit))
    _emit({
        "command": "demo",
        "icp_inliers": int(res.count),
        "icp_error": float(res.error),
        "relative_translation_m": [float(x) for x in T_rel[:3, 3]],
        "occupied_blocks": n_blocks,
        "outputs": ["SDF_dump.txt", "render.png", "normals.png"],
    })


# --------------------------------------------------------------------------
# run: full SLAM over a sequence
# --------------------------------------------------------------------------

def cmd_run(args) -> None:
    import jax
    import jax.numpy as jnp

    from .models import hash_slam, keyframe_slam
    from .utils import checkpoint as ck
    from .utils import metrics, synthetic, tum, viz

    config = _default_config(args)
    cam = config.camera
    os.makedirs(args.out, exist_ok=True)

    timestamps = None
    if args.dataset:
        import glob as _glob

        has_tum_list = os.path.exists(os.path.join(args.dataset, "depth.txt"))
        is_scannet = not has_tum_list and os.path.isdir(
            os.path.join(args.dataset, "depth")
        )
        is_icl = not has_tum_list and not is_scannet and bool(
            _glob.glob(os.path.join(args.dataset, "*.depth"))
        )
        if is_scannet:
            # extracted ScanNet scene (depth/ mm PNGs + pose/ + intrinsic/);
            # the per-scene intrinsic file is authoritative — it carries the
            # mm depth scale and calibration the engine must run with
            import dataclasses as _dc

            from .utils import scannet as scannet_mod

            seq = scannet_mod.ScanNetSequence(args.dataset,
                                              max_frames=args.max_frames)
            config = _dc.replace(config, camera=seq.cam)
            cam = seq.cam
            depths, gt = seq.load_all()
            if not seq.has_gt or any(p is None for p in gt):
                gt = None
        elif is_icl:
            # native ICL-NUIM format (euclidean .depth + POV-Ray cams).
            # The configured camera is kept when its resolution matches
            # the files; a 640x480 dataset takes the ICL calibration.
            from .utils import icl as icl_mod

            first = sorted(_glob.glob(
                os.path.join(args.dataset, "*.depth")
            ))[0]
            with open(first) as f:
                n_vals = len(f.read().split())
            if n_vals != cam.width * cam.height:
                icam = icl_mod.icl_camera()
                if n_vals != icam.width * icam.height:
                    raise SystemExit(
                        f"{first}: {n_vals} values match neither the "
                        f"configured {cam.width}x{cam.height} nor ICL's "
                        f"{icam.width}x{icam.height}"
                    )
                import dataclasses as _dc

                config = _dc.replace(config, camera=icam)
                cam = icam
            seq = icl_mod.ICLSequence(args.dataset, cam=cam,
                                      max_frames=args.max_frames)
            depths, gt = seq.load_all()
        else:
            from .utils import stream, tum as tum_mod

            seq = tum_mod.TUMSequence(args.dataset,
                                      max_frames=args.max_frames)
            paths = [os.path.join(args.dataset, rel)
                     for _, rel, _ in seq.entries]
            timestamps = [t for t, _, _ in seq.entries]
            gt = ([p for _, _, p in seq.entries] if seq.has_gt else None)
            depths = stream.FramePipeline(paths, cam.width, cam.height)
    else:
        n = args.synthetic or 30
        depths, gt = synthetic.make_sequence(cam, n, trans_amp=0.10,
                                             rot_amp_deg=5.0)
    mesh = None
    if args.devices > 1:
        from .parallel import sharded as sharded_mod

        mesh = sharded_mod.make_mesh(args.devices)

    resumed_frames = 0
    if args.resume:
        # restart-from-checkpoint (failure recovery, SURVEY §5): the
        # remaining frames of the sequence continue the restored state
        if args.backend == "keyframe":
            slam = ck.load_keyframe_slam(args.resume, mesh)
            resumed_frames = len(slam._frame_refs)
        elif mesh is not None:
            slam = ck.load_sharded_slam(args.resume, mesh)
            resumed_frames = len(slam.trajectory)
        else:
            slam, _ = ck.load_slam(args.resume)
            resumed_frames = len(slam.trajectory)
        config = slam.config
        cam = config.camera
        # skip the already-processed prefix (gt stays full: final ATE
        # compares the whole trajectory, restored + new, against it)
        from .utils import stream as stream_mod

        if isinstance(depths, stream_mod.FramePipeline):
            depths = stream_mod.FramePipeline(
                depths.paths[resumed_frames:], cam.width, cam.height
            )
        else:
            depths = depths[resumed_frames:]
    elif args.backend == "keyframe":
        slam = keyframe_slam.KeyframeSLAM(config, mesh=mesh)
    elif mesh is not None:
        from .parallel import sharded as sharded_mod

        slam = sharded_mod.ShardedHashSLAM(config, mesh)
    else:
        slam = hash_slam.HashSLAM(config)

    def _save(name):
        if args.backend == "keyframe":
            ck.save_keyframe_slam(os.path.join(args.out, name), slam)
        else:
            ck.save_slam(os.path.join(args.out, name), slam,
                         graph=getattr(slam, "graph", None))

    # pack the per-frame scalars ON DEVICE in ONE jitted dispatch (no
    # fetch): materializing them field-by-field would cost ~6 blocking
    # fetches per frame, and an EAGER 6-op pack ~6 separate dispatches
    # per frame — the jit makes it one
    @jax.jit
    def _pack_info(info):
        return jnp.stack([
            info.tracked.astype(jnp.float32), info.icp_error,
            info.icp_iters.astype(jnp.float32),
            info.blocks_allocated.astype(jnp.float32),
            info.blocks_active.astype(jnp.float32),
            info.blocks_freed.astype(jnp.float32),
        ])

    infos = []
    sat_frames = set()
    live_frames = []
    t0 = time.perf_counter()
    for i, d in enumerate(depths):
        info = slam.process(jnp.asarray(np.asarray(d, dtype=np.uint16)))
        infos.append(_pack_info(info))
        if getattr(slam, "saturated", False):
            sat_frames.add(i)
        if (
            args.render_every
            and (i + 1) % args.render_every == 0
            and getattr(slam, "render", None) is not None
        ):
            # live on every backend; a sharded render() returns the
            # image row-sharded over the mesh — fetch reassembles it
            # (process-safe: np.asarray alone would raise on the
            # non-addressable rows of a multi-process mesh)
            from .parallel import distributed

            out = slam.render()
            out = type(out)(*(distributed.fetch(f) for f in out))
            name = f"live_{resumed_frames + i:05d}.png"
            viz.write_png_rgb(
                os.path.join(args.out, name),
                viz.shade_rgb(out),
            )
            live_frames.append(name)
        if (
            args.checkpoint_every
            and args.checkpoint
            and (i + 1) % args.checkpoint_every == 0
        ):
            _save(args.checkpoint)
    if hasattr(slam, "flush"):
        slam.flush()
    jax.block_until_ready(
        slam.state.pose if hasattr(slam, "state") else None
    )
    dt = time.perf_counter() - t0
    # per-frame records are materialized AFTER the clock stops, from ONE
    # stacked fetch (field-by-field float()/bool() would block once per
    # scalar)
    stats = np.asarray(jnp.stack(infos)) if infos else np.zeros((0, 6))
    records = []
    for i in range(stats.shape[0]):
        rec = {
            "frame": resumed_frames + i,
            "tracked": bool(stats[i, 0] > 0.5),
            "icp_error": float(stats[i, 1]),
            "icp_iters": int(stats[i, 2]),
            "blocks_allocated": int(stats[i, 3]),
            "blocks_active": int(stats[i, 4]),
            "blocks_freed": int(stats[i, 5]),
        }
        if i in sat_frames:
            # keyframe backend at graph capacity with growth disabled:
            # new keyframes/edges are being dropped (pure odometry)
            rec["backend_saturated"] = True
        records.append(rec)

    trajectory = (slam.trajectory() if callable(getattr(slam, "trajectory"))
                  else slam.trajectory)
    ck.export_trajectory_tum(
        os.path.join(args.out, "trajectory.txt"), trajectory,
        timestamps=timestamps[: len(trajectory)] if timestamps else None,
    )
    with open(os.path.join(args.out, "metrics.jsonl"), "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")

    inner = slam if isinstance(slam, hash_slam.HashSLAM) else None
    # sharded runs checkpoint too (save_slam gathers sharded leaves; resume
    # with checkpoint.load_sharded_slam, or load_slam for the single-chip
    # canonical view)
    saveable = inner
    if saveable is None and args.backend == "hash" and mesh is not None:
        saveable = slam
    result = {
        "command": "run",
        "frames": len(depths),
        "fps": round(len(depths) / dt, 2),
        "tracked_frames": sum(r["tracked"] for r in records),
    }
    if gt is not None and all(p is not None for p in gt):
        gt_np = [np.asarray(p) for p in gt]
        result["ate_rmse_m"] = round(
            metrics.ate_rmse(trajectory, gt_np), 5
        )
        # full evaluation in the run output (no separate `evaluate` step
        # needed on real datasets): unaligned ATE + relative pose error
        result["ate_rmse_unaligned_m"] = round(
            metrics.ate_rmse(trajectory, gt_np, align=False), 5
        )
        if len(trajectory) > 1:
            rpe_t, rpe_r = metrics.rpe(trajectory, gt_np, delta=1)
            result["rpe_trans_rmse_m"] = round(float(rpe_t), 6)
            result["rpe_rot_rmse_deg"] = round(float(rpe_r), 6)
    if getattr(slam, "store", None) is not None:
        result["stream"] = {
            "stored_blocks": len(slam.store),
            "evicted": slam.store.total_evicted,
            "restored": slam.store.total_restored,
        }
    if args.backend == "keyframe":
        result["keyframes"] = len(slam.keyframes)
        result["graph_edges"] = int(slam.graph.num_edges)
        result["ba_runs"] = len(slam.ba_events)
        result["graph_capacity"] = {
            "keyframes": int(slam.graph.poses.shape[0]),
            "edges": int(slam.graph.edges_ij.shape[0]),
        }
        result["backend_saturated"] = bool(slam.saturated)
        if slam.capacity_events:
            result["capacity_events"] = slam.capacity_events
        if slam.relocalizations:
            result["relocalizations"] = slam.relocalizations
        if mesh is None:
            # render-only wrapper (the checkpoint goes through
            # save_keyframe_slam below, which persists the full backend)
            hs = hash_slam.HashSLAM.__new__(hash_slam.HashSLAM)
            hs.config, hs.state, hs.trajectory, hs.infos = (
                config, slam.state, list(trajectory), [])
            hs._step = hash_slam.make_step(config)
            inner = hs
    if args.checkpoint and (saveable is not None
                            or args.backend == "keyframe"):
        _save(args.checkpoint)
        result["checkpoint"] = args.checkpoint
    if live_frames:
        result["live_frames"] = len(live_frames)
    if args.render_last and inner is not None:
        out = inner.render()
        viz.write_png_rgb(os.path.join(args.out, "final.png"),
                          viz.shade_rgb(out))
        viz.write_png_rgb(os.path.join(args.out, "final_depth.png"),
                          viz.depth_rgb(out.depth))
        result["renders"] = ["final.png", "final_depth.png"]
    _emit(result)


# --------------------------------------------------------------------------
# render: offline orbit of a checkpointed map
# --------------------------------------------------------------------------

def cmd_render(args) -> None:
    import jax.numpy as jnp

    from .utils import checkpoint as ck
    from .utils import viz

    slam, _ = ck.load_slam(args.checkpoint)
    os.makedirs(args.out, exist_ok=True)

    if args.orbit > 1:
        pose0 = np.asarray(slam.state.pose)
        center = pose0[:3, 3] + pose0[:3, 2] * args.orbit_distance
        poses = viz.orbit_poses(center, args.orbit_distance,
                                height=-0.2, n_frames=args.orbit,
                                sweep_deg=args.sweep)
    else:
        poses = [np.asarray(slam.state.pose)]

    names, hits = [], []
    for i, T in enumerate(poses):
        out = slam.render(jnp.asarray(T))
        name = f"orbit_{i:03d}.png"
        viz.write_png_rgb(os.path.join(args.out, name), viz.shade_rgb(out))
        names.append(name)
        hits.append(float(np.asarray(out.hit).mean()))
    result = {"command": "render", "frames": names, "hit_fraction": hits}
    if args.ply:
        from .utils import pointcloud

        n = pointcloud.export_map_ply(
            os.path.join(args.out, args.ply), slam.state.hmap,
            slam.config.hash, slam.config.fusion,
        )
        result["ply"] = {"file": args.ply, "points": n}
    if args.mesh:
        from .utils import meshing

        n = meshing.export_mesh_ply(
            os.path.join(args.out, args.mesh), slam.state.hmap,
            slam.config.hash, slam.config.fusion,
        )
        result["mesh"] = {"file": args.mesh, "faces": n}
    _emit(result)


def cmd_info(args) -> None:
    from .utils import checkpoint as ck

    slam, graph = ck.load_slam(args.checkpoint)
    hmap = slam.state.hmap
    occupied = int(np.sum(np.asarray(hmap.ptrs) >= 0))
    result = {
        "command": "info",
        "config": json.loads(ck.config_to_json(slam.config)),
        "occupied_blocks": occupied,
        "free_blocks": int(slam.state.hmap.free_top),
        "frames_processed": int(slam.state.frame_idx),
        "trajectory_poses": len(slam.trajectory),
    }
    if graph is not None:
        result["graph"] = {
            "keyframes": int(graph.num_poses),
            "edges": int(graph.num_edges),
        }
    _emit(result)


def cmd_evaluate(args) -> None:
    """TUM-tooling-style trajectory evaluation: associate two TUM-format
    trajectory files by timestamp, report ATE RMSE and RPE."""
    from .utils import metrics, tum

    est_list = tum._parse_list(args.est)
    gt_list = tum._parse_list(args.gt)
    pairs = tum.associate(est_list, gt_list, max_dt=args.max_dt)
    if len(pairs) < 2:
        raise SystemExit(
            f"only {len(pairs)} timestamp associations (need >= 2)"
        )
    est = [tum.TUMSequence._pose_from(d) for _, d, _, _ in pairs]
    gt = [tum.TUMSequence._pose_from(g) for _, _, _, g in pairs]
    result = {
        "command": "evaluate",
        "pairs": len(pairs),
        "ate_rmse_m": round(metrics.ate_rmse(est, gt, align=True), 6),
        "ate_rmse_unaligned_m": round(
            metrics.ate_rmse(est, gt, align=False), 6
        ),
    }
    rpe_t, rpe_r = metrics.rpe(est, gt, delta=args.rpe_delta)
    result["rpe_trans_rmse_m"] = round(float(rpe_t), 6)
    result["rpe_rot_rmse_deg"] = round(float(rpe_r), 6)
    _emit(result)


def cmd_bench(args) -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench

    bench.main()


# --------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="voxelhashing_demo_tpu",
        description="Dense RGB-D SLAM engine (voxel hashing)",
    )
    p.add_argument("--small", action="store_true",
                   help="160x120 config for quick runs")
    sub = p.add_subparsers(dest="command", required=True)

    d = sub.add_parser("demo", help="two-frame pipeline (reference demo)")
    d.add_argument("frames", nargs="*", help="two 16-bit depth PNGs")
    d.add_argument("--out", default="demo_out")
    d.set_defaults(fn=cmd_demo)

    r = sub.add_parser("run", help="full SLAM over a sequence")
    r.add_argument("--preset", choices=sorted(INTRINSIC_PRESETS),
                   default="",
                   help="TUM camera calibration preset (freiburg1/2/3 "
                        "sequence families)")
    r.add_argument("--intrinsics", default="", metavar="FX,FY,CX,CY",
                   help="override the camera intrinsics (applied after "
                        "--preset; dataset-provided calibration, e.g. "
                        "ScanNet's intrinsic/ file, still wins)")
    r.add_argument("--dataset",
                   help="sequence directory: TUM (depth.txt), native "
                        "ICL-NUIM (*.depth), or extracted ScanNet "
                        "(depth/ + pose/ + intrinsic/), auto-detected")
    r.add_argument("--synthetic", type=int, metavar="N",
                   help="use N synthetic frames instead of a dataset")
    r.add_argument("--max-frames", type=int, default=None)
    r.add_argument("--backend", choices=("hash", "keyframe"),
                   default="hash")
    r.add_argument("--kf-rotation", type=float, default=None,
                   metavar="DEG",
                   help="keyframe insertion rotation threshold (degrees)")
    r.add_argument("--kf-translation", type=float, default=None,
                   metavar="M",
                   help="keyframe insertion translation threshold (meters)")
    r.add_argument("--devices", type=int, default=1,
                   help="shard the map over this many devices (pjit mesh)")
    r.add_argument("--stream", action="store_true",
                   help="out-of-frustum block streaming to a host store "
                        "(scene size bounded by host RAM, not num_blocks)")
    r.add_argument("--out", default="run_out")
    r.add_argument("--checkpoint", default="map.npz",
                   help="checkpoint filename (empty to skip)")
    r.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="also checkpoint every N frames (restart story)")
    r.add_argument("--resume", default="",
                   help="restore a checkpoint and continue the sequence "
                        "from the frame after its last pose")
    r.add_argument("--render-last", action="store_true")
    r.add_argument("--render-every", type=int, default=0, metavar="N",
                   help="write a live view (live_FFFFF.png shaded render "
                        "of the current map) every N frames — the "
                        "headless equivalent of the reference's SDL "
                        "window (Application.cpp:120-155)")
    r.set_defaults(fn=cmd_run)

    v = sub.add_parser("render", help="offline renders of a checkpoint")
    v.add_argument("--checkpoint", required=True)
    v.add_argument("--out", default="render_out")
    v.add_argument("--orbit", type=int, default=1)
    v.add_argument("--orbit-distance", type=float, default=1.5)
    v.add_argument("--sweep", type=float, default=60.0)
    v.add_argument("--ply", default="",
                   help="also export the surface point cloud (filename)")
    v.add_argument("--mesh", default="",
                   help="also export a triangle mesh (marching tetrahedra)")
    v.set_defaults(fn=cmd_render)

    i = sub.add_parser("info", help="checkpoint summary")
    i.add_argument("--checkpoint", required=True)
    i.set_defaults(fn=cmd_info)

    e = sub.add_parser("evaluate",
                       help="ATE/RPE of a TUM-format trajectory vs GT")
    e.add_argument("--est", required=True,
                   help="estimated trajectory (TUM format, e.g. the run "
                        "command's trajectory.txt)")
    e.add_argument("--gt", required=True, help="ground truth (TUM format)")
    e.add_argument("--max-dt", type=float, default=0.02)
    e.add_argument("--rpe-delta", type=int, default=1)
    e.set_defaults(fn=cmd_evaluate)

    b = sub.add_parser("bench", help="run the throughput benchmark")
    b.set_defaults(fn=cmd_bench)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
