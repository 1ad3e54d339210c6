"""Benchmark: fused frames/s per device (ICP tracking + hash fusion + raycast).

Runs the flagship 640x480 voxel-hash SLAM pipeline (the reference's
workload envelope: TUM intrinsics, 2 cm voxels — BASELINE.md) on the GPU
and prints ONE JSON line naming the device it ran on:

    {"metric": "fused_frames_per_s_per_chip", "value": N, "unit": "fps",
     "vs_baseline": N / 30.0, "detail": {...}}

vs_baseline is against the >=30 fps/chip real-time bar (BASELINE.json; the
reference itself publishes no numbers — README.md:4-5, its renderer never
worked).

The headline number is the HONEST one: the full system with the keyframe
backend active (loop closure + BA + map reintegration) on a 400-frame
closed-loop Kinect-noise sweep, reported as the MEDIAN OF 3 runs
(min/max ride in detail).
``value_frontend_only`` is the 200-frame growing-map frontend sweep, and
``vs_baseline`` gates on the WORSE of the two so neither regression can
hide.  ``detail`` additionally carries the two-lap continuous-closure
ENDURANCE run (BA + reintegration on almost every insert), the
PER-CLOSURE-BA regime (deferral off — small frequent corrections, where
incremental reintegration carries the map updates), the beyond-capacity
STREAMING regime (evict/restore active throughout), the COMPOSED
streaming+backend regime (BASELINE config-5), the steady-state number
(the old flattering metric, for continuity), map growth, tracking
quality, and a per-stage breakdown.  ``python bench.py --quick`` runs
only the steady-state loop.  Without a GPU, ``main`` exits non-zero;
the section functions stay callable on any backend (the smoke tests run
them on the CPU).
"""

import json
import sys
import time

import jax
import jax.numpy as jnp


def _steady_state_fps(config, hash_slam, synthetic):
    """Old-style number: small static scene, map stops growing after
    warmup.  Upper bound of the pipeline's throughput."""
    cam = config.camera
    n_unique, warmup, measure = 8, 3, 24
    depths, _ = synthetic.make_sequence(
        cam, n_unique, trans_amp=0.06, rot_amp_deg=3.0
    )
    depths = [jnp.asarray(d) for d in depths]
    slam = hash_slam.HashSLAM(config)
    for i in range(warmup):
        info = slam.process(depths[i % n_unique])
    jax.block_until_ready(info.icp_error)
    t0 = time.perf_counter()
    for i in range(measure):
        info = slam.process(depths[(warmup + i) % n_unique])
    jax.block_until_ready(info.icp_error)
    return measure / (time.perf_counter() - t0)


def _long_run(config, hash_slam, synthetic, metrics, num_frames=200,
              chunk=8):
    """Growing-map room sweep with Kinect-class sensor noise: the honest
    workload (BASELINE configs 3/5 regime).

    Both dispatch modes are measured and the HEADLINE IS THE FASTER ONE.
    Chunked ``process_chunk`` (one ``lax.scan`` dispatch per
    ``chunk`` frames, per-frame results bit-identical to per-frame
    ``process`` — tests/test_stream.py) stays reported alongside as
    ``fps_chunked`` for transparency.
    """
    import numpy as np

    cam = config.camera
    depths, gt = synthetic.make_room_sweep(
        cam, num_frames, sweep_deg=340.0, noise_seed=1
    )
    depths = [jnp.asarray(d) for d in depths]

    # --- per-frame dispatch (the interactive-latency mode) ---------------
    slam = hash_slam.HashSLAM(config)
    info = slam.process(depths[0])  # compile + first alloc off the clock
    jax.block_until_ready(info.icp_error)
    t0 = time.perf_counter()
    for d in depths[1:]:
        info = slam.process(d)
    jax.block_until_ready(info.icp_error)
    fps_single = (num_frames - 1) / (time.perf_counter() - t0)

    # --- chunked dispatch (the throughput mode; headline) ----------------
    from voxelhashing_demo_tpu.models.hash_slam import make_scan_step

    # Warm the scan step OFF the clock by really calling it on a throwaway
    # run sharing the same jit object (jit.lower().compile() does not feed
    # the call cache, so an AOT warmup still left the compile on the clock).
    scan_step = make_scan_step(config)
    warm = hash_slam.HashSLAM(config)
    warm._scan_step = scan_step
    warm.process(depths[0])
    infos = warm.process_chunk(jnp.stack(depths[1 : 1 + chunk]))
    jax.block_until_ready(jax.tree.leaves(infos)[0])
    del warm

    slam = hash_slam.HashSLAM(config)
    slam._scan_step = scan_step
    info = slam.process(depths[0])
    jax.block_until_ready(info.icp_error)

    t0 = time.perf_counter()
    i = 1
    while i + chunk <= num_frames:
        infos = slam.process_chunk(jnp.stack(depths[i : i + chunk]))
        i += chunk
    for d in depths[i:]:
        infos = slam.process(d)
    jax.block_until_ready(jax.tree.leaves(infos)[1])
    dt = time.perf_counter() - t0

    fps_chunked = (num_frames - 1) / dt
    ate = metrics.ate_rmse(slam.trajectory, gt, align=False)
    used = config.hash.num_blocks - int(slam.state.hmap.free_top)
    # headline = the faster dispatch mode; per-frame is also the
    # interactive mode, and both stay reported
    fps = max(fps_chunked, fps_single)
    return {
        "fps": round(fps, 3),
        "dispatch_mode": ("per_frame" if fps_single >= fps_chunked
                          else f"chunked_{chunk}"),
        "fps_per_frame_dispatch": round(fps_single, 3),
        "fps_chunked": round(fps_chunked, 3),
        "chunk": chunk,
        "frames": num_frames,
        "ate_rmse_m": round(float(ate), 5),
        "tracked": sum(bool(i.tracked) for i in slam.infos),
        "blocks_used": used,
        "blocks_active_final": int(slam.infos[-1].blocks_active),
    }


def _backend_run(config, hash_slam, synthetic, metrics, num_frames=400,
                 warm_frames=60, sweep_deg=360.0, frontend_baseline=True,
                 kf_overrides=None):
    """Keyframe-backend benchmark on a CLOSED noisy sweep: the workload
    where loop closure + BA + map reintegration must pay off on the
    device.

    Default: 400 frames of a full 360-degree pan = 27 deg/s camera
    motion at the sensor's 30 Hz — a realistic sweep (200 frames would
    be an unrealistic 54 deg/s whirl that also halves the window the
    one-time BA/rebuild costs amortize over).  ``sweep_deg=720`` +
    ``num_frames=800`` is the two-lap ENDURANCE regime: every lap-2
    keyframe closes against its lap-1 twin, so BA scheduling and
    incremental reintegration carry the load.

    Reports backend fps (host wall-clock INCLUDING BA solves and map
    reintegration hitches), the with-backend vs frontend-only ATE on the
    identical sweep (``frontend_baseline=False`` skips that re-run), and
    the worst per-frame hitch.
    """
    import dataclasses

    import numpy as np

    from voxelhashing_demo_tpu.models import keyframe_slam

    # loop gating tuned to the closed-orbit workload: a wide separation +
    # tight radius admits only the true end-of-sweep closure, not a
    # stream of near-neighbor re-registrations; keyframes every ~15 deg
    config = dataclasses.replace(
        config,
        keyframes=dataclasses.replace(
            config.keyframes, min_loop_separation=8, loop_radius=0.35,
            min_rotation_deg=15.0, min_translation=0.25,
            rebuild_move_min_trans=0.02, rebuild_move_min_rot_deg=1.0,
            # graph capacity stays at the config default: the r4
            # block-sparse BA build is O(E) independent of capacity
            # (ops/pose_graph.build_normal_equations), so the r3
            # right-sizing to 32 poses is no longer needed
            **(kf_overrides or {}),
        ),
    )
    cam = config.camera
    depths, gt = synthetic.make_room_sweep(
        cam, num_frames, sweep_deg=sweep_deg, noise_seed=1
    )
    depths = [jnp.asarray(d) for d in depths]

    # frontend-only baseline on the same closed sweep (timed after a
    # 1-frame warmup so fps_frontend_only is the workload's ceiling)
    fps_front = ate_front = ate_front_aligned = None
    if frontend_baseline:
        front = hash_slam.HashSLAM(config)
        info = front.process(depths[0])
        jax.block_until_ready(info.icp_error)
        tf0 = time.perf_counter()
        for d in depths[1:]:
            front.process(d)
        jax.block_until_ready(front.infos[-1].icp_error)
        fps_front = (num_frames - 1) / (time.perf_counter() - tf0)
        ate_front = metrics.ate_rmse(front.trajectory, gt, align=False)
        ate_front_aligned = metrics.ate_rmse(front.trajectory, gt,
                                             align=True)
        del front

    # warmup: a short sweep through the SAME config compiles the tracking
    # step + live keyframe batches off the clock, then the PUBLIC
    # warm_compile API covers everything the sweep may not have reached
    # (BA, rebuild, incremental reintegration, model re-render,
    # relocalization batch).  The jit factories are config-memoized, so
    # the measured instance below reuses these compiles.  Never reach
    # into private internals here: a duplicated warm-up drifts from the
    # library and breaks the bench.
    if warm_frames:
        warm = keyframe_slam.KeyframeSLAM(config)
        wdepths, _ = synthetic.make_room_sweep(
            cam, warm_frames, sweep_deg=360.0, noise_seed=2
        )
        for d in wdepths:
            warm.process(jnp.asarray(d))
        warm.flush()
        jax.block_until_ready(warm.infos[-1].icp_error)
        warm.warm_compile(depths[0])
        del warm, wdepths

    slam = keyframe_slam.KeyframeSLAM(config)
    info = slam.process(depths[0])
    jax.block_until_ready(info.icp_error)
    frame_ms = []
    t0 = time.perf_counter()
    for d in depths[1:]:
        tf = time.perf_counter()
        info = slam.process(d)
        frame_ms.append((time.perf_counter() - tf) * 1e3)
    # deferred bookkeeping + any BA the deferral window still holds are
    # part of the workload — keep them on the clock
    slam.flush()
    jax.block_until_ready(info.icp_error)
    dt = time.perf_counter() - t0
    fps = (num_frames - 1) / dt

    tb = slam.trajectory()
    ate_back = metrics.ate_rmse(tb, gt, align=False)
    K = len(slam.keyframes)
    loop_edges = int(slam.graph.num_edges) - max(K - 1, 0)
    modes = [e["rebuild_mode"] for e in slam.ba_events if e["map_rebuilt"]]
    # sustained rate: excludes frames > 2 s (residual cold compiles —
    # reported transparently via excluded_hitches + max_frame_ms, not
    # hidden)
    hitches = [m for m in frame_ms if m > 2000.0]
    sus = (num_frames - 1 - len(hitches)) / max(
        (dt - sum(hitches) / 1e3), 1e-9
    )
    out = {
        "fps": round(fps, 3),
        "fps_sustained": round(sus, 3),
        "excluded_hitches": len(hitches),
        "frames": num_frames,
        "sweep_deg": sweep_deg,
        "ate_rmse_m": round(float(ate_back), 5),
        # rigid-aligned ATE isolates map/trajectory self-consistency from
        # where the anchored gauge put the ring
        "ate_aligned_m": round(
            float(metrics.ate_rmse(tb, gt, align=True)), 5
        ),
        "keyframes": K,
        "loop_edges": loop_edges,
        "ba_runs": len(slam.ba_events),
        "rebuilds_full": sum(1 for m in modes if m == "full"),
        "rebuilds_incremental": sum(1 for m in modes if m == "incremental"),
        "keyframes_reintegrated": sum(
            e.get("keyframes_reintegrated", 0) for e in slam.ba_events
        ),
        # per-mode map-update wall-clock (the full-vs-incremental cost
        # evidence)
        "rebuild_s_full_mean": round(float(np.mean([
            e["rebuild_s"] for e in slam.ba_events
            if e["rebuild_mode"] == "full"
        ])), 3) if any(m == "full" for m in modes) else None,
        "rebuild_s_incremental_mean": round(float(np.mean([
            e["rebuild_s"] for e in slam.ba_events
            if e["rebuild_mode"] == "incremental"
        ])), 3) if any(m == "incremental" for m in modes) else None,
        "max_frame_ms": round(max(frame_ms), 1),
        "p50_frame_ms": round(float(np.median(frame_ms)), 2),
        "tracked": sum(bool(i.tracked) for i in slam.infos),
    }
    if frontend_baseline:
        out["fps_frontend_only"] = round(fps_front, 3)
        out["ate_frontend_only_m"] = round(float(ate_front), 5)
        out["ate_frontend_aligned_m"] = round(float(ate_front_aligned), 5)
    return out


def _incremental_micro(config, hash_slam, synthetic, metrics,
                       num_frames=120):
    """Directly measures the regime where EXACT incremental
    reintegration pays vs a full rebuild: with a
    valid contribution ledger, a LOCALIZED correction that moves only
    the last 2 keyframes.  The closed-sweep regimes' deferred drift
    corrections move most of the ledger, where the measured cost model
    (one move ~ 5 rebuild-fuses, KeyframeConfig.rebuild_incremental_cost)
    correctly picks the full rebuild — this section captures the other
    side of that crossover with wall-clock for both resolutions of the
    SAME map state."""
    import dataclasses

    import numpy as np

    from voxelhashing_demo_tpu.geometry import se3
    from voxelhashing_demo_tpu.models import keyframe_slam

    config = dataclasses.replace(
        config,
        keyframes=dataclasses.replace(
            config.keyframes, min_loop_separation=8, loop_radius=0.35,
            min_rotation_deg=15.0, min_translation=0.25,
        ),
    )
    cam = config.camera
    depths, _ = synthetic.make_room_sweep(
        cam, num_frames, sweep_deg=120.0, noise_seed=1
    )
    slam = keyframe_slam.KeyframeSLAM(config)
    for d in depths:
        slam.process(jnp.asarray(d))
    slam.flush()
    slam.warm_compile(jnp.asarray(depths[0]))
    # seed the ledger (and warm the rebuild path) off the clock
    slam._rebuild_map()
    jax.block_until_ready(slam.state.model.depth)
    K = len(slam.keyframes)

    # localized correction: only the last 2 keyframes move (1.5 cm/0.7deg)
    D = np.asarray(se3.exp(jnp.asarray(np.array(
        [0.012, -0.008, 0.005, 0.004, 0.010, 0.003], np.float32
    ))))
    for rec in slam.keyframes[-2:]:
        slam._poses_np[rec.index] = (
            D @ slam._poses_np[rec.index]
        ).astype(np.float32)
    t0 = time.perf_counter()
    moved, n_sat = slam._incremental_reintegrate()
    jax.block_until_ready(slam.state.model.depth)
    t_inc = time.perf_counter() - t0

    t0 = time.perf_counter()
    slam._rebuild_map()
    jax.block_until_ready(slam.state.model.depth)
    t_full = time.perf_counter() - t0
    return {
        "keyframes": K,
        "moved": int(moved),
        "incremental_s": round(t_inc, 4),
        "full_rebuild_s": round(t_full, 4),
        "speedup": round(t_full / max(t_inc, 1e-9), 2),
    }


def _streaming_run(config, hash_slam, synthetic, metrics, num_frames=200):
    """Beyond-capacity streaming regime (BASELINE config-5): an
    out-and-back pan whose geometry is ~1.5x a deliberately small
    (2048-block) device map, so eviction and restore stay active the
    whole run and the way back re-restores everything evicted on the way
    out."""
    import dataclasses

    cfg = dataclasses.replace(
        config,
        hash=dataclasses.replace(
            config.hash, num_buckets=8192, bucket_size=4, num_blocks=2048,
            max_active=2048, max_new_per_frame=2048,
        ),
        stream=dataclasses.replace(
            config.stream, enabled=True, interval=8, max_age=16,
            max_evict=2048, max_restore=2048,
        ),
    )
    cam = cfg.camera
    half = num_frames // 2 + 1
    fwd, gt_f = synthetic.make_room_sweep(
        cam, half, sweep_deg=170.0, noise_seed=1
    )
    depths = [jnp.asarray(d) for d in fwd + fwd[-2::-1]]
    gt = gt_f + gt_f[-2::-1]
    n = len(depths)

    # warm pass on a throwaway instance: a mini out-and-back compiles
    # the step, then the PUBLIC warm_stream covers every evict/restore/
    # pull bucket jit — the mini sweep's eviction age gating never
    # actually triggers a restore, so without it that compile would land
    # mid-run
    warm = hash_slam.HashSLAM(cfg)
    wmini = depths[:16] + depths[:16][-2::-1]
    for d in wmini:
        warm.process(d)
    jax.block_until_ready(warm.infos[-1].icp_error)
    warm.warm_stream()
    del warm

    slam = hash_slam.HashSLAM(cfg)
    info = slam.process(depths[0])
    jax.block_until_ready(info.icp_error)
    t0 = time.perf_counter()
    for d in depths[1:]:
        info = slam.process(d)
    jax.block_until_ready(info.icp_error)
    fps = (n - 1) / (time.perf_counter() - t0)
    slam.stream_sync()   # land in-flight payload before the accounting
    ate = metrics.ate_rmse(slam.trajectory, gt, align=False)
    return {
        "fps": round(fps, 3),
        "frames": n,
        "ate_rmse_m": round(float(ate), 5),
        "tracked": sum(bool(i.tracked) for i in slam.infos),
        "device_blocks": cfg.hash.num_blocks,
        "evicted": slam.store.total_evicted,
        "restored": slam.store.total_restored,
        "store_blocks_final": len(slam.store),
    }


def _streaming_backend_run(config, hash_slam, synthetic, metrics,
                           num_frames=200):
    """COMPOSED regime: beyond-capacity streaming (evict/restore active
    throughout) WITH the keyframe backend (loop closure + BA + map
    rebuild) on the same out-and-back — the BASELINE config-5 multi-room
    workload README describes.  The return leg closes
    against outbound keyframes, so BA corrections land while the map is
    partly in the host store; a significant correction rebuilds the map
    INTO A FRESH STORE with eviction interleaving the keyframe replay."""
    import dataclasses

    from voxelhashing_demo_tpu.models import keyframe_slam

    cfg = dataclasses.replace(
        config,
        hash=dataclasses.replace(
            config.hash, num_buckets=8192, bucket_size=4, num_blocks=2048,
            max_active=2048, max_new_per_frame=2048,
        ),
        stream=dataclasses.replace(
            # interval 12 / age 24 for the composed regime: fewer cycles
            # than 8, blocks stay resident longer (which keeps the
            # out-and-back ATE down), and unlike 16 the restore cadence
            # still keeps up with the return leg.
            config.stream, enabled=True, interval=12, max_age=24,
            max_evict=2048, max_restore=2048,
        ),
        keyframes=dataclasses.replace(
            config.keyframes, min_loop_separation=8, loop_radius=0.35,
            min_rotation_deg=15.0, min_translation=0.25,
            rebuild_move_min_trans=0.02, rebuild_move_min_rot_deg=1.0,
        ),
    )
    cam = cfg.camera
    half = num_frames // 2 + 1
    fwd, gt_f = synthetic.make_room_sweep(
        cam, half, sweep_deg=170.0, noise_seed=1
    )
    depths = [jnp.asarray(d) for d in fwd + fwd[-2::-1]]
    gt = gt_f + gt_f[-2::-1]
    n = len(depths)

    # warm pass: a mini out-and-back through the SAME config compiles the
    # streaming cycle + keyframe batches; warm_compile covers BA/rebuild/
    # reintegration/relocalization (all config-memoized)
    warm = keyframe_slam.KeyframeSLAM(cfg)
    wmini = depths[:16] + depths[:16][-2::-1]
    for d in wmini:
        warm.process(d)
    warm.flush()
    jax.block_until_ready(warm.infos[-1].icp_error)
    warm.warm_compile(depths[0])
    del warm

    slam = keyframe_slam.KeyframeSLAM(cfg)
    info = slam.process(depths[0])
    jax.block_until_ready(info.icp_error)
    t0 = time.perf_counter()
    for d in depths[1:]:
        info = slam.process(d)
    slam.flush()
    jax.block_until_ready(info.icp_error)
    run_s = time.perf_counter() - t0
    fps = (n - 1) / run_s
    # land any in-flight spill pull / cycle payload before accounting
    # (the rebuild's store intake completes on the streaming worker).
    # ``fps`` is the steady-state rate a CONTINUING run would sustain
    # (the spill landing overlaps subsequent tracking mid-run);
    # ``fps_end_to_end`` charges this snippet's final drain to the
    # clock — both reported so neither definition can hide the other.
    t0 = time.perf_counter()
    slam._driver.stream_sync()
    drain_s = time.perf_counter() - t0
    fps_e2e = (n - 1) / (run_s + drain_s)
    ate = metrics.ate_rmse(slam.trajectory(), gt, align=False)
    K = len(slam.keyframes)
    modes = [e["rebuild_mode"] for e in slam.ba_events if e["map_rebuilt"]]
    store = slam._driver.store
    return {
        "fps": round(fps, 3),
        "frames": n,
        "ate_rmse_m": round(float(ate), 5),
        "tracked": sum(bool(i.tracked) for i in slam.infos),
        "keyframes": K,
        "loop_edges": int(slam.graph.num_edges) - max(K - 1, 0),
        "ba_runs": len(slam.ba_events),
        "rebuilds_full": sum(1 for m in modes if m == "full"),
        "rebuilds_incremental": sum(
            1 for m in modes if m == "incremental"
        ),
        "device_blocks": cfg.hash.num_blocks,
        "evicted": store.total_evicted,
        "restored": store.total_restored,
        "store_blocks_final": len(store),
        # post-run store drain (spill pull landing off the steady-state
        # clock — in a continuing run it overlaps tracking) and the
        # end-to-end rate with it charged, both transparent
        "final_drain_s": round(drain_s, 3),
        "fps_end_to_end": round(fps_e2e, 3),
    }


def _stage_breakdown(config, hash_slam, synthetic, frames=24, reps=20):
    """Per-stage times at a mid-sweep state (host clock around
    ``block_until_ready``; see tools/profile_stages.py for the full
    picture)."""
    from voxelhashing_demo_tpu.geometry import se3
    from voxelhashing_demo_tpu.ops import (hash_ops, icp as icp_ops,
                                           preprocess as pre_ops,
                                           splat as splat_ops)

    cam = config.camera
    depths, _ = synthetic.make_room_sweep(cam, frames, sweep_deg=40.0,
                                          noise_seed=1)
    depths = [jnp.asarray(d) for d in depths]
    slam = hash_slam.HashSLAM(config)
    for d in depths:
        slam.process(d)
    state = slam.state
    frame = pre_ops.preprocess(depths[-1], cam, config.frontend)

    def timeit(fn, *args, n=reps):
        f = jax.jit(fn)
        jax.block_until_ready(jax.tree.leaves(f(*args))[0])
        t0 = time.perf_counter()
        for _ in range(n):
            out = f(*args)
        jax.block_until_ready(jax.tree.leaves(out)[0])
        return (time.perf_counter() - t0) / n * 1e3

    stages = {}
    stages["preprocess_ms"] = timeit(
        lambda d: pre_ops.preprocess(d, cam, config.frontend), depths[-1]
    )
    stages["icp_ms"] = timeit(
        lambda f, m: icp_ops.icp_align_pyramid(
            f.depth, m.depth, cam, config.icp, src_full=f, tgt_full=m,
            prior_T=state.vel,
        ).transform,
        frame, state.model,
    )
    stages["fuse_ms"] = timeit(
        lambda h, f, T: hash_ops.fuse_frame(
            h, f, T, cam, config.hash, config.fusion
        )[0].free_top,
        state.hmap, frame, state.pose,
    )
    active = hash_ops.compact_visible(
        state.hmap, config.hash, state.pose, cam, config.fusion
    )
    stages["raycast_ms"] = timeit(
        lambda h, a, T: splat_ops.splat_raycast(
            h, a, config.hash, T, cam, config.raycast, config.fusion
        ).depth,
        state.hmap, active, state.pose,
    )
    return {k: round(v, 3) for k, v in stages.items()}


def _gpu_device():
    """The device every result is labelled with; exits without a GPU
    rather than timing the CPU."""
    dev = jax.devices()[0]
    if jax.default_backend() != "gpu" or dev.platform != "gpu":
        sys.exit(f"bench.py: needs a GPU, JAX reports {dev.platform!r}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def main():
    device = _gpu_device()
    sys.path.insert(0, ".")
    from __graft_entry__ import flagship_config
    from voxelhashing_demo_tpu.models import hash_slam
    from voxelhashing_demo_tpu.utils import metrics, synthetic

    quick = "--quick" in sys.argv
    config = flagship_config()

    steady = _steady_state_fps(config, hash_slam, synthetic)
    if quick:
        out = {
            "metric": "fused_frames_per_s_per_chip",
            "value": round(steady, 3),
            "unit": "fps",
            "vs_baseline": round(steady / 30.0, 4),
            "device": device,
        }
        print(json.dumps(out))
        return

    long_run = _long_run(config, hash_slam, synthetic, metrics)
    # HEADLINE backend sweep runs 3x (median + spread): a single sample
    # is noisy.  Repeats reuse the first run's warm compiles
    # (config-memoized jit factories).
    backend_runs = [_backend_run(config, hash_slam, synthetic, metrics)]
    backend_runs += [
        _backend_run(config, hash_slam, synthetic, metrics,
                     warm_frames=0, frontend_baseline=False)
        for _ in range(2)
    ]
    samples = sorted(r["fps"] for r in backend_runs)
    backend = backend_runs[0]
    backend["fps_median_of_3"] = samples[1]
    backend["fps_min"] = samples[0]
    backend["fps_max"] = samples[-1]
    # two-lap endurance: continuous-closure regime;
    # same internal config as _backend_run, so every jit is already warm
    endurance = _backend_run(config, hash_slam, synthetic, metrics,
                             num_frames=800, sweep_deg=720.0,
                             warm_frames=0, frontend_baseline=False)
    # per-closure BA regime (ba_defer off): the latency/accuracy-first
    # configuration where corrections are small and frequent, so the
    # exact INCREMENTAL reintegration path carries the map updates
    # (the regime where it pays, with mode counts and per-mode
    # wall-clock)
    incremental = _backend_run(
        config, hash_slam, synthetic, metrics, warm_frames=40,
        frontend_baseline=False,
        kf_overrides=dict(ba_defer_edges=1, ba_defer_frames=0),
    )
    # localized-correction micro: the crossover's other side, where the
    # exact incremental path beats the full rebuild on the same state
    incremental["localized_micro"] = _incremental_micro(
        config, hash_slam, synthetic, metrics
    )
    streaming = _streaming_run(config, hash_slam, synthetic, metrics)
    # composed config-5 regime: streaming + keyframe backend together
    streaming_backend = _streaming_backend_run(
        config, hash_slam, synthetic, metrics
    )
    stages = _stage_breakdown(config, hash_slam, synthetic)
    # HEADLINE = the full system WITH the keyframe backend active (loop
    # closure + BA + map reintegration on the 400-frame closed sweep) —
    # the north-star configuration, and the slower of the two honest
    # workloads; median of 3 runs.  The frontend-only growing-map number
    # rides alongside; vs_baseline gates on the worse of the two so
    # neither regression can hide.
    fps = samples[1]
    fps_frontend = long_run["fps"]
    out = {
        "metric": "fused_frames_per_s_per_chip",
        "value": fps,
        "value_frontend_only": fps_frontend,
        "unit": "fps",
        "vs_baseline": round(min(fps, fps_frontend) / 30.0, 4),
        "device": device,
        "detail": {
            "workload": ("400-frame closed-loop Kinect-noise sweep, "
                         "keyframe backend (BA + reintegration) active; "
                         "median of 3 runs"),
            "long_run": long_run,
            "keyframe_backend": backend,
            "endurance_two_lap": endurance,
            "per_closure_ba_incremental": incremental,
            "streaming_beyond_capacity": streaming,
            "streaming_plus_backend": streaming_backend,
            "steady_state_fps": round(steady, 3),
            "stages": stages,
        },
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
