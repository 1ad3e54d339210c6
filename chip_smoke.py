"""Smoke run of the flagship SLAM path on a GPU.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --cards 4   # the sharded map on four cards, only

One process drives the card through the entry points a user calls
(``HashSLAM``, ``KeyframeSLAM``, the CLI) at the flagship configuration
(``__graft_entry__.flagship_config``: 640x480 TUM-fr1 intrinsics, 2 cm
voxels, a 65,536-bucket x 4 table and 65,536 blocks of 8^3 voxels, robust
frontend, full keyframe backend).  Phases, in order:

1. device     a GPU backend is required; there is no CPU fallback.
2. ops        each device op at real width against a plain reference
              (float64 numpy, numpy indexing, a Python dict, or the same
              function on the CPU), with its max error beside its
              tolerance; plus the integrate stage's device time.
3. frontend   200-frame noisy room sweep: >= 98 % tracked, ATE < 60 mm.
4. backend    400-frame closed pan: loop closure, BA and a map rebuild
              happen, poses stay finite, ATE no worse than frontend-only.
5. streaming  beyond-capacity map (2048 device blocks): blocks are evicted
              and restored, ATE < 150 mm.
6. cli        ``run --synthetic 30 --backend keyframe`` then ``render``.

Any failed check raises, so the process exits non-zero.  The last line of
standard output is one JSON object naming the device; nothing is printed
there unless every phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def report(phase: str, what: str, err: float, tol: float) -> None:
    """Print one comparison and fail unless ``err <= tol``."""
    ok = bool(err <= tol)
    print(f"[{phase}] {what}: max err {err:.3e} (tol {tol:.0e}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    check(ok, f"{phase}: {what} error {err:.3e} > {tol:.0e}")


# --------------------------------------------------------------------------
# 1. device
# --------------------------------------------------------------------------

def require_gpu(cards: int):
    """Exit non-zero unless JAX runs on at least ``cards`` GPUs."""
    import jax

    backend = jax.default_backend()
    devices = jax.devices()
    if backend != "gpu" or devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU backend, JAX reports "
                 f"{backend!r} ({devices[0].platform})")
    if len(devices) < cards:
        sys.exit(f"chip_smoke: needs {cards} GPUs, found {len(devices)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"[device] {devices[0].device_kind} x{len(devices)}", flush=True)
    for line in smi.splitlines():
        print(f"[device] nvidia-smi: {line}", flush=True)
    return devices


def describe_runtime() -> None:
    import jax

    print(f"[device] jax {jax.__version__}; "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
          f"compile cache {jax.config.jax_compilation_cache_dir!r}",
          flush=True)


# --------------------------------------------------------------------------
# plain references
# --------------------------------------------------------------------------

def ref_normal_system(p, n_t, r, valid, huber_delta):
    """JTJ / JTr of the point-to-plane system in float64."""
    p, n_t, r = (np.asarray(a, np.float64) for a in (p, n_t, r))
    w = np.asarray(valid, np.float64)
    if huber_delta > 0:
        w = w * np.minimum(1.0, huber_delta / np.maximum(np.abs(r), 1e-12))
    J = np.concatenate([n_t, np.cross(p, n_t)], axis=-1).reshape(-1, 6)
    w = w.reshape(-1)
    r = r.reshape(-1)
    return (J * w[:, None]).T @ J, J.T @ (w * r)


def _project64(pc, cam):
    """Pixel coords of camera-space points (float64) and a mask of points
    within 1e-3 px of a rounding or image-border decision, where float32
    on the device may legitimately round the other way."""
    z = pc[..., 2]
    safe = np.where(np.abs(z) > 1e-12, z, 1e-12)
    u = pc[..., 0] / safe * cam.fx + cam.cx
    v = pc[..., 1] / safe * cam.fy + cam.cy
    eps = 1e-3
    amb = np.zeros(u.shape, bool)
    for c, hi in ((u, cam.width - 1), (v, cam.height - 1)):
        amb |= np.abs(np.abs(c - np.floor(c)) - 0.5) < eps
        amb |= (np.abs(c) < eps) | (np.abs(c - hi) < eps)
    amb |= np.abs(z) < eps
    return u, v, amb


def ref_integrate(blocks, ptrs, tsdf, weight, depth_m, T_wc, cam, hcfg,
                  fusion):
    """Curless-Levoy update of one chunk of rows by numpy indexing.

    Returns (tsdf rows, weight rows, mask of voxels to compare)."""
    B = hcfg.block_size
    idx = np.arange(B ** 3)
    local = np.stack([idx % B, (idx // B) % B, idx // (B * B)], -1)
    vox = blocks[:, None, :].astype(np.int64) * B + local
    world = vox.astype(np.float64) * fusion.voxel_size
    T_cw = np.linalg.inv(np.asarray(T_wc, np.float64))
    pc = world @ T_cw[:3, :3].T + T_cw[:3, 3]
    u, v, amb = _project64(pc, cam)
    z = pc[..., 2]
    ui, vi = np.rint(u).astype(np.int64), np.rint(v).astype(np.int64)
    in_img = ((z > 0) & (u >= 0) & (u <= cam.width - 1) & (v >= 0)
              & (v <= cam.height - 1) & (ui >= 0) & (ui < cam.width)
              & (vi >= 0) & (vi < cam.height))
    d = depth_m[np.clip(vi, 0, cam.height - 1),
                np.clip(ui, 0, cam.width - 1)].astype(np.float64)
    sdf = d - z
    trunc = fusion.truncation + fusion.trunc_scale * d
    amb |= np.abs(sdf + trunc) < 1e-4
    row_valid = ptrs >= 0
    valid = row_valid[:, None] & in_img & (d > 0) & (z > 0) & (sdf > -trunc)
    sdf = np.clip(sdf, -trunc, trunc)
    if fusion.depth_weight_falloff:
        d01 = np.clip((d - cam.depth_min) / (cam.depth_max - cam.depth_min),
                      0.0, 1.0)
        ws = np.maximum(fusion.weight_sample * 1.5 * (1.0 - d01), 1.0)
    else:
        ws = np.full_like(d, fusion.weight_sample)
    w_new = np.where(valid, ws, 0.0)
    old_s = tsdf[np.clip(ptrs, 0, None)].astype(np.float64)
    old_w = weight[np.clip(ptrs, 0, None)].astype(np.float64)
    w_sum = old_w + w_new
    fused = np.where(w_new > 0,
                     (old_s * old_w + sdf * w_new) / np.maximum(w_sum, 1e-12),
                     old_s)
    new_w = np.where(w_new > 0, np.minimum(w_sum, fusion.max_weight), old_w)
    return fused, new_w, row_valid[:, None] & ~amb


def _bucket_np(keys, hcfg):
    from voxelhashing_demo_tpu.geometry import coords

    bias, mask = 1 << (hcfg.key_bits - 1), (1 << hcfg.key_bits) - 1
    k = keys.astype(np.int64)
    b = np.stack([((k >> (2 * hcfg.key_bits)) & mask) - bias,
                  ((k >> hcfg.key_bits) & mask) - bias,
                  (k & mask) - bias], -1).astype(np.int32)
    with np.errstate(over="ignore"):
        h = ((b[:, 0] * np.int32(coords.HASH_P0))
             ^ (b[:, 1] * np.int32(coords.HASH_P1))
             ^ (b[:, 2] * np.int32(coords.HASH_P2)))
    return np.mod(h.astype(np.int64), hcfg.num_buckets), b


def ref_insert(table_keys, table_ptrs, fill, free_list, free_top, cand, hcfg):
    """The allocator as a Python dict: key -> block row.  Unique candidate
    keys in ascending order (the smallest ``max_new_per_frame`` win), new
    keys ranked within their bucket in key order, rows popped off the
    free stack in (bucket, key) order; bucket overflow and an empty heap
    drop keys."""
    from voxelhashing_demo_tpu.geometry.coords import EMPTY_KEY

    table = {int(k): int(p) for k, p in zip(table_keys, table_ptrs)
             if k != EMPTY_KEY}
    uniq = sorted({int(k) for k in cand if k != EMPTY_KEY})
    uniq = uniq[: hcfg.max_new_per_frame]
    new = [k for k in uniq if k not in table]
    buckets, _ = _bucket_np(np.asarray(new, np.int64), hcfg)
    order = sorted(range(len(new)), key=lambda i: (buckets[i], new[i]))
    rank, n_alloc = {}, 0
    for i in order:
        b = int(buckets[i])
        slot = int(fill[b]) + rank.get(b, 0)
        rank[b] = rank.get(b, 0) + 1
        if slot < hcfg.bucket_size and n_alloc < free_top:
            table[new[i]] = int(free_list[free_top - 1 - n_alloc])
            n_alloc += 1
    return table, n_alloc


def ref_in_frustum(blocks, T_wc, cam, hcfg, fusion, margin_px=4.0):
    """hash_ops.block_in_frustum in float64, plus a mask of blocks within
    1e-3 of one of its thresholds."""
    half = 0.5 * hcfg.block_size * fusion.voxel_size
    radius = half * 1.7320508
    center = blocks.astype(np.float64) * hcfg.block_size * fusion.voxel_size
    center = center + half
    T_cw = np.linalg.inv(np.asarray(T_wc, np.float64))
    pc = center @ T_cw[:3, :3].T + T_cw[:3, 3]
    z = pc[:, 2]
    sz = np.maximum(z, 1e-6)
    u = pc[:, 0] / sz * cam.fx + cam.cx
    v = pc[:, 1] / sz * cam.fy + cam.cy
    zm = np.maximum(z, 0.05)
    mu = margin_px + radius * cam.fx / zm
    mv = margin_px + radius * cam.fy / zm
    near = cam.depth_min - 2.0 * half
    far = cam.depth_max + 2.0 * half
    margins = [z - near, far - z, u + mu, cam.width + mu - u, v + mv,
               cam.height + mv - v]
    inside = np.all([m >= 0 if k in (2, 4) else m > 0
                     for k, m in enumerate(margins)], 0)
    amb = np.any([np.abs(m) < 1e-3 for m in margins], 0)
    return inside, amb


# --------------------------------------------------------------------------
# 2. ops at real width
# --------------------------------------------------------------------------

def _device_ms(trace_dir: str, module: str, reps: int):
    """Mean device time per call of the jitted ``module`` from a profiler
    trace: the summed duration of its kernels on the GPU planes."""
    import jax

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        return None
    total = 0
    data = jax.profiler.ProfileData.from_file(paths[0])
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                if module in str(stats.get("hlo_module", "")):
                    total += ev.duration_ns
    return total / reps / 1e6 if total else None


def phase_ops(config, frames=6):
    import jax
    import jax.numpy as jnp

    from voxelhashing_demo_tpu.geometry import se3
    from voxelhashing_demo_tpu.ops import hash_ops, icp as icp_ops
    from voxelhashing_demo_tpu.ops import preprocess as pre_ops
    from voxelhashing_demo_tpu.ops import splat as splat_ops
    from voxelhashing_demo_tpu.models import hash_slam
    from voxelhashing_demo_tpu.utils import synthetic

    cam, hcfg, fusion = config.camera, config.hash, config.fusion
    depths, gt = synthetic.make_room_sweep(cam, frames, sweep_deg=40.0,
                                           noise_seed=1)
    slam = hash_slam.HashSLAM(config)
    t0 = time.perf_counter()
    jax.block_until_ready(slam.process(depths[0]).pose)
    first_frame_s = time.perf_counter() - t0
    for d in depths[1:-1]:
        slam.process(d)
    state = slam.state
    pre = jax.jit(lambda d: pre_ops.preprocess(d, cam, config.frontend))
    frame = pre(jnp.asarray(depths[-1]))

    # ICP normal system over a full-image association
    T = jnp.asarray(np.linalg.inv(gt[-2]) @ gt[-1])
    assoc = jax.jit(lambda T, f, m: icp_ops.associate(T, f, m, cam,
                                                      config.icp))
    p, n_t, r, valid = assoc(T, frame, state.model)
    sys_ = jax.jit(lambda *a: icp_ops.build_normal_system(
        *a, config.icp.huber_delta))(p, n_t, r, valid)
    JTJ, JTr = ref_normal_system(p, n_t, r, valid, config.icp.huber_delta)
    check(int(np.asarray(valid).sum()) > 1000, "ICP association empty")
    report("ops", f"ICP JTJ over {cam.width}x{cam.height} "
           f"({int(np.asarray(valid).sum())} inliers), relative",
           float(np.abs(np.asarray(sys_.JTJ) - JTJ).max()
                 / np.abs(JTJ).max()), 1e-4)
    report("ops", "ICP JTr, relative",
           float(np.abs(np.asarray(sys_.JTr) - JTr).max()
                 / np.abs(JTr).max()), 1e-4)

    # one integrate chunk: 128 blocks x 512 voxels
    pose = se3.compose(state.pose, T)
    active = jax.jit(lambda h, T: hash_ops.compact_visible(
        h, hcfg, T, cam, fusion))(state.hmap, pose)
    C = hcfg.integrate_chunk
    check(int(active.count) >= C, f"fewer than {C} active blocks")
    chunk = hash_ops.ActiveSet(blocks=active.blocks[:C],
                               ptrs=active.ptrs[:C], count=jnp.int32(C))
    hm = jax.jit(lambda h, a, d, T: hash_ops.integrate(
        h, a, hcfg, d, T, cam, fusion))(state.hmap, chunk, frame.depth, pose)
    ptrs = np.asarray(chunk.ptrs)
    ts, ws, cmp = ref_integrate(
        np.asarray(chunk.blocks), ptrs, np.asarray(state.hmap.tsdf),
        np.asarray(state.hmap.weight), np.asarray(frame.depth),
        np.asarray(pose), cam, hcfg, fusion)
    got_t = np.asarray(hm.tsdf)[ptrs]
    got_w = np.asarray(hm.weight)[ptrs]
    print(f"[ops] integrate chunk {C}x{hcfg.voxels_per_block}: "
          f"{int(cmp.sum())} voxels compared, {int((~cmp).sum())} within "
          f"1e-3 px of a rounding edge skipped", flush=True)
    report("ops", "integrate tsdf", float(np.abs(got_t - ts)[cmp].max()),
           1e-5)
    report("ops", "integrate weight", float(np.abs(got_w - ws)[cmp].max()),
           1e-5)

    # splat z-buffer: scatter-min against np.minimum.at on the same samples
    safe = jnp.clip(active.ptrs, 0, hcfg.num_blocks - 1)
    flat, zs = jax.jit(lambda b, s, w, v, T: splat_ops.splat_samples(
        b, s, w, v, hcfg, T, cam, config.raycast, fusion))(
        active.blocks, state.hmap.tsdf[safe], state.hmap.weight[safe],
        active.ptrs != hash_ops.FREE_PTR, pose)
    zb = jax.jit(splat_ops.zbuffer_min)(
        jnp.full((cam.height * cam.width + 1,), jnp.inf, jnp.float32),
        flat, zs)
    ref = np.full(cam.height * cam.width + 1, np.inf, np.float32)
    flat_np, zs_np = np.asarray(flat), np.asarray(zs)
    keep = flat_np < cam.height * cam.width
    np.minimum.at(ref, flat_np[keep], zs_np[keep])
    check(int(keep.sum()) > 10000, "splat produced no samples")
    n_diff = int(np.sum(np.asarray(zb) != ref))
    print(f"[ops] splat z-buffer: {int(keep.sum())} samples into "
          f"{int(np.isfinite(ref).sum())} pixels, {n_diff} pixels differ "
          f"(exact required) {'ok' if n_diff == 0 else 'FAIL'}", flush=True)
    check(n_diff == 0, "splat z-buffer differs from np.minimum.at")

    # one frame's hash allocation (insert, then compact) against a dict
    h0 = state.hmap
    cand = jax.jit(lambda f, T: hash_ops.frame_candidate_keys(
        f, T, cam, hcfg, fusion))(frame, pose)
    h1, n_alloc = jax.jit(lambda h, k: hash_ops.insert_blocks(
        h, hcfg, k))(h0, cand)
    table, n_ref = ref_insert(
        np.asarray(h0.keys), np.asarray(h0.ptrs), np.asarray(h0.bucket_fill),
        np.asarray(h0.free_list), int(h0.free_top), np.asarray(cand), hcfg)
    got = {int(k): int(p) for k, p in zip(np.asarray(h1.keys),
                                          np.asarray(h1.ptrs))
           if k != hash_ops.EMPTY_KEY}
    ok = got == table and int(n_alloc) == n_ref and (
        int(h1.free_top) == int(h0.free_top) - n_ref)
    print(f"[ops] hash insert: {n_ref} new of {len(table)} blocks, table "
          f"{'equals' if got == table else 'DIFFERS from'} the dict "
          f"(exact required) {'ok' if ok else 'FAIL'}", flush=True)
    check(ok, "hash insert differs from the dict reference")
    act = jax.jit(lambda h, T: hash_ops.compact_visible(
        h, hcfg, T, cam, fusion))(h1, pose)
    keys1 = np.asarray(h1.keys)
    occupied = np.flatnonzero(keys1 != hash_ops.EMPTY_KEY)
    _, blocks_occ = _bucket_np(keys1[occupied], hcfg)
    inside, amb = ref_in_frustum(blocks_occ, np.asarray(pose), cam, hcfg,
                                 fusion)
    ptr_slot = {int(p): s for s, p in zip(occupied,
                                          np.asarray(h1.ptrs)[occupied])}
    n = int(act.count)
    slots = [ptr_slot.get(int(p), -1) for p in np.asarray(act.ptrs)[:n]]
    pos = {s: i for i, s in enumerate(occupied)}
    sel = np.zeros(len(occupied), bool)
    sel[[pos[s] for s in slots if s in pos]] = True
    ok = (n <= hcfg.max_active and -1 not in slots
          and slots == sorted(slots)
          and not np.any(sel & ~inside & ~amb)
          and (n == hcfg.max_active or not np.any(inside & ~amb & ~sel)))
    print(f"[ops] compact: {n} visible of {len(occupied)} blocks, "
          f"{int(amb.sum())} on a frustum edge left to the device "
          f"(exact required) {'ok' if ok else 'FAIL'}", flush=True)
    check(ok, "compacted visible set differs from the reference")

    # preprocess (bilateral + flying-pixel rejection) vs the CPU backend
    cpu = jax.devices("cpu")[0]
    on_cpu = pre(jax.device_put(jnp.asarray(depths[-1]), cpu))
    report("ops", "preprocess depth vs CPU (m)", float(np.abs(
        np.asarray(frame.depth) - np.asarray(on_cpu.depth)).max()), 1e-5)
    report("ops", "preprocess vertices vs CPU (m)", float(np.abs(
        np.asarray(frame.vertices) - np.asarray(on_cpu.vertices)).max()),
        1e-5)
    return first_frame_s


def integrate_stage_time(config, slam, reps=20) -> None:
    """Device time of the integrate stage (XLA's plain depth gather) over
    the visible set of the frontend's final state."""
    import jax

    from voxelhashing_demo_tpu.ops import hash_ops

    cam, hcfg, fusion = config.camera, config.hash, config.fusion
    st = slam.state
    active = hash_ops.compact_visible(st.hmap, hcfg, st.pose, cam, fusion)
    depth = st.model.depth          # a full metric depth image at st.pose

    def integrate_stage(h, a, d, T):
        return hash_ops.integrate(h, a, hcfg, d, T, cam, fusion).tsdf[0, 0]

    fn = jax.jit(integrate_stage)
    jax.block_until_ready(fn(st.hmap, active, depth, st.pose))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(st.hmap, active, depth, st.pose)
    jax.block_until_ready(out)
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    with tempfile.TemporaryDirectory() as tdir:
        with jax.profiler.trace(tdir):
            for _ in range(reps):
                out = fn(st.hmap, active, depth, st.pose)
            jax.block_until_ready(out)
        dev_ms = _device_ms(tdir, "integrate_stage", reps)
    dev = "not measured" if dev_ms is None else f"{dev_ms:.3f} ms"
    print(f"[ops] integrate stage, XLA gather, {int(active.count)} active "
          f"blocks: device {dev} per frame (trace), host-clock "
          f"{host_ms:.3f} ms per call", flush=True)


# --------------------------------------------------------------------------
# 3-6. the system through its entry points
# --------------------------------------------------------------------------

def phase_frontend(config, first_frame_s, frames=200):
    """``first_frame_s``: the flagship step's first call in phase_ops,
    which compiles it (or loads it from the persistent cache)."""
    import jax

    from voxelhashing_demo_tpu.models import hash_slam
    from voxelhashing_demo_tpu.utils import metrics, synthetic

    depths, gt = synthetic.make_room_sweep(config.camera, frames,
                                           sweep_deg=340.0, noise_seed=1)
    slam = hash_slam.HashSLAM(config)
    jax.block_until_ready(slam.process(depths[0]).pose)
    t0 = time.perf_counter()
    for d in depths[1:]:
        info = slam.process(d)
    jax.block_until_ready(info.pose)
    fps = (frames - 1) / (time.perf_counter() - t0)
    tracked = sum(bool(i.tracked) for i in slam.infos)
    ate = metrics.ate_rmse(slam.trajectory, gt, align=False)
    print(f"[frontend] {jax.devices()[0].device_kind}: step compile "
          f"(first frame) {first_frame_s:.1f} s, {fps:.1f} frames/s wall "
          f"(smoke reading, not a benchmark)", flush=True)
    print(f"[frontend] tracked {tracked}/{frames} (need >= "
          f"{math.ceil(0.98 * frames)}), ATE {ate * 1e3:.2f} mm "
          f"(need < 60)", flush=True)
    check(tracked >= 0.98 * frames, "frontend lost tracking")
    check(ate < 0.060, f"frontend ATE {ate * 1e3:.2f} mm")
    return slam, ate


def phase_backend(config, frames=400):
    import bench
    from voxelhashing_demo_tpu.models import hash_slam
    from voxelhashing_demo_tpu.utils import metrics, synthetic

    out = bench._backend_run(config, hash_slam, synthetic, metrics,
                             num_frames=frames, warm_frames=0)
    rebuilds = out["rebuilds_full"] + out["rebuilds_incremental"]
    print(f"[backend] {json.dumps(out)}", flush=True)
    print(f"[backend] loop edges {out['loop_edges']}, BA runs "
          f"{out['ba_runs']}, map rebuilds {rebuilds}; ATE "
          f"{out['ate_rmse_m'] * 1e3:.2f} mm vs frontend-only "
          f"{out['ate_frontend_only_m'] * 1e3:.2f} mm", flush=True)
    check(out["loop_edges"] >= 1, "no loop closure accepted")
    check(out["ba_runs"] >= 1, "no BA solve")
    check(rebuilds >= 1, "no map rebuild")
    check(math.isfinite(out["ate_rmse_m"]), "non-finite backend poses")
    check(out["ate_rmse_m"] <= out["ate_frontend_only_m"],
          "backend ATE worse than frontend-only")


def phase_streaming(config, frames=200):
    import bench
    from voxelhashing_demo_tpu.models import hash_slam
    from voxelhashing_demo_tpu.utils import metrics, synthetic

    out = bench._streaming_run(config, hash_slam, synthetic, metrics,
                               num_frames=frames)
    print(f"[streaming] {json.dumps(out)}", flush=True)
    check(out["evicted"] > 0, "nothing evicted")
    check(out["restored"] > 0, "nothing restored")
    check(out["ate_rmse_m"] < 0.150,
          f"streaming ATE {out['ate_rmse_m'] * 1e3:.2f} mm")


def _cli(argv) -> dict:
    from voxelhashing_demo_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    line = buf.getvalue().strip().splitlines()[-1]
    print(f"[cli] {argv[argv[0] == '--small']}: {line}", flush=True)
    return json.loads(line)


def phase_cli(frames=30, small=False):
    pre = ["--small"] if small else []
    with tempfile.TemporaryDirectory() as tdir:
        run = _cli(pre + ["run", "--synthetic", str(frames), "--backend",
                          "keyframe", "--out", tdir])
        for name in ("trajectory.txt", "metrics.jsonl", "map.npz"):
            check(os.path.exists(os.path.join(tdir, name)),
                  f"cli run wrote no {name}")
        check(run["frames"] == frames, "cli run frame count")
        render = _cli(["render", "--checkpoint",
                       os.path.join(tdir, "map.npz"), "--orbit", "2",
                       "--out", os.path.join(tdir, "render")])
        hit = min(render["hit_fraction"])
        print(f"[cli] render hit fraction {hit:.3f} (need > 0.5)",
              flush=True)
        check(hit > 0.5, "cli render mostly empty")


# --------------------------------------------------------------------------
# four cards: the sharded map against one card
# --------------------------------------------------------------------------

def _compare(label, traj_n, traj_1, gt, metrics) -> None:
    dt = max(float(np.abs(np.asarray(a)[:3, 3] - np.asarray(b)[:3, 3]).max())
             for a, b in zip(traj_n, traj_1))
    ate_n = metrics.ate_rmse(traj_n, gt, align=False)
    ate_1 = metrics.ate_rmse(traj_1, gt, align=False)
    print(f"[cards] {label}: ATE {ate_n * 1e3:.3f} mm sharded vs "
          f"{ate_1 * 1e3:.3f} mm on one card", flush=True)
    report("cards", f"{label} per-frame translation (m)", dt, 1e-3)
    report("cards", f"{label} ATE difference (m)", abs(ate_n - ate_1), 2e-3)


def phase_cards(config, cards=4, frames=200) -> None:
    import jax

    from voxelhashing_demo_tpu.models import hash_slam, keyframe_slam
    from voxelhashing_demo_tpu.parallel import sharded
    from voxelhashing_demo_tpu.utils import metrics, synthetic

    depths, gt = synthetic.make_room_sweep(config.camera, frames,
                                           sweep_deg=340.0, noise_seed=1)
    mesh = sharded.make_mesh(cards)
    print(f"[cards] mesh {dict(mesh.shape)} over "
          f"{[d.id for d in mesh.devices.flat]}", flush=True)

    one = hash_slam.HashSLAM(config)
    many = sharded.ShardedHashSLAM(config, mesh)
    for d in depths:
        one.process(d)
        many.process(d)
    jax.block_until_ready(many.state.pose)
    _compare("ShardedHashSLAM", [np.asarray(p) for p in many.trajectory],
             [np.asarray(p) for p in one.trajectory], gt, metrics)

    one = keyframe_slam.KeyframeSLAM(config)
    many = keyframe_slam.KeyframeSLAM(config, mesh=mesh)
    for d in depths:
        one.process(d)
        many.process(d)
    _compare("KeyframeSLAM", many.trajectory(), one.trajectory(), gt,
             metrics)
    print(f"[cards] keyframes {len(many.keyframes)} sharded vs "
          f"{len(one.keyframes)}; BA runs {len(many.ba_events)} vs "
          f"{len(one.ba_events)}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded-map phase on four cards")
    args = ap.parse_args(argv)

    devices = require_gpu(args.cards)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from __graft_entry__ import flagship_config

    describe_runtime()
    config = flagship_config()
    if args.cards > 1:
        phase_cards(config, args.cards)
    else:
        first_frame_s = phase_ops(config)
        slam, _ = phase_frontend(config, first_frame_s)
        integrate_stage_time(config, slam)
        del slam
        phase_backend(config)
        phase_streaming(config)
        phase_cli()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
