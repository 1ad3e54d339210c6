"""Multi-chip scaling harness: frames/s at 1..N devices + efficiency.

This harness measures the sharded pipeline at power-of-two device counts
on whatever mesh is available:

- on a multi-GPU host (one process driving all cards, collectives over
  NCCL) it measures frames/s at 1, 2, 4, ... cards;
- on a CPU-only host it can still validate methodology over virtual devices:
  run with  XLA_FLAGS=--xla_force_host_platform_device_count=8
  JAX_PLATFORMS=cpu  (absolute fps is then meaningless, but the harness,
  sharding, and collectives are exactly the real ones).

Prints one JSON line per device count:
  {"devices": n, "fps": ..., "efficiency_vs_1": ...}
"""

import argparse
import json
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--max-devices", type=int, default=0,
                    help="0 = all available")
    ap.add_argument("--cpu", action="store_true",
                    help="force a virtual CPU mesh (set XLA_FLAGS="
                         "--xla_force_host_platform_device_count=8 too)")
    args = ap.parse_args()

    import jax

    if args.cpu:
        # a config update before backend init wins over the environment
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from voxelhashing_demo_tpu.config import (
        CameraConfig, FusionConfig, GCConfig, HashConfig, ICPConfig,
        PipelineConfig, RaycastConfig,
    )
    from voxelhashing_demo_tpu.parallel import sharded
    from voxelhashing_demo_tpu.utils import synthetic

    n_avail = len(jax.devices())
    max_dev = args.max_devices or n_avail
    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= min(max_dev, n_avail)]

    W, H = args.width, args.height
    scale = W / 640.0
    cam = CameraConfig(width=W, height=H, fx=517.3 * scale,
                       fy=516.5 * scale, cx=(W - 1) / 2, cy=(H - 1) / 2)

    base_fps = None
    for n in counts:
        if H % n or 65536 % n:
            continue
        config = PipelineConfig(
            camera=cam,
            icp=ICPConfig(pyramid=(4, 2, 1), pyramid_iters=(8, 4, 2)),
            fusion=FusionConfig(voxel_size=0.02, truncation=0.08),
            hash=HashConfig(num_buckets=65536, bucket_size=4,
                            num_blocks=65536, max_active=4096,
                            max_new_per_frame=4096, candidate_stride=3),
            raycast=RaycastConfig(mode="splat"),
            gc=GCConfig(enabled=True, interval=16),
        )
        mesh = sharded.make_mesh(n)
        slam = sharded.ShardedHashSLAM(config, mesh)
        depths, _ = synthetic.make_sequence(
            cam, 4, trans_amp=0.06, rot_amp_deg=3.0
        )
        depths = [jnp.asarray(d) for d in depths]

        for i in range(args.warmup):
            slam.process(depths[i % len(depths)])
        jax.block_until_ready(slam.state.pose)
        t0 = time.perf_counter()
        for i in range(args.frames):
            slam.process(depths[(args.warmup + i) % len(depths)])
        jax.block_until_ready(slam.state.pose)
        fps = args.frames / (time.perf_counter() - t0)
        if base_fps is None:
            base_fps = fps
        print(json.dumps({
            "devices": n,
            "platform": jax.devices()[0].platform,
            "kind": jax.devices()[0].device_kind,
            "fps": round(fps, 3),
            "efficiency_vs_1": round(fps / (base_fps * n), 4),
        }))


if __name__ == "__main__":
    main()
