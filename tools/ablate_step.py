"""Attribute frame time to stages by ablation.

Wall-timing individual jitted ops out of context overstates their
device cost (per-call dispatch, no fusion with neighbours); instead this compiles
variants of the FULL flagship step with one stage disabled each and
measures steady-state frames/s for each variant.  The fps delta vs the
full step is that stage's true in-context cost.
"""

import dataclasses
import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from __graft_entry__ import flagship_config
from voxelhashing_demo_tpu.models import hash_slam
from voxelhashing_demo_tpu.utils import synthetic

N_UNIQUE = 8
WARM = 3
MEASURE = 24


def run(name, config):
    cam = config.camera
    depths, _ = synthetic.make_sequence(cam, N_UNIQUE, trans_amp=0.06,
                                        rot_amp_deg=3.0)
    depths = [jnp.asarray(d) for d in depths]
    slam = hash_slam.HashSLAM(config)
    for i in range(WARM):
        slam.process(depths[i % N_UNIQUE])
    jax.block_until_ready(slam.state.pose)
    t0 = time.perf_counter()
    for i in range(MEASURE):
        slam.process(depths[(WARM + i) % N_UNIQUE])
    jax.block_until_ready(slam.state.pose)
    dt = (time.perf_counter() - t0) / MEASURE
    print(f"{name:34s} {dt*1000:8.2f} ms/frame  {1.0/dt:7.1f} fps")
    return dt


base = flagship_config()
t_full = run("full step", base)

# no ICP: single trivial level, 0 iterations
cfg = dataclasses.replace(
    base, icp=dataclasses.replace(base.icp, pyramid=(1,),
                                  pyramid_iters=(0,), max_iters=0)
)
run("icp off", cfg)

# coarse-only ICP (drop the full-res level)
cfg = dataclasses.replace(
    base, icp=dataclasses.replace(base.icp, pyramid=(4, 2),
                                  pyramid_iters=(8, 4))
)
run("icp coarse-only (4,2)", cfg)

# fewer fine iterations
cfg = dataclasses.replace(
    base, icp=dataclasses.replace(base.icp, pyramid=(4, 2, 1),
                                  pyramid_iters=(8, 4, 1))
)
run("icp (8,4,1)", cfg)

# GC off
cfg = dataclasses.replace(base, gc=dataclasses.replace(base.gc,
                                                       enabled=False))
run("gc off", cfg)

# candidate stride 4 (fewer allocation candidates)
cfg = dataclasses.replace(
    base, hash=dataclasses.replace(base.hash, candidate_stride=4)
)
run("alloc stride 4", cfg)

# smaller integrate chunk
cfg = dataclasses.replace(
    base, hash=dataclasses.replace(base.hash, integrate_chunk=512)
)
run("integrate chunk 512", cfg)

cfg = dataclasses.replace(
    base, hash=dataclasses.replace(base.hash, integrate_chunk=2048)
)
run("integrate chunk 2048", cfg)

# splat fill/smooth off
cfg = dataclasses.replace(
    base, raycast=dataclasses.replace(base.raycast, splat_fill_rounds=0,
                                      splat_smooth_sigma=0.0)
)
run("splat finalize minimal", cfg)

print(f"\ndevice: {jax.devices()[0].platform} "
      f"{jax.devices()[0].device_kind} x{len(jax.devices())}")
