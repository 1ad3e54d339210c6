"""Per-stage timing of the flagship pipeline on the default platform
(host clock around ``block_until_ready``).  Run from the repo root."""

import sys

import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from __graft_entry__ import flagship_config
from voxelhashing_demo_tpu.models import hash_slam
from voxelhashing_demo_tpu.ops import (
    hash_ops, hash_raycast, icp as icp_ops, preprocess as pre_ops,
    raycast as rc_ops,
)
from voxelhashing_demo_tpu.utils import synthetic
from voxelhashing_demo_tpu.geometry import se3


def timeit(name, fn, *args, n=5, **kw):
    out = fn(*args, **kw)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args, **kw)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n
    print(f"{name:30s} {dt*1000:10.1f} ms")
    return out


config = flagship_config()
cam = config.camera
depths, poses = synthetic.make_sequence(cam, 2, trans_amp=0.05)
d0 = jnp.asarray(depths[0])

# dispatch latency probe
x = jnp.ones((8, 128))
f = jax.jit(lambda a: a + 1)
timeit("dispatch(tiny add)", f, x, n=20)

pre = jax.jit(lambda d: pre_ops.preprocess(d, cam))
frame = timeit("preprocess", pre, d0)

state = hash_slam.create(config)
icp_fn = jax.jit(
    lambda a, b: icp_ops.icp_align(a, b, cam, config.icp)
)
timeit("icp_align(frame,frame)", icp_fn, frame, frame)

fuse = jax.jit(
    lambda h, f, T: hash_ops.fuse_frame(
        h, f, T, cam, config.hash, config.fusion
    )
)
hmap, active, n_alloc = timeit(
    "fuse_frame", fuse, state.hmap, frame, se3.identity()
)
print("  active:", int(active.count), " alloc:", int(n_alloc))

dens = jax.jit(
    lambda h, a, T: hash_raycast.densify_active(
        h, a, config.hash, config.fusion, T, config.raycast.cache_dims
    )
)
cache = timeit("densify_active", dens, hmap, active, se3.identity())

rc = jax.jit(
    lambda c, T: rc_ops.raycast_dense(
        c, T, cam, config.raycast, config.fusion
    )
)
timeit("raycast_dense", rc, cache, se3.identity())

gc = jax.jit(
    lambda h: hash_ops.garbage_collect(
        h, config.hash, config.gc.min_weight, config.gc.max_blocks_per_gc
    )
)
timeit("garbage_collect", gc, hmap)

step = jax.jit(lambda s, d: hash_slam.step(s, d, config))
s1, _ = timeit("full step", step, state, d0, n=3)

dev = jax.devices()[0]
print(f"device: {dev.platform} {dev.device_kind}")
