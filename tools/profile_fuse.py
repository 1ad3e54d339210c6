"""Fine-grained timing of fuse_frame / splat / preprocess sub-stages.

Run on the GPU:  python tools/profile_fuse.py  (host clock around
``block_until_ready``, so each number includes one dispatch)
Identifies which fixed-cost ops (sorts, scatters, gathers) dominate the
map-update path so optimization targets the right primitive.
"""

import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from __graft_entry__ import flagship_config
from voxelhashing_demo_tpu.geometry import se3
from voxelhashing_demo_tpu.models import hash_slam
from voxelhashing_demo_tpu.ops import hash_ops, splat as splat_ops
from voxelhashing_demo_tpu.ops import preprocess as pre_ops
from voxelhashing_demo_tpu.utils import synthetic


def timeit(name, fn, *args, n=10, **kw):
    out = fn(*args, **kw)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args, **kw)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n
    print(f"{name:42s} {dt*1000:9.2f} ms")
    return out


config = flagship_config()
cam = config.camera
hcfg = config.hash
fus = config.fusion

depths, _ = synthetic.make_sequence(cam, 2, trans_amp=0.05)
d0 = jnp.asarray(depths[0])

pre = jax.jit(lambda d: pre_ops.preprocess(d, cam))
frame = timeit("preprocess", pre, d0)

# preprocess sub-stages
to_m = jax.jit(lambda d: pre_ops.depth_to_meters(d, cam))
dm = timeit("  depth_to_meters", to_m, d0)
bp = jax.jit(lambda d: pre_ops.compute_vertices(d, cam))
verts = timeit("  compute_vertices", bp, dm)
nrm = jax.jit(pre_ops.compute_normals)
timeit("  compute_normals", nrm, verts)

T = se3.identity()

cand_fn = jax.jit(
    lambda f, t: hash_ops.frame_candidate_keys(f, t, cam, hcfg, fus)
)
cand = timeit("frame_candidate_keys", cand_fn, frame, T)
print("  candidates:", cand.shape[0])

uniq_fn = jax.jit(
    lambda k: hash_ops._unique_compact(k, hcfg.max_new_per_frame)
)
timeit("  unique_compact (sort+scatter)", uniq_fn, cand)
timeit("  bare sort", jax.jit(jnp.sort), cand)

state = hash_slam.create(config)
ins_fn = jax.jit(lambda h, k: hash_ops.insert_blocks(h, hcfg, k))
hmap, n_alloc = timeit("insert_blocks(all-new)", ins_fn, state.hmap, cand)
print("  allocated:", int(n_alloc))
# steady state: inserting into a map that already has them
timeit("insert_blocks(steady)", ins_fn, hmap, cand)

cv_fn = jax.jit(
    lambda h, t: hash_ops.compact_visible(h, hcfg, t, cam, fus)
)
active = timeit("compact_visible", cv_fn, hmap, T)
print("  active:", int(active.count))

int_fn = jax.jit(
    lambda h, a, d, t: hash_ops.integrate(h, a, hcfg, d, t, cam, fus)
)
hmap = timeit("integrate", int_fn, hmap, active, frame.depth, T)

fuse = jax.jit(
    lambda h, f, t: hash_ops.fuse_frame(h, f, t, cam, hcfg, fus)
)
timeit("fuse_frame(total)", fuse, hmap, frame, T)

sp_fn = jax.jit(
    lambda h, a, t: splat_ops.splat_depth_from_map(
        h, a, hcfg, t, cam, config.raycast, fus
    )
)
sdepth = timeit("splat_depth_from_map", sp_fn, hmap, active, T)

fin_fn = jax.jit(
    lambda d: splat_ops.finalize_depth(d, cam, config.raycast, fus)
)
timeit("splat finalize (fill+smooth+normals)", fin_fn, sdepth)

full_sp = jax.jit(
    lambda h, a, t: splat_ops.splat_raycast(
        h, a, hcfg, t, cam, config.raycast, fus
    )
)
timeit("splat_raycast(total)", full_sp, hmap, active, T)

# ICP as the flagship actually runs it (pyramid)
from voxelhashing_demo_tpu.ops import icp as icp_ops

icp_fn = jax.jit(
    lambda a, b: icp_ops.icp_align_pyramid(
        a.depth, b.depth, cam, config.icp, src_full=a, tgt_full=b
    )
)
timeit("icp_align_pyramid(flagship)", icp_fn, frame, frame)

dev = jax.devices()[0]
print(f"device: {dev.platform} {dev.device_kind}")
