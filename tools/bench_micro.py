"""Microbenchmarks of the primitive ops that dominate the SLAM frame.

Each op's cost is the time for n back-to-back dispatches closed by one
``jax.block_until_ready`` (host clock; includes dispatch).
"""

import time

import jax
import jax.numpy as jnp


def timeit(name, fn, *args, n=10):
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n
    print(f"{name:45s} {dt*1e3:9.2f} ms", flush=True)
    return out


key = jax.random.PRNGKey(0)
N_RAYS = 640 * 480
TABLE = 256**3

idx = jax.random.randint(key, (N_RAYS,), 0, TABLE)
idx2d = idx.reshape(480, 640)
flat = jnp.arange(TABLE, dtype=jnp.float32)
flat2 = jnp.stack([flat, flat], axis=-1)            # (TABLE, 2)
flat_bf16 = flat.astype(jnp.bfloat16)
rows = jnp.ones((16384, 512), dtype=jnp.float32)
row_idx = jax.random.randint(key, (16384,), 0, 16384)
small_tab = jnp.arange(64**3, dtype=jnp.int32)
idx_small = jax.random.randint(key, (N_RAYS,), 0, 64**3)

timeit("gather 307k from 16.7M f32", jax.jit(lambda i: flat[i]), idx)
timeit("gather 307k from 16.7M f32 (2d idx)", jax.jit(lambda i: flat[i]), idx2d)
timeit("gather 307k from 16.7M bf16", jax.jit(lambda i: flat_bf16[i]), idx)
timeit("gather 307k pairs from (16.7M,2)", jax.jit(lambda i: flat2[i]), idx)
timeit("gather 307k from 262k i32 table", jax.jit(lambda i: small_tab[i]), idx_small)
timeit("gather 16k rows (512) from (16k,512)", jax.jit(lambda i: rows[i]), row_idx)
timeit("8x gather 307k (trilinear-ish)",
       jax.jit(lambda i: sum(flat[(i + k) % TABLE] for k in range(8))), idx)

vals = jax.random.normal(key, (N_RAYS,))
big = jnp.zeros((TABLE,), dtype=jnp.float32)
timeit("scatter-set 307k into 16.7M", jax.jit(lambda v: big.at[idx].set(v)), vals)
timeit("scatter-min 307k into 16.7M", jax.jit(lambda v: big.at[idx].min(v)), vals)
img = jnp.full((480 * 640,), jnp.inf, dtype=jnp.float32)
sidx = jax.random.randint(key, (262144,), 0, 480 * 640)
svals = jax.random.normal(key, (262144,))
timeit("scatter-min 262k into 307k img", jax.jit(lambda v: img.at[sidx].min(v)), svals)

bigidx = jax.random.randint(key, (8 * 1024 * 1024,), 0, TABLE)
bigvals = jax.random.normal(key, (8 * 1024 * 1024,))
timeit("scatter-set 8.4M into 16.7M", jax.jit(lambda v: big.at[bigidx].set(v)), bigvals)

keys_s = jax.random.randint(key, (921600,), 0, 2**30)
timeit("sort 921k i32", jax.jit(jnp.sort), keys_s)
keys_m = jax.random.randint(key, (230400,), 0, 2**30)
timeit("sort 230k i32", jax.jit(jnp.sort), keys_m)

# elementwise pass over the image for reference
a = jax.random.normal(key, (480, 640, 3))
timeit("elementwise image pass (3ch)", jax.jit(lambda x: x * 2 + 1), a)

# 8.4M elementwise + row reduce
timeit("rowmax (16k,512)", jax.jit(lambda x: jnp.max(x, axis=-1)), rows)

# matmul 307k x 6 J^T J
J = jax.random.normal(key, (N_RAYS, 6))
timeit("JTJ 307kx6 (HIGHEST)", jax.jit(
    lambda j: jnp.matmul(j.T, j, precision=jax.lax.Precision.HIGHEST)), J)
print(f"device: {jax.devices()[0].platform} {jax.devices()[0].device_kind}")
