"""Sphere-traced raycasting of the TSDF — rendering and frame-to-model maps.

The reference's raycaster was its unfinished subsystem: a three-pass
OpenGL design (rasterize block cubes to front/back depth, then per-fragment
DDA, reference: notes.md:3-16, raycastSDF.frag:121-177) whose final pass is
commented out (SDFRenderer.cpp:215-254) and declared broken (README.md:4-5).

As one XLA program there is no rasterizer and no need for one: the whole image of rays
marches in lockstep inside one jitted ``lax.fori_loop``, sampling the TSDF
trilinearly.  Stepping is adaptive per ray (sphere tracing against the
truncated SDF): big conservative steps through unobserved space, |sdf|-sized
steps near the surface, then a secant refinement at the zero crossing.

The raycast output doubles as the model frame for frame-to-model ICP —
the capability the reference's design intended but never reached
(Application.cpp:75 Align commented out, identity-pose integration only).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import CameraConfig, FusionConfig, RaycastConfig
from ..geometry import camera as cam_geom
from ..geometry.se3 import matmul
from .tsdf import DenseTSDF, trilinear_sample, sdf_gradient


class RaycastOutput(NamedTuple):
    depth: jnp.ndarray     # (H, W) z-depth in camera frame; 0 = miss
    points: jnp.ndarray    # (H, W, 3) camera-space hit positions
    normals: jnp.ndarray   # (H, W, 3) camera-space unit normals (toward cam)
    hit: jnp.ndarray       # (H, W) bool


@partial(jax.jit, static_argnames=("cam", "rc", "fusion"))
def raycast_dense(
    state: DenseTSDF,
    T_wc: jnp.ndarray,
    cam: CameraConfig,
    rc: RaycastConfig,
    fusion: FusionConfig,
) -> RaycastOutput:
    """Render depth/normal maps of the dense TSDF from pose ``T_wc``
    (camera-to-world)."""
    return raycast_rays(state, T_wc, cam_geom.pixel_rays(cam), rc)


def raycast_rays(
    state: DenseTSDF,
    T_wc: jnp.ndarray,
    rays_cam: jnp.ndarray,
    rc: RaycastConfig,
) -> RaycastOutput:
    """Sphere-trace an arbitrary (h, w, 3) bundle of camera-space rays
    (z-depth parameterized).  The multi-chip path shards the image rows
    over devices and calls this on each device's row slice."""
    R = T_wc[:3, :3]
    origin = T_wc[:3, 3]
    dirs = matmul(rays_cam, R.T)                          # world, z-depth param
    inv_len = 1.0 / jnp.linalg.norm(dirs, axis=-1)        # meters per unit t

    H, W = rays_cam.shape[:2]
    vox = state.voxel_size

    def sample_at(t):
        pos = origin + dirs * t[..., None]
        return trilinear_sample(state, pos)

    def body(_, carry):
        t, t_hit, hit, prev_sdf, prev_t = carry
        s, w = sample_at(t)
        known = w > 0

        crossed = known & (s <= 0) & (prev_sdf > 0)
        # secant refinement between prev_t and t
        denom = jnp.where(
            jnp.abs(prev_sdf - s) > 1e-12, prev_sdf - s, 1e-12
        )
        t_ref = prev_t + (t - prev_t) * (prev_sdf / denom)
        new_hit = crossed & ~hit
        t_hit = jnp.where(new_hit, t_ref, t_hit)
        hit = hit | crossed

        # step: sphere trace when known-positive, coarse through unknown
        step_m = jnp.where(
            known,
            jnp.maximum(rc.step_scale * jnp.abs(s), rc.min_step * vox),
            rc.coarse_step * vox,
        )
        dt = step_m * inv_len
        prev_sdf = jnp.where(known, s, prev_sdf)
        prev_t = jnp.where(known, t, prev_t)
        t = jnp.where(hit, t, t + dt)
        return (t, t_hit, hit, prev_sdf, prev_t)

    # all carry components derive from rays_cam so their device-varying
    # type matches under shard_map (rows may be sharded over a mesh axis)
    zero = rays_cam[..., 0] * 0.0
    t0 = zero + rc.near
    init = (
        t0,
        zero,
        zero > 1.0,                 # hit: all-false, varying-typed
        zero + jnp.inf,             # prev_sdf: +inf = none yet
        t0,
    )
    t, t_hit, hit, _, _ = jax.lax.fori_loop(0, rc.max_steps, body, init)
    hit = hit & (t_hit > rc.near) & (t_hit < rc.far)

    depth = jnp.where(hit, t_hit, 0.0)
    points = rays_cam * depth[..., None]                  # camera frame

    pos_world = origin + dirs * t_hit[..., None]
    if rc.normal_mode == "gradient":
        g = sdf_gradient(state, pos_world)
        glen = jnp.linalg.norm(g, axis=-1, keepdims=True)
        n_world = jnp.where(glen > 1e-9, g / jnp.maximum(glen, 1e-9), 0.0)
        n_cam = matmul(n_world, R)                        # R^T n (world->cam)
        # orient toward the camera
        flip = jnp.sum(n_cam * rays_cam, axis=-1, keepdims=True) > 0
        n_cam = jnp.where(flip, -n_cam, n_cam)
    else:
        from .preprocess import compute_normals

        n_cam = compute_normals(points)
    normals = jnp.where(hit[..., None], n_cam, 0.0)
    points = jnp.where(hit[..., None], points, 0.0)

    return RaycastOutput(depth=depth, points=points, normals=normals, hit=hit)


def model_frame(out: RaycastOutput):
    """Package a raycast as a tracking Frame (frame-to-model target)."""
    from .preprocess import Frame

    return Frame(vertices=out.points, normals=out.normals, depth=out.depth)


def shade(out: RaycastOutput, light_dir=(0.0, 0.0, -1.0)) -> jnp.ndarray:
    """Simple Lambertian shading of a raycast for visualization, (H, W)
    in [0, 1].  Replaces the reference's GL Phong debug display
    (MainShader.frag)."""
    l = jnp.asarray(light_dir, dtype=jnp.float32)
    l = l / jnp.linalg.norm(l)
    lam = jnp.clip(jnp.sum(out.normals * l, axis=-1), 0.0, 1.0)
    return jnp.where(out.hit, 0.1 + 0.9 * lam, 0.0)
