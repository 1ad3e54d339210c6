"""Depth-frame preprocessing: back-projection and normal estimation.

Re-expression of the reference's two preprocessing kernels
(reference: CameraTrackingUtils.cu:50-113, launched by ``preProcess``
:115-120): one fused jitted function over the whole image instead of two
SIMT kernel launches with a host sync between them.

Validity convention (kept from the reference): invalid vertices have z == 0;
invalid normals are the zero vector (CameraTrackingUtils.cu:90,153).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import CameraConfig
from ..geometry import camera as cam_geom


class Frame(NamedTuple):
    """Preprocessed depth frame: camera-space geometry maps, all (H, W, ...)."""

    vertices: jnp.ndarray   # (H, W, 3) camera-space positions; z==0 invalid
    normals: jnp.ndarray    # (H, W, 3) unit normals; zero vector invalid
    depth: jnp.ndarray      # (H, W) metric depth; 0 invalid


def depth_to_meters(depth_raw: jnp.ndarray, cam: CameraConfig) -> jnp.ndarray:
    """uint16 depth image -> metric depth, gating the valid range.

    The reference divides by 5000 with no range gate in the kernel
    (CameraTrackingUtils.cu:64); the range gate [depth_min, depth_max]
    (common.h:46 maxIntegrationDistance) is applied here once.
    """
    d = depth_raw.astype(jnp.float32) / cam.depth_scale
    valid = (d >= cam.depth_min) & (d <= cam.depth_max)
    return jnp.where(valid, d, 0.0)


def compute_vertices(depth_m: jnp.ndarray, cam: CameraConfig) -> jnp.ndarray:
    """Back-project metric depth to camera-space vertices
    (reference: calculateVertexPositions, CameraTrackingUtils.cu:50-74)."""
    rays = cam_geom.pixel_rays(cam, dtype=depth_m.dtype)
    return rays * depth_m[..., None]


def compute_normals(vertices: jnp.ndarray) -> jnp.ndarray:
    """Central-difference cross-product normals
    (reference: calculateNormals, CameraTrackingUtils.cu:76-113).

    n = normalize(cross(v[y+1,x] - v[y-1,x], v[y,x+1] - v[y,x-1])), zero at
    the border or wherever any participating vertex is invalid.
    """
    # jnp.roll wraps, so border rows/cols are masked out below.
    up = jnp.roll(vertices, 1, axis=0)     # v[y-1, x]
    down = jnp.roll(vertices, -1, axis=0)  # v[y+1, x]
    left = jnp.roll(vertices, 1, axis=1)   # v[y, x-1]
    right = jnp.roll(vertices, -1, axis=1)  # v[y, x+1]

    n = jnp.cross(down - up, right - left)
    length = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = jnp.where(length > 1e-12, n / jnp.maximum(length, 1e-12), 0.0)

    H, W = vertices.shape[:2]
    vy = jnp.arange(H)[:, None]
    vx = jnp.arange(W)[None, :]
    interior = (vy > 0) & (vy < H - 1) & (vx > 0) & (vx < W - 1)

    def z_ok(a):
        return a[..., 2] != 0

    valid = (
        interior
        & z_ok(vertices)
        & z_ok(up)
        & z_ok(down)
        & z_ok(left)
        & z_ok(right)
    )
    return jnp.where(valid[..., None], n, 0.0)


def reject_outliers(
    depth_m: jnp.ndarray,
    band_base: float = 0.03,
    band_quad: float = 0.007,
    min_support: int = 3,
) -> jnp.ndarray:
    """Flying-pixel rejection: keep a depth sample only if >= ``min_support``
    of its 8 neighbors agree with it within a depth-adaptive band.

    Structured-light sensors emit isolated mid-air samples at depth
    discontinuities ("flying pixels"); a real surface sample always has
    same-surface neighbors, a flying pixel has none.  Without this gate
    every outlier allocates voxel blocks along its ray (measured: Kinect-
    class noise tripled block usage on the room-sweep workload).  The band
    grows quadratically with z, tracking both the sensor's axial noise
    (sigma ~ z^2, Khoshelham & Elberink 2012) and the pixel footprint on
    slanted surfaces.  No reference counterpart (its frontend ingests raw
    depth, CameraTrackingUtils.cu:50-74).  Pure shifted adds.
    """
    valid = depth_m > 0
    band = band_base + band_quad * depth_m * depth_m
    support = jnp.zeros(depth_m.shape, dtype=jnp.int32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            n = jnp.roll(depth_m, (dy, dx), axis=(0, 1))
            agree = (n > 0) & (jnp.abs(n - depth_m) < band)
            support = support + agree.astype(jnp.int32)
    return jnp.where(valid & (support >= min_support), depth_m, 0.0)


def bilateral_filter(
    depth_m: jnp.ndarray,
    radius: int = 2,
    sigma_space: float = 1.5,
    sigma_depth: float = 0.03,
) -> jnp.ndarray:
    """Edge-preserving bilateral filter on metric depth.

    Real sensor depth is noisy; KinectFusion-class systems prefilter before
    normal estimation.  The reference has no prefilter at all (its
    preprocess is back-project + normals only, CameraTrackingUtils.cu:50-113).
    Pure shifted adds; invalid (0) pixels neither contribute nor
    get filled.
    """
    acc = jnp.zeros_like(depth_m)
    wacc = jnp.zeros_like(depth_m)
    inv_2ss = 1.0 / (2.0 * sigma_space * sigma_space)
    inv_2sd = 1.0 / (2.0 * sigma_depth * sigma_depth)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            n = jnp.roll(depth_m, (dy, dx), axis=(0, 1))
            dz = n - depth_m
            w = (
                jnp.exp(-(dy * dy + dx * dx) * inv_2ss)
                * jnp.exp(-dz * dz * inv_2sd)
            )
            w = jnp.where(n > 0, w, 0.0)
            acc = acc + w * n
            wacc = wacc + w
    out = acc / jnp.maximum(wacc, 1e-12)
    return jnp.where((depth_m > 0) & (wacc > 0), out, depth_m)


def preprocess(
    depth_raw: jnp.ndarray, cam: CameraConfig, frontend=None
) -> Frame:
    """Full frontend: raw depth -> Frame (vertices, normals, metric depth).

    ``frontend`` is an optional FrontendConfig enabling the bilateral
    prefilter.
    """
    depth_m = depth_to_meters(depth_raw, cam)
    if frontend is not None and frontend.outlier_reject:
        depth_m = reject_outliers(
            depth_m, frontend.outlier_band_base,
            frontend.outlier_band_quad, frontend.outlier_min_support,
        )
    if frontend is not None and frontend.bilateral:
        depth_m = bilateral_filter(
            depth_m, frontend.bilateral_radius,
            frontend.bilateral_sigma_space, frontend.bilateral_sigma_depth,
        )
    vertices = compute_vertices(depth_m, cam)
    normals = compute_normals(vertices)
    return Frame(vertices=vertices, normals=normals, depth=depth_m)


def preprocess_metric(depth_m: jnp.ndarray, cam: CameraConfig) -> Frame:
    """Frontend for already-metric depth (e.g. raycast model maps)."""
    valid = (depth_m >= cam.depth_min) & (depth_m <= cam.depth_max)
    depth_m = jnp.where(valid, depth_m, 0.0)
    vertices = compute_vertices(depth_m, cam)
    normals = compute_normals(vertices)
    return Frame(vertices=vertices, normals=normals, depth=depth_m)


def downsample_depth(depth_m: jnp.ndarray, factor: int) -> jnp.ndarray:
    """Depth pyramid level: valid-aware min-pooling by ``factor``.

    The reference declares an ICP pyramid {4, 5, 10} but never uses it
    (common.h:28-29); here the pyramid is real.  Min-pooling (over valid
    pixels) avoids averaging across depth discontinuities.

    One ``reduce_window`` with a (factor, factor) window: windowed
    reduction is XLA's native pooling op, and it avoids the strided row
    slices a reshape/transpose formulation lowers to.
    """
    if factor <= 1:
        return depth_m
    big = jnp.where(depth_m > 0, depth_m, jnp.inf)
    m = -jax.lax.reduce_window(
        -big,
        -jnp.inf,
        jax.lax.max,
        window_dimensions=(factor, factor),
        window_strides=(factor, factor),
        padding="VALID",
    )
    return jnp.where(jnp.isfinite(m), m, 0.0)


def downsample_depth_mean(
    depth_m: jnp.ndarray, factor: int, edge_band: float = 0.05
) -> jnp.ndarray:
    """Valid-aware AVERAGE pooling with depth-edge rejection.

    Min-pooling assigns the window's nearest depth to the window-center
    ray — a bias of up to one fine pixel along the ray that measurably
    bends the finest-level ICP solution (~6 mm on the synthetic golden
    scene).  Averaging is unbiased on smooth surfaces; windows spanning a
    depth discontinuity (max - min > ``edge_band``) or any invalid pixel
    mixing are emitted as invalid rather than as phantom mid-air points.
    Used for ICP source-side pooling (ICPConfig.source_pools).
    """
    if factor <= 1:
        return depth_m
    valid = depth_m > 0
    dims, strides = (factor, factor), (factor, factor)
    s = jax.lax.reduce_window(
        jnp.where(valid, depth_m, 0.0), 0.0, jax.lax.add, dims, strides,
        "VALID",
    )
    c = jax.lax.reduce_window(
        valid.astype(jnp.float32), 0.0, jax.lax.add, dims, strides, "VALID"
    )
    mn = -jax.lax.reduce_window(
        -jnp.where(valid, depth_m, jnp.inf), -jnp.inf, jax.lax.max, dims,
        strides, "VALID",
    )
    mx = jax.lax.reduce_window(
        jnp.where(valid, depth_m, -jnp.inf), -jnp.inf, jax.lax.max, dims,
        strides, "VALID",
    )
    ok = (c > 0) & ((mx - mn) <= edge_band)
    return jnp.where(ok, s / jnp.maximum(c, 1.0), 0.0)
