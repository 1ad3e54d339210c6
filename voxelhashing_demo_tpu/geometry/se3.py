"""SE(3) Lie group operations in closed form.

The reference uses Eigen's generic dense matrix exponential/logarithm
(reference: SE3.cpp:4-26, ``unsupported/Eigen/MatrixFunctions``) on the host.
Under jit we need branch-free closed forms: Rodrigues for exp,
and the standard SO(3)/SE(3) log with Taylor guards near theta = 0 so the
whole tracker differentiates and vectorizes.

Twist convention: ``xi = [v, w]`` (translation first, rotation second) —
matching the reference's Jacobian row layout ``[n, p x n]`` where the first
three columns multiply the translation (reference: Solver.cu:26-37).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8

# Every float32 contraction in the package runs at HIGHEST precision: a
# GPU may otherwise run a float32 dot in TF32 (~3 decimal digits), which
# puts millimetres of error on a 3 m world coordinate — against 2 cm
# voxels and a 1 cm Huber band.  The contractions are at most 6 wide, so
# full precision adds little work.
HIGHEST = jax.lax.Precision.HIGHEST


def matmul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """``a @ b`` at full float32 precision."""
    return jnp.matmul(a, b, precision=HIGHEST)


def einsum(spec: str, *operands: jnp.ndarray) -> jnp.ndarray:
    """``jnp.einsum`` at full float32 precision."""
    return jnp.einsum(spec, *operands, precision=HIGHEST)


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """so(3) hat operator: 3-vector -> skew-symmetric 3x3."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zero, -wz, wy], axis=-1),
            jnp.stack([wz, zero, -wx], axis=-1),
            jnp.stack([-wy, wx, zero], axis=-1),
        ],
        axis=-2,
    )


def vee(M: jnp.ndarray) -> jnp.ndarray:
    """Inverse of hat: skew-symmetric 3x3 -> 3-vector."""
    return jnp.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], axis=-1)


def _sinc_factors(theta2: jnp.ndarray):
    """Return (A, B, C) = (sin t/t, (1-cos t)/t^2, (t - sin t)/t^3),
    float32-stable and branch-free.

    B uses the half-angle identity 0.5*(sin(t/2)/(t/2))^2 — the naive
    (1-cos t)/t^2 cancels catastrophically in f32 below t ~ 1e-3 (cos
    rounds to 1.0f).  A wide Taylor window (t < 0.1) covers C, whose
    exact form cancels the same way.
    """
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-2
    A = jnp.where(small,
                  1.0 - theta2 / 6.0 + theta2 * theta2 / 120.0,
                  jnp.sin(theta) / theta)
    half = 0.5 * theta
    s_half = jnp.sin(half) / half
    B = 0.5 * s_half * s_half
    C = jnp.where(small,
                  1.0 / 6.0 - theta2 / 120.0 + theta2 * theta2 / 5040.0,
                  (1.0 - A) / theta2)
    return A, B, C


def exp(xi: jnp.ndarray) -> jnp.ndarray:
    """SE(3) exponential map: twist [v, w] (..., 6) -> (..., 4, 4) matrix.

    Closed-form Rodrigues (replaces reference SE3.cpp:4-11's generic
    ``.exp()``): R = I + A K + B K^2, V = I + B K + C K^2, t = V v.
    """
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = jnp.sum(w * w, axis=-1)[..., None, None]
    K = hat(w)
    K2 = matmul(K, K)
    I = jnp.eye(3, dtype=xi.dtype)
    A, B, C = _sinc_factors(theta2)
    R = I + A * K + B * K2
    V = I + B * K + C * K2
    t = einsum("...ij,...j->...i", V, v)
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=xi.dtype),
        top.shape[:-2] + (1, 4),
    )
    return jnp.concatenate([top, bottom], axis=-2)


def log(T: jnp.ndarray) -> jnp.ndarray:
    """SE(3) logarithm: (..., 4, 4) -> twist [v, w] (..., 6).

    Closed form replacing reference SE3.cpp:14-19's generic ``.log()``.
    The rotation angle comes from ``atan2(|vee(R - R^T)|/2, (tr-1)/2)``
    rather than arccos: arccos has an infinite derivative at the identity,
    which poisons ``jacfwd`` through pose-graph residuals (ops/pose_graph.py)
    with NaNs; this form is exact and differentiable there (theta within pi
    of zero; rotations at exactly pi remain out of scope for graph edges).
    """
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w_sin = vee(0.5 * (R - jnp.swapaxes(R, -1, -2)))   # sin(theta) * axis
    s2 = jnp.sum(w_sin * w_sin, axis=-1)
    c = jnp.clip(
        (jnp.trace(R, axis1=-2, axis2=-1) - 1.0) * 0.5, -1.0, 1.0
    )
    s = jnp.sqrt(s2 + 1e-24)
    theta = jnp.arctan2(s, c)
    theta2 = (theta * theta)[..., None, None]
    # w = theta / sin(theta) * w_sin; the ratio -> 1 smoothly at theta = 0
    w = (theta / s)[..., None] * w_sin
    K = hat(w)
    K2 = matmul(K, K)
    I = jnp.eye(3, dtype=T.dtype)
    A, B, _ = _sinc_factors(theta2)
    # V^{-1} = I - K/2 + (1/theta^2)(1 - A/(2B)) K^2; the exact form
    # cancels in f32 below theta ~ 0.1, so a wide Taylor window applies
    coef = jnp.where(
        theta2 < 1e-2,
        1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0,
        (1.0 - A / (2.0 * B)) / jnp.maximum(theta2, _EPS),
    )
    V_inv = I - 0.5 * K + coef * K2
    v = einsum("...ij,...j->...i", V_inv, t)
    return jnp.concatenate([v, w], axis=-1)


def inverse(T: jnp.ndarray) -> jnp.ndarray:
    """Rigid-transform inverse without a generic 4x4 inverse."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    ti = -einsum("...ij,...j->...i", Rt, t)
    top = jnp.concatenate([Rt, ti[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=T.dtype),
        top.shape[:-2] + (1, 4),
    )
    return jnp.concatenate([top, bottom], axis=-2)


def compose(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Group composition A @ B (reference: SE3.cpp:24-26 updateTransform)."""
    return matmul(A, B)


def apply(T: jnp.ndarray, points: jnp.ndarray) -> jnp.ndarray:
    """Apply a single rigid transform (4, 4) to (..., 3) points.

    For batched transforms, vmap over this.
    """
    R = T[:3, :3]
    t = T[:3, 3]
    return matmul(points, R.T) + t


def apply_rotation(T: jnp.ndarray, vecs: jnp.ndarray) -> jnp.ndarray:
    """Rotate (..., 3) vectors by a single (4, 4) transform — for normals."""
    return matmul(vecs, T[:3, :3].T)


def identity(dtype=jnp.float32) -> jnp.ndarray:
    return jnp.eye(4, dtype=dtype)


def rotation_angle(T: jnp.ndarray) -> jnp.ndarray:
    """Rotation magnitude (radians) of a rigid transform."""
    tr = jnp.trace(T[..., :3, :3], axis1=-2, axis2=-1)
    return jnp.arccos(jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0))
