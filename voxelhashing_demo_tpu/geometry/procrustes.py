"""Closed-form weighted rigid alignment (correspondence Procrustes/Kabsch).

The reference carries this role as the legacy correspondence-SVD path
``rigidAlignment`` (reference: CameraTracking.cpp:92-115 — an SVD solve of
the linearized 6x6 system, half-wired and dead in the shipped build).
This module implements the standard full-strength version: given matched
point pairs, the SE(3) transform minimizing the weighted point-to-point
error in ONE SVD — no iteration, no small-angle linearization.  It is the
standard initializer when an ICP basin is unknown (relocalization:
models/keyframe_slam._relocalize seeds candidate registrations with it
before the point-to-plane GN refinement).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..config import CameraConfig, ICPConfig
from .se3 import matmul


def procrustes(
    src: jnp.ndarray,
    tgt: jnp.ndarray,
    weights: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """T in SE(3) minimizing ``sum_i w_i ||T @ src_i - tgt_i||^2``.

    ``src``/``tgt``: (N, 3) matched points; ``weights``: (N,) >= 0 (None
    = uniform).  Kabsch: weighted cross-covariance -> SVD -> rotation
    with a det correction so reflections are never returned.  Degenerate
    inputs (total weight ~ 0, or a rank-deficient covariance from e.g.
    collinear points) return a finite best-effort transform; callers gate
    acceptance downstream (the relocalizer refines by ICP and applies its
    inlier/observability gates regardless).
    """
    src = src.reshape(-1, 3).astype(jnp.float32)
    tgt = tgt.reshape(-1, 3).astype(jnp.float32)
    if weights is None:
        weights = jnp.ones(src.shape[:1], dtype=jnp.float32)
    w = weights.reshape(-1).astype(jnp.float32)
    wsum = jnp.sum(w)
    ok = wsum > 1e-6
    wn = w / jnp.where(ok, wsum, 1.0)

    mu_s = jnp.sum(src * wn[:, None], axis=0)
    mu_t = jnp.sum(tgt * wn[:, None], axis=0)
    C = matmul((tgt - mu_t).T, (src - mu_s) * wn[:, None])   # (3, 3)

    U, _, Vt = jnp.linalg.svd(C)
    d = jnp.linalg.det(matmul(U, Vt))
    D = jnp.diag(jnp.array([1.0, 1.0, 0.0], jnp.float32)
                 + jnp.array([0.0, 0.0, 1.0], jnp.float32) * d)
    R = matmul(matmul(U, D), Vt)
    t = mu_t - matmul(R, mu_s)

    T = jnp.eye(4, dtype=jnp.float32)
    T = T.at[:3, :3].set(R).at[:3, 3].set(t)
    T = jnp.where(jnp.all(jnp.isfinite(T)) & ok,
                  T, jnp.eye(4, dtype=jnp.float32))
    return T


def procrustes_init(
    src_frame,
    tgt_frame,
    cam: CameraConfig,
    cfg: ICPConfig,
    rounds: int = 2,
    init_T: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Coarse rigid init by closed-form point-to-point rounds.

    Each round: projective association under the current estimate
    (ops/icp.associate — the same machinery the GN tracker uses) with
    the distance/normal gates opened wide (a badly-displaced start
    yields large but still usable pairs), then one point-to-point
    Procrustes solve on the matched vertex pairs (classic Besl-McKay
    closed-form ICP rounds).  Because the rotation is solved exactly
    (not linearized), each round
    can move much further than a Gauss-Newton step — extending the
    capture basin when the start is far from the truth (the
    relocalizer's situation).  The result is an INITIALIZER: callers
    refine by ICP and apply their acceptance gates.
    """
    import dataclasses

    from ..ops import icp as icp_ops

    wide = dataclasses.replace(
        cfg, dist_thresh=1e6, normal_thresh=-1.0
    )
    T = jnp.eye(4, dtype=jnp.float32) if init_T is None else init_T
    packed = icp_ops.pack_target(tgt_frame)
    for _ in range(rounds):
        p, n_t, r, valid, p_t = icp_ops.associate(
            T, src_frame, tgt_frame, cam, wide, tgt_packed=packed,
            with_points=True,
        )
        delta = procrustes(
            p.reshape(-1, 3), p_t.reshape(-1, 3),
            valid.reshape(-1).astype(jnp.float32),
        )
        T = matmul(delta, T)
    return T


def procrustes_init_raced(
    src_frame,
    tgt_frame,
    cam: CameraConfig,
    cfg: ICPConfig,
    rounds: int = 3,
    yaws_deg: tuple = (-60.0, -40.0, -20.0, 0.0, 20.0, 40.0, 60.0),
) -> jnp.ndarray:
    """Multi-hypothesis Procrustes init: race ``procrustes_init`` from a
    fan of yaw starts and keep the hypothesis with the most gated inliers.

    Projective association is NOT nearest-neighbor: from a start tens of
    degrees off it locks into a sliding-consistent local basin that
    closed-form rounds cannot leave (measured: a 25-degree truth stalls
    at ~21 degrees from identity, but converges to 3 degrees from the
    20-degree hypothesis, with 3x the inliers — the score cleanly picks
    the winner).  Yaw is the right hypothesis axis for a camera that
    kidnaps within a sweep (roll/pitch are bounded by gravity).  All
    hypotheses run as vmap lanes in one dispatch.
    """
    import jax

    from ..ops import icp as icp_ops

    yaws = jnp.deg2rad(jnp.asarray(yaws_deg, dtype=jnp.float32))
    c, s = jnp.cos(yaws), jnp.sin(yaws)
    zeros = jnp.zeros_like(c)
    ones = jnp.ones_like(c)
    R = jnp.stack([
        jnp.stack([c, zeros, s], -1),
        jnp.stack([zeros, ones, zeros], -1),
        jnp.stack([-s, zeros, c], -1),
    ], -2)                                            # (Y, 3, 3)
    T0 = jnp.broadcast_to(
        jnp.eye(4, dtype=jnp.float32), (yaws.shape[0], 4, 4)
    ).at[:, :3, :3].set(R)

    packed = icp_ops.pack_target(tgt_frame)

    def one(T_init):
        T = procrustes_init(src_frame, tgt_frame, cam, cfg,
                            rounds=rounds, init_T=T_init)
        _, _, r, valid = icp_ops.associate(
            T, src_frame, tgt_frame, cam, cfg, tgt_packed=packed
        )
        return T, jnp.sum(valid.astype(jnp.float32))

    Ts, scores = jax.vmap(one)(T0)
    return Ts[jnp.argmax(scores)]
