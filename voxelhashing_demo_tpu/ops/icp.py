"""Point-to-plane ICP camera tracking solved by Gauss-Newton, fully on-device.

Redesign of the reference's tracking stack as one jitted program:

- Projective data association + point-to-plane residual
  (reference: FindCorrespondences, CameraTrackingUtils.cu:131-185) becomes a
  vectorized gather over the whole image — no atomics; the residual
  reduction is a deterministic ``jnp.sum`` instead of
  ``atomicAdd(&globalError, d)`` (CameraTrackingUtils.cu:175).
- The Jacobian rows [n, p x n] (reference: Solver.cu:26-37) are never
  materialized as an N x 6 matrix in HBM the way the reference stores
  d_JacMat; the 6x6 JTJ and 6-vector JTr are formed directly by einsum
  contractions, replacing cublasSsyrk/cublasSgemv
  (reference: Solver.cpp:80-87).  This is the fused normal-equation
  reduction the reference's dead LinearSystem.cu:25-90 path attempted.
- The 20-iteration host-driven loop with 4+ host<->device syncs per
  iteration (reference: CameraTracking.cpp:35-66) becomes a single
  ``lax.while_loop`` inside jit: zero host round-trips.
- The 6x6 solve uses damped Cholesky instead of the reference's explicit
  inverse (reference: Solver.cpp:109-110; its safer LDLT path
  SolveJacobianSystem Solver.cpp:126-139 existed but was unused).

Deviations from the reference, on purpose:
- The residual gate is ``|r| < dist_thresh``; the reference gates ``r <
  distThres`` only (CameraTrackingUtils.cu:170), silently accepting
  arbitrarily negative residuals.
- The Jacobian uses the transformed source point (standard linearization);
  the reference uses the destination point (Solver.cu:49) — equivalent at
  convergence, worse-conditioned far from it.
- A normal-compatibility gate (dot of rotated source normal and target
  normal) is enforced; the reference declares ``normalThres`` but never
  tests it (CameraTrackingUtils.cu:135).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import CameraConfig, ICPConfig
from ..geometry import se3
from ..geometry import camera as cam_geom
from .preprocess import Frame


class NormalSystem(NamedTuple):
    """Packed 6x6 Gauss-Newton normal equations and diagnostics."""

    JTJ: jnp.ndarray     # (6, 6)
    JTr: jnp.ndarray     # (6,)
    error: jnp.ndarray   # scalar: sum of squared residuals over inliers
    count: jnp.ndarray   # scalar: number of inlier correspondences


class ICPResult(NamedTuple):
    transform: jnp.ndarray   # (4, 4) src -> tgt camera transform
    error: jnp.ndarray       # mean squared point-to-plane residual
    count: jnp.ndarray       # inliers at the final iteration
    iters: jnp.ndarray       # iterations executed
    # final-iteration normal matrix (6, 6): its smallest eigenvalue
    # (normalized by count) measures solution observability — ~0 on
    # sliding-degenerate geometry (flat walls), ~1e-2 on structured
    # scenes.  The loop-closure observability gate reads it
    # (models/keyframe_slam; measured thresholds in
    # tests/test_loop_gating.py).
    JTJ: jnp.ndarray


def _sign_nz(x: jnp.ndarray) -> jnp.ndarray:
    """sign() that maps 0 -> +1 (octahedral fold needs a branchless sign)."""
    return jnp.where(x >= 0, 1.0, -1.0).astype(jnp.float32)


def oct_encode_bits(normals: jnp.ndarray) -> jnp.ndarray:
    """Unit normals (..., 3) -> one float32 of bits: 2x bf16 octahedral.

    Octahedral mapping (Meyer et al. 2010): project onto the L1 sphere,
    fold the lower hemisphere.  bf16 components give ~0.3 deg worst-case
    angular error — far inside ICP's normal gate (cos > 0.6) and the
    Gauss-Newton noise floor.  The zero (invalid) normal encodes to 0.0
    bits; consumers must gate validity separately (pack_target stores
    depth 0 for such pixels).
    """
    n = normals
    an = jnp.sum(jnp.abs(n), axis=-1, keepdims=True)
    p = n[..., :2] / jnp.maximum(an, 1e-12)
    fold = (1.0 - jnp.abs(p[..., ::-1])) * _sign_nz(p)
    oct2 = jnp.where(n[..., 2:] < 0, fold, p)
    u = jax.lax.bitcast_convert_type(
        oct2.astype(jnp.bfloat16), jnp.uint16
    ).astype(jnp.uint32)
    bits = u[..., 0] | (u[..., 1] << 16)
    return jax.lax.bitcast_convert_type(bits, jnp.float32)


def oct_decode_bits(bits_f32: jnp.ndarray) -> jnp.ndarray:
    """Inverse of oct_encode_bits: (...,) float32 bits -> (..., 3) unit
    normals.  All-zero bits decode to (0, 0, 1); gate by depth validity."""
    bits = jax.lax.bitcast_convert_type(bits_f32, jnp.uint32)
    x = jax.lax.bitcast_convert_type(
        (bits & jnp.uint32(0xFFFF)).astype(jnp.uint16), jnp.bfloat16
    ).astype(jnp.float32)
    y = jax.lax.bitcast_convert_type(
        (bits >> 16).astype(jnp.uint16), jnp.bfloat16
    ).astype(jnp.float32)
    z = 1.0 - jnp.abs(x) - jnp.abs(y)
    xy = jnp.stack([x, y], axis=-1)
    fold = (1.0 - jnp.abs(xy[..., ::-1])) * _sign_nz(xy)
    xy = jnp.where(z[..., None] < 0, fold, xy)
    n = jnp.concatenate([xy, z[..., None]], axis=-1)
    ln = jnp.linalg.norm(n, axis=-1, keepdims=True)
    return n / jnp.maximum(ln, 1e-12)


def pack_target(tgt: Frame) -> jnp.ndarray:
    """Pack an association target into (H, W, 2) float32: [depth, normal].

    Association is gather-bound (one random device-memory read per
    pixel): packing [vertices, normals] costs 24 bytes/pixel per GN
    iteration.  The target
    vertex is ray(u, v) * depth with ray a pure function of the gathered
    pixel coords (exactly how preprocess built it), and the normal fits in
    one float32 of octahedral bf16 bits — so 8 bytes/pixel carries the
    same information.  Pixels without a valid normal store depth 0 (they
    can never be point-to-plane targets).
    """
    usable = (tgt.depth > 0) & (
        jnp.sum(tgt.normals * tgt.normals, axis=-1) > 0.5
    )
    d = jnp.where(usable, tgt.depth, 0.0)
    return jnp.stack([d, oct_encode_bits(tgt.normals)], axis=-1)


def associate(
    T: jnp.ndarray,
    src: Frame,
    tgt: Frame,
    cam: CameraConfig,
    cfg: ICPConfig,
    tgt_packed: jnp.ndarray | None = None,
    with_points: bool = False,
):
    """Projective data association under current estimate T.

    Returns (p_src_transformed, n_tgt, residual, valid_mask), each (H, W, ...);
    with ``with_points`` the matched target vertex map is appended (the
    closed-form point-to-point consumers — geometry/procrustes — need the
    point itself, not just the plane residual).
    ``tgt_packed`` is the loop-hoisted pack_target(tgt); pass it when
    calling repeatedly with the same target.
    """
    p = se3.apply(T, src.vertices)                    # (H, W, 3)
    n_src = se3.apply_rotation(T, src.normals)
    ij, in_image = cam_geom.project_nearest(p, cam)

    # clamp for the gather; validity handled by mask.  The gather is THE
    # cost of association (random device-memory access), so the target
    # is packed to 8 bytes/pixel (see pack_target).
    u = jnp.clip(ij[..., 0], 0, cam.width - 1)
    v = jnp.clip(ij[..., 1], 0, cam.height - 1)
    if tgt_packed is None:
        tgt_packed = pack_target(tgt)
    g = tgt_packed[v, u]                              # (H, W, 2) gather
    d_t = g[..., 0]
    n_t = oct_decode_bits(g[..., 1])
    # reconstruct the target vertex = ray(u, v) * depth, bit-for-bit the
    # formula preprocess used (geometry/camera.pixel_rays)
    p_t = jnp.stack(
        [
            (u.astype(jnp.float32) - cam.cx) / cam.fx * d_t,
            (v.astype(jnp.float32) - cam.cy) / cam.fy * d_t,
            d_t,
        ],
        axis=-1,
    )

    r = jnp.sum((p - p_t) * n_t, axis=-1)             # point-to-plane residual

    src_valid = src.vertices[..., 2] != 0
    tgt_valid = d_t > 0
    n_ok = jnp.sum(n_src * n_t, axis=-1) > cfg.normal_thresh
    valid = (
        src_valid
        & in_image
        & tgt_valid
        & n_ok
        & (jnp.abs(r) < cfg.dist_thresh)
    )
    if with_points:
        return p, n_t, r, valid, p_t
    return p, n_t, r, valid


def build_normal_system(
    p: jnp.ndarray,
    n_t: jnp.ndarray,
    r: jnp.ndarray,
    valid: jnp.ndarray,
    huber_delta: float = 0.0,
) -> NormalSystem:
    """Form JTJ / JTr directly from the association maps.

    J row for pixel i: [n_i, (p_i x n_i)] (translation block first,
    reference: Solver.cu:30-35).  Contractions are (6 x N) @ (N x 6)
    matmuls at HIGHEST precision (geometry/se3.matmul).

    With ``huber_delta`` > 0 the system is IRLS-weighted by the Huber
    kernel (w = min(1, delta/|r|)) — outlier correspondences (dynamic
    objects, depth shadows) are down-weighted instead of fully trusted.
    The reference has no robust kernel (hard gate only,
    CameraTrackingUtils.cu:170).
    """
    w = valid.astype(jnp.float32)
    if huber_delta > 0:
        w = w * jnp.minimum(
            1.0, huber_delta / jnp.maximum(jnp.abs(r), 1e-12)
        )
    w_sqrt = jnp.sqrt(w)
    cross = jnp.cross(p, n_t)
    J = jnp.concatenate([n_t, cross], axis=-1)         # (H, W, 6)
    J = (J * w_sqrt[..., None]).reshape(-1, 6)
    rw = (r * w_sqrt).reshape(-1)

    JTJ = se3.matmul(J.T, J)                            # (6, 6)
    JTr = se3.matmul(J.T, rw)
    error = jnp.sum(rw * rw)
    count = jnp.sum(valid.astype(jnp.float32))
    return NormalSystem(JTJ=JTJ, JTr=JTr, error=error, count=count)


def solve_normal_system(
    sys: NormalSystem, damping: float
) -> jnp.ndarray:
    """Damped Cholesky solve of (JTJ + lambda I) delta = -JTr.

    Replaces the reference's explicit inverse (Solver.cpp:109-110).  The
    damping both regularizes degenerate geometry and makes the factorization
    safe when count ~ 0.
    """
    A = sys.JTJ + damping * jnp.eye(6, dtype=sys.JTJ.dtype)
    # scale-invariant extra damping when the system is empty/degenerate
    A = A + jnp.where(sys.count > 6, 0.0, 1.0) * jnp.eye(6, dtype=A.dtype)
    L, low = jax.scipy.linalg.cho_factor(A, lower=True)
    delta = jax.scipy.linalg.cho_solve((L, low), -sys.JTr)
    # a non-finite solve (should not happen with damping) yields no update
    return jnp.where(jnp.all(jnp.isfinite(delta)), delta, 0.0)


@partial(jax.jit, static_argnames=("cam", "cfg"))
def icp_align(
    src: Frame,
    tgt: Frame,
    cam: CameraConfig,
    cfg: ICPConfig,
    init_T: jnp.ndarray | None = None,
) -> ICPResult:
    """Align src onto tgt: returns T such that T @ src ~= tgt.

    The entire iteration runs inside one jitted ``lax.while_loop``
    (replacing reference CameraTracking.cpp:35-66's host loop), with a
    convergence test on the update norm — the reference's only early-out
    was ``error == 0`` (CameraTracking.cpp:55-58).
    """
    if init_T is None:
        init_T = se3.identity()

    tgt_packed = pack_target(tgt)

    def step(T):
        p, n_t, r, valid = associate(T, src, tgt, cam, cfg, tgt_packed)
        sys = build_normal_system(p, n_t, r, valid, cfg.huber_delta)
        delta = solve_normal_system(sys, cfg.damping)
        T_new = se3.compose(se3.exp(delta), T)
        return T_new, sys, jnp.sum(delta * delta)

    def cond(state):
        T, it, dnorm, err, cnt, JTJ = state
        return (it < cfg.max_iters) & (dnorm > cfg.update_tol**2)

    def body(state):
        T, it, dnorm, err, cnt, _ = state
        T_new, sys, d2 = step(T)
        mse = sys.error / jnp.maximum(sys.count, 1.0)
        return (T_new, it + 1, d2, mse, sys.count, sys.JTJ)

    init = (
        init_T,
        jnp.int32(0),
        jnp.float32(jnp.inf),
        jnp.float32(jnp.inf),
        jnp.float32(0.0),
        jnp.zeros((6, 6), dtype=jnp.float32),
    )
    T, iters, _, err, count, JTJ = jax.lax.while_loop(cond, body, init)
    return ICPResult(transform=T, error=err, count=count, iters=iters,
                     JTJ=JTJ)


def observability(res: ICPResult) -> jnp.ndarray:
    """Normalized smallest eigenvalue of the final normal matrix: ~0 when
    some twist direction is unconstrained (pure wall: sliding; corner:
    translation along the fold), >= ~1e-2 on structured scenes.  The
    direct test for the sliding registrations that pass residual/inlier
    gates (a flat cost along the slide direction IS a null JTJ
    direction)."""
    E = res.JTJ / jnp.maximum(res.count, 1.0)[..., None, None]
    return jnp.linalg.eigvalsh(E)[..., 0]


def alignment_score_sums(
    T: jnp.ndarray,
    src: Frame,
    tgt: Frame,
    cam: CameraConfig,
    cfg: ICPConfig,
    tgt_packed: jnp.ndarray | None = None,
):
    """(sum, count) of a robust alignment cost of ``T`` on a COMMON domain.

    ICP's per-inlier mean residual is NOT comparable between two candidate
    transforms: their inlier sets differ, and on near-symmetric scenes a
    wrong-basin solution can report a lower mean over fewer, self-selected
    inliers.  This scores every source-valid pixel identically: clamped
    |point-to-plane residual| where a target match exists, the full clamp
    (dist_thresh) where the pixel projects off-screen or onto invalid
    target — so losing correspondences costs, not pays.  The sharded twin
    psums the two sums before dividing.
    """
    if tgt_packed is None:
        tgt_packed = pack_target(tgt)
    p = se3.apply(T, src.vertices)
    ij, in_image = cam_geom.project_nearest(p, cam)
    u = jnp.clip(ij[..., 0], 0, cam.width - 1)
    v = jnp.clip(ij[..., 1], 0, cam.height - 1)
    g = tgt_packed[v, u]
    d_t = g[..., 0]
    n_t = oct_decode_bits(g[..., 1])
    p_t = jnp.stack(
        [
            (u.astype(jnp.float32) - cam.cx) / cam.fx * d_t,
            (v.astype(jnp.float32) - cam.cy) / cam.fy * d_t,
            d_t,
        ],
        axis=-1,
    )
    r = jnp.sum((p - p_t) * n_t, axis=-1)
    src_valid = src.vertices[..., 2] != 0
    matched = in_image & (d_t > 0)
    cap = cfg.dist_thresh
    pen = jnp.where(matched, jnp.minimum(jnp.abs(r), cap), cap)
    num = jnp.sum(jnp.where(src_valid, pen, 0.0))
    den = jnp.sum(src_valid.astype(jnp.float32))
    return num, den


def pick_by_score(
    challenger: ICPResult,
    base: ICPResult,
    challenger_score: jnp.ndarray,
    base_score: jnp.ndarray,
) -> ICPResult:
    """Choose between two raced ICP results by their common-domain
    alignment scores (alignment_score_sums).  Ties and non-finite
    challengers go to the base (identity-start) result."""
    c_ok = (
        jnp.all(jnp.isfinite(challenger.transform))
        & jnp.isfinite(challenger_score)
    )
    take_c = c_ok & (challenger_score < base_score)
    return jax.tree.map(
        lambda x, y: jnp.where(take_c, x, y), challenger, base
    )


def motion_plausible(T: jnp.ndarray, cfg: ICPConfig) -> jnp.ndarray:
    """Gate a tracked per-frame transform against the physically
    plausible motion envelope (ICPConfig.max_motion_trans/rot).

    Projective ICP in box-room geometry can converge to a wrong basin
    with thousands of sliding point-to-plane inliers (measured: a 1.4 m
    teleport "tracked" with 9k inliers, tests/test_backend_robustness).
    A real sensor cannot teleport between frames, so a result beyond the
    envelope is a tracking failure by definition — the signal the
    relocalizer (models/keyframe_slam) engages on."""
    if cfg.max_motion_trans <= 0:
        return jnp.bool_(True)
    t_ok = jnp.linalg.norm(T[:3, 3]) <= cfg.max_motion_trans
    r_ok = se3.rotation_angle(T) <= jnp.deg2rad(cfg.max_motion_rot_deg)
    return t_ok & r_ok


def icp_align_pyramid(
    depth_src_m: jnp.ndarray,
    depth_tgt_m: jnp.ndarray,
    cam: CameraConfig,
    cfg: ICPConfig,
    init_T: jnp.ndarray | None = None,
    src_full: Frame | None = None,
    tgt_full: Frame | None = None,
    prior_T: jnp.ndarray | None = None,
) -> ICPResult:
    """Coarse-to-fine ICP over a depth pyramid.

    The reference declared a pyramid schedule but never built one
    (common.h:28-29 unused); this is the real thing.  Levels are static
    Python iteration (each level jit-compiles once).  Pass ``src_full`` /
    ``tgt_full`` when full-resolution Frames are already preprocessed —
    the finest level then skips recomputing vertices/normals.

    ``prior_T`` is an optional motion prior (constant-velocity predictor):
    the COARSEST level runs twice, once from ``init_T`` (default identity)
    and once from the prior, and the better result (pick_better) seeds the
    finer levels.  Racing instead of trusting the prior is what makes it
    safe: a naive always-prior start lands in wrong local minima of
    symmetric scenes on direction reversals, while the race can only
    improve on the identity start.  The extra cost is one coarse level.
    """
    import dataclasses

    from .preprocess import (downsample_depth, downsample_depth_mean,
                             preprocess_metric)

    T = se3.identity() if init_T is None else init_T
    result = None
    levels = sorted(set(cfg.pyramid), reverse=True)
    iters = cfg.pyramid_iters
    if len(iters) != len(levels):
        iters = (cfg.max_iters,) * len(levels)
    pools = cfg.source_pools
    if len(pools) != len(levels):
        pools = (1,) * len(levels)
    for li, (factor, max_it, pool) in enumerate(zip(levels, iters, pools)):
        lcam = cam.scaled(factor) if factor > 1 else cam
        lcfg = dataclasses.replace(cfg, max_iters=max_it)
        if factor > 1:
            tgt = preprocess_metric(downsample_depth(depth_tgt_m, factor),
                                    lcam)
        else:
            tgt = (tgt_full if tgt_full is not None
                   else preprocess_metric(depth_tgt_m, lcam))
        # the source may be pooled further than the target: its points are
        # metric 3D samples projected into the lcam-res target, so a
        # coarser source only thins correspondences (gather cost /pool^2)
        # without coarsening the target they are matched against.  Pooled
        # sources use MEAN pooling: min-pooling's near-bias would bend the
        # finest-level solution (see downsample_depth_mean).
        sfactor = factor * pool
        if pool > 1:
            src = preprocess_metric(
                downsample_depth_mean(depth_src_m, sfactor),
                cam.scaled(sfactor),
            )
        elif sfactor > 1:
            src = preprocess_metric(downsample_depth(depth_src_m, sfactor),
                                    cam.scaled(sfactor))
        else:
            src = (src_full if src_full is not None
                   else preprocess_metric(depth_src_m, lcam))
        result = icp_align(src, tgt, lcam, lcfg, init_T=T)
        if li == 0 and prior_T is not None:
            raced = icp_align(src, tgt, lcam, lcfg, init_T=prior_T)
            packed = pack_target(tgt)
            sn, sd = alignment_score_sums(raced.transform, src, tgt, lcam,
                                          lcfg, packed)
            bn, bd = alignment_score_sums(result.transform, src, tgt, lcam,
                                          lcfg, packed)
            result = pick_by_score(
                raced, result,
                sn / jnp.maximum(sd, 1.0), bn / jnp.maximum(bd, 1.0),
            )
        T = result.transform
    return result
