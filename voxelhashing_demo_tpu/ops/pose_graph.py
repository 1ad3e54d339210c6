"""Keyframe pose graph optimization (bundle adjustment over poses), on-device.

The reference has nothing like this: its tracking is pure frame-to-frame ICP
with unbounded drift — no keyframes, no loop closure, no global optimization
(SURVEY.md §5 "long-context" row; reference CameraTracking.cpp:26-69 is the
whole tracking stack).  This module is the north-star component that bounds
drift over long sequences (BASELINE.json config 3).

Design (static shapes, one jit):
- The graph is a static-shape pytree: padded pose array [K, 4, 4] and padded
  edge arrays (indices, SE3 measurements, scalar weights).  Padding edges are
  (0, 0, identity, weight 0) so their residuals are exactly zero.
- Residual per edge (i, j):  r = log( Z_ij^-1 · T_i^-1 · T_j )  in se(3).
- Gauss-Newton with a *local* right-perturbation parameterization
  T_i <- T_i · exp(xi_i); each edge's exact 6x12 Jacobian block pair is
  computed per edge (vmapped forward-mode through exp/log) and
  scatter-added into the block-sparse normal matrix — O(E) build cost,
  independent of the graph capacity K.  Two inner solvers share that
  build (``KeyframeConfig.ba_solver``): a dense 6K x 6K Cholesky
  (exact; K=256 -> 1536^2, a small dense factorization) while K is small, and
  matrix-free block-Jacobi-preconditioned CG (``solve_delta_cg``) —
  O(E) per iteration, H never materialized — once the graph outgrows
  it; "auto" switches at the static capacity, so long runs get the
  scale-proof solve with one extra recompile and short runs pay
  nothing.
- Gauge freedom is fixed by an anchor prior on pose 0; Levenberg damping
  makes unconstrained (padded) poses a no-op instead of a singularity.
- The whole optimization (build J -> H -> solve -> retract, iterated) runs
  inside one jit; the multi-chip path shards edges and psums H/b
  (parallel/sharded.py).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import KeyframeConfig
from ..geometry import se3


class PoseGraph(NamedTuple):
    """Padded, static-shape pose graph (a pytree)."""

    poses: jnp.ndarray      # [K, 4, 4] camera-to-world keyframe poses
    num_poses: jnp.ndarray  # () int32; rows >= num_poses are identity pads
    edges_ij: jnp.ndarray   # [E, 2] int32 (i, j) pose indices; pads (0, 0)
    edges_T: jnp.ndarray    # [E, 4, 4] measured T_i^-1 @ T_j; pads identity
    edges_w: jnp.ndarray    # [E] float32 information weight; pads 0
    num_edges: jnp.ndarray  # () int32


class BAInfo(NamedTuple):
    chi2_initial: jnp.ndarray
    chi2_final: jnp.ndarray
    iters: jnp.ndarray


def create(max_keyframes: int, max_edges: int) -> PoseGraph:
    I = jnp.eye(4, dtype=jnp.float32)
    return PoseGraph(
        poses=jnp.broadcast_to(I, (max_keyframes, 4, 4)),
        num_poses=jnp.int32(0),
        edges_ij=jnp.zeros((max_edges, 2), dtype=jnp.int32),
        edges_T=jnp.broadcast_to(I, (max_edges, 4, 4)),
        edges_w=jnp.zeros((max_edges,), dtype=jnp.float32),
        num_edges=jnp.int32(0),
    )


def grow(
    graph: PoseGraph, max_keyframes: int, max_edges: int
) -> PoseGraph:
    """Host-side capacity growth: re-pad the arrays to larger capacities.

    The contents (poses, edges, counts) are preserved bit-exactly; the new
    rows are the same identity/zero padding ``create`` emits.  Jitted
    consumers (``optimize``) recompile once per new shape — growth doubles,
    so that happens O(log K) times over a run.  This is what keeps a long
    multi-room run from silently degrading to pure odometry when the
    initial capacity fills (models/keyframe_slam.py grows on demand).
    """
    K, E = graph.poses.shape[0], graph.edges_ij.shape[0]
    if max_keyframes < K or max_edges < E:
        raise ValueError(f"grow must not shrink: {(K, E)} -> "
                         f"{(max_keyframes, max_edges)}")
    I = jnp.eye(4, dtype=jnp.float32)
    return graph._replace(
        poses=jnp.concatenate(
            [graph.poses,
             jnp.broadcast_to(I, (max_keyframes - K, 4, 4))]
        ),
        edges_ij=jnp.concatenate(
            [graph.edges_ij, jnp.zeros((max_edges - E, 2), jnp.int32)]
        ),
        edges_T=jnp.concatenate(
            [graph.edges_T, jnp.broadcast_to(I, (max_edges - E, 4, 4))]
        ),
        edges_w=jnp.concatenate(
            [graph.edges_w, jnp.zeros((max_edges - E,), jnp.float32)]
        ),
    )


def add_pose(graph: PoseGraph, T: jnp.ndarray) -> PoseGraph:
    """Append a keyframe pose (no-op if at capacity)."""
    k = graph.num_poses
    K = graph.poses.shape[0]
    idx = jnp.where(k < K, k, K)
    return graph._replace(
        poses=graph.poses.at[idx].set(T, mode="drop"),
        num_poses=jnp.minimum(k + 1, K),
    )


def add_edge(
    graph: PoseGraph,
    i: jnp.ndarray,
    j: jnp.ndarray,
    T_ij: jnp.ndarray,
    weight: jnp.ndarray | float = 1.0,
) -> PoseGraph:
    """Append a relative-pose constraint (no-op if at capacity)."""
    e = graph.num_edges
    E = graph.edges_ij.shape[0]
    idx = jnp.where(e < E, e, E)
    return graph._replace(
        edges_ij=graph.edges_ij.at[idx].set(
            jnp.stack([jnp.int32(i), jnp.int32(j)]), mode="drop"
        ),
        edges_T=graph.edges_T.at[idx].set(T_ij, mode="drop"),
        edges_w=graph.edges_w.at[idx].set(
            jnp.float32(weight), mode="drop"
        ),
        num_edges=jnp.minimum(e + 1, E),
    )


def edge_residuals(
    poses: jnp.ndarray, edges_ij: jnp.ndarray, edges_T: jnp.ndarray
) -> jnp.ndarray:
    """se(3) residuals r_e = log(Z_e^-1 · T_i^-1 · T_j)  ->  (E, 6)."""
    Ti = poses[edges_ij[:, 0]]
    Tj = poses[edges_ij[:, 1]]
    pred = se3.compose(se3.inverse(Ti), Tj)
    return se3.log(se3.compose(se3.inverse(edges_T), pred))


def robust_edge_weights(
    graph: PoseGraph, delta: float, kernel: str = "gm"
) -> jnp.ndarray:
    """IRLS robust-kernel edge weights  ->  (E,).

    One false loop closure that slips past the acceptance gates would
    otherwise corrupt the whole graph (every pose bends toward the bogus
    constraint, and the map rebuild then bakes the corruption into the
    TSDF).  ``delta`` is in the mixed se(3) residual norm (meters +
    radians); honest drift corrections are mm-to-cm scale, false closures
    decimeter-plus.  Weights are re-evaluated every GN iteration as the
    poses move (IRLS).  Kernels:

    - ``"gm"`` (default): Geman-McClure ``delta^2 / (delta^2 + ||r||^2)``
      — redescending: a wrong-by-0.5 m edge keeps ~4 % weight and the
      graph essentially sheds it (measured 1.3 mm residual ATE vs 36 mm
      for Huber on the false-edge ring benchmark,
      tests/test_backend_robustness.py).  Nonconvex, but the odometry
      chain always provides a good linearization point, and measured
      honest-drift convergence is identical to Huber up to 0.38 residual.
    - ``"huber"``: ``min(1, delta / ||r||)`` — convex, influence bounded
      by delta but never zero.

    No reference counterpart (the reference has no backend, SURVEY.md §5).
    """
    r = edge_residuals(graph.poses, graph.edges_ij, graph.edges_T)
    if kernel == "gm":
        rn2 = jnp.sum(r * r, axis=-1)
        h = delta * delta / (delta * delta + rn2)
    elif kernel == "huber":
        rn = jnp.linalg.norm(r, axis=-1)
        h = jnp.minimum(1.0, delta / jnp.maximum(rn, 1e-12))
    else:
        raise ValueError(f"unknown robust kernel {kernel!r}")
    return graph.edges_w * h


def _chi2(graph: PoseGraph) -> jnp.ndarray:
    r = edge_residuals(graph.poses, graph.edges_ij, graph.edges_T)
    return jnp.sum(graph.edges_w * jnp.sum(r * r, axis=-1))


def build_normal_equations(
    graph: PoseGraph,
    robust_delta=None,
    robust_kernel: str = "gm",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(H, b, chi2) of the weighted GN system about the current poses.

    H is (6K, 6K), b is (6K,).  Exposed separately so the sharded path can
    build partial systems per device and ``psum`` them (the distributed-BA
    reduction of SURVEY.md §2b's last row; the robust weight depends only
    on an edge's own residual, so per-shard weights compose exactly).

    ``robust_delta`` (a python float > 0 or a traced scalar; None/0 = off)
    applies the IRLS robust reweighting (``robust_edge_weights``) about
    the current linearization point.

    Block-sparse build, O(E) independent of the graph capacity K: each
    edge touches exactly two poses, so its Jacobian is a 6x12 block pair
    — computed per edge (12 forward tangents through exp/log, vmapped
    over edges) and scattered into H as four 6x6 blocks.  The previous
    implementation differentiated the full residual stack against all
    K*6 twists at once, materializing an (E, 6, K, 6) Jacobian whose
    cost scaled O(E*K) and made BA capacity-sensitive.
    This is the per-edge half of the reference-lineage fused reduction
    (reference: LinearSystem.cu:25-90 accumulates per-correspondence
    blocks the same way).
    """
    K = graph.poses.shape[0]
    i_idx, j_idx, Hii, Hij, Hjj, bblk, chi2 = _edge_blocks(
        graph, robust_delta, robust_kernel
    )
    # four 6x6 blocks per edge, scatter-added into the (K, K, 6, 6)
    # block matrix (padding edges have w=0 -> zero blocks)
    Hblk = jnp.zeros((K, K, 6, 6), dtype=jnp.float32)
    Hblk = Hblk.at[i_idx, i_idx].add(Hii)
    Hblk = Hblk.at[i_idx, j_idx].add(Hij)
    Hblk = Hblk.at[j_idx, i_idx].add(jnp.swapaxes(Hij, 1, 2))
    Hblk = Hblk.at[j_idx, j_idx].add(Hjj)
    Hn = Hblk.transpose(0, 2, 1, 3).reshape(K * 6, K * 6)
    return Hn, bblk.reshape(-1), chi2


def _edge_blocks(
    graph: PoseGraph,
    robust_delta=None,
    robust_kernel: str = "gm",
):
    """Per-edge 6x6 GN blocks — the shared O(E) build both solvers use.

    Returns ``(i_idx, j_idx, Hii, Hij, Hjj, bblk, chi2)`` where
    ``Hii/Hij/Hjj`` are the edge's (E, 6, 6) contributions to the
    (i, i) / (i, j) / (j, j) blocks of H ((j, i) is ``Hij^T``) and
    ``bblk`` is the assembled (K, 6) gradient.  Nothing K x K is ever
    materialized here; the dense path scatters these into the full block
    matrix, the CG path consumes them directly as the matvec operands.
    """
    K = graph.poses.shape[0]
    if isinstance(robust_delta, (int, float)) and robust_delta <= 0:
        robust_delta = None
    ew = (robust_edge_weights(graph, robust_delta, robust_kernel)
          if robust_delta is not None else graph.edges_w)

    i_idx = graph.edges_ij[:, 0]
    j_idx = graph.edges_ij[:, 1]
    Ti = graph.poses[i_idx]                               # (E, 4, 4)
    Tj = graph.poses[j_idx]

    def edge_r(Ti_e, Tj_e, Z_e):
        return se3.log(se3.compose(
            se3.compose(se3.inverse(Z_e), se3.inverse(Ti_e)), Tj_e))

    def edge_jac(Ti_e, Tj_e, Z_e):
        def r_of(xi):                                     # xi: (12,)
            return edge_r(
                se3.compose(Ti_e, se3.exp(xi[:6])),
                se3.compose(Tj_e, se3.exp(xi[6:])), Z_e
            )

        return jax.jacfwd(r_of)(jnp.zeros((12,), dtype=jnp.float32))

    r = jax.vmap(edge_r)(Ti, Tj, graph.edges_T)           # (E, 6)
    J = jax.vmap(edge_jac)(Ti, Tj, graph.edges_T)         # (E, 6, 12)
    Ji, Jj = J[:, :, :6], J[:, :, 6:]
    wJi = Ji * ew[:, None, None]
    wJj = Jj * ew[:, None, None]

    Hii = se3.einsum("eab,eac->ebc", wJi, Ji)
    Hij = se3.einsum("eab,eac->ebc", wJi, Jj)
    Hjj = se3.einsum("eab,eac->ebc", wJj, Jj)

    bi = se3.einsum("eab,ea->eb", wJi, r)
    bj = se3.einsum("eab,ea->eb", wJj, r)
    bblk = jnp.zeros((K, 6), dtype=jnp.float32)
    bblk = bblk.at[i_idx].add(bi).at[j_idx].add(bj)

    chi2 = jnp.sum(ew * jnp.sum(r * r, axis=-1))
    return i_idx, j_idx, Hii, Hij, Hjj, bblk, chi2


def solve_delta_cg(
    graph: PoseGraph,
    robust_delta,
    cfg: KeyframeConfig,
) -> jnp.ndarray:
    """GN step by matrix-free block-Jacobi-preconditioned CG -> (K, 6).

    Solves the same damped, anchored system ``apply_update`` solves
    densely, but H is never materialized: the matvec gathers the two
    pose twists each edge touches, applies the edge's 6x6 blocks, and
    scatter-adds — O(E) work and O(E * 36 + K * 36) memory per
    iteration, flat in the graph capacity K (the dense path is O(K^2)
    memory / O(K^3) solve).  The preconditioner is the exact block
    diagonal of the damped system, one vmapped 6x6 Cholesky per pose —
    for SLAM graphs (an odometry chain plus sparse closures) that
    captures almost all of H's energy, and measured convergence reaches
    float32 parity with the dense solve in well under
    ``cfg.ba_cg_iters`` iterations (tests/test_pose_graph.py).

    This is the scale-proof half of the north star's "Schur-complement
    reduction" (BASELINE.md): poses are the only variables (the map is
    rebuilt, not optimized), so block-preconditioned CG on the reduced
    pose system IS the scalable solve.  Single-device only by design:
    the sharded BA path psums the dense H (parallel/sharded.py) — at
    the K where CG matters, edges no longer dominate and sharding the
    build stops paying.
    """
    K = graph.poses.shape[0]
    i_idx, j_idx, Hii, Hij, Hjj, bblk, _ = _edge_blocks(
        graph, robust_delta, cfg.ba_robust_kernel
    )
    HijT = jnp.swapaxes(Hij, 1, 2)

    # damping + gauge anchor, as (K, 6) diagonal addends (matches the
    # dense path's  H + diag(anchor) + lambda I  exactly)
    diagv = jnp.full((K, 6), cfg.ba_damping, dtype=jnp.float32)
    diagv = diagv.at[0].add(1e6)

    def matvec(x):                                        # (K, 6)
        xi, xj = x[i_idx], x[j_idx]
        yi = (se3.einsum("ebc,ec->eb", Hii, xi)
              + se3.einsum("ebc,ec->eb", Hij, xj))
        yj = (se3.einsum("ebc,ec->eb", HijT, xi)
              + se3.einsum("ebc,ec->eb", Hjj, xj))
        y = jnp.zeros((K, 6), dtype=jnp.float32)
        return y.at[i_idx].add(yi).at[j_idx].add(yj) + diagv * x

    # block-Jacobi preconditioner: the (K, 6, 6) diagonal of the damped
    # system, factored once per GN iteration
    Hd = jnp.zeros((K, 6, 6), dtype=jnp.float32)
    Hd = Hd.at[i_idx].add(Hii).at[j_idx].add(Hjj)
    Hd = Hd + jax.vmap(jnp.diag)(diagv)
    Ld = jax.vmap(lambda M: jax.scipy.linalg.cho_factor(M, lower=True)[0])(
        Hd
    )

    def precond(r):
        return jax.vmap(
            lambda L, v: jax.scipy.linalg.cho_solve((L, True), v)
        )(Ld, r)

    def dot(a, b):
        return jnp.sum(a * b)

    b = -bblk
    b2 = dot(b, b)
    tol2 = (cfg.ba_cg_tol ** 2) * b2
    x = jnp.zeros((K, 6), dtype=jnp.float32)
    r0 = b
    z0 = precond(r0)
    state = (jnp.int32(0), x, r0, z0, z0, dot(r0, z0))

    def cond(s):
        it, _, r, *_ = s
        return jnp.logical_and(it < cfg.ba_cg_iters, dot(r, r) > tol2)

    def body(s):
        it, x, r, z, p, rz = s
        Ap = matvec(p)
        alpha = rz / jnp.maximum(dot(p, Ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = dot(r, z)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        return (it + 1, x, r, z, z + beta * p, rz_new)

    _, delta, *_ = jax.lax.while_loop(cond, body, state)
    return jnp.where(jnp.all(jnp.isfinite(delta)), delta, 0.0)


def apply_update(
    graph: PoseGraph, H: jnp.ndarray, b: jnp.ndarray, cfg: KeyframeConfig
) -> PoseGraph:
    """Solve the damped, anchored system and retract onto the poses."""
    K = graph.poses.shape[0]
    anchor = jnp.zeros((K * 6,), dtype=jnp.float32).at[:6].set(1e6)
    A = H + jnp.diag(anchor) + cfg.ba_damping * jnp.eye(
        K * 6, dtype=jnp.float32
    )
    L, low = jax.scipy.linalg.cho_factor(A, lower=True)
    delta = jax.scipy.linalg.cho_solve((L, low), -b).reshape(K, 6)
    delta = jnp.where(jnp.all(jnp.isfinite(delta)), delta, 0.0)
    poses = jax.vmap(lambda T, xi: se3.compose(T, se3.exp(xi)))(graph.poses, delta)
    return graph._replace(poses=poses)


def gnc_delta(cfg: KeyframeConfig, i):
    """Graduated-non-convexity annealing of the robust kernel width for
    IRLS iteration ``i`` (traced): start at ``ba_gnc_init_scale x delta``
    (wide kernel — an honest loop closure carrying LARGE accumulated
    drift keeps most of its pull instead of being shed like an outlier)
    and anneal geometrically to ``delta`` by the final iteration, where
    persistent outliers redescend to ~zero weight.  Returns None when the
    robust kernel is off."""
    if cfg.ba_robust_delta <= 0:
        return None
    if cfg.ba_gnc_init_scale <= 1.0:
        return cfg.ba_robust_delta
    frac = i / max(cfg.ba_iters - 1, 1)
    return cfg.ba_robust_delta * jnp.power(
        jnp.float32(cfg.ba_gnc_init_scale), 1.0 - frac
    )


@partial(jax.jit, static_argnames=("cfg",))
def optimize(graph: PoseGraph, cfg: KeyframeConfig):
    """Gauss-Newton pose graph optimization, entirely on-device.

    Returns (optimized graph, BAInfo).
    """
    chi2_0 = _chi2(graph)
    K = graph.poses.shape[0]
    if cfg.ba_solver not in ("dense", "cg", "auto"):
        raise ValueError(f"unknown ba_solver {cfg.ba_solver!r}")
    use_cg = cfg.ba_solver == "cg" or (
        cfg.ba_solver == "auto" and K > cfg.ba_dense_max_k
    )

    if use_cg:
        def body(i, g):
            delta = solve_delta_cg(g, gnc_delta(cfg, i), cfg)
            poses = jax.vmap(lambda T, xi: se3.compose(T, se3.exp(xi)))(
                g.poses, delta
            )
            return g._replace(poses=poses)
    else:
        def body(i, g):
            H, b, _ = build_normal_equations(
                g, gnc_delta(cfg, i), cfg.ba_robust_kernel
            )
            return apply_update(g, H, b, cfg)

    graph = jax.lax.fori_loop(0, cfg.ba_iters, body, graph)
    return graph, BAInfo(
        chi2_initial=chi2_0,
        chi2_final=_chi2(graph),
        iters=jnp.int32(cfg.ba_iters),
    )
