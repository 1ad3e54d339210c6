"""Dense-grid SLAM pipeline: frame-to-model tracking + TSDF fusion + raycast.

This is the completed version of the reference's *intended* steady-state
pipeline (reference: SURVEY.md section 3.5; Application.cpp:75's commented
``Align``, notes.md's renderer design): every frame runs

    preprocess -> ICP against the raycast model -> integrate -> raycast

entirely inside a single jitted step function — zero host round-trips per
frame, versus the reference's dozens of ``cudaDeviceSynchronize`` + D2H
copies per frame (CameraTracking.cpp:53-66, Solver.cpp:82-89).

Frame-to-model tracking (raycast model maps as the ICP target) is what the
reference architecture aimed for but never wired up; it drifts far less
than frame-to-frame.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import PipelineConfig
from ..geometry import se3
from ..ops import icp as icp_ops
from ..ops import preprocess as pre_ops
from ..ops import raycast as rc_ops
from ..ops import tsdf as tsdf_ops


class DenseSLAMState(NamedTuple):
    tsdf: tsdf_ops.DenseTSDF
    pose: jnp.ndarray          # (4, 4) camera-to-world of last frame
    model: pre_ops.Frame       # raycast model maps in last camera frame
    frame_idx: jnp.ndarray     # () int32


class StepInfo(NamedTuple):
    pose: jnp.ndarray
    icp_error: jnp.ndarray
    icp_count: jnp.ndarray
    icp_iters: jnp.ndarray
    tracked: jnp.ndarray       # bool: ICP ran (model was available)


def create(config: PipelineConfig) -> DenseSLAMState:
    cam = config.camera
    H, W = cam.height, cam.width
    empty = pre_ops.Frame(
        vertices=jnp.zeros((H, W, 3), dtype=jnp.float32),
        normals=jnp.zeros((H, W, 3), dtype=jnp.float32),
        depth=jnp.zeros((H, W), dtype=jnp.float32),
    )
    return DenseSLAMState(
        tsdf=tsdf_ops.create_dense(config.grid, config.fusion),
        pose=se3.identity(),
        model=empty,
        frame_idx=jnp.int32(0),
    )


@partial(jax.jit, static_argnames=("config",))
def step(
    state: DenseSLAMState,
    depth_raw: jnp.ndarray,
    config: PipelineConfig,
):
    """One SLAM frame.  depth_raw: (H, W) uint16 in camera units."""
    cam = config.camera
    frame = pre_ops.preprocess(depth_raw, cam, config.frontend)

    # --- track (frame-to-model) -------------------------------------------
    model_valid = jnp.sum(state.model.depth > 0) > 100
    result = icp_ops.icp_align(frame, state.model, cam, config.icp)
    # ICP maps new-frame camera coords into last-frame camera coords, so
    # pose_new = pose_prev @ T_icp.  Fall back to constant-position when the
    # model is empty (first frame) or tracking failed.
    ok = (
        model_valid
        & (result.count > 100)
        & jnp.all(jnp.isfinite(result.transform))
        & icp_ops.motion_plausible(result.transform, config.icp)
    )
    T_rel = jnp.where(ok, result.transform, se3.identity())
    pose_new = se3.compose(state.pose, T_rel)

    # --- fuse -------------------------------------------------------------
    tsdf_new = tsdf_ops.integrate_dense(
        state.tsdf, frame.depth, pose_new, cam, config.fusion
    )

    # --- raycast model for the next frame ---------------------------------
    rc = rc_ops.raycast_dense(
        tsdf_new, pose_new, cam, config.raycast, config.fusion
    )
    model = rc_ops.model_frame(rc)

    new_state = DenseSLAMState(
        tsdf=tsdf_new,
        pose=pose_new,
        model=model,
        frame_idx=state.frame_idx + 1,
    )
    info = StepInfo(
        pose=pose_new,
        icp_error=result.error,
        icp_count=result.count,
        icp_iters=result.iters,
        tracked=ok,
    )
    return new_state, info


class DenseSLAM:
    """Host-side convenience wrapper accumulating the trajectory."""

    def __init__(self, config: PipelineConfig):
        self.config = config
        self.state = create(config)
        self.trajectory = []
        self.infos = []

    def process(self, depth_raw) -> StepInfo:
        self.state, info = step(self.state, jnp.asarray(depth_raw), self.config)
        self.trajectory.append(info.pose)
        self.infos.append(info)
        return info

    def render(self) -> rc_ops.RaycastOutput:
        return rc_ops.raycast_dense(
            self.state.tsdf,
            self.state.pose,
            self.config.camera,
            self.config.raycast,
            self.config.fusion,
        )
