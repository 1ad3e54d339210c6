"""Sensor-noise realism: the Kinect-class noise model and the robust
frontend that survives it.

The reference's entire workload is real Kinect/TUM depth (reference:
common.h:7-18, CameraTrackingUtils.cu:64) but it ships no data and no
noise handling.  These tests run the analytic scenes through the sensor
model (utils/synthetic.add_sensor_noise) and check that (a) the model
statistics are Kinect-like, (b) flying-pixel rejection cleans what it
should and nothing else, (c) the flagship robust frontend tracks a noisy
room-scale sweep within an ATE bound while keeping block allocation at
clean-data levels."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from voxelhashing_demo_tpu.config import (
    CameraConfig,
    FrontendConfig,
    FusionConfig,
    GCConfig,
    HashConfig,
    ICPConfig,
    PipelineConfig,
    RaycastConfig,
)
from voxelhashing_demo_tpu.models import hash_slam
from voxelhashing_demo_tpu.ops import preprocess as pre_ops
from voxelhashing_demo_tpu.utils import metrics, synthetic

CAM = CameraConfig(width=160, height=120, fx=129.3, fy=129.1,
                   cx=79.65, cy=59.8)


def test_sensor_noise_statistics():
    """Axial sigma grows with depth, dropout is a few percent, invalid
    pixels stay invalid, and the model is deterministic in its key."""
    d = synthetic.render_depth(jnp.eye(4), CAM)
    key = jax.random.PRNGKey(7)
    n1 = np.asarray(synthetic.add_sensor_noise(d, key))
    n2 = np.asarray(synthetic.add_sensor_noise(d, key))
    np.testing.assert_array_equal(n1, n2)

    clean = np.asarray(d)
    was_valid = clean > 0
    assert not np.any((~was_valid) & (n1 > 0)), "noise must not create depth"

    # dropout: some but bounded (edge dropout + 1% random)
    drop = np.mean((n1 == 0) & was_valid)
    assert 0.005 < drop < 0.25, f"dropout fraction {drop}"

    # axial noise scales with z: compare residual std near vs far,
    # excluding dropouts/outliers
    err = n1 - clean
    ok = (n1 > 0) & was_valid & (np.abs(err) < 0.05)
    near = ok & (clean < 1.8)
    far = ok & (clean > 2.2)
    assert err[near].std() < err[far].std()
    assert err[far].std() < 0.02  # Kinect-like mm-scale, not cm-scale

    # a few outliers exist
    outliers = np.mean(np.abs(err[(n1 > 0) & was_valid]) > 0.1)
    assert 0.0003 < outliers < 0.01, f"outlier fraction {outliers}"


def test_reject_outliers_kills_flying_pixels_only():
    d = np.asarray(synthetic.render_depth(jnp.eye(4), CAM)).copy()
    # plant isolated flying pixels mid-air
    rng = np.random.default_rng(0)
    ys = rng.integers(5, CAM.height - 5, 40)
    xs = rng.integers(5, CAM.width - 5, 40)
    planted = d.copy()
    planted[ys, xs] = 0.7  # far in front of every surface (z >= ~1.2)
    out = np.asarray(pre_ops.reject_outliers(jnp.asarray(planted)))
    assert np.all(out[ys, xs] == 0.0), "flying pixels must be rejected"
    # interior smooth-surface pixels survive (sphere center region)
    kept = (out > 0) & (planted == d)
    orig = (planted > 0) & (planted == d)
    assert kept.sum() > 0.97 * orig.sum(), "rejection too aggressive"


def _sweep_cfg(robust: bool) -> PipelineConfig:
    frontend = (FrontendConfig(bilateral=True, outlier_reject=True)
                if robust else FrontendConfig())
    icp = ICPConfig(pyramid=(4, 2, 1), pyramid_iters=(8, 4, 2),
                    huber_delta=0.01 if robust else 0.0)
    return PipelineConfig(
        camera=CAM,
        frontend=frontend,
        icp=icp,
        fusion=FusionConfig(voxel_size=0.04, truncation=0.16),
        hash=HashConfig(num_buckets=4096, bucket_size=4, num_blocks=4096,
                        max_active=2048, max_new_per_frame=2048),
        raycast=RaycastConfig(max_steps=96, cache_dims=(160, 160, 160)),
        gc=GCConfig(enabled=True, interval=8),
    )


def test_noisy_room_sweep_robust_frontend():
    """Flagship robust frontend on the Kinect-noise room sweep (the
    growing-map workload): tracks within an ATE bound AND keeps block
    allocation at clean-data levels (without flying-pixel rejection the
    outliers allocate garbage blocks all over the view frustum)."""
    n = 20
    depths, gt = synthetic.make_room_sweep(CAM, n, sweep_deg=70.0,
                                           noise_seed=3)
    clean_depths, _ = synthetic.make_room_sweep(CAM, n, sweep_deg=70.0)

    def run(cfg, frames):
        slam = hash_slam.HashSLAM(cfg)
        for d in frames:
            slam.process(d)
        used = cfg.hash.num_blocks - int(slam.state.hmap.free_top)
        ate = metrics.ate_rmse(slam.trajectory, gt, align=False)
        return ate, used

    ate_clean, used_clean = run(_sweep_cfg(False), clean_depths)
    ate_robust, used_robust = run(_sweep_cfg(True), depths)
    ate_plain, used_plain = run(_sweep_cfg(False), depths)

    # measured at this scale (quarter-res, 4 cm voxels): clean 42 mm,
    # robust 50 mm, plain 118 mm / 2.6x blocks.
    assert ate_clean < 0.06, f"clean sweep ATE {ate_clean}"
    assert ate_robust < 1.5 * ate_clean, (ate_robust, ate_clean)
    assert ate_plain > 1.8 * ate_robust, (ate_plain, ate_robust)
    # the robust frontend keeps the map at clean-data block budgets;
    # without it, flying pixels allocate far more
    assert used_robust < 1.4 * used_clean, (used_robust, used_clean)
    assert used_plain > 1.6 * used_robust, (used_plain, used_robust)
