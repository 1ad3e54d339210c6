"""bench.py smoke test: every bench section must run end-to-end on a tiny
CPU config.

Round 3's driver bench run crashed (rc=1) because bench.py's backend
warmup had drifted from a changed ``make_reintegrate`` return type and
NOTHING in tests/ exercised bench.py.  This test
runs ``_steady_state_fps``, ``_long_run``, ``_backend_run`` (which now
goes through the public ``KeyframeSLAM.warm_compile``) and
``_stage_breakdown`` on a tiny config for a handful of frames, so any API
drift between bench.py and the library fails the suite instead of the
driver's end-of-round artifact.
"""

import dataclasses

import bench
from voxelhashing_demo_tpu.config import (
    CameraConfig,
    FusionConfig,
    GCConfig,
    HashConfig,
    ICPConfig,
    KeyframeConfig,
    PipelineConfig,
    RaycastConfig,
)
from voxelhashing_demo_tpu.models import hash_slam
from voxelhashing_demo_tpu.utils import metrics, synthetic

CFG = PipelineConfig(
    camera=CameraConfig(width=80, height=60, fx=64.6625, fy=64.5625,
                        cx=39.7, cy=29.8),
    icp=ICPConfig(pyramid=(2, 1), pyramid_iters=(6, 3)),
    fusion=FusionConfig(voxel_size=0.04, truncation=0.16),
    hash=HashConfig(num_buckets=2048, bucket_size=4, num_blocks=2048,
                    max_active=1024, max_new_per_frame=1024),
    raycast=RaycastConfig(max_steps=48, cache_dims=(96, 96, 96)),
    gc=GCConfig(enabled=True, interval=8),
    keyframes=KeyframeConfig(sync_every=4, icp_downsample=2,
                             min_loop_inliers=100),
)


def test_steady_state_and_long_run():
    fps = bench._steady_state_fps(CFG, hash_slam, synthetic)
    assert fps > 0
    out = bench._long_run(CFG, hash_slam, synthetic, metrics,
                          num_frames=9, chunk=4)
    assert out["fps"] > 0 and out["frames"] == 9
    assert out["tracked"] >= 1


def test_backend_run_and_stages():
    # the gating thresholds bench._backend_run overrides are flagship-
    # tuned; at tiny scale just confirm the whole section (including
    # warm_compile: fuse/reintegrate/render/BA/batched-ICP jits) runs
    out = bench._backend_run(CFG, hash_slam, synthetic, metrics,
                             num_frames=10, warm_frames=4)
    assert out["fps"] > 0 and out["keyframes"] >= 1
    # kf_overrides drives the per-closure-BA incremental section
    out2 = bench._backend_run(
        CFG, hash_slam, synthetic, metrics, num_frames=8, warm_frames=0,
        frontend_baseline=False,
        kf_overrides=dict(ba_defer_edges=1, ba_defer_frames=0),
    )
    assert out2["fps"] > 0
    micro = bench._incremental_micro(CFG, hash_slam, synthetic, metrics,
                                     num_frames=10)
    assert micro["incremental_s"] > 0 and micro["full_rebuild_s"] > 0
    st = bench._streaming_run(CFG, hash_slam, synthetic, metrics,
                              num_frames=8)
    assert st["fps"] > 0 and st["frames"] == 9
    sb = bench._streaming_backend_run(CFG, hash_slam, synthetic, metrics,
                                      num_frames=8)
    assert sb["fps"] > 0 and sb["frames"] == 9
    stages = bench._stage_breakdown(CFG, hash_slam, synthetic,
                                    frames=6, reps=2)
    assert set(stages) == {"preprocess_ms", "icp_ms", "fuse_ms",
                           "raycast_ms"}
    assert all(v >= 0 for v in stages.values())
