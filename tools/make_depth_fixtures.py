"""Generate the committed PNG16 depth fixtures (tests/fixtures/kinect_png16).

The reference's one shipped path consumes real 16-bit Kinect depth PNGs
(reference: Application.cpp:28-29, ``stbi_load_16("assets/T0.png")``) —
but its assets directory is absent from the repo, and this build
environment has no network access to fetch TUM sequences.  These fixtures
are the honest next-best thing: depth rendered from the analytic room
scene and passed through the FULL physical Kinect v1 sensor model —
z-dependent axial noise, structured-light edge shadowing, dropouts,
flying pixels, AND 1/8-px disparity quantization (the ~1 cm banding at
2 m real fr1 frames show) — then encoded to genuine 16-bit PNG files at
5000 units/m through the same native codec `cli run --dataset` uses.
tests/test_depth_fixtures.py decodes them back through the codec and
runs the full frontend + tracking over them.

Rerun this script only to regenerate the fixtures (deterministic; the
files are committed so the test never depends on generation).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from voxelhashing_demo_tpu.config import CameraConfig
from voxelhashing_demo_tpu.utils import io as io_utils
from voxelhashing_demo_tpu.utils import synthetic

FIXTURES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests", "fixtures",
)
OUT = os.path.join(FIXTURES, "kinect_png16")
N_FRAMES = 8
# ~1.7 deg/frame = ~50 deg/s at the sensor's 30 Hz — the fast end of a
# realistic handheld pan (TUM fr1 averages ~1-2 deg/frame)
SWEEP_DEG = 14.0

# second committed sequence: a CLOSED 360-degree
# loop at quarter resolution, so the keyframe backend's gates
# (observability, robust kernels, BA, map rebuild) are exercised on the
# disk-file path too.  Quarter res keeps the committed size ~1 MB while
# the sensor model (noise, shadowing, dropouts, disparity quantization)
# stays identical; the full-res codec axis is covered by kinect_png16.
OUT_LOOP = os.path.join(FIXTURES, "kinect_png16_loop")
LOOP_FRAMES = 72     # 5 deg/frame — fast but tracked (motion prior)
LOOP_SWEEP = 360.0


def _write(out, cam, n_frames, sweep_deg, seed) -> None:
    from voxelhashing_demo_tpu.utils import tum

    os.makedirs(out, exist_ok=True)
    key = jax.random.PRNGKey(seed)
    poses, raws = [], []
    for i in range(n_frames):
        T = synthetic.room_sweep_pose(i / n_frames, sweep_deg)
        clean = synthetic.render_depth(jnp.asarray(T), cam,
                                       sdf=synthetic.room_sdf)
        key, sub = jax.random.split(key)
        noisy = synthetic.add_sensor_noise(clean, sub,
                                           disparity_quant=True)
        raws.append(np.asarray(synthetic.depth_to_raw(noisy, cam)))
        poses.append(np.asarray(T))
    # standard TUM layout (depth/ + depth.txt + groundtruth.txt) through
    # the native codec, so the fixtures exercise the same dataset path
    # `cli run --dataset` uses
    tum.export_sequence(out, raws, poses)
    print("wrote", n_frames, "frames to", out)


def main() -> None:
    _write(OUT, CameraConfig(), N_FRAMES, SWEEP_DEG, seed=7)
    _write(OUT_LOOP, CameraConfig().scaled(4), LOOP_FRAMES, LOOP_SWEEP,
           seed=11)


if __name__ == "__main__":
    main()
