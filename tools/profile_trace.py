"""True device-time attribution of the flagship step via jax.profiler.

Wall-clock timing includes per-dispatch host overhead; this captures an
XLA device trace of steady-state frames and aggregates per-op device time
(kernel events on the ``/device:`` planes) by op name, so optimization
targets what the device actually spends time on.
"""

import collections
import glob
import gzip
import os
import sys
import tempfile
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from __graft_entry__ import flagship_config
from voxelhashing_demo_tpu.models import hash_slam
from voxelhashing_demo_tpu.utils import synthetic


def main():
    config = flagship_config()
    cam = config.camera
    depths, _ = synthetic.make_sequence(cam, 8, trans_amp=0.06,
                                        rot_amp_deg=3.0)
    depths = [jnp.asarray(d) for d in depths]
    slam = hash_slam.HashSLAM(config)
    for i in range(4):
        slam.process(depths[i % 8])
    jax.block_until_ready(slam.state.pose)

    outdir = tempfile.mkdtemp(prefix="jaxtrace_")
    n_frames = 8
    jax.profiler.start_trace(outdir)
    for i in range(n_frames):
        slam.process(depths[(4 + i) % 8])
    jax.block_until_ready(slam.state.pose)
    jax.profiler.stop_trace()

    paths = glob.glob(os.path.join(outdir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        print("no xplane capture found under", outdir)
        return
    pd = jax.profiler.ProfileData.from_serialized_xspace(
        open(paths[0], "rb").read()
    )
    tot = collections.Counter()
    cnt = collections.Counter()
    device_total = 0.0
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                dur = ev.duration_ns
                name = ev.name
                tot[name] += dur
                cnt[name] += 1
                device_total += dur
    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind}")
    print(f"frames traced: {n_frames}; total device time/frame: "
          f"{device_total/n_frames/1e6:.2f} ms")
    print(f"{'op':60s} {'ms/frame':>9s} {'count/frame':>12s}")
    for name, ns in tot.most_common(45):
        print(f"{name[:60]:60s} {ns/n_frames/1e6:9.3f} {cnt[name]/n_frames:12.1f}")


if __name__ == "__main__":
    main()
