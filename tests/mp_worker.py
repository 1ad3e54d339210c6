"""Worker for the REAL 2-process ``jax.distributed`` test.

Launched twice by tests/test_multiprocess.py (process_id 0 and 1), each
with 4 virtual CPU devices, forming one 8-device GLOBAL mesh across two
OS processes with Gloo cross-process collectives — the closest this
environment gets to BASELINE configs 4-5's two-host slice (SURVEY.md
§2b: the reference is single-GPU; the multi-host dimension is the north
star).  Everything the single-process suite can only approximate runs
for real here: non-fully-addressable arrays, collective fetches,
per-process BlockStore shards, owner-routed cross-process restores, and
collective checkpoint save/load.

Writes a JSON result file; the parent asserts on it (and on cross-worker
agreement).  Run standalone for debugging:

    python tests/mp_worker.py 0 29781 /tmp/mp &
    python tests/mp_worker.py 1 29781 /tmp/mp
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _setup_env() -> None:
    # Rebuild XLA_FLAGS: drop any inherited device-count flag (pytest's
    # conftest sets 8; each worker must have exactly 4 so the two
    # processes form the 8-device global mesh).
    kept = [
        t for t in os.environ.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in t
        and "xla_cpu_parallel_codegen_split_count" not in t
    ]
    kept += [
        "--xla_force_host_platform_device_count=4",
        "--xla_cpu_parallel_codegen_split_count=1",
    ]
    os.environ["XLA_FLAGS"] = " ".join(kept)
    # two jax processes must never share the persistent compile cache
    # (the package itself skips it on a CPU-only platform)
    os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))


def main() -> None:
    pid, port, outdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    mode = sys.argv[4] if len(sys.argv) > 4 else "stream"
    _setup_env()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)

    from voxelhashing_demo_tpu.parallel import distributed

    # the library wrapper itself (its guard must not touch the backend)
    distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=2,
        process_id=pid,
    )

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from voxelhashing_demo_tpu.parallel import sharded
    from voxelhashing_demo_tpu.utils import checkpoint, metrics
    import test_streaming as ts  # scenario shared with the 1-proc twin

    res = {
        "pid": pid,
        "process_count": jax.process_count(),
        "local_devices": jax.local_device_count(),
        "global_devices": jax.device_count(),
    }
    assert distributed.is_multiprocess()
    assert res["process_count"] == 2 and res["global_devices"] == 8

    mesh = sharded.make_mesh()  # global: both processes' devices

    if mode == "kf":
        _run_keyframe(pid, outdir, res, mesh)
        return

    # ---- A. host<->device primitives on genuinely non-addressable arrays
    x = np.arange(48, dtype=np.float32).reshape(16, 3)
    half = x[pid * 8:(pid + 1) * 8]
    dev = distributed.shard_rows_to_global(half, mesh, P("d"))
    res["not_addressable"] = not dev.is_fully_addressable
    res["fetch_ok"] = bool(np.array_equal(distributed.fetch(dev), x))
    res["local_rows_ok"] = bool(
        np.array_equal(distributed.local_rows(dev), half))
    res["gather_concat_ok"] = bool(np.array_equal(
        distributed.gather_concat(half + pid),
        np.concatenate([x[:8], x[8:] + 1]),
    ))

    # ---- B. beyond-capacity streaming SLAM over the 2-process mesh
    # (identical scenario to the single-process twin,
    # tests/test_streaming.py::test_streaming_sharded_matches)
    depths, gt = ts._out_and_back()
    cfg = ts._stream_cfg(True)
    slam = sharded.ShardedHashSLAM(cfg, mesh)
    ate, dev_keys = ts._run(slam, depths, gt)
    res["ate"] = float(ate)
    res["total_evicted"] = int(slam.store.total_evicted)
    res["total_restored"] = int(slam.store.total_restored)
    res["store_keys"] = sorted(int(k) for k in slam.store._index)
    res["dev_keys"] = sorted(dev_keys)
    res["trajectory"] = np.stack(
        [np.asarray(p) for p in slam.trajectory]).tolist()

    # every store row must be owned by one of THIS process's devices
    from voxelhashing_demo_tpu.utils.blockstore import unpack_keys_np

    skeys = np.asarray(res["store_keys"], np.int32)
    if skeys.size:
        owner = sharded._owner_np(
            unpack_keys_np(skeys, cfg.hash.key_bits),
            cfg.hash.num_buckets, mesh.devices.size)
        res["store_local_only"] = bool(
            distributed.owner_process_mask(mesh, owner).all())
    else:
        res["store_local_only"] = True

    # ---- C. collective checkpoint: save gathers the store union;
    # load filters it back to this process's shard; resume matches the
    # uninterrupted run
    ckpt = os.path.join(outdir, f"ckpt_{pid}.npz")
    checkpoint.save_slam(ckpt, slam)
    loaded = checkpoint.load_sharded_slam(ckpt, mesh)
    res["loaded_store_keys"] = sorted(int(k) for k in loaded.store._index)

    # per-process shard checkpoint: no gather on save, same state back
    pp_base = os.path.join(outdir, "pp.npz")
    checkpoint.save_slam(pp_base, slam, per_process=True)
    lpp = checkpoint.load_sharded_slam(pp_base, mesh)
    res["pp_state_equal"] = bool(
        np.array_equal(distributed.fetch(lpp.state.hmap.keys),
                       distributed.fetch(loaded.state.hmap.keys))
        and np.array_equal(distributed.fetch(lpp.state.hmap.tsdf),
                           distributed.fetch(loaded.state.hmap.tsdf))
        and np.array_equal(np.asarray(lpp.state.pose),
                           np.asarray(loaded.state.pose))
    )
    res["pp_store_equal"] = (
        sorted(int(k) for k in lpp.store._index)
        == res["loaded_store_keys"]
    )

    tail = depths[-4:]
    for d in tail:
        slam.process(d)
    for d in tail:
        loaded.process(d)
    slam.stream_sync()
    loaded.stream_sync()
    pa = np.asarray(slam.state.pose)
    pb = np.asarray(loaded.state.pose)
    res["resume_exact"] = bool(np.array_equal(pa, pb))
    res["resume_close"] = bool(np.allclose(pa, pb, atol=1e-5))
    res["resumed_pose"] = pb.tolist()

    with open(os.path.join(outdir, f"result_{pid}.json"), "w") as f:
        json.dump(res, f)
    print(f"[worker {pid}] OK ate={ate:.4f} "
          f"evicted={res['total_evicted']} restored={res['total_restored']}",
          flush=True)


def _run_keyframe(pid: int, outdir: str, res: dict, mesh) -> None:
    """The FULL flagship stack (keyframe backend + loop closure + BA +
    map rebuild over the streaming sharded frontend — the BASELINE
    config-5 composition) across two real processes.  Scenario shared
    with the single-process twin,
    tests/test_streaming.py::test_streaming_composes_with_keyframe_backend,
    which documents why each assert holds."""
    import dataclasses

    import numpy as np

    from voxelhashing_demo_tpu.models import keyframe_slam
    from voxelhashing_demo_tpu.utils import checkpoint, metrics
    import test_streaming as ts

    depths, gt = ts._out_and_back()
    base = ts._stream_cfg(True)
    cfg = dataclasses.replace(
        base,
        keyframes=dataclasses.replace(
            base.keyframes, min_rotation_deg=8.0, min_translation=0.10,
            max_keyframes=4, max_edges=8,
        ),
    )
    slam = keyframe_slam.KeyframeSLAM(cfg, mesh=mesh)
    for d in depths:
        slam.process(d)
    slam.settle()
    res["ate"] = float(metrics.ate_rmse(slam.trajectory(), gt,
                                        align=False))
    res["trajectory"] = np.stack(
        [np.asarray(p) for p in slam.trajectory()]).tolist()
    res["n_keyframes"] = len(slam.keyframes)
    res["n_edges"] = int(slam._n_edges)
    res["ba_runs"] = len(slam.ba_events)
    res["capacity_kinds"] = sorted(
        {e["kind"] for e in slam.capacity_events})
    store = slam._driver.store
    res["total_evicted"] = int(store.total_evicted)
    res["total_restored"] = int(store.total_restored)
    res["store_keys"] = sorted(int(k) for k in store._index)

    # collective keyframe checkpoint + resume across both processes
    ckpt = os.path.join(outdir, f"kf_ckpt_{pid}.npz")
    checkpoint.save_keyframe_slam(ckpt, slam)
    loaded = checkpoint.load_keyframe_slam(ckpt, mesh)
    for d in depths[-4:]:
        loaded.process(d)
    loaded.settle()
    res["resumed_pose"] = np.asarray(
        loaded._driver.state.pose).tolist()
    res["resumed_keyframes"] = len(loaded.keyframes)

    with open(os.path.join(outdir, f"result_{pid}.json"), "w") as f:
        json.dump(res, f)
    print(f"[worker {pid}] KF OK ate={res['ate']:.4f} "
          f"kf={res['n_keyframes']} edges={res['n_edges']} "
          f"ba={res['ba_runs']}", flush=True)


if __name__ == "__main__":
    main()
