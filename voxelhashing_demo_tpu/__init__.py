"""Dense RGB-D SLAM engine (VoxelHashing on JAX/XLA).

A from-scratch re-design of the capabilities of nilspin/VoxelHashing_demo
as one JAX program: depth preprocessing, point-to-plane ICP tracking,
voxel-hashed TSDF fusion, splatted surface prediction and a keyframe
backend, with multi-device scaling via jax.sharding.  See SURVEY.md for
the reference analysis.
"""

import os as _os

import jax as _jax


def _enable_compile_cache() -> None:
    """Persistent XLA compile cache.  The flagship step takes minutes to
    compile cold; the cache lets later processes start in seconds.

    ``JAX_COMPILATION_CACHE_DIR`` (read by JAX itself) wins when set, and
    nothing is changed then.  Otherwise the cache sits at the fixed
    ``<repo>/.jax_cache``: the directory is part of the cache key, so a
    path that moved between hosts would never hit.  CPU-only processes
    (the tests) get no cache: XLA:CPU serializes executables for the
    compiling host's instruction set, and loading them on another host
    can abort the process."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    if (_jax.config.jax_platforms or "").strip().lower() == "cpu":
        return
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), ".jax_cache"),
    )
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    _jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


_enable_compile_cache()

from . import config
from .config import PipelineConfig, tiny_config


def release_compiled() -> None:
    """Drop every config-memoized jit factory cache and jax's live
    executable caches.

    The jit factories (``models.hash_slam.make_step`` & co.) are
    ``lru_cache``-memoized on the frozen config so same-config instances
    share compiles — which also makes every compiled executable immortal
    for the life of the process.  Long-lived processes that churn many
    configs (sweeps, notebooks) should call this at config boundaries:
    XLA:CPU has segfaulted sporadically once hundreds of live
    executables accumulated in one process (see tests/conftest.py, which
    calls this at module boundaries).  Safe to call at any quiescent
    point; the next use recompiles (or hits the persistent on-disk
    cache)."""
    from .models import hash_slam, keyframe_slam
    from .parallel import sharded

    for f in (
        sharded.make_sharded_spill_evict,
        sharded.make_sharded_render_model,
        hash_slam.make_step,
        hash_slam.make_scan_step,
        hash_slam.make_evict,
        hash_slam.make_restore,
        hash_slam.make_pull,
        hash_slam.make_spill_evict,
        hash_slam.make_spill_head,
        keyframe_slam.make_fuse_only,
        keyframe_slam._ba_pack,
        keyframe_slam.make_reintegrate,
        keyframe_slam.make_render_model,
        keyframe_slam._make_batch_icps,
        keyframe_slam._make_kf_pre,
        keyframe_slam._make_batch_procrustes,
    ):
        f.cache_clear()
    _jax.clear_caches()


__version__ = "0.1.0"
