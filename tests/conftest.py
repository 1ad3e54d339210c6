"""Test environment: force an 8-device virtual CPU mesh.

Tests run on the CPU; multi-device sharding is validated on virtual CPU
devices exactly as the driver's dryrun does.  Checks that need a GPU are
marked ``gpu`` and skip here (see the ``gpu_device`` fixture); the same
checks run on the card as phases of ``chip_smoke.py``.  Must run before
jax is imported anywhere.
"""

import os
import sys

# XLA_FLAGS is read at (lazy) backend init, so setting it here works.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_cpu_parallel_codegen_split_count" not in flags:
    # XLA:CPU's parallel codegen has segfaulted sporadically deep into
    # long full-suite processes on this 2-vCPU host (always inside
    # backend_compile of a shard_map program, never reproducible
    # standalone).  Serial codegen removes the raced path; compile time
    # impact on the tiny test programs is negligible.
    flags = (flags + " --xla_cpu_parallel_codegen_split_count=1").strip()
os.environ["XLA_FLAGS"] = flags

# No persistent compile cache under tests: concurrent processes sharing
# the cache dir have been observed to SIGSEGV/SIGABRT inside jax's cache
# deserialization on the virtual multi-device platform.  CPU test
# compiles are cheap; the package itself skips the cache on a CPU-only
# platform, and an inherited directory is dropped before jax reads it.
os.environ.pop("JAX_COMPILATION_CACHE_DIR", None)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips on the CPU backend"
    )


@pytest.fixture
def gpu_device():
    """The first GPU device, or a skip.  Decided here, at run time, never
    while a module is imported (workers must collect the same tests)."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("no GPU on this backend (runs as a chip_smoke.py phase)")
    return gpus[0]


@pytest.fixture(scope="session")
def tiny_cfg():
    from voxelhashing_demo_tpu.config import tiny_config

    return tiny_config()


@pytest.fixture(autouse=True, scope="module")
def _bound_live_executables():
    """Release compiled executables between test modules.

    The jit factories are config-memoized (lru_cache) so same-config
    instances share compiles — but across the whole suite that
    accumulates every module's executables in one process, and XLA:CPU
    has segfaulted sporadically inside late compiles once hundreds of
    executables were live (always in the sharded tests ~75% through the
    suite, never standalone).  Clearing the factory caches and jax's
    executable caches at module boundaries bounds the live set while
    keeping within-module sharing."""
    yield
    import voxelhashing_demo_tpu

    voxelhashing_demo_tpu.release_compiled()
