"""Where the persistent compile cache goes (voxelhashing_demo_tpu/__init__).

``JAX_COMPILATION_CACHE_DIR`` wins when set; otherwise the cache sits at
the fixed ``<repo>/.jax_cache``; a CPU-only process gets none.  Each case
imports the package in a fresh interpreter, since the choice is made once
at import.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = ("import jax, voxelhashing_demo_tpu; "
          "print(jax.config.jax_compilation_cache_dir)")


def _cache_dir_in_fresh_process(env_updates):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "JAX_PLATFORMS")}
    env.update(env_updates)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("case", ["env_dir", "fixed_repo_dir", "cpu_only"])
def test_compile_cache_dir(case, tmp_path):
    if case == "env_dir":
        got = _cache_dir_in_fresh_process(
            {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
        assert got == str(tmp_path)
    elif case == "fixed_repo_dir":
        got = _cache_dir_in_fresh_process({})
        assert got == os.path.join(REPO, ".jax_cache")
    else:
        got = _cache_dir_in_fresh_process({"JAX_PLATFORMS": "cpu"})
        assert got == "None"
