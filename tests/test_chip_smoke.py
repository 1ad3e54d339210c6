"""chip_smoke.py: refuses the CPU, and its plain references hold on CPU.

The script itself only runs on a GPU.  Here it must exit non-zero and
print no result line, both from the repo and from a directory that holds
nothing but the script.  Its op-level references (float64 normal
equations, numpy integrate, np.minimum.at z-buffer, the dict allocator,
the float64 frustum) are checked against the package on the CPU at a
reduced size; the same phase at full width runs on the card.
"""

import dataclasses
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _quarter_flagship():
    from __graft_entry__ import flagship_config

    c = flagship_config()
    return dataclasses.replace(
        c, camera=c.camera.scaled(4),
        hash=dataclasses.replace(c.hash, num_buckets=8192, num_blocks=8192,
                                 max_active=2048, max_new_per_frame=2048),
    )


def test_require_gpu_exits_on_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu(1)
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("where", ["repo", "script_alone"])
def test_script_fails_without_gpu(where, tmp_path):
    if where == "repo":
        cwd, script = REPO, os.path.join(REPO, "chip_smoke.py")
    else:
        script = shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_op_references_agree_on_cpu(capsys):
    """phase_ops raises on any disagreement beyond its tolerance."""
    chip_smoke.phase_ops(_quarter_flagship())
    out = capsys.readouterr().out
    assert out.count(" ok") >= 9 and "FAIL" not in out


def test_ref_insert_drops_on_full_bucket():
    """The dict allocator drops a key whose bucket is full, as the
    device allocator does."""
    import numpy as np

    from voxelhashing_demo_tpu.config import HashConfig
    from voxelhashing_demo_tpu.geometry.coords import EMPTY_KEY

    cfg = HashConfig(num_buckets=1, bucket_size=2, num_blocks=8,
                     max_new_per_frame=8)
    keys = np.full(2, EMPTY_KEY, np.int32)
    table, n = chip_smoke.ref_insert(
        keys, np.full(2, -1, np.int32), np.zeros(1, np.int32),
        np.arange(8, dtype=np.int32), 8, np.array([5, 3, 9, 3], np.int32),
        cfg)
    assert n == 2 and table == {3: 7, 5: 6}


@pytest.mark.gpu
def test_op_references_on_card(gpu_device):
    """Full-width phase on the card (also phase 2 of chip_smoke.py)."""
    from __graft_entry__ import flagship_config

    chip_smoke.phase_ops(flagship_config())
