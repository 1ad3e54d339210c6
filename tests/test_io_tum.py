"""I/O tests: PNG16 codec (pure-Python and native C++ agree), TUM dataset
round trip through export -> association -> batch decode."""

import os

import numpy as np
import pytest

from voxelhashing_demo_tpu.utils import io as depth_io
from voxelhashing_demo_tpu.utils import tum


def random_depth(h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 20000, size=(h, w)).astype(np.uint16)
    img[10:20, 10:20] = 0  # holes
    return img


def test_python_codec_roundtrip(tmp_path):
    img = random_depth()
    p = str(tmp_path / "d.png")
    depth_io.write_depth_png(p, img, native=False)
    out = depth_io.read_depth_png(p, native=False)
    np.testing.assert_array_equal(out, img)


def test_native_codec_roundtrip(tmp_path):
    if depth_io._load_native() is None:
        pytest.skip("native codec unavailable")
    img = random_depth(seed=1)
    p = str(tmp_path / "d.png")
    depth_io.write_depth_png(p, img, native=True)
    out = depth_io.read_depth_png(p, native=True)
    np.testing.assert_array_equal(out, img)


def test_native_and_python_cross_decode(tmp_path):
    if depth_io._load_native() is None:
        pytest.skip("native codec unavailable")
    img = random_depth(seed=2)
    p1 = str(tmp_path / "py.png")
    p2 = str(tmp_path / "nat.png")
    depth_io.write_depth_png(p1, img, native=False)
    depth_io.write_depth_png(p2, img, native=True)
    np.testing.assert_array_equal(depth_io.read_depth_png(p1, native=True), img)
    np.testing.assert_array_equal(depth_io.read_depth_png(p2, native=False), img)


def test_batch_decode(tmp_path):
    imgs = [random_depth(seed=i) for i in range(8)]
    paths = []
    for i, img in enumerate(imgs):
        p = str(tmp_path / f"{i}.png")
        depth_io.write_depth_png(p, img)
        paths.append(p)
    batch = depth_io.read_depth_batch(paths, 64, 48)
    assert batch.shape == (8, 48, 64)
    for i, img in enumerate(imgs):
        np.testing.assert_array_equal(batch[i], img)


def test_quaternion_roundtrip():
    rng = np.random.default_rng(0)
    for _ in range(20):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        R = tum.quat_to_matrix(*q)
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)
        q2 = np.array(tum.matrix_to_quat(R))
        if np.dot(q2, q) < 0:
            q2 = -q2
        np.testing.assert_allclose(q2, q, atol=1e-9)


def test_tum_sequence_roundtrip(tmp_path):
    from voxelhashing_demo_tpu.geometry import se3
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    depths = [random_depth(seed=i) for i in range(5)]
    poses = [
        np.asarray(se3.exp(jnp.asarray(rng.normal(size=6) * 0.1,
                                       dtype=jnp.float32)))
        for _ in range(5)
    ]
    root = str(tmp_path / "seq")
    tum.export_sequence(root, depths, poses)

    seq = tum.TUMSequence(root)
    assert len(seq) == 5
    for (d, T), d_ref, T_ref in zip(seq, depths, poses):
        np.testing.assert_array_equal(d, d_ref)
        np.testing.assert_allclose(T, T_ref, atol=1e-5)

    batch, bposes = seq.load_all(64, 48)
    assert batch.shape == (5, 48, 64)
    np.testing.assert_array_equal(batch[3], depths[3])


def test_tum_association_tolerance(tmp_path):
    a = [(0.0, ["x"]), (1.0, ["y"]), (2.0, ["z"])]
    b = [(0.005, ["p0"]), (1.5, ["p1"]), (2.001, ["p2"])]
    pairs = tum.associate(a, b, max_dt=0.02)
    assert len(pairs) == 2  # 1.0 has no partner within 20 ms
    assert pairs[0][3] == ["p0"]
    assert pairs[1][3] == ["p2"]


# --- real-world robustness -----------------------------

def test_truncated_png_raises(tmp_path):
    """A truncated file must raise cleanly (both codecs), not scramble."""
    img = random_depth(seed=3)
    p = str(tmp_path / "d.png")
    depth_io.write_depth_png(p, img)
    data = open(p, "rb").read()
    for cut in (8, 40, len(data) // 2):
        q = str(tmp_path / f"cut_{cut}.png")
        with open(q, "wb") as f:
            f.write(data[:cut])
        for native in (False, None):
            with pytest.raises((ValueError, RuntimeError)):
                depth_io.read_depth_png(q, native=native)
    # a file missing only the IEND trailer still has complete image data:
    # decoding it succeeds (graceful) and must be bit-exact
    q = str(tmp_path / "no_iend.png")
    with open(q, "wb") as f:
        f.write(data[:-4])
    np.testing.assert_array_equal(depth_io.read_depth_png(q), img)


def test_garbage_file_raises(tmp_path):
    p = str(tmp_path / "junk.png")
    with open(p, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\nnot really a png at all" * 10)
    for native in (False, None):
        with pytest.raises((ValueError, RuntimeError)):
            depth_io.read_depth_png(p, native=native)


def test_unsorted_depth_list_is_sorted(tmp_path):
    """Real-world depth.txt files are not always time-ordered; the parser
    must sort so association and SLAM ingestion see monotone time."""
    p = str(tmp_path / "depth.txt")
    with open(p, "w") as f:
        f.write("# comment\n2.0 depth/c.png\n0.5 depth/a.png\n"
                "1.0 depth/b.png\n")
    entries = tum._parse_list(p)
    assert [t for t, _ in entries] == [0.5, 1.0, 2.0]
    assert [d[0] for _, d in entries] == [
        "depth/a.png", "depth/b.png", "depth/c.png"
    ]


def test_sequence_without_groundtruth(tmp_path):
    """Missing groundtruth.txt: the sequence loads with pose=None."""
    import os

    from voxelhashing_demo_tpu.config import tiny_config

    cam = tiny_config().camera
    depths = [random_depth(cam.height, cam.width, seed=s) for s in range(3)]
    poses = [np.eye(4, dtype=np.float32)] * 3
    root = str(tmp_path / "seq")
    tum.export_sequence(root, depths, poses)
    os.remove(os.path.join(root, "groundtruth.txt"))
    seq = tum.TUMSequence(root)
    assert not seq.has_gt
    loaded, gt = seq.load_all(cam.width, cam.height)
    assert len(loaded) == 3 and all(p is None for p in gt)
    np.testing.assert_array_equal(np.asarray(loaded[0]), depths[0])


def test_native_codec_builds_from_source(tmp_path, monkeypatch):
    """The library is not committed: make builds it from depthio.cpp,
    and the fresh build round-trips against the pure-Python codec."""
    import shutil

    src = tmp_path / "native"
    src.mkdir()
    for name in ("Makefile", "depthio.cpp"):
        shutil.copy(os.path.join(depth_io._NATIVE_DIR, name), src)
    monkeypatch.setattr(depth_io, "_NATIVE_DIR", str(src))
    monkeypatch.setattr(depth_io, "_LIB_PATH", str(src / "libdepthio.so"))
    monkeypatch.setattr(depth_io, "_lib", None)
    monkeypatch.setattr(depth_io, "_lib_tried", False)
    assert depth_io._load_native() is not None
    assert (src / "libdepthio.so").exists()
    img = random_depth(h=480, w=640, seed=5)
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    depth_io.write_depth_png(a, img, native=True)
    depth_io.write_depth_png(b, img, native=False)
    np.testing.assert_array_equal(depth_io.read_depth_png(a, native=False),
                                  img)
    np.testing.assert_array_equal(depth_io.read_depth_png(b, native=True),
                                  img)
