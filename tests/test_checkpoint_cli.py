"""Checkpoint/resume roundtrip, trajectory export, viz, and CLI smoke tests."""

import json
import os

import jax.numpy as jnp
import numpy as np

from voxelhashing_demo_tpu.config import tiny_config
from voxelhashing_demo_tpu.models import hash_slam
from voxelhashing_demo_tpu.utils import checkpoint as ck
from voxelhashing_demo_tpu.utils import synthetic, viz


def _run_slam(n=4):
    cfg = tiny_config()
    depths, gt = synthetic.make_sequence(cfg.camera, n, trans_amp=0.05,
                                         rot_amp_deg=2.0)
    slam = hash_slam.HashSLAM(cfg)
    for d in depths:
        slam.process(d)
    return slam, depths, gt


def test_checkpoint_roundtrip(tmp_path):
    slam, depths, _ = _run_slam()
    path = str(tmp_path / "ck.npz")
    ck.save_slam(path, slam)
    loaded, graph = ck.load_slam(path)
    assert graph is None
    assert loaded.config == slam.config
    assert int(loaded.state.frame_idx) == int(slam.state.frame_idx)
    np.testing.assert_array_equal(
        np.asarray(loaded.state.hmap.keys), np.asarray(slam.state.hmap.keys)
    )
    np.testing.assert_allclose(
        np.asarray(loaded.state.pose), np.asarray(slam.state.pose)
    )
    assert len(loaded.trajectory) == len(slam.trajectory)

    # resumed processing must continue identically to uninterrupted run
    extra, _ = synthetic.make_sequence(slam.config.camera, 2,
                                       trans_amp=0.02, rot_amp_deg=1.0)
    a = slam.process(extra[-1])
    b = loaded.process(extra[-1])
    np.testing.assert_allclose(
        np.asarray(a.pose), np.asarray(b.pose), atol=1e-6
    )


def test_checkpoint_with_graph(tmp_path):
    from voxelhashing_demo_tpu.ops import pose_graph

    slam, _, _ = _run_slam(3)
    g = pose_graph.create(8, 8)
    g = pose_graph.add_pose(g, jnp.eye(4))
    path = str(tmp_path / "ck.npz")
    ck.save_slam(path, slam, graph=g)
    _, g2 = ck.load_slam(path)
    assert g2 is not None and int(g2.num_poses) == 1


def test_trajectory_tum_export_roundtrip(tmp_path):
    from voxelhashing_demo_tpu.geometry import se3
    from voxelhashing_demo_tpu.utils import tum

    poses = [np.asarray(se3.exp(jnp.asarray(x)), dtype=np.float32)
             for x in ([0.1, 0.2, -0.1, 0.2, -0.1, 0.3],
                       [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                       [-0.3, 0.1, 0.2, -0.2, 0.4, -0.1])]
    path = str(tmp_path / "traj.txt")
    ck.export_trajectory_tum(path, poses)
    lines = [l for l in open(path) if l.strip()]
    assert len(lines) == 3
    for line, T in zip(lines, poses):
        vals = [float(x) for x in line.split()]
        np.testing.assert_allclose(vals[1:4], T[:3, 3], atol=1e-5)
        R = tum.quat_to_matrix(*vals[4:8])
        np.testing.assert_allclose(R, T[:3, :3], atol=1e-5)


def test_sdf_dump(tmp_path):
    slam, _, _ = _run_slam(2)
    path = str(tmp_path / "SDF_dump.txt")
    n = ck.dump_sdf(path, slam.state.hmap, slam.config.hash)
    assert n > 0
    first = open(path).readline()
    assert str(n) in first


def test_viz_outputs(tmp_path):
    slam, _, _ = _run_slam(3)
    out = slam.render()
    rgb = viz.shade_rgb(out)
    assert rgb.shape == (slam.config.camera.height,
                         slam.config.camera.width, 3)
    assert rgb.dtype == np.uint8
    assert rgb.max() > 40  # something lit

    p = str(tmp_path / "r.png")
    viz.write_png_rgb(p, rgb)
    data = open(p, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"

    d = viz.depth_rgb(out.depth)
    nm = viz.normal_rgb(out.normals, out.hit)
    assert d.shape == rgb.shape and nm.shape == rgb.shape

    # frustum overlay draws some pixels
    cam = slam.config.camera
    T_view = viz.look_at([0.0, -0.3, -0.8], [0.0, 0.1, 1.5])
    before = rgb.copy()
    over = viz.draw_frustum(rgb, cam, T_view, cam, np.eye(4))
    assert (over != before).any()


def test_orbit_poses_look_at_center():
    poses = viz.orbit_poses([0, 0, 2.0], radius=1.0, height=0.0, n_frames=6)
    assert len(poses) == 6
    for T in poses:
        # camera z-axis points from eye toward the center
        fwd = T[:3, 2]
        to_c = np.array([0, 0, 2.0]) - T[:3, 3]
        to_c /= np.linalg.norm(to_c)
        np.testing.assert_allclose(fwd, to_c, atol=1e-5)
        # rigid
        np.testing.assert_allclose(T[:3, :3] @ T[:3, :3].T, np.eye(3),
                                   atol=1e-5)


def test_cli_demo_and_run(tmp_path, capsys):
    from voxelhashing_demo_tpu import cli

    out1 = str(tmp_path / "demo")
    cli.main(["--small", "demo", "--out", out1])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["icp_inliers"] > 500
    assert os.path.exists(os.path.join(out1, "render.png"))
    assert os.path.exists(os.path.join(out1, "SDF_dump.txt"))

    out2 = str(tmp_path / "run")
    cli.main(["--small", "run", "--synthetic", "5", "--out", out2,
              "--render-last"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["frames"] == 5
    assert res["tracked_frames"] >= 3
    assert res["ate_rmse_m"] < 0.05
    assert os.path.exists(os.path.join(out2, "trajectory.txt"))
    assert os.path.exists(os.path.join(out2, "map.npz"))
    assert os.path.exists(os.path.join(out2, "final.png"))

    # render from the checkpoint
    out3 = str(tmp_path / "render")
    cli.main(["render", "--checkpoint", os.path.join(out2, "map.npz"),
              "--out", out3, "--orbit", "2", "--sweep", "20"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(res["frames"]) == 2
    assert os.path.exists(os.path.join(out3, "orbit_000.png"))

    cli.main(["info", "--checkpoint", os.path.join(out2, "map.npz")])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["occupied_blocks"] > 0
    assert res["frames_processed"] == 5


def test_cli_resume_and_evaluate(tmp_path, capsys):
    """run --checkpoint-every / --resume continue a TUM-dataset run
    identically to the uninterrupted one; evaluate reports matching ATE
    via timestamp association."""
    from voxelhashing_demo_tpu import cli
    from voxelhashing_demo_tpu.config import CameraConfig
    from voxelhashing_demo_tpu.utils import tum

    cam = CameraConfig(width=160, height=120, fx=129.3, fy=129.1,
                       cx=79.65, cy=59.8)
    depths, poses = synthetic.make_sequence(cam, 7, trans_amp=0.05,
                                            rot_amp_deg=2.5)
    root = str(tmp_path / "seq")
    tum.export_sequence(root, [np.asarray(d) for d in depths], poses)

    def run(args):
        cli.main(args)
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    full = run(["--small", "run", "--dataset", root,
                "--out", str(tmp_path / "full"), "--checkpoint-every", "3"])
    assert full["frames"] == 7

    half = run(["--small", "run", "--dataset", root, "--max-frames", "4",
                "--out", str(tmp_path / "half")])
    resumed = run(["--small", "run", "--dataset", root,
                   "--resume", str(tmp_path / "half" / "map.npz"),
                   "--out", str(tmp_path / "resumed")])
    assert resumed["frames"] == 3
    assert abs(resumed["ate_rmse_m"] - full["ate_rmse_m"]) < 1e-4

    ev = run(["evaluate", "--est", str(tmp_path / "full" / "trajectory.txt"),
              "--gt", os.path.join(root, "groundtruth.txt")])
    assert ev["pairs"] == 7
    assert abs(ev["ate_rmse_m"] - full["ate_rmse_m"]) < 1e-3
    assert ev["rpe_rot_rmse_deg"] < 1.0


def test_cli_intrinsics_presets_and_override():
    from voxelhashing_demo_tpu import cli

    p = cli.build_parser()
    args = p.parse_args(["run", "--preset", "fr2", "--synthetic", "2"])
    cfg = cli._default_config(args)
    assert (cfg.camera.fx, cfg.camera.fy) == (520.9, 521.0)
    assert (cfg.camera.cx, cfg.camera.cy) == (325.1, 249.7)

    args = p.parse_args(["run", "--preset", "fr3",
                         "--intrinsics", "500.0,501.0,320.0,240.0",
                         "--synthetic", "2"])
    cfg = cli._default_config(args)
    assert (cfg.camera.fx, cfg.camera.cy) == (500.0, 240.0)

    args = p.parse_args(["run", "--synthetic", "2"])
    cfg = cli._default_config(args)
    assert cfg.camera.fx == 517.3  # fr1 default (reference common.h:7)


def test_cli_run_reports_full_evaluation(tmp_path, capsys):
    """The run JSON carries aligned + unaligned ATE and RPE directly — no
    separate evaluate step needed."""
    from voxelhashing_demo_tpu import cli

    out = str(tmp_path / "ev")
    cli.main(["--small", "run", "--synthetic", "5", "--out", out])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("ate_rmse_m", "ate_rmse_unaligned_m", "rpe_trans_rmse_m",
                "rpe_rot_rmse_deg"):
        assert key in res, key
    assert res["ate_rmse_m"] <= res["ate_rmse_unaligned_m"] + 1e-6
    assert res["rpe_trans_rmse_m"] < 0.05


def test_cli_keyframe_backend_resume(tmp_path, capsys):
    """--resume with --backend keyframe restores the full backend."""
    from voxelhashing_demo_tpu import cli
    from voxelhashing_demo_tpu.config import CameraConfig
    from voxelhashing_demo_tpu.utils import tum

    cam = CameraConfig(width=160, height=120, fx=129.3, fy=129.1,
                       cx=79.65, cy=59.8)
    depths, poses = synthetic.make_sequence(cam, 8, trans_amp=0.10,
                                            rot_amp_deg=5.0)
    root = str(tmp_path / "seq")
    tum.export_sequence(root, [np.asarray(d) for d in depths], poses)

    def run(args):
        cli.main(args)
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    kf = ["--kf-rotation", "2.0", "--kf-translation", "0.03"]
    full = run(["--small", "run", "--dataset", root,
                "--backend", "keyframe", "--out", str(tmp_path / "full")]
               + kf)
    assert full["frames"] == 8 and full["keyframes"] >= 2

    half = run(["--small", "run", "--dataset", root, "--max-frames", "5",
                "--backend", "keyframe", "--out", str(tmp_path / "half")]
               + kf)
    assert half["keyframes"] >= 2
    resumed = run(["--small", "run", "--dataset", root,
                   "--backend", "keyframe",
                   "--resume", str(tmp_path / "half" / "map.npz"),
                   "--out", str(tmp_path / "res")])
    assert resumed["frames"] == 3
    assert resumed["keyframes"] == full["keyframes"]
    assert resumed["graph_edges"] == full["graph_edges"]
    assert abs(resumed["ate_rmse_m"] - full["ate_rmse_m"]) < 1e-3


def test_cli_live_view(tmp_path, capsys):
    """--render-every writes live renders during the run (the headless
    equivalent of the reference's SDL window, Application.cpp:120-155)."""
    from voxelhashing_demo_tpu import cli

    out = str(tmp_path / "live")
    cli.main(["--small", "run", "--synthetic", "6", "--out", out,
              "--render-every", "2"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["live_frames"] == 3
    for i in (1, 3, 5):
        assert os.path.exists(os.path.join(out, f"live_{i:05d}.png"))


def test_checkpoint_with_retired_config_field_loads(tmp_path):
    """A checkpoint whose config JSON still carries a field this version
    no longer has (``hash.use_pallas_gather``) loads with that field
    ignored."""
    slam, _, _ = _run_slam(n=2)
    path = str(tmp_path / "old.npz")
    ck.save_slam(path, slam)
    with np.load(path) as z:
        arrays = dict(z)
    cfg = json.loads(bytes(arrays["config_json"]).decode())
    cfg["hash"]["use_pallas_gather"] = True
    arrays["config_json"] = np.frombuffer(json.dumps(cfg).encode(),
                                          dtype=np.uint8)
    np.savez_compressed(path, **arrays)
    loaded, _ = ck.load_slam(path)
    assert loaded.config == slam.config
    np.testing.assert_array_equal(np.asarray(loaded.state.hmap.tsdf),
                                  np.asarray(slam.state.hmap.tsdf))
