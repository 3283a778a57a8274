"""Port parity for the host tools: ``labeling``, ``utils`` (``Timing``,
``trace``, ``Rate``, ``ros``, ``clustering``) and the label,
show_keypoints and import_checkpoint CLIs, against the JAX package and its
scripts on the CPU.

The labeling runs on tests/test_labeling.py's synthetic sequence (keypoints
(1, 3), 24 frames, orbit radius 0.5 m, seed 7), written by the JAX package.

Tolerances, with what they were set from:
- ``find_furthest_frames``: indices equal (the same scan; the first pair in
  scan order wins a tie);
- 3D labels (``triangulate_pair``, the saved keypoints.json) within 1e-4 m
  of the JAX package's (seen 2.9e-7 m: JAX's camera math runs in float32,
  the port's in float64) and within 2e-3 m of the truth (test_labeling's);
  ``backproject`` within 1e-3 px of JAX's (seen 3.6e-5 px);
- the ROS conversions and the clustering equal (the same numpy and scipy or
  scikit-learn code);
- show_keypoints' overlay jpgs equal byte for byte to scripts/show_keypoints.py's;
- import_checkpoint's artifact served by the port against the JAX script's
  artifact served by the JAX package on the same Lightning state_dict
  (full width, 127x127 frames, float32): within 1e-5 (seen 6.0e-8); the
  bare backbone's params.msgpack tree equal, array for array.
"""

import json
import os
import pathlib
import runpy
import shutil
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
h5py = pytest.importorskip("h5py")

import jax  # noqa: E402

from object_keypoints_tpu import labeling as jlabeling  # noqa: E402
from object_keypoints_tpu.data.synthetic import write_synthetic_sequence  # noqa: E402
from object_keypoints_tpu.geometry import from_calibration as jfrom_calibration  # noqa: E402
from object_keypoints_tpu.geometry import linalg as jlinalg  # noqa: E402
from object_keypoints_tpu.serving import export as jexport  # noqa: E402
from object_keypoints_tpu.utils import ros as jros  # noqa: E402
from object_keypoints_tpu.utils import timer as jtimer  # noqa: E402
from object_keypoints_tpu_torch import labeling, utils  # noqa: E402
from object_keypoints_tpu_torch.cli import import_checkpoint, label, show_keypoints  # noqa: E402
from object_keypoints_tpu_torch.models.keypoint_net import KeypointNet  # noqa: E402
from object_keypoints_tpu_torch.serving import export  # noqa: E402
from object_keypoints_tpu_torch.utils import clustering, ros, timer  # noqa: E402

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def sequence_dir(tmp_path_factory, calibration_file):
    out = tmp_path_factory.mktemp("label_seq") / "seq"
    write_synthetic_sequence(str(out), calibration_file, keypoint_config=[1, 3], n_frames=24,
                             orbit_radius=0.5, seed=7)
    return str(out)


def random_poses(rng, n, duplicates=0):
    from scipy.spatial.transform import Rotation

    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, :3, :3] = Rotation.random(n, random_state=rng.integers(1 << 31)).as_matrix()
    poses[:, :3, 3] = rng.normal(size=(n, 3)) * 0.3
    if duplicates:  # repeated poses tie: the scan's first pair must win
        poses[-duplicates:] = poses[:duplicates]
    return poses


@pytest.mark.parametrize("seed, n, stride, duplicates", [(0, 40, None, 0), (1, 90, None, 0),
                                                         (2, 30, 1, 10), (3, 12, 2, 6)])
def test_find_furthest_frames_matches_jax(seed, n, stride, duplicates):
    poses = random_poses(np.random.default_rng(seed), n, duplicates)
    for min_baseline in (0.1, 0.3):
        want = jlabeling.find_furthest_frames(poses, stride=stride, min_baseline=min_baseline)
        assert labeling.find_furthest_frames(poses, stride, min_baseline) == want
    still = np.tile(np.eye(4), (10, 1, 1))
    assert labeling.find_furthest_frames(still) == (None, None)


def projections(camera_module_camera, world, T_W):
    T_CW = np.asarray(jlinalg.inv_transform(T_W))
    return camera_module_camera.project(world, T_CW)


def test_triangulate_pair_matches_jax(sequence_dir, calibration_file):
    from object_keypoints_tpu_torch.geometry.cameras import from_calibration

    jcam, cam = jfrom_calibration(calibration_file), from_calibration(calibration_file)
    with h5py.File(os.path.join(sequence_dir, "data.hdf5"), "r") as f:
        poses = f["camera_transform"][:]
    world = labeling.read_points(os.path.join(sequence_dir, "keypoints.json"))[:, :3]
    i, j = labeling.find_furthest_frames(poses, min_baseline=0.05)
    left, right = projections(jcam, world, poses[i]), projections(jcam, world, poses[j])
    for X, l, r in zip(world, left, right):
        got = labeling.triangulate_pair(cam, poses[i], poses[j], l, r)
        want = jlabeling.triangulate_pair(jcam, poses[i], poses[j], l, r)
        assert got.dtype == np.float64 and got.shape == (3,)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        np.testing.assert_allclose(got, X, atol=2e-3, rtol=0)


def session_clicks(session, jcam, world):
    T_WL = session.poses[session.left_frame_index]
    T_WR = session.poses[session.right_frame_index]
    for l, r in zip(projections(jcam, world, T_WL), projections(jcam, world, T_WR)):
        session.add_point("left", l)
        session.add_point("right", r)
    session.add_point("left", (0.0, 0.0))  # a junk click, undone
    session.undo()


def test_session_add_undo_save_writes_the_jax_keypoints(sequence_dir, calibration_file,
                                                        tmp_path):
    world = labeling.read_points(os.path.join(sequence_dir, "keypoints.json"))[:, :3]
    jcam = jfrom_calibration(calibration_file)
    saved = {}
    for name, module in (("port", labeling), ("jax", jlabeling)):
        seq = tmp_path / name
        shutil.copytree(sequence_dir, seq)
        session = module.LabelingSession(str(seq), calibration_file)
        session_clicks(session, jcam, world)
        assert len(session.left_keypoints) == len(session.right_keypoints) == len(world)
        out_file = session.save()
        assert out_file == str(seq / "keypoints.json")
        saved[name] = (labeling.read_points(out_file), session)
    (got, port_session), (want, jax_session) = saved["port"], saved["jax"]
    assert (port_session.left_frame_index, port_session.right_frame_index) == (
        jax_session.left_frame_index, jax_session.right_frame_index)
    assert got.shape == want.shape == world.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, world, atol=2e-3, rtol=0)
    for index in (port_session.left_frame_index, 5):
        np.testing.assert_allclose(port_session.backproject(index), jax_session.backproject(index),
                                   atol=1e-3, rtol=0)
    port_session.swap_frames(right=3)
    assert port_session.right_frame_index == 3
    port_session.add_point("left", (10.0, 10.0))
    with pytest.raises(AssertionError, match="counts must match"):
        port_session.save()


def test_write_points_is_the_jax_format(tmp_path):
    points = [np.array([1.0, 2.0, 3.0]), np.array([[0.5], [0.25], [-1.0]])]
    labeling.write_points(str(tmp_path / "port.json"), points)
    jlabeling.write_points(str(tmp_path / "jax.json"), points)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


# --- utils --------------------------------------------------------------------------------


def test_timing_and_rate(capsys):
    timing = utils.Timing()
    assert utils.Timing is timer.Timing
    for _ in range(3):
        with timing.measure("work"):
            time.sleep(0.002)
    timing.start("once")
    timing.end("once")
    stats = timing.stats()
    assert set(stats) == {"work", "once"} and stats["work"][2] == 3 and stats["once"][2] == 1
    assert stats["work"][0] >= 0.002
    timing.print_timing()
    reference = jtimer.Timing()
    reference._samples = timing._samples
    reference.print_timing()
    port_lines, jax_lines = np.split(np.array(capsys.readouterr().out.splitlines()), 2)
    assert list(port_lines) == list(jax_lines)

    rate = utils.Rate(hz=100.0)
    t0 = time.monotonic()
    for _ in range(3):
        rate.sleep()
    assert time.monotonic() - t0 >= 0.029


def test_trace_writes_a_chrome_trace(tmp_path):
    with timer.trace(str(tmp_path / "trace")):
        torch.relu(torch.randn(64, 64) @ torch.randn(64, 64))
    with open(tmp_path / "trace" / timer.TRACE_NAME) as f:
        events = json.load(f)["traceEvents"]
    assert any("relu" in str(e.get("name", "")) for e in events)


def test_ros_conversions_match_jax():
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(0)
    for _ in range(5):
        T = np.eye(4)
        T[:3, :3] = Rotation.random(random_state=rng.integers(1 << 31)).as_matrix()
        T[:3, 3] = rng.normal(size=3)
        msg = ros.transform_to_message(T, "world", "camera", 1.5)
        want = jros.transform_to_message(T, "world", "camera", 1.5)
        for part in ("translation", "rotation"):
            for axis in ("x", "y", "z", "w") if part == "rotation" else ("x", "y", "z"):
                assert getattr(getattr(msg.transform, part), axis) == getattr(
                    getattr(want.transform, part), axis)
        assert (msg.header.frame_id, msg.child_frame_id, msg.header.stamp) == ("world", "camera",
                                                                               1.5)
        np.testing.assert_array_equal(ros.message_to_transform(msg),
                                      jros.message_to_transform(want))
        np.testing.assert_allclose(ros.message_to_transform(msg), T, atol=1e-12)
        pose, jpose = ros.transform_to_pose(T, "map", 2.0), jros.transform_to_pose(T, "map", 2.0)
        assert vars(pose.pose.orientation) == vars(jpose.pose.orientation)
        assert vars(pose.pose.position) == vars(jpose.pose.position)


def test_clustering_matches_jax():
    sklearn = pytest.importorskip("sklearn")
    assert sklearn
    from object_keypoints_tpu.utils.clustering import KeypointClustering as JClustering

    rng = np.random.default_rng(0)
    points = np.concatenate([rng.normal(c, 0.5, size=(20, 2)) for c in ((0, 0), (8, 8), (0, 9))])
    centers, labels = clustering.KeypointClustering(bandwidth=2.0)(points)
    want_centers, want_labels = JClustering(bandwidth=2.0)(points)
    assert len(centers) == 3
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_array_equal(centers, want_centers)


# --- the CLIs -----------------------------------------------------------------------------


def test_label_cli_without_a_display_exits_before_matplotlib(tmp_path, monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # any import of it would raise
    with pytest.raises(SystemExit) as exit_info:
        label.main([str(tmp_path)])
    assert "LabelingSession" in str(exit_info.value)
    assert label.read_args([str(tmp_path), "--calibration", "c.yaml"]).calibration == "c.yaml"


def test_show_keypoints_cli_writes_the_jax_overlays(sequence_dir, calibration_file, tmp_path,
                                                    monkeypatch):
    base = tmp_path / "sequences"
    shutil.copytree(sequence_dir, base / "seq")
    flags = [str(base), "--calibration", calibration_file, "--max-frames", "3"]
    written = show_keypoints.main([*flags, "--out", str(tmp_path / "port")])
    assert written == {"seq": 3}
    monkeypatch.setattr(sys, "argv", ["show_keypoints.py", *flags, "--out", str(tmp_path / "jax")])
    runpy.run_path(str(ROOT / "scripts" / "show_keypoints.py"), run_name="__main__")
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [f"seq_{i:06}.jpg" for i in range(3)]
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    # the overlays hold the projected keypoints: the red dots are there
    image = cv2.imread(str(tmp_path / "port" / names[0]))
    assert ((image[..., 2] > 200) & (image[..., 1] < 60) & (image[..., 0] < 60)).sum() > 20


def run_jax_import_script(monkeypatch, checkpoint, out):
    monkeypatch.setattr(sys, "argv", ["import_torch_checkpoint.py", str(checkpoint), "--out",
                                      str(out), "--keypoints", str(ROOT / "config/valve.json"),
                                      "--features", "8"])
    runpy.run_path(str(ROOT / "scripts" / "import_torch_checkpoint.py"), run_name="__main__")


def port_import(checkpoint, out):
    return import_checkpoint.main([str(checkpoint), "--out", str(out), "--keypoints",
                                   str(ROOT / "config/valve.json"), "--features", "8"])


def test_import_checkpoint_cli_serves_as_the_jax_script(tmp_path, monkeypatch, capsys):
    model = KeypointNet(heatmaps_out=3, features=8, dropout=0.0,
                        generator=torch.Generator().manual_seed(0))
    checkpoint = tmp_path / "lightning.ckpt"
    torch.save({"state_dict": {f"model.{k}": v for k, v in model.state_dict().items()}},
               checkpoint)
    result = port_import(checkpoint, tmp_path / "port")
    run_jax_import_script(monkeypatch, checkpoint, tmp_path / "jax")
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[0]) == result
    assert json.loads(printed[-1]) == {"out": str(tmp_path / "jax"),
                                       "imported_params": result["imported_params"]}
    assert result["imported_params"] == sum(p.numel() for p in model.parameters())
    assert json.loads((tmp_path / "port" / "config.json").read_text()) == json.loads(
        (tmp_path / "jax" / "config.json").read_text())

    frames = np.random.default_rng(0).normal(size=(2, 3, 127, 127)).astype(np.float32)
    got = export.load_inference_fn(str(tmp_path / "port"), device="cpu")(frames)
    want = jexport.load_inference_fn(str(tmp_path / "jax"))(frames)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)


def test_import_checkpoint_cli_bare_backbone_and_unmapped_keys(tmp_path, monkeypatch, capsys):
    model = KeypointNet(heatmaps_out=3, features=8, dropout=0.0,
                        generator=torch.Generator().manual_seed(1))
    bare = {k.removeprefix("backbone."): v for k, v in model.state_dict().items()
            if k.startswith("backbone.")}
    torch.save(bare, tmp_path / "corner_net.pkl")
    result = port_import(tmp_path / "corner_net.pkl", tmp_path / "port")
    run_jax_import_script(monkeypatch, tmp_path / "corner_net.pkl", tmp_path / "jax")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["imported_params"] == (
        result["imported_params"])
    got, want = ((tmp_path / name / "params.msgpack").read_bytes() for name in ("port", "jax"))
    got, want = export.read_flax_msgpack(got), export.read_flax_msgpack(want)
    flat_got, flat_want = jax.tree_util.tree_leaves_with_path(got), \
        jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    assert set(got["params"]) == {"backbone"}
    for (path, a), (_, b) in zip(flat_got, flat_want):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))
    with pytest.raises(KeyError):  # no heads: neither package can serve it
        export.load_model(str(tmp_path / "port"))

    torch.save({**model.state_dict(), "extra.weight": torch.zeros(1)}, tmp_path / "bad.pkl")
    with pytest.raises(ValueError, match="unmapped reference keys: \\['extra.weight'\\]"):
        port_import(tmp_path / "bad.pkl", tmp_path / "bad")
