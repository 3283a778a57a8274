"""Port parity for the evaluation path: ``evaluation.py``, the eval CLI and
``export_model``, against the JAX package, on the CPU.

The sequence is one JAX-written synthetic valve sequence (720x1280, 5
frames) that both packages read; the learned mode serves the tiny
KeypointNet artifact of tests/test_torch_port_serve.py at 511x511.

Tolerances: summaries with equal ``n_points`` and ``missing_pct`` and the
cm figures within 1e-3 cm (the JAX host camera projects the keypoints in
float32, the port's in float64, ~1e-4 px apart); per-frame objects equal in
structure, 2D within 1e-4 px, 3D within 1e-5 m (test_torch_port_decode's
decode tolerances); cameras exact; exported weights bit for bit.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
pytest.importorskip("h5py")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from object_keypoints_tpu import evaluation as jeval  # noqa: E402
from object_keypoints_tpu.data.synthetic import write_synthetic_sequence  # noqa: E402
from object_keypoints_tpu.models import KeypointNet as JKeypointNet  # noqa: E402
from object_keypoints_tpu.pipeline import ObjectKeypointPipeline as JObjectKeypointPipeline  # noqa: E402
from object_keypoints_tpu.pipeline.decode_jit import (  # noqa: E402
    CameraArrays as JCameraArrays,
    decode_objects_batch as jdecode_objects_batch,
)
from object_keypoints_tpu.serving import export as jexport  # noqa: E402
from object_keypoints_tpu_torch import evaluation  # noqa: E402
from object_keypoints_tpu_torch.cli import eval_model  # noqa: E402
from object_keypoints_tpu_torch.geometry.cameras import (  # noqa: E402
    FisheyeCamera,
    load_calibration_params,
)
from object_keypoints_tpu_torch.models.keypoint_net import KeypointNet  # noqa: E402
from object_keypoints_tpu_torch.pipeline.components import ObjectKeypointPipeline  # noqa: E402
from object_keypoints_tpu_torch.pipeline.decode import (  # noqa: E402
    CameraArrays,
    DecodedObjects,
    decode_objects_batch,
)
from object_keypoints_tpu_torch.serving import export, weights  # noqa: E402
from test_torch_port_components import same_ragged  # noqa: E402
from test_torch_port_model import TINY, randomize  # noqa: E402
from test_torch_port_serve import artifact  # noqa: E402,F401

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = {"keypoint_config": [1, 3]}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory, calibration_file):
    """A data folder holding one JAX-written sequence, as the CLIs take it."""
    data = tmp_path_factory.mktemp("eval_data")
    write_synthetic_sequence(str(data / "seq_00"), calibration_file, [1, 3], n_frames=5, seed=5)
    return data


@pytest.fixture(scope="module")
def sequences(data_dir):
    path = str(data_dir / "seq_00")
    return evaluation.Sequence(path, CONFIG, device="cpu"), jeval.Sequence(path, CONFIG)


def check_summary(got, want):
    assert got["n_points"] == want["n_points"] > 0, (got, want)
    assert got["missing_pct"] == want["missing_pct"]
    assert got["lt_3cm"] == want["lt_3cm"]
    for key in ("mean_cm", "mean_xy_cm", "std_cm", "p25_cm", "p75_cm"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-3, rtol=0, err_msg=key)


def check_objects(got, want, what):
    """Lists of objects (the reference's dicts): 2D within 1e-4 px, 3D within
    1e-5 m, structure equal."""
    assert len(got) == len(want), (what, len(got), len(want))
    for g, w in zip(got, want):
        same_ragged(g["keypoints"], w["keypoints"], 1e-4, f"{what} keypoints")
        same_ragged(g["p_C"], w["p_C"], 1e-5, f"{what} p_C")


def test_sequence_cameras_match_jax(sequences):
    seq, jseq = sequences
    for name in ("camera", "camera_small"):
        got, want = getattr(seq, name), getattr(jseq, name)
        for field in ("K", "Kinv", "D", "image_size"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
        assert got.distortion_model == want.distortion_model == "equidistant"
    np.testing.assert_array_equal(seq.world_points, jseq.world_points)
    np.testing.assert_array_equal(seq.keypoints, jseq.keypoints)
    np.testing.assert_array_equal(seq.scale_prediction_to_image, jseq.scale_prediction_to_image)
    assert seq.device.type == "cpu"


def test_sequence_asks_for_the_card(data_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluation.Sequence(str(data_dir / "seq_00"), CONFIG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_model.main([str(data_dir), "--ground-truth", "--fast", "--keypoints",
                         str(ROOT / "config" / "valve.json")])


@pytest.fixture(scope="module")
def jax_ground_truth(sequences):
    return jeval.evaluate_sequence_fast(sequences[1], None, CONFIG, ground_truth=True).summary()


@pytest.mark.parametrize("batch_size", [2, 3, 8])
def test_fast_ground_truth_matches_jax(sequences, jax_ground_truth, batch_size):
    """Batched ground-truth eval, tail batch at its own size."""
    results = evaluation.evaluate_sequence_fast(sequences[0], None, CONFIG,
                                                batch_size=batch_size, ground_truth=True)
    check_summary(results.summary(), jax_ground_truth)
    assert len(results.gt_keypoints) == 5
    assert jax_ground_truth["mean_cm"] < 5.0


def test_per_frame_ground_truth_matches_jax(sequences):
    seq, jseq = sequences
    got = evaluation.evaluate_sequence(
        seq, ObjectKeypointPipeline((64, 64), seq.keypoints, CONFIG), ground_truth=True,
        max_frames=4)
    want = jeval.evaluate_sequence(
        jseq, JObjectKeypointPipeline((64, 64), jseq.keypoints, CONFIG), ground_truth=True,
        max_frames=4)
    check_summary(got.summary(), want.summary())
    for g, w in zip(got.predicted_keypoints, want.predicted_keypoints):
        same_ragged(g, w, 1e-5, "predicted keypoints")


def test_learned_mode_tiny_artifact_matches_jax(sequences, artifact):  # noqa: F811
    seq, jseq = sequences
    infer = export.load_inference_fn(artifact, device="cpu")
    jinfer = jexport.load_inference_fn(artifact)

    # one batch, frame by frame: decoded objects of both packages
    entries = list(seq.dataset.iter_prefix())
    maps = infer(evaluation.batch_frames(entries, "cpu"))
    decoded = evaluation.decoded_to_host(decode_objects_batch(
        *maps, CameraArrays.from_camera(seq.camera_small), (1, 3), max_peaks=16))
    frames = np.stack([np.transpose(e["frame"], (2, 0, 1)) for e in jseq.dataset])
    cam = jseq.camera_small
    jdecoded = jdecode_objects_batch(
        *jinfer(jnp.asarray(frames)),
        JCameraArrays(*(jnp.asarray(a, jnp.float32) for a in (cam.K, cam.D, cam.Kinv, cam.image_size))),
        (1, 3), max_peaks=16)
    n_objects = 0
    for k in range(len(entries)):
        got = evaluation.decoded_to_objects(decoded, k, (1, 3))
        check_objects(got, jeval.decoded_to_objects(jdecoded, k, (1, 3)), f"frame {k}")
        n_objects += len(got)
    assert n_objects > 0

    got = evaluation.evaluate_sequence_fast(seq, infer, CONFIG, batch_size=4)
    want = jeval.evaluate_sequence_fast(jseq, jinfer, CONFIG, batch_size=8)
    check_summary(got.summary(), want.summary())


def test_decoded_to_host_is_exact():
    g = torch.Generator().manual_seed(6)
    maps = (torch.rand(3, 3, 64, 64, generator=g), torch.rand(3, 3, 64, 64, generator=g) + 0.5,
            torch.randn(3, 2, 2, 64, 64, generator=g))
    p = load_calibration_params(str(ROOT / "config" / "calibration.yaml"))
    cam = FisheyeCamera(p["K"], p["D"], p["image_size"]).scale(64 / 720.0)
    decoded = decode_objects_batch(*maps, CameraArrays.from_camera(cam), (1, 3), max_peaks=8)
    host = evaluation.decoded_to_host(decoded)
    for name in DecodedObjects._fields:
        want = getattr(decoded, name).numpy()
        got = getattr(host, name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert decoded.center_valid.any()


def test_cli_matches_the_jax_script(data_dir, tmp_path):
    """``--ground-truth --fast`` through both entry points as subprocesses:
    the port's on the CPU (--cpu), the JAX script as it runs on the CPU."""
    valve = str(ROOT / "config" / "valve.json")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    port = subprocess.run(
        [sys.executable, "-m", "object_keypoints_tpu_torch.cli.eval_model", str(data_dir),
         "--ground-truth", "--fast", "--cpu", "--keypoints", valve, "--json",
         str(tmp_path / "port.json")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert port.returncode == 0, port.stderr
    ref = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "eval_model.py"), str(data_dir), "--ground-truth",
         "--fast", "--keypoints", valve, "--json", str(tmp_path / "jax.json")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    check_summary(got["summary"], want["summary"])
    assert {k: got[k] for k in ("data", "model", "ground_truth", "fast")} == {
        k: want[k] for k in ("data", "model", "ground_truth", "fast")}


def test_cli_per_frame_modes(data_dir, artifact, tmp_path):  # noqa: F811
    """The per-frame loop in both modes, in process on the CPU: ground truth
    against the batched path; learned mode (whose per-frame components
    decode 32 peaks a map, the batched path 16, as in the JAX package)
    writes one overlay a frame."""
    valve = str(ROOT / "config" / "valve.json")
    common = [str(data_dir), "--cpu", "--keypoints", valve, "--max-frames", "3"]
    per_frame = eval_model.main(common + ["--ground-truth"])
    batched = eval_model.main(common + ["--ground-truth", "--fast", "--batch", "2"])
    check_summary(per_frame, batched)
    pytest.importorskip("matplotlib")
    learned = eval_model.main(common + ["-m", artifact, "--write", str(tmp_path / "frames")])
    learned_fast = eval_model.main(common + ["-m", artifact, "--fast"])
    assert learned["n_points"] > 0 and learned_fast["n_points"] > 0
    assert sorted(os.listdir(tmp_path / "frames")) == [f"{i:06}.jpg" for i in range(3)]


@pytest.fixture(scope="module")
def tiny_variables():
    rng = np.random.default_rng(31)
    model = JKeypointNet(**TINY)
    return randomize(model.init({"params": jax.random.key(3)}, jnp.zeros((1, 64, 64, 3))), rng)


def test_export_round_trip(tiny_variables, tmp_path):
    """JAX variables -> port model -> port ``export_model`` -> JAX
    ``load_model`` gives the variables back bit for bit; the port's
    ``load_model`` reads the same artifact strictly."""
    arch = dict(stacks=TINY["stacks"], levels=TINY["levels"], mods=TINY["mods"])
    model = KeypointNet(**TINY)
    model.load_state_dict(weights.keypoint_net_state_dict(tiny_variables, **arch), strict=True)
    config = {k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()}
    config.update(input_size=64, keypoint_config=[1, 3])
    export.export_model(str(tmp_path), config, model)
    assert sorted(os.listdir(tmp_path)) == ["config.json", "params.msgpack"]

    _, restored, jconfig = jexport.load_model(str(tmp_path))
    assert jconfig == config
    for col in ("params", "batch_stats"):
        want, got = flatten_dict(tiny_variables[col]), flatten_dict(restored[col])
        assert set(got) == set(want)
        for k in want:
            assert np.asarray(got[k]).dtype == np.float32
            np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=str(k))

    back, _ = export.load_model(str(tmp_path))  # strict=True inside
    for (k, a), b in zip(model.state_dict().items(), back.state_dict().values()):
        assert torch.equal(a, b), k
    with pytest.raises(KeyError, match="unexpected"):
        weights.keypoint_net_variables({**model.state_dict(), "extra": torch.zeros(1)}, **arch)


def test_export_of_a_state_dict_serves(tiny_variables, tmp_path):
    """A state_dict exported by the port serves the same maps as the model
    it came from."""
    arch = dict(stacks=TINY["stacks"], levels=TINY["levels"], mods=TINY["mods"])
    sd = weights.keypoint_net_state_dict(tiny_variables, **arch)
    config = {k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()}
    export.export_model(str(tmp_path / "a"), config, sd)
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    frames = np.random.default_rng(8).normal(size=(2, 3, 64, 64)).astype(np.float32)
    got = export.load_inference_fn(str(tmp_path / "b"), device="cpu")(frames)
    jwant = jexport.load_inference_fn(str(tmp_path / "a"))(jnp.asarray(frames))
    for g, w in zip(got, jwant):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)
