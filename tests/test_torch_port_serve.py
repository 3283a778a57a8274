"""Port parity for the serve slice as a whole, and the port's import hygiene.

A JAX artifact written by ``export_model`` is loaded by the port's
``load_inference_fn``; frames go through JAX ``load_inference_fn`` +
``decode_objects_batch`` and through the port's, at a tiny geometry
(128x128 frames -> 16x16 maps). Maps agree to atol 1e-4; the decode to the
tolerances of test_torch_port_decode (masks equal, 1e-4 px, 1e-5 m).
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

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from object_keypoints_tpu.geometry import cameras as jcam  # noqa: E402
from object_keypoints_tpu.models import KeypointNet as JKeypointNet  # noqa: E402
from object_keypoints_tpu.pipeline import decode_jit as jpipe  # noqa: E402
from object_keypoints_tpu.serving import export as jexport  # noqa: E402
from object_keypoints_tpu_torch.geometry import cameras as cam  # noqa: E402
from object_keypoints_tpu_torch.pipeline import decode as pipe  # noqa: E402
from object_keypoints_tpu_torch.serving import export  # noqa: E402
from test_torch_port_model import TINY, randomize  # noqa: E402

torch.set_num_threads(1)

CONFIG = (1, 3)
MAP = 16


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    rng = np.random.default_rng(21)
    model = JKeypointNet(**TINY)
    variables = randomize(
        model.init({"params": jax.random.key(2)}, jnp.zeros((1, 128, 128, 3))), rng)
    path = tmp_path_factory.mktemp("artifact")
    config = {k: list(v) if isinstance(v, tuple) else v for k, v in TINY.items()}
    jexport.export_model(str(path), {**config, "input_size": 128,
                                     "keypoint_config": list(CONFIG)}, variables)
    return str(path)


def test_serve_slice_matches_jax(artifact, calibration_file):
    frames = np.random.default_rng(22).normal(size=(4, 3, 128, 128)).astype(np.float32)

    jinfer = jexport.load_inference_fn(artifact, quantize="never")
    jheat, jdepth, jcent = (np.asarray(a) for a in jinfer(jnp.asarray(frames)))
    heat, depth, cent = export.load_inference_fn(artifact, device="cpu")(frames)
    assert heat.shape == (4, 3, MAP, MAP) and cent.shape == (4, 2, 2, MAP, MAP)
    for name, got, want in (("heat", heat, jheat), ("depth", depth, jdepth),
                            ("centers", cent, jcent)):
        assert got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0, err_msg=name)

    offset = np.array([(511.0 / 720.0 * 1280.0 - 511.0) / 2.0, 0.0])
    chain = []
    for mod in (cam, jcam):
        p = mod.load_calibration_params(calibration_file)
        chain.append(mod.FisheyeCamera(p["K"], p["D"], p["image_size"])
                     .scale(511.0 / 720.0).cut(offset).scale(MAP / 511.0))
    jcamera = jpipe.CameraArrays(*(jnp.asarray(a, jnp.float32) for a in
                                   (chain[1].K, chain[1].D, chain[1].Kinv, chain[1].image_size)))
    kw = dict(max_peaks=8, reject_distance=20.0, peak_threshold=0.5)
    got = pipe.decode_objects_batch(heat, depth, cent, pipe.CameraArrays.from_camera(chain[0]),
                                    CONFIG, **kw)
    want = jpipe.decode_objects_batch(jnp.asarray(jheat), jnp.asarray(jdepth),
                                      jnp.asarray(jcent), jcamera, CONFIG, **kw)
    for name in pipe.DecodedObjects._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if g.dtype == bool or name == "assignment":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=1e-5 if name.endswith("p3d") else 1e-4,
                                       rtol=0, err_msg=name)
    assert got.center_valid.any()  # random weights still give peaks to decode


def test_load_model_reads_flax_msgpack_without_flax(artifact):
    model, config = export.load_model(artifact)
    assert config["input_size"] == 128
    flat = jax.tree_util.tree_leaves(jexport.load_model(artifact)[1])
    assert sum(p.numel() for p in model.parameters()) + sum(
        b.numel() for n, b in model.named_buffers() if "num_batches" not in n
    ) == sum(np.size(a) for a in flat)


def test_int8_serving_is_not_ported(artifact, tmp_path):
    """The name dates from before int8 serving was ported; the test now
    holds ``load_inference_fn``'s JAX semantics for an artifact with
    quant.json: "auto" (the default) and "require" serve it int8, "never"
    serves float, "require" without quant.json raises FileNotFoundError, and
    another word raises ValueError."""
    quantized = tmp_path / "quantized"
    shutil.copytree(artifact, quantized)
    (quantized / export.QUANT_NAME).write_text(json.dumps({"heatmap_head_1/conv_out": 1.0}))
    frames = np.random.default_rng(24).normal(size=(2, 3, 128, 128)).astype(np.float32)
    never = export.load_inference_fn(str(quantized), quantize="never", device="cpu")(frames)
    float_maps = export.load_inference_fn(artifact, device="cpu")(frames)
    assert all(torch.equal(a, b) for a, b in zip(never, float_maps))
    for quantize in ("auto", "require"):
        maps = export.load_inference_fn(str(quantized), quantize=quantize, device="cpu")(frames)
        assert any(not torch.equal(a, b) for a, b in zip(maps, never)), quantize
    with pytest.raises(FileNotFoundError):
        export.load_inference_fn(artifact, quantize="require", device="cpu")
    with pytest.raises(ValueError):
        export.load_inference_fn(artifact, quantize="int8", device="cpu")


def test_auto_serves_a_float_artifact_in_float(artifact):
    """quantize="auto" (the default, as in the JAX package) on an artifact
    without quant.json serves float, equal to quantize="never"."""
    frames = np.random.default_rng(23).normal(size=(2, 3, 128, 128)).astype(np.float32)
    auto = export.load_inference_fn(artifact, device="cpu")(frames)
    never = export.load_inference_fn(artifact, quantize="never", device="cpu")(frames)
    for a, b in zip(auto, never):
        assert torch.equal(a, b)


def test_serving_defaults_to_the_card(artifact, monkeypatch):
    """With no device given, the serve entry points ask for CUDA and raise
    where there is none, rather than serving on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export.load_inference_fn(artifact)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export.make_inference_fn(export.load_model(artifact)[0])


def test_port_never_imports_jax(tmp_path):
    """Import every slice module in a fresh interpreter (this process already
    has jax, from conftest.py) and check jax never came in."""
    code = (
        "import json, sys\n"
        "import object_keypoints_tpu_torch\n"
        "from object_keypoints_tpu_torch.models import blocks, hourglass, keypoint_net\n"
        "from object_keypoints_tpu_torch.models import cornernet\n"
        "from object_keypoints_tpu_torch.ops import _build, associate, decode, stem_conv\n"
        "from object_keypoints_tpu_torch.ops import corner_pool, detection_decode, nms\n"
        "from object_keypoints_tpu_torch.inference import detector, saccade\n"
        "from object_keypoints_tpu_torch.ops import int8_conv\n"
        "from object_keypoints_tpu_torch.geometry import cameras, linalg, stereo\n"
        "from object_keypoints_tpu_torch.pipeline import components, decode\n"
        "from object_keypoints_tpu_torch.pipeline import stereo as pipeline_stereo\n"
        "from object_keypoints_tpu_torch.serving import calibration, export, quantize, weights\n"
        "from object_keypoints_tpu_torch import constants, evaluation, testing\n"
        "from object_keypoints_tpu_torch.data import augment, encode, scene, synthetic, targets\n"
        "from object_keypoints_tpu_torch.data import augment_device, coco, combinators, prefetch\n"
        "from object_keypoints_tpu_torch.data import detection_augment, detection_targets\n"
        "from object_keypoints_tpu_torch.vendor import cocotools\n"
        "from object_keypoints_tpu_torch.training import device_data, losses, trainer\n"
        "from object_keypoints_tpu_torch.training import checkpoints, detection, loop\n"
        "from object_keypoints_tpu_torch import precision\n"
        "from object_keypoints_tpu_torch.utils import config, metrics, progress, tb_events, vis\n"
        "from object_keypoints_tpu_torch.cli import eval_model, flagship, package_model, train\n"
        "from object_keypoints_tpu_torch.cli import detect, evaluate_detector, train_detector\n"
        "from object_keypoints_tpu_torch import labeling, parallel\n"
        "from object_keypoints_tpu_torch.parallel import mesh\n"
        "from object_keypoints_tpu_torch.serving import sharded\n"
        "from object_keypoints_tpu_torch.utils import clustering, ros, timer, Rate, Timing\n"
        "from object_keypoints_tpu_torch.cli import import_checkpoint, label, show_keypoints\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'object_keypoints_tpu'))\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env={**os.environ, "PYTHONPATH": str(pathlib.Path(__file__).parents[1])},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
