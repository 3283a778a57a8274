"""Port parity: the detector eval against the JAX package, on the CPU.

``SystemConfig``, the synthetic COCO set, ``CocoDetectionDataset`` (its
detections, the results conversion, ``evaluate`` and the fallback AP), the
vendored COCOeval, and the eval CLI: ``cli.evaluate_detector --cpu --tiny``
in-process for the three archs against scripts/evaluate_detector.py
(``cornernet_inference`` / ``cornernet_saccade_inference`` + ``evaluate``)
on the same weights and the same four synthetic 192x256 images. The JAX CLI
reads them as an Orbax snapshot, the port's as a ``.pth`` state_dict:
CornerNet and CornerNet-Squeeze seeded with shared heat kernels (so that
corners pair), CornerNet-Saccade the trained fixture
results/saccade_tiny/CornerNet_Saccade_800.

Tolerances: configs, annotations, decoded images, detections and
conversions exact; the 12 COCOeval stats and the fallback AP within 1e-12
on one results file; the CLI's mAP and stats within 1e-6 and its
results.json rows as sets (``testing.compare_coco_rows``): equal counts
per image and class, boxes within 1e-4 px (xywh), scores within 1e-5.
"""

import importlib.util
import json
import os
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
ocp = pytest.importorskip("orbax.checkpoint")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from object_keypoints_tpu.data import coco as jcoco  # noqa: E402
from object_keypoints_tpu.data import synthetic as jsynthetic  # noqa: E402
from object_keypoints_tpu.models.cornernet import tiny_cornernet as jtiny_cornernet  # noqa: E402
from object_keypoints_tpu.utils import config as jconfig  # noqa: E402
from object_keypoints_tpu.vendor import cocotools as jcocotools  # noqa: E402
from object_keypoints_tpu_torch.cli import evaluate_detector  # noqa: E402
from object_keypoints_tpu_torch.data import coco, synthetic  # noqa: E402
from object_keypoints_tpu_torch.models import cornernet  # noqa: E402
from object_keypoints_tpu_torch.serving import weights  # noqa: E402
from object_keypoints_tpu_torch.testing import coco_rows, compare_coco_rows  # noqa: E402
from object_keypoints_tpu_torch.utils import config  # noqa: E402
from object_keypoints_tpu_torch.vendor import cocotools  # noqa: E402
from test_torch_port_model import randomize  # noqa: E402

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["CornerNet", "CornerNet_Saccade", "CornerNet_Squeeze"]


# --- configs and data ----------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS + ["CornerNet-multi_scale"])
def test_system_config_equals_jax(arch):
    system, _ = config.load_cfg(config.CONFIG_DIR / f"{arch}.json")
    got = config.SystemConfig(snapshot_name=arch).update_config(system)
    want = jconfig.SystemConfig(snapshot_name=arch).update_config(system)
    assert got.full.keys() == want.full.keys()
    for key, value in want.full.items():
        if isinstance(value, np.random.RandomState):
            for a, b in zip(got.full[key].get_state(), value.get_state()):
                np.testing.assert_array_equal(a, b)
        else:
            assert got.full[key] == value, key
    assert (got.snapshot_dir, got.snapshot_file, got.max_iter) == (
        want.snapshot_dir, want.snapshot_file, want.max_iter)
    with pytest.raises(AttributeError):
        got.no_such_key  # noqa: B018


@pytest.fixture(scope="module")
def coco_set(tmp_path_factory):
    """The same seed through both writers: (port's (ann, images), JAX's)."""
    root = tmp_path_factory.mktemp("coco")
    ours = synthetic.make_synthetic_coco_dataset(str(root / "port"), n_images=4,
                                                 image_size=(192, 256), seed=0)
    theirs = jsynthetic.make_synthetic_coco_dataset(str(root / "jax"), n_images=4,
                                                    image_size=(192, 256), seed=0)
    return ours, theirs


def test_synthetic_coco_dataset_equals_jax(coco_set):
    (ann, images), (jann, jimages) = coco_set
    with open(ann) as f, open(jann) as g:
        assert json.load(f) == json.load(g)
    names = sorted(os.listdir(jimages))
    assert sorted(os.listdir(images)) == names and len(names) == 4
    for name in names:
        np.testing.assert_array_equal(cv2.imread(os.path.join(images, name)),
                                      cv2.imread(os.path.join(jimages, name)))


def random_results(db, seed, n=30):
    """{image_id: {class: (k, 5)}}: random boxes near the ground truth of
    classes 1 and 2, and a few of other classes."""
    rng = np.random.default_rng(seed)
    out = {}
    for ind, image_id in enumerate(db.image_ids):
        gt = db.detections(ind)
        by_class = {}
        for cls in (1, 2, 5):
            base = gt[gt[:, 4] == cls][:, :4] if cls < 3 else rng.uniform(0, 100, (2, 4))
            if not len(base):
                continue
            boxes = np.repeat(base, n // 10, axis=0) + rng.normal(0, 3, (len(base) * (n // 10), 4))
            boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 1)
            by_class[cls] = np.concatenate(
                [boxes, rng.uniform(0, 1, (len(boxes), 1))], axis=1).astype(np.float32)
        out[image_id] = by_class
    return out


def test_coco_dataset_and_its_evaluation_equal_jax(coco_set, tmp_path, capsys):
    (ann, images), _ = coco_set
    ours, theirs = coco.CocoDetectionDataset(ann, images), jcoco.CocoDetectionDataset(ann, images)
    assert len(ours) == len(theirs) == 4
    assert (ours.categories, ours.cat_to_class, ours.class_names) == (
        theirs.categories, theirs.cat_to_class, theirs.class_names)
    for ind in range(len(ours)):
        assert ours.image_path(ind) == theirs.image_path(ind)
        np.testing.assert_array_equal(ours.detections(ind), theirs.detections(ind))
    results = random_results(ours, 0)
    converted = ours.convert_to_coco(results)
    assert converted == theirs.convert_to_coco(results) and len(converted) > 20
    result_json = tmp_path / "results.json"
    result_json.write_text(json.dumps(converted))

    cls_ids, image_ids = list(range(1, 81)), list(ours.image_ids)
    got = ours.evaluate(str(result_json), cls_ids, image_ids)
    want = theirs.evaluate(str(result_json), cls_ids, image_ids)
    assert len(got["stats"]) == 12 and want["mAP"] > 0.05
    np.testing.assert_allclose(got["stats"], want["stats"], rtol=0, atol=1e-12)
    got = ours._evaluate_fallback(str(result_json))
    want = theirs._evaluate_fallback(str(result_json))
    assert got["per_class"].keys() == want["per_class"].keys() and want["mAP"] > 0.05
    np.testing.assert_allclose(got["mAP"], want["mAP"], rtol=0, atol=1e-12)
    for cls in want["per_class"]:
        np.testing.assert_allclose(got["per_class"][cls], want["per_class"][cls], rtol=0,
                                   atol=1e-12)
    capsys.readouterr()


def test_vendored_cocoeval_equals_jax(coco_set, tmp_path, capsys):
    (ann, images), _ = coco_set
    db = coco.CocoDetectionDataset(ann, images)
    result_json = tmp_path / "results.json"
    result_json.write_text(json.dumps(db.convert_to_coco(random_results(db, 1))))
    evals = []
    for tools in (cocotools, jcocotools):
        gt = tools.COCO(ann)
        ev = tools.COCOeval(gt, gt.loadRes(str(result_json)), "bbox")
        ev.params.catIds = [1, 2, 5]
        ev.evaluate()
        ev.accumulate()
        ev.summarize()
        evals.append(ev)
    got, want = evals
    np.testing.assert_array_equal(got.stats, want.stats)
    assert got.eval.keys() == want.eval.keys()
    for key in ("precision", "recall"):
        np.testing.assert_array_equal(got.eval[key], want.eval[key])
    capsys.readouterr()


# --- the eval CLI -------------------------------------------------------------------

def jax_eval_cli():
    """scripts/evaluate_detector.py as a module (its main reads sys.argv)."""
    spec = importlib.util.spec_from_file_location("jax_evaluate_detector",
                                                  ROOT / "scripts" / "evaluate_detector.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def snapshot_variables(arch):
    """The tiny model's JAX variables: the trained saccade fixture, or a
    seeded init with random BatchNorm whose heat heads share one kernel
    across classes (x 3), so that corners of one class pair."""
    if arch == "CornerNet_Saccade":
        restored = ocp.PyTreeCheckpointer().restore(
            os.path.abspath(ROOT / "results" / "saccade_tiny" / "CornerNet_Saccade_800"))
        variables = {"params": restored["params"], "batch_stats": restored["batch_stats"]}
        return jax.tree_util.tree_map(np.asarray, variables), 800
    model = jtiny_cornernet(arch, categories=80)
    variables = model.init({"params": jax.random.key(1)}, jnp.zeros((1, 64, 64, 3)))
    variables = randomize(jax.tree_util.tree_map(np.asarray, variables),
                          np.random.default_rng(1))
    for side in ("tl", "br"):
        head = variables["params"][f"{side}_heat_0"]["conv_out"]
        head["kernel"] = np.repeat(head["kernel"][..., :1], 80, axis=-1) * 3.0
        head["bias"] = np.float32(-2.19) + np.float32(0.01) * np.arange(80, dtype=np.float32)
    return variables, 7


@pytest.fixture(scope="module", params=ARCHS)
def jax_eval(request, coco_set, tmp_path_factory):
    """One model's snapshot in both formats and the JAX CLI's run of it."""
    arch = request.param
    (ann, images), _ = coco_set
    root = tmp_path_factory.mktemp(arch)
    variables, test_iter = snapshot_variables(arch)
    ocp.PyTreeCheckpointer().save(str(root / "snapshots" / f"{arch}_{test_iter}"), variables)
    state_dict = weights.cornernet_state_dict(variables, cornernet.tiny_arch(arch))
    torch.save(state_dict, root / "snapshots" / f"{arch}_{test_iter}.pth")
    argv = [arch, "--annotations", ann, "--image-dir", images, "--tiny",
            "--snapshot-dir", str(root / "snapshots"), "--testiter", str(test_iter)]
    saved = sys.argv
    sys.argv = ["evaluate_detector.py", *argv, "--result-dir", str(root / "jax")]
    try:
        out = jax_eval_cli().main()
    finally:
        sys.argv = saved
    return argv, root, out, coco_rows(root / "jax" / str(test_iter) / "validation"
                                      / "results.json")


def test_eval_cli_equals_jax(jax_eval, capsys):
    argv, root, want, want_rows = jax_eval
    capsys.readouterr()
    got = evaluate_detector.main([*argv, "--cpu", "--result-dir", str(root / "port"),
                                  "--split", "val", "--suffix", "tiny"])
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert last.keys() == {"mAP", "images", "avg_time_s"} and last["images"] == 4
    assert sum("Average Precision" in line or "Average Recall" in line for line in lines) == 12
    np.testing.assert_allclose(got["mAP"], want["mAP"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["stats"], want["stats"], rtol=0, atol=1e-6)
    rows = coco_rows(root / "port" / argv[-1] / "val" / "tiny" / "results.json")
    assert len(rows) > 0
    compare_coco_rows("eval CLI: port vs JAX", rows, want_rows, atol_box=1e-4, atol_score=1e-5)


def test_eval_cli_asks_for_cuda_by_default(coco_set, tmp_path, monkeypatch):
    (ann, images), _ = coco_set
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ("CornerNet_Squeeze", "CornerNet_Saccade"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            evaluate_detector.main([arch, "--annotations", ann, "--image-dir", images, "--tiny",
                                    "--random", "--result-dir", str(tmp_path)])
