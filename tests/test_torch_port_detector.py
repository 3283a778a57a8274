"""Port parity: the single-pass detector's serve path against the JAX package.

Configs, the NMS family, the corner decode, the host geometry of
``cornernet_inference``, the whole ``Detector`` at tiny width and the detect CLI.
Inputs are made by numpy from a seed; JAX runs on the CPU.

Tolerances:
- configs: ``DetectionConfig`` and ``load_cfg`` equal on all four JSONs,
  which are byte-identical copies;
- ``bbox_overlaps`` within 1e-6, ``nms_mask`` equal;
- ``soft_nms_batch`` / ``soft_nms_merge_batch`` (methods 0/1/2, 5 and 7
  columns) within 1e-5 of the JAX batch over the same ``pad_class_dets``
  stack (the merge's weighted sums add in another order; seen 7.6e-6 on
  boxes of ~50 px), both run over the full pad; stopped after the largest
  class's count of real rows, the real rows equal the full loop's within
  the same 1e-5 (soft-NMS: exactly);
- ``decode_detections`` (kernel 1 and 3, ``no_border`` on and off, float32
  and bf16 heads) on the same heads in NHWC (JAX) and NCHW (port): classes
  exact, boxes and scores within 1e-5; exactly tied heats put the lower
  flat index first in both;
- ``crop_image`` / ``rescale_detections`` exact; ``cornernet_inference``
  with the planted decoders of tests/test_inference_driver.py: the same boxes
  within 1e-4 px and scores within 1e-5;
- the tiny ``Detector`` (Squeeze's fire hourglass without flip; the
  residual hourglass with flip; multi-scale with flip and merge) against
  the JAX ``Detector`` on the same image and weights, float32: equal counts
  per class, boxes within 1e-3 px, scores within 1e-5.
"""

import filecmp
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from object_keypoints_tpu.inference import detector as jdetector  # noqa: E402
from object_keypoints_tpu.models.cornernet import CornerNetModel as JCornerNetModel  # noqa: E402
from object_keypoints_tpu.ops import detection_decode as jdecode  # noqa: E402
from object_keypoints_tpu.ops import nms as jnms  # noqa: E402
from object_keypoints_tpu.utils import config as jconfig  # noqa: E402
from object_keypoints_tpu_torch.cli import detect as detect_cli  # noqa: E402
from object_keypoints_tpu_torch.inference import detector  # noqa: E402
from object_keypoints_tpu_torch.models import cornernet  # noqa: E402
from object_keypoints_tpu_torch.ops import detection_decode, nms  # noqa: E402
from object_keypoints_tpu_torch.serving import weights  # noqa: E402
from object_keypoints_tpu_torch.utils import config  # noqa: E402
from test_torch_port_model import randomize  # noqa: E402

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["CornerNet", "CornerNet-multi_scale", "CornerNet_Saccade", "CornerNet_Squeeze"]


# --- configs ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_jax(arch):
    src = ROOT / "object_keypoints_tpu" / "configs" / f"{arch}.json"
    ours = config.CONFIG_DIR / f"{arch}.json"
    assert filecmp.cmp(src, ours, shallow=False)
    system, db = config.load_cfg(ours)
    assert (system, db) == jconfig.load_cfg(str(src))
    got, want = config.DetectionConfig(db).configs, jconfig.DetectionConfig(db).configs
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for name in (arch, "CornerNet_Saccade-tiny"):
        assert config.tiny_db_overrides(name) == jconfig.tiny_db_overrides(name)


# --- NMS -------------------------------------------------------------------

def random_dets(rng, n, width=7, extent=60.0):
    xy = rng.uniform(0, extent, (n, 2))
    wh = rng.uniform(4, 30, (n, 2))
    cols = [xy, xy + wh, rng.uniform(0.01, 1, (n, 1)), rng.uniform(0.05, 1, (n, 2))]
    return np.concatenate(cols, axis=1).astype(np.float32)[:, :width]


def class_stack(seed, width, counts=(5, 17, 0, 30, 1)):
    rng = np.random.default_rng(seed)
    per_class = [random_dets(rng, n, width) for n in counts]
    return per_class, jnms.pad_class_dets(per_class, 32, width=width)


def test_bbox_overlaps_and_nms_mask_equal_jax():
    rng = np.random.default_rng(0)
    a, b = random_dets(rng, 40, 5), random_dets(rng, 23, 5)
    np.testing.assert_allclose(
        nms.bbox_overlaps(torch.from_numpy(a[:, :4]), torch.from_numpy(b[:, :4])).numpy(),
        np.asarray(jnms.bbox_overlaps(a[:, :4], b[:, :4])), rtol=0, atol=1e-6)
    a[::5, 4] = a[1::5, 4]  # equal scores keep their input order
    for threshold in (0.3, 0.5):
        np.testing.assert_array_equal(nms.nms_mask(torch.from_numpy(a), threshold).numpy(),
                                      np.asarray(jnms.nms_mask(jnp.asarray(a), threshold)))


@pytest.mark.parametrize("method", [0, 1, 2])
def test_soft_nms_batch_equals_jax(method):
    per_class, padded = class_stack(method, 5)
    want = np.asarray(jnms.soft_nms_batch(jnp.asarray(padded), method=method))
    full = nms.soft_nms_batch(torch.from_numpy(padded), method=method).numpy()
    np.testing.assert_allclose(full, want, rtol=0, atol=1e-5)
    steps = max(len(d) for d in per_class)
    early = nms.soft_nms_batch(torch.from_numpy(padded), method=method, steps=steps).numpy()
    for j, d in enumerate(per_class):
        np.testing.assert_array_equal(early[j, :len(d)], full[j, :len(d)])
    single = nms.soft_nms(torch.from_numpy(per_class[3][:, :5]), method=method).numpy()
    np.testing.assert_allclose(
        single, np.asarray(jnms.soft_nms(per_class[3][:, :5], method=method)), rtol=0, atol=1e-5)


@pytest.mark.parametrize("width", [5, 7])
@pytest.mark.parametrize("method", [0, 1, 2])
def test_soft_nms_merge_batch_equals_jax(method, width):
    per_class, padded = class_stack(10 + method, width)
    want = np.asarray(jnms.soft_nms_merge_batch(jnp.asarray(padded), method=method,
                                                weight_exp=6.0))
    full = nms.soft_nms_merge_batch(torch.from_numpy(padded), method=method,
                                    weight_exp=6.0).numpy()
    # pad rows merge among themselves at -1e6 (width 5 gives them unit corner
    # scores): relative there, 1e-5 px on the real rows
    np.testing.assert_allclose(full, want, rtol=1e-5, atol=1e-5)
    steps = max(len(d) for d in per_class)
    early = nms.soft_nms_merge_batch(torch.from_numpy(padded), method=method, weight_exp=6.0,
                                     steps=steps).numpy()
    for j, d in enumerate(per_class):
        np.testing.assert_allclose(early[j, :len(d)], want[j, :len(d)], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(early[j, :len(d)], full[j, :len(d)])
    single = nms.soft_nms_merge(torch.from_numpy(per_class[3]), method=method).numpy()
    np.testing.assert_allclose(single, np.asarray(jnms.soft_nms_merge(per_class[3], method=method)),
                               rtol=0, atol=1e-5)


def test_merge_keeps_a_zero_corner_score_row_finite():
    """The JAX package's 1e-12 guard: a selected box whose corner scores are
    0 merges to a finite box instead of poisoning the loop with NaN."""
    d = random_dets(np.random.default_rng(3), 6)
    d[0, 4], d[0, 5:] = 0.99, 0.0
    got = nms.soft_nms_merge(torch.from_numpy(d)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(jnms.soft_nms_merge(d)), rtol=0, atol=1e-5)


# --- corner decode ---------------------------------------------------------

def random_heads(seed, n=2, c=3, h=12, w=16):
    rng = np.random.default_rng(seed)
    heads = [rng.normal(size=(n, h, w, c)) * 2, rng.normal(size=(n, h, w, c)) * 2,
             rng.normal(size=(n, h, w, 1)) * 0.4, rng.normal(size=(n, h, w, 1)) * 0.4,
             rng.uniform(0, 1, (n, h, w, 2)), rng.uniform(0, 1, (n, h, w, 2))]
    return [a.astype(np.float32) for a in heads]


def decode_both(heads, dtype, **kw):
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    want = np.asarray(jdecode.decode_detections(*(jnp.asarray(a, jdtype) for a in heads), **kw))
    ours = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(dtype)
            for a in heads]
    return detection_decode.decode_detections(*ours, **kw).numpy(), want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("no_border", [False, True])
@pytest.mark.parametrize("kernel", [1, 3])
def test_decode_detections_equals_jax(kernel, no_border, dtype):
    heads = random_heads(kernel + 2 * no_border)
    got, want = decode_both(heads, dtype, K=20, kernel=kernel, ae_threshold=0.5, num_dets=60,
                            no_border=no_border)
    assert got.shape == want.shape == (2, 60, 8)
    assert (got[..., 4] > -1).sum() > 10  # some pairings survive
    np.testing.assert_array_equal(got[..., 7], want[..., 7])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_decode_ties_put_the_lower_index_first():
    """Flat heats tie every corner: both top-Ks take flat indices 0..K-1
    (class 0, row 0), and the rejected pairings' plateau of -1 keeps its
    order too."""
    heads = random_heads(7, c=2)
    heads[0][:] = 0.5
    heads[1][:] = 0.5
    got, want = decode_both(heads, torch.float32, K=8, kernel=1, ae_threshold=0.3,
                            num_dets=64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    _, pix, classes, ys, xs = detection_decode.topk_corners(
        torch.sigmoid(torch.from_numpy(heads[0].transpose(0, 3, 1, 2)).contiguous()), 8)
    assert (pix == torch.arange(8)).all() and not classes.any() and not ys.any()
    assert (got[..., 4] == -1).any()


def test_decode_takes_the_heads_of_the_port_model():
    model = cornernet.tiny_cornernet("CornerNet", categories=3,
                                     generator=torch.Generator().manual_seed(0)).eval()
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        dets, tl_heat, br_heat, tl_tag, br_tag = model(x, test=True, K=5, num_dets=7)
    assert dets.shape == (2, 7, 8) and dets.dtype == torch.float32
    assert tl_heat.shape == br_heat.shape == (2, 3, 16, 16)
    assert tl_tag.shape == br_tag.shape == (2, 1, 16, 16)


# --- host geometry and cornernet_inference ----------------------------------

def test_crop_and_rescale_equal_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (37, 53, 3), dtype=np.uint8)
    for center, size in (((18, 26), (63, 63)), ((18, 26), (31, 127)), ((5, 40), (127, 63))):
        got, want = detector.crop_image(img, center, size), jdetector.crop_image(img, center, size)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    dets = rng.uniform(0, 40, (1, 9, 8)).astype(np.float32)
    args = (np.array([[0.25, 0.3]], np.float32), np.array([[3.0, 60.0, 7.0, 70.0]], np.float32),
            np.array([[50.0, 60.0]], np.float32))
    np.testing.assert_array_equal(detector.rescale_detections(dets.copy(), *args),
                                  jdetector.rescale_detections(dets.copy(), *args))


def planted_config(**over):
    return {"categories": 2, "input_size": [128, 128], "output_sizes": [[32, 32]],
            "test_scales": [1], "test_flipped": False, "top_k": 8, "num_dets": 8,
            "nms_algorithm": "exp_soft_nms", "max_per_image": 10, **over}


def planted_decoder(rows):
    """The planted decoders of tests/test_inference_driver.py: fixed rows, the
    rest rejected (-1)."""
    def decode_fn(images, K, ae_threshold, kernel, num_dets):
        dets = np.full((images.shape[0], num_dets, 8), -1.0, np.float32)
        dets[:, :len(rows)] = rows
        return dets
    return decode_fn


CLUSTER = [[4.0, 4.0, 12.0, 12.0, 0.90, 0.8, 0.8, 0.0],
           [4.5, 4.5, 12.5, 12.5, 0.80, 0.7, 0.7, 0.0],
           [5.0, 5.0, 13.0, 13.0, 0.70, 0.6, 0.6, 0.0],
           [20.0, 20.0, 28.0, 28.0, 0.60, 0.9, 0.9, 0.0],
           [4.0, 20.0, 12.0, 28.0, 0.50, 0.5, 0.5, 1.0],
           [20.0, 4.0, 28.0, 12.0, 0.40, 0.5, 0.5, 1.0]]


@pytest.mark.parametrize("case", ["one_box", "merge_cap", "flip_multi_scale"])
def test_cornernet_inference_equals_jax_with_planted_decoders(case):
    rows, over = {
        "one_box": ([[4.0, 4.0, 12.0, 12.0, 0.9, 0.9, 0.9, 0.0]], dict(top_k=5, num_dets=4)),
        "merge_cap": (CLUSTER, dict(max_per_image=3, merge_bbox=True, weight_exp=6.0)),
        "flip_multi_scale": (CLUSTER, dict(test_flipped=True, test_scales=[0.5, 1, 1.5],
                                           merge_bbox=True, weight_exp=10,
                                           nms_algorithm="linear_soft_nms")),
    }[case]
    cfg_ours = config.DetectionConfig(planted_config(**over))
    cfg_jax = jconfig.DetectionConfig(planted_config(**over))
    image = np.zeros((100, 100, 3), np.uint8)
    got = detector.cornernet_inference(cfg_ours, planted_decoder(rows), image, device="cpu")
    decode = planted_decoder(rows)
    want = jdetector.cornernet_inference(
        cfg_jax, lambda images, **kw: jnp.asarray(decode(np.asarray(images), **kw)), image)
    assert got.keys() == want.keys() == {1, 2}
    assert sum(len(v) for v in got.values()) > 0
    for j in want:
        assert got[j].shape == want[j].shape, j
        np.testing.assert_allclose(got[j][:, :4], want[j][:, :4], rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[j][:, 4], want[j][:, 4], rtol=0, atol=1e-5)
    if case == "one_box":
        assert got[1].shape[0] == 1 and got[2].shape[0] == 0
        assert got[1][0, 4] == pytest.approx(0.9, rel=1e-3)
    if case == "merge_cap":
        assert sum(len(v) for v in got.values()) <= 3 + 1


def test_class_soft_nms_reports_its_steps():
    dets = np.array(CLUSTER, np.float32)
    cfg = config.DetectionConfig(planted_config())
    boxes, steps = detector.class_soft_nms(cfg, dets, device="cpu")
    assert steps == 4 and len(boxes[1]) == 4 and len(boxes[2]) == 2
    boxes, steps = detector.class_soft_nms(cfg, np.full((3, 8), -1.0, np.float32), device="cpu")
    assert steps == 0 and all(len(b) == 0 for b in boxes.values())


# --- the Detector at tiny width ---------------------------------------------

DETECTOR_CASES = {
    # (model, db overrides, heat gain, seed): the gain scales a heat kernel
    # shared by every class, so that random weights pair corners of one class
    "squeeze": (cornernet.tiny_arch("CornerNet_Squeeze"), {"test_flipped": False}, -30.0, 1),
    "residual_flip": (dict(stacks=1, levels=2, dims=(16, 16, 32), mods=(1, 1, 1),
                           hourglass="residual", stem_residuals=1, cnv_dim=16),
                      {"test_flipped": True}, -30.0, 0),
    "multi_scale_merge": (cornernet.tiny_arch("CornerNet_Squeeze"),
                          {"test_scales": [0.75, 1, 1.5], "merge_bbox": True, "weight_exp": 10},
                          -30.0, 1),
}


def tiny_detectors(name, categories=4):
    arch, over, gain, seed = DETECTOR_CASES[name]
    db = {**config.tiny_db_overrides("CornerNet"), "categories": categories, "top_k": 12,
          "num_dets": 40, "max_per_image": 100, "ae_threshold": 100.0, **over}
    rng = np.random.default_rng(seed)
    jm = JCornerNetModel(categories=categories, **arch)
    variables = jm.init({"params": jax.random.key(0)}, jnp.zeros((1, 64, 64, 3)))
    variables = randomize(jax.tree_util.tree_map(np.asarray, variables), rng)
    for side in ("tl", "br"):
        head = variables["params"][f"{side}_heat_0"]["conv_out"]
        head["kernel"] = np.repeat(head["kernel"][..., :1], categories, axis=-1) * gain
        head["bias"] = np.float32(-2.19) + np.float32(0.01) * np.arange(categories,
                                                                          dtype=np.float32)
    model = cornernet.CornerNetModel(categories, **arch)
    model.load_state_dict(weights.cornernet_state_dict(variables, arch), strict=True)
    ours = detector.Detector(model, config.DetectionConfig(db), device="cpu",
                             dtype=torch.float32)
    return ours, jdetector.Detector(jm, variables, jconfig.DetectionConfig(db)), rng


@pytest.mark.parametrize("name", sorted(DETECTOR_CASES))
def test_tiny_detector_equals_jax(name):
    ours, theirs, rng = tiny_detectors(name)
    image = rng.integers(0, 256, (96, 120, 3), dtype=np.uint8)
    got, want = ours(image), theirs(image)
    assert got.keys() == want.keys() == {"1", "2", "3", "4"}
    assert all(len(v) for v in got.values())  # every class has detections
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key][:, :4], want[key][:, :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(got[key][:, 4], want[key][:, 4], rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_detector_frames_are_contiguous_nchw(dtype):
    """The stem kernel takes contiguous NCHW frames only. A float32 batch of
    one frame (``scale_batch`` adds its batch axis with stride 0) came back
    from ``Detector.frames`` as a channels-last view, which the card's stem
    refused."""
    model = cornernet.tiny_cornernet("CornerNet_Squeeze")
    det = detector.Detector(model, config.DetectionConfig(config.tiny_db_overrides("CornerNet")),
                            device="cpu", dtype=dtype)
    image = np.random.default_rng(0).integers(0, 256, (96, 120, 3), dtype=np.uint8)
    batch, _ = detector.scale_batch(dict(det.config.configs, test_flipped=False), image, 1)
    assert batch.shape[0] == 1
    for frames in (det.frames(batch), det.frames(np.concatenate([batch, batch]))):
        assert frames.dtype == dtype and frames.is_contiguous()
        np.testing.assert_array_equal(
            frames.float().numpy(), torch.from_numpy(batch).to(dtype).float().permute(0, 3, 1, 2)
            .expand(len(frames), -1, -1, -1).numpy())


def test_detector_asks_for_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = cornernet.tiny_cornernet("CornerNet")
    cfg = config.DetectionConfig(config.tiny_db_overrides("CornerNet"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        detector.Detector(model, cfg)
    with pytest.raises(ValueError, match="Saccade"):
        detector.Detector(cornernet.tiny_cornernet("CornerNet_Saccade"), cfg, device="cpu")


# --- the detect CLI ---------------------------------------------------------

def test_detect_cli_at_full_width_on_the_cpu(tmp_path, capsys):
    """CornerNet-Squeeze at full width on a 100x100 image (127x127 frames);
    a snapshot of the same seeded weights, Lightning- and DataParallel-
    wrapped, detects the same boxes."""
    image = np.random.default_rng(0).integers(0, 256, (100, 100, 3), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "img.png"), image)
    out = tmp_path / "det.jpg"
    named = detect_cli.main([str(tmp_path / "img.png"), "--random", "--cpu", "--out", str(out)])
    assert out.exists() and cv2.imread(str(out)).shape == (100, 100, 3)
    assert capsys.readouterr().out.strip().endswith(f"-> {out}")
    assert sorted(named, key=int) == [str(i) for i in range(1, 81)]
    for boxes in named.values():
        assert boxes.shape[1] == 5 and np.isfinite(boxes).all()

    model = cornernet.cornernet_squeeze(generator=torch.Generator().manual_seed(0))
    torch.save({"state_dict": {f"model.module.{k}": v for k, v in model.state_dict().items()}},
               tmp_path / "snap.ckpt")
    again = detect_cli.main([str(tmp_path / "img.png"), "--snapshot", str(tmp_path / "snap.ckpt"),
                             "--cpu", "--out", str(tmp_path / "det2.jpg")])
    for key in named:
        np.testing.assert_array_equal(again[key], named[key])


def test_detect_cli_refuses_what_it_cannot_run(tmp_path):
    with pytest.raises(SystemExit, match="--snapshot"):
        detect_cli.main([str(tmp_path / "img.png"), "--cpu"])
    with pytest.raises(SystemExit, match="--snapshot"):
        detect_cli.main([str(tmp_path / "img.png"), "--arch", "CornerNet_Saccade", "--cpu"])


def test_detect_cli_runs_saccade_at_full_width_on_the_cpu(tmp_path, capsys):
    """CornerNet-Saccade (116,969,339 parameters) through its two-stage
    inference on a 100x100 image: stage 1's two views of 255x255."""
    image = np.random.default_rng(0).integers(0, 256, (100, 100, 3), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "img.png"), image)
    out = tmp_path / "det.jpg"
    named = detect_cli.main([str(tmp_path / "img.png"), "--arch", "CornerNet_Saccade",
                             "--random", "--cpu", "--out", str(out)])
    assert out.exists() and cv2.imread(str(out)).shape == (100, 100, 3)
    assert capsys.readouterr().out.strip().endswith(f"-> {out}")
    assert sorted(named, key=int) == [str(i) for i in range(1, 81)]
    for boxes in named.values():
        assert boxes.shape[1] == 5 and np.isfinite(boxes).all()
