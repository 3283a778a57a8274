"""Port parity: CornerNet-Saccade's two-stage inference against the JAX package.

The crops, the attention bookkeeping, the driver with stub decoders in both
protocols, and the tiny saccade model (seeded, and the trained fixture
results/saccade_tiny/CornerNet_Saccade_800) through the port's
``SaccadeDetector`` against ``make_saccade_decode_fn_fused`` +
``cornernet_saccade_inference``. Inputs are made by numpy from a seed; JAX
runs on the CPU.

Tolerances:
- ``crop_zoom`` (host cv2) exact; ``crop_zoom_batch`` within 1e-6 of the
  jitted ``_device_crop_zoom_batch`` on images in [0, 1] (XLA's fused
  program rounds the source coordinate differently, seen 7.9e-7) and equal
  to the same function evaluated op by op (``jax.disable_jit``);
- ``att_nms``, ``decode_atts``, ``get_ref_locs``, ``location_nms`` exact,
  tied scores included;
- the driver with stub decoders: the same boxes within 1e-4 px and scores
  within 1e-5, per class;
- the tiny model, seeded and trained, float32: equal counts per class,
  boxes within 1e-4 px, scores within 1e-5.
"""

import os
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from object_keypoints_tpu.inference import saccade as jsaccade  # noqa: E402
from object_keypoints_tpu.models.cornernet import CornerNetModel as JCornerNetModel  # noqa: E402
from object_keypoints_tpu.utils import config as jconfig  # noqa: E402
from object_keypoints_tpu_torch.inference import saccade  # noqa: E402
from object_keypoints_tpu_torch.models import cornernet  # noqa: E402
from object_keypoints_tpu_torch.serving import weights  # noqa: E402
from object_keypoints_tpu_torch.utils import config  # noqa: E402
from test_torch_port_model import randomize  # noqa: E402

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def assert_boxes_equal(got, want, atol_box=1e-4, atol_score=1e-5):
    """{class: (n, 5)} results: the same classes and counts, boxes and
    scores within the tolerances."""
    assert got.keys() == want.keys()
    for j in want:
        assert got[j].shape == want[j].shape, (j, got[j].shape, want[j].shape)
        np.testing.assert_allclose(got[j][:, :4], want[j][:, :4], rtol=0, atol=atol_box)
        np.testing.assert_allclose(got[j][:, 4], want[j][:, 4], rtol=0, atol=atol_score)


# --- crops -----------------------------------------------------------------

# (center [y, x], size [h, w]) on a 96x120 image into a 64x64 canvas: the
# four cases of tests/test_saccade.py (interior, border-clipped, zoom-out),
# a window past every border, cty = 0 with a one-pixel height (the patch is
# empty and the clamp falls to -2), windows centred outside the image, and
# the driver's pad rows (centre (1, 1), scale 1: the input size)
CROP_CASES = {
    "interior": ((48.0, 60.0), (32, 32)),
    "border_clipped": ((8.0, 8.0), (40, 40)),
    "corner": ((80.0, 110.0), (64, 48)),
    "zoom_out": ((48.0, 60.0), (128, 160)),
    "past_every_border": ((47.5, 59.5), (400, 500)),
    "top_row_one_pixel": ((0.0, 50.0), (1, 30)),
    "left_column_one_pixel": ((50.0, 0.0), (30, 1)),
    "bottom_row_one_pixel": ((95.0, 60.0), (1, 3)),
    "centred_above_left": ((-5.0, -7.0), (20, 20)),
    "centred_below_right": ((120.0, 130.0), (30, 30)),
    "pad_row": ((1.0, 1.0), (64, 64)),
}


def crop_inputs(names):
    image = np.random.default_rng(0).uniform(0, 1, size=(96, 120, 3)).astype(np.float32)
    centers = np.array([CROP_CASES[n][0] for n in names], np.float32)
    sizes = np.array([CROP_CASES[n][1] for n in names], np.float32)
    return image, centers, sizes


@pytest.mark.parametrize("name", sorted(CROP_CASES))
def test_crop_zoom_equals_jax(name):
    image, centers, sizes = crop_inputs([name])
    size = (int(sizes[0, 0]), int(sizes[0, 1]))
    got = saccade.crop_zoom(image, centers[0], size, (64, 64))
    want = jsaccade.crop_zoom(image, centers[0], size, (64, 64))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_crop_zoom_batch_equals_jax():
    names = sorted(CROP_CASES)
    image, centers, sizes = crop_inputs(names)
    got, got_off = saccade.crop_zoom_batch(torch.from_numpy(image), torch.from_numpy(centers),
                                           torch.from_numpy(sizes), (64, 64))
    assert got.shape == (len(names), 64, 64, 3) and got.dtype == torch.float32
    want, want_off = jsaccade._device_crop_zoom_batch(image, centers, sizes, (64, 64))
    np.testing.assert_array_equal(got_off.numpy(), np.asarray(want_off))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    with jax.disable_jit():
        eager, _ = jsaccade._crop_all_fn(96, 120, 64, 64)(
            jnp.asarray(image), jnp.asarray(centers), jnp.asarray(sizes))
    np.testing.assert_array_equal(got.numpy(), np.asarray(eager))
    for i, name in enumerate(names):  # the empty patches stay black
        if "one_pixel" in name:
            assert not got[i].any(), name


def test_crop_zoom_batch_reads_no_index_out_of_range():
    """Every gather index the batch computes lies in the image: a CUDA
    gather out of range is a device-side assert, where JAX clamps."""
    image, centers, sizes = crop_inputs(sorted(CROP_CASES))
    seen = []
    real_index = saccade._gather_index

    def spy(i, n):
        out = real_index(i, n)
        seen.append((int(i.min()), int(out.min()), int(out.max()), n))
        return out

    saccade._gather_index = spy
    try:
        saccade.crop_zoom_batch(torch.from_numpy(image), torch.from_numpy(centers),
                                torch.from_numpy(sizes), (64, 64))
    finally:
        saccade._gather_index = real_index
    assert min(s[0] for s in seen) < 0  # the one-pixel patches reach -2
    assert all(0 <= lo and hi < n for _, lo, hi, n in seen)


# --- attention bookkeeping ---------------------------------------------------

SACCADE_DB = {
    "categories": 2, "input_size": [64, 64], "output_sizes": [[16, 16]],
    "init_sizes": [32, 48], "att_max_crops": 6, "att_thresholds": [0.3, 0.3, 0.3],
    "att_scales": [[1, 2], [1.5, 2], [1, 2]], "att_ratios": [8, 4], "att_nms_ks": [3, 3],
    "nms_algorithm": "exp_soft_nms", "max_per_image": 10, "ref_dets": True, "top_k": 4,
    "num_dets": 6, "nms_threshold": 0.5,
}


def random_atts(seed, n=3):
    """Two NHWC attention maps per view with plateaus of tied values."""
    rng = np.random.default_rng(seed)
    atts = [np.round(rng.uniform(0, 1, (n, s, s, 1)), 1).astype(np.float32) for s in (8, 16)]
    return atts


def test_att_nms_equals_jax():
    atts = random_atts(0)
    got = saccade.att_nms(atts, [3, 5])
    want = jsaccade.att_nms([jnp.asarray(a) for a in atts], [3, 5])
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("ignore_same", [False, True])
def test_decode_atts_equals_jax(ignore_same):
    atts = random_atts(1)
    scales = np.array([0.25, 0.5, 3.0], np.float32)
    offsets = np.array([[0, 0], [-12, 5], [30, 40]], np.float32)
    got = saccade.decode_atts(config.DetectionConfig(SACCADE_DB), atts, [1, 2], scales, offsets,
                              120, 160, 0.3, ignore_same=ignore_same)
    want = jsaccade.decode_atts(jconfig.DetectionConfig(SACCADE_DB), atts, [1, 2], scales,
                                offsets, 120, 160, 0.3, ignore_same=ignore_same)
    assert len(want) > 10
    np.testing.assert_array_equal(got, want)


def test_get_ref_locs_and_location_nms_equal_jax():
    rng = np.random.default_rng(2)
    xy = rng.uniform(0, 200, (40, 2))
    wh = rng.choice([10.0, 50.0, 150.0], (40, 1)) * rng.uniform(0.5, 1.5, (40, 2))
    dets = np.concatenate([xy, xy + wh, np.round(rng.uniform(0, 1, (40, 1)), 1),
                           np.zeros((40, 3))], axis=1).astype(np.float32)
    np.testing.assert_array_equal(saccade.get_ref_locs(dets), jsaccade.get_ref_locs(dets))
    locs = np.concatenate([rng.uniform(0, 100, (60, 2)), rng.choice([0.5, 0.55, 1.0], (60, 1)),
                           np.round(rng.uniform(0, 1, (60, 1)), 1)], axis=1).astype(np.float32)
    assert len(np.unique(locs[:, 3])) < 20  # many tied scores
    got, want = saccade.location_nms(locs, thresh=16), jsaccade.location_nms(locs, thresh=16)
    assert 1 < len(want) < len(locs)
    np.testing.assert_array_equal(got, want)
    assert saccade.location_nms(locs[:0]).shape == (0, 4)


# --- the driver with stub decoders --------------------------------------------

def stub_outputs(n, call, no_att, n_dets=6):
    """Planted detections and attention maps for the n crops of the call-th
    call, each row a function of (call, row): boxes of both classes in
    output-map pixels, some rejected (-1), and attention peaks (tied 0.9s
    among them)."""
    dets = np.full((n, n_dets, 8), -1.0, np.float32)
    keys = [(7 * call + r) % 5 for r in range(n)]
    for r, k in enumerate(keys):
        dets[r, 0] = [2.0 + k, 2.0, 8.0 + k, 9.0, 0.9 - 0.05 * k, 0.8, 0.8, k % 2]
        dets[r, 1] = [2.5 + k, 2.5, 8.5 + k, 9.5, 0.7, 0.7, 0.7, k % 2]
        dets[r, 2] = [10.0, 1.0, 14.0, 6.0 + k, 0.55, 0.5, 0.5, 1 - k % 2]
    if no_att:
        return dets, None
    a1 = np.zeros((n, 8, 8, 1), np.float32)
    a2 = np.zeros((n, 16, 16, 1), np.float32)
    for r, k in enumerate(keys):
        a1[r, 2 + k % 4, 3, 0] = 0.9
        a1[r, 6, 1 + k % 4, 0] = 0.9
        a2[r, 12, 4 + 2 * (k % 4), 0] = 0.6
    return dets, [a1, a2]


def split_stub(calls, wrap=np.asarray):
    def decode_fn(images, no_att):
        dets, atts = stub_outputs(len(images), len(calls), no_att)
        calls.append((len(images), no_att))
        return wrap(dets), None if atts is None else [wrap(a) for a in atts]
    return decode_fn


def fused_stub(calls, wrap=np.asarray):
    def decode_fn(image, centers, sizes, no_att):
        centers, sizes = np.asarray(centers), np.asarray(sizes).astype(np.int32)
        dets, atts = stub_outputs(len(centers), len(calls), no_att)
        calls.append((len(centers), no_att))
        cty, ctx = centers[:, 0].astype(np.int32), centers[:, 1].astype(np.int32)
        offsets = np.stack([cty - sizes[:, 0] // 2, ctx - sizes[:, 1] // 2], 1).astype(np.float32)
        return (wrap(dets), None if atts is None else [wrap(a) for a in atts], wrap(offsets))
    decode_fn.crop_fused = decode_fn.att_nms_fused = True
    return decode_fn


def stub_image():
    rng = np.random.default_rng(4)
    image = rng.integers(0, 60, (120, 160, 3)).astype(np.uint8)
    image[30:70, 40:100] = 200
    return image


@pytest.mark.parametrize("route", ["split", "host_crops", "fused"])
def test_driver_with_stub_decoders_equals_jax(route):
    db = dict(SACCADE_DB, att_max_crops=30)
    make = fused_stub if route == "fused" else split_stub
    ours, theirs = [], []
    stats = []
    got = saccade.cornernet_saccade_inference(
        config.DetectionConfig(db), make(ours), stub_image(), device_crops=route != "host_crops",
        device="cpu", stats=stats)
    want = jsaccade.cornernet_saccade_inference(
        jconfig.DetectionConfig(db), make(theirs, jnp.asarray), stub_image(),
        device_crops=route != "host_crops")
    assert_boxes_equal(got, want)
    assert sum(len(v) for v in got.values()) > 3
    assert [n for n, _ in ours] == [n for n, _ in theirs] and len(ours) == 4
    # the stages' crops (padded to a power-of-two bucket when fused)
    assert stats[0]["crops"] == 2 and all(s["crops"] > 1 for s in stats[1:-1])
    assert [n for n, _ in ours] == [s["bucket"] for s in stats[:-1]]
    if route == "fused":
        assert [s["bucket"] for s in stats[:-1]] == [
            saccade.crop_bucket(s["crops"]) for s in stats[:-1]]
    assert stats[-1]["stage"] == "nms" and stats[-1]["steps"] > 0


@pytest.mark.parametrize("route", ["split", "fused"])
def test_no_attention_fetch_on_the_stage_where_the_crops_run_out(route):
    """att_max_crops stops the loop after stage 2 of 3: the port asks that
    stage for no attention maps (the JAX driver fetches them and reads
    nothing), and the boxes stay the same."""
    db = dict(SACCADE_DB, att_max_crops=5)
    make = fused_stub if route == "fused" else split_stub
    ours, theirs = [], []
    got = saccade.cornernet_saccade_inference(config.DetectionConfig(db), make(ours),
                                              stub_image(), device="cpu")
    want = jsaccade.cornernet_saccade_inference(jconfig.DetectionConfig(db),
                                                make(theirs, jnp.asarray), stub_image())
    assert_boxes_equal(got, want)
    assert [n for n, _ in ours] == [n for n, _ in theirs]
    assert len(ours) == 2 and len(db["att_thresholds"]) == 3  # stopped by the crop count
    assert [no_att for _, no_att in ours] == [False, True]
    assert [no_att for _, no_att in theirs] == [False, False]


def test_final_soft_nms_uses_sigma_0_7(monkeypatch):
    """Overlapping boxes of one class: the driver's soft-NMS runs at sigma
    0.7, as the JAX package's; at the 0.5 default the same run misses the
    JAX package's scores (by ~7e-3 here)."""
    db = dict(SACCADE_DB, att_max_crops=30, nms_threshold=0.3, max_per_image=100)

    def run():
        return saccade.cornernet_saccade_inference(config.DetectionConfig(db), fused_stub([]),
                                                   stub_image(), device="cpu")

    want = jsaccade.cornernet_saccade_inference(jconfig.DetectionConfig(db),
                                                fused_stub([], jnp.asarray), stub_image())
    assert_boxes_equal(run(), want)
    monkeypatch.setattr(saccade, "NMS_SIGMA", 0.5)
    with pytest.raises(AssertionError):
        assert_boxes_equal(run(), want)


# --- the tiny model ------------------------------------------------------------

def tiny_saccade_db(**over):
    _, db = config.load_cfg(config.CONFIG_DIR / "CornerNet_Saccade.json")
    return {**db, **config.tiny_db_overrides("CornerNet_Saccade"), **over}


def planted_tiny(seed=0, categories=4, heat_gain=3.0, att_gain=4.0):
    """A seeded tiny saccade model, JAX and port on the same weights: random
    BatchNorm, one heat kernel shared by every class (x heat_gain, biases
    -2.19 + 0.01 c) so that corners pair, and attention output kernels x
    att_gain with bias 0 so that stage 2 gets a bucket of crops."""
    arch = cornernet.tiny_arch("CornerNet_Saccade")
    jm = JCornerNetModel(categories=categories, **arch)
    variables = jm.init({"params": jax.random.key(seed)}, jnp.zeros((1, 64, 64, 3)))
    variables = randomize(jax.tree_util.tree_map(np.asarray, variables),
                          np.random.default_rng(seed))
    params = variables["params"]
    for side in ("tl", "br"):
        head = params[f"{side}_heat_0"]["conv_out"]
        head["kernel"] = np.repeat(head["kernel"][..., :1], categories, axis=-1) * heat_gain
        head["bias"] = np.float32(-2.19) + np.float32(0.01) * np.arange(categories,
                                                                          dtype=np.float32)
    for i in range(2):
        head = params[f"att_0_{i}"]["conv_out"]
        head["kernel"] = head["kernel"] * att_gain
        head["bias"] = np.zeros_like(head["bias"])
    model = cornernet.CornerNetModel(categories, **arch)
    model.load_state_dict(weights.cornernet_state_dict(variables, arch), strict=True)
    return jm, variables, model


@pytest.fixture(scope="module")
def seeded_tiny():
    db = tiny_saccade_db(categories=4, ae_threshold=100.0, top_k=12, num_dets=40,
                         max_per_image=100, att_max_crops=12)
    jm, variables, model = planted_tiny()
    image = np.random.default_rng(1).integers(0, 256, (96, 128, 3)).astype(np.uint8)
    jcfg = jconfig.DetectionConfig(db)
    want = jsaccade.cornernet_saccade_inference(
        jcfg, jsaccade.make_saccade_decode_fn_fused(jm, variables, jcfg), image)
    return db, model, image, want


@pytest.mark.parametrize("route", ["fused", "split"])
def test_tiny_saccade_equals_jax(seeded_tiny, route):
    db, model, image, want = seeded_tiny
    det = saccade.SaccadeDetector(model, config.DetectionConfig(db), device="cpu",
                                  dtype=torch.float32)
    stats = []
    got = saccade.cornernet_saccade_inference(det.config, getattr(det, route), image,
                                              device="cpu", stats=stats)
    assert_boxes_equal(got, want)
    assert sum(len(v) for v in want.values()) > 10
    crops = [s["crops"] for s in stats[:-1]]
    assert crops[0] == 2 and crops[1] > 4 and sum(crops[1:]) == db["att_max_crops"], crops
    named = det(image)
    for j, boxes in want.items():
        np.testing.assert_allclose(named[str(j)], boxes, rtol=0, atol=1e-4)


def test_trained_fixture_equals_jax():
    """The tiny saccade model trained on the synthetic COCO rectangles
    (results/saccade_tiny/CornerNet_Saccade_800, restored through the JAX
    package) on the 192x256 scene of benchmarks/run_all.py's trained
    saccade bench: stage 2 runs on real detections."""
    ocp = pytest.importorskip("orbax.checkpoint")
    snap = os.path.abspath(ROOT / "results" / "saccade_tiny" / "CornerNet_Saccade_800")
    restored = ocp.PyTreeCheckpointer().restore(snap)
    variables = {"params": restored["params"], "batch_stats": restored["batch_stats"]}
    db = tiny_saccade_db()
    jcfg = jconfig.DetectionConfig(db)
    from object_keypoints_tpu.models.cornernet import tiny_cornernet as jtiny_cornernet

    jm = jtiny_cornernet("CornerNet_Saccade", categories=jcfg["categories"])
    rng = np.random.default_rng(3)
    image = rng.integers(0, 40, size=(192, 256, 3)).astype(np.uint8)
    for (y, x, bh, bw, warm) in ((40, 60, 24, 30, True), (120, 180, 28, 22, False),
                                 (60, 200, 18, 26, True)):
        color = ((int(rng.integers(180, 255)), int(rng.integers(0, 80)),
                  int(rng.integers(0, 80))) if warm else
                 (int(rng.integers(0, 80)), int(rng.integers(0, 80)),
                  int(rng.integers(180, 255))))
        image[y:y + bh, x:x + bw] = color
    want = jsaccade.cornernet_saccade_inference(
        jcfg, jsaccade.make_saccade_decode_fn_fused(jm, variables, jcfg), image)

    model = cornernet.tiny_cornernet("CornerNet_Saccade", jcfg["categories"])
    model.load_state_dict(weights.cornernet_state_dict(
        jax.tree_util.tree_map(np.asarray, variables), cornernet.tiny_arch("CornerNet_Saccade")),
        strict=True)
    det = saccade.SaccadeDetector(model, config.DetectionConfig(db), device="cpu",
                                  dtype=torch.float32)
    stats = []
    got = saccade.cornernet_saccade_inference(det.config, det.fused, image, device="cpu",
                                              stats=stats)
    assert_boxes_equal(got, want)
    assert stats[1]["crops"] > 0 and sum(len(v) for v in want.values()) > 0


def test_saccade_detector_asks_for_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config.DetectionConfig(tiny_saccade_db())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        saccade.SaccadeDetector(cornernet.tiny_cornernet("CornerNet_Saccade"), cfg)
    with pytest.raises(ValueError, match="attention"):
        saccade.SaccadeDetector(cornernet.tiny_cornernet("CornerNet"), cfg, device="cpu")
