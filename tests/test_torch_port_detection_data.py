"""Port parity for the detector training data: corner and saccade targets,
detection augment, ``gather_tags`` and the train CLI's batch stream,
against the JAX package.

Every host function is a copy of the JAX package's and is held to it
exactly: the same inputs and ``numpy.random.Generator`` seeds give equal
arrays (``assert_array_equal``) and leave the generators in the same state.
``gather_tags`` (torch, NCHW) equals the JAX ``gather_tags`` (NHWC)
exactly: a gather computes nothing. The batch stream with one worker gives
the JAX script's batches (scripts/train_detector.py, imported unchanged)
bit for bit, for the CornerNet route (random crop, resize, clip, flip,
color jitter, lighting) and the saccade route (zoom, crop around an object,
flip, attention and validity targets); the JAX script stores the tag
indices as int32 (jax without x64) where the port keeps numpy's int64, so
values are compared, not dtypes.
"""

import importlib.util
import itertools
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

from object_keypoints_tpu.data import detection_augment as jaug  # noqa: E402
from object_keypoints_tpu.data import detection_targets as jtargets  # noqa: E402
from object_keypoints_tpu.utils.config import DetectionConfig as JDetectionConfig  # noqa: E402
from object_keypoints_tpu_torch.cli import train_detector as cli  # noqa: E402
from object_keypoints_tpu_torch.data import detection_augment as aug  # noqa: E402
from object_keypoints_tpu_torch.data import detection_targets as targets  # noqa: E402
from object_keypoints_tpu_torch.data.coco import CocoDetectionDataset  # noqa: E402
from object_keypoints_tpu_torch.data.synthetic import make_synthetic_coco_dataset  # noqa: E402
from object_keypoints_tpu_torch.utils.config import (  # noqa: E402
    CONFIG_DIR,
    DetectionConfig,
    load_cfg,
    tiny_db_overrides,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def jax_script():
    """scripts/train_detector.py as a module, unchanged."""
    spec = importlib.util.spec_from_file_location("jax_train_detector_script",
                                                  ROOT / "scripts" / "train_detector.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def assert_same(got, want, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            assert_same(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)) and not np.isscalar(want):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{what}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=what)


def random_dets(rng, n, h, w, categories=3):
    x0 = rng.uniform(-10, w - 5, n)
    y0 = rng.uniform(-10, h - 5, n)
    bw, bh = rng.uniform(2, w / 2, n), rng.uniform(2, h / 2, n)
    cls = rng.integers(1, categories + 1, n)
    return np.stack([x0, y0, x0 + bw, y0 + bh, cls], 1).astype(np.float32)


def same_rng(seed):
    return np.random.default_rng(seed), np.random.default_rng(seed)


def assert_rngs_agree(a, b):
    assert a.bit_generator.state == b.bit_generator.state


# ------------------------------------------------------------------ targets


@pytest.mark.parametrize("size,overlap", [((10, 12), 0.7), ((3, 40), 0.3), ((64, 64), 0.5),
                                          ((1.5, 2.5), 0.7)])
def test_gaussian_radius_equals_jax(size, overlap):
    assert targets.gaussian_radius(size, overlap) == jtargets.gaussian_radius(size, overlap)


@pytest.mark.parametrize("center,radius,k", [((5, 6), 3, 1.0), ((0, 0), 4, 0.5), ((15, 2), 6, 1.0),
                                             ((40, 40), 2, 1.0), ((3, 9), 0, 1.0)])
def test_draw_gaussian_equals_jax(center, radius, k):
    base = np.random.default_rng(radius).uniform(0, 0.5, (12, 16)).astype(np.float32)
    got, want = base.copy(), base.copy()
    targets.draw_gaussian(got, center, radius, k)
    jtargets.draw_gaussian(want, center, radius, k)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bump,rad,n", [(True, -1, 5), (False, -1, 4), (True, 2, 3), (True, -1, 0),
                                        (True, -1, 12)])
def test_render_corner_targets_equals_jax(bump, rad, n):
    rng = np.random.default_rng(n + 3 * bump + rad + 1)
    dets = random_dets(rng, n, 60, 80)
    dets[:, 0:4:2] = np.clip(dets[:, 0:4:2], 0, 79)
    dets[:, 1:4:2] = np.clip(dets[:, 1:4:2], 0, 59)
    kw = dict(gaussian_bump=bump, gaussian_iou=0.3, gaussian_rad=rad, max_tag_len=8)
    got = targets.render_corner_targets(dets, 3, (60, 80), (15, 20), **kw)
    want = jtargets.render_corner_targets(dets, 3, (60, 80), (15, 20), **kw)
    assert_same(got, want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k


@pytest.mark.parametrize("n", [0, 6])
def test_clip_to_border_equals_jax(n):
    dets = random_dets(np.random.default_rng(n), n, 40, 50)
    got, want = targets._clip_to_border(dets, (2, 38, 3, 45)), jtargets._clip_to_border(
        dets, (2, 38, 3, 45))
    assert_same(got, want)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("rand_crop", [False, True])
def test_saccade_ref_scale_equals_jax(seed, rand_crop):
    dets = random_dets(np.random.default_rng(seed), seed, 300, 300) * np.float32(
        [1.5, 1.5, 1.5, 1.5, 1])
    a, b = same_rng(seed)
    assert targets.saccade_ref_scale(dets, rand_crop, a) == jtargets.saccade_ref_scale(
        dets, rand_crop, b)
    assert_rngs_agree(a, b)


def test_create_attention_masks_equals_jax():
    dets = random_dets(np.random.default_rng(3), 20, 255, 255) * np.float32([1, 1, 1.4, 1.4, 1])
    args = ([[16, 16], [32, 32], [64, 64]], [16, 8, 4], [[96, 256], [32, 96], [0, 32]], dets)
    assert_same(targets.create_attention_masks(*args), jtargets.create_attention_masks(*args))


def saccade_configs():
    _, db = load_cfg(CONFIG_DIR / "CornerNet_Saccade.json")
    tiny = dict(db, **tiny_db_overrides("CornerNet_Saccade"), categories=3, min_scale=4)
    return {"tiny": tiny, "tiny_rand_crop": dict(tiny, rand_crop=True, rand_center=True),
            "tiny_rand_crop_no_center": dict(tiny, rand_crop=True, rand_center=False),
            "full": dict(db, categories=3)}


@pytest.mark.parametrize("cfg", sorted(saccade_configs()))
@pytest.mark.parametrize("seed", range(4))
def test_saccade_sample_equals_jax(cfg, seed):
    db = saccade_configs()[cfg]
    rng = np.random.default_rng(100 + seed)
    h, w = (96, 128) if cfg != "full" else (480, 640)
    image = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
    dets = random_dets(rng, 1 + seed * 2, h, w)
    a, b = same_rng(seed)
    got = targets.saccade_sample(image, dets.copy(), DetectionConfig(db), a, max_tag_len=16)
    want = jtargets.saccade_sample(image, dets.copy(), JDetectionConfig(db), b, max_tag_len=16)
    assert_same(got, want)
    assert_rngs_agree(a, b)


@pytest.mark.parametrize("shape", [(2, 3, 4, 5), (1, 80, 16, 16), (3, 1, 7, 9)])
def test_gather_tags_equals_jax(shape):
    rng = np.random.default_rng(sum(shape))
    n, c, h, w = shape
    feat = rng.normal(size=shape).astype(np.float32)
    tags = rng.integers(0, h * w, size=(n, 11))
    got = targets.gather_tags(torch.from_numpy(feat), torch.from_numpy(tags))
    want = jtargets.gather_tags(jnp.asarray(feat.transpose(0, 2, 3, 1)), jnp.asarray(tags))
    assert got.shape == (n, 11, c)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_tags_gradient_is_the_scatter_of_its_cotangent():
    """Repeated indices (two objects on one corner pixel) add their
    cotangents, as the reference's gather does."""
    feat = torch.zeros(1, 2, 3, 3, dtype=torch.float64, requires_grad=True)
    tags = torch.tensor([[4, 4, 0]])
    ct = torch.tensor([[[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]]], dtype=torch.float64)
    (targets.gather_tags(feat, tags) * ct).sum().backward()
    want = torch.zeros(1, 2, 9, dtype=torch.float64)
    want[0, :, 4] = torch.tensor([4.0, 6.0])
    want[0, :, 0] = torch.tensor([5.0, 6.0])
    torch.testing.assert_close(feat.grad.flatten(2), want, rtol=0, atol=0)


# ------------------------------------------------------------------ augment


def test_coco_pca_constants_equal_jax():
    np.testing.assert_array_equal(aug.COCO_EIG_VAL, jaug.COCO_EIG_VAL)
    np.testing.assert_array_equal(aug.COCO_EIG_VEC, jaug.COCO_EIG_VEC)


@pytest.mark.parametrize("border,size", [(128, 640), (128, 200), (64, 100), (32, 31)])
def test_get_border_equals_jax(border, size):
    assert aug._get_border(border, size) == jaug._get_border(border, size)


@pytest.mark.parametrize("seed", range(4))
def test_random_crop_equals_jax(seed):
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 255, (90 + 7 * seed, 120, 3)).astype(np.uint8)
    dets = random_dets(rng, 3, *image.shape[:2])
    a, b = same_rng(seed)
    scales = [0.6, 0.7, 0.8, 0.9, 1.0, 1.1, 1.2, 1.3]
    got = aug.random_crop(image, dets, scales, (64, 64), border=32, rng=a)
    want = jaug.random_crop(image, dets, scales, (64, 64), border=32, rng=b)
    assert_same(got, want)
    assert_rngs_agree(a, b)


@pytest.mark.parametrize("center,size,out", [((30, 40), (64, 64), None), ((0, 0), (31, 47), None),
                                             ((80, 100), (64, 64), (70, 72))])
def test_crop_image_around_equals_jax(center, size, out):
    image = np.random.default_rng(1).integers(0, 255, (90, 110, 3)).astype(np.uint8)
    assert_same(aug.crop_image_around(image, center, size, out),
                jaug.crop_image_around(image, center, size, out))


@pytest.mark.parametrize("n", [0, 4])
def test_resize_and_clip_equal_jax(n):
    rng = np.random.default_rng(n)
    image = rng.integers(0, 255, (48, 64, 3)).astype(np.uint8)
    dets = random_dets(rng, n, 48, 64)
    got, want = aug.resize_image(image, dets, (64, 64)), jaug.resize_image(image, dets, (64, 64))
    assert_same(got, want)
    assert_same(aug.clip_detections(got[0], got[1]), jaug.clip_detections(*want))


@pytest.mark.parametrize("seed", range(5))
def test_color_jitter_and_lighting_equal_jax(seed):
    image = np.random.default_rng(seed).uniform(0, 1, (20, 24, 3)).astype(np.float32)
    a, b = same_rng(seed)
    got = aug.lighting(aug.color_jitter(image.copy(), a), a)
    want = jaug.lighting(jaug.color_jitter(image.copy(), b), b)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(aug.grayscale(image), jaug.grayscale(image))
    assert_rngs_agree(a, b)


# ------------------------------------------------------------- batch stream


@pytest.fixture(scope="module")
def coco_sets(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    small = make_synthetic_coco_dataset(str(root / "small"), n_images=6, image_size=(64, 64), seed=0)
    wide = make_synthetic_coco_dataset(str(root / "wide"), n_images=6, image_size=(96, 128),
                                       seed=1)
    return {"small": small, "wide": wide}


def stream_config(route):
    if route == "cornernet":
        _, db = load_cfg(CONFIG_DIR / "CornerNet_Squeeze.json")
        return dict(db, input_size=[96, 96], output_sizes=[[24, 24]], border=32,
                    rand_crop=True, rand_color=True, lighting=True), "wide", False
    if route == "cornernet_tiny":
        _, db = load_cfg(CONFIG_DIR / "CornerNet_Squeeze.json")
        return dict(db, **tiny_db_overrides("CornerNet_Squeeze")), "small", False
    _, db = load_cfg(CONFIG_DIR / "CornerNet_Saccade.json")
    return {**db, **tiny_db_overrides("CornerNet_Saccade"), "rand_crop": True,
            "rand_color": True, "min_scale": 4}, "wide", True


@pytest.mark.parametrize("route", ["cornernet", "cornernet_tiny", "saccade"])
def test_batch_stream_equals_the_jax_script(coco_sets, route):
    db, which, saccade = stream_config(route)
    dataset = CocoDetectionDataset(*coco_sets[which])
    stream = cli.batch_stream(dataset, DetectionConfig(db), 3, 1, saccade=saccade)
    want_stream = jax_script().batch_stream(dataset, JDetectionConfig(db), 3, 1, saccade=saccade)
    got = list(itertools.islice(stream, 3))
    stream.close()
    want = list(itertools.islice(want_stream, 3))
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        assert all(isinstance(v, (np.ndarray, tuple)) for v in g.values())
        assert_same(g, {k: (tuple(np.asarray(a) for a in v) if isinstance(v, tuple)
                            else np.asarray(v)) for k, v in w.items()}, f"batch {i}")
    keys = {"images", "tl_heatmaps", "br_heatmaps", "tl_regrs", "br_regrs", "tl_tags", "br_tags",
            "tag_mask"}
    assert set(got[0]) == keys | ({"tl_valids", "br_valids", "attentions"} if saccade else set())
    assert got[0]["images"].dtype == np.float32 and got[0]["tl_tags"].dtype == np.int64
    assert any(g["tag_mask"].any() for g in got)


def test_batch_stream_workers_draw_their_own_seeds(coco_sets):
    """Worker i draws from default_rng(i): with two workers the batches are
    those of worker 0's and worker 1's streams, in some order."""
    db, which, _ = stream_config("cornernet_tiny")
    dataset = CocoDetectionDataset(*coco_sets[which])
    config = DetectionConfig(db)
    solo = [next(iter(cli.batch_stream(dataset, config, 2, 1)))]
    two = cli.batch_stream(dataset, config, 2, 2)
    got = list(itertools.islice(two, 10))
    two.close()
    assert any(np.array_equal(g["images"], solo[0]["images"]) for g in got)


def test_batch_stream_raises_a_worker_error(tmp_path):
    """A worker that fails raises on the consumer's side rather than
    leaving it waiting."""
    ann, images = make_synthetic_coco_dataset(str(tmp_path), n_images=2, image_size=(64, 64))
    dataset = CocoDetectionDataset(ann, images)
    (pathlib.Path(images) / "00000.jpg").unlink()
    (pathlib.Path(images) / "00001.jpg").unlink()
    db, _, _ = stream_config("cornernet_tiny")
    stream = cli.batch_stream(dataset, DetectionConfig(db), 2, 1)
    with pytest.raises(Exception):
        next(stream)
