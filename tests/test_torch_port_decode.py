"""Port parity: peak extraction, association, camera geometry and the batched
object decode, against the JAX package on identical inputs.

Scenes are numpy-built Gaussian blob maps at keypoints projected through
config/calibration.yaml's left camera, mapped into 64x64 prediction space
by the serve path's camera chain (bench.py / scripts/eval_model.py). They
cover two clean objects, over-capacity cells (argmax for capacity 1,
k-means for capacity 3) with an outlier beyond the 20 px reject distance,
and exact ties (twin blobs, a flat plateau, all-zero maps), where the tie
order of ``lax.top_k`` decides which peaks are kept.

Tolerances: masks and assignments equal; 2D points within 1e-4 px; 3D
points within 1e-5 m (the ceilings of BASELINE.md are 1 px and 5 mm).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from object_keypoints_tpu.geometry import cameras as jcam  # noqa: E402
from object_keypoints_tpu.ops import associate as jassoc  # noqa: E402
from object_keypoints_tpu.ops import decode as jdecode  # noqa: E402
from object_keypoints_tpu.pipeline import decode_jit as jpipe  # noqa: E402
from object_keypoints_tpu_torch.geometry import cameras as cam  # noqa: E402
from object_keypoints_tpu_torch.ops import associate as assoc  # noqa: E402
from object_keypoints_tpu_torch.ops import decode  # noqa: E402
from object_keypoints_tpu_torch.pipeline import decode as pipe  # noqa: E402
from object_keypoints_tpu_torch.testing import bench_camera  # noqa: E402

torch.set_num_threads(1)

SIZE = 64
CONFIG = (1, 3)  # valve: one type-0 point and three type-1 points per object
MAX_PEAKS = 16


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def camera_chain(module, calibration_file, size=SIZE):
    """Left camera scaled/cut/scaled into size x size prediction space."""
    params = module.load_calibration_params(calibration_file)
    return bench_camera(module.FisheyeCamera(params["K"], params["D"], params["image_size"]), size)


@pytest.fixture(scope="module")
def camera(calibration_file):
    return camera_chain(cam, calibration_file)


def _object(c, type0=((0, -0.1, 0),), type1=((-0.1, 0.06, 0), (0, 0.1, 0), (0.1, 0.06, 0))):
    c = np.asarray(c, np.float64)
    return [(0, c, 1.0)] + [(1, c + d, 1.0) for d in type0] + [(2, c + d, 1.0) for d in type1]


def render(camera, blobs, sigma=1.5):
    """blobs: (channel, 3D point or None, amplitude, object id or None, pixel
    override or None). Returns probs (3, S, S), depth (3, S, S), offsets
    (2, 2, S, S) with every type pixel's offset pointing at the center of
    the object whose blob is nearest (zero for outliers)."""
    K, D = camera.K.astype(np.float32), camera.D.astype(np.float32)
    probs = np.zeros((3, SIZE, SIZE), np.float32)
    depth = np.zeros_like(probs)
    offsets = np.zeros((2, 2, SIZE, SIZE), np.float32)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float64)
    nearest = np.full((3, SIZE, SIZE), np.inf)
    centers = {}
    for ch, p, amp, obj, px in blobs:
        if px is None:
            px = np.asarray(jcam.fisheye_project(jnp.asarray(p, jnp.float32), K, D), np.float64)
        if ch == 0 and obj is not None:
            centers[obj] = px
    for ch, p, amp, obj, px in blobs:
        if px is None:
            px = np.asarray(jcam.fisheye_project(jnp.asarray(p, jnp.float32), K, D), np.float64)
        d2 = (xx - px[0]) ** 2 + (yy - px[1]) ** 2
        blob = amp * np.exp(-d2 / (2 * sigma**2))
        probs[ch] = np.maximum(probs[ch], np.where(blob > 1e-3, blob, 0.0))
        closer = d2 < nearest[ch]
        nearest[ch] = np.where(closer, d2, nearest[ch])
        depth[ch] = np.where(closer, p[2] if p is not None else 1.0, depth[ch])
        if ch > 0:
            target = centers.get(obj)
            for k in range(2):
                grid = (xx if k == 0 else yy) + 0.5
                off = (target[k] - grid) if target is not None else 0.0
                offsets[ch - 1, k] = np.where(closer, off, offsets[ch - 1, k])
    return probs, depth, offsets


def scenes(camera):
    clean = [(ch, p, a, i, None) for i, c in enumerate([(-0.17, 0.0, 0.8), (0.17, 0.02, 0.9)])
             for ch, p, a in _object(c)]
    # object 0 has two type-0 blobs (capacity 1: argmax) and four type-1
    # blobs (capacity 3: k-means); one type-1 outlier sits far from both
    over = [(ch, p, a, 0, None) for ch, p, a in _object(
        (-0.15, 0.0, 0.8), type1=((-0.1, 0.06, 0), (0, 0.1, 0), (0.1, 0.06, 0), (0.0, -0.02, 0)))]
    over += [(1, np.array([-0.15, 0.1, 0.8]), 0.8, 0, None)]
    over += [(ch, p, a, 1, None) for ch, p, a in _object((0.2, 0.0, 1.0))]
    over += [(2, None, 1.0, None, np.array([60.0, 4.0]))]
    # exact ties: twin center blobs at integer pixels, a flat plateau of 0.25
    # on the type-1 map, an all-zero type-0 map
    ties = [(0, None, 1.0, 0, np.array([20.0, 30.0])), (0, None, 1.0, 1, np.array([44.0, 30.0]))]
    maps = [render(camera, s) for s in (clean, over, ties)]
    probs, depth, offsets = (np.stack(m) for m in zip(*maps))
    probs[2, 2, 10:18, 40:52] = 0.25
    return probs, depth, offsets


@pytest.fixture(scope="module")
def scene(camera):
    return scenes(camera)


def jax_camera(camera):
    return jpipe.CameraArrays(*(jnp.asarray(a, jnp.float32)
                                for a in (camera.K, camera.D, camera.Kinv, camera.image_size)))


def close(got, want, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0, err_msg=what)


def equal(got, want, what):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=what)


def test_camera_chain_matches(camera, calibration_file):
    ref = camera_chain(jcam, calibration_file)
    for name in ("K", "Kinv", "D", "image_size"):
        equal(getattr(camera, name), getattr(ref, name), name)


def test_extract_peaks(scene):
    probs = scene[0]
    points, conf, valid = decode.extract_peaks(t(probs), MAX_PEAKS, 0.5)
    jp, jc, jv = jdecode.extract_peaks_batch(jnp.asarray(probs), max_peaks=MAX_PEAKS,
                                             threshold=0.5)
    equal(valid, jv, "valid")
    close(points, jp, 1e-4, "points")
    close(conf, jc, 1e-4, "confidence")
    assert valid[:2].sum().item() == (2 + 2 + 6) + (2 + 3 + 8)  # every blob found
    assert valid[2, 0].sum() == 2 and valid[2, 1].sum() == 0


def test_box_filter_and_nms_keep_tie_order():
    x = np.zeros((1, 12, 12), np.float32)
    x[0, 2:6, 2:6] = 0.25
    x[0, 8, 8] = 0.25
    for fn, jfn in ((decode.box_filter, jdecode.box_filter),
                    (decode.maxpool_nms, jdecode.maxpool_nms)):
        equal(fn(t(x)), jfn(jnp.asarray(x)[None])[0], fn.__name__)
    points, _, valid = decode.extract_peaks(t(x), 8, 0.0)
    jp, _, jv = jdecode.extract_peaks(jnp.asarray(x), max_peaks=8, threshold=0.0)
    equal(valid, jv, "valid")
    close(points, jp, 1e-6, "points")


def test_assign_to_centers(scene):
    probs, _, offsets = scene
    points, _, valid = decode.extract_peaks(t(probs), MAX_PEAKS, 0.5)
    jp, _, jv = jdecode.extract_peaks_batch(jnp.asarray(probs), max_peaks=MAX_PEAKS, threshold=0.5)
    got_a, got_c = assoc.assign_to_centers(points[:, 1:], valid[:, 1:], t(offsets),
                                           points[:, 0], valid[:, 0])
    want_a, want_c = jax.vmap(jassoc.assign_to_centers)(jp[:, 1:], jv[:, 1:],
                                                        jnp.asarray(offsets), jp[:, 0], jv[:, 0])
    equal(got_a, want_a, "assignment")
    close(got_c, want_c, 1e-4, "predicted centers")
    assert got_a.dtype == torch.int32
    assert (got_a[1] == -1).sum() > (~valid[1, 1:]).sum()  # the outlier is rejected


@pytest.mark.parametrize("capacity", [1, 3])
def test_resolve_capacity(capacity):
    """Cells with no, few (<= capacity) and too many (> capacity) points."""
    rng = np.random.default_rng(capacity)
    m = 8
    points = rng.uniform(0, 64, size=(6, m, 2)).astype(np.float32)
    conf = rng.uniform(0, 1, size=(6, m)).astype(np.float32)
    counts = [0, 1, capacity, capacity + 1, m - 1, m]
    mask = np.zeros((6, m), bool)
    for i, c in enumerate(counts):
        mask[i, rng.permutation(m)[:c]] = True
    out, out_valid = assoc.resolve_capacity(t(points), t(mask), t(conf), capacity)
    want, want_valid = jax.vmap(lambda p, k, c: jassoc.resolve_capacity(p, k, c, capacity))(
        jnp.asarray(points), jnp.asarray(mask), jnp.asarray(conf))
    equal(out_valid, want_valid, "valid")
    close(out, want, 1e-4, "points")
    assert out_valid.sum(-1).tolist() == [min(c, capacity) for c in counts]
    if capacity == 1:  # over capacity -> the most confident point
        best = np.argmax(np.where(mask[3], conf[3], -np.inf))
        close(out[3, 0], points[3, best], 0, "argmax")


def test_masked_kmeans():
    rng = np.random.default_rng(9)
    points = rng.uniform(0, 64, size=(4, 10, 2)).astype(np.float32)
    mask = rng.uniform(size=(4, 10)) > 0.3
    weights = rng.uniform(size=(4, 10)).astype(np.float32)
    got = assoc.masked_kmeans(t(points), t(mask), t(weights), 3)
    want = jax.vmap(lambda p, k, w: jassoc.masked_kmeans(p, k, w, 3))(
        jnp.asarray(points), jnp.asarray(mask), jnp.asarray(weights))
    close(got, want, 1e-4, "centers")


def test_undistort_and_unproject(camera):
    rng = np.random.default_rng(3)
    uv = rng.uniform(0, SIZE, size=(200, 2)).astype(np.float32)
    z = rng.uniform(0.3, 2.0, size=(200,)).astype(np.float32)
    K, D, Kinv = (np.asarray(a, np.float32) for a in (camera.K, camera.D, camera.Kinv))
    und = cam.fisheye_undistort_points(t(uv), t(K), t(D), P=t(K))
    close(und, jcam.fisheye_undistort_points(uv, K, D, P=K), 1e-4, "fisheye undistort")
    close(cam.unproject(und, t(z), t(Kinv)),
          jcam.unproject(jnp.asarray(und.numpy()), z, Kinv), 1e-5, "unproject")
    # the round trip lands back on the pixels
    p3d = cam.unproject(und, t(z), t(Kinv)).double()
    close(cam.fisheye_project(p3d, t(K).double(), t(D).double()), uv, 1e-3, "reproject")

    D_rt = np.array([-0.28, 0.07, 1e-4, -2e-4], np.float32)
    close(cam.radtan_undistort_points(t(uv), t(K), t(D_rt), P=t(K)),
          jcam.radtan_undistort_points(uv, K, D_rt, P=K), 1e-4, "radtan undistort")


def test_decode_objects_batch(scene, camera):
    probs, depth, offsets = scene
    got = pipe.decode_objects_batch(t(probs), t(depth), t(offsets),
                                    pipe.CameraArrays.from_camera(camera), CONFIG,
                                    max_peaks=MAX_PEAKS)
    want = jpipe.decode_objects_batch(jnp.asarray(probs), jnp.asarray(depth),
                                      jnp.asarray(offsets), jax_camera(camera), CONFIG,
                                      max_peaks=MAX_PEAKS)
    for name in pipe.DecodedObjects._fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert tuple(g.shape) == w.shape, name
        if g.dtype == torch.bool or name == "assignment":
            equal(g, w, name)
        else:
            close(g, w, 1e-5 if name.endswith("p3d") else 1e-4, name)
    # clean scene: two objects, each with its one type-0 and three type-1 points
    assert got.center_valid[0].sum() == 2
    assert got.keypoints_valid[0][got.center_valid[0]].sum().item() == 2 * (1 + 3)
    # over capacity: object cells are full, not overfull
    assert got.keypoints_valid[1].sum().item() == 2 * (1 + 3)

    one = pipe.decode_objects(t(probs[0]), t(depth[0]), t(offsets[0]),
                              pipe.CameraArrays.from_camera(camera), CONFIG, max_peaks=MAX_PEAKS)
    for name in pipe.DecodedObjects._fields:
        equal(getattr(one, name), getattr(got, name)[0], name)
