"""Port parity for the data layer: target rendering, augmentation, the
sequence writer and ``SceneDataset``, against the JAX package.

Inputs are made from seeds with numpy; the sequence is one JAX-written
synthetic valve sequence (720x1280, 5 frames) that both packages read.

Tolerances:
- targets on the same points: heatmaps within 1e-6 (exp and the splat sums
  round differently), depth and centers within 1e-6 with equal support
  masks, against the JAX jitted renderer and its host twin;
- frames within 1e-6: both compute (x / 255 - mean) / std in float32, the
  JAX native path as (x * (1/255) - mean) * (1/std), up to 2 ulps apart;
- example dicts built from the same prefix entries: maps as above, T_WC and
  keypoints exact;
- the prefix itself: the JAX host camera projects in float32 (x64 off), the
  port's in float64, so projected keypoints differ by up to ~1e-4 px (5e-5
  px measured in the 511 px crop) and the maps rendered from them by up to
  ~3e-6 (heatmap slope <= 0.43 per px at 64 px); the stream is held to
  2e-4 px and 1e-5 with equal masks;
- the writers: the same world points and poses; the blobs sit at the two
  projections, so a few pixels a frame may differ by one level before
  encoding.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
h5py = pytest.importorskip("h5py")

import jax.numpy as jnp  # noqa: E402

from object_keypoints_tpu.data import augment as jaugment  # noqa: E402
from object_keypoints_tpu.data import scene as jscene  # noqa: E402
from object_keypoints_tpu.data import synthetic as jsynthetic  # noqa: E402
from object_keypoints_tpu.data import targets as jtargets  # noqa: E402
from object_keypoints_tpu_torch.data import augment, scene, synthetic, targets  # noqa: E402
from object_keypoints_tpu_torch.data.encode import SequenceWriter  # noqa: E402

torch.set_num_threads(1)

CONFIG = {"keypoint_config": [1, 3]}


def read_video(path):
    capture = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = capture.read()
        if not ok:
            break
        frames.append(frame)
    capture.release()
    return frames


@pytest.fixture(scope="module")
def jax_frames(tmp_path_factory, calibration_file):
    """A JAX-written sequence and the raw frames its writer encoded."""
    out = tmp_path_factory.mktemp("data_seq") / "seq"
    frames = []
    add_frame = jsynthetic.SequenceWriter.add_frame

    def record(self, image, T_WC):
        frames.append(image.copy())
        return add_frame(self, image, T_WC)

    jsynthetic.SequenceWriter.add_frame = record
    try:
        jsynthetic.write_synthetic_sequence(str(out), calibration_file, [1, 3], n_frames=5,
                                            seed=5)
    finally:
        jsynthetic.SequenceWriter.add_frame = add_frame
    return str(out), frames


@pytest.fixture(scope="module")
def sequence_dir(jax_frames):
    return jax_frames[0]


def target_case(seed, config, n_objects):
    """Random multi-object points in 64x64 target space: overlapping discs
    (object 0's first keypoints within 3 px of its center, the other objects
    on top of object 0), points out of frame and invalid points."""
    rng = np.random.default_rng(seed)
    n_kp = sum(config)
    points = rng.uniform(-8, 72, size=(n_objects, n_kp, 2)).astype(np.float32)
    points[0, 1:3] = points[0, 0] + rng.uniform(-3, 3, size=(2, 2))
    points[1:, :2] = points[0, :2] + rng.uniform(-4, 4, size=(n_objects - 1, 2, 2))
    points_C = np.concatenate([points, rng.uniform(0.5, 2.0, size=(n_objects, n_kp, 1))],
                              axis=-1).astype(np.float32)
    valid = rng.uniform(size=(n_objects, n_kp)) > 0.2
    return points, points_C, valid


def check_maps(got, want, what, heat_atol=1e-6, atol=1e-6):
    """(heatmaps, depth, centers) against each other; equal support masks."""
    for name, g, w in zip(("heatmaps", "depth", "centers"), got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        np.testing.assert_allclose(g, w, atol=heat_atol if name == "heatmaps" else atol,
                                   rtol=0, err_msg=f"{what} {name}")
        if name != "heatmaps":
            np.testing.assert_array_equal(g != 0, w != 0, err_msg=f"{what} {name} support")


@pytest.mark.parametrize("seed,config,n_objects", [
    (0, (1, 1, 3), 3), (1, (1, 2, 2), 2), (2, (1, 4), 1), (3, (1, 1, 1, 1), 4),
])
def test_targets_match_jax_renderers(seed, config, n_objects):
    points, points_C, valid = target_case(seed, config, n_objects)
    got = targets.render_all_targets(torch.from_numpy(points), torch.from_numpy(points_C),
                                     torch.from_numpy(valid), config, (64, 64))
    jit = jtargets.render_all_targets(jnp.asarray(points), jnp.asarray(points_C),
                                      jnp.asarray(valid), config, (64, 64))
    host = jtargets.render_all_targets_host(points, points_C, valid, config, (64, 64))
    check_maps([t.numpy() for t in got], jit, "port vs jit")
    check_maps([t.numpy() for t in got], host, "port vs host")
    assert (got[1] != 0).any() and (got[2] != 0).any()


def test_targets_last_writer_wins_on_overlap():
    """Two objects' discs on one pixel: the later object's value wins, as in
    the JAX loop, in depth and in the center field."""
    points = np.array([[[32.0, 32.0], [20.0, 20.0]], [[40.0, 40.0], [21.0, 20.0]]], np.float32)
    points_C = np.concatenate([points, np.array([[[1.0], [1.5]], [[2.0], [2.5]]])], axis=-1)
    heat, depth, centers = targets.render_all_targets(
        torch.from_numpy(points), torch.from_numpy(points_C.astype(np.float32)),
        torch.ones(2, 2, dtype=torch.bool), (1, 1), (64, 64))
    assert depth[1, 20, 20] == 2.5
    np.testing.assert_allclose(centers[0, :, 20, 20].numpy(), [40.0 - 20.5, 40.0 - 20.5])
    assert depth[1, 20, 16] == 1.5  # covered by the first object only


def test_targets_batched_equal_per_frame():
    config = (1, 1, 3)
    cases = [target_case(10 + i, config, 2) for i in range(4)]
    stacked = [torch.from_numpy(np.stack(c)) for c in zip(*cases)]
    batch = targets.render_all_targets(*stacked, config, (64, 48))
    for i, case in enumerate(cases):
        one = targets.render_all_targets(*(torch.from_numpy(a) for a in case), config, (64, 48))
        for b, o in zip(batch, one):
            assert torch.equal(b[i], o)
    assert batch[2].shape == (4, 2, 2, 64, 48)


def test_target_kernels_match_jax():
    np.testing.assert_array_equal(targets.compute_kernel(50, 25), jtargets.compute_kernel(50, 25))
    x, y = np.random.default_rng(4).normal(size=(2, 7, 2)).astype(np.float32)
    np.testing.assert_allclose(targets.gaussian_kernel_value(torch.from_numpy(x), torch.from_numpy(y)),
                               jtargets.gaussian_kernel_value(x, y), atol=1e-7, rtol=0)
    np.testing.assert_array_equal(targets.pixel_grid(5, 7).numpy(), jtargets.pixel_grid(5, 7))


@pytest.mark.parametrize("shape,point", [
    ((120, 160), (80.0, 60.0)), ((120, 160), (1.0, 1.0)), ((120, 160), (165.0, 60.0)),
    ((120, 160), (165.0, 130.0)), ((120, 160), (-10.0, -130.0)), ((360, 640), (353.5, 153.8)),
    ((720, 1280), (456.02, 34.744)),
])
def test_add_discrete_kernel_boundary_cases(shape, point):
    """tests/test_targets.py's boundary cases, pasted by both packages."""
    kernel = targets.compute_kernel(50, 25)
    got = targets.add_discrete_kernel(np.zeros(shape, np.float32), kernel, np.array([point]), 25)
    want = jtargets.add_discrete_kernel(np.zeros(shape, np.float32), kernel, np.array([point]), 25)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_augmentation_matches_jax(seed):
    """Geometry and the seeded photometric suffix (CLAHE, cutout, flips
    included) give the same frames and keypoints as the JAX pipeline."""
    rng = np.random.default_rng(100 + seed)
    image = rng.integers(0, 255, size=(90, 160, 3), dtype=np.uint8)
    kps = rng.uniform(0, 150, size=(5, 2))
    got = augment.AugmentationPipeline((64, 64), augment=True)(
        image, kps, np.random.default_rng(seed))
    want = jaugment.AugmentationPipeline((64, 64), augment=True)(
        image, kps, np.random.default_rng(seed))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    clahe = augment.clahe(image, np.random.default_rng(seed))
    np.testing.assert_array_equal(clahe, jaugment.clahe(image, np.random.default_rng(seed)))


def test_examples_from_the_same_prefix_match_jax(sequence_dir):
    """The JAX dataset's own prefix entries through the port's
    ``_finish_example``: the suffix (scaling, targets, normalization)."""
    jds = jscene.SceneDataset(sequence_dir, CONFIG, include_pose=True)
    ds = scene.SceneDataset(sequence_dir, CONFIG, include_pose=True)
    for entry in jds.iter_prefix():
        got, want = ds._finish_example(*entry), jds._finish_example(*entry)
        assert sorted(got) == sorted(want)
        np.testing.assert_allclose(got["frame"], want["frame"], atol=1e-6, rtol=0)
        assert got["frame"].dtype == np.float32
        check_maps([got[k] for k in ("heatmaps", "depth", "centers")],
                   [want[k] for k in ("heatmaps", "depth", "centers")], "example")
        np.testing.assert_array_equal(got["T_WC"], want["T_WC"])
        np.testing.assert_array_equal(got["keypoints"], want["keypoints"])


def test_scene_dataset_matches_jax(sequence_dir):
    """Each package reads the sequence its own way: mp4 decode, hdf5 poses,
    projection (float32 there, float64 here), resize/crop, targets."""
    jds = jscene.SceneDataset(sequence_dir, CONFIG, include_pose=True)
    ds = scene.SceneDataset(sequence_dir, CONFIG, include_pose=True)
    assert len(ds) == len(jds) == 5
    assert (ds.n_objects, ds.n_keypoints, ds.keypoint_config) == (1, 5, [1, 1, 3])
    np.testing.assert_array_equal(ds.world_points, jds.world_points)
    np.testing.assert_array_equal(ds.image_offset, jds.image_offset)
    prefixes = list(zip(ds.iter_prefix(), jds.iter_prefix()))
    examples = list(zip(ds, jds))
    assert len(prefixes) == len(examples) == 5
    for (p, jp), (got, want) in zip(prefixes, examples):
        np.testing.assert_array_equal(p[0], jp[0])  # the resized frame
        np.testing.assert_allclose(p[1], jp[1], atol=2e-4, rtol=0)
        np.testing.assert_allclose(p[2], jp[2], atol=1e-6, rtol=0)
        np.testing.assert_array_equal(p[3], jp[3])
        assert got["frame"].shape == (511, 511, 3)
        np.testing.assert_allclose(got["frame"], want["frame"], atol=1e-6, rtol=0)
        check_maps([got[k] for k in ("heatmaps", "depth", "centers")],
                   [want[k] for k in ("heatmaps", "depth", "centers")], "stream",
                   heat_atol=1e-5, atol=1e-5)
        assert got["heatmaps"].shape == (64, 64, 3) and got["centers"].shape == (64, 64, 2, 2)
        np.testing.assert_array_equal(got["T_WC"], want["T_WC"])
        np.testing.assert_allclose(got["keypoints"], want["keypoints"], atol=2e-5, rtol=0)


def test_recording_in_memory_equals_the_files(sequence_dir):
    """Poses and frames handed over in memory go through the same per-frame
    code as the files: the examples are equal."""
    with h5py.File(f"{sequence_dir}/data.hdf5", "r") as f:
        poses = f["camera_transform"][:]
    frames = [cv2.cvtColor(f, cv2.COLOR_BGR2RGB) for f in read_video(f"{sequence_dir}/frames.mp4")]
    from_files = list(scene.SceneDataset(sequence_dir, CONFIG, include_pose=True))
    in_memory = list(scene.SceneDataset(sequence_dir, CONFIG, include_pose=True,
                                        recording=(poses, frames)))
    assert len(from_files) == len(in_memory) == 5
    for a, b in zip(from_files, in_memory):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_render_targets_batched_equal_examples(sequence_dir):
    """The batched target path of the fast eval equals the per-example maps."""
    ds = scene.SceneDataset(sequence_dir, CONFIG)
    entries = list(ds.iter_prefix())
    heat, depth, centers = ds.render_targets(ds.target_points(np.stack([e[1] for e in entries])),
                                             np.stack([e[2] for e in entries]))
    for i, example in enumerate(ds):
        np.testing.assert_array_equal(heat[i].permute(1, 2, 0).numpy(), example["heatmaps"])
        np.testing.assert_array_equal(depth[i].permute(1, 2, 0).numpy(), example["depth"])
        np.testing.assert_array_equal(centers[i].permute(2, 3, 0, 1).numpy(), example["centers"])


def test_cache_normalize_and_to_image(sequence_dir):
    ds = scene.SceneDataset(sequence_dir, CONFIG, cache_frames=True, normalize=False)
    first, second = list(ds), list(ds)
    assert first[0]["frame"].dtype == np.uint8
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a["frame"], b["frame"])
    normalized = scene.normalize_frames(torch.tensor(first[0]["frame"])).numpy()
    normalized_by_dataset = next(iter(scene.SceneDataset(sequence_dir, CONFIG)))["frame"]
    np.testing.assert_array_equal(normalized, normalized_by_dataset)
    np.testing.assert_array_equal(scene.SceneDataset.to_image(normalized),
                                  jscene.SceneDataset.to_image(normalized))
    with pytest.raises(ValueError, match="Wrong number of keypoints"):
        scene.SceneDataset(sequence_dir, {"keypoint_config": [1, 1, 1]})


def test_synthetic_writer_matches_jax(jax_frames, tmp_path, calibration_file):
    """The same seed gives the same world points, poses and noise; the raw
    frames differ only where a blob pixel rounds across a level; the port's
    SequenceWriter encodes the JAX frames into the same files."""
    jdir, jframes = jax_frames
    world, poses, frames = synthetic.synthetic_recording(calibration_file, [1, 3], n_frames=5,
                                                         seed=5)
    frames = list(frames)
    with open(f"{jdir}/keypoints.json") as f:
        np.testing.assert_array_equal(world, np.array(json.load(f)["3d_points"]))
    with h5py.File(f"{jdir}/data.hdf5", "r") as f:
        np.testing.assert_array_equal(poses, f["camera_transform"][:])
    for got, want in zip(frames, jframes):
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 1 and np.count_nonzero(diff) <= 16, np.count_nonzero(diff)

    with SequenceWriter(tmp_path / "copy", preview=False) as writer:
        writer.write_calibration(calibration_file)
        writer.write_keypoints(world)
        for T_WC, frame in zip(poses, jframes):
            writer.add_frame(frame, T_WC)
    for got, want in zip(read_video(tmp_path / "copy" / "frames.mp4"),
                         read_video(f"{jdir}/frames.mp4")):
        np.testing.assert_array_equal(got, want)

    written = synthetic.write_synthetic_sequence(str(tmp_path / "seq"), calibration_file, [1, 3],
                                                 n_frames=5, seed=5)
    np.testing.assert_array_equal(written, world)
    decoded = read_video(tmp_path / "seq" / "frames.mp4")
    assert len(decoded) == 5 and decoded[0].shape == (720, 1280, 3)
    with h5py.File(tmp_path / "seq" / "data.hdf5", "r") as f:
        np.testing.assert_array_equal(f["camera_transform"][:], poses)
