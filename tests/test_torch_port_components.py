"""Port parity for the pipeline components (the reference's host API): the
same maps, detections and calibration through the JAX package's facades and
the port's, ragged outputs compared entry by entry.

Maps: the analytic stereo heatmaps of tests/test_stereo_pipeline.py
(180x320), the analytic monocular targets of tests/test_pipeline.py and the
over-capacity scenes of tests/test_torch_port_decode.py (64x64, bench.py's
camera chain), and the tiny KeypointNet artifact of
tests/test_torch_port_serve.py.

Tolerances: counts, matches and masks equal; 2D within 1e-4 px; 3D within
1e-4 m (the port's host cameras run float64, the JAX package's float32).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from object_keypoints_tpu.data import targets as T  # noqa: E402
from object_keypoints_tpu.geometry import cameras as jcam  # noqa: E402
from object_keypoints_tpu.pipeline import components as jcomp  # noqa: E402
from object_keypoints_tpu.pipeline import stereo_jit as jstereo  # noqa: E402
from object_keypoints_tpu_torch.geometry import cameras as cam  # noqa: E402
from object_keypoints_tpu_torch.pipeline import components as comp  # noqa: E402
from object_keypoints_tpu_torch.pipeline import decode as pipe  # noqa: E402
from object_keypoints_tpu_torch.pipeline import stereo as pstereo  # noqa: E402
from test_stereo_pipeline import CONFIG, KEYPOINTS, _heatmaps  # noqa: E402
from test_torch_port_decode import camera_chain, scenes  # noqa: E402
from test_torch_port_serve import artifact  # noqa: E402,F401
from test_torch_port_stereo import make_rig  # noqa: E402

torch.set_num_threads(1)


def close(got, want, atol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=0, err_msg=what)


def same_ragged(got, want, atol, what):
    """Nested lists / tuples / dicts of arrays, equal in structure and close."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            same_ragged(got[k], want[k], atol, f"{what}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (what, len(got), len(want))
        for i, (g, w) in enumerate(zip(got, want)):
            same_ragged(g, w, atol, f"{what}[{i}]")
    elif want is None:
        assert got is None, what
    else:
        assert np.shape(got) == np.shape(want), (what, np.shape(got), np.shape(want))
        close(got, want, atol, what)


@pytest.fixture(scope="module")
def fixture_rigs(calibration_file):
    return make_rig(cam, calibration_file, "fixture"), make_rig(jcam, calibration_file, "fixture")


@pytest.fixture(scope="module")
def full_rigs(calibration_file):
    return cam.StereoCamera.from_file(calibration_file), jcam.StereoCamera.from_file(calibration_file)


def test_keypoint_extraction_stereo_form(fixture_rigs):
    heat_l, heat_r, *_ = _heatmaps(fixture_rigs[1], KEYPOINTS)
    batch_l, batch_r = np.stack([heat_l, heat_r]), np.stack([heat_r, heat_l])
    got = comp.KeypointExtractionComponent(CONFIG, (180, 320), max_peaks=8)(batch_l, batch_r)
    want = jcomp.KeypointExtractionComponent(CONFIG, (180, 320), max_peaks=8)(batch_l, batch_r)
    same_ragged(got, want, 1e-4, "extraction")
    assert [len(c) for c in got[0][0][0]] == [1, 1, 3]
    single = comp.KeypointExtractionComponent(CONFIG, (180, 320), max_peaks=8)(batch_l)
    same_ragged(single, got[0], 0, "one batch")
    with pytest.raises(ValueError):
        comp.KeypointExtractionComponent({"keypoint_config": [1]}, (180, 320))(batch_l)


def test_triangulation_and_association_components(full_rigs):
    mine, ref = full_rigs
    points = np.array([[0.0, 0.0, 1.0], [0.0, 0.25, 1.0], [0.0, -0.25, 1.0],
                       [0.0, -0.02, 1.0], [0.0, 0.02, 1.0], [0.15, 0.0, 1.0]])
    p_l = mine.left_camera.project(points)
    p_r = mine.right_camera.project(points @ mine.T_RL[:3, :3].T + mine.T_RL[:3, 3])

    tri, jtri = comp.TriangulationComponent(), jcomp.TriangulationComponent()
    tri.reset(mine)
    jtri.reset(ref)
    close(tri(p_l, p_r), jtri(p_l, p_r), 1e-4, "triangulation")
    close(tri(p_l, p_r), points, 1e-6, "triangulation truth")

    rng = np.random.default_rng(0)
    decoy = p_r[1] + np.array([0.0, 25.0])
    cases = [(p_l[:3], p_r[:3][perm], 2.0) for perm in (rng.permutation(3) for _ in range(3))]
    cases += [(p_l[:3], np.stack([decoy, p_r[1], p_r[2]]), 2.0), (p_l[3:], p_r[3:], 15.0),
              (p_l, p_r[:4], 2.0), (p_l[:2], p_r, 2.0)]
    for i, (left, right, threshold) in enumerate(cases):
        assoc, jassoc = comp.AssociationComponent(threshold), jcomp.AssociationComponent(threshold)
        assoc.reset(mine)
        jassoc.reset(ref)
        got = assoc(left, right)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, jassoc(left, right), err_msg=f"case {i}")
    assert assoc(p_l[:3], np.stack([decoy, p_r[1], p_r[2]])).tolist() == [-1, 1, 2]


def test_stereo_keypoint_pipeline_facade(fixture_rigs):
    mine, ref = fixture_rigs
    heat_l, heat_r, *_ = _heatmaps(ref, KEYPOINTS)
    pipeline = pstereo.StereoKeypointPipeline(CONFIG, max_peaks=8, epipolar_threshold=3.0)
    pipeline.reset(mine)
    jpipeline = jstereo.StereoKeypointPipeline(CONFIG, max_peaks=8, epipolar_threshold=3.0)
    jpipeline.reset(ref)
    got, want = pipeline(heat_l, heat_r), jpipeline(heat_l, heat_r)
    same_ragged(got, want, 1e-4, "stereo facade")
    assert [len(o["p_L"]) for o in got] == [1, 1, 3]


def monocular_frames(calibration_file):
    """Frame 0: the analytic valve targets of test_pipeline.py's monocular
    test; frames 1-3: test_torch_port_decode's scenes (two clean objects,
    over-capacity cells with an outlier, ties)."""
    cam64 = camera_chain(jcam, calibration_file)
    keypoints = np.concatenate([KEYPOINTS.mean(0, keepdims=True), KEYPOINTS])
    heat, depth, centers = T.render_all_targets(
        jnp.asarray(cam64.project(keypoints)[None], jnp.float32),
        jnp.asarray(keypoints[None], jnp.float32), jnp.ones((1, 5), bool), (1, 1, 3), (64, 64))
    probs, depths, offsets = scenes(camera_chain(cam, calibration_file))
    return (np.concatenate([np.asarray(heat)[None], probs]),
            np.concatenate([np.asarray(depth)[None], depths]),
            np.concatenate([np.asarray(centers)[None], offsets]))


def test_object_keypoint_pipeline(calibration_file):
    probs, depth, offsets = monocular_frames(calibration_file)
    config = {"keypoint_config": [1, 3]}
    pipeline = comp.ObjectKeypointPipeline([64, 64], None, config, max_peaks=16)
    pipeline.reset(camera_chain(cam, calibration_file))
    jpipeline = jcomp.ObjectKeypointPipeline([64, 64], None, config, max_peaks=16)
    jpipeline.reset(camera_chain(jcam, calibration_file))
    counts = []
    for n in range(len(probs)):
        maps = (probs[n:n + 1], depth[n:n + 1], offsets[n:n + 1])
        got, want = pipeline(*maps), jpipeline(*maps)
        for o_got, o_want in zip(got, want):
            same_ragged(o_got["keypoints"], o_want["keypoints"], 1e-4, f"frame {n} keypoints")
            same_ragged(o_got["p_centers"], o_want["p_centers"], 1e-4, f"frame {n} p_centers")
            same_ragged(o_got["p_C"], o_want["p_C"], 1e-4, f"frame {n} p_C")
        assert len(got) == len(want)
        counts.append(len(got))

        decoded = pipeline.decode_device(*(torch.from_numpy(a[0]) for a in maps))
        jdecoded = jpipeline.decode_device(*(a[0] for a in maps))
        for name in pipe.DecodedObjects._fields:
            g, w = getattr(decoded, name).numpy(), np.asarray(getattr(jdecoded, name))
            if g.dtype == bool or name == "assignment":
                np.testing.assert_array_equal(g, w, err_msg=name)
            else:
                close(g, w, 1e-4, f"decode_device {name}")
    assert counts[:3] == [1, 2, 2]
    # 3D of the analytic valve within the 5 cm gate of test_pipeline.py
    obj = pipeline(probs[:1], depth[:1], offsets[:1])[0]
    keypoints = np.concatenate([KEYPOINTS.mean(0, keepdims=True), KEYPOINTS])
    assert np.linalg.norm(obj["p_C"][0][0] - keypoints[0]) < 5e-2
    assert obj["p_C"][2].shape == (3, 3)


def test_object_extraction_and_detection_to_point(calibration_file):
    config = {"keypoint_config": [1, 3]}
    rng = np.random.default_rng(4)
    centers = [np.array([20.0, 30.0]), np.array([44.0, 30.0])]
    type0 = [np.array([21.0, 27.0]), np.array([19.0, 28.0]), np.array([43.0, 27.5])]
    type1 = [c + rng.normal(0, 4, 2) for c in centers for _ in range(4)] + [np.array([2.0, 60.0])]
    keypoints = [centers, type0, type1]
    confidence = [[1.0, 1.0], [0.9, 0.4, 0.8], list(rng.uniform(0.5, 1.0, len(type1)))]
    offsets = np.zeros((2, 2, 64, 64), np.float32)
    for t_, pts in enumerate((type0, type1)):
        for p in pts:
            x, y = np.round(p).astype(int)
            target = min(centers, key=lambda c: np.linalg.norm(c - p))
            offsets[t_, :, y, x] = target - (np.array([x, y]) + 0.5)
    got = comp.ObjectExtraction(config, (64, 64))(keypoints, confidence, offsets)
    want = jcomp.ObjectExtraction(config, (64, 64))(keypoints, confidence, offsets)
    same_ragged(got, want, 1e-4, "objects")
    assert [len(o["heatmap_points"][1]) for o in got] == [3, 3]  # k-means to capacity
    assert comp.ObjectExtraction(config, (64, 64))([[], [], []], [[], [], []], offsets) == []

    to_point, jto_point = comp.DetectionToPoint(), jcomp.DetectionToPoint()
    to_point.reset(camera_chain(cam, calibration_file))
    jto_point.reset(camera_chain(jcam, calibration_file))
    xy = rng.uniform(0, 64, size=(40, 2))
    depth = rng.uniform(0.5, 2.0, size=(64, 64)).astype(np.float32)
    close(to_point(xy, depth), jto_point(xy, depth), 1e-4, "detection to point")
    assert to_point(np.zeros((0, 2)), depth) is None


def test_learned_tracking_pipeline_tiny_artifact(artifact, calibration_file):
    frame = np.random.default_rng(24).normal(size=(1, 3, 128, 128)).astype(np.float32)
    config = {"keypoint_config": [1, 3]}
    pipeline = comp.LearnedKeypointTrackingPipeline(artifact, False, [16, 16], None, config,
                                                    max_peaks=8)
    pipeline.reset(camera_chain(cam, calibration_file, size=16))
    jpipeline = jcomp.LearnedKeypointTrackingPipeline(artifact, True, [16, 16], None, config,
                                                      max_peaks=8)
    jpipeline.reset(camera_chain(jcam, calibration_file, size=16))
    (objects, heat), (jobjects, jheat) = pipeline(frame), jpipeline(frame)
    close(heat, jheat, 1e-4, "heatmaps")
    assert isinstance(heat, np.ndarray) and len(objects) == len(jobjects) > 0
    for o_got, o_want in zip(objects, jobjects):
        same_ragged(o_got["keypoints"], o_want["keypoints"], 1e-4, "keypoints")
        same_ragged(o_got["p_C"], o_want["p_C"], 1e-4, "p_C")


def test_inference_component_devices(artifact, monkeypatch):
    seen = []

    def model(frames):
        seen.append(frames.device)
        return frames[:, :1], frames[:, 1:2], frames[:, 2:]

    frames = np.zeros((1, 3, 8, 8), np.float32)
    component = comp.InferenceComponent(model, cuda=False)
    out = component(frames)
    assert seen == [torch.device("cpu")] and all(isinstance(a, np.ndarray) for a in out)
    # infer keeps the maps on the inference device, as tensors
    assert all(isinstance(a, torch.Tensor) for a in component.infer(torch.from_numpy(frames)))
    # cuda=True means the CUDA device: without one it raises, never falls back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for target in (model, artifact):
        with pytest.raises(RuntimeError, match="CUDA"):
            comp.InferenceComponent(target, cuda=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        comp.LearnedKeypointTrackingPipeline(artifact, True, [16, 16], None,
                                             {"keypoint_config": [1, 3]})


def test_components_work_on_the_maps_device(calibration_file, monkeypatch):
    """The components hand the maps they are given to the tensor functions
    as they are, with no numpy round trip, so maps on the card are decoded
    on the card (tests/test_torch_port_gpu.py runs it there)."""
    from object_keypoints_tpu_torch.ops import associate, decode

    seen = []

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*args, **kwargs):
            seen.append((name, args[0] if name == "extract_peaks" else args[2]))
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapped)

    spy(decode, "extract_peaks")
    spy(associate, "assign_to_centers")
    probs, depth, offsets = (torch.from_numpy(a[:1].copy()) for a in monocular_frames(calibration_file))
    pipeline = comp.ObjectKeypointPipeline([64, 64], None, {"keypoint_config": [1, 3]}, max_peaks=16)
    pipeline.reset(camera_chain(cam, calibration_file))
    objects = pipeline(probs, depth, offsets)
    assert len(objects) == 1
    (name, maps), (name2, centers) = seen
    assert name == "extract_peaks" and maps.data_ptr() == probs.data_ptr()
    assert name2 == "assign_to_centers" and centers.data_ptr() == offsets[0].data_ptr()
    same_ragged(objects, pipeline(probs.numpy(), depth.numpy(), offsets.numpy()), 0, "numpy maps")
