"""Scenes, rigs and comparisons shared by the port's tests and chip_smoke.py.

- ``bench_camera`` / ``serve_rig``: bench.py's camera chain (511 tall,
  centre cut, into size x size prediction space), for one camera of either
  package or for the stereo rig of config/calibration.yaml.
- ``stereo_scene``: numpy Gaussian heatmaps of known 3D keypoints at their
  fisheye projections in both views of the 180x320 rig.
- ``compare_stereo``: one stereo decode held to another (masks equal, 2D
  within a pixel tolerance, 3D within ``stereo_3d_tolerance``).
- ``synthetic_sequence_in_memory``: a synthetic sequence whose poses and
  frames stay in memory, for machines without h5py.
- ``synthetic_datasets``: ``SceneDataset``s over such sequences, what
  ``training.device_data.build_device_store`` takes.
- ``synthetic_batch``: a seeded train batch of Gaussian-blob targets, the
  batch of tests/test_training.py made with numpy, for both packages.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from object_keypoints_tpu_torch.data.encode import SequenceWriter
from object_keypoints_tpu_torch.data.scene import SceneDataset
from object_keypoints_tpu_torch.data.synthetic import synthetic_recording
from object_keypoints_tpu_torch.geometry import cameras, stereo

BENCH_OFFSET = np.array([(511.0 / 720.0 * 1280.0 - 511.0) / 2.0, 0.0])  # bench.py:194
# the valve keypoints of tests/test_stereo_pipeline.py, in the left camera frame (m)
SCENE_KEYPOINTS = np.array([[0.0, 0.0, 1.0], [0.25, 0.15, 1.0], [-0.25, -0.25, 1.0],
                            [0.25, -0.25, 1.0]])
SCENE_CHANNELS = ([0], [1], [2, 3, 4])  # centroid; first keypoint; the other three
SCENE_SIZE = (180, 320)


def bench_camera(camera, size: int = 64):
    """A 1280x720 camera of either package through bench.py's chain."""
    return camera.scale(511.0 / 720.0).cut(BENCH_OFFSET).scale(size / 511.0)


def serve_rig(params, size: int = 64) -> cameras.StereoCamera:
    """The stereo rig of calibration ``params`` through bench.py's chain."""
    return cameras.StereoCamera(*(bench_camera(cameras.FisheyeCamera(K, D, params["image_size"]), size)
                                  for K, D in ((params["K"], params["D"]),
                                               (params["Kp"], params["Dp"]))),
                                params["T_RL"])


def gaussian_maps(points, size, sigma: float = 2.0) -> np.ndarray:
    """(K, H, W) float32 maps: channel c holds unit Gaussians at points[c]."""
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    maps = np.zeros((len(points), h, w), np.float32)
    for c, pts in enumerate(points):
        for x, y in pts:
            maps[c] = np.maximum(maps[c], np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / sigma**2))
    return maps


def stereo_scene(calibration_file: str):
    """The calibration's rig at 180x320 and the Gaussian maps of
    SCENE_KEYPOINTS and their centroid in both views. Returns (rig, left
    maps, right maps, the 5 points, SCENE_CHANNELS)."""
    p = cameras.load_calibration_params(calibration_file)
    scale = SCENE_SIZE[0] / 720.0
    rig = cameras.StereoCamera(cameras.FisheyeCamera(p["K"], p["D"], p["image_size"]).scale(scale),
                               cameras.FisheyeCamera(p["Kp"], p["Dp"], p["image_size"]).scale(scale),
                               p["T_RL"])
    points = np.concatenate([SCENE_KEYPOINTS.mean(0, keepdims=True), SCENE_KEYPOINTS])
    p_l = rig.left_camera.project(points)
    p_r = rig.right_camera.project(points @ rig.T_RL[:3, :3].T + rig.T_RL[:3, 3])
    return (rig, gaussian_maps([p_l[c] for c in SCENE_CHANNELS], SCENE_SIZE),
            gaussian_maps([p_r[c] for c in SCENE_CHANNELS], SCENE_SIZE), points, SCENE_CHANNELS)


def stereo_3d_tolerance(points, flat_to: float = 1.0) -> np.ndarray:
    """Per-point 3D tolerance in m: 1e-4 m within ``flat_to`` (>= 1) m of
    the camera, 1e-4 m x (|p| / 1 m)^3 from there on.

    Why the cube: the DLT solves the 3x3 normal equations of two rays
    ``B`` apart, whose condition number grows as (z / B)^2; float32
    rounding (eps ~6e-8) then moves a point at distance z by about
    eps z^3 / B^2, ~1.5e-5 m x (z / 1 m)^3 on a 6.24 cm baseline."""
    dist = np.linalg.norm(np.asarray(points, np.float64), axis=-1)
    return np.where(dist < flat_to, 1e-4, 1e-4 * np.maximum(1.0, dist**3))


def _numpy(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.numpy() if x.dtype == torch.bool else x.double().numpy()
    return np.asarray(x)


def lift_exact(decoded, rig):
    """``decoded`` with its 3D points lifted anew, in float64 on the CPU,
    from its own matched pixels: the same port code (undistort,
    Hartley-Sturm, DLT) that the decode ran, with ``rig``'s arrays as
    float64. The witness for ``stereo_3d_tolerance``."""
    r = [torch.as_tensor(a).detach().cpu().double() for a in rig]
    p3 = stereo.triangulate_pixels(decoded.points_left.detach().cpu().double(),
                                   decoded.points_right.detach().cpu().double(), *r)
    valid = decoded.match_valid.detach().cpu()
    return decoded._replace(points_3d=torch.where(valid[..., None], p3, torch.zeros_like(p3)))


def compare_stereo(got, want, what: str, atol_2d: float = 1e-4, flat_to: float = 1.0,
                   exact=None):
    """Hold a ``StereoDecoded`` (torch, any device) to another (torch, or the
    JAX package's): shapes equal, masks equal, points and confidences
    within ``atol_2d``, unmatched 3D slots 0 in both, and each matched 3D
    point within ``stereo_3d_tolerance(exact, flat_to)``, where
    ``exact`` is a float64 lift of the same pixels (``lift_exact``) and
    defaults to ``want``.

    A matched point whose tolerance is at least its own exact distance (or
    that is non-finite in ``exact``) carries no depth at this precision: its
    rays are all but parallel. It is counted and not compared, and may be
    non-finite in either. Returns (worst 3D error as a fraction of its
    tolerance, points compared, points that carry no depth)."""
    fields = ("points_left", "points_right", "match_valid", "points_3d", "left_valid",
              "confidence")
    g = {name: _numpy(getattr(got, name)) for name in fields}
    w = {name: _numpy(getattr(want, name)) for name in fields}
    for name in fields:
        assert g[name].shape == w[name].shape, (what, name, g[name].shape, w[name].shape)
    for name in ("match_valid", "left_valid"):
        np.testing.assert_array_equal(g[name], w[name], err_msg=f"{what}: {name}")
    for name in ("points_left", "points_right", "confidence"):
        np.testing.assert_allclose(g[name], w[name], atol=atol_2d, rtol=0, err_msg=f"{what}: {name}")
    matched = w["match_valid"]
    np.testing.assert_array_equal(g["points_3d"][~matched], 0.0, err_msg=f"{what}: unmatched 3D")
    np.testing.assert_array_equal(w["points_3d"][~matched], 0.0, err_msg=f"{what}: unmatched 3D")
    g3, w3 = g["points_3d"][matched], w["points_3d"][matched]
    e3 = w3 if exact is None else _numpy(exact.points_3d)[matched]
    with np.errstate(invalid="ignore"):
        tol = stereo_3d_tolerance(e3, flat_to)
        held = np.isfinite(e3).all(-1) & (tol < np.linalg.norm(e3, axis=-1))
    ratio = np.abs(g3[held] - w3[held]).max(-1, initial=0.0) / tol[held]
    ratio = np.where(np.isfinite(ratio), ratio, np.inf)
    worst = float(ratio.max(initial=0.0))
    assert worst <= 1.0, f"{what}: 3D error {worst:.3g} x its tolerance"
    return worst, int(held.sum()), int((~held).sum())


def synthetic_sequence_in_memory(out_dir: str, calibration_file: str, keypoint_config,
                                 n_frames: int, seed: int = 0, n_objects: int = 1):
    """A synthetic sequence (``data.synthetic.synthetic_recording``) with
    only its labels on disk: writes calibration.yaml and keypoints.json into
    ``out_dir`` (neither needs cv2 or h5py) and returns the ``recording``
    (poses, RGB uint8 frames) that ``evaluation.Sequence`` and
    ``SceneDataset`` take in place of data.hdf5 and frames.mp4."""
    world_points, poses, frames = synthetic_recording(calibration_file, keypoint_config,
                                                      n_objects, n_frames=n_frames, seed=seed)
    labels = SequenceWriter(out_dir, preview=False)  # no frames: nothing to close
    labels.write_calibration(calibration_file)
    labels.write_keypoints(world_points)
    return poses, list(frames)


def synthetic_datasets(root: str, calibration_file: str, keypoint_config, n_sequences: int,
                       n_frames: int, n_objects: int = 1, seed: int = 0) -> list:
    """``n_sequences`` synthetic sequences held in memory under ``root``
    (seeds ``seed``, ``seed`` + 1, ...), each as a ``SceneDataset`` with
    augmentation and normalization off: raw uint8 frames, the device
    store's input."""
    datasets = []
    for i in range(n_sequences):
        seq_dir = os.path.join(root, f"seq_{i:02d}")
        recording = synthetic_sequence_in_memory(seq_dir, calibration_file, keypoint_config,
                                                 n_frames, seed + i, n_objects)
        datasets.append(SceneDataset(seq_dir, {"keypoint_config": list(keypoint_config)},
                                     normalize=False, recording=recording))
    return datasets


def synthetic_batch(seed: int = 0, n: int = 2, size: int = 32, k: int = 3) -> dict:
    """A consistent (frame, targets) train batch in the data layer's layout
    (numpy, NHWC): noise frames (n, size, size, 3) with a std of 0.1,
    Gaussian blobs on (size / 8)^2 heatmaps at fixed places, depth 1.5 x the
    heatmaps, centers (.., k - 1, 2) holding 0.5 in x."""
    h = w = size // 8
    frame = (np.random.default_rng(seed).normal(size=(n, size, size, 3)) * 0.1).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    heat = np.zeros((n, h, w, k), np.float32)
    for i in range(k):
        cy, cx = (i + 1) % h, (2 * i + 1) % w
        heat[..., i] = np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / 2.0)[None]
    centers = np.zeros((n, h, w, k - 1, 2), np.float32)
    centers[..., 0] = 0.5
    return {"frame": frame, "heatmaps": heat, "depth": np.clip(heat * 1.5, 0, None),
            "centers": centers}
