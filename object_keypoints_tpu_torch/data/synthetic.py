"""Synthetic keypoint sequences for tests, demos and the card's smoke run.

The port's copy of the keypoint half of ``object_keypoints_tpu/data/
synthetic.py``: world keypoints, an orbiting camera trajectory and frames
with bright gaussian blobs at the projected keypoints, in the on-disk layout
``SceneDataset`` reads. The same seed draws the same world points, poses and
noise as the JAX writer. The blobs sit at the port's float64 projections,
the JAX writer's at its float32 ones (~1e-4 px apart), so a few blob pixels
may differ by one level.
"""

from __future__ import annotations

import os
import zlib
from typing import Sequence

import numpy as np
import torch

from object_keypoints_tpu_torch.data.encode import SequenceWriter
from object_keypoints_tpu_torch.geometry import linalg
from object_keypoints_tpu_torch.geometry.cameras import from_calibration

BLOB_REACH = 10.0  # sigmas


def _look_at(eye, target, up=(0.0, -1.0, 0.0)):
    """T_WC with camera z-axis pointed from eye at target."""
    z = np.asarray(target, np.float64) - np.asarray(eye, np.float64)
    z /= np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, y, z, eye
    return T


def sample_object_keypoints(rng, keypoint_config: Sequence[int], n_objects: int,
                            spread: float = 0.12, separation: float = 0.45):
    """World keypoints for n_objects instances (without the synthetic
    centers, which the dataset derives)."""
    n_real = sum(keypoint_config)
    points = []
    for i in range(n_objects):
        base = np.array([(i - (n_objects - 1) / 2.0) * separation, 0.0, 1.2])
        offsets = rng.uniform(-spread, spread, size=(n_real, 3))
        points.append(base + offsets)
    return np.concatenate(points, axis=0)


def synthetic_recording(calibration_file: str, keypoint_config: Sequence[int],
                        n_objects: int = 1, n_frames: int = 30, image_size=(720, 1280),
                        seed: int = 0, blob_sigma: float = 12.0, orbit_radius: float = 0.35):
    """A synthetic sequence in memory: (world keypoints (n, 3), poses
    (n_frames, 4, 4) world-from-camera, an iterator over the RGB uint8
    frames, drawn one at a time)."""
    rng = np.random.default_rng(seed)
    camera = from_calibration(calibration_file)
    world_points = sample_object_keypoints(rng, keypoint_config, n_objects)
    target = world_points.mean(axis=0)
    poses = []
    for i in range(n_frames):
        angle = 2.0 * np.pi * i / max(n_frames, 1) * 0.25
        eye = np.array([orbit_radius * np.sin(angle), 0.15 * np.sin(2 * angle),
                        -0.05 * np.cos(angle)])
        poses.append(_look_at(eye, target))
    poses = np.stack(poses) if poses else np.zeros((0, 4, 4))

    def frames():
        h, w = image_size
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
        # A blob is drawn within BLOB_REACH sigmas of its center only: beyond,
        # it adds less than 1e-19 to a pixel of at least 20, which leaves the
        # float32 canvas unchanged, so the frame equals the whole-frame sum.
        reach = int(np.ceil(BLOB_REACH * blob_sigma))
        for T_WC in poses:
            T_CW = linalg.inv_transform(torch.from_numpy(T_WC)).numpy()
            projected = camera.project(world_points, T_CW)
            canvas = rng.integers(20, 60, size=(h, w, 3), dtype=np.uint8).astype(np.float32)
            for k, (px, py) in enumerate(projected):
                if not (0 <= px < w and 0 <= py < h):
                    continue
                win = (slice(max(int(py) - reach, 0), int(py) + reach + 1),
                       slice(max(int(px) - reach, 0), int(px) + reach + 1))
                blob = np.exp(-((xs[win] - px) ** 2 + (ys[win] - py) ** 2) / (2 * blob_sigma**2))
                color = np.array(
                    [120 + 40 * (k % 3), 80 + 50 * ((k + 1) % 3), 200 - 30 * (k % 4)],
                    np.float32,
                )
                canvas[win] += blob[..., None] * color[None, None]
            yield np.clip(canvas, 0, 255).astype(np.uint8)

    return world_points, poses, frames()


def write_synthetic_sequence(out_dir: str, calibration_file: str,
                             keypoint_config: Sequence[int], n_objects: int = 1,
                             n_frames: int = 30, image_size=(720, 1280), seed: int = 0,
                             blob_sigma: float = 12.0, orbit_radius: float = 0.35):
    """Write a whole sequence directory; returns the world keypoints."""
    world_points, poses, frames = synthetic_recording(
        calibration_file, keypoint_config, n_objects, n_frames, image_size, seed,
        blob_sigma, orbit_radius)
    with SequenceWriter(out_dir, preview=False) as writer:
        writer.write_calibration(calibration_file)
        writer.write_keypoints(world_points)
        for T_WC, frame in zip(poses, frames):
            writer.add_frame(frame, T_WC)
    return world_points


def sequence_seed(split: str, index: int) -> int:
    """The seed of sequence ``index`` of ``split`` in a synthetic tree: a
    crc32 of its name, stable across processes (``hash`` of a str is salted
    per process)."""
    return zlib.crc32(f"{split}:{index}".encode()) % (1 << 31)


def make_synthetic_dataset_tree(root: str, calibration_file: str,
                                keypoint_config: Sequence[int],
                                n_train: int = 2, n_val: int = 1, **kwargs):
    """train/ + val/ sequence trees like the reference's --train/--val
    directories, sequence i of a split at ``sequence_seed(split, i)``."""
    for split, count in (("train", n_train), ("val", n_val)):
        for i in range(count):
            write_synthetic_sequence(
                os.path.join(root, split, f"seq_{i:02d}"), calibration_file, keypoint_config,
                seed=sequence_seed(split, i), **kwargs,
            )
    return os.path.join(root, "train"), os.path.join(root, "val")
