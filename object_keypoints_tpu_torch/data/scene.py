"""SceneDataset: stream one recorded sequence into examples.

Counterpart of ``object_keypoints_tpu/data/scene.py``. A sequence directory
holds
    frames.mp4        the recorded video (read with cv2.VideoCapture)
    data.hdf5         (N, 4, 4) 'camera_transform' world-from-camera poses
    keypoints.json    {'3d_points': [...]} labeled world keypoints
    calibration.yaml  Kalibr camera intrinsics

Per frame: project the world keypoints through the fisheye camera,
resize/crop (+augment), scale into 64x64 prediction space and render the
heatmap / center / depth targets with ``data.targets`` on ``device``.
Example dicts are host numpy, NHWC: frame (511, 511, 3) normalized float32,
heatmaps (64, 64, K), depth (64, 64, K), centers (64, 64, T, 2) [, T_WC,
keypoints (4, n_keypoints, 2)].

``recording=(poses, frames)`` holds the poses and RGB uint8 frames in memory
in place of data.hdf5 and frames.mp4 (a machine without h5py reads the
other files alone); every frame goes through the same per-frame code.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Iterator

import numpy as np
import torch

from object_keypoints_tpu_torch.constants import KEYPOINT_FILENAME, RGB_MEAN, RGB_STD
from object_keypoints_tpu_torch.data import targets
from object_keypoints_tpu_torch.data.augment import AugmentationPipeline
from object_keypoints_tpu_torch.geometry import cameras, linalg


@functools.lru_cache(maxsize=None)
def _rgb_stats(device: torch.device):
    """The normalization constants on ``device``, made once (and never as
    inference tensors, so any caller may use them): a host->device copy
    waits for the card, which a train step must not."""
    with torch.inference_mode(False):
        return torch.as_tensor(RGB_MEAN, device=device), torch.as_tensor(RGB_STD, device=device)


def normalize_frames(frames):
    """RGB frames in [0, 255] (..., H, W, 3), uint8 or float, a tensor on any
    device -> float32 (x / 255 - mean) / std on that device, the reference's
    normalization."""
    mean, std = _rgb_stats(frames.device)
    return (frames.to(torch.float32) / 255.0 - mean) / std


class SceneDataset:
    width = 1280
    height = 720
    width_resized = 511
    height_resized = 511
    heatmap_size = targets.HEATMAP_SIZE
    prediction_size = np.array([heatmap_size, heatmap_size])
    # x/y offset of the center crop in resized space
    image_offset = np.array([(height_resized / height * width - 511.0) / 2.0, 0.0])

    def __init__(self, base_dir, keypoint_config, augment: bool = False,
                 augment_color: bool = False, include_pose: bool = False, seed=None,
                 cache_frames: bool = False, normalize: bool = True, device="cpu",
                 recording=None):
        """``cache_frames`` keeps the deterministic per-frame prefix (decode,
        pose inverse, projection, resize+crop) in memory across passes;
        ``normalize=False`` emits the raw uint8 frame; each example's targets
        render on ``device``. It defaults to the CPU because an example is a
        host dict: one frame rendered on the card only adds two copies. Batches
        render on the card through ``render_targets(..., device=...)``, as
        the evaluation does."""
        del augment_color  # accepted and unused, like the reference call sites
        self.base_dir = os.path.expanduser(str(base_dir))
        self.metadata_path = os.path.join(self.base_dir, "data.hdf5")
        self.augment = augment
        self.device = torch.device(device)
        self.keypoint_config = [1] + list(keypoint_config["keypoint_config"])
        self.include_pose = include_pose
        self.rng = np.random.default_rng(seed)
        self._init_points()
        self.camera = cameras.from_calibration(os.path.join(self.base_dir, "calibration.yaml"))
        self.target_size = tuple(int(s) for s in self.prediction_size)
        self.image_size = (self.height_resized, self.width_resized)
        self.augmentations = AugmentationPipeline(self.image_size, augment=augment)
        if recording is None:
            import h5py

            with h5py.File(self.metadata_path, "r") as f:
                self.poses = f["camera_transform"][:]
            self._recorded_frames = None
        else:
            poses, frames = recording
            self.poses = np.asarray(poses, np.float64)
            self._recorded_frames = list(frames)
        self._cache = [] if cache_frames else None
        self.normalize = normalize

    def __len__(self):
        return self.poses.shape[0]

    def _init_points(self):
        """Load labeled points; prepend a synthetic per-object center = mean
        of the object's points."""
        with open(os.path.join(self.base_dir, KEYPOINT_FILENAME), "rt") as f:
            world_points = np.array(json.load(f)["3d_points"])[:, :3]
        self.n_keypoints = sum(self.keypoint_config)
        n_real = self.n_keypoints - 1
        if world_points.shape[0] % n_real:
            raise ValueError(f"Wrong number of keypoints: {world_points.shape[0]} labeled, "
                             f"{n_real} per object, sequence {self.base_dir}")
        self.n_objects = world_points.shape[0] // n_real
        self.keypoint_maps = len(self.keypoint_config)
        self.world_points = np.zeros((self.n_keypoints * self.n_objects, 3))
        for i in range(self.n_objects):
            obj = world_points[i * n_real : (i + 1) * n_real]
            self.world_points[i * self.n_keypoints] = obj.mean(axis=0)
            self.world_points[i * self.n_keypoints + 1 : (i + 1) * self.n_keypoints] = obj

    def _frames(self) -> Iterator[np.ndarray]:
        """The sequence's RGB uint8 frames in order."""
        if self._recorded_frames is not None:
            yield from self._recorded_frames
            return
        import cv2

        capture = cv2.VideoCapture(os.path.join(self.base_dir, "frames.mp4"))
        try:
            while True:
                ok, frame = capture.read()
                if not ok:
                    return
                yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        finally:
            capture.release()

    def iter_prefix(self) -> Iterator[tuple]:
        """The deterministic per-frame prefix only: (frame uint8 after
        resize/crop, projected keypoints in image space, points_C, T_WC)."""
        if self._cache is not None and len(self._cache) == len(self):
            yield from self._cache
            return
        if self._cache is not None:
            self._cache.clear()  # a partial previous pass must not mix in
        frames = self._frames()
        try:
            for T_WC, frame in zip(self.poses, frames):
                entry = self._prepare_frame(T_WC, frame)
                if self._cache is not None:
                    self._cache.append(entry)
                yield entry
        finally:
            frames.close()

    def __iter__(self) -> Iterator[dict]:
        for entry in self.iter_prefix():
            yield self._finish_example(*entry)

    def _prepare_frame(self, T_WC, frame):
        """The deterministic, cacheable per-frame prefix: pose inverse,
        world->image projection, resize+crop."""
        T_CW = linalg.inv_transform(torch.from_numpy(np.asarray(T_WC, np.float64)))
        projected = self.camera.project(self.world_points, T_CW.numpy())
        image, keypoints = self.augmentations.geometry(frame, projected)
        points_C = linalg.transform_points(T_CW, torch.from_numpy(self.world_points)).numpy()
        image.setflags(write=False)  # cached entries must never be mutated
        return (image, keypoints, points_C.reshape(self.n_objects, self.n_keypoints, 3),
                np.asarray(T_WC))

    def target_points(self, keypoints):
        """Image-space keypoints (..., n_objects * n_keypoints, 2) -> target
        space (..., n_objects, n_keypoints, 2), float64."""
        scaling = np.array(self.target_size, np.float64) / np.array(self.image_size)
        # (x, y) keypoints scale with (w, h)
        points = np.asarray(keypoints) * scaling[::-1]
        return points.reshape(*points.shape[:-2], self.n_objects, self.n_keypoints, 2)

    def render_targets(self, points_t, points_C, device=None):
        """Targets of target-space points (..., n_objects, n_keypoints, 2)
        with their camera-frame points (..., n_objects, n_keypoints, 3), in
        one call on ``device`` (the dataset's by default): heatmaps (..., K,
        H, W), depth (..., K, H, W), centers (..., T, 2, H, W)."""
        device = self.device if device is None else device
        points = torch.from_numpy(np.array(points_t, np.float32)).to(device)
        return targets.render_all_targets(
            points, torch.from_numpy(np.array(points_C, np.float32)).to(device),
            torch.ones(points.shape[:-1], dtype=torch.bool, device=device),
            tuple(self.keypoint_config), self.target_size)

    def _finish_example(self, frame, projected, points_C, T_WC) -> dict:
        """The stochastic per-pass suffix: photometric/flip augmentation,
        target rendering, normalization."""
        frame, keypoints = self.augmentations.photometric(frame, projected, self.rng)
        points_t = self.target_points(keypoints)
        heat, depth, centers = (t.cpu().numpy() for t in self.render_targets(points_t, points_C))
        example = {
            "frame": normalize_frames(torch.tensor(frame)).numpy() if self.normalize else frame,
            "heatmaps": np.transpose(heat, (1, 2, 0)),  # (64, 64, K)
            "depth": np.transpose(depth, (1, 2, 0)),
            "centers": np.transpose(centers, (2, 3, 0, 1)),  # (64, 64, T, 2)
        }
        if self.include_pose:
            keypoints_out = np.zeros((self.n_keypoints * 4, 2))
            flat = points_t.reshape(-1, 2)
            keypoints_out[: flat.shape[0]] = flat
            example["T_WC"] = np.asarray(T_WC)
            example["keypoints"] = keypoints_out.reshape(4, self.n_keypoints, 2)
        return example

    @staticmethod
    def to_image(image):
        """Undo the normalization -> uint8 HWC."""
        return np.clip((np.asarray(image) * RGB_STD + RGB_MEAN) * 255.0, 0.0, 255.0).astype(
            np.uint8
        )
