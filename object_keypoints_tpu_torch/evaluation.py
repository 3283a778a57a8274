"""Evaluation: 3D keypoint error accumulation + the reference metric table.

Counterpart of ``object_keypoints_tpu/evaluation.py``: detected objects
match the nearest ground-truth object by XY center distance, detected
points (all coordinates < 2 m) match the nearest ground-truth keypoint,
out-of-view ground truth is skipped, and the summary reports mean error
(cm), mean XY error, std, fraction < 3 cm, 25th/75th percentiles, % missing
and the point count, printed with rich as the reference prints it.

A ``Sequence`` is evaluated on its ``device``, the card unless the CPU is
asked for. The batched path (``evaluate_sequence_fast``) reads each frame's
deterministic prefix from the dataset, then per batch either uploads the
uint8 frames once and normalizes them on the device (learned mode) or
renders the batch's targets on the device in one call (ground-truth mode),
decodes the batch there and copies the decode to the host in one transfer.
The JAX package pads the tail batch to keep its jitted shapes; eager torch
runs the tail at its own size, with the same results.
"""

from __future__ import annotations

import itertools
import json
import math
import os
from typing import List, Optional

import numpy as np
import torch

from object_keypoints_tpu_torch.data.scene import SceneDataset, normalize_frames
from object_keypoints_tpu_torch.geometry import linalg
from object_keypoints_tpu_torch.geometry.cameras import FisheyeCamera, load_calibration_params
from object_keypoints_tpu_torch.pipeline.decode import (
    CameraArrays,
    DecodedObjects,
    decode_objects_batch,
)


class Sequence:
    """One recorded sequence and the camera chain into prediction space.

    ``device``: where its frames are evaluated (the card by default; it
    raises without CUDA unless ``device="cpu"``). ``recording``: poses and
    frames in memory in place of data.hdf5 and frames.mp4 (``SceneDataset``)."""

    def __init__(self, sequence_path: str, keypoint_config: dict, prediction_size=(64, 64),
                 device="cuda", recording=None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Sequence: device {str(self.device)!r} asked for, but CUDA is "
                               "not available; pass device='cpu' to evaluate on the CPU")
        self.sequence_path = str(sequence_path)
        self.keypoint_config = keypoint_config
        self.prediction_size = np.array(prediction_size)
        self.dataset = SceneDataset(self.sequence_path, keypoint_config, augment=False,
                                    include_pose=True, recording=recording)
        self.size_resized = np.array([SceneDataset.height_resized, SceneDataset.width_resized])
        self.image_offset = SceneDataset.image_offset
        self.scale_prediction_to_image = self.prediction_size / self.size_resized
        self._load_calibration()
        self._read_keypoints()

    def _load_calibration(self):
        params = load_calibration_params(os.path.join(self.sequence_path, "calibration.yaml"))
        camera = FisheyeCamera(params["K"], params["D"], params["image_size"])
        camera = camera.scale(SceneDataset.height_resized / SceneDataset.height)
        self.camera = camera.cut(self.image_offset)
        scale_small = self.prediction_size[0] / SceneDataset.height_resized
        self.camera_small = camera.cut(self.image_offset).scale(scale_small)

    def _read_keypoints(self):
        self.world_points = self.dataset.world_points.reshape(
            self.dataset.n_objects, self.dataset.n_keypoints, 3)
        with open(os.path.join(self.sequence_path, "keypoints.json"), "rt") as f:
            self.keypoints = np.array(json.load(f)["3d_points"])[:, :3]

    def to_image_points(self, predictions):
        return predictions / self.scale_prediction_to_image


class Results:
    """3D error accumulator."""

    def __init__(self):
        self.gt_keypoints: List = []
        self.predicted_keypoints: List = []
        self.camera = None

    def set_calibration(self, camera):
        self.camera = camera

    def add(self, T_WC, objects, scene_points):
        """T_WC: world-from-camera pose; objects: pipeline detections;
        scene_points: (n_objects, n_keypoints, 3) world ground truth."""
        gt_keypoints = []
        keypoints = []
        T_CW = linalg.inv_transform(torch.from_numpy(np.asarray(T_WC, np.float64)))
        scene_points_C = linalg.transform_points(
            T_CW, torch.from_numpy(np.asarray(scene_points, np.float64).reshape(-1, 3))
        ).numpy().reshape(scene_points.shape)
        centers_C = scene_points_C[:, 0]

        for obj in objects:
            p_CK = obj["p_C"]
            if p_CK[0] is None:
                continue
            object_distances = np.linalg.norm(centers_C[:, :2] - p_CK[0][0][:2], axis=1)
            object_points = scene_points_C[int(object_distances.argmin())]

            gt_center = self.camera.project(object_points[0:1])
            if not self.camera.in_frame(gt_center)[0]:
                continue  # object center not in view

            gt_points = []
            object_keypoints = []
            for points in p_CK:
                if points is None:
                    continue
                for point in points:
                    if point is not None and (np.asarray(point) < 2.0).all():
                        closest = np.linalg.norm(object_points - point, axis=1).argmin()
                        gt_point = object_points[closest]
                        projected = self.camera.project(gt_point[None])
                        if not self.camera.in_frame(projected).all():
                            continue  # point not in view
                        object_keypoints.append(np.asarray(point))
                        gt_points.append(gt_point)
                    else:
                        object_keypoints.append(None)
                        gt_points.append(None)
            gt_keypoints.append(gt_points)
            keypoints.append(object_keypoints)
        self.gt_keypoints.append(gt_keypoints)
        self.predicted_keypoints.append(keypoints)

    def summary(self) -> dict:
        errors, errors_xy = [], []
        missing = 0
        n_points = 0
        small_error = 0
        for gt, predicted in zip(self.gt_keypoints, self.predicted_keypoints):
            for gt_points, p_points in zip(gt, predicted):
                for gt_point, p_point in zip(gt_points, p_points):
                    n_points += 1
                    if p_point is not None:
                        err = float(np.linalg.norm(gt_point - p_point))
                        errors.append(err)
                        errors_xy.append(float(np.linalg.norm(gt_point[:2] - p_point[:2])))
                        if err < 0.03:
                            small_error += 1
                    else:
                        missing += 1
        if not n_points:
            return {"n_points": 0}
        errors = np.array(errors) * 100.0  # cm
        errors_xy = np.array(errors_xy) * 100.0
        return {
            "mean_cm": float(errors.mean()) if errors.size else float("nan"),
            "mean_xy_cm": float(errors_xy.mean()) if errors.size else float("nan"),
            "std_cm": float(errors.std()) if errors.size else float("nan"),
            "lt_3cm": small_error / n_points,
            "p25_cm": float(np.percentile(errors, 25)) if errors.size else float("nan"),
            "p75_cm": float(np.percentile(errors, 75)) if errors.size else float("nan"),
            "missing_pct": 100.0 * missing / n_points,
            "n_points": n_points,
        }

    def print_results(self):
        """The reference's rich table; the plain dict where rich is missing."""
        s = self.summary()
        try:
            from rich.console import Console
            from rich.table import Table
        except ImportError:
            print(s)
            return s
        table = Table(show_header=True)
        for col in ("mean", "mean xy", "std", "< 3cm", "25th percentile",
                    "75th percentile", "missing", "points"):
            table.add_column(col)
        if s["n_points"]:
            table.add_row(
                f"{s['mean_cm']}", f"{s['mean_xy_cm']}", f"{s['std_cm']}",
                f"{s['lt_3cm']}", f"{s['p25_cm']}", f"{s['p75_cm']}",
                f"{s['missing_pct']:.02f}%", f"{s['n_points']}",
            )
        Console().print(table)
        return s


def decoded_to_host(decoded: DecodedObjects) -> DecodedObjects:
    """A decoded batch as numpy arrays, copied from its device in one
    transfer (every field packed into one float32 tensor: masks and indices
    are small integers, exact in float32)."""
    n = decoded.center_valid.shape[0]
    packed = torch.cat([t.reshape(n, -1).to(torch.float32) for t in decoded], dim=1).cpu().numpy()
    out, start = [], 0
    for t in decoded:
        size = math.prod(t.shape[1:])
        part = packed[:, start:start + size].reshape(t.shape)
        out.append(part > 0.5 if t.dtype == torch.bool else
                   part.astype(torch.empty((), dtype=t.dtype).numpy().dtype))
        start += size
    return DecodedObjects(*out)


def decoded_to_objects(decoded, frame_index: int, keypoint_config) -> List[dict]:
    """One frame of a fixed-shape DecodedObjects batch (numpy, e.g. from
    ``decoded_to_host``, or tensors) as the reference pipeline's list of
    dicts."""
    def host(x):
        x = x[frame_index]
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    center_valid = host(decoded.center_valid)
    centers = host(decoded.center_points)
    center_p3d = host(decoded.center_p3d)
    kps = host(decoded.keypoints)
    kp_valid = host(decoded.keypoints_valid)
    kp_p3d = host(decoded.keypoints_p3d)

    objects = []
    for j in np.nonzero(center_valid)[0]:
        keypoints = [centers[j][None]]
        p_C = [center_p3d[j][None]]
        for t, cap in enumerate(keypoint_config):
            sel = kp_valid[j, t, :cap]
            keypoints.append(kps[j, t, :cap][sel])
            p_C.append(kp_p3d[j, t, :cap][sel] if sel.any() else None)
        objects.append({"p_centers": [], "keypoints": keypoints, "p_C": p_C})
    return objects


def prefix_batches(sequence: Sequence, batch_size: int, max_frames: Optional[int] = None):
    """The dataset's per-frame prefix entries in lists of ``batch_size``
    (the last may be shorter), at most ``max_frames`` entries in all."""
    entries = itertools.islice(sequence.dataset.iter_prefix(), max_frames)
    while batch := list(itertools.islice(entries, batch_size)):
        yield batch


def batch_frames(entries, device):
    """A batch's uint8 frames, uploaded once and normalized on ``device``:
    (N, 3, H, W) float32 (a view of NHWC memory)."""
    frames = torch.from_numpy(np.stack([e[0] for e in entries])).to(device)
    return normalize_frames(frames).permute(0, 3, 1, 2)


def batch_targets(sequence: Sequence, entries):
    """A batch's ground-truth maps, rendered on the sequence's device in one
    call: heatmaps (N, K, H, W), depth (N, K, H, W), centers (N, T, 2, H, W)."""
    dataset = sequence.dataset
    points_t = dataset.target_points(np.stack([e[1] for e in entries]))
    return dataset.render_targets(points_t, np.stack([e[2] for e in entries]),
                                  device=sequence.device)


def evaluate_sequence_fast(sequence: Sequence, inference_fn, keypoint_config,
                           batch_size: int = 8, max_frames: Optional[int] = None,
                           ground_truth: bool = False) -> Results:
    """Batched eval on the sequence's device: frames -> model ->
    ``decode_objects_batch`` -> Results.

    ``ground_truth=True`` skips the model (``inference_fn`` may be None) and
    decodes the rendered ground-truth maps instead."""
    cam = sequence.camera_small
    camera = CameraArrays.from_camera(cam, device=sequence.device)
    config = tuple(keypoint_config["keypoint_config"])
    results = Results()
    results.set_calibration(cam)
    for entries in prefix_batches(sequence, batch_size, max_frames):
        if ground_truth:
            maps = batch_targets(sequence, entries)
        else:
            maps = inference_fn(batch_frames(entries, sequence.device))
        heat, depth, centers = (t.to(sequence.device) for t in maps)
        decoded = decoded_to_host(decode_objects_batch(
            heat, depth, centers, camera, config, model=cam.distortion_model, max_peaks=16))
        for k, entry in enumerate(entries):
            results.add(entry[3], decoded_to_objects(decoded, k, config), sequence.world_points)
    return results


def example_maps(example, device):
    """An example's ground-truth maps as a one-frame batch on ``device``:
    heatmaps (1, K, H, W), depth (1, K, H, W), centers (1, T, 2, H, W)."""
    return (torch.from_numpy(np.transpose(example["heatmaps"], (2, 0, 1))[None]).to(device),
            torch.from_numpy(np.transpose(example["depth"], (2, 0, 1))[None]).to(device),
            torch.from_numpy(np.transpose(example["centers"], (2, 3, 0, 1))[None]).to(device))


def evaluate_sequence(sequence: Sequence, pipeline, ground_truth: bool = False,
                      max_frames: Optional[int] = None) -> Results:
    """Play a sequence frame by frame through a pipeline of
    ``pipeline.components`` and accumulate Results. Ground-truth maps are
    decoded on the sequence's device; a learned pipeline runs on its own."""
    results = Results()
    results.set_calibration(sequence.camera_small)
    pipeline.reset(sequence.camera_small)
    for example in itertools.islice(sequence.dataset, max_frames):
        if ground_truth:
            objects = pipeline(*example_maps(example, sequence.device))
        else:
            objects, _ = pipeline(np.transpose(example["frame"], (2, 0, 1))[None])
        results.add(example["T_WC"], objects, sequence.world_points)
    return results
