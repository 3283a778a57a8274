"""Inference pipeline components: the reference's host API.

Counterpart of ``object_keypoints_tpu/pipeline/components.py``, with the
stereo components (``TriangulationComponent``, ``AssociationComponent``)
beside the monocular ones. The work is done by the batched tensor functions
of ``ops``, ``geometry`` and ``pipeline.decode``; these classes convert
between their fixed-shape masked tensors and the reference's ragged
list-of-dicts format on the host. The tensor work runs on the device of the
maps it is given (numpy: the CPU), so a pipeline fed from the card decodes
on the card; only the ragged results come back to the host. The JAX package
pads point counts to powers of two to keep jit shapes stable; eager torch
needs no padding, and padded slots are invalid, so the results are the
same.
"""

from __future__ import annotations

import numpy as np
import torch

from object_keypoints_tpu_torch.geometry import stereo as stereo_ops
from object_keypoints_tpu_torch.ops import associate as assoc_ops
from object_keypoints_tpu_torch.ops import decode as decode_ops
from object_keypoints_tpu_torch.pipeline.decode import CameraArrays, decode_objects


def _as_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class InferenceComponent:
    """Runs a model: an exported artifact directory (loaded with the port's
    ``load_inference_fn``: int8 where it holds quant.json, else float) or
    any callable ``frames -> (heatmaps, depth, centers)``. Frames go to the
    CUDA device when ``cuda`` is true, which raises if there is none, else
    to the CPU.
    ``infer`` returns the maps as tensors on that device; calling the
    component returns them as numpy arrays, as the reference does."""

    name = "inference"

    def __init__(self, model, cuda: bool = True):
        if cuda and not torch.cuda.is_available():
            raise RuntimeError("InferenceComponent(cuda=True) needs a CUDA device; "
                               "pass cuda=False to run on the CPU")
        self.device = torch.device("cuda" if cuda else "cpu")
        if callable(model):
            self.model = model
        else:
            from object_keypoints_tpu_torch.serving.export import load_inference_fn

            self.model = load_inference_fn(model, device=self.device)

    def infer(self, frames):
        return tuple(self.model(torch.as_tensor(frames, device=self.device)))

    def __call__(self, frames):
        return tuple(_as_numpy(t) for t in self.infer(frames))


class KeypointExtractionComponent:
    """Sub-pixel peak extraction.

    ``__call__`` takes one batch (returns ``(points, confidences)``) or two,
    the stereo form, returning ``((points_l, conf_l), (points_r, conf_r))``.
    ``points[frame][channel]`` is a list of (2,) arrays in (x, y) and
    ``confidences[frame][channel]`` the matching scores. Extraction runs
    on the device of a tensor batch (numpy: the CPU)."""

    name = "keypoints"
    PROBABILITY_CUTOFF = 0.1  # declared and unused, as in the reference

    def __init__(self, keypoint_config, prediction_size, bandwidth: float = 1.0,
                 max_peaks: int = 32, threshold: float = 0.5):
        del bandwidth  # accepted and ignored, as in the reference
        self.keypoint_config = [1] + list(keypoint_config["keypoint_config"])
        self.n_keypoints = sum(self.keypoint_config)
        self.prediction_size = tuple(prediction_size)
        self.max_peaks = max_peaks
        self.threshold = threshold

    def _extract_batch(self, frames):
        frames = torch.as_tensor(frames, dtype=torch.float32)
        if frames.shape[1] != len(self.keypoint_config):
            raise ValueError(f"expected {len(self.keypoint_config)} channels, "
                             f"got {frames.shape[1]}")
        pts, conf, valid = (_as_numpy(t) for t in decode_ops.extract_peaks(
            frames, self.max_peaks, self.threshold))
        keypoints, confidences = [], []
        for n in range(frames.shape[0]):
            keypoints.append([list(pts[n, c][valid[n, c]]) for c in range(frames.shape[1])])
            confidences.append([list(conf[n, c][valid[n, c]]) for c in range(frames.shape[1])])
        return keypoints, confidences

    def __call__(self, *frame_batches):
        results = [self._extract_batch(frames) for frames in frame_batches]
        return results[0] if len(results) == 1 else tuple(results)


class ObjectExtraction:
    """Center-offset association and capacity resolution of one frame's
    detections into objects (the reference's list-of-dicts). The
    association runs on the device of ``centers`` (numpy: the CPU)."""

    def __init__(self, keypoint_config, prediction_size, reject_distance: float = 20.0):
        self.keypoint_config = list(keypoint_config["keypoint_config"])
        self.prediction_size = tuple(prediction_size)
        self.reject_distance = reject_distance

    def __call__(self, keypoints, confidence, centers):
        if len(keypoints[0]) == 0:
            return []
        center_points = np.stack(keypoints[0])
        T = len(keypoints) - 1
        M = max([len(k) for k in keypoints] + [1])
        pts = np.zeros((T, M, 2), np.float32)
        conf = np.zeros((T, M), np.float32)
        valid = np.zeros((T, M), bool)
        for t in range(T):
            for m, p in enumerate(keypoints[1 + t]):
                pts[t, m] = p
                conf[t, m] = confidence[1 + t][m]
                valid[t, m] = True

        centers = torch.as_tensor(centers, dtype=torch.float32)
        device = centers.device
        assignment, predicted_centers = (_as_numpy(t) for t in assoc_ops.assign_to_centers(
            torch.from_numpy(pts).to(device), torch.from_numpy(valid).to(device), centers,
            torch.from_numpy(center_points.astype(np.float32)).to(device),
            torch.ones(len(center_points), dtype=torch.bool, device=device),
            reject_distance=self.reject_distance,
        ))

        objects = [{"center": center, "heatmap_points": [[] for _ in range(T)],
                    "confidence": [[] for _ in range(T)], "p_centers": []}
                   for center in center_points]
        for t in range(T):
            for m in range(M):
                j = assignment[t, m]
                if not valid[t, m] or j < 0:
                    continue
                objects[j]["p_centers"].append(predicted_centers[t, m])
                objects[j]["heatmap_points"][t].append(pts[t, m])
                objects[j]["confidence"][t].append(conf[t, m])

        for obj in objects:
            for t in range(T):
                if len(obj["heatmap_points"][t]) == 0:
                    obj["heatmap_points"][t] = np.array([])
                    continue
                points = np.stack(obj["heatmap_points"][t])
                confidences = np.stack(obj["confidence"][t])
                cap = self.keypoint_config[t]
                if points.shape[0] > cap:
                    if cap == 1:
                        points = points[confidences.argmax(axis=0)][None]
                    else:
                        points = _as_numpy(assoc_ops.masked_kmeans(
                            torch.from_numpy(points).to(device),
                            torch.ones(len(points), dtype=torch.bool, device=device),
                            torch.from_numpy(confidences).to(device), cap,
                        ))
                obj["heatmap_points"][t] = points
        return objects


class DetectionToPoint:
    """2D detections + depth map -> camera-frame 3D points: undistort, read
    the depth at the rounded undistorted pixel, unproject. The host camera
    works in float64 numpy; a depth map given as a tensor stays on its
    device, and only the depths read at the pixels come back."""

    def reset(self, camera):
        self.camera = camera
        self.min_index = np.zeros(2, np.int32)
        self.max_index = camera.image_size[::-1].astype(np.int32) - 1

    def __call__(self, xy, p_depth):
        if xy.shape[0] == 0:
            return None
        xy = self.camera.undistort(np.asarray(xy, np.float64))
        xy_int = np.clip(np.round(xy).astype(np.int32), self.min_index, self.max_index)
        p_depth = torch.as_tensor(p_depth)
        idx = torch.as_tensor(xy_int, dtype=torch.long, device=p_depth.device)
        zs = _as_numpy(p_depth[idx[:, 1], idx[:, 0]])
        return self.camera.unproject(xy, zs)


class TriangulationComponent:
    """Matched stereo pixels -> 3D points in the left camera frame
    (``StereoCamera.triangulate``)."""

    name = "triangulation"

    def reset(self, stereo_camera):
        self.stereo_camera = stereo_camera

    def __call__(self, left_points, right_points):
        return self.stereo_camera.triangulate(np.asarray(left_points, np.float64),
                                              np.asarray(right_points, np.float64))


class AssociationComponent:
    """Greedy mutually exclusive epipolar matching of left and right
    detections: per left point, the index of its right match or -1. The
    distance is the right point's distance to the left point's epipolar
    line; globally nearest pairs go first."""

    name = "association"

    def __init__(self, threshold: float = 2.0):
        self.threshold = threshold
        self.stereo_camera = None

    def reset(self, stereo_camera):
        self.stereo_camera = stereo_camera
        self.F = torch.as_tensor(stereo_camera.F, dtype=torch.float32)

    def __call__(self, left_points, right_points):
        left = torch.as_tensor(np.asarray(left_points, np.float32))
        right = torch.as_tensor(np.asarray(right_points, np.float32))
        assignment = assoc_ops.greedy_epipolar_match(
            stereo_ops.epipolar_distances(self.F, left, right),
            torch.ones(len(left), dtype=torch.bool), torch.ones(len(right), dtype=torch.bool),
            threshold=self.threshold, max_matches=min(len(left), len(right)),
        )
        return assignment.numpy()


class ObjectKeypointPipeline:
    """Monocular decode: heatmaps, depth and center offsets of one frame
    (leading dimension 1) -> objects with 3D keypoints. ``points_3d`` is
    accepted and unused, as in the reference. Tensor maps are decoded on
    their device (numpy: the CPU)."""

    def __init__(self, prediction_size, points_3d, keypoint_config, max_peaks: int = 32):
        self.keypoint_extraction = KeypointExtractionComponent(
            keypoint_config, prediction_size, max_peaks=max_peaks)
        self.object_extraction = ObjectExtraction(keypoint_config, prediction_size)
        self.detection_to_point = DetectionToPoint()
        self.prediction_size = tuple(prediction_size)
        self.keypoint_config = tuple(keypoint_config["keypoint_config"])
        self.max_peaks = max_peaks
        self._camera = None

    def reset(self, camera):
        self._camera = camera
        self.detection_to_point.reset(camera)

    def __call__(self, heatmap, p_depth, p_centers):
        heatmap = torch.as_tensor(heatmap)
        if heatmap.shape[0] != 1:
            raise ValueError(f"one frame at a time, got {heatmap.shape[0]}")
        p_centers = torch.as_tensor(p_centers, device=heatmap.device)[0]
        p_depth = torch.as_tensor(p_depth, device=heatmap.device)[0]
        points, confidence = self.keypoint_extraction(heatmap)
        objects = []
        for obj in self.object_extraction(points[0], confidence[0], p_centers):
            world_points = [self.detection_to_point(obj["center"][None], p_depth[0])]
            for i, points_i in enumerate(obj["heatmap_points"]):
                world_points.append(self.detection_to_point(points_i, p_depth[1 + i]))
            objects.append({"p_centers": obj["p_centers"],
                            "keypoints": [obj["center"][None]] + obj["heatmap_points"],
                            "p_C": world_points})
        return objects

    def decode_device(self, probs, depth, offsets):
        """The fixed-shape decode (``pipeline.decode.decode_objects``) of one
        frame, on the device the maps are on; returns ``DecodedObjects``."""
        probs = torch.as_tensor(probs)
        return decode_objects(
            probs, torch.as_tensor(depth, device=probs.device),
            torch.as_tensor(offsets, device=probs.device),
            CameraArrays.from_camera(self._camera, device=probs.device), self.keypoint_config,
            model=self._camera.distortion_model, max_peaks=self.max_peaks,
        )


class LearnedKeypointTrackingPipeline(ObjectKeypointPipeline):
    """``ObjectKeypointPipeline`` behind model inference: the decode runs on
    the inference device (``cuda=True``: the card); the heatmaps are
    returned as numpy, as in the reference."""

    def __init__(self, model, cuda: bool = True, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.inference = InferenceComponent(model, cuda)

    def __call__(self, frame):
        heatmap, depth, centers = self.inference.infer(frame)
        return super().__call__(heatmap, depth, centers), _as_numpy(heatmap)
