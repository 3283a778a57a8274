"""Object decoding: heatmaps -> associated 3D keypoints, fixed shapes.

Counterpart of ``object_keypoints_tpu/pipeline/decode_jit.py``:

    probs (N, 1+T, H, W), depth (N, 1+T, H, W), offsets (N, T, 2, H, W)
      -> peak extraction (ops.decode)
      -> center association (ops.associate.assign_to_centers)
      -> per-(object, type) capacity resolution (argmax / masked k-means)
      -> undistort + depth lookup + unprojection into the camera frame.

Every center peak founds an object; ``max_peaks`` detections per map. The
JAX package vmaps over frames and objects; here both are batch dimensions,
so a batch decodes in one pass of tensor ops with no host synchronisation.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from object_keypoints_tpu_torch.geometry import cameras as cam_ops
from object_keypoints_tpu_torch.ops import associate as assoc_ops
from object_keypoints_tpu_torch.ops import decode as decode_ops
from object_keypoints_tpu_torch.utils import timer


class CameraArrays(NamedTuple):
    """Camera parameters as fp32 tensors (the model is a separate string)."""

    K: torch.Tensor
    D: torch.Tensor
    Kinv: torch.Tensor
    image_size: torch.Tensor  # (height, width)

    @classmethod
    def from_camera(cls, camera, device=None) -> "CameraArrays":
        """From a host camera with numpy K, D, Kinv and image_size."""
        return cls(*(torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
                     for a in (camera.K, camera.D, camera.Kinv, camera.image_size)))


class DecodedObjects(NamedTuple):
    """Fixed-shape decode result, with a leading frame dimension N from
    ``decode_objects_batch``. M = max peaks, T = keypoint types, C = max
    capacity over types."""

    center_points: torch.Tensor  # (M, 2) sub-pixel (x, y)
    center_valid: torch.Tensor  # (M,)
    center_p3d: torch.Tensor  # (M, 3) camera frame
    keypoints: torch.Tensor  # (M, T, C, 2)
    keypoints_valid: torch.Tensor  # (M, T, C)
    keypoints_p3d: torch.Tensor  # (M, T, C, 3)
    predicted_centers: torch.Tensor  # (T, M, 2) center votes of raw detections
    assignment: torch.Tensor  # (T, M) raw-detection -> object index or -1
    raw_points: torch.Tensor  # (T, M, 2) raw per-type detections
    raw_valid: torch.Tensor  # (T, M)


def _lift(points, valid, depth_plane, camera: CameraArrays, model: str):
    """Undistort, read depth at the rounded *undistorted* pixel, unproject.

    points (N, ..., 2), valid (N, ...), depth_plane (N, H, W) -> (N, ..., 3).
    """
    und = cam_ops.undistort_points(points, camera.K, camera.D, camera.K, model)
    n, ph, pw = depth_plane.shape
    cam_h = camera.image_size[0].to(torch.int64)  # truncates, like astype(int32)
    cam_w = camera.image_size[1].to(torch.int64)
    xy_int = torch.round(und).to(torch.int64)
    # clip to the camera's image, then to the plane (a JAX gather clamps)
    x = torch.minimum(xy_int[..., 0].clamp(min=0), cam_w - 1).clamp(0, pw - 1)
    y = torch.minimum(xy_int[..., 1].clamp(min=0), cam_h - 1).clamp(0, ph - 1)
    z = depth_plane.reshape(n, -1).gather(1, (y * pw + x).reshape(n, -1)).reshape(x.shape)
    p3d = cam_ops.unproject(und, z, camera.Kinv)
    return torch.where(valid[..., None], p3d, torch.zeros_like(p3d))


def decode_objects_batch(probs, depth, offsets, camera: CameraArrays, keypoint_config,
                         model: str = "equidistant", max_peaks: int = 32,
                         reject_distance: float = 20.0,
                         peak_threshold: float = 0.5) -> DecodedObjects:
    """Decode a batch. probs (N, 1+T, H, W) probabilities with channel 0 the
    object-center map; depth (N, 1+T, H, W); offsets (N, T, 2, H, W);
    keypoint_config: per-type capacities, e.g. (1, 3) for the valve. A call
    is the span ``decode``, its stages ``decode.peaks``, ``decode.assign``,
    ``decode.capacity`` and ``decode.lift`` (``utils.timer``)."""
    T = len(keypoint_config)
    if probs.shape[1] != T + 1:
        raise ValueError(f"probs has {probs.shape[1]} maps, keypoint_config {keypoint_config} "
                         f"needs {T + 1}")
    with timer.span("decode"):
        return _decode_batch(probs, depth, offsets, camera, keypoint_config, model, max_peaks,
                             reject_distance, peak_threshold)


def _decode_batch(probs, depth, offsets, camera, keypoint_config, model, max_peaks,
                  reject_distance, peak_threshold) -> DecodedObjects:
    T = len(keypoint_config)
    with timer.span("decode.peaks"):
        points, conf, valid = decode_ops.extract_peaks(probs, max_peaks, peak_threshold)
    center_points, center_valid = points[:, 0], valid[:, 0]
    type_points, type_conf, type_valid = points[:, 1:], conf[:, 1:], valid[:, 1:]

    with timer.span("decode.assign"):
        assignment, predicted_centers = assoc_ops.assign_to_centers(
            type_points, type_valid, offsets, center_points, center_valid,
            reject_distance=reject_distance,
        )

    n, m = probs.shape[0], max_peaks
    max_cap = max(keypoint_config)
    with timer.span("decode.capacity"):
        objects = torch.arange(m, device=probs.device, dtype=assignment.dtype)
        per_type_points, per_type_valid = [], []
        for t, capacity in enumerate(keypoint_config):
            # (N, objects, detections): detection j of type t belongs to object i
            mask = (assignment[:, t, None, :] == objects[:, None]) & type_valid[:, t, None, :]
            out, out_valid = assoc_ops.resolve_capacity(
                type_points[:, t, None].expand(n, m, m, 2), mask,
                type_conf[:, t, None].expand(n, m, m), capacity,
            )
            pad = max_cap - capacity
            per_type_points.append(F.pad(out, (0, 0, 0, pad)))
            per_type_valid.append(F.pad(out_valid, (0, pad)))

        keypoints = torch.stack(per_type_points, dim=2)  # (N, M, T, C, 2)
        keypoints_valid = torch.stack(per_type_valid, dim=2) & center_valid[:, :, None, None]

    with timer.span("decode.lift"):
        center_p3d = _lift(center_points, center_valid, depth[:, 0], camera, model)
        keypoints_p3d = torch.stack(
            [_lift(keypoints[:, :, t], keypoints_valid[:, :, t], depth[:, 1 + t], camera, model)
             for t in range(T)], dim=2,
        )
    return DecodedObjects(
        center_points=center_points,
        center_valid=center_valid,
        center_p3d=center_p3d,
        keypoints=keypoints,
        keypoints_valid=keypoints_valid,
        keypoints_p3d=keypoints_p3d,
        predicted_centers=predicted_centers,
        assignment=assignment,
        raw_points=type_points,
        raw_valid=type_valid,
    )


def decode_objects(probs, depth, offsets, camera: CameraArrays, keypoint_config,
                   model: str = "equidistant", max_peaks: int = 32,
                   reject_distance: float = 20.0, peak_threshold: float = 0.5) -> DecodedObjects:
    """Decode one frame: probs/depth (1+T, H, W), offsets (T, 2, H, W)."""
    out = decode_objects_batch(probs[None], depth[None], offsets[None], camera,
                               keypoint_config, model, max_peaks, reject_distance,
                               peak_threshold)
    return DecodedObjects(*(a[0] for a in out))
