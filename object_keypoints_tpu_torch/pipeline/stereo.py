"""Stereo decode: two heatmap stacks -> matched, triangulated 3D keypoints.

Counterpart of ``object_keypoints_tpu/pipeline/stereo_jit.py``, the
reference's stereo-triangulated serve path:

    probs_l/probs_r (..., K, H, W)
      -> per-channel peak extraction (ops.decode)
      -> per-channel greedy epipolar matching (ops.associate) on
         undistorted coordinates
      -> undistort -> Hartley-Sturm correction -> DLT (geometry.stereo),
         masked over unmatched slots.

The JAX package vmaps over stereo pairs; here the leading dimensions are
batch dimensions, so a batch of pairs decodes in one pass of tensor ops with
no host synchronisation. Every slot is triangulated, matched or not (an
unmatched slot may give NaN), and ``torch.where`` keeps only the matched
ones.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from object_keypoints_tpu_torch.geometry import cameras as cam_ops
from object_keypoints_tpu_torch.geometry import stereo as stereo_ops
from object_keypoints_tpu_torch.ops import associate as assoc_ops
from object_keypoints_tpu_torch.ops import decode as decode_ops


class StereoRigArrays(NamedTuple):
    """Stereo rig parameters as tensors (equidistant fisheye both sides)."""

    K: torch.Tensor
    D: torch.Tensor
    Kp: torch.Tensor
    Dp: torch.Tensor
    T_RL: torch.Tensor
    F: torch.Tensor

    @classmethod
    def from_stereo_camera(cls, rig, device=None, dtype=torch.float32) -> "StereoRigArrays":
        """From a host ``StereoCamera`` (numpy float64 K, D, T_RL and F);
        float32 unless ``dtype`` says otherwise."""
        return cls(*(torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
                     for a in (rig.left_camera.K, rig.left_camera.D, rig.right_camera.K,
                               rig.right_camera.D, rig.T_RL, rig.F)))


class StereoDecoded(NamedTuple):
    """Fixed-shape stereo decode result, with the input's leading dimensions
    before K. M = max_peaks."""

    points_left: torch.Tensor  # (..., K, M, 2) sub-pixel (x, y)
    points_right: torch.Tensor  # (..., K, M, 2) matched right point of each left slot
    match_valid: torch.Tensor  # (..., K, M)
    points_3d: torch.Tensor  # (..., K, M, 3) left-camera frame, 0 where unmatched
    left_valid: torch.Tensor  # (..., K, M) raw left detections
    confidence: torch.Tensor  # (..., K, M) left detection confidence


def stereo_decode_triangulate(probs_l, probs_r, rig: StereoRigArrays, max_peaks: int = 16,
                              peak_threshold: float = 0.5,
                              epipolar_threshold: float = 2.0) -> StereoDecoded:
    """probs_l/probs_r (..., K, H, W) per-type probability maps of the left
    and right views of the same stereo pairs."""
    pts_l, conf_l, valid_l = decode_ops.extract_peaks(probs_l, max_peaks, peak_threshold)
    pts_r, _, valid_r = decode_ops.extract_peaks(probs_r, max_peaks, peak_threshold)

    und_l = cam_ops.fisheye_undistort_points(pts_l, rig.K, rig.D, P=rig.K)
    und_r = cam_ops.fisheye_undistort_points(pts_r, rig.Kp, rig.Dp, P=rig.Kp)
    assignment = assoc_ops.greedy_epipolar_match(
        stereo_ops.epipolar_distances(rig.F, und_l, und_r), valid_l, valid_r,
        threshold=epipolar_threshold, max_matches=max_peaks,
    )
    idx = torch.clamp(assignment, 0, max_peaks - 1).long()
    pts_r_matched = pts_r.gather(-2, idx[..., None].expand(*idx.shape, 2))
    match_valid = (assignment >= 0) & valid_l

    p3d = stereo_ops.triangulate_pixels(pts_l, pts_r_matched, rig.K, rig.D, rig.Kp, rig.Dp,
                                        rig.T_RL, rig.F)
    p3d = torch.where(match_valid[..., None], p3d, torch.zeros_like(p3d))
    return StereoDecoded(points_left=pts_l, points_right=pts_r_matched,
                         match_valid=match_valid, points_3d=p3d, left_valid=valid_l,
                         confidence=conf_l)


class StereoKeypointPipeline:
    """Host facade: one pair of heatmap stacks (K, H, W) in, per channel the
    matched left/right points and their 3D points (``p_L``) out, as numpy.
    The decode runs on the device of ``heatmaps_left`` (numpy: the CPU)."""

    def __init__(self, keypoint_config, max_peaks: int = 16, peak_threshold: float = 0.5,
                 epipolar_threshold: float = 2.0):
        self.keypoint_config = [1] + list(keypoint_config["keypoint_config"])
        self.max_peaks = max_peaks
        self.peak_threshold = peak_threshold
        self.epipolar_threshold = epipolar_threshold
        self.rig = None

    def reset(self, stereo_camera):
        self.rig = StereoRigArrays.from_stereo_camera(stereo_camera)

    def __call__(self, heatmaps_left, heatmaps_right):
        left = torch.as_tensor(heatmaps_left, dtype=torch.float32)
        out = stereo_decode_triangulate(
            left, torch.as_tensor(heatmaps_right, dtype=torch.float32, device=left.device),
            StereoRigArrays(*(a.to(left.device) for a in self.rig)),
            max_peaks=self.max_peaks, peak_threshold=self.peak_threshold,
            epipolar_threshold=self.epipolar_threshold,
        )
        valid, p3, pl, pr = (t.cpu().numpy() for t in
                             (out.match_valid, out.points_3d, out.points_left, out.points_right))
        return [{"points_left": pl[c][valid[c]], "points_right": pr[c][valid[c]],
                 "p_L": p3[c][valid[c]]}
                for c in range(len(self.keypoint_config))]
