"""Labeling core: frame-pair selection, two-view triangulation, label IO.

The port's copy of ``object_keypoints_tpu/labeling.py``, the headless core of
the reference's StereoLabel GUI (its scripts/label.py), on the port's
float64 geometry (``geometry.linalg``, ``geometry.stereo``,
``geometry.cameras``):

- ``find_furthest_frames``: scan pose pairs for the most view-orthogonal,
  >= 0.1 m apart frames (label.py:113-134: a stride of n // 30, the least
  |z_i . z_j|; the first pair in scan order wins a tie);
- ``triangulate_pair``: two-frame triangulation of one click pair: undistort
  both clicks with P = K, DLT against P1 = K[I|0] and P2 = K[I|0] T_RL, T_RL
  the relative pose of the two frames, then lift to the world by T_WL
  (label.py:285-305);
- ``LabelingSession``: command-pattern point entry with undo (label.py:34-69,
  255-258), saving once the counts are equal (label.py:269-283) into the
  keypoints.json format (label.py:24-30).

h5py is imported where a session opens a sequence's data.hdf5.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from object_keypoints_tpu_torch.constants import KEYPOINT_FILENAME
from object_keypoints_tpu_torch.geometry import linalg
from object_keypoints_tpu_torch.geometry import stereo as stereo_ops
from object_keypoints_tpu_torch.geometry.cameras import from_calibration


def _f64(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def write_points(out_file: str, points_w) -> None:
    """keypoints.json in the reference's format (label.py:24-30)."""
    contents = {"3d_points": [np.asarray(x).ravel().tolist() for x in points_w]}
    with open(out_file, "w") as f:
        f.write(json.dumps(contents))


def read_points(path: str) -> np.ndarray:
    with open(path, "rt") as f:
        return np.array(json.load(f)["3d_points"])


def find_furthest_frames(poses: np.ndarray, stride: Optional[int] = None,
                         min_baseline: float = 0.1) -> Tuple[int, int]:
    """Most view-orthogonal pose pair with enough baseline
    (label.py:113-134)."""
    n = poses.shape[0]
    stride = stride or max(n // 30, 1)
    best = (None, None)
    value = 1.0
    for i in range(0, n, stride):
        for j in range(i, n, stride):
            T_WL, T_WR = poses[i], poses[j]
            if np.linalg.norm(T_WL[:3, 3] - T_WR[:3, 3]) < min_baseline:
                continue
            dot = abs(float(T_WL[2, :3] @ T_WR[2, :3]))
            if dot < value:
                value = dot
                best = (i, j)
    return best


def triangulate_pair(camera, T_WL, T_WR, left_point, right_point) -> np.ndarray:
    """Two-frame triangulation of one click pair -> world point
    (label.py:285-305)."""
    T_RW = linalg.inv_transform(_f64(T_WR)).numpy()
    T_RL = T_RW @ np.asarray(T_WL, np.float64)
    x = camera.undistort(np.asarray(left_point, np.float64)[None])
    xp = camera.undistort(np.asarray(right_point, np.float64)[None])
    P1 = camera.K @ np.eye(3, 4)
    P2 = camera.K @ np.eye(3, 4) @ T_RL
    p_L = stereo_ops.triangulate_linear(_f64(P1), _f64(P2), _f64(x), _f64(xp))[0]
    return linalg.transform_points(_f64(T_WL), p_L).numpy()


@dataclasses.dataclass
class AddPointCommand:
    """Command-pattern point entry with undo (label.py:34-69)."""

    side: str  # 'left' | 'right'
    point: np.ndarray

    def forward(self, session: "LabelingSession"):
        session.points(self.side).append(np.asarray(self.point, np.float64))

    def undo(self, session: "LabelingSession"):
        pts = session.points(self.side)
        if pts:
            pts.pop()


class LabelingSession:
    """Headless labeling state machine for one sequence directory."""

    def __init__(self, sequence_dir: str, calibration: Optional[str] = None):
        import h5py

        self.sequence_dir = str(sequence_dir)
        with h5py.File(os.path.join(self.sequence_dir, "data.hdf5"), "r") as f:
            self.poses = f["camera_transform"][:]
        calibration = calibration or os.path.join(self.sequence_dir, "calibration.yaml")
        self.camera = from_calibration(calibration)
        self.left_frame_index, self.right_frame_index = find_furthest_frames(self.poses)
        self.left_keypoints: List[np.ndarray] = []
        self.right_keypoints: List[np.ndarray] = []
        self.world_points: List[np.ndarray] = []
        self.commands: List[AddPointCommand] = []

    def points(self, side: str) -> List[np.ndarray]:
        return self.left_keypoints if side == "left" else self.right_keypoints

    def add_point(self, side: str, xy) -> None:
        command = AddPointCommand(side, np.asarray(xy, np.float64))
        command.forward(self)
        self.commands.append(command)

    def undo(self) -> None:
        if self.commands:
            self.commands.pop().undo(self)

    def swap_frames(self, left: Optional[int] = None, right: Optional[int] = None):
        """Re-pick labeling frames (label.py keys a/b, :243-253)."""
        if left is not None:
            self.left_frame_index = left
        if right is not None:
            self.right_frame_index = right

    def triangulate_all(self) -> List[np.ndarray]:
        if len(self.left_keypoints) != len(self.right_keypoints):
            raise AssertionError("label counts must match before saving (label.py:269)")
        T_WL = self.poses[self.left_frame_index]
        T_WR = self.poses[self.right_frame_index]
        self.world_points = [
            triangulate_pair(self.camera, T_WL, T_WR, l, r)
            for l, r in zip(self.left_keypoints, self.right_keypoints)
        ]
        return self.world_points

    def backproject(self, frame_index: int) -> np.ndarray:
        """Project current world points into a frame (for label QA overlay,
        label.py:307-322)."""
        T_CW = linalg.inv_transform(_f64(self.poses[frame_index])).numpy()
        return self.camera.project(np.stack(self.world_points), T_CW)

    def save(self) -> str:
        self.triangulate_all()
        out_file = os.path.join(self.sequence_dir, KEYPOINT_FILENAME)
        write_points(out_file, self.world_points)
        return out_file
