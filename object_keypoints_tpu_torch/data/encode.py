"""Sequence directories: the writer.

The port's copy of ``object_keypoints_tpu/data/encode.py``. A sequence
directory holds 'camera_transform' (N, 4, 4) world-from-camera poses in
data.hdf5, frames.mp4 (+ a preview mp4), keypoints.json and
calibration.yaml. cv2 and h5py are imported by the methods that need them,
so writing labels alone needs neither.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np


class SequenceWriter:
    """Writes frames + poses (+ labels/calibration) in the reference's
    sequence-directory layout."""

    def __init__(self, out_dir: str, fps: float = 30.0, fourcc: str = "mp4v",
                 preview: bool = True):
        self.out_dir = str(out_dir)
        os.makedirs(self.out_dir, exist_ok=True)
        self.fps = fps
        self.fourcc = fourcc
        self.preview = preview
        self._writer = None
        self._preview_writer = None
        self._poses = []
        self._size = None

    def add_frame(self, image_rgb: np.ndarray, T_WC: np.ndarray):
        import cv2

        h, w = image_rgb.shape[:2]
        if self._writer is None:
            self._size = (w, h)
            code = cv2.VideoWriter_fourcc(*self.fourcc)
            self._writer = cv2.VideoWriter(
                os.path.join(self.out_dir, "frames.mp4"), code, self.fps, (w, h)
            )
            if self.preview:
                pw = min(1280, w)
                ph = int(round(h * pw / w))
                self._preview_size = (pw, ph)
                self._preview_writer = cv2.VideoWriter(
                    os.path.join(self.out_dir, "frames_preview.mp4"), code, self.fps,
                    self._preview_size,
                )
        if (w, h) != self._size:
            raise ValueError(f"frame of {w}x{h}, the sequence's frames are "
                             f"{self._size[0]}x{self._size[1]}")
        bgr = cv2.cvtColor(image_rgb, cv2.COLOR_RGB2BGR)
        self._writer.write(bgr)
        if self._preview_writer is not None:
            self._preview_writer.write(cv2.resize(bgr, self._preview_size))
        self._poses.append(np.asarray(T_WC, np.float64))

    def write_calibration(self, calibration_file: str):
        shutil.copy(calibration_file, os.path.join(self.out_dir, "calibration.yaml"))

    def write_keypoints(self, points_3d: np.ndarray):
        """keypoints.json in the labeler's format."""
        with open(os.path.join(self.out_dir, "keypoints.json"), "wt") as f:
            json.dump({"3d_points": np.asarray(points_3d).tolist()}, f)

    def close(self):
        import h5py

        if self._writer is not None:
            self._writer.release()
        if self._preview_writer is not None:
            self._preview_writer.release()
        with h5py.File(os.path.join(self.out_dir, "data.hdf5"), "w") as f:
            f.create_dataset("camera_transform", data=np.stack(self._poses))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
