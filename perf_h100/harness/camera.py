"""The serve path's camera: a Kalibr equidistant camera through bench.py's
chain (scale to 511 rows, cut the centred 511 x 511 square, scale to the
output grid), in float64 on the host.

The configuration file holds the calibration (``camera``: intrinsics [fx,
fy, cx, cy], distortion_coeffs, resolution [w, h]); this module computes
K, D, Kinv and image_size (h, w), the fields both the program's camera
arrays and the reference decode take.
"""

from __future__ import annotations

import types

import numpy as np
import torch


def serve_camera(calib: dict, frame: int, grid: int):
    fx, fy, cx, cy = calib["intrinsics"]
    K = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])
    size = np.array(calib["resolution"][::-1], dtype=np.float64)  # (h, w)

    def scale(K, size, s):
        K = K.copy()
        K[0, 0] *= s
        K[1, 1] *= s
        K[0, 2] *= s
        K[1, 2] *= s
        return K, size * s

    s0 = frame / size[0]
    K, size = scale(K, size, s0)
    offset = np.array([(s0 * calib["resolution"][0] - frame) / 2.0, 0.0])
    K[0, 2] -= offset[0]
    K[1, 2] -= offset[1]
    size = size - 2.0 * offset[::-1]
    K, size = scale(K, size, grid / frame)
    return types.SimpleNamespace(K=K, D=np.asarray(calib["distortion_coeffs"], np.float64),
                                 Kinv=np.linalg.inv(K), image_size=size)


def camera_tensors(camera, device, dtype=torch.float32):
    return tuple(torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
                 for a in (camera.K, camera.D, camera.Kinv, camera.image_size))
