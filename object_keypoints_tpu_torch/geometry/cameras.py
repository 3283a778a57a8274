"""Camera models: equidistant fisheye and radtan, as torch tensor functions.

Counterpart of ``object_keypoints_tpu/geometry/cameras.py``. Undistortion
runs a fixed number of iterations (10 Newton steps for the fisheye, 20
fixed-point steps for radtan), so it has no data-dependent control flow.
Everything is elementwise: no matmul, so TF32 settings cannot touch it.

The calibration helpers and the host classes (``PinholeCamera``,
``RadTanPinholeCamera``, ``FisheyeCamera``, ``StereoCamera``) work in numpy
float64 on the host; their methods run the tensor functions on CPU float64
tensors and return numpy arrays. The JAX package runs the same methods in
float32 (x64 off), so the two agree to float32 rounding, not bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import yaml

from object_keypoints_tpu_torch.geometry import linalg

NEWTON_ITERS = 10  # OpenCV's fisheye undistort iteration budget
RADTAN_ITERS = 20


def apply_K(xy, K):
    """(..., 2) normalized image coords -> pixel coords."""
    return torch.stack([xy[..., 0] * K[0, 0] + K[0, 2], xy[..., 1] * K[1, 1] + K[1, 2]], dim=-1)


def apply_Kinv(uv, K):
    """(..., 2) pixel coords -> normalized image coords."""
    return torch.stack([(uv[..., 0] - K[0, 2]) / K[0, 0], (uv[..., 1] - K[1, 2]) / K[1, 1]],
                       dim=-1)


def fisheye_distort_normalized(xy, D):
    """Apply the equidistant distortion to normalized pinhole coords."""
    r = torch.sqrt(torch.sum(xy * xy, dim=-1))
    theta = torch.atan(r)
    th2 = theta * theta
    theta_d = theta * (1.0 + th2 * (D[0] + th2 * (D[1] + th2 * (D[2] + th2 * D[3]))))
    scale = torch.where(r > 1e-12, theta_d / torch.clamp(r, min=1e-12), torch.ones_like(r))
    return xy * scale[..., None]


def fisheye_project(points_C, K, D):
    """Camera-frame 3D points (..., 3) -> fisheye pixels (..., 2)."""
    ab = points_C[..., :2] / points_C[..., 2:3]
    return apply_K(fisheye_distort_normalized(ab, D), K)


def fisheye_undistort_normalized(xy_dist, D):
    """Invert the equidistant distortion: theta from theta_d by 10 Newton
    steps (the update cv2.fisheye.undistortPoints runs)."""
    theta_d = torch.sqrt(torch.sum(xy_dist * xy_dist, dim=-1))
    theta_d_c = torch.clamp(theta_d, -math.pi, math.pi)
    theta = theta_d_c
    for _ in range(NEWTON_ITERS):
        th2 = theta * theta
        th4 = th2 * th2
        k0, k1, k2, k3 = D[0] * th2, D[1] * th4, D[2] * (th4 * th2), D[3] * (th4 * th4)
        f = theta * (1.0 + k0 + k1 + k2 + k3) - theta_d_c
        fp = 1.0 + 3.0 * k0 + 5.0 * k1 + 7.0 * k2 + 9.0 * k3
        theta = theta - f / fp
    scale = torch.where(theta_d > 1e-9, torch.tan(theta) / torch.clamp(theta_d, min=1e-9),
                        torch.ones_like(theta_d))
    return xy_dist * scale[..., None]


def fisheye_undistort_points(uv, K, D, P=None):
    """Pixel coords -> undistorted pixel coords through ``P`` (or
    normalized coords when ``P`` is None)."""
    xy = fisheye_undistort_normalized(apply_Kinv(uv, K), D)
    return xy if P is None else apply_K(xy, P)


def _radtan_distort_terms(xy, D):
    k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * k2)
    dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return radial, torch.stack([dx, dy], dim=-1)


def radtan_distort_normalized(xy, D):
    radial, tang = _radtan_distort_terms(xy, D)
    return xy * radial[..., None] + tang


def radtan_project(points_C, K, D):
    """Camera-frame 3D points (..., 3) -> radtan pixels (..., 2), as
    cv2.projectPoints with four distortion coefficients."""
    xy = points_C[..., :2] / points_C[..., 2:3]
    return apply_K(radtan_distort_normalized(xy, D), K)


def project_points(points_W, T_CW, K, D, model: str):
    """World points (..., 3) -> pixels (..., 2) for either distortion model."""
    p_C = linalg.transform_points(T_CW, points_W)
    if model == "equidistant":
        return fisheye_project(p_C, K, D)
    if model == "radtan":
        return radtan_project(p_C, K, D)
    raise ValueError(f"Unknown distortion model {model!r}")


def radtan_undistort_normalized(xy_dist, D):
    """Fixed-point inversion of the radtan distortion (cv2.undistortPoints)."""
    xy = xy_dist
    for _ in range(RADTAN_ITERS):
        radial, tang = _radtan_distort_terms(xy, D)
        xy = (xy_dist - tang) / radial[..., None]
    return xy


def radtan_undistort_points(uv, K, D, P=None):
    xy = radtan_undistort_normalized(apply_Kinv(uv, K), D)
    return xy if P is None else apply_K(xy, P)


def undistort_points(uv, K, D, P, model: str):
    """Pixel coords -> undistorted pixel coords for either distortion model."""
    if model == "equidistant":
        return fisheye_undistort_points(uv, K, D, P)
    if model == "radtan":
        return radtan_undistort_points(uv, K, D, P)
    raise ValueError(f"Unknown distortion model {model!r}")


def unproject(uv, z, Kinv):
    """Pixel coords (..., 2) + depth (...,) -> camera-frame points (..., 3),
    pinhole (undistort first), exact fp32."""
    xyw = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
    rays = torch.sum(Kinv * xyw[..., None, :], dim=-1)
    return rays * z[..., None]


# ---------------------------------------------------------------------------
# Calibration-file helpers (host, numpy float64)
# ---------------------------------------------------------------------------


def camera_matrix(intrinsics):
    """[fx, fy, cx, cy] -> 3x3 K."""
    fx, fy, cx, cy = intrinsics
    return np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])


def projection_matrix(K, T_CW):
    """K @ T_CW[:3, :], the 3x4 projection matrix."""
    return np.asarray(K) @ np.asarray(T_CW)[:3, :]


def scale_camera_matrix(K, scaling_factor):
    """Scale focal lengths and principal point by (sx, sy)."""
    out = np.array(K, copy=True)
    out[0, 0] = K[0, 0] * scaling_factor[0]
    out[1, 1] = K[1, 1] * scaling_factor[1]
    out[0, 2] = K[0, 2] * scaling_factor[0]
    out[1, 2] = K[1, 2] * scaling_factor[1]
    return out


def fundamental_matrix(T_RL, K, Kp):
    """Fundamental matrix of the rig, l_R = F @ x_L (left pixel -> right
    epipolar line): F = Kp^-T R K^T [e]x with e = K R^T t, in float64 (the
    JAX package rounds the epipole to float32 first, a ~1e-7 relative
    difference)."""
    T_RL = np.asarray(T_RL, dtype=np.float64)
    R, t = T_RL[:3, :3], T_RL[:3, 3]
    C = linalg.skew_matrix(torch.from_numpy(K @ R.T @ t)).numpy()
    return np.linalg.inv(Kp).T @ R @ K.T @ C


def load_calibration_params(calibration_file):
    """Kalibr stereo calibration -> dict with K, Kp, D, Dp, T_LR, T_RL and
    image_size (height, width)."""
    with open(calibration_file, "rt") as f:
        calibration = yaml.safe_load(f)
    left, right = calibration["cam0"], calibration["cam1"]
    T_RL = np.array(right["T_cn_cnm1"])
    T_LR = np.eye(4)
    T_LR[:3, :3] = T_RL[:3, :3].T
    T_LR[:3, 3] = -T_LR[:3, :3] @ T_RL[:3, 3]
    return {
        "K": camera_matrix(left["intrinsics"]),
        "Kp": camera_matrix(right["intrinsics"]),
        "D": np.array(left["distortion_coeffs"]),
        "Dp": np.array(right["distortion_coeffs"]),
        "T_LR": T_LR,
        "T_RL": T_RL,
        "image_size": right["resolution"][::-1],
    }


def from_calibration(calibration_file):
    """The cam0 camera of a Kalibr YAML."""
    with open(calibration_file, "rt") as f:
        camera = yaml.safe_load(f)["cam0"]
    K = camera_matrix(camera["intrinsics"])
    D = np.array(camera["distortion_coeffs"])
    if camera["camera_model"] == "pinhole":
        if camera["distortion_model"] == "equidistant":
            return FisheyeCamera(K, D, camera["resolution"][::-1])
        if camera["distortion_model"] == "radtan":
            return RadTanPinholeCamera(K, D, camera["resolution"][::-1])
    raise ValueError(f"Unrecognized calibration type {camera['distortion_model']}.")


# ---------------------------------------------------------------------------
# Host classes (numpy float64 in and out)
# ---------------------------------------------------------------------------


def _f64(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


class PinholeCamera:
    """Pinhole camera on the host: K, Kinv, D and image_size (height, width),
    all float64. ``project``/``undistort`` follow ``distortion_model``.

    Like the JAX package (and the reference it follows), ``scale`` and
    ``cut`` return a ``FisheyeCamera`` whatever the subclass."""

    distortion_model = "none"

    def __init__(self, K, D, image_size):
        self.K = np.asarray(K, dtype=np.float64)
        self.Kinv = np.linalg.inv(self.K)
        self.D = np.asarray(D, dtype=np.float64)
        self.image_size = np.array(image_size, dtype=np.float64)
        if abs(self.K[0, 2] * 2.0 - self.image_size[1]) >= 0.05 * self.image_size[1]:
            raise ValueError(f"principal point {self.K[0, 2]} is far from the centre of "
                             f"width {self.image_size[1]}")

    def scale(self, scale):
        K = scale_camera_matrix(self.K, np.ones(2) * scale)
        return FisheyeCamera(K, self.D, self.image_size * scale)

    def cut(self, offset):
        offset = np.asarray(offset, dtype=np.float64)
        K = self.K.copy()
        K[0, 2] = self.K[0, 2] - offset[0]
        K[1, 2] = self.K[1, 2] - offset[1]
        return FisheyeCamera(K, self.D, self.image_size - 2.0 * offset[::-1])

    def project(self, X, T_CW=np.eye(4)):
        """World points (N, 3) -> pixels (N, 2)."""
        return project_points(_f64(X), _f64(T_CW), _f64(self.K), _f64(self.D),
                              self.distortion_model).numpy()

    def undistort(self, xy):
        """Pixels (N, 2) -> undistorted pixels (N, 2), projected through K."""
        K = _f64(self.K)
        return undistort_points(_f64(xy), K, _f64(self.D), K, self.distortion_model).numpy()

    def unproject(self, xys, zs):
        """Undistorted pixels (N, 2) and depths (N,) -> camera-frame points."""
        return unproject(_f64(xys), _f64(zs).reshape(-1), _f64(self.Kinv)).numpy()

    def in_frame(self, x):
        x = np.asarray(x)
        under = (x <= 0.0).any(axis=1)
        over = (x >= self.image_size).any(axis=1)
        return ~(under | over)


class RadTanPinholeCamera(PinholeCamera):
    """Pinhole camera with four radtan distortion coefficients."""

    distortion_model = "radtan"


class FisheyeCamera(PinholeCamera):
    """Kalibr pinhole-equidistant camera."""

    distortion_model = "equidistant"


class StereoCamera:
    """Stereo rig: two cameras and T_RL (left camera frame -> right).

    ``triangulate`` undistorts both views, corrects the matches to the
    epipolar geometry (Hartley-Sturm) and triangulates (DLT) into the left
    camera frame, in float64 on the host."""

    def __init__(self, left_camera, right_camera, T_RL):
        self.left_camera = left_camera
        self.right_camera = right_camera
        self.T_RL = np.asarray(T_RL, dtype=np.float64)
        self.T_LR = linalg.inv_transform(torch.from_numpy(self.T_RL)).numpy()
        self.F = fundamental_matrix(self.T_RL, self.left_camera.K, self.right_camera.K)

    def triangulate(self, left_keypoints, right_keypoints):
        """Matched pixels (N, 2) in each view -> (N, 3) left-camera points."""
        from object_keypoints_tpu_torch.geometry import stereo

        left, right = self.left_camera, self.right_camera
        return stereo.triangulate_pixels(
            _f64(left_keypoints), _f64(right_keypoints), _f64(left.K), _f64(left.D),
            _f64(right.K), _f64(right.D), _f64(self.T_RL), _f64(self.F),
        ).numpy()

    @classmethod
    def from_file(cls, calibration_file):
        params = load_calibration_params(calibration_file)
        left = FisheyeCamera(params["K"], params["D"], params["image_size"])
        right = FisheyeCamera(params["Kp"], params["Dp"], params["image_size"])
        return cls(left, right, params["T_RL"])
