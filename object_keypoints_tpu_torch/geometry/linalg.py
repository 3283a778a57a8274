"""SE3 and small linear-algebra helpers on torch tensors.

Counterpart of ``object_keypoints_tpu/geometry/linalg.py``. Every function
takes tensors or numpy arrays (numpy float64 stays float64), with any
leading batch dimensions where the JAX version has them. Matrix products are
elementwise products summed over the shared axis, never ``torch.matmul``, so
a float32 product is full float32 whatever the TF32 settings.
"""

from __future__ import annotations

import torch


def matmul(a, b):
    """(..., n, k) @ (..., k, m) as an elementwise product and a sum."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def matvec(a, v):
    """(..., n, k) @ (..., k) as an elementwise product and a sum."""
    return torch.sum(a * v[..., None, :], dim=-1)


def skew_matrix(v):
    """(..., 3) vectors -> (..., 3, 3) cross-product matrices."""
    v = torch.as_tensor(v)
    zero = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], zero], dim=-1),
    ], dim=-2)


def inv_transform(T):
    """Inverse (R^T, -R^T t) of rigid (..., 4, 4) transforms."""
    T = torch.as_tensor(T)
    R_t = T[..., :3, :3].transpose(-1, -2)
    t = -matvec(R_t, T[..., :3, 3])
    bottom = torch.zeros_like(T[..., 3:, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([torch.cat([R_t, t[..., :, None]], dim=-1), bottom], dim=-2)


def transform_points(T, points):
    """Apply one rigid 4x4 transform to (..., 3) points."""
    T = torch.as_tensor(T)
    return matvec(T[:3, :3], torch.as_tensor(points)) + T[:3, 3]


def rotation_matrix_to_euler_xyz(R):
    """(..., 3, 3) rotations -> (..., 3) xyz Euler angles in radians, scipy's
    ``as_euler('xyz')`` convention for non-degenerate rotations."""
    R = torch.as_tensor(R)
    b = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    a = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    c = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([a, b, c], dim=-1)


def angle_between(R1, R2):
    """Euler angles of the relative rotation R1^T R2."""
    R1, R2 = torch.as_tensor(R1), torch.as_tensor(R2)
    return rotation_matrix_to_euler_xyz(matmul(R1.transpose(-1, -2), R2))


def rotation_angle(R1, R2):
    """Geodesic angle (radians) of the relative rotation R1^T R2."""
    R1, R2 = torch.as_tensor(R1), torch.as_tensor(R2)
    R = matmul(R1.transpose(-1, -2), R2)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.acos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0))
