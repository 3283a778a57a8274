"""Stereo triangulation: optimal epipolar correction and DLT, batched.

Counterpart of ``object_keypoints_tpu/geometry/stereo.py``. The JAX package
vmaps a per-point function; here every function takes points with any
leading batch dimensions, ``(..., 2)``, and runs as elementwise tensor ops
with no host synchronisation and no matmul (3x3 products are written out),
so float32 stays float32 whatever the TF32 settings.

- ``correct_matches`` is the Hartley-Sturm correction (H&Z Algorithm 12.1)
  the JAX package uses: instead of the real roots of the degree-6
  polynomial, it brackets the minimum of the geometric cost s(t) on a
  65-point tan grid and polishes it with 8 Newton steps. The JAX package
  takes s'(t) and s''(t) from ``jax.grad``; here they are written in closed
  form, so the correction also runs under ``torch.inference_mode``.
- ``triangulate_linear`` is the DLT. ``method="solve"`` (the serve default)
  solves the 3x3 normal equations in closed form (``torch.linalg.solve``
  checks for singular matrices and so waits for the device);
  ``method="eigh"`` takes the smallest eigenvector of the 4x4 normal matrix.
"""

from __future__ import annotations

import math

import torch

from object_keypoints_tpu_torch.geometry import cameras
from object_keypoints_tpu_torch.geometry.linalg import matmul, matvec

_GRID_SIZE = 65
_GRID_LIMIT = math.pi / 2 * 0.9999
_NEWTON_STEPS = 8


def _cross(u, v):
    u0, u1, u2 = u.unbind(-1)
    v0, v1, v2 = v.unbind(-1)
    return torch.stack([u1 * v2 - u2 * v1, u2 * v0 - u0 * v2, u0 * v1 - u1 * v0], dim=-1)


def _best_cross(rows):
    """Null vector of (..., 3, 3) rank-2 matrices: the longest of the cross
    products of two rows (the first on ties)."""
    r0, r1, r2 = rows.unbind(-2)
    cands = torch.stack([_cross(r0, r1), _cross(r0, r2), _cross(r1, r2)], dim=-2)
    best = torch.argmax(torch.sqrt(torch.sum(cands * cands, dim=-1)), dim=-1)
    return cands.gather(-2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]


def _translation(x):
    """(..., 2) -> (..., 3, 3) homogeneous translations by x."""
    one = torch.ones_like(x[..., 0])
    zero = torch.zeros_like(one)
    return torch.stack([torch.stack([one, zero, x[..., 0]], dim=-1),
                        torch.stack([zero, one, x[..., 1]], dim=-1),
                        torch.stack([zero, zero, one], dim=-1)], dim=-2)


def _rotation(e):
    """(..., 3) unit epipoles -> (..., 3, 3) rotations putting them on the x axis."""
    one = torch.ones_like(e[..., 0])
    zero = torch.zeros_like(one)
    return torch.stack([torch.stack([e[..., 0], e[..., 1], zero], dim=-1),
                        torch.stack([-e[..., 1], e[..., 0], zero], dim=-1),
                        torch.stack([zero, zero, one], dim=-1)], dim=-2)


def _cost(t, f, fp, a, b, c, d):
    """Hartley-Sturm's squared distance s(t) of the pencil parameter t."""
    num_l = t * t / (1.0 + f * f * t * t)
    n = c * t + d
    m = a * t + b
    return num_l + n * n / (m * m + fp * fp * (n * n))


def cost_derivatives(t, f, fp, a, b, c, d):
    """s'(t) and s''(t) in closed form. With w = 1 / (1 + f^2 t^2),
    n = c t + d, m = a t + b, D = m^2 + f'^2 n^2 and k = b c - a d:

        (t^2 w)'  = 2 t w^2,        (t^2 w)''  = w^3 (2 - 6 f^2 t^2)
        (n^2/D)'  = 2 k n m / D^2,  (n^2/D)''  = 2 k (c m + a n) / D^2 - 4 k n m D' / D^3

    with D' = 2 (a m + f'^2 c n), grouped so no power of D is formed."""
    w = 1.0 / (1.0 + f * f * t * t)
    ds_l = 2.0 * t * w * w
    d2s_l = w * w * (2.0 * w - 6.0 * (f * f * t * t * w))
    n = c * t + d
    m = a * t + b
    q = 1.0 / (m * m + fp * fp * (n * n))
    k = b * c - a * d
    nq, mq = n * q, m * q
    dD = 2.0 * (a * m + fp * fp * (c * n))
    ds_r = 2.0 * k * nq * mq
    d2s_r = 2.0 * k * q * (c * mq + a * nq - 2.0 * nq * mq * dD)
    return ds_l + ds_r, d2s_l + d2s_r


def correct_matches(F, points_l, points_r):
    """Optimal epipolar correction of correspondences, cv2.correctMatches'
    equivalent. F (3, 3) with x_r^T F x_l = 0; points_l/r (..., 2) pixels.
    Returns the corrected (..., 2) pairs."""
    Tl_inv, Tr_inv = _translation(points_l), _translation(points_r)
    F1 = matmul(Tr_inv.transpose(-1, -2), matmul(F, Tl_inv))

    # epipoles, normalised so e1^2 + e2^2 = 1
    e_l, e_r = _best_cross(F1), _best_cross(F1.transpose(-1, -2))
    e_l = e_l / torch.sqrt(e_l[..., 0] * e_l[..., 0] + e_l[..., 1] * e_l[..., 1])[..., None]
    e_r = e_r / torch.sqrt(e_r[..., 0] * e_r[..., 0] + e_r[..., 1] * e_r[..., 1])[..., None]
    R_l, R_r = _rotation(e_l), _rotation(e_r)
    F2 = matmul(R_r, matmul(F1, R_l.transpose(-1, -2)))
    coef = (e_l[..., 2], e_r[..., 2], F2[..., 1, 1], F2[..., 1, 2], F2[..., 2, 1], F2[..., 2, 2])
    f, fp, a, b, c, d = coef

    # global bracket on t = tan(phi), then a Newton polish of s'(t) = 0 that
    # keeps a step only if it is finite and does not raise the cost
    phi = torch.linspace(-_GRID_LIMIT, _GRID_LIMIT, _GRID_SIZE, dtype=torch.float64,
                         device=points_l.device)
    ts = torch.tan(phi).to(points_l.dtype)
    t = ts[torch.argmin(_cost(ts, *(x[..., None] for x in coef)), dim=-1)]
    cost_t = _cost(t, *coef)
    for _ in range(_NEWTON_STEPS):
        g, h = cost_derivatives(t, *coef)
        step = torch.where(torch.abs(h) > 1e-20, g / h, torch.zeros_like(g))
        t_new = t - torch.clamp(step, -1e3, 1e3)
        cost_new = _cost(t_new, *coef)
        keep = torch.isfinite(t_new) & (cost_new <= cost_t)
        t = torch.where(keep, t_new, t)
        cost_t = torch.where(keep, cost_new, cost_t)

    # the asymptotic candidate t = inf
    use_inf = 1.0 / (f * f) + c * c / (a * a + fp * fp * (c * c)) < cost_t
    n, m = c * t + d, a * t + b
    lines_l = (torch.where(use_inf, f, t * f), (~use_inf).to(t.dtype), torch.where(use_inf, -1.0, -t))
    lines_r = (torch.where(use_inf, -fp * c, -fp * n), torch.where(use_inf, a, m),
               torch.where(use_inf, c, n))

    def closest_to_origin(line):
        lam, mu, nu = line
        return torch.stack([-lam * nu, -mu * nu, lam * lam + mu * mu], dim=-1)

    x_l = matvec(Tl_inv, matvec(R_l.transpose(-1, -2), closest_to_origin(lines_l)))
    x_r = matvec(Tr_inv, matvec(R_r.transpose(-1, -2), closest_to_origin(lines_r)))
    return x_l[..., :2] / x_l[..., 2:], x_r[..., :2] / x_r[..., 2:]


def _solve_spd3(A, y):
    """Solve (..., 3, 3) symmetric positive definite systems A x = y by a
    closed-form Cholesky factorisation and two substitutions."""
    l00 = torch.sqrt(A[..., 0, 0])
    l10 = A[..., 1, 0] / l00
    l20 = A[..., 2, 0] / l00
    l11 = torch.sqrt(A[..., 1, 1] - l10 * l10)
    l21 = (A[..., 2, 1] - l20 * l10) / l11
    l22 = torch.sqrt(A[..., 2, 2] - l20 * l20 - l21 * l21)
    z0 = y[..., 0] / l00
    z1 = (y[..., 1] - l10 * z0) / l11
    z2 = (y[..., 2] - l20 * z0 - l21 * z1) / l22
    x2 = z2 / l22
    x1 = (z1 - l21 * x2) / l11
    x0 = (z0 - l10 * x1 - l20 * x2) / l00
    return torch.stack([x0, x1, x2], dim=-1)


def triangulate_linear(P1, P2, points_l, points_r, method: str = "solve"):
    """DLT triangulation, cv2.triangulatePoints' equivalent. P1, P2 (3, 4)
    projection matrices; points (..., 2) pixels. Returns (..., 3) points in
    the frame of P1.

    ``method="solve"`` fixes X_4 = 1 and solves the 3x3 normal equations
    (the inhomogeneous DLT); ``method="eigh"`` takes the homogeneous
    solution, the smallest eigenvector of the 4x4 normal matrix."""
    rows = torch.stack([points_l[..., 0, None] * P1[2] - P1[0],
                        points_l[..., 1, None] * P1[2] - P1[1],
                        points_r[..., 0, None] * P2[2] - P2[0],
                        points_r[..., 1, None] * P2[2] - P2[1]], dim=-2)
    rows = rows / torch.sqrt(torch.sum(rows * rows, dim=-1, keepdim=True))
    if method == "eigh":
        _, vecs = torch.linalg.eigh(matmul(rows.transpose(-1, -2), rows))
        X = vecs[..., :, 0]
        return X[..., :3] / X[..., 3:]
    if method != "solve":
        raise ValueError(f"unknown triangulation method {method!r}")
    B_t = rows[..., :3].transpose(-1, -2)
    return -_solve_spd3(matmul(B_t, rows[..., :3]), matvec(B_t, rows[..., 3]))


def triangulate_pixels(points_l, points_r, K, D, Kp, Dp, T_RL, F, correct: bool = True):
    """Stereo lift of matched fisheye pixels (..., 2): undistort both views
    (through K and Kp), optionally correct against F, triangulate with
    P1 = K [I|0] and P2 = Kp T_RL[:3]. Returns (..., 3) left-camera points."""
    und_l = cameras.fisheye_undistort_points(points_l, K, D, P=K)
    und_r = cameras.fisheye_undistort_points(points_r, Kp, Dp, P=Kp)
    if correct:
        und_l, und_r = correct_matches(F, und_l, und_r)
    P1 = torch.cat([K, torch.zeros_like(K[:, :1])], dim=-1)
    P2 = matmul(Kp, T_RL[:3])
    return triangulate_linear(P1, P2, und_l, und_r)


def epipolar_distances(F, points_l, points_r):
    """Distance in pixels of every right point to the epipolar line of every
    left point: points_l (..., L, 2), points_r (..., R, 2) -> (..., L, R)."""
    lines = matvec(F, torch.cat([points_l, torch.ones_like(points_l[..., :1])], dim=-1))
    norm = torch.sqrt(lines[..., 0] * lines[..., 0] + lines[..., 1] * lines[..., 1])
    xr = torch.cat([points_r, torch.ones_like(points_r[..., :1])], dim=-1)
    signed = torch.sum(lines[..., :, None, :] * xr[..., None, :, :], dim=-1)
    return torch.abs(signed) / torch.clamp(norm[..., None], min=1e-12)
