"""Plain reference of the object decode: heatmaps -> objects with 3D keypoints.

The semantics of object_keypoints' decode (perception/pipeline.py and
utils/): peaks of each box-filtered map after a max-pool NMS, sub-pixel
centroids of the raw map around them, center-offset votes grouping the
keypoints to the nearest object center (rejected beyond a distance),
per-(object, type) capacity by argmax or a deterministic k-means, then the
equidistant undistortion and a depth lookup to lift points into the camera
frame. Written out in plain torch, frozen here: it imports nothing of the
program. Top-K is a stable descending sort (ties: lower index first).

Outputs follow the serving contract's field order (``FIELDS``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FIELDS = ("center_points", "center_valid", "center_p3d", "keypoints", "keypoints_valid",
          "keypoints_p3d", "predicted_centers", "assignment", "raw_points", "raw_valid")
NEWTON_ITERS = 10
KMEANS_ITERS = 20


def box_filter(x, size=5):
    pad = size // 2
    h, w = x.shape[-2:]
    xp = F.pad(x, (pad, pad, pad, pad))
    rows = sum(xp[..., dy:dy + h, :] for dy in range(size))
    return sum(rows[..., dx:dx + w] for dx in range(size))


def extract_peaks(probs, max_peaks, threshold, window=5):
    lead, (h, w) = probs.shape[:-2], probs.shape[-2:]
    maps = probs.reshape(-1, h, w)
    b = maps.shape[0]
    boxed = box_filter(maps, window)
    hmax = F.max_pool2d(boxed.reshape(-1, 1, h, w), window, stride=1, padding=window // 2)
    suppressed = torch.where(boxed == hmax.reshape(boxed.shape), boxed, torch.zeros_like(boxed))
    scores, idx = torch.sort(suppressed.reshape(b, -1), dim=-1, descending=True, stable=True)
    scores, idx = scores[:, :max_peaks], idx[:, :max_peaks]
    valid = scores > threshold
    py, px = idx // w, idx % w
    pad = window // 2
    padded = F.pad(maps, (pad, pad, pad, pad)).reshape(b, -1)
    di = torch.arange(window, device=probs.device)
    yy = py[:, :, None, None] + di[:, None]
    xx = px[:, :, None, None] + di
    win = padded.gather(1, (yy * (w + 2 * pad) + xx).reshape(b, -1)).reshape(
        b, max_peaks, window, window)
    mass = win.sum(dim=(-2, -1))
    safe = torch.clamp(mass, min=1e-12)
    cy = (win * (yy - pad).to(probs.dtype)).sum(dim=(-2, -1)) / safe
    cx = (win * (xx - pad).to(probs.dtype)).sum(dim=(-2, -1)) / safe
    points = torch.stack([cx, cy], dim=-1)
    return (points.reshape(*lead, max_peaks, 2), mass.reshape(*lead, max_peaks),
            valid.reshape(*lead, max_peaks))


def _take(points, idx):
    return points.gather(-2, idx[..., None].expand(*idx.shape, points.shape[-1]))


def assign_to_centers(points, points_valid, offsets, center_points, center_valid, reject):
    h, w = offsets.shape[-2:]
    x_int = torch.clamp(torch.round(points[..., 0]).long(), 0, w - 1)
    y_int = torch.clamp(torch.round(points[..., 1]).long(), 0, h - 1)
    lin = (y_int * w + x_int)[..., None, :]
    flat = offsets.flatten(-2)
    off = flat.gather(-1, lin.expand(*lin.shape[:-2], 2, lin.shape[-1])).transpose(-1, -2)
    predicted = torch.stack([x_int, y_int], dim=-1).to(points.dtype) + 0.5 + off
    diff = predicted[..., :, :, None, :] - center_points[..., None, None, :, :]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1))
    dist = torch.where(center_valid[..., None, None, :], dist, torch.full_like(dist, math.inf))
    nearest = torch.argmin(dist, dim=-1)
    ok = points_valid & (torch.amin(dist, dim=-1) <= reject)
    return torch.where(ok, nearest, torch.full_like(nearest, -1)).to(torch.int32), predicted


def masked_kmeans(points, mask, weights, k):
    score = torch.where(mask, weights, torch.full_like(weights, -math.inf))
    centers = _take(points, torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :k])
    ks = torch.arange(k, device=points.device)
    for _ in range(KMEANS_ITERS):
        diff = points[..., :, None, :] - centers[..., None, :, :]
        assign = torch.argmin(torch.sum(diff * diff, dim=-1), dim=-1)
        one_hot = ((assign[..., None] == ks) & mask[..., None]).to(points.dtype)
        counts = one_hot.sum(dim=-2)
        sums = torch.sum(one_hot[..., None] * points[..., :, None, :], dim=-3)
        centers = torch.where(counts[..., None] > 0,
                              sums / torch.clamp(counts[..., None], min=1.0), centers)
    return centers


def resolve_capacity(points, mask, confidence, capacity):
    count = mask.sum(dim=-1)
    order = torch.argsort((~mask).to(torch.int8), dim=-1, stable=True)[..., :capacity]
    kept, kept_valid = _take(points, order), mask.gather(-1, order)
    if capacity == 1:
        conf = torch.where(mask, confidence, torch.full_like(confidence, -math.inf))
        resolved = _take(points, torch.argmax(conf, dim=-1, keepdim=True))
    else:
        resolved = masked_kmeans(points, mask, confidence, capacity)
    over = (count > capacity)[..., None]
    return torch.where(over[..., None], resolved, kept), (over | kept_valid) & (count > 0)[..., None]


def undistort_equidistant(uv, K, D):
    """Pixels -> undistorted pixels through K: theta from theta_d by 10
    Newton steps (cv2.fisheye.undistortPoints)."""
    xy = torch.stack([(uv[..., 0] - K[0, 2]) / K[0, 0], (uv[..., 1] - K[1, 2]) / K[1, 1]], -1)
    theta_d = torch.sqrt(torch.sum(xy * xy, dim=-1))
    theta_c = torch.clamp(theta_d, -math.pi, math.pi)
    theta = theta_c
    for _ in range(NEWTON_ITERS):
        th2 = theta * theta
        th4 = th2 * th2
        k0, k1, k2, k3 = D[0] * th2, D[1] * th4, D[2] * (th4 * th2), D[3] * (th4 * th4)
        theta = theta - (theta * (1.0 + k0 + k1 + k2 + k3) - theta_c) / (
            1.0 + 3.0 * k0 + 5.0 * k1 + 7.0 * k2 + 9.0 * k3)
    scale = torch.where(theta_d > 1e-9, torch.tan(theta) / torch.clamp(theta_d, min=1e-9),
                        torch.ones_like(theta_d))
    xy = xy * scale[..., None]
    return torch.stack([xy[..., 0] * K[0, 0] + K[0, 2], xy[..., 1] * K[1, 1] + K[1, 2]], -1)


def lift(points, valid, depth_plane, camera):
    """Undistort, read depth at the rounded undistorted pixel (clipped to the
    camera's image, then to the plane), unproject through Kinv."""
    K, D, Kinv, size = camera
    und = undistort_equidistant(points, K, D)
    n, ph, pw = depth_plane.shape
    xy = torch.round(und).to(torch.int64)
    x = torch.minimum(xy[..., 0].clamp(min=0), size[1].to(torch.int64) - 1).clamp(0, pw - 1)
    y = torch.minimum(xy[..., 1].clamp(min=0), size[0].to(torch.int64) - 1).clamp(0, ph - 1)
    z = depth_plane.reshape(n, -1).gather(1, (y * pw + x).reshape(n, -1)).reshape(x.shape)
    xyw = torch.cat([und, torch.ones_like(und[..., :1])], dim=-1)
    p3d = torch.sum(Kinv * xyw[..., None, :], dim=-1) * z[..., None]
    return torch.where(valid[..., None], p3d, torch.zeros_like(p3d))


def decode_objects(probs, depth, offsets, camera, keypoint_config, max_peaks, reject,
                   threshold):
    """probs, depth (N, 1+T, H, W), offsets (N, T, 2, H, W); ``camera`` is
    (K, D, Kinv, image_size (h, w)) tensors. Returns the ``FIELDS`` tuple."""
    T = len(keypoint_config)
    points, conf, valid = extract_peaks(probs, max_peaks, threshold)
    center_points, center_valid = points[:, 0], valid[:, 0]
    tp, tc, tv = points[:, 1:], conf[:, 1:], valid[:, 1:]
    assignment, predicted = assign_to_centers(tp, tv, offsets, center_points, center_valid,
                                              reject)
    n, m, cap = probs.shape[0], max_peaks, max(keypoint_config)
    objects = torch.arange(m, device=probs.device, dtype=assignment.dtype)
    kps, kvs = [], []
    for t, capacity in enumerate(keypoint_config):
        mask = (assignment[:, t, None, :] == objects[:, None]) & tv[:, t, None, :]
        out, out_valid = resolve_capacity(tp[:, t, None].expand(n, m, m, 2), mask,
                                          tc[:, t, None].expand(n, m, m), capacity)
        kps.append(F.pad(out, (0, 0, 0, cap - capacity)))
        kvs.append(F.pad(out_valid, (0, cap - capacity)))
    keypoints = torch.stack(kps, dim=2)
    keypoints_valid = torch.stack(kvs, dim=2) & center_valid[:, :, None, None]
    center_p3d = lift(center_points, center_valid, depth[:, 0], camera)
    keypoints_p3d = torch.stack([lift(keypoints[:, :, t], keypoints_valid[:, :, t],
                                      depth[:, 1 + t], camera) for t in range(T)], dim=2)
    return (center_points, center_valid, center_p3d, keypoints, keypoints_valid, keypoints_p3d,
            predicted, assignment, tp, tv)
