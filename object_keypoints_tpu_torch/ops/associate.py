"""Association: center-offset grouping, masked k-means, capacity resolution
and greedy epipolar matching.

Counterpart of ``object_keypoints_tpu/ops/associate.py``. Every function
takes any leading batch dimensions in place of the JAX package's vmaps.

Ties follow the JAX package: top-K is a stable descending sort (lower index
first), the keep-branch compaction is a stable argsort, and ``argmin`` /
``argmax`` return the first index in both frameworks. Sums are elementwise
(no matmul), so they stay fp32 whatever the TF32 settings.
"""

from __future__ import annotations

import torch


def _take(points, idx):
    """points (..., M, D), idx (..., K) -> (..., K, D)."""
    return points.gather(-2, idx[..., None].expand(*idx.shape, points.shape[-1]))


def assign_to_centers(points, points_valid, offsets, center_points, center_valid,
                      reject_distance: float = 20.0):
    """Assign detected keypoints to detected object centers.

    The predicted center of a type-t point at (x, y) is ``(round(x) + .5,
    round(y) + .5) + offsets[t, :, round(y), round(x)]``; the point joins the
    nearest valid center unless that is farther than ``reject_distance``.

    points (..., T, M, 2) in (x, y); points_valid (..., T, M);
    offsets (..., T, 2, H, W); center_points (..., C, 2); center_valid (..., C).
    Returns assignment (..., T, M) int32 in [-1, C) and predicted centers
    (..., T, M, 2).
    """
    h, w = offsets.shape[-2:]
    # round half to even, like np.round / jnp.round
    x_int = torch.clamp(torch.round(points[..., 0]).long(), 0, w - 1)
    y_int = torch.clamp(torch.round(points[..., 1]).long(), 0, h - 1)
    lin = (y_int * w + x_int)[..., None, :]  # (..., T, 1, M)
    flat = offsets.flatten(-2)  # (..., T, 2, H*W)
    off = flat.gather(-1, lin.expand(*lin.shape[:-2], 2, lin.shape[-1])).transpose(-1, -2)
    grid = torch.stack([x_int, y_int], dim=-1).to(points.dtype) + 0.5
    predicted_centers = grid + off

    diff = predicted_centers[..., :, :, None, :] - center_points[..., None, None, :, :]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1))  # (..., T, M, C)
    dist = torch.where(center_valid[..., None, None, :], dist, torch.full_like(dist, torch.inf))
    nearest = torch.argmin(dist, dim=-1)
    min_dist = torch.amin(dist, dim=-1)
    ok = points_valid & (min_dist <= reject_distance)
    assignment = torch.where(ok, nearest, torch.full_like(nearest, -1))
    return assignment.to(torch.int32), predicted_centers


def masked_kmeans(points, mask, weights, k: int, iters: int = 20):
    """Deterministic Lloyd k-means over masked points: centers start at the k
    highest-weight valid points, then ``iters`` Lloyd steps.

    points (..., M, 2), mask (..., M), weights (..., M) -> centers (..., k, 2).
    """
    score = torch.where(mask, weights, torch.full_like(weights, -torch.inf))
    init_idx = torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :k]
    centers = _take(points, init_idx)
    ks = torch.arange(k, device=points.device)
    for _ in range(iters):
        diff = points[..., :, None, :] - centers[..., None, :, :]
        assign = torch.argmin(torch.sum(diff * diff, dim=-1), dim=-1)  # (..., M)
        one_hot = ((assign[..., None] == ks) & mask[..., None]).to(points.dtype)  # (..., M, k)
        counts = one_hot.sum(dim=-2)  # (..., k)
        sums = torch.sum(one_hot[..., None] * points[..., :, None, :], dim=-3)  # (..., k, 2)
        centers = torch.where(counts[..., None] > 0,
                              sums / torch.clamp(counts[..., None], min=1.0), centers)
    return centers


def resolve_capacity(points, mask, confidence, capacity: int):
    """Capacity resolution for (object, keypoint-type) cells: with at most
    ``capacity`` points keep them; with more, take the argmax-confidence
    point (capacity 1) or the k-means centers (capacity > 1).

    points (..., M, 2), mask (..., M), confidence (..., M) ->
    out (..., capacity, 2), out_valid (..., capacity).
    """
    count = mask.sum(dim=-1)
    # keep-branch: the first `capacity` valid points, compacted to the front
    order = torch.argsort((~mask).to(torch.int8), dim=-1, stable=True)[..., :capacity]
    kept = _take(points, order)
    kept_valid = mask.gather(-1, order)

    if capacity == 1:
        masked_conf = torch.where(mask, confidence, torch.full_like(confidence, -torch.inf))
        resolved = _take(points, torch.argmax(masked_conf, dim=-1, keepdim=True))
    else:
        resolved = masked_kmeans(points, mask, confidence, capacity)

    over = (count > capacity)[..., None]
    out = torch.where(over[..., None], resolved, kept)
    out_valid = (over | kept_valid) & (count > 0)[..., None]
    return out, out_valid


def greedy_epipolar_match(distances, left_valid, right_valid, threshold: float = 2.0,
                          max_matches: int = None):
    """Greedy mutually exclusive matching on (..., L, R) distance matrices:
    ``max_matches`` times, the globally nearest remaining pair (row-major
    first on ties) is matched if its distance is at most ``threshold``, and
    its row and column leave the matrix. Invalid rows and columns never
    match. Returns (..., L) int32 right indices, -1 where unmatched."""
    L, R = distances.shape[-2:]
    if max_matches is None:
        max_matches = min(L, R)
    inf = torch.full_like(distances, torch.inf)
    d = torch.where(left_valid[..., :, None] & right_valid[..., None, :], distances, inf)
    assignment = torch.full(distances.shape[:-1], -1, dtype=torch.int32,
                            device=distances.device)
    rows = torch.arange(L, device=distances.device)
    cols = torch.arange(R, device=distances.device)
    for _ in range(max_matches):
        best, flat = torch.min(d.flatten(-2), dim=-1)
        i, j = flat // R, flat % R
        take = (best <= threshold)[..., None]
        hit_row = take & (rows == i[..., None])
        hit_col = take & (cols == j[..., None])
        assignment = torch.where(hit_row, j[..., None].to(torch.int32), assignment)
        d = torch.where(hit_row[..., :, None] | hit_col[..., None, :], inf, d)
    return assignment
