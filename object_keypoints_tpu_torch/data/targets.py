"""Training-target rendering: gaussian heatmaps, center fields, depth discs.

Counterpart of ``object_keypoints_tpu/data/targets.py``. The JAX package
renders one frame as a jitted program; here every renderer takes points with
any leading frame dimensions, ``(..., n_objects, n_keypoints, 2)``, and
renders on their device in plain torch ops (the JAX renderer was lowered by
XLA, not written as a Pallas kernel). ``compute_kernel`` and
``add_discrete_kernel`` stay host numpy, as they are there.

Overlapping discs: the JAX loops visit objects in order and, within an
object, keypoints in order, and each covering keypoint overwrites the
pixel, so the last one visited wins. Here each pixel takes the covering
keypoint of highest rank in that order, gathered by index: no scatter with
duplicate indices, whose write order CUDA leaves undefined. A pixel is
covered when ``sqrt(dx^2 + dy^2) < radius`` in float32, the way
``jnp.linalg.norm`` computes it, so boundary pixels agree.

Geometry constants (the reference's video.py:17-20): heatmap 64x64,
center/depth disc radius 4 px, splat window radius 8 px, length scale 2 px.
"""

from __future__ import annotations

import numpy as np
import torch

HEATMAP_SIZE = 64
CENTER_RADIUS = HEATMAP_SIZE / 16.0  # 4 px
KERNEL_RADIUS = int(HEATMAP_SIZE / 8.0)  # 8 px window radius
DEFAULT_LENGTH_SCALE = HEATMAP_SIZE / 32.0  # 2 px


def gaussian_kernel_value(x, y, length_scale=DEFAULT_LENGTH_SCALE):
    """exp(-|x - y|^2 / ls^2), the reference's unnormalized RBF; x, y (..., 2)."""
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    return torch.exp(-torch.sum((x - y) ** 2, dim=-1) / length_scale**2)


def compute_kernel(size: int, center: int, length_scale=DEFAULT_LENGTH_SCALE):
    """Discretized sum-normalized gaussian kernel (host numpy)."""
    ii = np.arange(size, dtype=np.float32)
    grid = np.stack(np.meshgrid(ii, ii, indexing="ij"), axis=-1)  # (s, s, 2) of (i, j)
    c = np.array([center, center], dtype=np.float32)
    kernel = np.exp(-np.sum((grid - c) ** 2, axis=-1) / float(length_scale) ** 2)
    return (kernel / kernel.sum()).astype(np.float32)


def pixel_grid(height: int, width: int, device=None):
    """(2, H, W) float32 grid of pixel centers (x + .5, y + .5)."""
    ys, xs = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    return torch.stack([xs + 0.5, ys + 0.5]).to(torch.float32)


def add_discrete_kernel(target, kernel, points, center: int | None = None):
    """Paste a precomputed kernel at each rounded point, in place (host
    numpy), with the reference's window and edge arithmetic."""
    target = np.asarray(target)
    kernel = np.asarray(kernel)
    size = kernel.shape[0]
    c = size // 2 if center is None else center
    height, width = target.shape
    for point in np.asarray(points):
        x = round(float(point[0]))
        y = round(float(point[1]))
        x_start = max(x - c, 0)
        x_end = max(min(x + c, width), 0)
        y_start = max(y - c, 0)
        y_end = max(min(y + c, height), 0)
        ky0, ky1 = 0, size
        kx0, kx1 = 0, size
        if y_start == 0:
            ky0 = abs(y - c)
        if y + c >= height:
            ky1 = ky0 + size - max(y + c - height, 0)
        if x_start == 0:
            kx0 = abs(x - c)
        if x + c > width:
            kx1 = kx0 + size - max(x + c - width, 0)
        if (ky1 - ky0) < 0 or (kx1 - kx0) < 0:
            continue
        target[y_start:y_end, x_start:x_end] += kernel[ky0:ky1, kx0:kx1]
    return target


def splat_gaussian(shape, points, valid, length_scale=DEFAULT_LENGTH_SCALE,
                   window_radius: int = KERNEL_RADIUS):
    """Additive sub-pixel gaussians, each truncated to a window around its
    point cast to int (truncation toward zero, like ``astype(int32)``).

    shape: (H, W); points (..., P, 2) float (x, y); valid (..., P). Returns
    (..., H, W)."""
    h, w = shape
    ys = torch.arange(h, device=points.device)[:, None]
    xs = torch.arange(w, device=points.device)[None, :]
    px, py = points[..., 0, None, None], points[..., 1, None, None]
    ix = points[..., 0].to(torch.int32)[..., None, None]
    iy = points[..., 1].to(torch.int32)[..., None, None]
    inside = ((xs >= ix - window_radius) & (xs <= ix + window_radius)
              & (ys >= iy - window_radius) & (ys <= iy + window_radius))
    val = torch.exp(-((xs - px) ** 2 + (ys - py) ** 2) / length_scale**2)
    val = torch.where(inside & valid[..., None, None], val, torch.zeros_like(val))
    return val.sum(dim=-3)


def _map_slices(keypoint_config):
    """(start, count) of each map's keypoints within an object."""
    starts = np.cumsum([0, *keypoint_config[:-1]])
    return [(int(s), int(n)) for s, n in zip(starts, keypoint_config)]


def _candidates(x, start: int, count: int):
    """x (..., n_objects, n_keypoints, C) -> one map's keypoints
    (..., n_objects * count, C), objects first: the JAX loops' visiting order."""
    return x[..., start:start + count, :].flatten(-3, -2)


def _fill_discs(points, valid, values, size, radius):
    """Each pixel within ``radius`` of a valid point takes the values of the
    last such point in the order given.

    points (..., L, 2), valid (..., L), values (..., L, C) -> ((..., C, H, W)
    with 0 where no point covers, the covered mask (..., H, W))."""
    h, w = size
    grid = pixel_grid(h, w, device=points.device)
    dx = points[..., 0, None, None] - grid[0]
    dy = points[..., 1, None, None] - grid[1]
    within = (torch.sqrt(dx * dx + dy * dy) < radius) & valid[..., None, None]
    rank = torch.arange(1, points.shape[-2] + 1, device=points.device)[:, None, None]
    last = torch.where(within, rank, torch.zeros_like(rank)).amax(dim=-3)  # 0: none
    covered = last > 0
    index = (last - 1).clamp(min=0).flatten(-2).unsqueeze(-2)  # (..., 1, H*W)
    out = []
    for c in range(values.shape[-1]):
        v = values[..., c, None].expand(*values.shape[:-1], h * w)  # (..., L, H*W)
        picked = torch.gather(v, -2, index).squeeze(-2).unflatten(-1, (h, w))
        out.append(torch.where(covered, picked, torch.zeros_like(picked)))
    return torch.stack(out, dim=-3), covered


def render_heatmaps(points, valid, keypoint_config: tuple, target_size: tuple,
                    length_scale=DEFAULT_LENGTH_SCALE):
    """Per-map gaussian targets with the reference's normalize-and-clip.

    points (..., n_objects, n_keypoints, 2) in target space with the
    synthetic center first in each object; valid (..., n_objects,
    n_keypoints); keypoint_config: per-map counts *including* the center
    map, e.g. (1, 1, 3). Returns (..., len(config), H, W), each map scaled
    by 1 / max(map max, 0.5) and clipped to [0, 1]."""
    maps = [splat_gaussian(target_size, _candidates(points, s, n),
                           _candidates(valid[..., None], s, n)[..., 0], length_scale)
            for s, n in _map_slices(keypoint_config)]
    target = torch.stack(maps, dim=-3)
    peak = target.amax(dim=(-2, -1)).clamp(min=0.5)
    return (target / peak[..., None, None]).clamp(0.0, 1.0)


def render_center_field(points, valid, keypoint_config: tuple, target_size: tuple,
                        radius=CENTER_RADIUS):
    """Center-offset vector field: for each non-center keypoint, pixels
    within ``radius`` of it hold the vector from the pixel center to its
    object's center (keypoint 0). Returns (..., T, 2, H, W), T =
    len(keypoint_config) - 1."""
    grid = pixel_grid(*target_size, device=points.device)
    centers = points[..., :1, :].expand(points.shape)  # each keypoint's object center
    fields = []
    for s, n in _map_slices(keypoint_config)[1:]:
        value, covered = _fill_discs(_candidates(points, s, n),
                                     _candidates(valid[..., None], s, n)[..., 0],
                                     _candidates(centers, s, n), target_size, radius)
        fields.append(torch.where(covered[..., None, :, :], value - grid, torch.zeros_like(value)))
    return torch.stack(fields, dim=-4)


def render_depth_field(points, points_C, valid, keypoint_config: tuple,
                       target_size: tuple, radius=CENTER_RADIUS):
    """Per-map depth targets: pixels within ``radius`` of a keypoint hold its
    camera-frame z (center map included). points_C (..., n_objects,
    n_keypoints, 3). Returns (..., len(config), H, W)."""
    maps = [_fill_discs(_candidates(points, s, n), _candidates(valid[..., None], s, n)[..., 0],
                        _candidates(points_C[..., 2:], s, n), target_size, radius)[0][..., 0, :, :]
            for s, n in _map_slices(keypoint_config)]
    return torch.stack(maps, dim=-3)


def render_all_targets(points, points_C, valid, keypoint_config: tuple,
                       target_size: tuple = (HEATMAP_SIZE, HEATMAP_SIZE)):
    """(heatmaps (..., K, H, W), depth (..., K, H, W), centers (..., T, 2, H,
    W)) of points already scaled to target space, on their device."""
    return (render_heatmaps(points, valid, keypoint_config, target_size),
            render_depth_field(points, points_C, valid, keypoint_config, target_size),
            render_center_field(points, valid, keypoint_config, target_size))
