"""CornerNet's training targets for one image, in numpy: a frozen copy of
the target arithmetic of CornerNet-Lite's sampler (core/sample/cornernet.py
and core/sample/utils.py): a Gaussian bump at each corner, of the radius
that keeps a box's IoU at ``gaussian_iou``, sub-pixel offsets, flat tag
indices and a tag mask in buffers of ``max_tag_len``. Heatmaps are (oh, ow,
C), the layout the train step takes.
"""

from __future__ import annotations

import math

import numpy as np

MAX_TAG_LEN = 128


def gaussian_radius(det_size, min_overlap):
    height, width = det_size
    t = min_overlap
    perim, area = height + width, width * height
    bounds = []
    for q2, q1, q0, branch in ((1.0, -perim, area * (1 - t) / (1 + t), -1.0),
                               (4.0, -2 * perim, (1 - t) * area, -1.0),
                               (4.0 * t, 2 * t * perim, (t - 1) * area, 1.0)):
        bounds.append((-q1 + branch * math.sqrt(q1 * q1 - 4 * q2 * q0)) / (2 * q2))
    return min(bounds)


def draw_gaussian(heatmap, center, radius):
    cx, cy = int(center[0]), int(center[1])
    h, w = heatmap.shape[:2]
    x0, x1 = max(cx - radius, 0), min(cx + radius + 1, w)
    y0, y1 = max(cy - radius, 0), min(cy + radius + 1, h)
    if x1 <= x0 or y1 <= y0:
        return
    sigma = (2 * radius + 1) / 6
    dx = np.arange(x0, x1, dtype=np.float64)[None, :] - cx
    dy = np.arange(y0, y1, dtype=np.float64)[:, None] - cy
    bump = np.exp(-(dx * dx + dy * dy) / (2 * sigma * sigma))
    bump[bump < np.finfo(bump.dtype).eps] = 0.0
    window = heatmap[y0:y1, x0:x1]
    np.maximum(window, bump, out=window)


def corner_targets(detections, categories, input_size, output_size, gaussian_iou=0.3,
                   max_tag_len=MAX_TAG_LEN):
    """detections (n, 5): [x1, y1, x2, y2, category (1-based)] in input pixels."""
    oh, ow = output_size
    wr, hr = ow / input_size[1], oh / input_size[0]
    out = {"tl_heatmaps": np.zeros((oh, ow, categories), np.float32),
           "br_heatmaps": np.zeros((oh, ow, categories), np.float32),
           "tl_regrs": np.zeros((max_tag_len, 2), np.float32),
           "br_regrs": np.zeros((max_tag_len, 2), np.float32),
           "tl_tags": np.zeros((max_tag_len,), np.int64),
           "br_tags": np.zeros((max_tag_len,), np.int64),
           "tag_mask": np.zeros((max_tag_len,), bool)}
    for i, det in enumerate(detections[:max_tag_len]):
        c = int(det[-1]) - 1
        fxtl, fytl, fxbr, fybr = det[0] * wr, det[1] * hr, det[2] * wr, det[3] * hr
        xtl, ytl, xbr, ybr = int(fxtl), int(fytl), int(fxbr), int(fybr)
        width = math.ceil((det[2] - det[0]) * wr)
        height = math.ceil((det[3] - det[1]) * hr)
        radius = max(0, int(gaussian_radius((height, width), gaussian_iou)))
        draw_gaussian(out["tl_heatmaps"][..., c], (xtl, ytl), radius)
        draw_gaussian(out["br_heatmaps"][..., c], (xbr, ybr), radius)
        out["tl_regrs"][i] = [fxtl - xtl, fytl - ytl]
        out["br_regrs"][i] = [fxbr - xbr, fybr - ybr]
        out["tl_tags"][i] = ytl * ow + xtl
        out["br_tags"][i] = ybr * ow + xbr
        out["tag_mask"][i] = True
    return out
