"""CornerNet detection training targets: corner heatmaps and tag buffers.

The port's copy of ``object_keypoints_tpu/data/detection_targets.py`` (the
vendored COCO batch sampler's target math, core/sample/cornernet.py:32-160,
core/sample/utils.py:42-128, core/sample/cornernet_saccade.py:8-268):
gaussian corner bumps with the 3-case IoU-derived radius, sub-pixel offset
targets, flat tag indices and validity masks packed into fixed max_tag_len
buffers, and CornerNet-Saccade's crop-around-object sampler with its
attention and validity targets. Host numpy (the input pipeline), copied
function for function, so that the same ``numpy.random.Generator`` draws
the same targets; the heatmaps are (oh, ow, C), the layout of the JAX
package's batches. ``gather_tags`` is torch: it gathers NCHW head maps at
the targets' flat indices for the losses (``training.losses``).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

MAX_TAG_LEN = 128  # sample/cornernet.py:49


def gaussian_radius(det_size, min_overlap: float) -> float:
    """Least corner-bump radius keeping box IoU >= min_overlap.

    Re-derivation of the 3-case bound (semantics of sample/utils.py:65-86):
    shifting a corner by r changes the overlap in one of three geometric
    ways — both corners move inward, the detected box shrinks, or it grows —
    and each case reduces to a quadratic ``q2*r^2 + q1*r + q0 = 0`` in the
    admissible radius; ``branch`` selects which root bounds r from above.
    The binding constraint is the tightest of the three.
    """
    height, width = det_size
    t = min_overlap
    perim_half = height + width
    area = width * height
    cases = (
        # (q2, q1, q0, branch)
        (1.0, -perim_half, area * (1 - t) / (1 + t), -1.0),  # corners inward
        (4.0, -2 * perim_half, (1 - t) * area, -1.0),  # box shrunk by r
        (4.0 * t, 2 * t * perim_half, (t - 1) * area, 1.0),  # box grown by r
    )
    bounds = []
    for q2, q1, q0, branch in cases:
        disc = math.sqrt(q1 * q1 - 4 * q2 * q0)
        bounds.append((-q1 + branch * disc) / (2 * q2))
    return min(bounds)


def draw_gaussian(heatmap: np.ndarray, center, radius: int, k: float = 1.0) -> None:
    """Max-composite an isotropic gaussian peak into a heatmap in place.

    Semantics of sample/utils.py:50-63 (sigma = diameter/6, truncation to
    the radius window, sub-eps tail zeroed, max composition), re-expressed
    as a direct evaluation over the clipped map/window intersection instead
    of slicing a precomputed (2r+1)^2 kernel — no kernel allocation, and the
    clipping arithmetic is plain rectangle intersection.
    """
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
    # the untruncated peak value is exp(0) == 1, so the support cutoff is
    # absolute: anything below f64 eps is outside the kernel's support
    bump[bump < np.finfo(bump.dtype).eps] = 0.0
    window = heatmap[y0:y1, x0:x1]
    np.maximum(window, bump * k, out=window)


def render_corner_targets(
    detections: np.ndarray,
    categories: int,
    input_size: Sequence[int],
    output_size: Sequence[int],
    gaussian_bump: bool = True,
    gaussian_iou: float = 0.3,
    gaussian_rad: int = -1,
    max_tag_len: int = MAX_TAG_LEN,
):
    """Targets for one image (sample/cornernet.py:101-160).

    detections: (N, 5) [x1, y1, x2, y2, category(1-based)] in input pixels.
    Returns dict(tl_heatmaps/br_heatmaps (cat, oh, ow) NCHW-free —
    actually (oh, ow, cat) NHWC — tl_regrs/br_regrs (max_tag_len, 2),
    tl_tags/br_tags (max_tag_len,) flat output-pixel indices, tag_mask
    (max_tag_len,)).
    """
    oh, ow = output_size
    width_ratio = ow / input_size[1]
    height_ratio = oh / input_size[0]

    tl_heat = np.zeros((oh, ow, categories), np.float32)
    br_heat = np.zeros((oh, ow, categories), np.float32)
    tl_regrs = np.zeros((max_tag_len, 2), np.float32)
    br_regrs = np.zeros((max_tag_len, 2), np.float32)
    tl_tags = np.zeros((max_tag_len,), np.int64)
    br_tags = np.zeros((max_tag_len,), np.int64)
    tag_mask = np.zeros((max_tag_len,), bool)

    for ind, det in enumerate(detections[:max_tag_len]):
        category = int(det[-1]) - 1
        fxtl, fytl = det[0] * width_ratio, det[1] * height_ratio
        fxbr, fybr = det[2] * width_ratio, det[3] * height_ratio
        xtl, ytl, xbr, ybr = int(fxtl), int(fytl), int(fxbr), int(fybr)

        if gaussian_bump:
            width = det[2] - det[0]
            height = det[3] - det[1]
            width = math.ceil(width * width_ratio)
            height = math.ceil(height * height_ratio)
            if gaussian_rad == -1:
                radius = max(0, int(gaussian_radius((height, width), gaussian_iou)))
            else:
                radius = gaussian_rad
            draw_gaussian(tl_heat[..., category], (xtl, ytl), radius)
            draw_gaussian(br_heat[..., category], (xbr, ybr), radius)
        else:
            tl_heat[ytl, xtl, category] = 1.0
            br_heat[ybr, xbr, category] = 1.0

        tl_regrs[ind] = [fxtl - xtl, fytl - ytl]
        br_regrs[ind] = [fxbr - xbr, fybr - ybr]
        tl_tags[ind] = ytl * ow + xtl
        br_tags[ind] = ybr * ow + xbr
        tag_mask[ind] = True

    return {
        "tl_heatmaps": tl_heat,
        "br_heatmaps": br_heat,
        "tl_regrs": tl_regrs,
        "br_regrs": br_regrs,
        "tl_tags": tl_tags,
        "br_tags": br_tags,
        "tag_mask": tag_mask,
    }


def _clip_to_border(detections, border):
    """Clip boxes to (y0, y1, x0, x1); return (clipped, keep_mask)
    (sample/cornernet_saccade.py:19-31)."""
    dets = np.asarray(detections, np.float32).copy()
    if not len(dets):
        return dets, np.zeros((0,), bool)
    y0, y1, x0, x1 = border
    dets[:, 0:4:2] = np.clip(dets[:, 0:4:2], x0, x1 - 1)
    dets[:, 1:4:2] = np.clip(dets[:, 1:4:2], y0, y1 - 1)
    keep = ((dets[:, 2] - dets[:, 0]) > 0) & ((dets[:, 3] - dets[:, 1]) > 0)
    return dets[keep], keep


def saccade_ref_scale(detections, rand_crop: bool, rng) -> tuple:
    """Pick a reference object and a zoom scale putting its max side into one
    of the saccade view bands 16-32 / 32-96 / 96-255
    (sample/cornernet_saccade.py:83-100). Returns (scale | None, ref_ind)."""
    if detections.shape[0] == 0 or (rand_crop and rng.uniform() > 0.7):
        return None, None
    ref_ind = int(rng.integers(detections.shape[0]))
    det = detections[ref_ind]
    ref_hw = max(det[3] - det[1], det[2] - det[0])
    if ref_hw > 96:
        return int(rng.integers(96, 255)) / ref_hw, ref_ind
    if ref_hw > 32:
        return int(rng.integers(32, 97)) / ref_hw, ref_ind
    return int(rng.integers(16, 33)) / ref_hw, ref_ind


def create_attention_masks(att_sizes, att_ratios, att_ranges, detections):
    """Per-scale attention targets: mark the cell containing each object's
    center in the scale band matching its size
    (sample/cornernet_saccade.py:102-114). Returns [(ah, aw, 1) f32, ...]."""
    atts = [np.zeros((ah, aw, 1), np.float32) for ah, aw in att_sizes]
    for det in np.asarray(detections, np.float32):
        max_hw = max(det[2] - det[0], det[3] - det[1])
        for att, ratio, rng_band in zip(atts, att_ratios, att_ranges):
            if rng_band[0] <= max_hw <= rng_band[1]:
                x = int((det[0] + det[2]) / 2 / ratio)
                y = int((det[1] + det[3]) / 2 / ratio)
                if 0 <= y < att.shape[0] and 0 <= x < att.shape[1]:
                    att[y, x, 0] = 1.0
    return atts


def saccade_sample(image, detections, db_config, rng,
                   max_tag_len: int = MAX_TAG_LEN, flip: bool = True):
    """One CornerNet-Saccade training example: crop-around-object zoom
    sampling + corner/attention/validity targets
    (sample/cornernet_saccade.py:116-268, geometric part — color jitter and
    normalization stay with the batch stream like the cornernet sampler).

    image: (H, W, 3) uint8/float; detections: (N, 5)
    [x1, y1, x2, y2, category(1-based)] in image pixels.

    Returns (cropped_image, targets) with NHWC targets:
    tl/br_heatmaps (oh, ow, C), tl/br_valids (oh, ow, C) — 1 where the focal
    loss may penalize negatives, 0 inside untrainable (cropped/small) object
    bumps — tl/br_regrs (M, 2), tl/br_tags (M,), tag_mask (M,), and
    ``attentions`` [(ah, aw, 1), ...] per scale.
    """
    input_size = db_config["input_size"]
    output_size = db_config["output_sizes"][0]
    categories = db_config["categories"]
    rand_scales = db_config["rand_scales"]
    rand_crop = db_config["rand_crop"]
    rand_center = db_config["rand_center"]
    gaussian_iou = db_config["gaussian_iou"]
    gaussian_rad = db_config["gaussian_radius"]
    att_ratios = db_config["att_ratios"]
    att_ranges = db_config["att_ranges"]
    att_sizes = db_config["att_sizes"]
    min_scale = db_config["min_scale"]

    orig = np.asarray(detections, np.float32).copy()
    dets, keep = _clip_to_border(
        orig, (0, image.shape[0], 0, image.shape[1])
    )
    keep_inds = np.flatnonzero(keep) if len(orig) else np.zeros((0,), np.int64)

    scale, ref_ind = saccade_ref_scale(dets, rand_crop, rng)
    if scale is None:
        scale = float(rng.choice(np.asarray(rand_scales)))
    orig[:, 0:4] *= scale

    new_size = (int(image.shape[0] * scale), int(image.shape[1] * scale))
    import cv2

    image = cv2.resize(image, (new_size[1], new_size[0]))
    dets[:, 0:4] *= scale

    # crop center: around the reference object (jittered when rand_center),
    # or a uniformly random window containing it
    # (sample/cornernet_saccade.py:33-70)
    ih, iw = input_size
    h, w = image.shape[:2]

    centered = rand_center and rng.uniform() > 0.5

    def _axis_center(lo_edge, hi_edge, span, extent):
        """Random crop center along one axis given the ref det edges."""
        if not rand_crop or extent <= span:
            return extent // 2
        if lo_edge is None or not centered:
            lo = max(hi_edge - span, 0) if lo_edge is not None else 0
            hi = min(extent - span, lo_edge) if lo_edge is not None else extent - span
            # A zoomed reference box larger than the input span would give
            # hi < lo (latent in the reference sampler too,
            # sample/cornernet_saccade.py:47-56); clamp to a valid window.
            hi = max(hi, lo)
            return int(rng.integers(int(lo), int(hi) + 1)) + span // 2
        mid = (lo_edge + hi_edge) // 2
        lo = max(mid - int(rng.integers(0, 15)), 0)
        hi = min(mid + int(rng.integers(0, 15)), extent - 1)
        return int(rng.integers(int(lo), int(hi) + 1))

    if ref_ind is not None:
        x0d, y0d, x1d, y1d = dets[ref_ind, 0:4]
    else:
        x0d = y0d = x1d = y1d = None
    xc = _axis_center(x0d, x1d, iw, w)
    yc = _axis_center(y0d, y1d, ih, h)

    from object_keypoints_tpu_torch.data.detection_augment import crop_image_around

    image, border, offset = crop_image_around(image, (yc, xc), (ih, iw))
    dets[:, 0:4:2] -= offset[1]
    dets[:, 1:4:2] -= offset[0]

    dets, keep = _clip_to_border(dets, border)
    keep_inds = keep_inds[keep] if len(keep_inds) else keep_inds

    if flip and rng.uniform() > 0.5:
        image = np.ascontiguousarray(image[:, ::-1])
        if len(dets):
            dets[:, [0, 2]] = image.shape[1] - dets[:, [2, 0]] - 1

    attentions = create_attention_masks(att_sizes, att_ratios, att_ranges, dets)

    # survived-the-crop test: area ratio vs the zoomed original box > 0.5
    # (sample/cornernet_saccade.py:8-17,206)
    if len(dets):
        surv = orig[keep_inds]
        area = (dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1])
        orig_area = (surv[:, 2] - surv[:, 0]) * (surv[:, 3] - surv[:, 1])
        overlaps = area / np.maximum(orig_area, 1e-9) > 0.5
    else:
        overlaps = np.zeros((0,), bool)

    oh, ow = output_size
    width_ratio = ow / iw
    height_ratio = oh / ih
    tl_heat = np.zeros((oh, ow, categories), np.float32)
    br_heat = np.zeros((oh, ow, categories), np.float32)
    tl_valid = np.zeros((oh, ow, categories), np.float32)
    br_valid = np.zeros((oh, ow, categories), np.float32)
    tl_regrs = np.zeros((max_tag_len, 2), np.float32)
    br_regrs = np.zeros((max_tag_len, 2), np.float32)
    tl_tags = np.zeros((max_tag_len,), np.int64)
    br_tags = np.zeros((max_tag_len,), np.int64)
    tag_mask = np.zeros((max_tag_len,), bool)
    tag_len = 0

    for det, overlap in zip(dets, overlaps):
        category = int(det[-1]) - 1
        det_max = max(int(det[3]) - int(det[1]), int(det[2]) - int(det[0]))
        trainable = overlap and det_max >= min_scale

        fxtl, fytl = det[0] * width_ratio, det[1] * height_ratio
        fxbr, fybr = det[2] * width_ratio, det[3] * height_ratio
        xtl, ytl, xbr, ybr = int(fxtl), int(fytl), int(fxbr), int(fybr)

        width = math.ceil((det[2] - det[0]) * width_ratio)
        height = math.ceil((det[3] - det[1]) * height_ratio)
        if gaussian_rad == -1:
            radius = max(0, int(gaussian_radius((height, width), gaussian_iou)))
        else:
            radius = gaussian_rad

        if trainable and tag_len < max_tag_len:
            draw_gaussian(tl_heat[..., category], (xtl, ytl), radius)
            draw_gaussian(br_heat[..., category], (xbr, ybr), radius)
            tl_regrs[tag_len] = [fxtl - xtl, fytl - ytl]
            br_regrs[tag_len] = [fxbr - xbr, fybr - ybr]
            tl_tags[tag_len] = ytl * ow + xtl
            br_tags[tag_len] = ybr * ow + xbr
            tag_mask[tag_len] = True
            tag_len += 1
        else:
            # untrainable objects get their bump EXCLUDED from the focal
            # negatives via the validity mask (cornernet_saccade.py:259-264)
            draw_gaussian(tl_valid[..., category], (xtl, ytl), radius)
            draw_gaussian(br_valid[..., category], (xbr, ybr), radius)

    targets = {
        "tl_heatmaps": tl_heat,
        "br_heatmaps": br_heat,
        "tl_valids": (tl_valid == 0).astype(np.float32),
        "br_valids": (br_valid == 0).astype(np.float32),
        "tl_regrs": tl_regrs,
        "br_regrs": br_regrs,
        "tl_tags": tl_tags,
        "br_tags": br_tags,
        "tag_mask": tag_mask,
        "attentions": attentions,
    }
    return image, targets


def gather_tags(feat, tags):
    """Per-tag features for the loss (_tranpose_and_gather_feat,
    py_utils/utils.py:21-25): (N, C, H, W) maps and (N, M) flat indices
    y * W + x -> (N, M, C)."""
    import torch

    n, c = feat.shape[:2]
    index = tags.to(device=feat.device, dtype=torch.int64)[:, None, :].expand(n, c, -1)
    return torch.gather(feat.flatten(2), 2, index).transpose(1, 2)
