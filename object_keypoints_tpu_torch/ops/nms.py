"""Box NMS family: IoU matrix, greedy IoU NMS, soft-NMS, merge soft-NMS.

Counterpart of ``object_keypoints_tpu/ops/nms.py``. Detections are
[x1, y1, x2, y2, score(, tl_score, br_score)] rows; the functions return
masks or updated scores rather than ragged keep-lists. The greedy loops run
in plain torch on the detections' device, batched over a leading class axis
(``soft_nms_batch``, ``soft_nms_merge_batch`` over a (C, N, width) stack
that ``pad_class_dets`` builds), and no step waits for the host: the
selected row is a one-hot mask, never a host index. ``torch.argmax``
returns the first maximal index, as ``jnp.argmax`` does.

The JAX package's departures from the reference's Cython are kept: corner
scores stay attached to their boxes in the merge, its divisors are held at
1e-12 or above, and a row whose decayed score falls below ``threshold`` is
dead: score 0, never selected, and no part of a later merge.

``steps`` stops a batch loop early. Pad rows (``PAD_BOX``: score 0, far
outside any image) sort after every real row, so after a class's real rows
each step selects a pad row, which has IoU 0 with every real box and leaves
every real row as it was. A caller that knows the largest class's count of
real rows may stop there; the pad rows' own values then differ from a full
loop's (the merge rewrites a selected pad box), and callers drop them.
"""

from __future__ import annotations

import numpy as np
import torch

# a unit box far outside any image: IoU 0 with every real box; score 0, so
# every real (positive-score) row is processed before any filler
PAD_BOX = (-1e6, -1e6, -1e6, -1e6, 0.0)


def _areas(boxes):
    return (boxes[..., 2] - boxes[..., 0] + 1.0) * (boxes[..., 3] - boxes[..., 1] + 1.0)


def bbox_overlaps(boxes, query_boxes):
    """(N, 4) x (K, 4) -> (N, K) intersection over union, with the
    reference's +1 pixel extents."""
    lt = torch.maximum(boxes[:, None, :2], query_boxes[None, :, :2])
    rb = torch.minimum(boxes[:, None, 2:4], query_boxes[None, :, 2:4])
    wh = torch.clamp(rb - lt + 1.0, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = _areas(boxes)[:, None] + _areas(query_boxes)[None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def _iou_selected(box, boxes):
    """IoU of each class's selected box (C, 4) with its rows (C, N, 4) ->
    (C, N), ``bbox_overlaps``' arithmetic."""
    lt = torch.maximum(box[:, None, :2], boxes[..., :2])
    rb = torch.minimum(box[:, None, 2:4], boxes[..., 2:4])
    wh = torch.clamp(rb - lt + 1.0, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = _areas(box)[:, None] + _areas(boxes) - inter
    return torch.where(union > 0, inter / union, 0.0)


def nms_mask(dets, threshold: float):
    """Greedy IoU NMS over (N, 5) detections in score order (ties in input
    order). Returns a boolean keep mask over the input order."""
    n = dets.shape[0]
    order = torch.argsort(-dets[:, 4], stable=True)
    iou = bbox_overlaps(dets[order, :4], dets[order, :4])
    rows = torch.arange(n, device=dets.device)
    keep = torch.ones(n, dtype=torch.bool, device=dets.device)
    for i in range(n):
        suppress = (iou[i] > threshold) & keep[i]
        keep = torch.where((rows > i) & suppress, False, keep)
    out = torch.zeros_like(keep)
    out[order] = keep
    return out


def _decay(iou, Nt: float, sigma: float, method: int):
    """Score weights: 0 hard NMS, 1 linear, 2 gaussian."""
    if method == 1:
        return torch.where(iou > Nt, 1.0 - iou, 1.0)
    if method == 2:
        return torch.exp(-(iou * iou) / sigma)
    return torch.where(iou > Nt, 0.0, 1.0)


def _select(boxes, scores, alive):
    """Each class's highest alive score: (its box (C, 4), one-hot (C, N) of
    the first maximal row, valid (C, 1): the class had an alive row)."""
    masked = torch.where(alive, scores, -torch.inf)
    i = masked.argmax(dim=1, keepdim=True)
    box = boxes.gather(1, i[..., None].expand(-1, 1, 4))[:, 0]
    rows = torch.arange(scores.shape[1], device=scores.device)
    return box, rows == i, masked.gather(1, i) > -torch.inf


def soft_nms_batch(dets, sigma: float = 0.5, Nt: float = 0.3, threshold: float = 0.001,
                   method: int = 0, steps: int | None = None):
    """Per-class soft-NMS over a (C, N, 5) stack: ``steps`` (default N)
    greedy steps, each selecting every class's highest unprocessed score and
    decaying the scores of the rows that overlap it. Returns the (C, N, 5)
    stack with the decayed scores; those below ``threshold`` are 0."""
    dets = dets.float()
    boxes, scores = dets[..., :4], dets[..., 4]
    alive = torch.ones_like(scores, dtype=torch.bool)
    n = dets.shape[1] if steps is None else steps
    for _ in range(n):
        box, onehot, valid = _select(boxes, scores, alive)
        weight = torch.where(onehot, 1.0, _decay(_iou_selected(box, boxes), Nt, sigma, method))
        scores = torch.where(alive & valid, scores * weight, scores)
        scores = torch.where(scores < threshold, 0.0, scores)
        alive = alive & ~onehot
    return torch.cat([boxes, scores[..., None]], dim=-1)


def soft_nms_merge_batch(dets, sigma: float = 0.5, Nt: float = 0.3, threshold: float = 0.001,
                         method: int = 2, weight_exp: float = 6.0, steps: int | None = None):
    """Per-class soft-NMS with box merging over a (C, N, 7) stack [x1, y1,
    x2, y2, score, tl_score, br_score] (a (C, N, 5) stack gets unit corner
    scores). At each step the selected box becomes the average of itself
    (weight 1) and every alive box that overlaps it (weight (1 - decay) **
    weight_exp), its top-left under tl_score weights and its bottom-right
    under br_score weights; rows that decay below ``threshold`` die."""
    dets = dets.float()
    if dets.shape[-1] >= 7:
        tl_score, br_score = dets[..., 5], dets[..., 6]
    else:
        tl_score = br_score = torch.ones_like(dets[..., 4])
    boxes, scores = dets[..., :4], dets[..., 4]
    alive = torch.ones_like(scores, dtype=torch.bool)
    n = dets.shape[1] if steps is None else steps
    for _ in range(n):
        box, onehot, valid = _select(boxes, scores, alive)
        weight = torch.where(onehot, 1.0, _decay(_iou_selected(box, boxes), Nt, sigma, method))
        # merge weights: (1 - decay) ** exp over the alive rows, 0 where they
        # do not overlap; the selected row enters with weight 1
        mw = torch.where(onehot, 1.0, torch.where(alive, (1.0 - weight) ** weight_exp, 0.0))
        tw, bw = tl_score * mw, br_score * mw
        merged_tl = (boxes[..., 0:2] * tw[..., None]).sum(dim=1, keepdim=True) / torch.clamp(
            tw.sum(dim=1)[:, None, None], min=1e-12)
        merged_br = (boxes[..., 2:4] * bw[..., None]).sum(dim=1, keepdim=True) / torch.clamp(
            bw.sum(dim=1)[:, None, None], min=1e-12)
        write = (onehot & valid)[..., None]
        boxes = torch.where(write, torch.cat([merged_tl, merged_br], dim=-1), boxes)

        scores = torch.where(alive & valid, scores * weight, scores)
        dead = scores < threshold
        scores = torch.where(dead, 0.0, scores)
        alive = alive & ~onehot & ~dead
    return torch.cat([boxes, scores[..., None], dets[..., 5:]], dim=-1)


def soft_nms(dets, sigma: float = 0.5, Nt: float = 0.3, threshold: float = 0.001,
             method: int = 0):
    """Soft-NMS of one (N, 5) set: ``soft_nms_batch`` of one class."""
    return soft_nms_batch(dets[None], sigma, Nt, threshold, method)[0]


def soft_nms_merge(dets, sigma: float = 0.5, Nt: float = 0.3, threshold: float = 0.001,
                   method: int = 2, weight_exp: float = 6.0):
    """Merge soft-NMS of one (N, 7) (or (N, 5)) set."""
    return soft_nms_merge_batch(dets[None], sigma, Nt, threshold, method, weight_exp)[0]


def pad_class_dets(per_class, n_pad: int, width: int = 5):
    """Stack ragged per-class (n_j, width) arrays into a (C, n_pad, width)
    float32 numpy stack with ``PAD_BOX`` filler; columns past 5 pad as 0."""
    out = np.zeros((len(per_class), n_pad, width), np.float32)
    out[:, :, :5] = np.asarray(PAD_BOX, np.float32)
    for j, d in enumerate(per_class):
        out[j, : len(d)] = d
    return out
