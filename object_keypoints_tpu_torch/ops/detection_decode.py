"""CornerNet detection decoding: top-K corners -> paired boxes.

Counterpart of ``object_keypoints_tpu/ops/detection_decode.py`` on NCHW
heads: sigmoid (in float32, whatever the heads' dtype) -> max-pool NMS ->
per-image top-K corners over classes x pixels -> sub-pixel offsets -> all
K x K top-left / bottom-right pairings scored by their mean heat, rejected
(score -1) on a class mismatch, a tag distance above ``ae_threshold``, an
inverted box (and, with ``no_border``, a corner on the map's border) ->
the top ``num_dets`` pairings.

Output: (N, num_dets, 8) = [x1, y1, x2, y2, score, tl_score, br_score,
class] in output-map pixels.

Tie order: both top-Ks put equal scores lowest flat index first, as
``lax.top_k`` does; the pairing scores hold a plateau of exactly -1 (every
rejected pair) and bf16 heads give equal sigmoids often, so top-K here is
a stable descending sort followed by a slice (``torch.topk`` promises no
order for ties). The flat corner index is class-major, (class, y, x), the
NCHW flatten.
"""

from __future__ import annotations

import torch

from object_keypoints_tpu_torch.ops.decode import maxpool_nms


def top_k_stable(x, k: int):
    """The k largest entries of each row of x (..., n), equal values lowest
    index first: (values, indices)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def topk_corners(scores, k: int):
    """(N, C, H, W) -> the per-image top k over all class / pixel bins:
    (scores, pix, classes, ys, xs), each (N, k); pix is the flat pixel
    index y * W + x, ys and xs are float32."""
    n, _, h, w = scores.shape
    top, inds = top_k_stable(scores.reshape(n, -1), k)
    classes = inds // (h * w)
    pix = inds % (h * w)
    return top, pix, classes, (pix // w).float(), (pix % w).float()


def _gather_pixels(feat, pix):
    """(N, C, H, W) features at flat pixel indices pix (N, K) -> (N, K, C)."""
    n, c, h, w = feat.shape
    flat = feat.reshape(n, c, h * w)
    return flat.gather(2, pix[:, None, :].expand(n, c, pix.shape[1])).transpose(1, 2)


def decode_detections(tl_heat, br_heat, tl_tag, br_tag, tl_regr, br_regr,
                      K: int = 100, kernel: int = 1, ae_threshold: float = 1.0,
                      num_dets: int = 1000, no_border: bool = False):
    """Heads in NCHW: heats (N, C, H, W), tags (N, 1, H, W), offsets
    (N, 2, H, W) -> detections (N, num_dets, 8), float32."""
    n, _, h, w = tl_heat.shape
    tl_p = torch.sigmoid(tl_heat.float())
    br_p = torch.sigmoid(br_heat.float())
    if kernel > 1:
        tl_p = maxpool_nms(tl_p, size=kernel)
        br_p = maxpool_nms(br_p, size=kernel)

    tl_scores, tl_pix, tl_cls, tl_ys, tl_xs = topk_corners(tl_p, K)
    br_scores, br_pix, br_cls, br_ys, br_xs = topk_corners(br_p, K)

    tl_off = _gather_pixels(tl_regr.float(), tl_pix)  # (N, K, 2)
    br_off = _gather_pixels(br_regr.float(), br_pix)
    tl_xs = tl_xs + tl_off[..., 0]
    tl_ys = tl_ys + tl_off[..., 1]
    br_xs = br_xs + br_off[..., 0]
    br_ys = br_ys + br_off[..., 1]

    # K x K pairings: tl along dim 1, br along dim 2
    txs, tys = tl_xs[:, :, None], tl_ys[:, :, None]
    bxs, bys = br_xs[:, None, :], br_ys[:, None, :]
    bboxes = torch.stack(torch.broadcast_tensors(txs, tys, bxs, bys), dim=3)

    tl_tag_k = _gather_pixels(tl_tag.float(), tl_pix)[..., 0]
    br_tag_k = _gather_pixels(br_tag.float(), br_pix)[..., 0]
    dists = (tl_tag_k[:, :, None] - br_tag_k[:, None, :]).abs()

    scores = (tl_scores[:, :, None] + br_scores[:, None, :]) / 2.0

    reject = tl_cls[:, :, None] != br_cls[:, None, :]
    reject |= dists > ae_threshold
    reject |= bxs < txs
    reject |= bys < tys
    if no_border:
        raw_tys = tl_ys - tl_off[..., 1]
        raw_txs = tl_xs - tl_off[..., 0]
        raw_bys = br_ys - br_off[..., 1]
        raw_bxs = br_xs - br_off[..., 0]
        reject |= (raw_tys[:, :, None] == 0) | (raw_txs[:, :, None] == 0)
        reject |= (raw_bys[:, None, :] == h - 1) | (raw_bxs[:, None, :] == w - 1)
    scores = torch.where(reject, -1.0, scores)

    top_scores, top_inds = top_k_stable(scores.reshape(n, -1), num_dets)
    boxes = bboxes.reshape(n, -1, 4).gather(1, top_inds[..., None].expand(n, num_dets, 4))
    # flat pairing index = tl * K + br
    tl_k, br_k = top_inds // K, top_inds % K
    clses = tl_cls.gather(1, tl_k).float()
    tl_s = tl_scores.gather(1, tl_k)
    br_s = br_scores.gather(1, br_k)
    return torch.cat([boxes, top_scores[..., None], tl_s[..., None], br_s[..., None],
                      clses[..., None]], dim=2)
