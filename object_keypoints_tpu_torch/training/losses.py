"""The keypoint training loss and the CornerNet losses.

Counterpart of ``object_keypoints_tpu/training/losses.py``. The keypoint
loss (``keypoint_loss``, the reference's perception/loss.py:19-48) keeps its
reduction structure:

- heatmap: BCE-with-logits, summed over (C, H, W), then meaned over the
  batch, per stack, stacks summed;
- depth: L1 on the pixels where the target heatmap is above 0.01, sum / N;
- center: smooth-L1 (beta 1) on the mask of the K-1 non-center maps
  broadcast over the 2 offset channels, sum / N;
- total = heatmap + depth_weight * depth + center_weight * center.

The per-stack lists hold the *unnormalized* depth and center sums, as the
reference logs them. Layouts are NCHW: heatmaps and depth (N, K, H, W),
centers (N, T, 2, H, W). Masks select by ``torch.where``, never by
boolean indexing, so the loss runs on the card without a host sync.

The CornerNet losses (the vendored core/models/py_utils/losses.py:9-224:
penalty-reduced focal, associative-embedding pull/push, masked smooth-L1
offsets, and CornerNet-Saccade's validity-masked focal and attention terms)
take the heads as the JAX functions take them, per-stack lists, in NCHW:
heats (N, C, H, W) logits, tags (N, M) and offsets (N, M, 2) gathered at the
targets' corners (``data.detection_targets.gather_tags``); targets are NCHW
heatmaps and (N, M) masks. Every term is computed in float32 (float64 stays
float64) on float32 casts of the heads, whatever their dtype: in bf16 the
sigmoid's clamp at 1 - 1e-4 rounds to 1 and log(1 - p) turns the JAX
package's bf16 loss infinite once a heat logit passes ~6.2. The
``num_pos == 0`` branch is a ``torch.where`` and every count stays a
tensor, so a step never waits for the host.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def keypoint_loss(p_heatmaps: Sequence[torch.Tensor], gt_heatmaps: torch.Tensor,
                  p_depth: Sequence[torch.Tensor], gt_depth: torch.Tensor,
                  p_centers: Sequence[torch.Tensor], gt_centers: torch.Tensor,
                  depth_weight: float = 10.0, center_weight: float = 1.0
                  ) -> Tuple[torch.Tensor, tuple, tuple, tuple]:
    """Per-stack losses and their weighted total: (total, heatmap_losses,
    depth_losses, center_losses). p_* are per-stack sequences of logits
    (heatmaps), depth and center offsets; gt_* single tensors of one
    stack's shape."""
    n = float(gt_heatmaps.shape[0])
    where_heat = gt_heatmaps > 0.01  # (N, K, H, W)
    center_mask = where_heat[:, 1:, None]  # (N, T, 1, H, W): both offset channels

    heatmap_total = depth_total = center_total = 0.0
    heatmap_losses, depth_losses, center_losses = [], [], []
    for p_hm, p_d, p_c in zip(p_heatmaps, p_depth, p_centers):
        hm = F.binary_cross_entropy_with_logits(p_hm, gt_heatmaps, reduction="none")
        hm = hm.sum(dim=(1, 2, 3)).mean()
        heatmap_total = heatmap_total + hm
        heatmap_losses.append(hm)

        d = torch.where(where_heat, (p_d - gt_depth).abs(), 0.0).sum()
        depth_total = depth_total + d / n
        depth_losses.append(d)

        c = F.smooth_l1_loss(p_c, gt_centers, reduction="none", beta=1.0)
        c = torch.where(center_mask, c, 0.0).sum()
        center_total = center_total + c / n
        center_losses.append(c)

    total = heatmap_total + depth_weight * depth_total + center_weight * center_total
    return total, tuple(heatmap_losses), tuple(depth_losses), tuple(center_losses)


class KeypointLoss:
    """Object wrapper with the reference constructor (loss.py:5-17)."""

    def __init__(self, keypoint_config, depth_weight: float = 10.0,
                 center_weight: float = 1.0, reduction: str = "mean"):
        if reduction not in ("mean", "sum"):
            raise NotImplementedError(
                f"Unknown reduction method {reduction}, try 'mean' or 'sum'.")
        self.keypoint_config = keypoint_config
        self.n_keypoint_maps = len(keypoint_config) + 1  # + center map
        self.depth_weight = depth_weight
        self.center_weight = center_weight

    def __call__(self, p_heatmaps, gt_heatmaps, p_depth, gt_depth, p_centers, gt_centers):
        return keypoint_loss(p_heatmaps, gt_heatmaps, p_depth, gt_depth, p_centers, gt_centers,
                             depth_weight=self.depth_weight, center_weight=self.center_weight)


# ---------------------------------------------------------------------------
# CornerNet losses
# ---------------------------------------------------------------------------


def _loss_dtype(x: torch.Tensor) -> torch.dtype:
    """float32 for bf16 / float16 / float32 heads, float64 for float64."""
    return torch.promote_types(x.dtype, torch.float32)


def _up(x: torch.Tensor) -> torch.Tensor:
    return x.to(_loss_dtype(x))


def _clamped_sigmoid(x):
    """sigmoid clamped into [1e-4, 1 - 1e-4] (losses.py:6-7), in float32. A
    max then a min, as ``jnp.clip`` is, so a tie at a bound splits the
    gradient as JAX's does (``torch.clamp`` would give it all to the input).
    The bounds are filled on the device: a tensor made from a host value
    would wait for the card."""
    p = torch.sigmoid(_up(x))
    lo = torch.full((), 1e-4, dtype=p.dtype, device=p.device)
    hi = torch.full((), 1.0 - 1e-4, dtype=p.dtype, device=p.device)
    return torch.minimum(torch.maximum(p, lo), hi)


def _smooth_l1(x, y):
    """smooth-L1 with beta 1: 0.5 d^2 where |d| < 1, else |d| - 0.5."""
    d = (x - y).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def _focal(preds: Sequence[torch.Tensor], gt: torch.Tensor, valid=None) -> torch.Tensor:
    gt = _up(gt)
    pos = gt == 1.0
    neg = ~pos
    neg_weights = torch.where(neg, (1.0 - gt) ** 4, 0.0)
    num_pos = pos.to(gt.dtype).sum()
    weight = 1.0 if valid is None else _up(valid)

    total = 0.0
    for p in preds:
        p = _up(p)
        pos_loss = torch.where(pos, torch.log(p) * (1.0 - p) ** 2 * weight, 0.0).sum()
        neg_loss = torch.where(neg, torch.log(1.0 - p) * p ** 2 * neg_weights * weight, 0.0).sum()
        total = total - torch.where(num_pos > 0, (pos_loss + neg_loss) / num_pos.clamp(min=1.0),
                                    neg_loss)
    return total


def focal_loss(preds: Sequence[torch.Tensor], gt: torch.Tensor) -> torch.Tensor:
    """Penalty-reduced focal loss over *probabilities* (losses.py:73-95):
    where gt == 1, log(p) (1 - p)^2; elsewhere log(1 - p) p^2 (1 - gt)^4;
    normalized by the count of positives, or the negatives' raw sum where
    there are none. Summed over the per-stack ``preds``."""
    return _focal(preds, gt)


def focal_loss_masked(preds: Sequence[torch.Tensor], gt: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """``focal_loss`` with each pixel's terms weighted by ``valid``
    (losses.py:46-71), CornerNet-Saccade's crops' per-pixel validity."""
    return _focal(preds, gt, valid)


def ae_loss(tag0: torch.Tensor, tag1: torch.Tensor, mask: torch.Tensor):
    """Associative-embedding pull and push on paired corner tags
    (losses.py:9-33). tag0, tag1: (N, M) gathered tag values; mask (N, M)
    bool. Returns (pull, push)."""
    tag0, tag1 = _up(tag0), _up(tag1)
    maskf = mask.to(tag0.dtype)
    num = maskf.sum(dim=1, keepdim=True)  # (N, 1)
    tag_mean = (tag0 + tag1) / 2.0

    pull0 = torch.where(mask, (tag0 - tag_mean) ** 2 / (num + 1e-4), 0.0).sum()
    pull1 = torch.where(mask, (tag1 - tag_mean) ** 2 / (num + 1e-4), 0.0).sum()
    pull = pull0 + pull1

    pair_mask = (maskf[:, :, None] + maskf[:, None, :]) == 2.0
    num2 = (num - 1.0) * num  # (N, 1)
    dist = tag_mean[:, :, None] - tag_mean[:, None, :]
    dist = torch.relu(1.0 - dist.abs())
    dist = dist - 1.0 / (num[..., None] + 1e-4)
    dist = dist / (num2[..., None] + 1e-4)
    push = torch.where(pair_mask, dist, 0.0).sum()
    return pull, push


def offset_loss(off: torch.Tensor, gt_off: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked smooth-L1 sub-pixel offset loss (losses.py:35-44). off, gt_off:
    (N, M, 2); mask: (N, M)."""
    off = _up(off)
    num = mask.to(off.dtype).sum()
    loss = torch.where(mask[..., None], _smooth_l1(off, _up(gt_off)), 0.0).sum()
    return loss / (num + 1e-4)


def _pull_push_offsets(tl_tags, br_tags, tl_offs, br_offs, gt_mask, gt_tl_off, gt_br_off):
    pull_total = push_total = off_total = 0.0
    for tl_tag, br_tag in zip(tl_tags, br_tags):
        pull, push = ae_loss(tl_tag, br_tag, gt_mask)
        pull_total = pull_total + pull
        push_total = push_total + push
    for tl_off, br_off in zip(tl_offs, br_offs):
        off_total = off_total + offset_loss(tl_off, gt_tl_off, gt_mask)
        off_total = off_total + offset_loss(br_off, gt_br_off, gt_mask)
    return pull_total, push_total, off_total


def cornernet_loss(outs, targets, pull_weight=1e-1, push_weight=1e-1, off_weight=1.0):
    """The CornerNet loss over stacks (losses.py:167-224).

    outs: (tl_heats, br_heats, tl_tags, br_tags, tl_offs, br_offs), per-stack
    sequences: heats (N, C, H, W) logits, tags (N, M), offsets (N, M, 2).
    targets: (gt_tl_heat, gt_br_heat, gt_mask, gt_tl_off, gt_br_off), heats
    (N, C, H, W)."""
    tl_heats, br_heats, tl_tags, br_tags, tl_offs, br_offs = outs
    gt_tl_heat, gt_br_heat, gt_mask, gt_tl_off, gt_br_off = targets

    focal = focal_loss([_clamped_sigmoid(t) for t in tl_heats], gt_tl_heat)
    focal = focal + focal_loss([_clamped_sigmoid(b) for b in br_heats], gt_br_heat)
    pull, push, off = _pull_push_offsets(tl_tags, br_tags, tl_offs, br_offs, gt_mask,
                                         gt_tl_off, gt_br_off)
    loss = focal + pull_weight * pull + push_weight * push + off_weight * off
    return loss / max(len(tl_heats), 1)


def cornernet_saccade_loss(outs, targets, pull_weight=1e-1, push_weight=1e-1, off_weight=1.0):
    """The CornerNet-Saccade loss (losses.py:97-165): the CornerNet terms
    with the validity-masked focal, plus a focal term for each attention
    scale, averaged over stacks.

    outs: (tl_heats, br_heats, tl_tags, br_tags, tl_offs, br_offs, atts),
    ``atts`` per-stack lists of per-scale attention logits (N, 1, h, w).
    targets: (gt_tl_heat, gt_br_heat, gt_mask, gt_tl_off, gt_br_off,
    gt_tl_valid, gt_br_valid, gt_atts), ``gt_atts`` a per-scale list of
    (N, 1, h, w) in the order of each stack's ``atts``."""
    tl_heats, br_heats, tl_tags, br_tags, tl_offs, br_offs, atts = outs
    (gt_tl_heat, gt_br_heat, gt_mask, gt_tl_off, gt_br_off,
     gt_tl_valid, gt_br_valid, gt_atts) = targets

    focal = focal_loss_masked([_clamped_sigmoid(t) for t in tl_heats], gt_tl_heat, gt_tl_valid)
    focal = focal + focal_loss_masked([_clamped_sigmoid(b) for b in br_heats], gt_br_heat,
                                      gt_br_valid)
    att_total = 0.0
    for scale, gt_att in enumerate(gt_atts):
        scale_preds = [_clamped_sigmoid(stack_atts[scale]) for stack_atts in atts]
        att_total = att_total + focal_loss(scale_preds, gt_att) / max(len(scale_preds), 1)
    pull, push, off = _pull_push_offsets(tl_tags, br_tags, tl_offs, br_offs, gt_mask,
                                         gt_tl_off, gt_br_off)
    loss = focal + att_total + pull_weight * pull + push_weight * push + off_weight * off
    return loss / max(len(tl_heats), 1)
