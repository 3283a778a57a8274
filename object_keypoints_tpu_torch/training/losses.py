"""The keypoint training loss.

Counterpart of ``object_keypoints_tpu/training/losses.py::keypoint_loss``
(the reference's perception/loss.py:19-48), with its reduction structure:

- heatmap: BCE-with-logits, summed over (C, H, W), then meaned over the
  batch, per stack, stacks summed;
- depth: L1 on the pixels where the target heatmap is above 0.01, sum / N;
- center: smooth-L1 (beta 1) on the mask of the K-1 non-center maps
  broadcast over the 2 offset channels, sum / N;
- total = heatmap + depth_weight * depth + center_weight * center.

The per-stack lists hold the *unnormalized* depth and center sums, as the
reference logs them. Layouts are NCHW: heatmaps and depth (N, K, H, W),
centers (N, T, 2, H, W). Masks select by ``torch.where``, never by
boolean indexing, so the loss runs on the card without a host sync. The
CornerNet losses come with the detector.
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
