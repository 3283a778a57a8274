"""Plain reference of ``valve_keypointnet.json``: the object_keypoints
KeypointNet (ethz-asl/object_keypoints, perception/models.py) in ``torch.nn``.

A two-stack fire hourglass (``reference.layers``) and, per stack, three
prediction heads (1x1 conv-bn-relu to ``features``, 1x1 conv-bn-relu to 32,
1x1 conv with bias): heatmap logits (K maps), depth (K maps) and center
offsets (2 (K - 1) maps, read as (K - 1, 2)). The serving contract returns
the last stack's sigmoid heatmaps, depth and centers, float32.
"""

from __future__ import annotations

import torch
from torch import nn

from reference.layers import Conv2d, ConvBlock, HourglassStack


class PredictionModule(nn.Sequential):
    def __init__(self, in_dim, features, out):
        super().__init__(ConvBlock(in_dim, features, 1), ConvBlock(features, 32, 1),
                         Conv2d(32, out, 1, bias=True))


class KeypointNet(nn.Module):
    def __init__(self, heatmaps_out, features=128, stacks=2, levels=4,
                 dims=(256, 256, 384, 384, 512), mods=(2, 2, 2, 2, 4),
                 stem_features=(128, 256), cnv_dim=256, **_):
        super().__init__()
        self.heatmaps_out = heatmaps_out
        self.backbone = HourglassStack(stacks, levels, tuple(dims), tuple(mods),
                                       tuple(stem_features), cnv_dim)
        for head, out in (("heatmap", heatmaps_out), ("depth", heatmaps_out),
                          ("center", 2 * (heatmaps_out - 1))):
            setattr(self, f"{head}_head", nn.ModuleDict({
                f"output_head{s + 1}": PredictionModule(cnv_dim, features, out)
                for s in range(stacks)}))

    def forward(self, x):
        """Eval-mode serve outputs of the last stack: (sigmoid heatmaps,
        depth, centers (N, K - 1, 2, h, w))."""
        f = self.backbone(x)[-1]
        key = f"output_head{len(self.heatmap_head)}"
        c = self.center_head[key](f)
        n, _, h, w = c.shape
        return (torch.sigmoid(self.heatmap_head[key](f)), self.depth_head[key](f),
                c.reshape(n, self.heatmaps_out - 1, 2, h, w))


def reference_model(config: dict) -> KeypointNet:
    return KeypointNet(**config["model"])
