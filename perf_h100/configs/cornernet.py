"""Plain reference of ``cornernet.json``: CornerNet with the Hourglass-104
(princeton-vl/CornerNet-Lite, core/models/CornerNet.py and
core/models/py_utils/losses.py) in ``torch.nn``, train mode.

- The backbone: ``reference.residual.ResidualHourglassStack``, two stacks
  of the five-level residual hourglass, one stride-2 stem residual.
- Per stack, the top-left and bottom-right corner-pool blocks and their
  heads (3x3 conv with bias + ReLU, 1x1 conv with bias): heats (categories),
  tags (1), offsets (2). The blocks, the pools, the heads and the loss are
  ``cornernet_squeeze.py``'s, loaded from beside this file: CornerNet-Lite's
  two models share them, and CornerNet's heads are 3x3 where Squeeze's are
  1x1.

Departure from the published model, in memory and not in value: in a step
(gradients on) the stem, each stack and each corner's pool block with its
three heads are segments under ``torch.utils.checkpoint`` (``recompute``),
their activations made again in the backward, so that a float32 step of 49
images fits on one card. BatchNorm's running statistics are therefore
updated twice a step; the check compares none of them.
"""

from __future__ import annotations

import os

from torch import nn

from harness.core import load_module
from reference.residual import ResidualHourglassStack, segment

squeeze = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)), "cornernet_squeeze.py"),
                      "perf_config_cornernet_squeeze")

loss = squeeze.loss
HEADS = ("heats", "tags", "offs")


class CornerNet(nn.Module):
    def __init__(self, categories=80, stacks=2, levels=5, dims=(256, 256, 384, 384, 384, 512),
                 mods=(2, 2, 2, 2, 2, 4), cnv_dim=256, stem_residuals=1, head_kernel=3,
                 recompute=True):
        super().__init__()
        self.recompute = recompute
        self.hg = ResidualHourglassStack(stacks, levels, tuple(dims), tuple(mods), (128, 256),
                                         cnv_dim, stem_residuals, recompute)
        self.tl_modules = nn.ModuleList([squeeze.CornerPoolBlock(cnv_dim, squeeze.top_pool,
                                                                 squeeze.left_pool)
                                         for _ in range(stacks)])
        self.br_modules = nn.ModuleList([squeeze.CornerPoolBlock(cnv_dim, squeeze.bottom_pool,
                                                                 squeeze.right_pool)
                                         for _ in range(stacks)])
        for side in ("tl", "br"):
            for head, out in zip(HEADS, (categories, 1, 2)):
                setattr(self, f"{side}_{head}", nn.ModuleList(
                    [squeeze.PredModule(cnv_dim, out, kernel=head_kernel) for _ in range(stacks)]))

    def _corner(self, side, s, cnv):
        """Stack s's pool block of one corner and its heat, tag and offset maps."""
        pooled = getattr(self, f"{side}_modules")[s](cnv)
        return tuple(getattr(self, f"{side}_{head}")[s](pooled) for head in HEADS)

    def forward(self, x):
        """Per-stack lists: tl_heats, br_heats, tl_tags, br_tags, tl_offs,
        br_offs (NCHW)."""
        outs = []
        for s, cnv in enumerate(self.hg(x)):
            tl = segment(self.recompute, self._corner, "tl", s, cnv)
            br = segment(self.recompute, self._corner, "br", s, cnv)
            outs.append((tl[0], br[0], tl[1], br[1], tl[2], br[2]))
        return [list(t) for t in zip(*outs)]


def reference_model(config: dict, recompute: bool = True) -> CornerNet:
    return CornerNet(config["db"]["categories"], **config["model"], recompute=recompute)
