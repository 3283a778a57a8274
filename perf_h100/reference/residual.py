"""The residual hourglass, plain PyTorch, for the benchmark's reference.

A restatement of CornerNet's Hourglass-104 (princeton-vl/CornerNet-Lite,
core/models/CornerNet.py: its ``hg_module`` levels and ``hg_net`` stack)
with ``reference.layers``' blocks. A level: ``up1``, the level's residuals;
``low1``, a stride-2 residual to the next width, then residuals; ``low2``,
the next level (residuals at the deepest); ``low3``, residuals, the last back
to the level's width; out, ``up1 + nearest x2 upsample(low3)``. The stack,
``reference.layers.HourglassStack`` with these levels for its fire ones:
the 7x7/s2 stem and its stride-2 residuals, the hourglasses, each followed by
a 3x3 conv-bn-relu (``cnvs``), and between stacks the 1x1 + BN merges of the
stack's input (``inters_``) and features (``cnvs_``), summed, ReLU, and a
residual (``inters``). Attribute names are the reference state_dict's.

``segment`` runs a part of a forward under ``torch.utils.checkpoint`` where
gradients are on: only the part's inputs are kept and its activations are
made again in the backward, so that a float32 step of the published batch
fits on one card. It changes no value; BatchNorm's running statistics are
updated a second time by the recompute.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from reference.layers import HourglassStack, Residual, _level


def upsample_nearest2(x):
    """``nn.Upsample(scale_factor=2)``: nearest, each pixel to a 2x2 block."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class ResidualHourglass(nn.Module):
    def __init__(self, n, dims, mods, in_dim=None):
        super().__init__()
        _level(self, Residual, n, dims, mods, in_dim,
               lambda: ResidualHourglass(n - 1, dims[1:], mods[1:]))

    def forward(self, x):
        return self.up1(x) + upsample_nearest2(self.low3(self.low2(self.low1(x))))


def segment(recompute: bool, fn, *args):
    """``fn(*args)``; with ``recompute`` and gradients on, under a
    non-reentrant checkpoint (``torch.autograd.grad`` reaches through it)."""
    if recompute and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


class ResidualHourglassStack(HourglassStack):
    """``reference.layers.HourglassStack`` with residual hourglasses in place
    of the fire ones (the same keys); with ``recompute`` the stem and each
    stack (its hourglass, ``cnvs`` and the merge after it) are segments."""

    def __init__(self, stacks=2, levels=5, dims: Sequence[int] = (256, 256, 384, 384, 384, 512),
                 mods: Sequence[int] = (2, 2, 2, 2, 2, 4), stem_features=(128, 256), cnv_dim=256,
                 stem_residuals=1, recompute=True):
        super().__init__(stacks, levels, dims, mods, stem_features, cnv_dim, stem_residuals)
        self.recompute = recompute
        widths = [stem_features[1]] + [cnv_dim] * (stacks - 1)
        self.hgs = nn.ModuleList([ResidualHourglass(levels, dims, mods, in_dim=w) for w in widths])

    def _stem(self, x):
        for layer in self.pre:
            x = layer(x)
        return x

    def _stack(self, s, inter):
        """Stack s's features and, but after the last stack, the next one's input."""
        cnv = self.cnvs[s](self.hgs[s](inter))
        if s == self.stacks - 1:
            return cnv, None
        return cnv, self.inters[s](torch.relu(self.inters_[s](inter) + self.cnvs_[s](cnv)))

    def forward(self, x):
        inter = segment(self.recompute, self._stem, x)
        outs = []
        for s in range(self.stacks):
            cnv, inter = segment(self.recompute, self._stack, s, inter)
            outs.append(cnv)
        return outs
