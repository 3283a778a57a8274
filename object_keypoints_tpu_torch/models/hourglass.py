"""CornerNet-Squeeze fire-module hourglass backbone (NCHW).

Counterpart of ``object_keypoints_tpu/models/hourglass.py`` (``FireHourglass``
and ``HourglassStack``). Attribute names follow the reference torch
state_dict: ``pre.{0,1,2}``, ``hgs.{s}.{up1,low1,low2,low3,up2}``,
``cnvs.{s}``, ``inters.{s}``, ``inters_.{s}``, ``cnvs_.{s}``.

``up2`` is ``ConvTranspose2d(4, stride 2, padding 1)``; the flax kernel of the
same layer is the spatially flipped, transposed torch weight
(``serving.weights`` converts). ``pre.0`` is a ``StemConvBlock``: in eval
mode it runs the stem kernel.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from object_keypoints_tpu_torch.models.blocks import (
    ConvBlock,
    ConvTranspose2d,
    FireModule,
    MergeBN,
    Residual,
    StemConvBlock,
)
from object_keypoints_tpu_torch.ops.stem_conv import stem_conv


class FireHourglass(nn.Module):
    """One recursive hourglass level on ``dims[0]``-wide input."""

    def __init__(self, n: int, dims: Sequence[int], mods: Sequence[int]):
        super().__init__()
        curr_dim, next_dim = dims[0], dims[1]
        curr_mod, next_mod = mods[0], mods[1]
        self.up1 = nn.Sequential(*[FireModule(curr_dim, curr_dim) for _ in range(curr_mod)])
        self.low1 = nn.Sequential(
            FireModule(curr_dim, next_dim, stride=2),
            *[FireModule(next_dim, next_dim) for _ in range(1, curr_mod)],
        )
        if n > 1:
            self.low2 = FireHourglass(n - 1, dims[1:], mods[1:])
        else:
            self.low2 = nn.Sequential(*[FireModule(next_dim, next_dim) for _ in range(next_mod)])
        self.low3 = nn.Sequential(
            *[FireModule(next_dim, next_dim) for _ in range(curr_mod - 1)],
            FireModule(next_dim, curr_dim),
        )
        self.up2 = ConvTranspose2d(curr_dim, curr_dim, 4, stride=2, padding=1)

    def forward(self, x):
        return self.up1(x) + self.up2(self.low3(self.low2(self.low1(x))))


class HourglassStack(nn.Module):
    """Stem (511 -> 256 -> 128 -> 64) + ``stacks`` hourglasses with 1x1+BN
    inter-stack fusion; returns the per-stack ``cnv_dim`` feature maps."""

    def __init__(self, stacks: int = 2, levels: int = 4,
                 dims: Sequence[int] = (256, 256, 384, 384, 512),
                 mods: Sequence[int] = (2, 2, 2, 2, 4),
                 stem_features: Sequence[int] = (128, 256), cnv_dim: int = 256):
        super().__init__()
        if not stem_features[1] == dims[0] == cnv_dim:
            raise ValueError(
                "the hourglass input width dims[0] must equal stem_features[1] and "
                f"cnv_dim, got {dims[0]}, {stem_features[1]}, {cnv_dim}"
            )
        self.stacks, self.levels, self.mods = stacks, levels, tuple(mods)
        self.pre = nn.ModuleList([
            StemConvBlock(stem_features[0]),
            Residual(stem_features[0], stem_features[1], stride=2),
            Residual(stem_features[1], stem_features[1], stride=2),
        ])
        self.hgs = nn.ModuleList([FireHourglass(levels, dims, mods) for _ in range(stacks)])
        self.cnvs = nn.ModuleList([ConvBlock(dims[0], cnv_dim, 3) for _ in range(stacks)])
        self.inters = nn.ModuleList([Residual(cnv_dim, cnv_dim) for _ in range(stacks - 1)])
        self.inters_ = nn.ModuleList([MergeBN(cnv_dim, cnv_dim) for _ in range(stacks - 1)])
        self.cnvs_ = nn.ModuleList([MergeBN(cnv_dim, cnv_dim) for _ in range(stacks - 1)])

    def forward(self, x, stem=stem_conv):
        inter = self.pre[2](self.pre[1](self.pre[0](x, stem)))
        outs = []
        for s in range(self.stacks):
            cnv = self.cnvs[s](self.hgs[s](inter))
            outs.append(cnv)
            if s < self.stacks - 1:
                fused = torch.relu(self.inters_[s](inter) + self.cnvs_[s](cnv))
                inter = self.inters[s](fused)
        return outs
