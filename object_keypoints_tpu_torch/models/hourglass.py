"""Hourglass backbones (NCHW): the fire-module and the residual hourglass.

Counterpart of ``object_keypoints_tpu/models/hourglass.py`` (``FireHourglass``,
``ResidualHourglass`` and ``HourglassStack``). Attribute names follow the
reference torch state_dict: ``pre.{0,1[,2]}``,
``hgs.{s}.{up1,low1,low2,low3[,up2]}``, ``cnvs.{s}``, ``inters.{s}``,
``inters_.{s}``, ``cnvs_.{s}``.

The fire hourglass (CornerNet-Squeeze, the KeypointNet) unpools with
``ConvTranspose2d(4, stride 2, padding 1)``; the flax kernel of the same
layer is the spatially flipped, transposed torch weight (``serving.weights``
converts). The residual hourglass (CornerNet, CornerNet-Saccade) unpools
with a parameterless nearest x2, which picks input pixel ``o // 2`` as
``jax.image.resize(..., "nearest")`` does for an exact x2. ``pre.0`` is a
``StemConvBlock``: in eval mode it runs the stem kernel.

Widths are the ones flax infers: a level takes ``in_dim`` (``dims[0]`` by
default) and returns ``dims[0]``; a block whose input width or stride
differs from its output gets the projection skip it gets there.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
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

HOURGLASS = ("fire", "residual")


def _build_level(level, block, n, dims, mods, in_dim, inner):
    """Give ``level`` its up1, low1, low2 and low3, in the reference's order;
    low2 is ``inner()`` (the next level) where n > 1, else next_mod blocks."""
    curr_dim, next_dim = dims[0], dims[1]
    curr_mod, next_mod = mods[0], mods[1]
    in_dim = curr_dim if in_dim is None else in_dim
    level.up1 = nn.Sequential(
        *[block(in_dim if i == 0 else curr_dim, curr_dim) for i in range(curr_mod)])
    level.low1 = nn.Sequential(
        block(in_dim, next_dim, stride=2),
        *[block(next_dim, next_dim) for _ in range(1, curr_mod)],
    )
    level.low2 = inner() if n > 1 else nn.Sequential(
        *[block(next_dim, next_dim) for _ in range(next_mod)])
    level.low3 = nn.Sequential(
        *[block(next_dim, next_dim) for _ in range(curr_mod - 1)],
        block(next_dim, curr_dim),
    )


class FireHourglass(nn.Module):
    """One recursive fire-module hourglass level."""

    def __init__(self, n: int, dims: Sequence[int], mods: Sequence[int],
                 in_dim: Optional[int] = None):
        super().__init__()
        _build_level(self, FireModule, n, dims, mods, in_dim,
                     lambda: FireHourglass(n - 1, dims[1:], mods[1:]))
        self.up2 = ConvTranspose2d(dims[0], dims[0], 4, stride=2, padding=1)

    def forward(self, x):
        return self.up1(x) + self.up2(self.low3(self.low2(self.low1(x))))


def upsample_nearest2(x):
    """Nearest x2: output pixel o takes input pixel o // 2 on both axes."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class ResidualHourglass(nn.Module):
    """One recursive residual hourglass level (stride-2 residual down,
    nearest x2 up). With ``collect_ups`` the forward also returns each
    level's merge output, deepest first, for the saccade attention heads."""

    def __init__(self, n: int, dims: Sequence[int], mods: Sequence[int],
                 in_dim: Optional[int] = None, collect_ups: bool = False):
        super().__init__()
        self.collect_ups = collect_ups
        _build_level(self, Residual, n, dims, mods, in_dim,
                     lambda: ResidualHourglass(n - 1, dims[1:], mods[1:], collect_ups=collect_ups))

    def forward(self, x):
        low2 = self.low2(self.low1(x))
        ups = []
        if self.collect_ups and isinstance(self.low2, ResidualHourglass):
            low2, ups = low2
        merged = self.up1(x) + upsample_nearest2(self.low3(low2))
        return (merged, ups + [merged]) if self.collect_ups else merged


class HourglassStack(nn.Module):
    """Stem (conv 7x7/s2, then ``stem_residuals`` stride-2 residuals) +
    ``stacks`` hourglasses (``hourglass`` "fire" or "residual") with 1x1+BN
    inter-stack fusion. Returns the per-stack ``cnv_dim`` feature maps and,
    with ``collect_ups``, each stack's per-level merge outputs."""

    def __init__(self, stacks: int = 2, levels: int = 4,
                 dims: Sequence[int] = (256, 256, 384, 384, 512),
                 mods: Sequence[int] = (2, 2, 2, 2, 4),
                 stem_features: Sequence[int] = (128, 256), cnv_dim: int = 256,
                 stem_residuals: int = 2, hourglass: str = "fire", collect_ups: bool = False):
        super().__init__()
        if hourglass not in HOURGLASS:
            raise ValueError(f"hourglass must be one of {HOURGLASS}, got {hourglass!r}")
        if collect_ups and hourglass != "residual":
            raise ValueError("collect_ups needs the residual hourglass")
        self.stacks, self.levels, self.mods = stacks, levels, tuple(mods)
        self.collect_ups = collect_ups
        s0, s1 = stem_features
        self.pre = nn.ModuleList([
            StemConvBlock(s0),
            *[Residual(s0 if i == 0 else s1, s1, stride=2) for i in range(stem_residuals)],
        ])

        def level(in_dim):
            if hourglass == "fire":
                return FireHourglass(levels, dims, mods, in_dim=in_dim)
            return ResidualHourglass(levels, dims, mods, in_dim=in_dim, collect_ups=collect_ups)

        # the first stack reads the stem, every later one the fused features
        widths = [s1] + [cnv_dim] * (stacks - 1)
        self.hgs = nn.ModuleList([level(w) for w in widths])
        self.cnvs = nn.ModuleList([ConvBlock(dims[0], cnv_dim, 3) for _ in range(stacks)])
        self.inters = nn.ModuleList([Residual(cnv_dim, cnv_dim) for _ in range(stacks - 1)])
        self.inters_ = nn.ModuleList([MergeBN(w, cnv_dim) for w in widths[:-1]])
        self.cnvs_ = nn.ModuleList([MergeBN(cnv_dim, cnv_dim) for _ in range(stacks - 1)])

    def forward(self, x, stem=stem_conv):
        inter = self.pre[0](x, stem)
        for res in self.pre[1:]:
            inter = res(inter)
        outs, ups = [], []
        for s in range(self.stacks):
            hg = self.hgs[s](inter)
            if self.collect_ups:
                hg, stack_ups = hg
                ups.append(stack_ups)
            cnv = self.cnvs[s](hg)
            outs.append(cnv)
            if s < self.stacks - 1:
                fused = torch.relu(self.inters_[s](inter) + self.cnvs_[s](cnv))
                inter = self.inters[s](fused)
        return (outs, ups) if self.collect_ups else outs
