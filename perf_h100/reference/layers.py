"""Plain PyTorch layers of the hourglass models, for the benchmark's reference.

A frozen restatement of the published blocks (CornerNet-Lite's
``convolution``, ``residual``, ``fire_module``, the fire and residual
hourglass, the inter-stack merge), written with ``torch.nn`` alone. The
attribute names are those of the reference PyTorch state_dict, which the
program under test keeps too, so one seeded state_dict loads into both.
It imports nothing of the program.

Arithmetic: float32 or float64, whatever the parameters and input are.
BatchNorm is ``nn.BatchNorm2d`` (eps 1e-5): eval mode normalizes by the
running statistics, train mode by the batch's biased variance. Every
convolution is a ``Conv2d`` or ``ConvTranspose2d`` below, whose operands
pass through ``quant`` where one is set (``set_quant``): ``quant(x, w,
out_axis)`` returns the operands to use and a transform of the output (or
None), so that the benchmark's controls compute the same network in a lower
precision.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    quant: Optional[Callable] = None

    def forward(self, x):
        w, out = self.weight, None
        if self.quant is not None:
            x, w, out = self.quant(x, w, 0)
        y = F.conv2d(x, w, self.bias, self.stride, self.padding, self.dilation, self.groups)
        return y if out is None else out(y)


class ConvTranspose2d(nn.ConvTranspose2d):
    quant: Optional[Callable] = None

    def forward(self, x):
        w, out = self.weight, None
        if self.quant is not None:
            x, w, out = self.quant(x, w, 1)
        y = F.conv_transpose2d(x, w, self.bias, self.stride, self.padding,
                               self.output_padding, self.groups, self.dilation)
        return y if out is None else out(y)


def set_quant(model: nn.Module, quant: Optional[Callable]) -> nn.Module:
    """Give every convolution of ``model`` the operand transform ``quant(x,
    w, out_axis)`` (None: plain arithmetic)."""
    for m in model.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d)):
            m.quant = quant
    return model


def BatchNorm2d(dim):
    return nn.BatchNorm2d(dim, eps=1e-5)


class ConvBlock(nn.Module):
    """conv(k) + BN + ReLU; without BN the conv has a bias."""

    def __init__(self, in_dim, out_dim, kernel=3, stride=1, with_bn=True):
        super().__init__()
        pad = (kernel - 1) // 2
        self.conv = Conv2d(in_dim, out_dim, kernel, stride=stride, padding=pad, bias=not with_bn)
        self.bn = BatchNorm2d(out_dim) if with_bn else None

    def forward(self, x):
        y = self.conv(x)
        return torch.relu(y if self.bn is None else self.bn(y))


class Residual(nn.Module):
    def __init__(self, in_dim, out_dim, kernel=3, stride=1):
        super().__init__()
        pad = (kernel - 1) // 2
        self.conv1 = Conv2d(in_dim, out_dim, kernel, stride=stride, padding=pad, bias=False)
        self.bn1 = BatchNorm2d(out_dim)
        self.conv2 = Conv2d(out_dim, out_dim, kernel, padding=pad, bias=False)
        self.bn2 = BatchNorm2d(out_dim)
        if stride != 1 or in_dim != out_dim:
            self.skip = nn.Sequential(Conv2d(in_dim, out_dim, 1, stride=stride, bias=False),
                                      BatchNorm2d(out_dim))
        else:
            self.skip = nn.Identity()

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + self.skip(x))


class FireModule(nn.Module):
    """squeeze 1x1 + BN; concat(1x1, depthwise 3x3) + BN; identity skip when
    the stride is 1 and the widths match; ReLU."""

    def __init__(self, in_dim, out_dim, sr=2, stride=1):
        super().__init__()
        squeezed = out_dim // sr
        self.conv1 = Conv2d(in_dim, squeezed, 1, bias=False)
        self.bn1 = BatchNorm2d(squeezed)
        self.conv_1x1 = Conv2d(squeezed, out_dim // 2, 1, stride=stride, bias=False)
        self.conv_3x3 = Conv2d(squeezed, out_dim // 2, 3, stride=stride, padding=1,
                               groups=squeezed, bias=False)
        self.bn2 = BatchNorm2d(out_dim)
        self.skip = stride == 1 and in_dim == out_dim

    def forward(self, x):
        y = self.bn1(self.conv1(x))
        y = self.bn2(torch.cat((self.conv_1x1(y), self.conv_3x3(y)), dim=1))
        return torch.relu(y + x) if self.skip else torch.relu(y)


class MergeBN(nn.Sequential):
    def __init__(self, in_dim, out_dim):
        super().__init__(Conv2d(in_dim, out_dim, 1, bias=False), BatchNorm2d(out_dim))


def _level(level, block, n, dims, mods, in_dim, inner):
    curr_dim, next_dim = dims[0], dims[1]
    curr_mod, next_mod = mods[0], mods[1]
    in_dim = curr_dim if in_dim is None else in_dim
    level.up1 = nn.Sequential(*[block(in_dim if i == 0 else curr_dim, curr_dim)
                                for i in range(curr_mod)])
    level.low1 = nn.Sequential(block(in_dim, next_dim, stride=2),
                               *[block(next_dim, next_dim) for _ in range(1, curr_mod)])
    level.low2 = inner() if n > 1 else nn.Sequential(
        *[block(next_dim, next_dim) for _ in range(next_mod)])
    level.low3 = nn.Sequential(*[block(next_dim, next_dim) for _ in range(curr_mod - 1)],
                               block(next_dim, curr_dim))


class FireHourglass(nn.Module):
    """A fire-module hourglass level; unpools with ConvTranspose2d(4, 2, 1)."""

    def __init__(self, n, dims, mods, in_dim=None):
        super().__init__()
        _level(self, FireModule, n, dims, mods, in_dim,
               lambda: FireHourglass(n - 1, dims[1:], mods[1:]))
        self.up2 = ConvTranspose2d(dims[0], dims[0], 4, stride=2, padding=1)

    def forward(self, x):
        return self.up1(x) + self.up2(self.low3(self.low2(self.low1(x))))


class HourglassStack(nn.Module):
    """Stem (7x7/s2 conv-bn-relu, then stride-2 residuals), ``stacks`` fire
    hourglasses, 1x1 + BN inter-stack merges; returns each stack's features."""

    def __init__(self, stacks=2, levels=4, dims: Sequence[int] = (256, 256, 384, 384, 512),
                 mods: Sequence[int] = (2, 2, 2, 2, 4), stem_features=(128, 256), cnv_dim=256,
                 stem_residuals=2):
        super().__init__()
        self.stacks = stacks
        s0, s1 = stem_features
        self.pre = nn.ModuleList([ConvBlock(3, s0, 7, stride=2),
                                  *[Residual(s0 if i == 0 else s1, s1, stride=2)
                                    for i in range(stem_residuals)]])
        widths = [s1] + [cnv_dim] * (stacks - 1)
        self.hgs = nn.ModuleList([FireHourglass(levels, dims, mods, in_dim=w) for w in widths])
        self.cnvs = nn.ModuleList([ConvBlock(dims[0], cnv_dim, 3) for _ in range(stacks)])
        self.inters = nn.ModuleList([Residual(cnv_dim, cnv_dim) for _ in range(stacks - 1)])
        self.inters_ = nn.ModuleList([MergeBN(w, cnv_dim) for w in widths[:-1]])
        self.cnvs_ = nn.ModuleList([MergeBN(cnv_dim, cnv_dim) for _ in range(stacks - 1)])

    def forward(self, x):
        inter = x
        for layer in self.pre:
            inter = layer(inter)
        outs = []
        for s in range(self.stacks):
            cnv = self.cnvs[s](self.hgs[s](inter))
            outs.append(cnv)
            if s < self.stacks - 1:
                inter = self.inters[s](torch.relu(self.inters_[s](inter) + self.cnvs_[s](cnv)))
        return outs
