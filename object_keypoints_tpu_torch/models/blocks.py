"""Building blocks: conv-bn-relu, residual, fire module, 1x1 merge.

PyTorch counterparts of ``object_keypoints_tpu/models/blocks.py``. Modules
take and return NCHW tensors; their attribute names follow the reference
torch state_dict (``conv``/``bn``, ``conv1``/``bn1``/``conv2``/``bn2``/
``skip``, ``conv_1x1``/``conv_3x3``), so
``object_keypoints_tpu.serving.torch_import`` reads a port state_dict as it
is. BatchNorm eps is 1e-5 and torch momentum 0.1 (flax momentum 0.9).
Weights start from torch's Conv2d default, kaiming_uniform(a=sqrt(5)), the
JAX package's ``torch_conv_kernel_init``.
"""

from __future__ import annotations

import torch
from torch import nn

from object_keypoints_tpu_torch.ops.stem_conv import fold_bn, stem_conv


def _bn(dim: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(dim, eps=1e-5, momentum=0.1)


class ConvBlock(nn.Module):
    """conv(k) + BN + ReLU (the vendored ``convolution``)."""

    def __init__(self, in_dim: int, out_dim: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        pad = (kernel - 1) // 2
        self.conv = nn.Conv2d(in_dim, out_dim, kernel, stride=stride, padding=pad, bias=False)
        self.bn = _bn(out_dim)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class StemConvBlock(ConvBlock):
    """The 7x7/s2 3-channel ConvBlock that opens the backbone. In eval mode
    it folds its BatchNorm and runs ``stem`` (by default the CUDA stem
    kernel's wrapper ``stem_conv``); in train mode it is a plain ConvBlock."""

    def __init__(self, out_dim: int):
        super().__init__(3, out_dim, kernel=7, stride=2)

    def forward(self, x, stem=stem_conv):
        if self.training:
            return super().forward(x)
        bn = self.bn
        scale, bias = fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
        return stem(x, self.conv.weight, scale, bias)


class Residual(nn.Module):
    """conv-bn-relu + conv-bn with a projection skip where the stride or the
    width changes (the vendored ``residual``)."""

    def __init__(self, in_dim: int, out_dim: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        pad = (kernel - 1) // 2
        self.conv1 = nn.Conv2d(in_dim, out_dim, kernel, stride=stride, padding=pad, bias=False)
        self.bn1 = _bn(out_dim)
        self.conv2 = nn.Conv2d(out_dim, out_dim, kernel, padding=pad, bias=False)
        self.bn2 = _bn(out_dim)
        if stride != 1 or in_dim != out_dim:
            self.skip = nn.Sequential(
                nn.Conv2d(in_dim, out_dim, 1, stride=stride, bias=False), _bn(out_dim)
            )
        else:
            self.skip = nn.Identity()

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + self.skip(x))


class FireModule(nn.Module):
    """Squeeze 1x1 + BN, then concat[1x1, depthwise 3x3] + BN, identity skip
    when stride is 1 and the widths match, ReLU (CornerNet-Squeeze's fire)."""

    def __init__(self, in_dim: int, out_dim: int, sr: int = 2, stride: int = 1):
        super().__init__()
        squeezed = out_dim // sr
        self.conv1 = nn.Conv2d(in_dim, squeezed, 1, bias=False)
        self.bn1 = _bn(squeezed)
        self.conv_1x1 = nn.Conv2d(squeezed, out_dim // 2, 1, stride=stride, bias=False)
        self.conv_3x3 = nn.Conv2d(squeezed, out_dim // 2, 3, stride=stride, padding=1,
                                  groups=squeezed, bias=False)
        self.bn2 = _bn(out_dim)
        self.skip = stride == 1 and in_dim == out_dim

    def forward(self, x):
        y = self.bn1(self.conv1(x))
        y = self.bn2(torch.cat((self.conv_1x1(y), self.conv_3x3(y)), dim=1))
        return torch.relu(y + x) if self.skip else torch.relu(y)


class MergeBN(nn.Sequential):
    """1x1 conv (no bias) + BN, the inter-stack merge; state_dict keys
    ``0.weight`` and ``1.*`` as in the reference."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__(nn.Conv2d(in_dim, out_dim, 1, bias=False), _bn(out_dim))
