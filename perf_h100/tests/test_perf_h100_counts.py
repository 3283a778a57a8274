"""The operation and byte counts against hand counts at small shapes."""

import torch
from torch import nn

from harness import flops
from reference.layers import Conv2d, ConvTranspose2d


def test_conv_flops_hand_count():
    model = nn.Sequential(Conv2d(3, 4, 3, padding=1, bias=False),  # 2*(1*4*8*8)*3*9
                          Conv2d(4, 4, 3, padding=1, groups=4),  # 2*(4*8*8)*1*9
                          ConvTranspose2d(4, 2, 4, stride=2, padding=1))  # 2*(4*8*8)*2*16
    got = flops.conv_flops(model, (1, 3, 8, 8))
    assert got == 2 * 256 * 27 + 2 * 256 * 9 + 2 * 256 * 32


def test_conv_flops_scales_with_batch():
    model = nn.Sequential(Conv2d(3, 8, 7, stride=2, padding=3))
    one = flops.conv_flops(model, (1, 3, 511, 511))
    assert one == 2 * 8 * 256 * 256 * 147
    assert flops.conv_flops(model, (5, 3, 511, 511)) == 5 * one


def test_stem_bound_hand_count():
    seconds, moved, f = flops.stem_bound_s(96, 511, 511)
    out = 96 * 256 * 256 * 128
    assert f == 2 * out * 147
    assert moved == 96 * 3 * 511 * 511 * 2 + out * 2 + 192 * 128 * 2 + 1024
    assert seconds == max(moved / 3.35e12, f / 989e12)
    assert abs(seconds * 1e3 - 0.5257) < 1e-3  # the bound PERF.md gives for the serve batch
