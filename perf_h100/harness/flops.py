"""Operations and bytes counted from shapes, and the table of peaks.

Convolution FLOPs come from the plain reference's module tree run on the
meta device (shapes only, no arithmetic): a convolution producing Y output
elements from C_in / groups input channels and a kh x kw kernel does
2 Y (C_in / groups) kh kw FLOPs; a transposed one does 2 X (C_out / groups)
kh kw for X input elements. The rest of a step (BatchNorm, activations,
the decode, the loss) is left out: it is a small share of the FLOPs.
"""

from __future__ import annotations

import torch
from torch import nn

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit)
PEAK = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12, "tf32": 495e12}
HBM_BYTES_PER_S = 3.35e12


def conv_flops(model: nn.Module, input_shape, call=None) -> int:
    """FLOPs of every convolution in one forward of ``model`` (moved to the
    meta device) on an input of ``input_shape``; ``call(model, x)`` runs the
    forward (default ``model(x)``)."""
    total = [0]

    def hook(m, inputs, out):
        k = m.weight[0, 0].numel()
        if m.transposed:
            total[0] += 2 * inputs[0].numel() * (m.out_channels // m.groups) * k
        else:
            total[0] += 2 * out.numel() * (m.in_channels // m.groups) * k

    model = model.to("meta")
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, nn.modules.conv._ConvNd)]
    try:
        with torch.no_grad():
            x = torch.empty(input_shape, device="meta")
            (call or (lambda m, t: m(t)))(model, x)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def stem_bound_s(n, h, w, c_out=128, itemsize=2, peak="bf16"):
    """Least seconds for the 7x7/s2 3-channel stem (conv + folded BN + ReLU)
    on (n, 3, h, w): frames read once, the space-to-depth tap matrix (192 x
    c_out), scale and bias read once, the output written once, at the HBM
    rate; against 2 x 147 FLOPs an output element at the peak. Returns
    (seconds, bytes, flops)."""
    out = n * ((h - 1) // 2 + 1) * ((w - 1) // 2 + 1) * c_out
    moved = n * 3 * h * w * itemsize + out * itemsize + 192 * c_out * itemsize + 2 * 4 * c_out
    flops = 2 * out * 147
    return max(moved / HBM_BYTES_PER_S, flops / PEAK[peak]), moved, flops
