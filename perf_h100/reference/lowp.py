"""Lower precisions as transforms of the reference's convolutions
(``reference.layers.set_quant``: each returns the operands and an output
transform), and TF32 off.

- ``int_codes(bits, s_act)``: the int8 serve route's arithmetic (or a
  narrower one, the int8 route's control): the activation by the calibrated
  max-abs ``s_act`` of the convolution's input, the weight by one max-abs a
  output channel, codes clipped to +-(2^(bits-1) - 1), rounding half to even;
- ``fp8``: float8 arithmetic, the precision below bfloat16, as fp8 training
  runs it: both operands and the output (the bias added) rounded to e4m3,
  and in a backward the gradient arriving at each of them rounded to e5m2;
  each tensor by one max-abs scale into the format's range;
- ``fp8_forward``: the forward's operands and outputs in e4m3 as ``fp8``
  rounds them, the gradients passed through unrounded (a step whose
  forward convolutions run in fp8 and whose backward stays as it was).
"""

from __future__ import annotations

import contextlib

import torch

from reference.layers import set_quant  # noqa: F401

FORMATS = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2, 57344.0)}


def _other_axes(w, out_axis):
    return tuple(d for d in range(w.dim()) if d != out_axis)


def int_codes(bits, s_act):
    top = float(2 ** (bits - 1) - 1)

    def quant(x, w, out_axis):
        sx = s_act / top
        sw = w.abs().amax(dim=_other_axes(w, out_axis), keepdim=True).clamp(min=1e-12) / top
        return (torch.round(x / sx).clamp(-top, top) * sx,
                torch.round(w / sw).clamp(-top, top) * sw, None)

    return quant


def round_fp8(t, fmt="e4m3"):
    """``t`` rounded to an fp8 format, scaled by its max-abs into range."""
    dtype, top = FORMATS[fmt]
    s = (t.abs().amax().clamp(min=1e-30) / top).to(t.dtype)
    return (t / s).to(dtype).to(t.dtype) * s


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return round_fp8(t, "e4m3")

    @staticmethod
    def backward(ctx, grad):
        return round_fp8(grad, "e5m2")


def _fp8(t):
    return _FP8.apply(t)


def fp8(x, w, out_axis):
    return _fp8(x), _fp8(w), _fp8


class _FP8Forward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return round_fp8(t, "e4m3")

    @staticmethod
    def backward(ctx, grad):
        return grad


def _fp8_forward(t):
    return _FP8Forward.apply(t)


def fp8_forward(x, w, out_axis):
    return _fp8_forward(x), _fp8_forward(w), _fp8_forward


@contextlib.contextmanager
def no_tf32():
    cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul
