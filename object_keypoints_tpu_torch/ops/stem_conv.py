"""Stem convolution: 7x7/s2 conv 3 -> C + folded BatchNorm + ReLU.

Counterpart of ``object_keypoints_tpu/ops/pallas/stem_conv.py``. The kernels
are in ``csrc/stem_conv.cu`` (its source note gives their design and what
bounds them); this module holds their wrapper, the plain PyTorch version,
the space-to-depth tap matrix and the BN fold.

``stem_conv`` runs the plain version on a CPU tensor and a CUDA kernel on a
CUDA tensor: bf16 frames go to the tensor-core kernel
(``okt_stem_conv_bf16``), fp32 frames to the CUDA-core kernel
(``okt_stem_conv_fp32``); on anything the kernels do not take it raises.
Both return an (N, C, Ho, Wo) tensor in channels_last memory format,
Ho = (H - 1)//2 + 1. On the card it is differentiable, as the JAX
eval-mode forward is: the TPU kernel has no backward of its own, so the
backward recomputes the plain version under autograd and differentiates
that (``StemConvKernel``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from object_keypoints_tpu_torch.ops import _build
from object_keypoints_tpu_torch.utils import timer

MAX_C_OUT = 128
K_TAPS = 192  # 4 x 4 unit-stride taps x 12 space-to-depth channels


def fold_bn(weight, bias, running_mean, running_var, eps: float = 1e-5):
    """Eval-mode BatchNorm as an affine map, in fp32:
    ``scale = weight / sqrt(var + eps)``, ``bias = bias - mean * scale``."""
    scale = weight.float() / torch.sqrt(running_var.float() + eps)
    return scale, bias.float() - running_mean.float() * scale


def stem_taps(w, width: int | None = None):
    """(C, 3, 7, 7) conv weights -> the (192, width) tap matrix of the
    space-to-depth form, in ``w``'s dtype; columns past C (``width``
    defaults to C) are zero.

    With s2d cell (i, j) holding frame pixels (2i + p, 2j + q, c) in (p, q, c)
    order, ``out(y, x) = sum_{u, v in -2..1} s2d(y + u, x + v) . T[u, v]``;
    row ``(u + 2) * 48 + (v + 2) * 12 + (2p + q) * 3 + c`` holds
    ``w[:, c, 2u + p + 3, 2v + q + 3]``, zero where that index is -1. It is
    the JAX package's ``rearrange_stem_kernel`` grouped by the row shift u
    instead of the column shift v."""
    width = w.shape[0] if width is None else width
    # (width, 3, 8, 8): spatial index 2(u + 2) + p = dy + 1
    wp = F.pad(w, (1, 0, 1, 0, 0, 0, 0, width - w.shape[0]))
    return wp.reshape(width, 3, 4, 2, 4, 2).permute(2, 4, 3, 5, 1, 0).reshape(K_TAPS, width)


def bf16_taps(w):
    """The bf16 kernel's (192, 128) tap matrix of ``w``. The eval-mode
    weights stay put from one batch to the next, so it is built once and
    kept on ``w`` until ``w`` changes: another storage, dtype or shape, or an
    in-place write (its version counter). An inference tensor has no version
    counter, so its taps are built on every call. A build counts in
    ``weights.built`` (``utils.timer``)."""
    def build():
        timer.count("weights.built")
        with torch.no_grad():
            return stem_taps(w.to(torch.bfloat16), MAX_C_OUT).contiguous()

    if w.is_inference():
        return build()
    key = (w.data_ptr(), w._version, w.dtype, tuple(w.shape))
    cached = getattr(w, "_stem_taps", None)
    if cached is None or cached[0] != key:
        cached = w._stem_taps = (key, build())
    return cached[1]


def stem_conv_plain(frames, w, scale, bias):
    """The kernels' plain version, ``stem_conv_reference``'s arithmetic with
    the taps rounded to the frames' dtype (as ``stem_conv_pallas_from_frame``
    rounds them): conv, affine and ReLU in fp32, one rounding to the frames'
    dtype at the end."""
    y = F.conv2d(frames.float(), w.to(frames.dtype).float(), stride=2, padding=3)
    y = torch.relu(y * scale[:, None, None] + bias[:, None, None])
    return y.to(frames.dtype).contiguous(memory_format=torch.channels_last)


class StemConvKernel(torch.autograd.Function):
    """The CUDA kernel as an autograd op. Forward: one launch. Backward:
    the plain version recomputed under autograd (cuDNN's conv backward,
    then the affine and the ReLU), which gives ``frames``, ``w``, ``scale``
    and ``bias`` their gradients; ``fold_bn`` stays outside, so BatchNorm's
    weight and bias get theirs through it."""

    @staticmethod
    def forward(ctx, frames, w, scale, bias):
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(frames, w, scale, bias)
        return _launch(frames, w, scale, bias)

    @staticmethod
    def backward(ctx, grad):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            out = stem_conv_plain(*inputs)
        grads = iter(torch.autograd.grad(out, [t for t in inputs if t.requires_grad], grad))
        return tuple(next(grads) if need else None for need in ctx.needs_input_grad)


def stem_conv(frames, w, scale, bias):
    """frames (N, 3, H, W) contiguous fp32/bf16, w (C, 3, 7, 7), scale and
    bias (C,) fp32 -> relu(conv(frames, w) * scale + bias), channels_last.
    C is a multiple of 4 (fp32) or 8 (bf16), at most 128."""
    if frames.device.type == "cpu":
        return stem_conv_plain(frames, w, scale, bias)
    if frames.device.type != "cuda":
        raise ValueError(f"stem_conv: no kernel for device {frames.device}")
    if frames.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"stem_conv: frames must be float32 or bfloat16, got {frames.dtype}")
    if frames.dim() != 4 or frames.shape[1] != 3 or not frames.is_contiguous():
        raise ValueError(
            f"stem_conv: frames must be contiguous (N, 3, H, W), got "
            f"{tuple(frames.shape)} with strides {frames.stride()}"
        )
    multiple = 8 if frames.dtype == torch.bfloat16 else 4
    c_out = w.shape[0]
    if tuple(w.shape) != (c_out, 3, 7, 7) or c_out % multiple or not 0 < c_out <= MAX_C_OUT:
        raise ValueError(f"stem_conv: w must be (C, 3, 7, 7) with C % {multiple} == 0 for "
                         f"{frames.dtype} frames, C <= {MAX_C_OUT}; got {tuple(w.shape)}")
    for name, t in (("w", w), ("scale", scale), ("bias", bias)):
        if t.device != frames.device:
            raise ValueError(f"stem_conv: {name} on {t.device}, frames on {frames.device}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (c_out,) or not t.is_contiguous():
            raise ValueError(f"stem_conv: {name} must be contiguous fp32 ({c_out},)")
    return StemConvKernel.apply(frames, w, scale, bias)


def _launch(frames, w, scale, bias):
    """One launch of the kernel for ``frames``' dtype on checked inputs."""
    bf16 = frames.dtype == torch.bfloat16
    c_out = w.shape[0]
    n, _, h, wd = frames.shape
    if bf16:
        taps = bf16_taps(w)
    else:
        taps = w.float().permute(1, 2, 3, 0).contiguous()  # (3, 7, 7, C) = (147, C)
    out = torch.empty((n, c_out, (h - 1) // 2 + 1, (wd - 1) // 2 + 1),
                      device=frames.device, dtype=frames.dtype,
                      memory_format=torch.channels_last)
    lib = _build.load_library()
    launch = lib.okt_stem_conv_bf16 if bf16 else lib.okt_stem_conv_fp32
    with torch.cuda.device(frames.device):
        err = launch(frames.data_ptr(), taps.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                     out.data_ptr(), n, h, wd, c_out,
                     torch.cuda.current_stream(frames.device).cuda_stream)
    if err:
        raise RuntimeError(f"stem_conv kernel launch failed: cudaError {err}")
    stem_conv.launches += 1
    if bf16:
        stem_conv.launches_bf16 += 1
    else:
        stem_conv.launches_fp32 += 1
    return out


# launches on CUDA tensors: all, and per kernel
stem_conv.launches = 0
stem_conv.launches_bf16 = 0
stem_conv.launches_fp32 = 0
