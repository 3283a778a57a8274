"""Stem convolution: 7x7/s2 conv 3 -> C + folded BatchNorm + ReLU.

Counterpart of ``object_keypoints_tpu/ops/pallas/stem_conv.py``. The kernel
is ``csrc/stem_conv.cu`` (its source note gives the design and what bounds
it); this module holds its wrapper, its plain PyTorch version and the BN
fold.

``stem_conv`` runs the plain version on a CPU tensor and the CUDA kernel on
a CUDA tensor; on anything the kernel does not take it raises. Both return
an (N, C, Ho, Wo) tensor in channels_last memory format, Ho = (H - 1)//2 + 1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from object_keypoints_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_C_OUT = 128


def fold_bn(weight, bias, running_mean, running_var, eps: float = 1e-5):
    """Eval-mode BatchNorm as an affine map, in fp32:
    ``scale = weight / sqrt(var + eps)``, ``bias = bias - mean * scale``."""
    scale = weight.float() / torch.sqrt(running_var.float() + eps)
    return scale, bias.float() - running_mean.float() * scale


def stem_conv_plain(frames, w, scale, bias):
    """The kernel's plain version, ``stem_conv_reference``'s arithmetic: conv,
    affine and ReLU in fp32, one rounding to the frames' dtype at the end."""
    y = F.conv2d(frames.float(), w.float(), stride=2, padding=3)
    y = torch.relu(y * scale[:, None, None] + bias[:, None, None])
    return y.to(frames.dtype).contiguous(memory_format=torch.channels_last)


def stem_conv(frames, w, scale, bias):
    """frames (N, 3, H, W) contiguous fp32/bf16, w (C, 3, 7, 7), scale and
    bias (C,) fp32 -> relu(conv(frames, w) * scale + bias), channels_last."""
    if frames.device.type == "cpu":
        return stem_conv_plain(frames, w, scale, bias)
    if frames.device.type != "cuda":
        raise ValueError(f"stem_conv: no kernel for device {frames.device}")
    if frames.dtype not in _DTYPE_CODES:
        raise TypeError(f"stem_conv: frames must be float32 or bfloat16, got {frames.dtype}")
    if frames.dim() != 4 or frames.shape[1] != 3 or not frames.is_contiguous():
        raise ValueError(
            f"stem_conv: frames must be contiguous (N, 3, H, W), got "
            f"{tuple(frames.shape)} with strides {frames.stride()}"
        )
    c_out = w.shape[0]
    if tuple(w.shape) != (c_out, 3, 7, 7) or c_out % 4 or not 0 < c_out <= MAX_C_OUT:
        raise ValueError(f"stem_conv: w must be (C, 3, 7, 7) with C % 4 == 0, "
                         f"C <= {MAX_C_OUT}; got {tuple(w.shape)}")
    for name, t in (("w", w), ("scale", scale), ("bias", bias)):
        if t.device != frames.device:
            raise ValueError(f"stem_conv: {name} on {t.device}, frames on {frames.device}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (c_out,) or not t.is_contiguous():
            raise ValueError(f"stem_conv: {name} must be contiguous fp32 ({c_out},)")

    n, _, h, wd = frames.shape
    taps = w.float().permute(1, 2, 3, 0).contiguous()  # (3, 7, 7, C) = (147, C)
    out = torch.empty((n, c_out, (h - 1) // 2 + 1, (wd - 1) // 2 + 1),
                      device=frames.device, dtype=frames.dtype,
                      memory_format=torch.channels_last)
    with torch.cuda.device(frames.device):
        err = _build.load_library().okt_stem_conv(
            frames.data_ptr(), taps.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), n, h, wd, c_out, _DTYPE_CODES[frames.dtype],
            torch.cuda.current_stream(frames.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"stem_conv kernel launch failed: cudaError {err}")
    stem_conv.launches += 1
    return out


stem_conv.launches = 0
