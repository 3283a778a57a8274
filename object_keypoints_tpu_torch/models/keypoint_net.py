"""KeypointNet: hourglass backbone + heatmap / depth / center-offset heads.

Counterpart of ``object_keypoints_tpu/models/keypoint_net.py``. Heads are
3-conv prediction modules, one per hourglass stack, under the reference
names ``{heatmap,depth,center}_head.output_head{s+1}.{0,1,2}``. Dropout on
the stack features is flax's, drawn from the ``torch.Generator`` that the
forward is given (torch's default one when none), and identity in eval
mode.

Layouts: the public functions take and return NCHW tensors. Inside, the
forward runs in whatever memory format its input has; the stem returns
channels_last, so from the stem on the serve forward runs channels_last
(``serving.export.make_inference_fn`` also converts the weights). Outputs
per stack: heatmap logits (N, K, H, W), depth (N, K, H, W) and centers
(N, T, 2, H, W), T = K - 1: the center head's (N, 2T, H, W) output in the
channel order of the JAX package's NHWC (..., T, 2).

Initialisation mirrors the JAX package: conv kernels from
U(+-1/sqrt(fan_in)), zero biases, and the reference quirk of a heatmap
output bias of 0.01/0.99 (the odds, not the log-odds). It draws from the
``torch.Generator`` given, so a seed fixes the weights.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from object_keypoints_tpu_torch.models.blocks import Conv2d, ConvBlock, reset_like_jax
from object_keypoints_tpu_torch.models.hourglass import HourglassStack
from object_keypoints_tpu_torch.ops.stem_conv import stem_conv

HEATMAP_BIAS = 0.01 / 0.99  # perception/models.py:25-26 quirk


class PredictionModule(nn.Sequential):
    """1x1 conv-bn-relu -> features, 1x1 conv-bn-relu -> 32, 1x1 conv with
    bias -> out."""

    def __init__(self, in_dim: int, features: int, out: int, bias_init_value: float = 0.0):
        super().__init__(
            ConvBlock(in_dim, features, 1),
            ConvBlock(features, 32, 1),
            Conv2d(32, out, 1, bias=True),
        )
        self.bias_init_value = bias_init_value


def dropout(x, rate: float, generator: Optional[torch.Generator] = None):
    """flax's Dropout: keep each element with probability 1 - ``rate``
    (uniform draws from ``generator`` below it) and scale it by
    1 / (1 - rate); the rest become 0."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    draws = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(draws < keep, x / keep, 0.0)


class KeypointNetOutputs(NamedTuple):
    """Per-stack head outputs (tuples ordered stack0, stack1, ...), NCHW."""

    heatmaps: Tuple[torch.Tensor, ...]  # each (N, K, H, W) logits
    depth: Tuple[torch.Tensor, ...]  # each (N, K, H, W)
    centers: Tuple[torch.Tensor, ...]  # each (N, K-1, 2, H, W)


class KeypointNet(nn.Module):
    """Hourglass + 3 heads per stack."""

    def __init__(self, heatmaps_out: int = 2, features: int = 128, dropout: float = 0.1,
                 stacks: int = 2, levels: int = 4,
                 dims: Sequence[int] = (256, 256, 384, 384, 512),
                 mods: Sequence[int] = (2, 2, 2, 2, 4),
                 stem_features: Sequence[int] = (128, 256), cnv_dim: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not stem_features[1] == dims[0] == cnv_dim:
            raise ValueError(
                "the hourglass input width dims[0] must equal stem_features[1] and "
                f"cnv_dim, got {dims[0]}, {stem_features[1]}, {cnv_dim}"
            )
        self.heatmaps_out = heatmaps_out
        self.backbone = HourglassStack(stacks, levels, dims, mods, stem_features, cnv_dim)
        self.dropout_rate = dropout
        T = heatmaps_out - 1
        for head, out, bias in (("heatmap", heatmaps_out, HEATMAP_BIAS),
                                ("depth", heatmaps_out, 0.0),
                                ("center", 2 * T, 0.0)):
            setattr(self, f"{head}_head", nn.ModuleDict({
                f"output_head{s + 1}": PredictionModule(cnv_dim, features, out, bias)
                for s in range(stacks)
            }))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """JAX-package init (``blocks.reset_like_jax``), then the prediction
        heads' output bias constant."""
        reset_like_jax(self, generator)
        for m in self.modules():
            if isinstance(m, PredictionModule):
                m[2].bias.fill_(m.bias_init_value)

    def forward(self, x, stem=stem_conv,
                generator: Optional[torch.Generator] = None) -> KeypointNetOutputs:
        feats = self.backbone(x, stem)
        if self.training:
            feats = [dropout(f, self.dropout_rate, generator) for f in feats]
        heat, depth, centers = [], [], []
        for s, f in enumerate(feats):
            key = f"output_head{s + 1}"
            heat.append(self.heatmap_head[key](f))
            depth.append(self.depth_head[key](f))
            c = self.center_head[key](f)
            n, _, h, w = c.shape
            centers.append(c.reshape(n, self.heatmaps_out - 1, 2, h, w))
        return KeypointNetOutputs(tuple(heat), tuple(depth), tuple(centers))


def outputs_to_reference(outputs: KeypointNetOutputs, stack: int = -1):
    """One stack's outputs in the reference serving contract: sigmoid
    heatmaps (N, K, H, W), depth (N, K, H, W), centers (N, T, 2, H, W)."""
    return (torch.sigmoid(outputs.heatmaps[stack]), outputs.depth[stack],
            outputs.centers[stack])
