"""The CornerNet detector family (NCHW): CornerNet, CornerNet-Squeeze,
CornerNet-Saccade.

Counterpart of ``object_keypoints_tpu/models/cornernet.py``. One class,
``CornerNetModel``, is CornerNet-Lite's ``hg_net`` over a fire or residual
hourglass; the factories give the three published models and the --tiny
one. Attribute names are the reference hg_net's, so
``object_keypoints_tpu.serving.torch_import.import_cornernet{,_squeeze,
_saccade}`` reads a port state_dict as it is:

- ``hg``: ``models.hourglass.HourglassStack`` (``hg.pre.{0..}``, ``hg.hgs.{s}``,
  ``hg.cnvs.{s}``, ``hg.inters.{s}``, ``hg.inters_.{s}``, ``hg.cnvs_.{s}``);
  ``hg.pre.0`` is a ``StemConvBlock``, so the eval forward runs the stem kernel;
- ``{tl,br}_modules.{s}``: ``CornerPoolBlock`` (``p1_conv1``, ``p2_conv1``,
  ``p_conv1``, ``p_bn1``, ``conv1``, ``bn1``, ``conv2``);
- ``{tl,br}_{heats,tags,offs}.{s}``: ``PredModule`` (``0``: conv + bias +
  ReLU, ``1``: 1x1 conv + bias);
- ``att_modules.{s}.{i}``: the saccade attention heads, one per hourglass
  level, deepest first.

``forward(x)`` returns the per-stack training outputs [tl_heats, br_heats,
tl_tags, br_tags, tl_offs, br_offs(, atts)], each a list over stacks of
NCHW maps; ``forward(x, test=True, **decode_kwargs)`` computes the last
stack's heads alone and decodes them (``ops.detection_decode``): detections
(N, num_dets, 8), tl_heat, br_heat, tl_tag, br_tag (and, for the saccade
model, the last stack's attention maps as clipped probabilities). Both run
the backbone under the span ``detector.backbone`` and the corner pools and
prediction heads (the attention heads too) under ``detector.heads``
(``utils.timer``; off by default); the decode is outside both.

Init follows the JAX package (``blocks.reset_like_jax``), drawn from the
``torch.Generator`` given, with the heat and attention output biases at
-2.19. Precision follows the frames' dtype (``precision``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from object_keypoints_tpu_torch.models.blocks import (
    BatchNorm2d,
    Conv2d,
    ConvBlock,
    reset_like_jax,
)
from object_keypoints_tpu_torch.models.hourglass import HourglassStack
from object_keypoints_tpu_torch.ops import corner_pool as pools
from object_keypoints_tpu_torch.ops.detection_decode import decode_detections
from object_keypoints_tpu_torch.ops.stem_conv import stem_conv
from object_keypoints_tpu_torch.utils import timer

HEAT_BIAS = -2.19


class PredModule(nn.Sequential):
    """conv(kernel) with bias + ReLU, then a 1x1 conv with bias -> out."""

    def __init__(self, in_dim: int, out: int, hidden: int = 256, kernel: int = 3,
                 bias_init_value: float = 0.0):
        super().__init__(ConvBlock(in_dim, hidden, kernel, with_bn=False),
                         Conv2d(hidden, out, 1, bias=True))
        self.bias_init_value = bias_init_value


class CornerPoolBlock(nn.Module):
    """Two pooled branches (conv-bn-relu to 128, then a directional pool)
    summed, a 3x3 conv + BN, a 1x1 conv + BN skip, ReLU, conv-bn-relu."""

    def __init__(self, dim: int, pool1, pool2):
        super().__init__()
        self.pool1, self.pool2 = pool1, pool2
        self.p1_conv1 = ConvBlock(dim, 128, 3)
        self.p2_conv1 = ConvBlock(dim, 128, 3)
        self.p_conv1 = Conv2d(128, dim, 3, padding=1, bias=False)
        self.p_bn1 = BatchNorm2d(dim)
        self.conv1 = Conv2d(dim, dim, 1, bias=False)
        self.bn1 = BatchNorm2d(dim)
        self.conv2 = ConvBlock(dim, dim, 3)

    def forward(self, x):
        p = self.pool1(self.p1_conv1(x)) + self.pool2(self.p2_conv1(x))
        p = self.p_bn1(self.p_conv1(p))
        return self.conv2(torch.relu(p + self.bn1(self.conv1(x))))


class CornerNetModel(nn.Module):
    """hg_net over a fire or residual hourglass; build one with the
    factories below."""

    def __init__(self, categories: int = 80, stacks: int = 2, levels: int = 4,
                 dims: Sequence[int] = (256, 256, 384, 384, 512),
                 mods: Sequence[int] = (2, 2, 2, 2, 4), hourglass: str = "fire",
                 stem_residuals: int = 2, cnv_dim: int = 256, head_kernel: int = 3,
                 with_attention: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.categories, self.stacks = categories, stacks
        self.with_attention = with_attention
        self.hg = HourglassStack(stacks, levels, dims, mods, (128, 256), cnv_dim,
                                 stem_residuals=stem_residuals, hourglass=hourglass,
                                 collect_ups=with_attention)
        self.tl_modules = nn.ModuleList(
            [CornerPoolBlock(cnv_dim, pools.top_pool, pools.left_pool) for _ in range(stacks)])
        self.br_modules = nn.ModuleList(
            [CornerPoolBlock(cnv_dim, pools.bottom_pool, pools.right_pool) for _ in range(stacks)])
        for side in ("tl", "br"):
            for head, out, bias in (("heats", categories, HEAT_BIAS), ("tags", 1, 0.0),
                                    ("offs", 2, 0.0)):
                setattr(self, f"{side}_{head}", nn.ModuleList([
                    PredModule(cnv_dim, out, kernel=head_kernel, bias_init_value=bias)
                    for _ in range(stacks)]))
        if with_attention:
            # one head per level on its merge output, deepest level first
            att_in = [dims[i] for i in reversed(range(levels))]
            self.att_modules = nn.ModuleList([
                nn.ModuleList([PredModule(d, 1, bias_init_value=HEAT_BIAS) for d in att_in])
                for _ in range(stacks)])
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """JAX-package init, then each head's output bias constant."""
        reset_like_jax(self, generator)
        for m in self.modules():
            if isinstance(m, PredModule):
                m[1].bias.fill_(m.bias_init_value)

    def heads(self, cnv, s: int):
        """Stack s's heads on its features: tl_heat, br_heat, tl_tag,
        br_tag, tl_off, br_off."""
        tl, br = self.tl_modules[s](cnv), self.br_modules[s](cnv)
        return (self.tl_heats[s](tl), self.br_heats[s](br), self.tl_tags[s](tl),
                self.br_tags[s](br), self.tl_offs[s](tl), self.br_offs[s](br))

    def forward(self, x, test: bool = False, stem=stem_conv, **decode_kwargs):
        with timer.span("detector.backbone"):
            feats = self.hg(x, stem)
        cnvs, ups = feats if self.with_attention else (feats, [])
        with timer.span("detector.heads"):
            # the test path reads the last stack's attention alone
            atts = [[att(u) for att, u in zip(self.att_modules[s], stack_ups)]
                    for s, stack_ups in enumerate(ups) if not test or s == self.stacks - 1]
            if not test:
                outs = [list(t) for t in zip(*(self.heads(cnv, s) for s, cnv in enumerate(cnvs)))]
                if self.with_attention:
                    outs.append(atts)
                return outs
            tl_heat, br_heat, tl_tag, br_tag, tl_off, br_off = self.heads(cnvs[-1],
                                                                          self.stacks - 1)
        detections = decode_detections(tl_heat, br_heat, tl_tag, br_tag, tl_off, br_off,
                                       **decode_kwargs)
        if self.with_attention:
            probs = [torch.clamp(torch.sigmoid(a), 1e-4, 1 - 1e-4) for a in atts[-1]]
            return (detections, tl_heat, br_heat, tl_tag, br_tag), probs
        return detections, tl_heat, br_heat, tl_tag, br_tag


# the published models (CornerNet.py, CornerNet_Squeeze.py, CornerNet_Saccade.py)
ARCHS = {
    "CornerNet": dict(stacks=2, levels=5, dims=(256, 256, 384, 384, 384, 512),
                      mods=(2, 2, 2, 2, 2, 4), hourglass="residual", stem_residuals=1),
    "CornerNet_Squeeze": dict(stacks=2, levels=4, dims=(256, 256, 384, 384, 512),
                              mods=(2, 2, 2, 2, 4), hourglass="fire", stem_residuals=2,
                              head_kernel=1),
    "CornerNet_Saccade": dict(stacks=3, levels=3, dims=(256, 384, 384, 512), mods=(1, 1, 1, 1),
                              hourglass="residual", stem_residuals=1, with_attention=True),
}


def tiny_arch(arch: str) -> dict:
    """The --tiny model that pairs with ``utils.config.tiny_db_overrides``:
    one stack, two levels, dims (8, 8, 16), cnv_dim 8; the residual
    hourglass with attention for CornerNet_Saccade, else the fire one."""
    saccade = arch.split("-")[0] == "CornerNet_Saccade"
    return dict(stacks=1, levels=2, dims=(8, 8, 16), mods=(1, 1, 1),
                hourglass="residual" if saccade else "fire", stem_residuals=1, cnv_dim=8,
                with_attention=saccade)


def cornernet(categories: int = 80, generator: Optional[torch.Generator] = None):
    """CornerNet: 2 stacks of a 5-level residual hourglass, one stem residual."""
    return CornerNetModel(categories, **ARCHS["CornerNet"], generator=generator)


def cornernet_squeeze(categories: int = 80, generator: Optional[torch.Generator] = None):
    """CornerNet-Squeeze: 2 stacks of a 4-level fire hourglass, two stem
    residuals, 1x1 heads."""
    return CornerNetModel(categories, **ARCHS["CornerNet_Squeeze"], generator=generator)


def cornernet_saccade(categories: int = 80, generator: Optional[torch.Generator] = None):
    """CornerNet-Saccade: 3 stacks of a 3-level residual hourglass with
    attention heads."""
    return CornerNetModel(categories, **ARCHS["CornerNet_Saccade"], generator=generator)


FACTORIES = {"CornerNet": cornernet, "CornerNet_Squeeze": cornernet_squeeze,
             "CornerNet_Saccade": cornernet_saccade}


def tiny_cornernet(arch: str, categories: int = 80, generator: Optional[torch.Generator] = None):
    """The --tiny model of ``arch`` (``tiny_arch``)."""
    return CornerNetModel(categories, **tiny_arch(arch), generator=generator)
