"""Plain reference of ``cornernet_squeeze.json``: CornerNet-Squeeze
(princeton-vl/CornerNet-Lite, core/models/CornerNet_Squeeze.py and
core/models/py_utils/losses.py) in ``torch.nn``, train mode.

- The model: the fire hourglass (``reference.layers``, two stacks, two
  stride-2 stem residuals) and, per stack, the top-left and bottom-right
  corner-pool modules (two 3x3 conv-bn-relu branches to 128, a directional
  running max each, summed; 3x3 conv + BN; a 1x1 conv + BN skip; ReLU;
  3x3 conv-bn-relu) and their 1x1 heads (conv with bias + ReLU, 1x1 conv
  with bias): heats (categories), tags (1), offsets (2).
- The pools: top and left are suffix maxima, bottom and right prefix
  maxima (``torch.cummax``).
- The loss: the focal loss over clamped sigmoids (positives where the target
  is 1, negatives weighted by (1 - target)^4, normalized by the positives),
  the associative-embedding pull and push at the paired corners' tags
  (weights 0.1), the smooth-L1 offsets (weight 1), summed over the stacks
  and averaged over them. float32.
"""

from __future__ import annotations

import torch
from torch import nn

from reference.layers import Conv2d, ConvBlock, BatchNorm2d, HourglassStack


def _suffix(x, dim):
    return torch.cummax(x.flip(dim), dim)[0].flip(dim)


def top_pool(x):
    return _suffix(x, 2)


def left_pool(x):
    return _suffix(x, 3)


def bottom_pool(x):
    return torch.cummax(x, 2)[0]


def right_pool(x):
    return torch.cummax(x, 3)[0]


class PredModule(nn.Sequential):
    def __init__(self, in_dim, out, hidden=256, kernel=1):
        super().__init__(ConvBlock(in_dim, hidden, kernel, with_bn=False),
                         Conv2d(hidden, out, 1, bias=True))


class CornerPoolBlock(nn.Module):
    def __init__(self, dim, pool1, pool2):
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


class CornerNetSqueeze(nn.Module):
    def __init__(self, categories=80, stacks=2, levels=4, dims=(256, 256, 384, 384, 512),
                 mods=(2, 2, 2, 2, 4), cnv_dim=256, stem_residuals=2, head_kernel=1, **_):
        super().__init__()
        self.hg = HourglassStack(stacks, levels, tuple(dims), tuple(mods), (128, 256), cnv_dim,
                                 stem_residuals=stem_residuals)
        self.tl_modules = nn.ModuleList([CornerPoolBlock(cnv_dim, top_pool, left_pool)
                                         for _ in range(stacks)])
        self.br_modules = nn.ModuleList([CornerPoolBlock(cnv_dim, bottom_pool, right_pool)
                                         for _ in range(stacks)])
        for side in ("tl", "br"):
            for head, out in (("heats", categories), ("tags", 1), ("offs", 2)):
                setattr(self, f"{side}_{head}", nn.ModuleList(
                    [PredModule(cnv_dim, out, kernel=head_kernel) for _ in range(stacks)]))

    def forward(self, x):
        """Per-stack lists: tl_heats, br_heats, tl_tags, br_tags, tl_offs,
        br_offs (NCHW)."""
        outs = []
        for s, cnv in enumerate(self.hg(x)):
            tl, br = self.tl_modules[s](cnv), self.br_modules[s](cnv)
            outs.append((self.tl_heats[s](tl), self.br_heats[s](br), self.tl_tags[s](tl),
                         self.br_tags[s](br), self.tl_offs[s](tl), self.br_offs[s](br)))
        return [list(t) for t in zip(*outs)]


def reference_model(config: dict) -> CornerNetSqueeze:
    return CornerNetSqueeze(config["db"]["categories"], **config["model"])


def gather(feat, tags):
    """(N, C, H, W) maps at (N, M) flat indices y * W + x -> (N, M, C)."""
    n, c = feat.shape[:2]
    return torch.gather(feat.flatten(2), 2, tags[:, None, :].expand(n, c, -1)).transpose(1, 2)


def _focal(probs, gt):
    pos = gt == 1.0
    neg_weights = torch.where(pos, 0.0, (1.0 - gt) ** 4)
    num_pos = pos.float().sum()
    total = 0.0
    for p in probs:
        pos_loss = torch.where(pos, torch.log(p) * (1.0 - p) ** 2, 0.0).sum()
        neg_loss = torch.where(pos, 0.0, torch.log(1.0 - p) * p ** 2 * neg_weights).sum()
        total = total - torch.where(num_pos > 0, (pos_loss + neg_loss) / num_pos.clamp(min=1.0),
                                    neg_loss)
    return total


def _ae(tag0, tag1, mask):
    maskf = mask.float()
    num = maskf.sum(dim=1, keepdim=True)
    mean = (tag0 + tag1) / 2.0
    pull = (torch.where(mask, (tag0 - mean) ** 2 / (num + 1e-4), 0.0).sum()
            + torch.where(mask, (tag1 - mean) ** 2 / (num + 1e-4), 0.0).sum())
    pairs = (maskf[:, :, None] + maskf[:, None, :]) == 2.0
    dist = torch.relu(1.0 - (mean[:, :, None] - mean[:, None, :]).abs())
    dist = (dist - 1.0 / (num[..., None] + 1e-4)) / (((num - 1.0) * num)[..., None] + 1e-4)
    return pull, torch.where(pairs, dist, 0.0).sum()


def _offset(off, gt, mask):
    d = (off - gt).abs()
    l1 = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
    return torch.where(mask[..., None], l1, 0.0).sum() / (mask.float().sum() + 1e-4)


def loss(outs, batch):
    """The CornerNet loss of ``outs`` (``forward``'s) on a batch dict (images
    NHWC, heatmaps (N, h, w, C), regrs (N, M, 2), tags (N, M), tag_mask)."""
    tl_heats, br_heats, tl_tags, br_tags, tl_offs, br_offs = outs
    mask = batch["tag_mask"]

    def probs(x):
        return torch.clamp(torch.sigmoid(x.float()), 1e-4, 1.0 - 1e-4)

    focal = (_focal([probs(t) for t in tl_heats], batch["tl_heatmaps"].permute(0, 3, 1, 2))
             + _focal([probs(b) for b in br_heats], batch["br_heatmaps"].permute(0, 3, 1, 2)))
    pull = push = off = 0.0
    for tl, br in zip(tl_tags, br_tags):
        a, b = _ae(gather(tl, batch["tl_tags"])[..., 0].float(),
                   gather(br, batch["br_tags"])[..., 0].float(), mask)
        pull, push = pull + a, push + b
    for tl, br in zip(tl_offs, br_offs):
        off = (off + _offset(gather(tl, batch["tl_tags"]).float(), batch["tl_regrs"], mask)
               + _offset(gather(br, batch["br_tags"]).float(), batch["br_regrs"], mask))
    return (focal + 0.1 * pull + 0.1 * push + off) / len(tl_heats)
