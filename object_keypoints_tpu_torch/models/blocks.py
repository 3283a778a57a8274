"""Building blocks: conv-bn-relu, residual, fire module, 1x1 merge.

PyTorch counterparts of ``object_keypoints_tpu/models/blocks.py``. Modules
take and return NCHW tensors; their attribute names follow the reference
torch state_dict (``conv``/``bn``, ``conv1``/``bn1``/``conv2``/``bn2``/
``skip``, ``conv_1x1``/``conv_3x3``), so
``object_keypoints_tpu.serving.torch_import`` reads a port state_dict as it
is. Weights start from torch's Conv2d default, kaiming_uniform(a=sqrt(5)),
the JAX package's ``torch_conv_kernel_init``.

Precision follows the JAX package's ``dtype`` rule (``precision``): the
parameters and BatchNorm statistics stay float32 and a block computes in
its input's dtype. ``Conv2d`` and ``ConvTranspose2d`` cast their weights to
it; ``BatchNorm2d`` is flax's BatchNorm (momentum 0.9, eps 1e-5, the biased
batch variance folded into the running one), over the data group's batch
when a process group is initialized (``parallel``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from object_keypoints_tpu_torch import parallel
from object_keypoints_tpu_torch.ops.stem_conv import fold_bn, stem_conv
from object_keypoints_tpu_torch.utils import timer

MOMENTUM = 0.9  # flax's: running = MOMENTUM * running + (1 - MOMENTUM) * batch


def in_dtype(module, dtype):
    """``module``'s weight and bias in ``dtype``. Where the weights need a
    gradient the cast is part of the autograd graph, made on every call;
    otherwise it is kept on the module until the weights change (another
    storage or an in-place write, seen by the version counter), so a serving
    forward casts once and not once a call. An inference tensor has no
    version counter, so its cast is made on every call. A cast made outside
    autograd's graph counts in ``weights.built`` (``utils.timer``)."""
    w, b = module.weight, module.bias
    if w.dtype == dtype:
        return w, b

    def cast():
        return w.to(dtype), None if b is None else b.to(dtype)

    if torch.is_grad_enabled() and w.requires_grad:
        return cast()
    if w.is_inference():
        timer.count("weights.built")
        return cast()
    key = (w.data_ptr(), w._version, None if b is None else (b.data_ptr(), b._version), dtype,
           torch.is_inference_mode_enabled())
    cached = getattr(module, "_cast", None)
    if cached is None or cached[0] != key:
        timer.count("weights.built")
        cached = module._cast = (key, cast())
    return cached[1]


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` over float32 weights that computes in its input's dtype."""

    def forward(self, x):
        return self._conv_forward(x, *in_dtype(self, x.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` over float32 weights that computes in its
    input's dtype."""

    def forward(self, x):
        w, b = in_dtype(self, x.dtype)
        return F.conv_transpose2d(x, w, b, self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


class BatchNorm2d(nn.BatchNorm2d):
    """flax's BatchNorm over NCHW. Weight, bias and running statistics stay
    float32 whatever the input's dtype; the normalization runs in float32
    and returns the input's dtype. Train mode normalizes by the batch's
    biased variance and folds that same biased variance into
    ``running_var``, as flax does: ``nn.BatchNorm2d`` folds the unbiased
    one, n / (n - 1) larger. ``num_batches_tracked`` is not counted.

    Where a process group is initialized (``parallel.initialize_distributed``,
    at world size 1 too) train mode takes flax's global view of the batch
    across the data group (the ranks of this rank's model column, the whole
    group without a (data, model) grid), as the JAX package's BatchNorm does
    over a mesh: each rank sums its channels' values and squares and counts
    them, one differentiable all-reduce over the data group adds them up
    (the ranks of a data row hold the same activations), and the variance is
    E[x^2] - E[x]^2 of the whole batch, flax's formula; that biased variance
    goes into ``running_var``, so every rank keeps the same statistics. The
    sums accumulate in float64 whatever the input's dtype: that formula
    cancels where a channel's mean is many of its deviations, and float32
    sums over 2 x 256 x 256 values a rank put 5e-3 of the gradient's norm
    between a two-rank float32 step and float64 (7e-5 with float64 sums,
    as a one-process float32 step). The normalization runs in float32
    (float64 for a float64 input). ``nn.SyncBatchNorm`` is not used: it
    needs CUDA and folds the unbiased variance."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-5, momentum=1.0 - MOMENTUM)

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        if parallel.is_distributed():
            return self._global_forward(x)
        # momentum 1 writes the batch's mean and unbiased variance into `batch`
        batch = self.running_mean.new_zeros(2, self.num_features)
        y = F.batch_norm(x, batch[0], batch[1], self.weight, self.bias, True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_mean.mul_(MOMENTUM).add_(batch[0], alpha=1.0 - MOMENTUM)
            self.running_var.mul_(MOMENTUM).add_(batch[1], alpha=(1.0 - MOMENTUM) * (n - 1) / n)
        return y

    def _global_forward(self, x):
        acc = torch.float64 if x.dtype == torch.float64 else torch.float32
        xf = x.to(acc)
        c = x.shape[1]
        f64 = torch.float64
        local = torch.cat([xf.sum((0, 2, 3), dtype=f64), xf.square().sum((0, 2, 3), dtype=f64),
                           xf.new_full((1,), x.numel() // c, dtype=f64)])
        total = parallel.all_reduce_autograd(local, parallel.data_group())
        count = total[2 * c].detach()
        mean = total[:c] / count
        var = torch.clamp(total[c:2 * c] / count - mean.square(), min=0.0)
        mean, var = mean.to(acc), var.to(acc)
        scale = torch.rsqrt(var + self.eps) * self.weight.to(acc)
        y = (xf - mean[:, None, None]) * scale[:, None, None] + self.bias.to(acc)[:, None, None]
        with torch.no_grad():
            self.running_mean.mul_(MOMENTUM).add_(mean.to(self.running_mean.dtype),
                                                  alpha=1.0 - MOMENTUM)
            self.running_var.mul_(MOMENTUM).add_(var.to(self.running_var.dtype),
                                                 alpha=1.0 - MOMENTUM)
        return y.to(x.dtype)


class ConvBlock(nn.Module):
    """conv(k) + BN + ReLU (the vendored ``convolution``); with
    ``with_bn=False`` the conv has a bias and there is no ``bn``."""

    def __init__(self, in_dim: int, out_dim: int, kernel: int = 3, stride: int = 1,
                 with_bn: bool = True):
        super().__init__()
        pad = (kernel - 1) // 2
        self.conv = Conv2d(in_dim, out_dim, kernel, stride=stride, padding=pad, bias=not with_bn)
        self.bn = BatchNorm2d(out_dim) if with_bn else None

    def forward(self, x):
        y = self.conv(x)
        return torch.relu(y if self.bn is None else self.bn(y))


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
        self.conv1 = Conv2d(in_dim, out_dim, kernel, stride=stride, padding=pad, bias=False)
        self.bn1 = BatchNorm2d(out_dim)
        self.conv2 = Conv2d(out_dim, out_dim, kernel, padding=pad, bias=False)
        self.bn2 = BatchNorm2d(out_dim)
        if stride != 1 or in_dim != out_dim:
            self.skip = nn.Sequential(
                Conv2d(in_dim, out_dim, 1, stride=stride, bias=False), BatchNorm2d(out_dim)
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


@torch.no_grad()
def reset_like_jax(model: nn.Module, generator: torch.Generator | None = None):
    """The JAX package's init: conv kernels U(+-1/sqrt(fan_in)), drawn from
    ``generator`` in module order; conv biases zero; BatchNorm at identity."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            # flax counts fan_in over (kh, kw, in); torch's ConvTranspose2d
            # weight is (in, out, kh, kw), Conv2d's (out, in/groups, kh, kw)
            fan_in = w[:, 0].numel() if isinstance(m, nn.ConvTranspose2d) else w[0].numel()
            bound = fan_in ** -0.5
            w.copy_(torch.empty(w.shape).uniform_(-bound, bound, generator=generator))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()


class MergeBN(nn.Sequential):
    """1x1 conv (no bias) + BN, the inter-stack merge; state_dict keys
    ``0.weight`` and ``1.*`` as in the reference."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__(Conv2d(in_dim, out_dim, 1, bias=False), BatchNorm2d(out_dim))
