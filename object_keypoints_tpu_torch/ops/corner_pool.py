"""Corner pooling: directional running maxima over NCHW maps.

Counterpart of ``object_keypoints_tpu/ops/corner_pool.py``, which lowers
them through XLA (``lax.cummax``); they are no TPU kernel, and here they
are ``torch.cummax``, whose backward sends each gradient to the running
argmax, as JAX's autodiff of ``cummax`` does.

- TopPool:    out[i] = max(x[i:])   along H (dim 2): suffix, a reversed cummax
- BottomPool: out[i] = max(x[:i+1]) along H: prefix, a plain cummax
- LeftPool:   out[j] = max(x[j:])   along W (dim 3): suffix
- RightPool:  out[j] = max(x[:j+1]) along W: prefix
"""

from __future__ import annotations

import torch
from torch import nn

H, W = 2, 3


def _prefix_max(x, dim):
    return torch.cummax(x, dim)[0]


def _suffix_max(x, dim):
    return torch.cummax(x.flip(dim), dim)[0].flip(dim)


def top_pool(x):
    """Suffix max along H: the max over this row and every row below."""
    return _suffix_max(x, H)


def bottom_pool(x):
    """Prefix max along H."""
    return _prefix_max(x, H)


def left_pool(x):
    """Suffix max along W."""
    return _suffix_max(x, W)


def right_pool(x):
    """Prefix max along W."""
    return _prefix_max(x, W)


class _Pool(nn.Module):
    fn = None

    def forward(self, x):
        return self.fn(x)


class TopPool(_Pool):
    fn = staticmethod(top_pool)


class BottomPool(_Pool):
    fn = staticmethod(bottom_pool)


class LeftPool(_Pool):
    fn = staticmethod(left_pool)


class RightPool(_Pool):
    fn = staticmethod(right_pool)
