"""Corner pooling: directional running maxima over NCHW maps.

Counterpart of ``object_keypoints_tpu/ops/corner_pool.py``, which lowers
them through XLA (``lax.cummax``); they are no TPU kernel. The forward here
is ``torch.cummax``, one launch a pool. The backward is JAX's, not
``torch.cummax``'s: JAX differentiates ``cummax`` through the associative
scan it is defined by (the odd/even recursion of
``jax.lax.associative_scan`` combining with ``lax.max``), and ``lax.max``
gives half of the cotangent to each operand where the two tie, so a
running max that ties shares its gradient among the tied inputs along the
scan's tree, where ``torch.cummax`` gives all of it to one index. Each
pool is therefore an autograd Function whose backward rebuilds that scan
over ``torch.maximum`` (whose backward also halves a tie) and returns its
vector-Jacobian product. Where no values tie the two backwards agree.

- TopPool:    out[i] = max(x[i:])   along H (dim 2): suffix, a reversed cummax
- BottomPool: out[i] = max(x[:i+1]) along H: prefix, a plain cummax
- LeftPool:   out[j] = max(x[j:])   along W (dim 3): suffix
- RightPool:  out[j] = max(x[:j+1]) along W: prefix
"""

from __future__ import annotations

import torch
from torch import nn

H, W = 2, 3


def _slice(t, dim, start, stop=None, step=1):
    return t[(slice(None),) * dim + (slice(start, stop, step),)]


def _interleave(even, odd, dim):
    """even[0], odd[0], even[1], odd[1], ... along ``dim``; ``even`` holds
    as many elements as ``odd`` or one more."""
    k = odd.shape[dim]
    out = torch.stack((_slice(even, dim, 0, k), odd), dim + 1).flatten(dim, dim + 1)
    return torch.cat((out, _slice(even, dim, k)), dim) if even.shape[dim] > k else out


def scan_max(x, dim):
    """Prefix max along ``dim`` by ``jax.lax.associative_scan``'s recursion
    over ``torch.maximum``: the max of each pair of neighbours, scanned, gives
    the odd positions; each even one is the odd scan before it against its
    own element. Differentiable; its gradient is JAX's ``cummax``'s."""
    n = x.shape[dim]
    if n < 2:
        return x
    odd = scan_max(torch.maximum(_slice(x, dim, 0, -1, 2), _slice(x, dim, 1, None, 2)), dim)
    before = _slice(odd, dim, 0, -1) if n % 2 == 0 else odd
    even = torch.cat((_slice(x, dim, 0, 1), torch.maximum(before, _slice(x, dim, 2, None, 2))),
                     dim)
    return _interleave(even, odd, dim)


class _CumMax(torch.autograd.Function):
    """torch.cummax forward, JAX's associative-scan backward."""

    @staticmethod
    def forward(ctx, x, dim, reverse):
        ctx.save_for_backward(x)
        ctx.dim, ctx.reverse = dim, reverse
        if reverse:
            return torch.cummax(x.flip(dim), dim)[0].flip(dim)
        return torch.cummax(x, dim)[0]

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        dim, reverse = ctx.dim, ctx.reverse
        with torch.enable_grad():
            xd = x.detach().requires_grad_()
            y = scan_max(xd.flip(dim), dim).flip(dim) if reverse else scan_max(xd, dim)
            (gx,) = torch.autograd.grad(y, xd, grad)
        return gx, None, None


def _prefix_max(x, dim):
    return _CumMax.apply(x, dim, False)


def _suffix_max(x, dim):
    return _CumMax.apply(x, dim, True)


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
