"""Corner pooling: directional running maxima over NCHW maps.

Counterpart of ``object_keypoints_tpu/ops/corner_pool.py``, which lowers
them through XLA (``lax.cummax``); they are no TPU kernel. The backward is
JAX's, not ``torch.cummax``'s: JAX differentiates ``cummax`` through the
associative scan it is defined by (the odd/even recursion of
``jax.lax.associative_scan`` combining with ``lax.max``), and ``lax.max``
gives half of the cotangent to each operand where the two tie, so a
running max that ties shares its gradient among the tied inputs along the
scan's tree, where ``torch.cummax`` gives all of it to one index.
``scan_max`` is that scan over ``torch.maximum`` (whose backward also
halves a tie), differentiable; ``scan_max_vjp`` is its vector-Jacobian
product in two sweeps over the scan's levels, equal to autograd's through
``scan_max`` bit for bit. Where no values tie the two backwards agree.

Each pool is the autograd Function ``_CumMax``. On a CPU tensor its forward
is ``torch.cummax`` and its backward ``scan_max_vjp``. On a CUDA tensor
(bfloat16 or float32) both passes are the hand-written kernels of
``csrc/corner_pool.cu``: ``okt_corner_pool_fwd`` (``pool_kernel``), the
running max along either axis in either direction with no flip and no
indices, and ``okt_corner_pool_bwd`` (``pool_grad_kernel``),
``scan_max_vjp``'s two sweeps with each line held in shared memory (lines
of at most ``MAX_LINE``); they read the NHWC memory
of a channels_last map, and an input or a cotangent that is not NHWC-dense
is made so first. Nothing falls back: another dtype or a longer line
raises. The counters ``corner_pool.kernel`` (a launch of either kernel)
and ``corner_pool.relayout`` (a tensor made channels_last) and the spans
``corner_pool.forward`` and ``corner_pool.backward`` (each holding one
launch on the card) are ``utils.timer``'s.

- TopPool:    out[i] = max(x[i:])   along H (dim 2): suffix
- BottomPool: out[i] = max(x[:i+1]) along H: prefix
- LeftPool:   out[j] = max(x[j:])   along W (dim 3): suffix
- RightPool:  out[j] = max(x[:j+1]) along W: prefix
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from object_keypoints_tpu_torch.utils import timer

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


def _split(left, right, g):
    """``torch.maximum(left, right)``'s backward: the shares of its
    cotangent ``g`` that go to ``left`` and to ``right``; a tie halves it."""
    g = torch.where(left == right, g / 2, g)
    return g.masked_fill(left < right, 0), g.masked_fill(left > right, 0)


def _pad_end(t, dim, n):
    """``t`` with ``n`` zeros appended along ``dim``."""
    return F.pad(t, (0, 0) * (t.dim() - 1 - dim) + (0, n))


def scan_max_vjp(x, grad, dim):
    """The vector-Jacobian product of ``scan_max(x, dim)`` with the
    cotangent ``grad``, equal to autograd's through it bit for bit: every
    gradient element is a sum of at most two terms, each rounded to the
    dtype as the eager ops round.

    Down-sweep over the levels (level 0 is ``x``; level l + 1 the max of
    each complete pair of level l, down to a length under 2): the even
    output 2i (i >= 1) of a level is max(before, x[2i]), ``before`` the
    running max of the next level up to i - 1, and its cotangent is split
    between the two; the next level's output cotangent is g[2i + 1] plus
    the share of ``before`` at output 2i + 2. Up-sweep: each level's input
    cotangent is split over the pair that made it, and g[0] and the even
    outputs' other shares join the even positions."""
    levels = []
    while x.shape[dim] >= 2:
        n, k = x.shape[dim], x.shape[dim] // 2
        a, b = _slice(x, dim, 0, 2 * k, 2), _slice(x, dim, 1, 2 * k, 2)
        up = torch.maximum(a, b)
        before = _slice(torch.cummax(up, dim)[0], dim, 0, (n - 1) // 2)
        to_before, to_even = _split(before, _slice(x, dim, 2, None, 2),
                                    _slice(grad, dim, 2, None, 2))
        levels.append((a, b, torch.cat((_slice(grad, dim, 0, 1), to_even), dim)))
        grad = _slice(grad, dim, 1, 2 * k, 2) + _pad_end(to_before, dim, k - (n - 1) // 2)
        x = up
    for a, b, even_rest in reversed(levels):
        to_a, to_b = _split(a, b, grad)
        even = _pad_end(to_a, dim, even_rest.shape[dim] - a.shape[dim]) + even_rest
        grad = _interleave(even, to_b, dim)
    return grad


# okt_corner_pool_fwd / _bwd's code for each dtype they take
KERNEL_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
MAX_LINE = 4096  # the longest line okt_corner_pool_bwd holds on chip


def _nhwc(t):
    """``t`` if its memory is NHWC-dense, else a channels_last copy,
    counted in ``corner_pool.relayout``."""
    if t.permute(0, 2, 3, 1).is_contiguous():
        return t
    timer.count("corner_pool.relayout")
    return t.contiguous(memory_format=torch.channels_last)


def _checked(x, dim):
    """``x``, NHWC-dense, if the kernels take it; else raise."""
    if x.device.type != "cuda":
        raise ValueError(f"corner pool: no kernel for device {x.device}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"corner pool: bfloat16 or float32 maps on the card, got {x.dtype}")
    if x.dim() != 4 or dim not in (H, W):
        raise ValueError(f"corner pool: an (N, C, H, W) map along H or W, got {tuple(x.shape)} "
                         f"along dim {dim}")
    return _nhwc(x)


def _checked_line(x, dim):
    if x.shape[dim] > MAX_LINE:
        raise ValueError(f"corner pool: the backward kernel takes lines of at most {MAX_LINE}, "
                         f"got {x.shape[dim]}")


def _launch(name, *tensors, dim, reverse):
    """``okt_corner_pool_<name>`` over the NHWC-dense maps ``tensors`` into a
    new one, on the current stream of their card."""
    from object_keypoints_tpu_torch.ops import _build

    x = tensors[0]
    n, c, h, w = x.shape
    out = torch.empty((n, h, w, c), dtype=x.dtype, device=x.device).permute(0, 3, 1, 2)
    if out.numel() == 0:
        return out
    kernel = f"okt_corner_pool_{name}"
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        err = getattr(lib, kernel)(
            *(t.data_ptr() for t in tensors), out.data_ptr(), KERNEL_DTYPES[x.dtype], n, c, h, w,
            dim, int(reverse), torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"corner pool {name} kernel launch failed: cudaError {err}")
    timer.count("corner_pool.kernel")
    return out


def pool_kernel(x, dim, reverse):
    """``okt_corner_pool_fwd``: the running max of a CUDA (N, C, H, W) map
    along ``dim``, from the end where ``reverse``; channels_last out."""
    return _launch("fwd", _checked(x, dim), dim=dim, reverse=reverse)


def pool_grad_kernel(x, grad, dim, reverse):
    """``okt_corner_pool_bwd``: ``scan_max_vjp(x, grad, dim)`` on the card
    (of the flipped line where ``reverse``); channels_last out."""
    x = _checked(x, dim)
    _checked_line(x, dim)
    if grad.shape != x.shape or grad.dtype != x.dtype or grad.device != x.device:
        raise ValueError(f"corner pool: a cotangent like the map, got {grad.dtype} "
                         f"{tuple(grad.shape)} on {grad.device}")
    return _launch("bwd", x, _nhwc(grad), dim=dim, reverse=reverse)


class _CumMax(torch.autograd.Function):
    """The running max along ``dim`` (from the end where ``reverse``) with
    JAX's associative-scan backward: on the CPU ``torch.cummax`` and
    ``scan_max_vjp``, on the card ``pool_kernel`` and ``pool_grad_kernel``.
    The spans ``corner_pool.forward`` and ``corner_pool.backward``
    (``utils.timer``; a CUDA backward runs on autograd's own thread)."""

    @staticmethod
    def forward(ctx, x, dim, reverse):
        ctx.dim, ctx.reverse = dim, reverse
        with timer.span("corner_pool.forward"):
            if x.device.type == "cpu":
                ctx.save_for_backward(x)
                if reverse:
                    return torch.cummax(x.flip(dim), dim)[0].flip(dim)
                return torch.cummax(x, dim)[0]
            x = _checked(x, dim)
            if ctx.needs_input_grad[0]:
                _checked_line(x, dim)
            ctx.save_for_backward(x)
            return pool_kernel(x, dim, reverse)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        dim, reverse = ctx.dim, ctx.reverse
        with timer.span("corner_pool.backward"):
            if x.device.type == "cpu":
                if reverse:
                    return scan_max_vjp(x.flip(dim), grad.flip(dim), dim).flip(dim), None, None
                return scan_max_vjp(x, grad, dim), None, None
            return pool_grad_kernel(x, grad, dim, reverse), None, None


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
