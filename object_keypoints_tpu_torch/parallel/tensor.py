"""The mesh's ``model`` axis: wide convolutions split by output channel over
the ranks of a data row.

Counterpart of the JAX package's ``shard_params`` over a mesh with a
``model`` axis (``parallel/mesh.py:88-139``): its rule (``mesh._param_spec``)
shards every conv kernel (H, W, Cin, Cout) with Cout >= 256 and divisible by
the axis on Cout, and XLA partitions those convs and inserts their
collectives. The port writes that column split by hand, one process a rank
of the grid that ``parallel.create_mesh`` lays out:

- ``shard_params(model, mesh)`` swaps, in place, every wide ``Conv2d`` /
  ``ConvTranspose2d`` (``wide_convs``, the rule on torch shapes) for a
  ``ModelShardedConv`` holding this rank's model-rank slice of its output
  channels: dim 0 of a Conv2d weight (out, in / groups, kh, kw), dim 1 of a
  ConvTranspose2d weight (in, out, kh, kw). The bias stays whole, as the
  rule replicates it, and is added after the gather, so its gradient is the
  same on every rank of the row.
- A ``ModelShardedConv`` runs its conv on the slice, all-gathers the
  channels over the model group and adds the bias: every rank of the row
  holds the whole output. Backward: the gather's is this rank's slice of the
  output gradient; the conv's input passes an identity whose backward sums
  the input gradient over the model group (each rank's conv made only its
  channels' share of it). A grouped conv (the fire modules' depthwise 3x3)
  takes only its own groups' input channels (groups / m of them): that
  slice's backward all-gathers the input gradient.
- ``unshard`` / ``unshard_like_parameters`` gather the whole state_dict, or
  tensors aligned with the parameters (gradients), back: JAX reads a sharded
  array as a global one.

Every rank's weights must be the same before ``shard_params`` (one seed, or
a broadcast). The collectives run on contiguous buffers in the memory order
of the tensor they move (NHWC for a channels_last one), and the result
comes back in that layout.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from object_keypoints_tpu_torch.parallel.mesh import (
    WIDE,
    Mesh,
    all_gather,
    all_reduce,
    model_group,
    model_rank,
    model_size,
)

CONVS = (nn.Conv2d, nn.ConvTranspose2d)


def sharded_dim(conv) -> int:
    """The torch dimension of the rule's Cout: 1 for a ConvTranspose2d weight
    (in, out, kh, kw), 0 for a Conv2d weight (out, in / groups, kh, kw)."""
    return 1 if isinstance(conv, nn.ConvTranspose2d) else 0


def wide_convs(model: nn.Module, count: int, kinds: tuple = CONVS) -> list:
    """(name, module) of every conv of ``model`` (a module of ``kinds``) that
    the rule shards over a ``model`` axis of ``count``: Cout >= 256 and
    divisible by ``count``."""
    if count <= 1:
        return []
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, kinds) and m.out_channels >= WIDE and m.out_channels % count == 0]


def shard_in_channels(conv, count: int) -> Optional[int]:
    """The input channels one shard of a grouped Conv2d reads (its groups'
    share), or None where the conv has one group and reads them all."""
    if conv.groups == 1:
        return None
    if isinstance(conv, nn.ConvTranspose2d) or conv.groups % count:
        raise ValueError(f"no output-channel split of {conv} over {count} shards")
    return conv.in_channels // count


def weight_shard(conv, index: int, count: int) -> torch.Tensor:
    """A copy of output-channel slice ``index`` of ``count`` of ``conv``'s weight."""
    dim, width = sharded_dim(conv), conv.out_channels // count
    return conv.weight.detach().narrow(dim, index * width, width).clone()


def _is_nhwc(t: torch.Tensor) -> bool:
    """Whether ``t`` is laid out channels_last (and not also contiguous)."""
    return (t.dim() == 4 and not t.is_contiguous()
            and t.is_contiguous(memory_format=torch.channels_last))


def _buffer(t: torch.Tensor, copy: bool = False):
    """(``t`` as a contiguous tensor in its memory order, whether that order
    is NHWC); with ``copy`` never ``t``'s own storage."""
    nhwc = _is_nhwc(t)
    b = t.permute(0, 2, 3, 1) if nhwc else t
    return (b.clone(memory_format=torch.contiguous_format) if copy else b.contiguous()), nhwc


def _restore(b: torch.Tensor, nhwc: bool) -> torch.Tensor:
    return b.permute(0, 3, 1, 2) if nhwc else b


def _gather_channels(t: torch.Tensor, group) -> torch.Tensor:
    b, nhwc = _buffer(t)
    return _restore(all_gather(b, 3 if nhwc else 1, group), nhwc)


def _narrow_channels(t: torch.Tensor, index: int, width: int, nhwc: bool) -> torch.Tensor:
    layout = torch.channels_last if nhwc else torch.contiguous_format
    return t.narrow(1, index * width, width).contiguous(memory_format=layout)


class _CopyToModel(torch.autograd.Function):
    """Identity; the backward sums the gradient over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        b, nhwc = _buffer(grad, copy=True)
        return _restore(all_reduce(b, ctx.group), nhwc), None


class _SliceToModel(torch.autograd.Function):
    """Channels [index * width, (index + 1) * width) of the input; the
    backward all-gathers the slices' gradients over the model group."""

    @staticmethod
    def forward(ctx, x, group, index, width):
        ctx.group = group
        return _narrow_channels(x, index, width, _is_nhwc(x))

    @staticmethod
    def backward(ctx, grad):
        return _gather_channels(grad, ctx.group), None, None, None


class _GatherFromModel(torch.autograd.Function):
    """The ranks' channels concatenated in model-rank order; the backward
    is this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, y, group, index):
        ctx.index, ctx.width, ctx.nhwc = index, y.shape[1], _is_nhwc(y)
        return _gather_channels(y, group)

    @staticmethod
    def backward(ctx, grad):
        return _narrow_channels(grad, ctx.index, ctx.width, ctx.nhwc), None, None


class ModelShardedConv(nn.Module):
    """This rank's share of a wide ``Conv2d`` / ``ConvTranspose2d`` over the
    model group ``group`` of ``count`` ranks, ``index`` its rank there:
    ``weight`` is the output-channel slice ``index`` (float32, computed in
    the input's dtype, as ``models.blocks`` convs), ``bias`` the whole bias.
    Input and output are the whole (N, C, H, W) tensors, replicated over the
    row."""

    def __init__(self, conv, index: int, count: int, group):
        super().__init__()
        self.transpose = isinstance(conv, nn.ConvTranspose2d)
        self.index, self.count, self.group = index, count, group
        self.dim = sharded_dim(conv)
        self.in_width = shard_in_channels(conv, count)
        self.groups = conv.groups // count if self.in_width else 1
        self.stride, self.padding, self.dilation = conv.stride, conv.padding, conv.dilation
        self.output_padding = getattr(conv, "output_padding", None)
        self.weight = nn.Parameter(weight_shard(conv, index, count),
                                   requires_grad=conv.weight.requires_grad)
        self.bias = conv.bias

    def forward(self, x):
        if self.in_width is None:
            x = _CopyToModel.apply(x, self.group)
        else:
            x = _SliceToModel.apply(x, self.group, self.index, self.in_width)
        w = self.weight.to(x.dtype)
        if self.transpose:
            y = F.conv_transpose2d(x, w, None, self.stride, self.padding, self.output_padding,
                                   self.groups, self.dilation)
        else:
            y = F.conv2d(x, w, None, self.stride, self.padding, self.dilation, self.groups)
        y = _GatherFromModel.apply(y, self.group, self.index)
        return y if self.bias is None else y + self.bias.to(y.dtype)[:, None, None]

    def gather(self, shard: torch.Tensor) -> torch.Tensor:
        """A tensor shaped as ``weight`` (the weight, its gradient), whole:
        the model group's slices concatenated along the sharded dim."""
        return all_gather(shard.detach().contiguous(), self.dim, self.group)


def shard_params(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Swap, in place, every wide conv of ``model`` (``wide_convs``) for
    this rank's ``ModelShardedConv``, over the model group that
    ``create_mesh(..., model_parallel)`` built in this process group;
    returns ``model``. A data-only mesh leaves it as it is. Shard before
    ``training.trainer.create_train_state``: the optimizer state lives on
    the shards."""
    count = mesh.model_parallel
    if count == 1:
        return model
    if model_size() != count:
        raise ValueError(f"shard_params: a model axis of {count}, but this process group's grid "
                         f"has {model_size()}; call parallel.create_mesh inside the group first")
    index, group = model_rank(), model_group()
    for name, conv in wide_convs(model, count):
        parent, _, child = name.rpartition(".")
        setattr(model.get_submodule(parent), child, ModelShardedConv(conv, index, count, group))
    return model


def _sharded_owners(model: nn.Module) -> dict:
    return {id(m.weight): m for m in model.modules() if isinstance(m, ModelShardedConv)}


def sharded_mask(model: nn.Module) -> Optional[List[bool]]:
    """For each parameter of ``model``, in order, whether it is a shard;
    None where none is."""
    owners = _sharded_owners(model)
    return [id(p) in owners for p in model.parameters()] if owners else None


def unshard_like_parameters(model: nn.Module, tensors: Sequence[torch.Tensor]) -> list:
    """``tensors`` aligned with ``model.parameters()`` (the gradients), each
    shard's gathered whole: a collective of every rank of each data row."""
    owners = _sharded_owners(model)
    return [owners[id(p)].gather(t) if id(p) in owners else t
            for p, t in zip(model.parameters(), tensors)]


def unshard(model: nn.Module) -> dict:
    """``model``'s state_dict with each shard's weight gathered whole: the
    unsharded model's state_dict (a collective of every rank of each data
    row)."""
    state = model.state_dict()
    for name, m in model.named_modules():
        if isinstance(m, ModelShardedConv):
            state[f"{name}.weight"] = m.gather(m.weight)
    return state
