"""Seeded weights, made on the device in one draw.

Both sides of a check load the same state_dict: the program under test and
the plain reference (their modules share the reference's names). Values:

- convolution weights U(+-sqrt(6 / fan_in)), He's init for ReLU networks
  (fan_in over in/groups x kh x kw; a transposed convolution's over out x
  kh x kw of its (in, out, kh, kw)), convolution biases U(+-0.1);
- BatchNorm weight U(0.5, 1.5), bias U(+-0.1), running mean U(+-0.1),
  running variance U(0.5, 1.5); ``batchnorm_stats`` then sets the running
  statistics to those of seeded frames, as training leaves them, so that the
  network's outputs depend on its input as a trained one's do and a folded
  or skipped BatchNorm shows;
- ``overrides``: {fnmatch pattern of a key: constant} from the config (an
  output bias such as CornerNet's heat prior -2.19).
"""

from __future__ import annotations

import fnmatch

import torch
from torch import nn


def seeded_state(model: nn.Module, seed: int, device, overrides=None) -> dict:
    """A float32 state_dict for ``model`` (which may live on the meta
    device), drawn from ``seed`` on ``device``."""
    kinds = {}
    for name, m in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(m, nn.modules.conv._ConvNd):
            w = m.weight
            fan_in = w[:, 0].numel() if m.transposed else w[0].numel()
            kinds[prefix + "weight"] = ("sym", (6.0 / fan_in) ** 0.5)
            if m.bias is not None:
                kinds[prefix + "bias"] = ("sym", 0.1)
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            kinds.update({prefix + "weight": ("pos", 1.0), prefix + "bias": ("sym", 0.1),
                          prefix + "running_mean": ("sym", 0.1),
                          prefix + "running_var": ("pos", 1.0),
                          prefix + "num_batches_tracked": ("zero", 0)})
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    missing = sorted(set(shapes) - set(kinds))
    if missing:
        raise KeyError(f"no rule for the weights {missing[:5]}")
    total = sum(s.numel() for s in shapes.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device)
    state, offset = {}, 0
    for key, shape in shapes.items():
        n = shape.numel()
        u = flat[offset:offset + n].view(shape)
        offset += n
        kind, scale = kinds[key]
        if kind == "zero":
            state[key] = torch.zeros(shape, dtype=torch.int64, device=device)
        elif kind == "sym":
            state[key] = (2.0 * u - 1.0) * scale
        else:
            state[key] = u + 0.5 * scale
    for pattern, value in (overrides or {}).items():
        hits = [k for k in state if fnmatch.fnmatchcase(k, pattern)]
        if not hits:
            raise KeyError(f"override {pattern!r} matches no weight")
        for k in hits:
            state[k].fill_(value)
    return state


def meta_model(factory, *args, **kwargs) -> nn.Module:
    """``factory(*args, **kwargs)`` built on the meta device: no weights are
    drawn or allocated until ``materialize``."""
    with torch.device("meta"):
        return factory(*args, **kwargs)


def materialize(model: nn.Module, state: dict, device) -> nn.Module:
    """Give a meta-device ``model`` storage on ``device`` and load ``state``."""
    model = model.to_empty(device=device)
    model.load_state_dict(state, strict=True)
    return model


@torch.no_grad()
def batchnorm_stats(model: nn.Module, state: dict, frames) -> dict:
    """Set ``state``'s BatchNorm running statistics, in place, to the batch
    statistics of a train-mode forward of the plain reference ``model``
    (loaded with ``state``, float32, TF32 off) on ``frames``; BatchNorms the
    forward does not reach keep theirs."""
    from reference.lowp import no_tf32

    model.load_state_dict(state, strict=True)
    model.to(frames.device)
    norms = [m for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    before = {id(m): (m.running_mean.clone(), m.running_var.clone()) for m in norms}
    for m in norms:
        m.momentum = None  # a cumulative average: one batch gives its own statistics
        m.reset_running_stats()
    model.train()
    with no_tf32():
        model(frames.float())
    for m in norms:
        if int(m.num_batches_tracked) == 0:
            m.running_mean.copy_(before[id(m)][0])
            m.running_var.copy_(before[id(m)][1])
        m.num_batches_tracked.zero_()
    for key, value in model.state_dict().items():
        state[key].copy_(value)
    return state
