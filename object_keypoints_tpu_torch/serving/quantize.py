"""Post-training int8 quantization of the serve path.

Counterpart of ``object_keypoints_tpu/serving/quantize.py``. Where the JAX
package swaps each eligible flax conv for an int8 one through a method
interceptor while it traces, the port swaps each eligible ``Conv2d`` /
``ConvTranspose2d`` module of a KeypointNet for an ``Int8Conv``, once
(``quantize_model``):

    x_int8 = clip(round(float32(x) * (1 / s_in)), -127, 127),  s_in = s_act / 127
    y_int32 = conv(x_int8, round(w / s_w))         # ops.int8_conv
    y = float32(y_int32) * (s_in * s_w[out]) (+ bias), cast to the compute dtype

``s_act`` is the calibrated max-abs (or a percentile) of the conv's input, a
scalar, or one per input channel, then folded into the weight's input-channel
axis before ``s_w`` is taken; ``s_w`` is per output channel. The int8 weights
and their scales are made once, when the module is swapped (where XLA
constant-folds them), and kept as non-persistent buffers: ``state_dict``, the
artifact and the weight bridge are unchanged. On the card the int8 product
runs on cuBLASLt's int8 GEMM (``ops.int8_conv``); BatchNorm, ReLU and adds
stay in the compute dtype.

Scales are keyed by flax module path (``backbone/pre_res1/Conv_0``,
``heatmap_head_1/conv_out``, ``backbone/hg_0/up2``), so quant.json is the
JAX package's file; ``serving.weights``'s name walk maps a port module to its
path. Eligible: convolutions with groups == 1 (not the fire modules'
depthwise 3x3) and the hourglass unpools. Calibration records every eligible
conv, the 3-channel stem included; ``quantize_model`` leaves in float a conv
with fewer than ``min_in_features`` input channels (the stem), one with no
scale or a scale <= 0, and one that ``skip(path)`` holds: by default
(``default_skip``) every conv inside the hourglasses.

Calibration runs eagerly, on forward pre-hooks: the port has no traced mode
to refuse, so the JAX package's check against a jitted calibration has no
counterpart here.
"""

from __future__ import annotations

import contextlib
import copy
import math
import os
from typing import Callable, Dict, Iterable, Optional

import torch
from torch import nn

from object_keypoints_tpu_torch.models.blocks import StemConvBlock
from object_keypoints_tpu_torch.ops.int8_conv import (
    ALIGN,
    int8_conv2d,
    int8_conv_transpose2d,
    pack_conv2d_weight,
    pack_conv_transpose2d_weight,
    quantize,
    unpack_conv2d_weight,
    unpack_conv_transpose2d_weight,
)
from object_keypoints_tpu_torch.serving.weights import conv_module_paths
from object_keypoints_tpu_torch.utils import timer

QUANT_NAME = "quant.json"

# Producer module path -> calibration key of the consumer conv that sets the
# handoff scale (the JAX package's table): pre_conv's output is consumed only
# by pre_res1's Conv_0 and Conv_2, pre_res1's only by pre_res2's.
STEM_HANDOFFS = {
    "backbone/pre_conv": "backbone/pre_res1/Conv_0",
    "backbone/pre_res1": "backbone/pre_res2/Conv_0",
}

# The JAX package's default placement: every conv outside the hourglasses
# runs int8. Override with OKT_INT8_SKIP=<comma-separated path substrings>
# (the empty string quantizes everything).
DEFAULT_SKIP_SUBSTRINGS = ("/hg_",)


def default_skip() -> Optional[Callable[[str], bool]]:
    """The default skip predicate (``DEFAULT_SKIP_SUBSTRINGS``, or
    ``OKT_INT8_SKIP`` where it is set); None quantizes every eligible conv."""
    env = os.environ.get("OKT_INT8_SKIP")
    subs = tuple(s for s in env.split(",") if s) if env is not None else DEFAULT_SKIP_SUBSTRINGS
    if not subs:
        return None
    return lambda path: any(s in path for s in subs)


def _default_handoffs() -> Dict[str, str]:
    """Off unless opted in by OKT_INT8_HANDOFF=1, as in the JAX package."""
    if os.environ.get("OKT_INT8_HANDOFF", "0") == "1":
        return STEM_HANDOFFS
    return {}


def conv_paths(model) -> Dict[str, str]:
    """Port module name -> flax path of every eligible conv of ``model``, a
    KeypointNet: groups == 1 convolutions and the ConvTranspose unpools."""
    bb = model.backbone
    return {name: path
            for name, (path, kind) in conv_module_paths(bb.stacks, bb.levels, bb.mods).items()
            if kind == "conv_t" or model.get_submodule(name).groups == 1}


def _parent(name: str):
    parent, _, child = name.rpartition(".")
    return parent, child


def _input_module(model, name: str):
    """The module whose forward takes conv ``name``'s input: the conv, or
    the StemConvBlock around it, whose eval forward hands the conv's weight
    to the stem kernel and never calls the conv."""
    parent = model.get_submodule(_parent(name)[0])
    return parent if isinstance(parent, StemConvBlock) else model.get_submodule(name)


def linear_percentile(x, q: float, dim: Optional[int] = None):
    """numpy's default ("linear") percentile ``q`` of float ``x`` along
    ``dim`` (all of it when None), from the two neighbouring order
    statistics (``torch.kthvalue``; ``torch.quantile`` refuses inputs above
    2^24 elements), interpolated in float64; float32 out."""
    if dim is None:
        x, dim = x.reshape(-1), 0
    n = x.shape[dim]
    index = q / 100.0 * (n - 1)
    lo = min(int(math.floor(index)), n - 1)
    frac = index - lo
    low = torch.kthvalue(x, lo + 1, dim=dim).values.double()
    if frac == 0.0:
        return low.float()
    high = torch.kthvalue(x, min(lo + 2, n), dim=dim).values.double()
    return (low * (1.0 - frac) + high * frac).float()


def _reduce(x, q: Optional[float], per_channel: bool):
    """One batch's scale of a conv input x (N, C, H, W): max |x|, or its
    percentile ``q``; per input channel or per tensor."""
    x = x.detach().float().abs()
    if per_channel:
        flat = x.transpose(0, 1).reshape(x.shape[1], -1)
        return flat.amax(dim=1) if q is None else linear_percentile(flat, q, dim=1)
    return x.amax() if q is None else linear_percentile(x, q)


@contextlib.contextmanager
def collect_activation_scales(model, stats: Dict[str, torch.Tensor],
                              percentile: Optional[float] = None, per_channel: bool = False):
    """Context: while it is open, each forward of ``model`` folds every
    eligible conv's input scale into ``stats`` (flax path -> tensor, on the
    input's device): the max over batches of each batch's max |x|, or of its
    ``percentile`` of |x| (the max of per-batch percentiles, as in the JAX
    package), per tensor or, with ``per_channel``, per input channel."""

    def hook(path):
        def pre_hook(module, args):
            value = _reduce(args[0], percentile, per_channel)
            prev = stats.get(path)
            stats[path] = value if prev is None else torch.maximum(prev, value)
        return pre_hook

    handles = [_input_module(model, name).register_forward_pre_hook(hook(path))
               for name, path in conv_paths(model).items()]
    try:
        yield
    finally:
        for handle in handles:
            handle.remove()


def calibrate_activation_scales(model, apply_fn: Callable, batches: Iterable,
                                percentile: Optional[float] = None,
                                per_channel: bool = False) -> Dict:
    """Run ``apply_fn(batch)`` (a forward of ``model``) over the calibration
    batches and return each eligible conv's input scale keyed by flax module
    path: a float per conv, or a list of per-input-channel floats with
    ``per_channel``. One copy to the host at the end."""
    stats: Dict[str, torch.Tensor] = {}
    with collect_activation_scales(model, stats, percentile, per_channel), torch.inference_mode():
        for batch in batches:
            apply_fn(batch)
    if not stats:
        return {}
    keys = list(stats)
    if per_channel:
        flat = torch.cat([stats[k] for k in keys]).tolist()
        out, at = {}, 0
        for k in keys:
            out[k] = flat[at:at + stats[k].numel()]
            at += stats[k].numel()
        return out
    return dict(zip(keys, torch.stack([stats[k] for k in keys]).tolist()))


def _per_channel(scale) -> bool:
    return isinstance(scale, (list, tuple))


def int8_weights(weight, scale, transpose: bool):
    """A conv's int8 form for activation scale ``scale``: (packed int8
    weights for ops.int8_conv, the float32 rescale per output channel,
    1 / s_in as a Python float or a float32 (C,) tensor). The arithmetic is
    the JAX package's, op for op, in float32: a Python ``s_in`` meets float32
    tensors rounded to float32, as JAX's weak type does."""
    w = weight.detach().float()
    in_axis, out_axis = (0, 1) if transpose else (1, 0)
    if _per_channel(scale):
        s_in = torch.tensor(scale, dtype=torch.float32, device=w.device).clamp(min=1e-12) / 127.0
        w = w * s_in.view([-1 if d == in_axis else 1 for d in range(4)])
        inv = 1.0 / s_in
    else:
        s_in = scale / 127.0
        inv = 1.0 / s_in
    s_w = w.abs().amax(dim=[d for d in range(4) if d != out_axis]) / 127.0
    s_w = s_w.clamp(min=1e-12)
    wq = torch.round(w / s_w.view([-1 if d == out_axis else 1 for d in range(4)]))
    wq = wq.clamp_(-127, 127).to(torch.int8)
    rescale = s_w if _per_channel(scale) else torch.tensor(s_in, dtype=torch.float32,
                                                             device=w.device) * s_w
    pack = pack_conv_transpose2d_weight if transpose else pack_conv2d_weight
    return pack(wq), rescale, inv


class QuantizedActivation:
    """A producer's output quantized once for its consumers (the stem
    handoff): ``q`` (N, H, W, C) int8 at ``scale`` (the calibrated max-abs),
    ``dtype`` the compute dtype it stands for."""

    __slots__ = ("q", "scale", "dtype")

    def __init__(self, q, scale: float, dtype):
        self.q, self.scale, self.dtype = q, scale, dtype

    def dequantize(self):
        """(N, C, H, W) channels_last in ``dtype``: q * (scale / 127)."""
        return (self.q.float() * (self.scale / 127.0)).to(self.dtype).permute(0, 3, 1, 2)


class Int8Conv(nn.Module):
    """An eligible ``Conv2d`` (square kernel, stride and padding, groups 1)
    or ``ConvTranspose2d`` (4x4, stride 2, padding 1) run int8 at activation
    scale ``scale``. It shares the float module's ``weight`` and ``bias``
    parameters (its state_dict entries stay the same); its int8 weights and
    rescale are non-persistent buffers made here, once, from the weight as
    it is now. Input: an (N, C, H, W) tensor, or a ``QuantizedActivation``;
    output: (N, O, Ho, Wo) channels_last in the input's compute dtype.
    Spans (``utils.timer``): ``int8.quantize`` over the input's quantize,
    ``int8.rescale`` over the output's pass (the rescale, the bias, the cast
    back and the permute); weights quantized again for a
    ``QuantizedActivation`` at another scale count in ``weights.built``."""

    def __init__(self, conv, scale, path: str = ""):
        super().__init__()
        self.transpose = isinstance(conv, nn.ConvTranspose2d)
        k, s, p = conv.kernel_size[0], conv.stride[0], conv.padding[0]
        square = conv.kernel_size == (k, k) and conv.stride == (s, s) and conv.padding == (p, p)
        plain = conv.groups == 1 and conv.dilation == (1, 1)
        if self.transpose:
            plain = plain and (k, s, p) == (4, 2, 1) and conv.output_padding == (0, 0)
        if not (square and plain):
            raise ValueError(f"Int8Conv {path!r}: no int8 route for {conv}")
        self.path, self.scale, self.groups = path, scale, 1
        self.kernel_size, self.stride, self.padding = k, s, p
        self.in_channels, self.out_channels = conv.in_channels, conv.out_channels
        self.weight, self.bias = conv.weight, conv.bias
        packed, rescale, inv = int8_weights(conv.weight, scale, self.transpose)
        self.register_buffer("packed", packed, persistent=False)
        self.register_buffer("rescale", rescale, persistent=False)
        if isinstance(inv, torch.Tensor):
            self.register_buffer("in_scale_inv", inv, persistent=False)
        else:
            self.in_scale_inv = inv

    def output_shard(self, index: int, count: int) -> "Int8Conv":
        """Output channels [index * o, (index + 1) * o) of this conv, o =
        out / count (the mesh's ``model`` axis), as an Int8Conv of their
        own: the packed int8 weights, the per-output-channel rescale, the
        bias and the float weight sliced. Each channel keeps the codes and
        the scale that the whole conv made from the whole weight, and the
        input's scale is the whole conv's. o must be a multiple of 8, the
        int8 GEMM's width rule."""
        o = self.out_channels // count
        if self.out_channels % count or o % ALIGN:
            raise ValueError(f"Int8Conv {self.path!r}: {self.out_channels} output channels do not "
                             f"split into {count} shards of a multiple of {ALIGN}")
        lo = index * o
        shard = Int8Conv.__new__(Int8Conv)
        nn.Module.__init__(shard)
        for name in ("transpose", "path", "scale", "groups", "kernel_size", "stride", "padding",
                     "in_channels"):
            setattr(shard, name, getattr(self, name))
        shard.out_channels = o

        def part(t, dim=0):
            return nn.Parameter(t.detach().narrow(dim, lo, o).clone(), requires_grad=t.requires_grad)

        shard.weight = part(self.weight, 1 if self.transpose else 0)
        shard.bias = None if self.bias is None else part(self.bias)
        packed = self.packed[:, lo:lo + o] if self.transpose else self.packed[lo:lo + o]
        shard.register_buffer("packed", packed.contiguous(), persistent=False)
        shard.register_buffer("rescale", self.rescale[lo:lo + o].clone(), persistent=False)
        if "in_scale_inv" in self._buffers:
            shard.register_buffer("in_scale_inv", self.in_scale_inv, persistent=False)
        else:
            shard.in_scale_inv = self.in_scale_inv
        return shard

    def int8_weight(self):
        """The int8 weight in the float module's layout."""
        if self.transpose:
            return unpack_conv_transpose2d_weight(self.packed, self.out_channels, self.in_channels)
        return unpack_conv2d_weight(self.packed, self.out_channels, self.in_channels,
                                    self.kernel_size)

    def forward(self, x):
        packed, rescale = self.packed, self.rescale
        if isinstance(x, QuantizedActivation):
            xq, dtype = x.q, x.dtype
            if x.scale != self.scale:  # quantized at its producer's scale, per tensor
                packed, rescale, _ = int8_weights(self.weight, x.scale, self.transpose)
                timer.count("weights.built")
        else:
            with timer.span("int8.quantize"):
                xq, dtype = quantize(x, self.in_scale_inv), x.dtype
        if self.transpose:
            acc = int8_conv_transpose2d(xq, packed, self.out_channels)
        else:
            acc = int8_conv2d(xq, packed, self.out_channels, self.kernel_size, self.stride,
                              self.padding)
        with timer.span("int8.rescale"):
            y = acc.float() * rescale
            if self.bias is not None:
                y = y + self.bias.float()
            return y.to(dtype).permute(0, 3, 1, 2)


def _handoff_hook(scale: float):
    inv = 1.0 / (scale / 127.0)

    def hook(module, args, y):
        with timer.span("int8.quantize"):
            return QuantizedActivation(quantize(y, inv), scale, y.dtype)
    return hook


def _dequantize_hook(module, args):
    if args and isinstance(args[0], QuantizedActivation):
        return (args[0].dequantize(), *args[1:])
    return None


def _install_handoffs(model, scales: Dict, handoffs: Dict[str, str], paths: Dict[str, str]):
    """Each producer's output leaves it quantized at its consumer's scale;
    an Int8Conv takes it as it is, another producer passes it on to its
    convs, and any other module dequantizes it first (the JAX package's
    rules)."""
    names = {path: name for name, path in paths.items()}
    producers = set()
    for producer, consumer_key in handoffs.items():
        scale = scales.get(consumer_key)
        if scale is None or _per_channel(scale):
            continue
        module = model.get_submodule(_parent(names[f"{producer}/Conv_0"])[0])
        module.register_forward_hook(_handoff_hook(scale))
        producers.add(id(module))
    if not producers:
        return
    containers = (Int8Conv, nn.Sequential, nn.ModuleList, nn.ModuleDict)
    for module in model.modules():
        if id(module) not in producers and not isinstance(module, containers):
            module.register_forward_pre_hook(_dequantize_hook)


def quantize_model(model, scales: Dict, min_in_features: int = 16,
                   skip: Optional[Callable[[str], bool]] = None,
                   handoffs: Optional[Dict[str, str]] = None):
    """Swap, in place, every eligible conv of ``model`` (a KeypointNet) that
    has a positive scale in ``scales``, at least ``min_in_features`` input
    channels, and a path that ``skip`` does not hold for an ``Int8Conv``;
    returns ``model``. ``skip=None`` applies ``default_skip()`` (pass
    ``lambda path: False`` to quantize every eligible conv); ``handoffs``
    ({producer path: consumer key}) defaults to ``STEM_HANDOFFS`` under
    OKT_INT8_HANDOFF=1, else none. Run it after the weights are loaded and,
    to make the int8 weights there, after the model is on its device."""
    if skip is None:
        skip = default_skip()
    if handoffs is None:
        handoffs = _default_handoffs()
    paths = conv_paths(model)
    for name, path in paths.items():
        conv, scale = model.get_submodule(name), scales.get(path)
        transpose = isinstance(conv, nn.ConvTranspose2d)
        if (scale is None or (max(scale) if _per_channel(scale) else scale) <= 0.0
                or (skip is not None and skip(path))
                or conv.weight.shape[0 if transpose else 1] < min_in_features):
            continue
        parent, child = _parent(name)
        if isinstance(model.get_submodule(parent), StemConvBlock):
            raise ValueError(f"{path}: the stem runs the stem kernel and is not quantized; "
                             "keep min_in_features above its 3 input channels")
        setattr(model.get_submodule(parent), child, Int8Conv(conv, scale, path))
    _install_handoffs(model, scales, handoffs, paths)
    return model


def quantized_apply(model, scales: Dict, x, min_in_features: int = 16,
                    skip: Optional[Callable[[str], bool]] = None,
                    handoffs: Optional[Dict[str, str]] = None, **kwargs):
    """``model(x, **kwargs)`` with the eligible convs run int8, on a copy of
    ``model`` (left as it is), in inference mode; the counterpart of the JAX
    package's ``quantized_apply``."""
    quantized = quantize_model(copy.deepcopy(model), scales, min_in_features, skip, handoffs)
    with torch.inference_mode():
        return quantized(x, **kwargs)
