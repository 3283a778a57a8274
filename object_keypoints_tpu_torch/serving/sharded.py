"""Serving over several devices: the inference contract with the batch split
across the data rows of a (data, model) grid and the wide convs split
across the devices of a row.

Counterpart of ``object_keypoints_tpu/serving/sharded.py``, which runs one
jitted SPMD program with the batch sharded over a mesh's ``data`` axis and
the wide conv kernels over its ``model`` axis (``parallel.mesh``'s rule).
The port runs in one process too: one eval-mode replica of the model a data
row (``serving.export.make_inference_fn`` on the row's first device, so on
a card each replica's stem runs the CUDA stem kernel); at ``model_parallel
> 1`` each wide conv of a replica holds its output-channel shards on the
row's devices (``DeviceShardedConv``), float or int8, and their outputs are
concatenated on the row's first device. The batch is split evenly over the
rows, the replicas launched back to back without waiting for any card, and
the outputs gathered in order onto the grid's first device.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import torch
from torch import nn

from object_keypoints_tpu_torch.parallel import batch_sharding, device_mesh, wide_convs
from object_keypoints_tpu_torch.parallel.tensor import shard_in_channels, weight_shard
from object_keypoints_tpu_torch.serving.export import load_served_model, make_inference_fn
from object_keypoints_tpu_torch.serving.quantize import Int8Conv, QuantizedActivation


def conv_shard(conv, index: int, count: int):
    """Output channels [index * c, (index + 1) * c) of a float conv (c = out
    / count) as a conv of its own kind with its slice of the bias; a grouped
    conv keeps its share of the groups and reads their input channels."""
    shard = copy.deepcopy(conv)
    width = conv.out_channels // count
    shard.weight = nn.Parameter(weight_shard(conv, index, count),
                                requires_grad=conv.weight.requires_grad)
    if conv.bias is not None:
        shard.bias = nn.Parameter(conv.bias.detach()[index * width:(index + 1) * width].clone(),
                                  requires_grad=conv.bias.requires_grad)
    shard.out_channels = width
    in_width = shard_in_channels(conv, count)
    if in_width:
        shard.in_channels, shard.groups = in_width, conv.groups // count
    return shard


class DeviceShardedConv(nn.Module):
    """A wide conv (float or ``Int8Conv``) split by output channel over
    ``devices``, one process: shard k, on ``devices[k]``, computes channels
    [k * c, (k + 1) * c) exactly as the whole conv does (its weight, bias,
    int8 codes and scales are the whole conv's slices). The input goes to
    every shard's device (a grouped conv's shard gets its groups' input
    channels), and the outputs come back to the input's device,
    concatenated in order."""

    def __init__(self, conv, devices: Sequence[torch.device]):
        super().__init__()
        count = len(devices)
        self.devices = tuple(devices)
        if isinstance(conv, Int8Conv):
            self.in_width = None
            shards = [conv.output_shard(k, count) for k in range(count)]
        else:
            self.in_width = shard_in_channels(conv, count)
            shards = [conv_shard(conv, k, count) for k in range(count)]
        self.shards = nn.ModuleList(s.to(d, memory_format=torch.channels_last)
                                    for s, d in zip(shards, self.devices))

    def forward(self, x):
        home = x.q.device if isinstance(x, QuantizedActivation) else x.device
        outs = []
        for k, (shard, device) in enumerate(zip(self.shards, self.devices)):
            if isinstance(x, QuantizedActivation):  # the int8 stem handoff
                part = QuantizedActivation(x.q.to(device, non_blocking=True), x.scale, x.dtype)
            else:
                part = x if self.in_width is None else x[:, k * self.in_width:(k + 1) * self.in_width]
                part = part.to(device, non_blocking=True)
            outs.append(shard(part).to(home, non_blocking=True))
        return torch.cat(outs, 1)


def shard_across_devices(model: nn.Module, devices: Sequence[torch.device]) -> nn.Module:
    """Swap, in place, every wide conv of ``model`` (the ``model`` axis's
    rule, ``parallel.wide_convs``; float or ``Int8Conv``) for a
    ``DeviceShardedConv`` over ``devices``; returns ``model``."""
    for name, conv in wide_convs(model, len(devices), (nn.Conv2d, nn.ConvTranspose2d, Int8Conv)):
        parent, _, child = name.rpartition(".")
        setattr(model.get_submodule(parent), child, DeviceShardedConv(conv, devices))
    return model


def make_sharded_inference_fn(model, devices: Optional[Sequence] = None, dtype=torch.float32,
                              quant_scales: Optional[dict] = None, model_parallel: int = 1):
    """``make_inference_fn``'s contract (NCHW frames in; sigmoid heatmaps,
    depth and centers of the last stack out, float32) over the (data,
    model) grid of ``devices`` (``parallel.device_mesh``): every visible
    CUDA device by default, raising where there is none (pass devices, e.g.
    ``["cpu"] * 8``, for the CPU). Each data row serves its own copy of
    ``model``, its wide convs split over the row's ``model_parallel``
    devices; the batch is split evenly over the rows, and a batch the row
    count does not divide raises ``ValueError``. ``model`` is left as it
    is."""
    mesh = device_mesh(devices, model_parallel)
    rows = mesh.rows
    replicas = []
    for row in rows:
        replica = copy.deepcopy(model)
        replicas.append(make_inference_fn(replica, dtype=dtype, device=row[0],
                                          quant_scales=quant_scales))
        if model_parallel > 1:
            shard_across_devices(replica, row)

    def infer(frames):
        x = torch.as_tensor(frames)
        if len(x) % len(rows):
            raise ValueError(f"batch of {len(x)} frames not divisible by {len(rows)} data rows")
        if x.device.type == "cpu" and any(d.type == "cuda" for d in mesh):
            x = x.pin_memory()  # host -> card copies that do not wait
        outs = [replica(batch_sharding(x, i, len(rows)).to(row[0], non_blocking=True))
                for i, (replica, row) in enumerate(zip(replicas, rows))]
        first = mesh[0]
        return tuple(torch.cat([o[j].to(first, non_blocking=True) for o in outs])
                     for j in range(3))

    return infer


def load_sharded_inference_fn(path: str, devices: Optional[Sequence] = None, dtype=torch.float32,
                              quantize: str = "auto", model_parallel: int = 1):
    """An artifact directory -> ``make_sharded_inference_fn``
    (``load_inference_fn``'s twin, with its quantize modes)."""
    model, scales = load_served_model(path, quantize)
    return make_sharded_inference_fn(model, devices=devices, dtype=dtype, quant_scales=scales,
                                     model_parallel=model_parallel)
