"""Serving over several devices: the inference contract with the batch split
across replicas.

Counterpart of ``object_keypoints_tpu/serving/sharded.py``, which runs one
jitted SPMD program with the batch sharded over a mesh's ``data`` axis. The
port runs in one process too: one eval-mode replica of the model a device
(``serving.export.make_inference_fn``, so on a card each replica's stem runs
the CUDA stem kernel), the batch split evenly over them, the replicas
launched back to back without waiting for any card, and the outputs
gathered in order onto the first device. Only the ``data`` axis is ported
(``parallel.create_mesh``).
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import torch

from object_keypoints_tpu_torch.parallel import batch_sharding, create_mesh
from object_keypoints_tpu_torch.serving.export import load_served_model, make_inference_fn


def make_sharded_inference_fn(model, devices: Optional[Sequence] = None, dtype=torch.float32,
                              quant_scales: Optional[dict] = None):
    """``make_inference_fn``'s contract (NCHW frames in; sigmoid heatmaps,
    depth and centers of the last stack out, float32) with the batch split
    evenly over ``devices``: every visible CUDA device by default, raising
    where there is none (pass devices, e.g. ``["cpu"] * 8``, for the CPU).
    A batch the device count does not divide raises ``ValueError``. Each
    device serves its own copy of ``model``; ``model`` is left as it is."""
    devices = create_mesh(devices)
    replicas = [make_inference_fn(copy.deepcopy(model), dtype=dtype, device=d,
                                  quant_scales=quant_scales) for d in devices]

    def infer(frames):
        x = torch.as_tensor(frames)
        if len(x) % len(devices):
            raise ValueError(f"batch of {len(x)} frames not divisible by {len(devices)} devices")
        if x.device.type == "cpu" and any(d.type == "cuda" for d in devices):
            x = x.pin_memory()  # host -> card copies that do not wait
        outs = []
        for i, (replica, device) in enumerate(zip(replicas, devices)):
            shard = batch_sharding(x, i, len(devices)).to(device, non_blocking=True)
            outs.append(replica(shard))
        first = devices[0]
        return tuple(torch.cat([o[j].to(first, non_blocking=True) for o in outs])
                     for j in range(3))

    return infer


def load_sharded_inference_fn(path: str, devices: Optional[Sequence] = None, dtype=torch.float32,
                              quantize: str = "auto"):
    """An artifact directory -> ``make_sharded_inference_fn``
    (``load_inference_fn``'s twin, with its quantize modes)."""
    model, scales = load_served_model(path, quantize)
    return make_sharded_inference_fn(model, devices=devices, dtype=dtype, quant_scales=scales)
