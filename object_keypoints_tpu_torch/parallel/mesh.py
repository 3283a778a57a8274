"""Process groups, data devices and the collectives of data parallelism.

Counterpart of ``object_keypoints_tpu/parallel/mesh.py``. The JAX package
runs one SPMD program over a device mesh whose ``data`` axis shards the
batch; XLA inserts the gradient reduction and the global BatchNorm
statistics. The port runs one process per card (the reference's
``torch.distributed`` + NCCL, its corner_net_lite/train.py:37-44, 193-247):

- ``initialize_distributed`` starts the process group from the JAX
  package's launch contract (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``,
  ``PROCESS_ID``);
- ``models.blocks.BatchNorm2d`` sums its statistics over the group
  (``all_reduce_autograd``) whenever one is initialized;
- ``training.trainer`` averages the gradients in one all-reduce a step
  (``all_reduce_``).

The collectives are ``all_reduce`` and ``broadcast`` only: gloo runs both on
CUDA tensors too, so two ranks can share one card. The ``model`` axis
(channel sharding of wide kernels, the JAX package's ``shard_params``) is
not ported: ``create_mesh(model_parallel > 1)`` raises.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# the JAX package's launch contract (its parallel/mesh.py:24-52)
CONTRACT_ERROR = ("NUM_PROCESSES is set but PROCESS_ID is not; a manual multi-process launch "
                  "needs COORDINATOR_ADDRESS, NUM_PROCESSES and PROCESS_ID (one unique id per "
                  "process)")


def is_distributed() -> bool:
    """Whether this process belongs to an initialized process group."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def initialize_distributed(backend: Optional[str] = None, device="cuda",
                           timeout: Optional[float] = None) -> Optional[torch.device]:
    """Join the process group that ``COORDINATOR_ADDRESS`` (host:port),
    ``NUM_PROCESSES`` and ``PROCESS_ID`` describe, and return this rank's
    device: ``cuda:(rank % device_count)`` (made the current device), or the
    CPU where ``device="cpu"``. With ``COORDINATOR_ADDRESS`` unset it does
    nothing and returns None. ``NUM_PROCESSES`` without ``PROCESS_ID``
    raises the JAX package's ``ValueError``; without ``NUM_PROCESSES`` the
    group has one process. The backend is NCCL on the card and gloo on the
    CPU unless ``backend`` names one; ``timeout`` (seconds) bounds every
    collective and the rendezvous. Raises where the card is asked for and
    there is none."""
    addr = os.environ.get("COORDINATOR_ADDRESS")
    if not addr:
        return None
    world, process = 1, 0
    if os.environ.get("NUM_PROCESSES"):
        if "PROCESS_ID" not in os.environ:
            raise ValueError(CONTRACT_ERROR)
        world, process = int(os.environ["NUM_PROCESSES"]), int(os.environ["PROCESS_ID"])
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed: the card is asked for, but CUDA is not "
                               "available; pass device='cpu' to train on the CPU")
        device = torch.device("cuda", process % torch.cuda.device_count())
        torch.cuda.set_device(device)
    kwargs = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                            init_method=f"tcp://{addr}", world_size=world, rank=process, **kwargs)
    return device


def destroy_distributed() -> None:
    """Leave the process group, if this process is in one."""
    if is_distributed():
        dist.destroy_process_group()


def create_mesh(devices: Optional[Sequence] = None, model_parallel: int = 1) -> tuple:
    """The data devices: ``devices`` as ``torch.device``s, by default every
    visible CUDA device (raising where there is none). Only the ``data``
    axis is ported: ``model_parallel > 1`` raises."""
    if model_parallel != 1:
        raise NotImplementedError(
            f"model_parallel={model_parallel}: the model axis (channel sharding of wide conv "
            "kernels) is not ported; ROADMAP.md section 1 queues it. The port is data-parallel "
            "only (model_parallel=1)")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("create_mesh: no devices given and CUDA is not available; pass "
                               "devices (for example ['cpu'] * 8) to use the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("create_mesh: no devices")
    return devices


def batch_sharding(batch, index: Optional[int] = None, count: Optional[int] = None):
    """Slice ``index`` of ``count`` equal slices of ``batch``'s leading axis
    (an array, a tensor, or a dict of them): by default this rank's slice of
    the group's. A batch the count does not divide raises ``ValueError``."""
    index = rank() if index is None else index
    count = world_size() if count is None else count
    if isinstance(batch, dict):
        return {k: batch_sharding(v, index, count) for k, v in batch.items()}
    n = len(batch)
    if n % count:
        raise ValueError(f"batch of {n} not divisible by {count} shards")
    size = n // count
    return batch[index * size:(index + 1) * size]


def all_reduce_(tensors: Sequence[torch.Tensor], mean: Sequence[bool]) -> None:
    """Sum each tensor over the group in place, in one all-reduce of their
    concatenation (one dtype); those with ``mean`` set are then divided by
    the world size. Tensors of any memory layout come back in their own."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    world = world_size()
    for t, chunk, average in zip(tensors, flat.split([t.numel() for t in tensors]), mean):
        chunk = chunk.view(t.shape)
        t.copy_(chunk / world if average else chunk)


def all_reduce_autograd(tensor: torch.Tensor) -> torch.Tensor:
    """The sum of ``tensor`` over the group, differentiable: the backward
    sums the incoming gradients over the group."""
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(tensor)


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` in place with rank ``src``'s."""
    with torch.no_grad():
        for t in tensors:
            buf = t if t.is_contiguous() else t.contiguous()
            dist.broadcast(buf, src)
            if buf is not t:
                t.copy_(buf)
