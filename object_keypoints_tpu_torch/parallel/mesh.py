"""Process groups, the (data, model) grid, the sharding rule and the
collectives.

Counterpart of ``object_keypoints_tpu/parallel/mesh.py``. The JAX package
runs one SPMD program over a device mesh of two axes: ``data`` shards the
batch, ``model`` shards the output channels of wide conv kernels; XLA
inserts the gradient reduction, the global BatchNorm statistics and the
collectives of the channel split. The port runs one process per card (the
reference's ``torch.distributed`` + NCCL, its corner_net_lite/train.py:37-44,
193-247):

- ``initialize_distributed`` starts the process group from the JAX
  package's launch contract (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``,
  ``PROCESS_ID``);
- ``create_mesh(devices, model_parallel=m)`` lays the devices out in the JAX
  package's row-major (data, model) grid: device ``r`` at ``(r // m, r % m)``.
  Inside a process group the grid's devices are its ranks, and at ``m > 1``
  it also builds one model group per data row and one data group per model
  column; without a grid the data group is the whole group;
- ``models.blocks.BatchNorm2d`` sums its statistics over the data group
  (``all_reduce_autograd``) whenever a group is initialized;
- ``training.trainer`` averages the gradients over the data group in one
  all-reduce a step (``all_reduce_``);
- ``_param_spec`` is the JAX package's rule for the ``model`` axis, on flax
  paths and flax shapes; ``parallel.tensor.shard_params`` applies it to a
  port model.

The collectives are ``all_reduce``, ``all_gather`` and ``broadcast``: gloo
runs them on CUDA tensors too, so several ranks can share one card. Each
helper here counts its calls and bytes in ``COLLECTIVES``.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# the JAX package's launch contract (its parallel/mesh.py:24-52)
CONTRACT_ERROR = ("NUM_PROCESSES is set but PROCESS_ID is not; a manual multi-process launch "
                  "needs COORDINATOR_ADDRESS, NUM_PROCESSES and PROCESS_ID (one unique id per "
                  "process)")
WIDE = 256  # the rule's least output width (the JAX package's _param_spec)

# calls and bytes of each collective this process made through the helpers here
COLLECTIVES: collections.Counter = collections.Counter()


def is_distributed() -> bool:
    """Whether this process belongs to an initialized process group."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


@dataclasses.dataclass(frozen=True)
class _Grid:
    """This rank's subgroups of a (data, model) grid over the process group."""

    model_parallel: int
    data_group: object  # this rank's model column
    model_group: object  # this rank's data row


_grid: Optional[_Grid] = None  # set by create_mesh inside a process group


def model_size() -> int:
    """The ``model`` axis's size: 1 without a grid."""
    return _grid.model_parallel if _grid is not None else 1


def data_size() -> int:
    """The ``data`` axis's size: the world size without a grid."""
    return world_size() // model_size()


def data_rank() -> int:
    """This rank's row of the grid: its slice of the batch."""
    return rank() // model_size()


def model_rank() -> int:
    """This rank's column of the grid: its slice of each wide kernel."""
    return rank() % model_size()


def data_group():
    """This rank's data group (its model column), or None, the whole group."""
    return _grid.data_group if _grid is not None else None


def model_group():
    """This rank's model group (its data row); None without a grid."""
    return _grid.model_group if _grid is not None else None


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
    """Leave the process group, if this process is in one, and its grid."""
    global _grid
    _grid = None
    if is_distributed():
        dist.destroy_process_group()


class Mesh(tuple):
    """The devices of a (data, model) grid, flattened row-major: device
    ``r`` sits at ``(r // model_parallel, r % model_parallel)``, as in the
    JAX package's ``np.array(devices).reshape(n // m, m)``. A tuple of
    ``torch.device``s, so a data-only mesh is the tuple of its devices."""

    def __new__(cls, devices: Sequence[torch.device], model_parallel: int = 1):
        mesh = super().__new__(cls, devices)
        mesh.model_parallel = model_parallel
        return mesh

    @property
    def shape(self) -> dict:
        """The axes' sizes, as the JAX ``Mesh.shape``."""
        return {"data": len(self) // self.model_parallel, "model": self.model_parallel}

    @property
    def rows(self) -> list:
        """The data rows, each the ``model_parallel`` devices of one replica."""
        m = self.model_parallel
        return [tuple(self[i:i + m]) for i in range(0, len(self), m)]


def device_mesh(devices: Optional[Sequence] = None, model_parallel: int = 1) -> Mesh:
    """The (data, model) grid of ``devices`` in one process (no process
    group is touched): by default every visible CUDA device, raising where
    there is none. A device count that ``model_parallel`` does not divide
    raises the JAX package's ``ValueError``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("create_mesh: no devices given and CUDA is not available; pass "
                               "devices (for example ['cpu'] * 8) to use the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("create_mesh: no devices")
    if len(devices) % model_parallel:
        raise ValueError(f"{len(devices)} devices not divisible by model_parallel={model_parallel}")
    return Mesh(devices, model_parallel)


def create_mesh(devices: Optional[Sequence] = None, model_parallel: int = 1) -> Mesh:
    """The (data, model) grid (``device_mesh``). Inside a process group at
    ``model_parallel > 1`` the grid's devices are the group's ranks, one
    each (by default rank r's card, ``cuda:(r % device_count)``, as
    ``initialize_distributed`` places it), and every rank builds one model
    group per data row and one data group per model column, all of them in
    the same order, and keeps its own two: BatchNorm, the trainer's
    reductions and ``parallel.tensor`` then use them. Every rank calls it,
    once."""
    global _grid
    if not is_distributed() or model_parallel == 1:
        return device_mesh(devices, model_parallel)
    world, me = world_size(), rank()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("create_mesh: no devices given and CUDA is not available; pass "
                               "each rank's device (for example ['cpu'] * world)")
        devices = [f"cuda:{r % torch.cuda.device_count()}" for r in range(world)]
    mesh = device_mesh(devices, model_parallel)
    if len(mesh) != world:
        raise ValueError(f"create_mesh: {len(mesh)} devices for a process group of {world} ranks")
    m, rows = model_parallel, world // model_parallel
    model_groups = [dist.new_group([i * m + j for j in range(m)]) for i in range(rows)]
    data_groups = [dist.new_group([i * m + j for i in range(rows)]) for j in range(m)]
    _grid = _Grid(m, data_groups[me % m], model_groups[me // m])
    return mesh


def batch_sharding(batch, index: Optional[int] = None, count: Optional[int] = None):
    """Slice ``index`` of ``count`` equal slices of ``batch``'s leading axis
    (an array, a tensor, or a dict of them): by default this rank's data
    row's slice of the data axis's. A batch the count does not divide
    raises ``ValueError``."""
    index = data_rank() if index is None else index
    count = data_size() if count is None else count
    if isinstance(batch, dict):
        return {k: batch_sharding(v, index, count) for k, v in batch.items()}
    n = len(batch)
    if n % count:
        raise ValueError(f"batch of {n} not divisible by {count} shards")
    size = n // count
    return batch[index * size:(index + 1) * size]


# --- the rule of the model axis ------------------------------------------------------------


def _param_spec(path: str, shape: Sequence[int], model_axis_size: int) -> tuple:
    """The JAX package's rule for one parameter, on its flax path and flax
    shape: a conv kernel (H, W, Cin, Cout) with Cout >= 256 and divisible by
    the ``model`` axis is sharded on Cout; everything else (biases,
    BatchNorm, narrow kernels) is replicated. The PartitionSpec as a tuple:
    ``(None, None, None, "model")`` or ``()``."""
    if model_axis_size <= 1:
        return ()
    if len(shape) == 4 and shape[-1] >= WIDE and shape[-1] % model_axis_size == 0:
        return (None, None, None, "model")
    return ()


def _flax_params(model):
    """(keystr, flax shape) of every flax parameter of an unsharded port
    KeypointNet, through ``serving.weights``'s name walk."""
    from object_keypoints_tpu_torch.serving.weights import keypoint_net_param_shapes

    bb = model.backbone
    shapes = keypoint_net_param_shapes(model.state_dict(), bb.stacks, bb.levels, bb.mods)
    return [("".join(f"[{p!r}]" for p in path), shape) for path, shape in shapes.items()]


def param_specs(model, mesh: Mesh) -> dict:
    """flax keystr (``jax.tree_util.keystr`` of the params tree) -> the
    PartitionSpec tuple that the JAX package's ``param_specs`` gives, for
    every parameter of an unsharded port KeypointNet."""
    return {path: _param_spec(path, shape, mesh.model_parallel)
            for path, shape in _flax_params(model)}


def model_sharded_paths(model, mesh: Mesh) -> list:
    """The sorted keystr paths of every parameter that the rule shards over
    ``model``: the JAX package's ``model_sharded_paths`` of the same
    model's params."""
    return sorted(path for path, spec in param_specs(model, mesh).items() if spec)


# --- collectives ---------------------------------------------------------------------------


def _count(kind: str, tensor: torch.Tensor) -> None:
    COLLECTIVES[kind] += 1
    COLLECTIVES[f"{kind}_bytes"] += tensor.numel() * tensor.element_size()


def all_reduce(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """``tensor`` (contiguous) summed over ``group`` (None: the whole
    group), in place; returns it."""
    _count("all_reduce", tensor)
    dist.all_reduce(tensor, group=group)
    return tensor


def all_gather(tensor: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``tensor``s (contiguous, one shape) concatenated along
    ``dim`` in their group rank order."""
    _count("all_gather", tensor)
    parts = [torch.empty_like(tensor) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, tensor, group=group)
    return torch.cat(parts, dim)


def all_reduce_(tensors: Sequence[torch.Tensor], mean: Sequence[bool], group=None) -> None:
    """Sum each tensor over ``group`` (None: the whole group) in place, in
    one all-reduce of their concatenation (one dtype); those with ``mean``
    set are then divided by the group's size. Tensors of any memory layout
    come back in their own."""
    flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors]), group)
    size = dist.get_world_size(group)
    for t, chunk, average in zip(tensors, flat.split([t.numel() for t in tensors]), mean):
        chunk = chunk.view(t.shape)
        t.copy_(chunk / size if average else chunk)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        return all_reduce(tensor.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_autograd(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``tensor`` over ``group`` (None: the whole group),
    differentiable: the backward sums the incoming gradients over it."""
    return _AllReduceSum.apply(tensor, group)


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` in place with rank ``src``'s."""
    with torch.no_grad():
        for t in tensors:
            buf = t if t.is_contiguous() else t.contiguous()
            _count("broadcast", buf)
            dist.broadcast(buf, src)
            if buf is not t:
                t.copy_(buf)
