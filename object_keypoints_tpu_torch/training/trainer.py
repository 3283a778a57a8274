"""Train state, AdamW with reduce-on-plateau, and the train / eval steps.

Counterpart of ``object_keypoints_tpu/training/trainer.py`` (the reference's
scripts/train.py:45-117 KeypointModule): AdamW and a plateau schedule on the
train loss, per-stack loss metrics, and a validation metric that is the L1
distance between the last stack's sigmoid heatmap and its target.

- **The optimizer** (``make_optimizer``) is optax's chain
  ``clip_by_global_norm`` (optional) -> ``adamw`` -> ``reduce_on_plateau``
  restated over torch's multi-tensor ``_foreach`` ops, in optax's order of
  operations: one parameter group, weight decay on every parameter (BN
  parameters and biases included: optax's ``adamw`` has no mask), and the
  plateau scale multiplying the whole update, weight decay included. The
  plateau state is updated with this step's (pre-update) loss *before* the
  step's update is scaled, as optax does.
- **A step never waits for the card.** The metrics and the plateau state
  are tensors on the model's device; no ``.item()``, no boolean indexing, no
  host copy. Adam's step count and the plateau's accumulation count are
  known on the host without the device and stay Python ints.
- **Precision** (``precision``): float32 runs with TF32 off; bf16 is bf16
  compute over float32 parameters and BatchNorm. The loss is float32.
- **Batches** are the data layer's dicts, laid out as in the JAX package:
  frame (N, H, W, 3) uint8 or normalized float32, heatmaps and depth (N, h,
  w, K), centers (N, h, w, T, 2). The step permutes them to NCHW views.
- **Randomness** (dropout) comes from an explicit ``torch.Generator`` on
  the model's device.
- **Over a process group** (``parallel``) each rank steps on its data
  row's slice of the global batch: BatchNorm takes the global statistics,
  one all-reduce a step over the data group averages the gradients, and the
  metrics are the JAX global step's: the loss and the heatmap losses the
  mean over the data rows, the depth and center losses (sums over the
  batch, the reference's unnormalized log) their sum. The plateau schedule
  sees the global loss, so every rank keeps the same ``lr_scale`` and the
  same weights. Over a (data, model) grid (``parallel.shard_params``) a
  shard's gradient is its slice of the whole gradient and needs no
  reduction over the model group; a replicated parameter's is the same on
  every rank of a data row. ``grad_norm`` and the clip take the norm of the
  whole gradient: a shard's squares summed over the model group, a
  replicated tensor counted once.

The train state holds the model itself: its parameters and its BatchNorm
running statistics (the JAX state's ``params`` and ``batch_stats``), updated
in place.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from object_keypoints_tpu_torch import parallel
from object_keypoints_tpu_torch.data.scene import normalize_frames
from object_keypoints_tpu_torch.precision import no_tf32
from object_keypoints_tpu_torch.training.losses import keypoint_loss


def prepare_frames(frames: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(N, H, W, 3) frames -> contiguous (N, 3, H, W) in ``dtype``. uint8
    frames are normalized on their device; float frames are taken as
    normalized already."""
    if frames.dtype == torch.uint8:
        frames = normalize_frames(frames)
    return frames.permute(0, 3, 1, 2).to(dtype).contiguous()


@dataclasses.dataclass
class OptState:
    """AdamW's moments and the plateau's state. ``count`` and
    ``plateau_accumulated`` are host ints; the rest are tensors on the
    parameters' device."""

    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    scale: torch.Tensor  # the plateau's multiplier of every update
    best_value: torch.Tensor
    plateau_count: torch.Tensor  # int32
    plateau_accumulated: int
    avg_value: torch.Tensor


class AdamWPlateau:
    """clip_by_global_norm (optional) -> adamw -> reduce_on_plateau, applied
    to the parameters in place. The plateau follows optax 0.2.6's
    ``contrib.reduce_on_plateau`` with its defaults (rtol 1e-4, atol 0, no
    cooldown, min_scale 0): the mean of ``accumulation_size`` losses is
    compared with the best so far; below ``(1 - rtol) * best - atol`` it is
    the new best, else the plateau count rises, and at ``patience`` the
    scale is multiplied by ``factor`` and the count starts again."""

    b1, b2, eps = 0.9, 0.999, 1e-8  # optax.adamw's
    rtol, atol = 1e-4, 0.0  # optax.contrib.reduce_on_plateau's

    def __init__(self, lr: float, weight_decay: float, factor: float, patience: int,
                 accumulation_size: int, grad_clip: Optional[float] = None):
        if not 0.0 < factor < 1.0:
            raise ValueError(f"plateau factor must be in (0, 1), got {factor}")
        self.lr, self.weight_decay = lr, weight_decay
        self.factor, self.patience, self.accumulation_size = factor, patience, accumulation_size
        self.grad_clip = grad_clip

    def init(self, params: List[torch.Tensor]) -> OptState:
        device = params[0].device
        return OptState(
            count=0,
            mu=[torch.zeros_like(p) for p in params],
            nu=[torch.zeros_like(p) for p in params],
            scale=torch.ones((), dtype=params[0].dtype, device=device),
            best_value=torch.full((), float("inf"), device=device),
            plateau_count=torch.zeros((), dtype=torch.int32, device=device),
            plateau_accumulated=0,
            avg_value=torch.zeros((), device=device),
        )

    def _plateau(self, state: OptState, value: torch.Tensor) -> None:
        count = state.plateau_accumulated
        state.avg_value = (count * state.avg_value + value.float()) / (count + 1)
        state.plateau_accumulated = count + 1
        if state.plateau_accumulated < self.accumulation_size:
            return
        improved = state.avg_value < (1 - self.rtol) * state.best_value - self.atol
        state.best_value = torch.where(improved, state.avg_value, state.best_value)
        count = torch.where(improved, 0, state.plateau_count + 1)
        tripped = count == self.patience
        state.plateau_count = torch.where(tripped, 0, count).to(torch.int32)
        state.scale = torch.where(tripped, state.scale * self.factor, state.scale)
        state.plateau_accumulated = 0
        state.avg_value = torch.zeros_like(state.avg_value)

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor], state: OptState,
             value: torch.Tensor, sharded: Optional[List[bool]] = None) -> None:
        """Update ``params`` in place from ``grads`` and this step's loss;
        ``sharded`` marks the shards of a (data, model) grid, for the clip's
        norm (``global_norm``)."""
        if self.grad_clip:
            norm = global_norm(grads, sharded)
            grads = torch._foreach_mul(grads, torch.where(norm < self.grad_clip, 1.0,
                                                          self.grad_clip / norm))
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - b2)
        state.count += 1
        # u = mu_hat / (sqrt(nu_hat) + eps) + wd * p, then * -lr, then * scale
        update = torch._foreach_div(state.mu, _bias_correction(b1, state.count, params[0].dtype))
        denom = torch._foreach_div(state.nu, _bias_correction(b2, state.count, params[0].dtype))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(update, params, alpha=self.weight_decay)
        torch._foreach_mul_(update, -self.lr)
        self._plateau(state, value)
        torch._foreach_mul_(update, state.scale)
        torch._foreach_add_(params, update)


def _bias_correction(decay: float, count: int, dtype: torch.dtype) -> float:
    """1 - decay ** count, computed in the parameters' float type as optax
    computes it: in float32, 1 - 0.999 is 1e-5 off the exact value, which
    moves Adam's first updates by ~5e-6 of themselves."""
    real = np.float64 if dtype == torch.float64 else np.float32
    return float(real(1.0) - real(decay) ** real(count))


def make_optimizer(lr: float = 4e-3, weight_decay: float = 0.01, plateau_factor: float = 0.1,
                   plateau_patience: int = 10, plateau_accumulation: int = 1,
                   grad_clip: Optional[float] = None) -> AdamWPlateau:
    """AdamW + reduce-on-plateau, the reference's recipe (defaults from its
    scripts/train.py:22-31); ``plateau_accumulation`` losses are averaged
    before each comparison."""
    return AdamWPlateau(lr, weight_decay, plateau_factor, plateau_patience,
                        plateau_accumulation, grad_clip)


def global_norm(tensors: List[torch.Tensor], sharded: Optional[List[bool]] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax's global_norm).
    Where ``sharded`` marks a tensor as this rank's shard of a whole one
    (``parallel.sharded_mask``), it is the norm of the whole tensors: the
    shards' squares summed over the model group, the rest counted once."""
    norms = torch._foreach_norm(tensors)
    if not sharded:
        return torch.linalg.vector_norm(torch.stack(norms))
    shards = torch.stack([n for n, s in zip(norms, sharded) if s]).square().sum().reshape(1)
    total = parallel.all_reduce(shards, parallel.model_group())[0]
    rest = [n for n, s in zip(norms, sharded) if not s]
    if rest:
        total = total + torch.stack(rest).square().sum()
    return total.sqrt()


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm running statistics), the
    optimizer and its state, the compute dtype, the count of steps, and
    which parameters are shards of a (data, model) grid (None: none)."""

    model: torch.nn.Module
    tx: AdamWPlateau
    opt_state: OptState
    dtype: torch.dtype = torch.float32
    step: int = 0
    sharded: Optional[List[bool]] = None

    @property
    def params(self) -> List[torch.Tensor]:
        return list(self.model.parameters())

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def lr_scale(self) -> torch.Tensor:
        """The plateau schedule's current multiplier of the learning rate."""
        return self.opt_state.scale


def create_train_state(model: torch.nn.Module, tx: AdamWPlateau, dtype=torch.float32,
                       device="cuda") -> TrainState:
    """Move ``model`` (in place) to ``device`` and start its optimizer state
    at zero. Training runs on the card unless ``device="cpu"`` is asked for,
    and raises where a CUDA device is asked for and there is none. ``dtype``
    is the compute dtype; the parameters keep theirs (float32 as a
    KeypointNet is made). On the card the weights go channels_last, the
    layout cuDNN's tensor-core convolutions take; on the CPU they stay
    contiguous: torch's CPU backward of a strided 1x1 convolution over a few
    channels_last channels corrupts the heap (torch 2.13, 4 and 8
    channels). A model sharded over a (data, model) grid
    (``parallel.shard_params``) is sharded before this: the optimizer state
    lives on the shards."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"create_train_state: device {str(device)!r} asked for, but CUDA "
                           "is not available; pass device='cpu' to train on the CPU")
    layout = torch.channels_last if device.type == "cuda" else torch.contiguous_format
    model.to(device=device, memory_format=layout)
    return TrainState(model=model, tx=tx, opt_state=tx.init(list(model.parameters())),
                      dtype=dtype, sharded=parallel.sharded_mask(model))


def to_device(batch: dict, device) -> dict:
    """A batch's arrays as tensors on ``device``; a tuple of arrays (the
    detection batches' attention maps) becomes a tuple of tensors."""

    def on(v):
        return torch.as_tensor(v).to(device, non_blocking=True)

    return {k: tuple(on(a) for a in v) if isinstance(v, (tuple, list)) else on(v)
            for k, v in batch.items()}


def loss_and_metrics(model, batch: dict, train: bool, dtype=torch.float32,
                     generator: Optional[torch.Generator] = None, depth_weight: float = 10.0,
                     center_weight: float = 1.0):
    """Forward and the reference loss on ``batch``. ``train`` puts ``model``
    in train mode (batch statistics, running statistics updated, dropout
    from ``generator``), else in eval mode. Returns (loss, metrics,
    outputs). The loss is float32 for a float32 or bf16 model (float64 for
    a float64 one)."""
    outs = model.train(train)(prepare_frames(batch["frame"], dtype), generator=generator)
    loss_dtype = torch.promote_types(dtype, torch.float32)  # float64 stays float64
    heatmaps = [h.to(loss_dtype) for h in outs.heatmaps]
    depth = [d.to(loss_dtype) for d in outs.depth]
    centers = [c.to(loss_dtype) for c in outs.centers]
    total, hm_losses, d_losses, c_losses = keypoint_loss(
        heatmaps, batch["heatmaps"].permute(0, 3, 1, 2), depth, batch["depth"].permute(0, 3, 1, 2),
        centers, batch["centers"].permute(0, 3, 4, 1, 2), depth_weight=depth_weight,
        center_weight=center_weight)
    metrics = {"loss": total.detach()}
    for i, (h, d, c) in enumerate(zip(hm_losses, d_losses, c_losses)):
        metrics[f"heatmap_loss{i + 1}"] = h.detach()
        metrics[f"depth_loss{i + 1}"] = d.detach()
        metrics[f"center_loss{i + 1}"] = c.detach()
    return total, metrics, outs


def _summed(name: str) -> bool:
    """Whether the global step sums metric ``name`` over the ranks: the
    depth and center losses are sums over the batch (losses.py:82-87); the
    rest are means."""
    return name.removeprefix("val_").startswith(("depth_loss", "center_loss"))


def reduce_metrics(metrics: dict, extra=()) -> dict:
    """``metrics`` (device scalars) as the global step computes them over
    the data group: sums for the depth and center losses, means for the
    rest; ``extra`` tensors are averaged in the same all-reduce, in place."""
    names = sorted(metrics)
    extra = list(extra)
    dtype = extra[0].dtype if extra else metrics[names[0]].dtype
    stacked = torch.stack([metrics[k].to(dtype) for k in names])
    parallel.all_reduce_([*extra, stacked], mean=[True] * len(extra) + [False],
                         group=parallel.data_group())
    rows = parallel.data_size()
    return {k: (v if _summed(k) else v / rows).to(metrics[k].dtype)
            for k, v in zip(names, stacked)}


def loss_and_grads(state: TrainState, batch: dict, generator: Optional[torch.Generator] = None,
                   depth_weight: float = 10.0, center_weight: float = 1.0):
    """The step's forward and backward in train mode: (loss, metrics,
    gradients of ``state.params``); the BatchNorm running statistics are
    updated. ``metrics["grad_norm"]`` is the global norm of the gradients.
    Over a process group the loss, the metrics and the gradients are the
    global batch's (one all-reduce over the data group); over a (data,
    model) grid a shard's gradient is its slice of the whole one."""
    batch = to_device(batch, state.device)
    params = state.params
    with no_tf32():
        loss, metrics, _ = loss_and_metrics(state.model, batch, True, state.dtype, generator,
                                            depth_weight, center_weight)
        grads = list(torch.autograd.grad(loss, params))
    if parallel.is_distributed():
        metrics = reduce_metrics(metrics, grads)
        loss = metrics["loss"]
    metrics["grad_norm"] = global_norm(grads, state.sharded)
    return loss.detach(), metrics, grads


def apply_gradients(state: TrainState, grads: List[torch.Tensor], loss: torch.Tensor) -> TrainState:
    """The optimizer's update of ``state.params`` with this step's loss."""
    state.tx.step(state.params, grads, state.opt_state, loss, state.sharded)
    state.step += 1
    return state


def train_step(state: TrainState, batch: dict, generator: Optional[torch.Generator] = None,
               depth_weight: float = 10.0, center_weight: float = 1.0):
    """One optimization step on a host-pipeline batch: (state, metrics),
    the state updated in place, the metrics tensors on its device."""
    loss, metrics, grads = loss_and_grads(state, batch, generator, depth_weight, center_weight)
    return apply_gradients(state, grads, loss), metrics


def eval_step(state: TrainState, batch: dict, depth_weight: float = 10.0,
              center_weight: float = 1.0, reduce: bool = True) -> dict:
    """Validation metrics in eval mode (the stem runs its CUDA kernel on the
    card): ``val_loss``, the mean |sigmoid(last-stack heatmap) - target|;
    ``total_heatmap_loss``, the loss; and ``val_<name>`` for each per-stack
    loss. Over a process group, where each rank holds a slice of the batch,
    they are the global batch's (``reduce_metrics``); ``reduce=False`` keeps
    this rank's."""
    batch = to_device(batch, state.device)
    with torch.no_grad(), no_tf32():
        _, metrics, outs = loss_and_metrics(state.model, batch, False, state.dtype, None,
                                            depth_weight, center_weight)
        p_heatmap = torch.sigmoid(outs.heatmaps[-1].float())
        val_loss = (p_heatmap - batch["heatmaps"].permute(0, 3, 1, 2)).abs().mean()
    out = {"val_loss": val_loss, "total_heatmap_loss": metrics["loss"]}
    out.update({"val_" + k: v for k, v in metrics.items() if k != "loss"})
    return reduce_metrics(out) if reduce and parallel.is_distributed() else out
