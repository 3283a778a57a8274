"""Iteration-based CornerNet detector training: the optimizer, the steps, the loop.

Counterpart of ``object_keypoints_tpu/training/detection.py`` (the vendored
corner_net_lite/train.py:89-183 and nnet/py_factory.py:33-137):

- **The optimizer** (``make_detection_optimizer``) is optax's
  ``adam(schedule)`` or ``sgd(schedule, momentum=0.9)`` restated over
  torch's multi-tensor ``_foreach`` ops in optax's order of operations; the
  schedule (``step_decay_schedule``) divides the learning rate by
  ``decay_rate`` every ``stepsize`` iterations and reads the count before
  the step increments it, as ``scale_by_schedule`` does. The learning rate
  and Adam's bias corrections are computed in the parameters' float type
  (float32 for float32 parameters), as optax computes them. The count is a
  host int, so an update never waits for the card.
- **The steps** (``detection_train_step``, ``saccade_train_step``): the
  train-mode forward (flax's BatchNorm: the port's ``BatchNorm2d``,
  momentum 0.9, the biased batch variance folded into the running one),
  ``gather_tags`` at the targets' corners, the CornerNet or
  CornerNet-Saccade loss (``training.losses``, float32 whatever the compute
  dtype), the backward and the update, with TF32 off. Batches keep the JAX
  package's layout (images, heatmaps and validity maps NHWC; attentions a
  tuple of (N, h, w, 1), coarse to fine, the order of the model's attention
  heads) and are permuted to NCHW on their device. The loss stays a tensor
  on the device.
- **The loop** (``train_detector``): ``max_iter`` iterations from
  ``start_iter``; a resume replays optax's counts (the schedule's and
  Adam's), so the decayed learning rate and the bias corrections pick up
  where they were. The losses stay on the card and are read in one copy
  every ``display`` iterations, for the JAX loop's message. Snapshots are
  ``<snapshot_dir>/<snapshot_name>_<iter>.pth``, a state_dict under the
  reference hg_net's names, which ``cli.detect.load_state_dict`` and the
  eval CLI read (the JAX loop writes Orbax directories, which need JAX).

The train state is ``training.trainer.TrainState``: the model holds the
parameters and the BatchNorm statistics, updated in place.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterator, List, Optional

import numpy as np
import torch

from object_keypoints_tpu_torch.data.detection_targets import gather_tags
from object_keypoints_tpu_torch.precision import no_tf32
from object_keypoints_tpu_torch.training.losses import cornernet_loss, cornernet_saccade_loss
from object_keypoints_tpu_torch.training.trainer import (
    TrainState,
    _bias_correction,
    create_train_state,
    prepare_frames,
    to_device,
)
from object_keypoints_tpu_torch.utils import timer


def step_decay_schedule(base_lr: float, stepsize: int, decay_rate):
    """lr / decay_rate every stepsize iterations (train.py:150-154). The
    schedule maps the optimizer's count to the learning rate, computed in
    the real type ``real`` (numpy's float32 or float64) as optax computes it
    for parameters of that type: ``real(base_lr) / real(decay_rate ** k)``."""

    def schedule(count: int, real=np.float32) -> float:
        return float(real(base_lr) / real(decay_rate ** (count // stepsize)))

    return schedule


@dataclasses.dataclass
class DetectionOptState:
    """``count`` stands for both of optax's counts (the schedule's and
    Adam's, which move together and which a resume sets together); ``mu``
    is Adam's first moment or SGD's momentum trace, ``nu`` Adam's second
    moment (None for SGD)."""

    count: int
    mu: List[torch.Tensor]
    nu: Optional[List[torch.Tensor]]


class DetectionOptimizer:
    """optax's adam(schedule) (b1 0.9, b2 0.999, eps 1e-8) or sgd(schedule,
    momentum 0.9), applied to the parameters in place."""

    b1, b2, eps = 0.9, 0.999, 1e-8
    momentum = 0.9

    def __init__(self, algo: str, schedule: Callable):
        if algo not in ("adam", "sgd"):
            raise ValueError(f"unknown opt_algo {algo}")
        self.algo, self.schedule = algo, schedule

    def init(self, params: List[torch.Tensor]) -> DetectionOptState:
        return DetectionOptState(
            count=0, mu=[torch.zeros_like(p) for p in params],
            nu=[torch.zeros_like(p) for p in params] if self.algo == "adam" else None)

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor],
             state: DetectionOptState) -> None:
        """Update ``params`` in place from ``grads``."""
        dtype = params[0].dtype
        lr = self.schedule(state.count, np.float64 if dtype == torch.float64 else np.float32)
        if self.algo == "adam":
            b1, b2 = self.b1, self.b2
            # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu
            torch._foreach_mul_(state.mu, b1)
            torch._foreach_add_(state.mu, torch._foreach_mul(grads, 1.0 - b1))
            squares = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(squares, 1.0 - b2)
            torch._foreach_mul_(state.nu, b2)
            torch._foreach_add_(state.nu, squares)
            count = state.count + 1
            update = torch._foreach_div(state.mu, _bias_correction(b1, count, dtype))
            denom = torch._foreach_div(state.nu, _bias_correction(b2, count, dtype))
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            torch._foreach_div_(update, denom)
            torch._foreach_mul_(update, -lr)
        else:
            # trace = g + momentum * trace; the update is -lr * trace
            torch._foreach_mul_(state.mu, self.momentum)
            torch._foreach_add_(state.mu, grads)
            update = torch._foreach_mul(state.mu, -lr)
        torch._foreach_add_(params, update)
        state.count += 1


def make_detection_optimizer(system_config) -> DetectionOptimizer:
    """adam or sgd (py_factory.py:61-72) over the config's step-decay
    schedule; an unknown ``opt_algo`` raises ValueError."""
    schedule = step_decay_schedule(system_config.learning_rate, system_config.stepsize,
                                   system_config.decay_rate)
    return DetectionOptimizer(system_config.opt_algo, schedule)


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def detection_loss(model, batch: dict, dtype=torch.float32, saccade: bool = False):
    """The train-mode forward of ``model`` on ``batch`` (on the model's
    device) and its CornerNet (or, with ``saccade``, CornerNet-Saccade)
    loss: a float32 scalar (float64 for a float64 model); the BatchNorm
    running statistics are updated. The spans ``train.forward`` (the model)
    and ``train.loss`` (the tag gathers and the loss; ``utils.timer``)."""
    with timer.span("train.forward"):
        outs = model.train()(prepare_frames(batch["images"], dtype))
    with timer.span("train.loss"):
        tl_heats, br_heats, tl_tags_f, br_tags_f, tl_offs_f, br_offs_f = outs[:6]
        tl_tags = [gather_tags(t, batch["tl_tags"])[..., 0] for t in tl_tags_f]
        br_tags = [gather_tags(t, batch["br_tags"])[..., 0] for t in br_tags_f]
        tl_offs = [gather_tags(t, batch["tl_tags"]) for t in tl_offs_f]
        br_offs = [gather_tags(t, batch["br_tags"]) for t in br_offs_f]
        heads = (tl_heats, br_heats, tl_tags, br_tags, tl_offs, br_offs)
        targets = (_nchw(batch["tl_heatmaps"]), _nchw(batch["br_heatmaps"]), batch["tag_mask"],
                   batch["tl_regrs"], batch["br_regrs"])
        if not saccade:
            return cornernet_loss(heads, targets)
        return cornernet_saccade_loss(
            (*heads, outs[6]),
            (*targets, _nchw(batch["tl_valids"]), _nchw(batch["br_valids"]),
             [_nchw(a) for a in batch["attentions"]]))


def loss_and_grads(state: TrainState, batch: dict, saccade: bool = False):
    """One step's forward and backward, TF32 off: (loss, gradients of
    ``state.params``); the backward is the span ``train.backward``."""
    batch = to_device(batch, state.device)
    with no_tf32():
        loss = detection_loss(state.model, batch, state.dtype, saccade)
        with timer.span("train.backward"):
            grads = list(torch.autograd.grad(loss, state.params))
    return loss.detach(), grads


def _train_step(state: TrainState, batch: dict, saccade: bool):
    with timer.span("train.step"):
        loss, grads = loss_and_grads(state, batch, saccade)
        with timer.span("train.optimizer"):
            state.tx.step(state.params, grads, state.opt_state)
        state.step += 1
        return state, {"loss": loss}


def detection_train_step(state: TrainState, batch: dict):
    """One CornerNet step: (state, {"loss"}), the state updated in place.
    batch: images (N, H, W, 3) normalized, tl_heatmaps / br_heatmaps (N, oh,
    ow, C), tl_regrs / br_regrs (N, M, 2), tl_tags / br_tags (N, M) flat
    indices, tag_mask (N, M)."""
    return _train_step(state, batch, saccade=False)


def saccade_train_step(state: TrainState, batch: dict):
    """One CornerNet-Saccade step: the CornerNet batch plus tl_valids /
    br_valids (N, oh, ow, C) and attentions, a tuple of per-scale (N, ah, aw,
    1) masks, coarse to fine (``data.detection_targets.saccade_sample``)."""
    return _train_step(state, batch, saccade=True)


def train_detector(model: torch.nn.Module, system_config, batches: Iterator,
                   start_iter: int = 0, snapshot_dir: Optional[str] = None,
                   on_display: Optional[Callable] = None,
                   train_step_fn: Optional[Callable] = None, device="cuda",
                   dtype=torch.float32) -> TrainState:
    """The vendored iteration loop (train.py:162-183) on ``device`` in
    compute ``dtype``: ``batches`` yields detection batches (numpy or
    tensors); ``train_step_fn`` is ``detection_train_step`` (the default) or
    ``saccade_train_step``. Returns the final TrainState; ``model`` is
    trained in place. Runs on the card unless ``device="cpu"``."""
    state = create_train_state(model, make_detection_optimizer(system_config), dtype, device)
    # a resume replays both of optax's counts (tree_set(count=start_iter))
    state.step = state.opt_state.count = start_iter
    step_fn = train_step_fn or detection_train_step
    display = int(system_config.display)
    losses = []  # device scalars since the last display
    for iteration in range(start_iter + 1, int(system_config.max_iter) + 1):
        state, metrics = step_fn(state, next(batches))
        losses.append(metrics["loss"])
        if iteration % display == 0:
            values = torch.stack(losses[-display:]).cpu().tolist()  # one copy a display
            losses.clear()
            (on_display or print)(f"iter {iteration}: loss {np.mean(values):.5f}")
        if snapshot_dir and iteration % system_config.snapshot == 0:
            os.makedirs(snapshot_dir, exist_ok=True)
            name = (system_config.snapshot_name or "model") + f"_{iteration}.pth"
            torch.save({k: v.detach().cpu().contiguous() for k, v in model.state_dict().items()},
                       os.path.join(snapshot_dir, name))
    return state
