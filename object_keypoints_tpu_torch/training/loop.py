"""The training loop: data -> steps -> validation -> checkpoints -> export.

Counterpart of ``object_keypoints_tpu/training/loop.py`` (the reference's
scripts/train.py:45-179: its sequences chained and shuffle-pooled, AdamW and
a plateau schedule on the train loss, the val metric L1(sigmoid(heatmap[-1]),
target), top-1 on val_loss). ``train(config)`` builds the sequences from
``config.train`` and ``config.val`` as the JAX loop does; ``fit`` takes them
built (a machine without h5py holds them in memory, ``SceneDataset(...,
recording=...)``) and runs the rest. One device: the card unless
``device="cpu"`` is asked for.

- **Data.** The device store (``training.device_data``) when the frames fit
  ``device_data_budget_bytes`` (``OKT_DEVICE_DATA=0/1`` overrides): each
  epoch's order is numpy's permutation from ``config.seed``, as in the JAX
  loop, uploaded once from pinned memory and sliced on the card. Else the
  host pipeline, ``Chain`` -> ``SamplingPool`` -> ``batched`` ->
  ``device_prefetch`` (``prefetch`` batches ahead). ``OKT_CACHE_FRAMES=0``
  turns the datasets' frame cache off.
- **A step never waits for the card.** The metrics are read every
  ``log_every`` steps in one copy; validation is read once an epoch.
- **Validation** batches are 2 x ``batch_size`` frames, the tail padded
  cyclically to that size, rendered once and replayed (on the card in store
  mode) when the whole batches fit ``VAL_CACHE_BUDGET_BYTES`` (every field
  counted; ``OKT_CACHE_VAL=0`` opts out).
- **Best on val** is tracked every epoch (a copy on the device) and written
  with ``last`` every ``ckpt_every`` epochs and at the last; the serving
  artifact is exported from the best, or from the final state when no
  validation was finite.
- **Random numbers**: the weights from ``torch.Generator().manual_seed(seed)``,
  dropout and the device augment from one generator on the device seeded
  with ``seed``; the host augment from numpy seeds ``seed + i``, as in JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch

from object_keypoints_tpu_torch.data.combinators import Chain, SamplingPool, batched
from object_keypoints_tpu_torch.data.prefetch import device_prefetch
from object_keypoints_tpu_torch.data.scene import SceneDataset
from object_keypoints_tpu_torch.models.keypoint_net import KeypointNet
from object_keypoints_tpu_torch.serving.export import export_model
from object_keypoints_tpu_torch.training.checkpoints import (
    CheckpointManager,
    model_config,
    opt_state_from_dict,
)
from object_keypoints_tpu_torch.training.device_data import (
    build_device_store,
    train_step_device_data,
)
from object_keypoints_tpu_torch.training.trainer import (
    create_train_state,
    eval_step,
    make_optimizer,
    train_step,
)
from object_keypoints_tpu_torch.utils.metrics import MetricsLogger, print_metrics

VAL_FIELDS = ("frame", "heatmaps", "depth", "centers")
VAL_CACHE_BUDGET_BYTES = 512 * 1024 ** 2


@dataclasses.dataclass
class TrainConfig:
    """The JAX package's TrainConfig: the flags of scripts/train.py:17-33
    and their defaults, and the loop's settings."""

    train: str = ""
    val: str = ""
    keypoint_config: Sequence[int] = (1, 1, 1)
    batch_size: int = 8
    lr: float = 4e-3
    weight_decay: float = 0.01
    features: int = 128
    center_weight: float = 1.0
    depth_weight: float = 10.0
    dropout: float = 0.1
    pool: int = 1000
    epochs: int = 10
    steps_per_epoch: Optional[int] = None  # None = exhaust the chain
    bf16: bool = False  # the reference's --fp16
    seed: int = 0
    out_dir: str = "runs/keypoints"
    resume: Optional[str] = None
    log_every: int = 10
    tensorboard: bool = False  # an event file beside metrics.jsonl
    ckpt_every: int = 1  # write the checkpoints every N epochs
    # the reference steps ReduceLROnPlateau once an epoch on the epoch's mean
    # train loss; the schedule sees one loss a step, so it averages about an
    # epoch of them per comparison and patience counts epochs
    plateau_patience: int = 10
    plateau_accumulation: int = 50
    # the reference's --resume reloads the weights under a fresh optimizer;
    # False continues the optimizer's state exactly
    resume_fresh_optimizer: bool = True
    device_data: Optional[bool] = None  # None: the store when the frames fit
    device_data_budget_bytes: int = 8 << 30
    model_overrides: Optional[dict] = None  # KeypointNet layout arguments

    @property
    def heatmaps_out(self) -> int:
        return len(list(self.keypoint_config)) + 1


def sequences(dirs, config: TrainConfig, train: bool, recordings=None) -> list:
    """The datasets of sequence directories ``dirs`` as the loop reads them:
    raw uint8 frames, the frame cache on unless ``OKT_CACHE_FRAMES=0``; train
    sets augmented from seeds ``config.seed + i``, val sets with their poses.
    ``recordings``: one (poses, frames) per directory, held in memory."""
    cache_frames = os.environ.get("OKT_CACHE_FRAMES", "1") == "1"
    kwargs = dict(augment=True) if train else dict(include_pose=True)
    return [SceneDataset(d, {"keypoint_config": list(config.keypoint_config)},
                         seed=config.seed + i if train else None, normalize=False,
                         cache_frames=cache_frames,
                         recording=None if recordings is None else recordings[i], **kwargs)
            for i, d in enumerate(dirs)]


def build_model(config: TrainConfig) -> KeypointNet:
    """The KeypointNet of ``config``, its weights drawn from ``config.seed``."""
    return KeypointNet(heatmaps_out=config.heatmaps_out, features=config.features,
                       dropout=config.dropout, generator=torch.Generator().manual_seed(config.seed),
                       **dict(config.model_overrides or {}))


def _sequence_dirs(root: str) -> list:
    return sorted(os.path.join(root, d) for d in os.listdir(root))


def train(config: TrainConfig, device="cuda", prefetch: int = 2) -> dict:
    """Train on the sequence directories under ``config.train`` and
    ``config.val``; returns what ``fit`` returns."""
    return fit(config, sequences(_sequence_dirs(config.train), config, train=True),
               sequences(_sequence_dirs(config.val), config, train=False), device, prefetch)


def _upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without waiting for the card (a copy from
    pageable memory would)."""
    tensor = torch.from_numpy(array)
    if device.type == "cuda":
        return tensor.pin_memory().to(device, non_blocking=True)
    return tensor


def _read(metrics: dict) -> dict:
    """Device scalars -> floats, in one copy to the host; keys sorted, as
    the JAX loop's metrics come."""
    names = sorted(metrics)
    values = torch.stack([metrics[k].detach().float() for k in names]).cpu().tolist()
    return dict(zip(names, values))


def _kept(items, sink: list):
    """Yield ``items``, appending each to ``sink``."""
    for item in items:
        sink.append(item)
        yield item


def fit(config: TrainConfig, train_sets: list, val_sets: list, device="cuda",
        prefetch: int = 2) -> dict:
    """Train on ``train_sets`` (``sequences(..., train=True)``), validate on
    ``val_sets`` each epoch, checkpoint and export. Returns
    {'best_val_loss', 'steps', 'checkpoint_dir', 'export_dir'}."""
    device = torch.device(device)
    tx = make_optimizer(lr=config.lr, weight_decay=config.weight_decay,
                        plateau_patience=config.plateau_patience,
                        plateau_accumulation=config.plateau_accumulation)
    state = create_train_state(build_model(config), tx,
                               torch.bfloat16 if config.bf16 else torch.float32, device)
    hparams = dataclasses.asdict(config)
    hparams["keypoint_config"] = list(config.keypoint_config)
    ckpt = CheckpointManager(config.out_dir, hparams=hparams)
    if config.resume:
        restored = CheckpointManager(config.resume).restore("last")
        state.model.load_state_dict(restored["model"])
        state.step = int(restored["step"])
        if not config.resume_fresh_optimizer:
            state.opt_state = opt_state_from_dict(restored["opt_state"], device)
    generator = torch.Generator(device=device).manual_seed(config.seed)
    loss_weights = dict(depth_weight=config.depth_weight, center_weight=config.center_weight)

    # one example gives the sizes, taken as the JAX loop takes it (which also
    # draws that example's augmentation from the first train set's stream)
    sample = next(iter(train_sets[0]))
    frame_bytes = np.asarray(sample["frame"]).nbytes
    total_frames = sum(len(s) for s in train_sets)
    use_store = config.device_data
    if use_store is None:
        env = os.environ.get("OKT_DEVICE_DATA")
        use_store = (env == "1" if env in ("0", "1")
                     else total_frames * frame_bytes <= config.device_data_budget_bytes)
    store = None
    if use_store:
        store = build_device_store(train_sets, device)
        target_config = tuple(train_sets[0].keypoint_config)
        perm_rng = np.random.default_rng(config.seed)
        print(f"device store: {total_frames} frames, "
              f"{total_frames * frame_bytes / 1e6:.0f} MB staged on {device}")

    def train_batches():
        if store is not None:
            order = _upload(perm_rng.permutation(store.n_frames), device)  # once an epoch
            for start in range(0, store.n_frames - config.batch_size + 1, config.batch_size):
                yield order[start:start + config.batch_size]
            return
        chain = Chain(train_sets, shuffle=True, seed=config.seed)
        yield from device_prefetch(batched(SamplingPool(chain, config.pool, seed=config.seed),
                                           config.batch_size), device, prefetch)

    vb = 2 * config.batch_size
    n_val = sum(len(s) for s in val_sets)
    val_cacheable = (os.environ.get("OKT_CACHE_VAL", "1") == "1"
                     and math.ceil(n_val / vb) * vb
                     * sum(np.asarray(sample[k]).nbytes for k in VAL_FIELDS)
                     <= VAL_CACHE_BUDGET_BYTES)
    val_cache: list = []  # device batches in store mode, else host batches

    def host_val_batches():
        for b in batched(Chain(val_sets), vb, drop_last=False):
            b = {k: b[k] for k in VAL_FIELDS}
            n = len(b["frame"])
            if n < vb:  # one shape for every batch
                idx = np.resize(np.arange(n), vb)
                b = {k: np.asarray(v)[idx] for k, v in b.items()}
            yield b

    def val_batches():
        if val_cache:
            return iter(val_cache) if store is not None else device_prefetch(
                iter(val_cache), device, prefetch)
        if not val_cacheable:
            return device_prefetch(host_val_batches(), device, prefetch)
        if store is not None:
            return _kept(device_prefetch(host_val_batches(), device, prefetch), val_cache)
        return device_prefetch(_kept(host_val_batches(), val_cache), device, prefetch)

    logger = MetricsLogger(config.out_dir, tensorboard=config.tensorboard)
    try:
        for epoch in range(config.epochs):
            epoch_steps = 0
            with contextlib.closing(train_batches()) as batches:
                for batch in batches:
                    if store is not None:
                        state, metrics = train_step_device_data(
                            state, store, batch, generator, keypoint_config=target_config,
                            **loss_weights)
                    else:
                        state, metrics = train_step(state, batch, generator, **loss_weights)
                    epoch_steps += 1
                    if state.step % config.log_every == 0:
                        host = _read({**metrics, "lr_scale": state.lr_scale})
                        logger.log(state.step, host)
                        print_metrics(state.step, {"loss": host["loss"]}, extra=f"epoch={epoch}")
                    if config.steps_per_epoch and epoch_steps >= config.steps_per_epoch:
                        break

            # validation, read once: (batches, metrics) copied in one go
            val_metrics = [eval_step(state, b, **loss_weights) for b in val_batches()]
            mean_val = {"val_loss": float("inf")}
            if val_metrics:
                names = sorted(val_metrics[0])
                table = torch.stack([torch.stack([m[k].float() for k in names])
                                     for m in val_metrics]).cpu().numpy().astype(np.float64)
                mean_val = {k: float(np.mean(table[:, i])) for i, k in enumerate(names)}
            logger.log(state.step, mean_val)
            print_metrics(state.step, {"val_loss": mean_val["val_loss"]},
                          extra=f"epoch={epoch} [val]")

            ckpt.save_if_best(state, state.step, mean_val["val_loss"], defer=True)
            if (epoch + 1) % config.ckpt_every == 0 or epoch == config.epochs - 1:
                ckpt.save_last(state, state.step)
                ckpt.flush_best()

        # the serving artifact from the best checkpoint (the reference packages
        # its top-1 on val_loss), or from the final state when no val was finite
        export_dir = os.path.join(config.out_dir, "export")
        weights = state.model.state_dict()
        if np.isfinite(ckpt.best_val):
            weights, _ = ckpt.restore_state_dict("best")
        export_model(export_dir, model_config(hparams), weights)
    finally:
        logger.close()
    return {"best_val_loss": ckpt.best_val, "steps": state.step,
            "checkpoint_dir": config.out_dir, "export_dir": export_dir}
