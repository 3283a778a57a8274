"""Device-resident training data: ship the dataset once, train on indices.

Counterpart of ``object_keypoints_tpu/training/device_data.py``. The
deterministic per-frame prefix of every sequence (decode, pose math,
projection, resize/crop: ``SceneDataset.iter_prefix``) is staged on the card
once, ~0.78 MB a 511x511 uint8 frame; the stochastic suffix runs inside the
step: photometric augment and flips (``data.augment_device``), target
rendering (``data.targets``, batched) and normalization. A step's input is a
(B,) index tensor; the rest is gathers from device memory.

The host pipeline (``training.trainer.train_step`` over ``batched``
``SceneDataset`` examples) stays the exact-parity path: with augmentation
off both give the same loss (tests/test_torch_port_train.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from object_keypoints_tpu_torch.data import targets as targets_mod
from object_keypoints_tpu_torch.data.augment_device import photometric_device
from object_keypoints_tpu_torch.data.scene import normalize_frames
from object_keypoints_tpu_torch.training import trainer


class DeviceStore(NamedTuple):
    """The whole training set on one device."""

    frames: torch.Tensor  # (N, H, W, 3) uint8, after resize/crop
    keypoints: torch.Tensor  # (N, O, K, 2) float32, image-space (x, y)
    points_C: torch.Tensor  # (N, O, K, 3) float32, camera-frame 3D
    valid: torch.Tensor  # (N, O, K) bool (False rows pad the object count)

    @property
    def n_frames(self) -> int:
        return self.frames.shape[0]


def build_device_store(datasets: Sequence, device="cuda") -> DeviceStore:
    """Run every dataset's deterministic prefix and stage it on ``device``.

    ``datasets``: ``SceneDataset``s sharing a keypoint config; object counts
    may differ between sequences (padded with valid=False rows)."""
    frames, kps, pcs, counts = [], [], [], []
    for ds in datasets:
        k = ds.n_keypoints
        for image, projected, points_C, _ in ds.iter_prefix():
            frames.append(np.asarray(image))
            kps.append(np.asarray(projected, np.float32).reshape(-1, k, 2))
            pcs.append(np.asarray(points_C, np.float32).reshape(-1, k, 3))
            counts.append(kps[-1].shape[0])
    if not frames:
        raise ValueError("build_device_store: no frames in any dataset")
    o_max, n, k = max(counts), len(frames), kps[0].shape[1]
    kp_arr = np.zeros((n, o_max, k, 2), np.float32)
    pc_arr = np.zeros((n, o_max, k, 3), np.float32)
    valid = np.zeros((n, o_max, k), bool)
    for i, (kp, pc, c) in enumerate(zip(kps, pcs, counts)):
        kp_arr[i, :c] = kp
        pc_arr[i, :c] = pc
        valid[i, :c] = True
    return DeviceStore(*(torch.from_numpy(a).to(device)
                         for a in (np.stack(frames), kp_arr, pc_arr, valid)))


def device_batch(store: DeviceStore, indices: torch.Tensor, keypoint_config: tuple,
                 target_size: tuple = (64, 64), augment: bool = True,
                 generator: Optional[torch.Generator] = None) -> dict:
    """Gather the examples at ``indices`` and run the stochastic suffix on
    the store's device: the batch dict ``trainer.train_step`` takes, frames
    normalized float32 (N, H, W, 3), the targets as NHWC views of the
    renderer's NCHW maps. ``keypoint_config`` counts the maps with the
    center map, e.g. (1, 1, 3)."""
    indices = indices.to(store.frames.device, non_blocking=True)
    frames = store.frames[indices]  # (B, H, W, 3) uint8
    kps, p_C, valid = store.keypoints[indices], store.points_C[indices], store.valid[indices]
    b, img_h, img_w, _ = frames.shape
    o, k = kps.shape[1], kps.shape[2]
    if augment:
        frames, kps_flat = photometric_device(frames, kps.reshape(b, o * k, 2), generator)
        kps = kps_flat.reshape(b, o, k, 2)
    # image space -> target space: (x, y) * (w_scale, h_scale), in float32
    points_t = torch.stack([kps[..., 0] * (target_size[1] / img_w),
                            kps[..., 1] * (target_size[0] / img_h)], dim=-1)
    heat, depth, centers = targets_mod.render_all_targets(points_t, p_C, valid,
                                                          tuple(keypoint_config), target_size)
    return {"frame": normalize_frames(frames), "heatmaps": heat.permute(0, 2, 3, 1),
            "depth": depth.permute(0, 2, 3, 1), "centers": centers.permute(0, 3, 4, 1, 2)}


def train_step_device_data(state: trainer.TrainState, store: DeviceStore, indices: torch.Tensor,
                           generator: Optional[torch.Generator] = None,
                           keypoint_config: tuple = (1, 1, 3), target_size: tuple = (64, 64),
                           augment: bool = True, depth_weight: float = 10.0,
                           center_weight: float = 1.0):
    """One optimization step over the store: ``device_batch`` (gather,
    augment from ``generator``, targets, normalization), then the train core
    that ``trainer.train_step`` runs. Returns (state, metrics) as it does."""
    batch = device_batch(store, indices, keypoint_config, target_size, augment, generator)
    return trainer.train_step(state, batch, generator, depth_weight, center_weight)
