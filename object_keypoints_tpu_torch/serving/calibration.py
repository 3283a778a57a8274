"""Real frames for int8 activation calibration.

Counterpart of ``object_keypoints_tpu/serving/calibration.py``: frames read
back through ``SceneDataset`` (the 511 resize and the normalization) from the
first reachable directory of sequences, in the small batches
``serving.quantize.calibrate_activation_scales`` runs over. The package CLI
(``cli.package_model``) calibrates on them. Frames are NHWC float32, as the
JAX package's; the port's forward takes NCHW.

Where a sequence directory cannot be read (no h5py to open data.hdf5, as on
a machine without it), ``collect_calibration_frames`` returns None and the
caller takes its fallback, as for a directory that holds no sequence.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional, Sequence

import numpy as np

from object_keypoints_tpu_torch.data.scene import SceneDataset


def dataset_frames(datasets: Iterable, n_frames: int = 16) -> List[np.ndarray]:
    """Up to ``n_frames`` normalized (511, 511, 3) frames from the
    ``SceneDataset``s in order (augmentation off)."""
    frames: List[np.ndarray] = []
    for dataset in datasets:
        for example in dataset:
            if len(frames) >= n_frames:
                return frames
            frames.append(np.asarray(example["frame"], np.float32))
    return frames


def _sequences(data_dir: str, keypoint_config: Sequence[int]):
    """The readable sequences of ``data_dir`` as SceneDatasets, by name."""
    for name in sorted(os.listdir(data_dir)):
        seq = os.path.join(data_dir, name)
        if not os.path.isdir(seq):
            continue
        try:
            yield SceneDataset(seq, {"keypoint_config": list(keypoint_config)}, augment=False)
        except (OSError, ValueError, ImportError):
            continue  # not an encoded sequence, another topology, or no h5py


def collect_calibration_frames(data_dirs: Sequence[Optional[str]],
                               keypoint_config: Sequence[int],
                               n_frames: int = 16) -> Optional[List[np.ndarray]]:
    """Up to ``n_frames`` normalized frames from the first reachable
    directory of sequences in ``data_dirs``; None when none is readable."""
    for data_dir in data_dirs:
        if not data_dir or not os.path.isdir(data_dir):
            continue
        frames = dataset_frames(_sequences(data_dir, keypoint_config), n_frames)
        if frames:
            return frames
    return None


def calibration_batches(frames: Sequence[np.ndarray], batch: int = 4):
    """Stack frames into the small batches calibration runs over."""
    return [np.stack(frames[i : i + batch]) for i in range(0, len(frames), batch)]
