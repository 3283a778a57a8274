"""Detector configs: SystemConfig, the db defaults, their JSON merge and the --tiny overrides.

The port's copy of ``object_keypoints_tpu/utils/config.py``
(CornerNet-Lite's core/config.py:4-162 SystemConfig, core/dbs/
detection.py:5-70 defaults and core/base.py:27-31 JSON reader).
Model JSONs pair a "system" and a "db" section (``configs/*.json``, copied
byte for byte from the JAX package). ``CONFIG_DIR`` holds them.
"""

from __future__ import annotations

import json
import os
import pathlib

import numpy as np

CONFIG_DIR = pathlib.Path(__file__).resolve().parents[1] / "configs"


class SystemConfig:
    """Training-system configuration (core/config.py:4-162): a dict of
    defaults behind attribute access; ``update_config`` merges the known
    keys of a config's "system" section."""

    def __init__(self, **overrides):
        self._configs = {
            "dataset": None,
            "sampling_function": "cornernet",
            # training
            "display": 5,
            "snapshot": 400,
            "stepsize": 5000,
            "learning_rate": 0.001,
            "decay_rate": 10,
            "max_iter": 100000,
            "val_iter": 20,
            "batch_size": 1,
            "snapshot_name": None,
            "prefetch_size": 100,
            "pretrain": None,
            "opt_algo": "adam",
            "chunk_sizes": None,
            # directories
            "data_dir": "./data",
            "cache_dir": "./cache",
            "config_dir": "./config",
            "result_dir": "./results",
            # splits
            "train_split": "training",
            "val_split": "validation",
            "test_split": "testdev",
            # rngs
            "data_rng": np.random.RandomState(123),
            "nnet_rng": np.random.RandomState(317),
        }
        self.update_config(overrides)

    def __getattr__(self, name):
        configs = object.__getattribute__(self, "_configs")
        if name in configs:
            return configs[name]
        raise AttributeError(name)

    @property
    def full(self):
        return self._configs

    def update_config(self, new: dict):
        for key, value in (new or {}).items():
            if key in self._configs:
                self._configs[key] = value
        return self

    @property
    def snapshot_dir(self):
        return os.path.join(self._configs["cache_dir"], "nnet",
                            self._configs["snapshot_name"] or "model")

    @property
    def snapshot_file(self):
        return os.path.join(self.snapshot_dir, (self._configs["snapshot_name"] or "model")
                            + "_{}.ckpt")


DETECTION_DEFAULTS = {
    # training (core/dbs/detection.py:9-62)
    "categories": 80,
    "rand_scales": [1],
    "rand_scale_min": 0.8,
    "rand_scale_max": 1.4,
    "rand_scale_step": 0.2,
    # train + test
    "input_size": [383, 383],
    "output_sizes": [[96, 96], [48, 48], [24, 24], [12, 12]],
    "score_threshold": 0.05,
    "nms_threshold": 0.7,
    "max_per_set": 40,
    "max_per_image": 100,
    "top_k": 20,
    "ae_threshold": 1,
    "nms_kernel": 3,
    "num_dets": 1000,
    "nms_algorithm": "exp_soft_nms",
    "weight_exp": 8,
    "merge_bbox": False,
    "data_aug": True,
    "lighting": True,
    "border": 64,
    "gaussian_bump": False,
    "gaussian_iou": 0.7,
    "gaussian_radius": -1,
    "rand_crop": False,
    "rand_color": False,
    "rand_center": True,
    "init_sizes": [192, 255],
    "view_sizes": [],
    "min_scale": 16,
    "max_scale": 32,
    # saccade attention
    "att_sizes": [[16, 16], [32, 32], [64, 64]],
    "att_ranges": [[96, 256], [32, 96], [0, 32]],
    "att_ratios": [16, 8, 4],
    "att_scales": [1, 1.5, 2],
    "att_thresholds": [0.3, 0.3, 0.3, 0.3],
    "att_nms_ks": [3, 3, 3],
    "att_max_crops": 8,
    "ref_dets": True,
    # testing
    "test_scales": [1],
    "test_flipped": True,
}


class DetectionConfig:
    """Detection db config: the defaults with a db section's known keys
    merged over them; ``rand_scales: null`` expands to
    ``arange(rand_scale_min, rand_scale_max, rand_scale_step)``."""

    def __init__(self, db_config: dict | None = None):
        self.configs = dict(DETECTION_DEFAULTS)
        for key, value in (db_config or {}).items():
            if key in self.configs:
                self.configs[key] = value
        if self.configs["rand_scales"] is None:
            self.configs["rand_scales"] = list(
                np.arange(
                    self.configs["rand_scale_min"],
                    self.configs["rand_scale_max"],
                    self.configs["rand_scale_step"],
                )
            )

    def __getitem__(self, key):
        return self.configs[key]


def load_cfg(path):
    """Read a paired system/db JSON -> (system dict, db dict)."""
    with open(path, "rt") as f:
        cfg = json.load(f)
    return cfg.get("system", {}), cfg.get("db", {})


def tiny_db_overrides(arch: str) -> dict:
    """The --tiny db overrides that pair with ``models.cornernet.tiny_cornernet``:
    64x64 input, 16x16 output, few detections. For CornerNet_Saccade the
    attention geometry follows the tiny model's two upsample levels."""
    tiny = {
        "input_size": [64, 64], "output_sizes": [[16, 16]],
        "test_scales": [1], "top_k": 8, "num_dets": 8, "max_per_image": 10,
        "rand_crop": False, "rand_color": False, "lighting": False,
    }
    if arch.split("-")[0] == "CornerNet_Saccade":
        tiny.update(
            att_sizes=[[8, 8], [16, 16]],
            att_ranges=[[16, 64], [0, 16]],
            att_ratios=[8, 4],
            att_scales=[[1, 2], [1, 2]],
            att_thresholds=[0.3, 0.3],
            att_nms_ks=[3, 3],
            init_sizes=[48, 64],
        )
    return tiny
