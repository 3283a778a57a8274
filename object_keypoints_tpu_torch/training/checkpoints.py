"""Checkpoints of a KeypointNet train state: best-on-val and resumable last.

Counterpart of ``object_keypoints_tpu/training/checkpoints.py`` (the
reference's ModelCheckpoint top-1 on val_loss with its hparams beside it,
scripts/train.py:170-172 and 53; ``--resume`` restores weights under new
hyperparameters, train.py:163-168). Orbax cannot be read without JAX, so
the port writes its own files under the checkpoint directory:

    best.msgpack   the serving state {"params", "batch_stats", "step",
                   "val_loss"} in flax's msgpack form (the weights through
                   ``serving.weights``), the file the JAX package's
                   ``CheckpointManager.restore("best")`` reads
    last.pt        {"model": the state_dict, "opt_state": the optimizer's
                   state (``OptState``'s fields), "step"}, read back with
                   ``torch.load(weights_only=True)``
    hparams.json   the run's configuration
    best_val.json  {"val_loss"} of the stored best, so that a new manager
                   over the directory does not let a worse first validation
                   overwrite it

Every file is written to a temporary name and moved into place with
``os.replace``, so a killed process leaves no truncated checkpoint.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
from typing import Optional

import numpy as np
import torch

from object_keypoints_tpu_torch.serving.export import (
    architecture,
    read_flax_msgpack,
    write_flax_msgpack,
)
from object_keypoints_tpu_torch.serving.weights import (
    keypoint_net_state_dict,
    keypoint_net_variables,
)
from object_keypoints_tpu_torch.training.trainer import OptState

BEST, LAST = "best.msgpack", "last.pt"


def model_config(hparams: dict) -> dict:
    """The serving artifact's model configuration from a run's hparams, as
    the JAX loop and scripts/package_model.py make it."""
    keypoint_config = list(hparams["keypoint_config"])
    return {
        "heatmaps_out": len(keypoint_config) + 1,
        "features": hparams.get("features", 128),
        "dropout": hparams.get("dropout", 0.1),
        "keypoint_config": keypoint_config,
        **(hparams.get("model_overrides") or {}),
    }


def opt_state_to_dict(opt_state: OptState) -> dict:
    """``OptState``'s fields, its tensors copied to the CPU."""
    def host(v):
        if isinstance(v, list):
            return [t.detach().cpu() for t in v]
        return v.detach().cpu() if isinstance(v, torch.Tensor) else v

    return {f.name: host(getattr(opt_state, f.name)) for f in dataclasses.fields(OptState)}


def opt_state_from_dict(fields: dict, device) -> OptState:
    """The inverse of ``opt_state_to_dict``, its tensors on ``device``."""
    def on(v):
        if isinstance(v, list):
            return [t.to(device) for t in v]
        return v.to(device) if isinstance(v, torch.Tensor) else v

    return OptState(**{k: on(v) for k, v in fields.items()})


class CheckpointManager:
    """``best`` and ``last`` of a run in ``directory``. ``hparams`` (written
    to hparams.json) give the model's layout for the flax form of ``best``;
    without them they are read from the directory's hparams.json."""

    def __init__(self, directory: str, hparams: Optional[dict] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.hparams = hparams
        self.best_val = float("inf")
        self._best_payload = None  # stashed best, not yet flushed to disk
        sidecar = os.path.join(self.directory, "best_val.json")
        if os.path.exists(sidecar):
            with open(sidecar, "rt") as f:
                self.best_val = float(json.load(f)["val_loss"])
        if hparams is not None:
            self._write("hparams.json", json.dumps(hparams, indent=2).encode())

    def _write(self, name: str, data: bytes):
        path = os.path.join(self.directory, name)
        with open(path + ".tmp", "wb") as f:
            f.write(data)
        os.replace(path + ".tmp", path)

    def _architecture(self) -> dict:
        return architecture(model_config(self.hparams or self.load_hparams(self.directory)))

    def save_last(self, state, step: int):
        """The resumable state: weights, BatchNorm statistics, the optimizer
        and the step."""
        buffer = io.BytesIO()
        torch.save({"model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
                    "opt_state": opt_state_to_dict(state.opt_state), "step": int(step)}, buffer)
        self._write(LAST, buffer.getvalue())

    def save_if_best(self, state, step: int, val_loss: float, defer: bool = False) -> bool:
        """Keep top-1 on val_loss (ModelCheckpoint save_top_k=1 parity).

        The best payload is the serving state (weights, BatchNorm statistics,
        step, val_loss); resume goes through ``last``. With ``defer=True`` it
        is stashed as a copy on the model's device and written on the next
        :meth:`flush_best`, so a loop can track the best every epoch and pay
        the copy to the host and the write at its checkpoint cadence. A copy,
        not references: the optimizer updates the parameters in place, so a
        stash by reference would become the last state."""
        if val_loss < self.best_val:
            self.best_val = val_loss
            weights = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
            self._best_payload = (weights, int(step), float(val_loss))
            if not defer:
                self.flush_best()
            return True
        return False

    def flush_best(self):
        """Write any stashed best payload (see ``save_if_best(defer=True)``)."""
        if self._best_payload is None:
            return
        weights, step, val_loss = self._best_payload
        variables = keypoint_net_variables(weights, **self._architecture())
        self._write(BEST, write_flax_msgpack({
            **variables, "step": np.asarray(step, np.int64),
            "val_loss": np.asarray(val_loss, np.float64)}))
        self._write("best_val.json", json.dumps({"val_loss": self.best_val}).encode())
        self._best_payload = None

    def restore(self, name: str = "last") -> dict:
        """``best``: {"params", "batch_stats", "step", "val_loss"} as numpy
        (flax variables); ``last``: {"model", "opt_state", "step"} on the
        CPU."""
        if name == "best":
            with open(os.path.join(self.directory, BEST), "rb") as f:
                return read_flax_msgpack(f.read())
        if name == "last":
            return torch.load(os.path.join(self.directory, LAST), map_location="cpu",
                              weights_only=True)
        raise ValueError(f"restore: unknown checkpoint {name!r}, expected 'best' or 'last'")

    def restore_state_dict(self, name: str = "best"):
        """(port state_dict, step) of checkpoint ``name``."""
        restored = self.restore(name)
        if name == "best":
            return keypoint_net_state_dict(restored, **self._architecture()), int(restored["step"])
        return restored["model"], int(restored["step"])

    @staticmethod
    def load_hparams(directory: str) -> dict:
        with open(os.path.join(directory, "hparams.json"), "rt") as f:
            return json.load(f)
