"""The flagship recipe: scripts/flagship_recipe.sh's data, training and eval.

    python -m object_keypoints_tpu_torch.cli.flagship --out runs/flagship/runA \
        --pool 500 --epochs 50

- **Data**: the recipe's synthetic valve set, 16 train and 2 val sequences of
  50 frames of 720x1280 with 2 objects, config/valve.json's keypoints;
  sequence i of a split is drawn from ``data.synthetic.sequence_seed(split,
  i)``, as ``make_synthetic_dataset_tree`` draws it. The sequences are held
  in memory (a machine without h5py cannot read a sequence directory), so
  the frames skip the mp4 encode that the tree on disk applies.
- **Training**: ``training.loop.fit`` with the recipe's flags (batch 8, lr
  4e-3, features 128, bf16, seed 1, checkpoints every 10 epochs, TensorBoard)
  and ``--pool`` / ``--epochs`` (the recipe's runA: 500 / 50).
- **Eval**: the exported model in float32 over the val split, batch 8
  (``evaluation.evaluate_sequence_fast``, the eval CLI's ``--fast`` path).

Writes under ``--out``: the run (metrics.jsonl, hparams.json, the event
file, the checkpoints, export/), eval.json with the keys of
results/flagship/<name>/eval.json, and run.json (the device, seconds of
data, training and eval, ms a step). It runs on the CUDA card (and raises
without one) unless ``--cpu`` asks for the CPU.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import time

import torch

from object_keypoints_tpu_torch import evaluation
from object_keypoints_tpu_torch.data.synthetic import sequence_seed
from object_keypoints_tpu_torch.serving.export import load_inference_fn
from object_keypoints_tpu_torch.testing import synthetic_sequence_in_memory
from object_keypoints_tpu_torch.training import loop

CALIBRATION = "config/calibration.yaml"
KEYPOINTS = "config/valve.json"
N_TRAIN, N_VAL, N_FRAMES, N_OBJECTS = 16, 2, 50, 2
RECIPE = dict(batch_size=8, lr=4e-3, features=128, bf16=True, seed=1, ckpt_every=10,
              tensorboard=True)
EVAL_BATCH = 8


def read_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", required=True, help="Output directory of the run.")
    parser.add_argument("--pool", default=1000, type=int,
                        help="How many examples to use in shuffle pool.")
    parser.add_argument("--epochs", default=10, type=int)
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU, not the CUDA card.")
    return parser.parse_args(argv)


def synthetic_split(root: str, split: str, n: int, keypoint_config, n_frames: int = N_FRAMES,
                    n_objects: int = N_OBJECTS) -> list:
    """The recipe's sequences of ``split`` in memory: [(sequence directory
    with its labels, (poses, frames))]."""
    out = []
    for i in range(n):
        seq_dir = os.path.join(root, split, f"seq_{i:02d}")
        out.append((seq_dir, synthetic_sequence_in_memory(
            seq_dir, CALIBRATION, keypoint_config, n_frames, seed=sequence_seed(split, i),
            n_objects=n_objects)))
    return out


def _card(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def main(argv=None):
    flags = read_args(argv)
    device = torch.device("cpu" if flags.cpu else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("flagship: CUDA is not available; pass --cpu to run on the CPU")
    card = _card(device)
    with open(KEYPOINTS) as f:
        keypoint_options = json.load(f)
    keypoint_config = keypoint_options["keypoint_config"]
    data_root = os.path.join(flags.out, "data")

    t0 = time.perf_counter()
    train_split = synthetic_split(data_root, "train", N_TRAIN, keypoint_config, N_FRAMES)
    val_split = synthetic_split(data_root, "val", N_VAL, keypoint_config, N_FRAMES)
    config = loop.TrainConfig(train=os.path.join(data_root, "train"),
                              val=os.path.join(data_root, "val"), keypoint_config=keypoint_config,
                              pool=flags.pool, epochs=flags.epochs, out_dir=flags.out, **RECIPE)
    train_sets = loop.sequences([d for d, _ in train_split], config, train=True,
                                recordings=[r for _, r in train_split])
    val_sets = loop.sequences([d for d, _ in val_split], config, train=False,
                              recordings=[r for _, r in val_split])
    data_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    result = loop.fit(config, train_sets, val_sets, device=device)
    train_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    infer = load_inference_fn(result["export_dir"], device=device)  # float32
    results = evaluation.Results()
    for seq_dir, recording in val_split:
        sequence = evaluation.Sequence(seq_dir, keypoint_options, device=device,
                                       recording=recording)
        seq_results = evaluation.evaluate_sequence_fast(sequence, infer, keypoint_options,
                                                        batch_size=EVAL_BATCH)
        results.gt_keypoints.extend(seq_results.gt_keypoints)
        results.predicted_keypoints.extend(seq_results.predicted_keypoints)
        results.set_calibration(sequence.camera_small)
    summary = results.print_results()
    eval_s = time.perf_counter() - t0

    with open(os.path.join(flags.out, "eval.json"), "wt") as f:
        json.dump({"summary": summary, "data": config.val, "model": result["export_dir"],
                   "ground_truth": False, "fast": True}, f, indent=2)
    run = {"card": card, "device": str(device), "config": dataclasses.asdict(config),
           "result": result, "data_s": data_s, "train_s": train_s, "eval_s": eval_s,
           "train_ms_per_step": 1e3 * train_s / max(result["steps"], 1),
           "train_frames": sum(len(s) for s in train_sets),
           "val_frames": sum(len(s) for s in val_sets)}
    with open(os.path.join(flags.out, "run.json"), "wt") as f:
        json.dump(run, f, indent=2)
    print(json.dumps({"summary": summary, **{k: run[k] for k in (
        "card", "data_s", "train_s", "eval_s", "train_ms_per_step")}}))
    return summary, run


if __name__ == "__main__":
    main()
