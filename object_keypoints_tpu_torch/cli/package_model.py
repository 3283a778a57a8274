"""Model packaging CLI: a checkpoint directory -> the serving artifact.

    python -m object_keypoints_tpu_torch.cli.package_model --model runs/keypoints \
        --out runs/keypoints/artifact --which best [--quantize]

The port of scripts/package_model.py. Reads a checkpoint directory that
``training.loop`` wrote (``training.checkpoints``: best.msgpack or last.pt
and hparams.json) and writes the artifact ``serving.export.export_model``
writes (config.json + params.msgpack, the JAX package's format), then prints
{"out", "step", "quantized_convs"} as JSON. ``--quantize`` calibrates int8
activation scales in bf16, as the JAX CLI does, and stores them as
quant.json: on frames of ``--calibration-data``, else of the run's train or
val directories, else on unit-normal frames (the JAX CLI's, from numpy's
seed 0). It calibrates on the card unless ``--cpu``.
"""

import argparse
import json
import sys

import numpy as np
import torch

from object_keypoints_tpu_torch.serving.calibration import (
    calibration_batches,
    collect_calibration_frames,
)
from object_keypoints_tpu_torch.serving.export import export_model, model_from_config
from object_keypoints_tpu_torch.serving.quantize import calibrate_activation_scales
from object_keypoints_tpu_torch.training.checkpoints import CheckpointManager, model_config


def read_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, required=True,
                        help="Checkpoint directory (best.msgpack or last.pt, and hparams.json).")
    parser.add_argument("--out", type=str, required=True, help="Output artifact directory.")
    parser.add_argument("--which", default="best", choices=["best", "last"])
    parser.add_argument("--quantize", action="store_true",
                        help="Calibrate and store int8 activation scales with the artifact "
                             "(quant.json); load_inference_fn then serves it int8.")
    parser.add_argument("--calibration-data", type=str, default=None,
                        help="Directory of encoded sequences to calibrate on. Default: the "
                             "checkpoint's recorded train, then val dir (hparams), falling "
                             "back to unit-normal frames only when no real data is reachable.")
    parser.add_argument("--calibration-frames", type=int, default=16)
    parser.add_argument("--calibration-percentile", type=float, default=None,
                        help="Clip activation scales at this percentile of |x| instead of "
                             "max-abs (e.g. 99.9; outlier-robust).")
    parser.add_argument("--per-channel", action="store_true",
                        help="Per-input-channel activation scales (folded into the int8 "
                             "weights).")
    parser.add_argument("--cpu", action="store_true", help="Calibrate on the CPU.")
    return parser.parse_args(argv)


def calibration_frames(flags, keypoint_config, data_dirs, input_size: int = 511):
    """Frames from the first reachable directory in ``data_dirs``;
    unit-normal frames (the normalized images' statistics) as the last
    resort, the JAX CLI's numbers."""
    frames = collect_calibration_frames(data_dirs, keypoint_config,
                                        n_frames=flags.calibration_frames)
    if frames is None:
        print("package_model: no calibration data reachable; "
              "falling back to unit-normal frames", file=sys.stderr)
        rng = np.random.default_rng(0)
        frames = list(rng.normal(size=(flags.calibration_frames, input_size, input_size, 3))
                      .astype(np.float32))
    return frames


def calibrate(flags, config: dict, weights, hparams: dict, device) -> dict:
    """int8 activation scales of the checkpoint's model, calibrated in bf16
    (bf16 convolutions over float32 parameters and BatchNorm) on ``device``."""
    model = model_from_config(config)
    model.load_state_dict(weights)
    model.to(device=device, memory_format=torch.channels_last).eval()
    data_dirs = [flags.calibration_data, hparams.get("train"), hparams.get("val")]
    frames = calibration_frames(flags, config["keypoint_config"], data_dirs)

    def apply(batch):  # NHWC float32 -> contiguous NCHW bf16 on the device
        x = torch.from_numpy(batch).to(device).permute(0, 3, 1, 2)
        model(x.to(torch.bfloat16).contiguous())

    return calibrate_activation_scales(model, apply, calibration_batches(frames),
                                       percentile=flags.calibration_percentile,
                                       per_channel=flags.per_channel)


def main(argv=None):
    flags = read_args(argv)
    hparams = CheckpointManager.load_hparams(flags.model)
    config = model_config(hparams)
    weights, step = CheckpointManager(flags.model).restore_state_dict(flags.which)
    quant_scales = None
    if flags.quantize:
        device = torch.device("cpu" if flags.cpu else "cuda")
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("package_model --quantize calibrates on the card, and CUDA is not "
                               "available; pass --cpu to calibrate on the CPU")
        quant_scales = calibrate(flags, config, weights, hparams, device)
    export_model(flags.out, config, weights, quant_scales=quant_scales)
    result = {"out": flags.out, "step": step,
              "quantized_convs": len(quant_scales) if quant_scales else 0}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
