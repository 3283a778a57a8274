"""Model packaging CLI: a checkpoint directory -> the serving artifact.

    python -m object_keypoints_tpu_torch.cli.package_model --model runs/keypoints \
        --out runs/keypoints/artifact --which best

The port of scripts/package_model.py. Reads a checkpoint directory that
``training.loop`` wrote (``training.checkpoints``: best.msgpack or last.pt
and hparams.json) and writes the artifact ``serving.export.export_model``
writes (config.json + params.msgpack, the JAX package's format), then prints
{"out", "step", "quantized_convs"} as JSON. int8 calibration
(``--quantize`` and the calibration flags) is not ported yet: given, they
raise rather than write a float artifact.
"""

import argparse
import json

from object_keypoints_tpu_torch.serving.export import export_model
from object_keypoints_tpu_torch.training.checkpoints import CheckpointManager, model_config

CALIBRATION_DEFAULTS = dict(quantize=False, calibration_data=None, calibration_frames=16,
                            calibration_percentile=None, per_channel=False)


def read_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, required=True,
                        help="Checkpoint directory (best.msgpack or last.pt, and hparams.json).")
    parser.add_argument("--out", type=str, required=True, help="Output artifact directory.")
    parser.add_argument("--which", default="best", choices=["best", "last"])
    parser.add_argument("--quantize", action="store_true",
                        help="int8 activation scales (not ported yet: raises).")
    parser.add_argument("--calibration-data", type=str, default=None,
                        help="int8 calibration sequences (not ported yet: raises).")
    parser.add_argument("--calibration-frames", type=int, default=16,
                        help="int8 calibration frames (not ported yet: raises).")
    parser.add_argument("--calibration-percentile", type=float, default=None,
                        help="int8 calibration percentile (not ported yet: raises).")
    parser.add_argument("--per-channel", action="store_true",
                        help="int8 per-channel scales (not ported yet: raises).")
    return parser.parse_args(argv)


def main(argv=None):
    flags = read_args(argv)
    given = sorted(k for k, v in CALIBRATION_DEFAULTS.items() if getattr(flags, k) != v)
    if given:
        raise NotImplementedError(
            f"package_model: {', '.join('--' + k.replace('_', '-') for k in given)}: int8 "
            "calibration is not ported yet (ROADMAP.md, item 2); no artifact was written")
    ckpt = CheckpointManager(flags.model)
    weights, step = ckpt.restore_state_dict(flags.which)
    export_model(flags.out, model_config(CheckpointManager.load_hparams(flags.model)), weights)
    result = {"out": flags.out, "step": step, "quantized_convs": 0}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
