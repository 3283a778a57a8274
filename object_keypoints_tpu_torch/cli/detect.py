"""Detection demo CLI: a CornerNet detector on one image -> a labeled overlay.

    python -m object_keypoints_tpu_torch.cli.detect image.jpg --random
    python -m object_keypoints_tpu_torch.cli.detect image.jpg --arch CornerNet \
        --snapshot cornernet.pth --out detections.jpg
    python -m object_keypoints_tpu_torch.cli.detect image.jpg --arch CornerNet_Saccade --random

The port of scripts/detect.py, with its flags and ``--cpu``. The model is
built from ``configs/<arch>.json`` and computes in bf16, as the JAX CLI's
does; it runs on the card unless ``--cpu``. ``--snapshot`` is a torch
state_dict file under the reference hg_net's names (a Lightning checkpoint's
``state_dict`` unwrapped, its ``model.`` and any DataParallel ``module.``
prefix dropped); the JAX CLI's Orbax snapshots need JAX and are not read
here. ``--random`` runs weights drawn from a seeded ``torch.Generator``.
CornerNet and CornerNet_Squeeze run through ``inference.detector.Detector``,
CornerNet_Saccade through its two-stage inference
(``inference.saccade.SaccadeDetector``).
"""

import argparse

import torch

from object_keypoints_tpu_torch.inference.detector import Detector
from object_keypoints_tpu_torch.inference.saccade import SaccadeDetector
from object_keypoints_tpu_torch.models.cornernet import FACTORIES
from object_keypoints_tpu_torch.utils.config import CONFIG_DIR, DetectionConfig, load_cfg
from object_keypoints_tpu_torch.utils.vis import draw_bboxes


def read_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("image", help="Input image path.")
    parser.add_argument("--arch", default="CornerNet_Squeeze",
                        choices=["CornerNet", "CornerNet_Squeeze", "CornerNet_Saccade"])
    parser.add_argument("--snapshot", default=None,
                        help="torch state_dict file under the reference hg_net's names.")
    parser.add_argument("--random", action="store_true",
                        help="Random weights (pipeline smoke test).")
    parser.add_argument("--out", default="detections.jpg")
    parser.add_argument("--cpu", action="store_true", help="Detect on the CPU.")
    return parser.parse_args(argv)


def load_state_dict(path: str) -> dict:
    """A torch checkpoint -> a state_dict under the reference names."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:  # Lightning checkpoint
        obj = {k.removeprefix("model."): v for k, v in obj["state_dict"].items()}
    if not isinstance(obj, dict):
        obj = obj.state_dict()
    out = {}
    for k, v in obj.items():
        while k.startswith("module."):  # DataParallel wrappers
            k = k.removeprefix("module.")
        out[k] = v
    return out


def main(argv=None):
    flags = read_args(argv)
    import cv2

    if not (flags.snapshot or flags.random):
        raise SystemExit("provide --snapshot or pass --random for a smoke test")
    _, db_cfg = load_cfg(CONFIG_DIR / f"{flags.arch}.json")
    config = DetectionConfig(db_cfg)
    model = FACTORIES[flags.arch](config["categories"], generator=torch.Generator().manual_seed(0))
    if flags.snapshot:
        model.load_state_dict(load_state_dict(flags.snapshot), strict=True)

    image = cv2.imread(flags.image)
    if image is None:
        raise SystemExit(f"cannot read image {flags.image}")
    facade = SaccadeDetector if model.with_attention else Detector
    detector = facade(model, config, device="cpu" if flags.cpu else "cuda", dtype=torch.bfloat16)
    named = detector(image[..., ::-1])

    overlay = draw_bboxes(image, named, thresh=0.3)
    cv2.imwrite(flags.out, overlay)
    n = sum(len(v[v[:, 4] > 0.3]) if len(v) else 0 for v in named.values())
    print(f"{n} detections above 0.3 -> {flags.out}")
    return named


if __name__ == "__main__":
    main()
