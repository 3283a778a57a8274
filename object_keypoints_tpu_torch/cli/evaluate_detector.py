"""Detector evaluation CLI: a COCO-format split through a CornerNet detector -> COCOeval.

    python -m object_keypoints_tpu_torch.cli.evaluate_detector CornerNet_Squeeze \\
        --annotations data/coco/annotations/instances_val.json \\
        --image-dir data/coco/val --snapshot-dir cache/nnet --testiter 500000

The port of scripts/evaluate_detector.py (CornerNet-Lite's evaluate.py:16-103
and the dataset drives of core/test/cornernet.py:27-73 and
core/test/cornernet_saccade.py), with its flags and ``--cpu``: every image
of the split goes through the full multi-scale / flip inference
(``inference.detector.Detector``) or the two-stage saccade inference
(``inference.saccade.SaccadeDetector``), the boxes are written as COCO
``<result_dir>/<testiter>/<split>[/<suffix>]/results.json``, and the
official COCOeval protocol prints its 12-stat summary; the last line is
the JSON ``{"mAP", "images", "avg_time_s"}``. It runs on the card unless
``--cpu``; the full-width models compute in bf16 and the ``--tiny`` ones in
float32, as the JAX CLI's do.

Snapshots: ``<snapshot_dir>/<cfg>_<testiter>.pth``, a torch state_dict
under the reference hg_net's names (read by ``cli.detect.load_state_dict``).
The JAX CLI reads Orbax directories, which need JAX; ``--random`` runs
weights drawn from a seeded ``torch.Generator`` instead.
"""

import argparse
import json
import os

import torch

from object_keypoints_tpu_torch.cli.detect import load_state_dict
from object_keypoints_tpu_torch.data.coco import CocoDetectionDataset
from object_keypoints_tpu_torch.inference.detector import Detector
from object_keypoints_tpu_torch.inference.saccade import SaccadeDetector
from object_keypoints_tpu_torch.models.cornernet import FACTORIES, tiny_cornernet
from object_keypoints_tpu_torch.utils.config import (
    CONFIG_DIR,
    DetectionConfig,
    SystemConfig,
    load_cfg,
    tiny_db_overrides,
)
from object_keypoints_tpu_torch.utils.progress import Timer, stdout_to_tqdm
from object_keypoints_tpu_torch.utils.vis import draw_bboxes


def read_args(argv=None):
    parser = argparse.ArgumentParser(description="Evaluation Script")
    parser.add_argument("cfg_file", help="config name (evaluate.py:18-20)",
                        choices=["CornerNet", "CornerNet_Squeeze", "CornerNet_Saccade"])
    parser.add_argument("--annotations", required=True,
                        help="COCO-format annotation JSON for the split.")
    parser.add_argument("--image-dir", required=True,
                        help="Directory holding the split's images.")
    parser.add_argument("--testiter", default=None, type=int,
                        help="test at iteration i (evaluate.py:19-21); "
                        "defaults to the config's max_iter")
    parser.add_argument("--split", default="validation",
                        help="split name, used for the result dir layout only")
    parser.add_argument("--suffix", default=None, type=str)
    parser.add_argument("--snapshot-dir", default="cache/nnet",
                        help="Where <cfg>_<testiter>.pth state_dicts are.")
    parser.add_argument("--result-dir", default="results")
    parser.add_argument("--random", action="store_true",
                        help="Random weights (protocol smoke test; no snapshot).")
    parser.add_argument("--tiny", action="store_true",
                        help="The tiny model and input contract of the protocol smoke "
                        "tests (not in the reference).")
    parser.add_argument("--debug", action="store_true",
                        help="First 100 images only + bbox overlays "
                        "(core/test/cornernet.py:33-62)")
    parser.add_argument("--max-images", default=None, type=int,
                        help="Cap evaluated images (not in the reference; "
                        "useful on synthetic sets).")
    parser.add_argument("--cpu", action="store_true", help="Evaluate on the CPU.")
    return parser.parse_args(argv)


def main(argv=None):
    flags = read_args(argv)
    import cv2

    sys_cfg_json, db_cfg = load_cfg(CONFIG_DIR / f"{flags.cfg_file}.json")
    system_config = SystemConfig(snapshot_name=flags.cfg_file).update_config(sys_cfg_json)
    if flags.tiny:
        db_cfg = dict(db_cfg, **tiny_db_overrides(flags.cfg_file))
    config = DetectionConfig(db_cfg)

    # result dir layout parity: <result_dir>/<testiter>/<split>[/<suffix>]
    # (evaluate.py:42-48)
    test_iter = flags.testiter if flags.testiter is not None else system_config.max_iter
    result_dir = os.path.join(flags.result_dir, str(test_iter), flags.split)
    if flags.suffix is not None:
        result_dir = os.path.join(result_dir, flags.suffix)
    os.makedirs(result_dir, exist_ok=True)

    db = CocoDetectionDataset(flags.annotations, flags.image_dir)
    categories = config["categories"]

    generator = torch.Generator().manual_seed(0)
    if flags.tiny:
        model = tiny_cornernet(flags.cfg_file, categories, generator=generator)
        dtype = torch.float32
    else:
        model = FACTORIES[flags.cfg_file](categories, generator=generator)
        dtype = torch.bfloat16
    if not flags.random:
        name = (system_config.snapshot_name or "model") + f"_{test_iter}.pth"
        print(f"loading parameters at iteration: {test_iter}")
        model.load_state_dict(load_state_dict(os.path.join(flags.snapshot_dir, name)),
                              strict=True)
    facade = SaccadeDetector if model.with_attention else Detector
    detector = facade(model, config, device="cpu" if flags.cpu else "cuda", dtype=dtype)

    db_inds = db.db_inds[:100] if flags.debug else db.db_inds
    if flags.max_images is not None:
        db_inds = db_inds[:flags.max_images]

    debug_dir = os.path.join(result_dir, "debug")
    if flags.debug:
        os.makedirs(debug_dir, exist_ok=True)

    try:
        from tqdm import tqdm
    except ImportError:  # pragma: no cover
        tqdm = lambda it, **kw: it  # noqa: E731

    timer = Timer()
    top_bboxes = {}
    with stdout_to_tqdm():
        for ind in tqdm(range(len(db_inds)), ncols=80, desc="locating kps"):
            db_ind = int(db_inds[ind])
            image_id = db.image_ids[db_ind]
            image = cv2.imread(db.image_path(db_ind))
            if image is None:
                raise SystemExit(f"cannot read image {db.image_path(db_ind)}")

            timer.tic()
            named = detector(image[..., ::-1])
            timer.toc()
            top_bboxes[image_id] = {j: named[str(j)] for j in range(1, categories + 1)}

            if flags.debug:
                overlay = draw_bboxes(image, {db.class_names.get(j, str(j)): boxes
                                              for j, boxes in top_bboxes[image_id].items()})
                cv2.imwrite(os.path.join(debug_dir, f"{db_ind}.jpg"), overlay)
    print(f"average time: {timer.average_time}")

    result_json = os.path.join(result_dir, "results.json")
    detections = db.convert_to_coco(top_bboxes)
    with open(result_json, "w") as f:
        json.dump(detections, f)

    cls_ids = list(range(1, categories + 1))
    image_ids = [db.image_ids[int(i)] for i in db_inds]
    out = db.evaluate(result_json, cls_ids, image_ids)
    print(json.dumps({"mAP": out["mAP"], "images": len(image_ids),
                      "avg_time_s": timer.average_time}))
    return out


if __name__ == "__main__":
    main()
