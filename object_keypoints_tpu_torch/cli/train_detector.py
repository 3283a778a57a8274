"""CornerNet detector training CLI: a COCO-format set -> corner targets -> the iteration trainer.

    python -m object_keypoints_tpu_torch.cli.train_detector CornerNet_Squeeze \\
        --annotations data/coco/annotations/instances_train.json --images data/coco/train
    python -m object_keypoints_tpu_torch.cli.train_detector CornerNet_Squeeze --tiny --cpu \\
        --annotations /tmp/coco/annotations.json --images /tmp/coco/images --max-iter 20

The port of scripts/train_detector.py (the vendored corner_net_lite/train.py
entry point), with its flags and ``--cpu``: the paired system/db JSON of
``configs/<cfg>.json``, the model the config names (CornerNet,
CornerNet-Squeeze or CornerNet-Saccade; seeded weights), the threaded batch
stream (``batch_stream``: random crop or saccade crop, resize, flip, color
jitter and lighting, corner targets; host numpy and cv2), and
``training.detection.train_detector``. Batches go to the card through
``data.prefetch.device_prefetch`` from pinned memory. It runs on the card
unless ``--cpu``; the full-width models compute in bf16 over float32
parameters and the ``--tiny`` one in float32, as the JAX CLI's do.
Snapshots are ``<snapshot-dir>/<cfg>_<iter>.pth`` state_dicts, which the
eval CLI reads with ``--testiter``. ``--iter`` replays the step count for the
learning-rate schedule and Adam's bias corrections and, as in the JAX CLI,
loads no weights.
"""

import argparse
import os
import queue
import threading

import numpy as np
import torch

from object_keypoints_tpu_torch.data.coco import CocoDetectionDataset
from object_keypoints_tpu_torch.data.prefetch import device_prefetch
from object_keypoints_tpu_torch.models.cornernet import FACTORIES, tiny_cornernet
from object_keypoints_tpu_torch.training.detection import saccade_train_step, train_detector
from object_keypoints_tpu_torch.utils.config import (
    CONFIG_DIR,
    DetectionConfig,
    SystemConfig,
    load_cfg,
    tiny_db_overrides,
)


def read_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("cfg_file", help="Config name, e.g. CornerNet_Squeeze.")
    parser.add_argument("--annotations", required=True, help="COCO annotation json.")
    parser.add_argument("--images", required=True, help="Image directory.")
    parser.add_argument("--iter", dest="start_iter", type=int, default=0,
                        help="Resume from iteration (rebuilds the decayed LR).")
    parser.add_argument("--batch-size", type=int, default=None,
                        help="Override config batch size (no chunk_sizes needed).")
    parser.add_argument("--snapshot-dir", default="cache/nnet")
    parser.add_argument("--workers", type=int, default=2,
                        help="Prefetch threads (vendored uses processes).")
    parser.add_argument("--max-iter", type=int, default=None,
                        help="Override the config's max_iter.")
    parser.add_argument("--lr", type=float, default=None,
                        help="Override the config's learning_rate.")
    parser.add_argument("--snapshot-every", type=int, default=None,
                        help="Override the config's snapshot cadence.")
    parser.add_argument("--tiny", action="store_true",
                        help="Shrink the model + input contract (matches "
                        "evaluate_detector --tiny) for smoke and accuracy gates.")
    parser.add_argument("--cpu", action="store_true", help="Train on the CPU.")
    return parser.parse_args(argv)


def batch_stream(dataset, db_config, batch_size, workers, saccade=False):
    """Threaded COCO batch producer (the vendored prefetch processes,
    corner_net_lite/train.py:49-87): each worker ``i`` draws from its own
    ``np.random.default_rng(i)`` and yields numpy batches in the JAX
    package's layout (images (N, H, W, 3) normalized float32, NHWC heatmaps,
    ``attentions`` a tuple). With ``saccade=True`` it runs the
    crop-around-object zoom sampler (sample/cornernet_saccade.py) instead of
    the plain cornernet one. A worker's error is raised on the consumer's
    side; closing the generator stops the workers."""
    import cv2

    from object_keypoints_tpu_torch.data.detection_augment import (
        clip_detections,
        color_jitter,
        lighting,
        random_crop,
        resize_image,
    )
    from object_keypoints_tpu_torch.data.detection_targets import (
        render_corner_targets,
        saccade_sample,
    )
    from object_keypoints_tpu_torch.inference.detector import COCO_MEAN, COCO_STD

    input_size = db_config["input_size"]
    output_size = db_config["output_sizes"][0]
    categories = db_config["categories"]

    q: "queue.Queue" = queue.Queue(maxsize=4)
    stop = threading.Event()

    def make_batch(rng):
        images, targets = [], []
        for _ in range(batch_size):
            ind = int(rng.integers(len(dataset)))
            img = cv2.imread(dataset.image_path(ind))
            dets = dataset.detections(ind).copy()
            if saccade:
                # geometric part (zoom, crop around a ref object, flip,
                # attention/validity targets) lives in the sampler
                img, t = saccade_sample(img, dets, db_config, rng)
            else:
                # sampler pipeline (sample/cornernet.py:76-99)
                if db_config["rand_crop"]:
                    img, dets = random_crop(
                        img, dets, db_config["rand_scales"], input_size,
                        border=db_config["border"], rng=rng,
                    )
                img, dets = resize_image(img, dets, input_size)
                dets = clip_detections(img, dets)
                if rng.uniform() > 0.5:  # random horizontal flip
                    img = np.ascontiguousarray(img[:, ::-1])
                    if len(dets):
                        width = img.shape[1]
                        dets[:, [0, 2]] = width - dets[:, [2, 0]] - 1
                t = None
            img = img[..., ::-1].astype(np.float32) / 255.0  # bgr -> rgb
            if db_config["rand_color"]:
                img = color_jitter(img, rng)
                if db_config["lighting"]:
                    img = lighting(img, rng)
            img = (img - COCO_MEAN) / COCO_STD
            images.append(img)
            targets.append(
                t if t is not None else render_corner_targets(
                    dets, categories, input_size, output_size,
                    gaussian_bump=db_config["gaussian_bump"],
                    gaussian_iou=db_config["gaussian_iou"],
                    gaussian_rad=db_config["gaussian_radius"],
                )
            )
        batch = {"images": np.stack(images)}
        for key in targets[0]:
            if key == "attentions":
                batch[key] = tuple(np.stack([t[key][i] for t in targets])
                                   for i in range(len(targets[0][key])))
            else:
                batch[key] = np.stack([t[key] for t in targets])
        return batch

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def producer(seed):
        rng = np.random.default_rng(seed)
        try:
            while not stop.is_set():
                put(make_batch(rng))
        except Exception as e:  # surface it on the consumer's side
            put(e)

    for i in range(workers):
        threading.Thread(target=producer, args=(i,), name=f"batch_stream_{i}",
                         daemon=True).start()
    try:
        while True:
            item = q.get()
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()


def build_model(cfg_file: str, categories: int, tiny: bool):
    """(model, compute dtype): the --tiny model in float32, else the
    config's full-width model in bf16 over float32 parameters; weights from
    a torch.Generator seeded 0."""
    generator = torch.Generator().manual_seed(0)
    if tiny:
        return tiny_cornernet(cfg_file, categories, generator=generator), torch.float32
    return FACTORIES[cfg_file.split("-")[0]](categories, generator=generator), torch.bfloat16


def main(argv=None):
    flags = read_args(argv)

    sys_cfg_json, db_cfg_json = load_cfg(CONFIG_DIR / f"{flags.cfg_file}.json")
    if flags.tiny:
        db_cfg_json = dict(db_cfg_json, **tiny_db_overrides(flags.cfg_file))
    system_config = SystemConfig(snapshot_name=flags.cfg_file).update_config(sys_cfg_json)
    if flags.max_iter is not None:
        system_config.update_config({"max_iter": flags.max_iter})
    if flags.lr is not None:
        system_config.update_config({"learning_rate": flags.lr})
    if flags.snapshot_every is not None:
        system_config.update_config({"snapshot": flags.snapshot_every})
    db_config = DetectionConfig(db_cfg_json)
    batch_size = flags.batch_size or system_config.batch_size

    dataset = CocoDetectionDataset(flags.annotations, flags.images)
    model, dtype = build_model(flags.cfg_file, db_config["categories"], flags.tiny)
    device = "cpu" if flags.cpu else "cuda"

    os.makedirs(flags.snapshot_dir, exist_ok=True)
    saccade = flags.cfg_file.split("-")[0] == "CornerNet_Saccade"
    batches = device_prefetch(batch_stream(dataset, db_config, batch_size, flags.workers,
                                           saccade=saccade), device)
    try:
        return train_detector(
            model, system_config, batches,
            start_iter=flags.start_iter, snapshot_dir=flags.snapshot_dir,
            train_step_fn=saccade_train_step if saccade else None, device=device, dtype=dtype,
        )
    finally:
        batches.close()


if __name__ == "__main__":
    main()
