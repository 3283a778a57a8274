"""CornerNet inference: multi-scale, flip test, per-class soft-NMS.

Counterpart of ``object_keypoints_tpu/inference/detector.py``
(CornerNet-Lite's core/test/cornernet.py:75-176 and core/base.py:5-25). For
each test scale the image is resized and padded to ``size | 127`` on the
host, with its horizontal flip as a second frame when ``test_flipped``;
the model's forward and corner decode run on the card, one call a scale;
the detections come back, are un-flipped and rescaled into the image's
coordinates on the host; then every class's soft-NMS runs on the card as
one batched loop (``ops.nms``) and the host caps the result at
``max_per_image``. The host geometry is the JAX package's, copied.

The steps are public so that a caller can time them apart:
``scale_batch`` (host prefix), ``Detector.decode`` (upload, forward, decode,
copy back), ``rescale_scale`` and ``class_soft_nms`` (upload, loop, copy
back) and ``cap_detections`` (host tail).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from object_keypoints_tpu_torch.ops import nms as nms_ops
from object_keypoints_tpu_torch.precision import no_tf32

# COCO normalization of CornerNet-Lite's dbs (core/dbs/coco.py)
COCO_MEAN = np.array([0.40789654, 0.44719302, 0.47026115], np.float32)
COCO_STD = np.array([0.28863828, 0.27408164, 0.27809835], np.float32)

NMS_ALGORITHMS = {"nms": 0, "linear_soft_nms": 1, "exp_soft_nms": 2}


def crop_image(image, center, size):
    """Center-pad/crop to a fixed size (core/sample/utils.py crop_image).
    Returns (canvas, border, offset)."""
    cty, ctx = center
    height, width = size
    im_h, im_w = image.shape[:2]
    canvas = np.zeros((height, width, 3), dtype=image.dtype)

    x0, x1 = max(0, ctx - width // 2), min(ctx + width // 2, im_w)
    y0, y1 = max(0, cty - height // 2), min(cty + height // 2, im_h)

    left, right = ctx - x0, x1 - ctx
    top, bottom = cty - y0, y1 - cty

    cc_y, cc_x = height // 2, width // 2
    y_slice = slice(cc_y - top, cc_y + bottom)
    x_slice = slice(cc_x - left, cc_x + right)
    canvas[y_slice, x_slice] = image[y0:y1, x0:x1]

    border = np.array([cc_y - top, cc_y + bottom, cc_x - left, cc_x + right], np.float32)
    offset = np.array([cty - height // 2, ctx - width // 2])
    return canvas, border, offset


def rescale_detections(detections, ratios, borders, sizes):
    """Undo the resize/pad into original image coords
    (test/cornernet.py:14-21). In place."""
    xs, ys = detections[..., 0:4:2], detections[..., 1:4:2]
    xs /= ratios[:, 1][:, None, None]
    ys /= ratios[:, 0][:, None, None]
    xs -= borders[:, 2][:, None, None]
    ys -= borders[:, 0][:, None, None]
    np.clip(xs, 0, sizes[:, 1][:, None, None], out=xs)
    np.clip(ys, 0, sizes[:, 0][:, None, None], out=ys)
    return detections


def scale_batch(config, image: np.ndarray, scale: float):
    """The host prefix of one test scale: resize, pad to ``size | 127``,
    COCO-normalize, and append the horizontal flip when ``test_flipped``.
    Returns (batch (B, H, W, 3) float32 NHWC, geometry for
    ``rescale_scale``)."""
    import cv2

    input_size, output_size = config["input_size"], config["output_sizes"][0]
    height, width = image.shape[:2]
    height_scale = (input_size[0] + 1) // output_size[0]
    width_scale = (input_size[1] + 1) // output_size[1]

    new_height = int(height * scale)
    new_width = int(width * scale)
    inp_height = new_height | 127
    inp_width = new_width | 127
    out_height = (inp_height + 1) // height_scale
    out_width = (inp_width + 1) // width_scale

    resized = cv2.resize(image, (new_width, new_height))
    padded, border, _ = crop_image(
        resized, (new_height // 2, new_width // 2), (inp_height, inp_width)
    )
    normalized = ((padded.astype(np.float32) / 255.0) - COCO_MEAN) / COCO_STD

    batch = normalized[None]
    if config["test_flipped"]:
        batch = np.concatenate([batch, batch[:, :, ::-1]], axis=0)
    geometry = dict(
        ratios=np.array([[out_height / inp_height, out_width / inp_width]], np.float32),
        borders=border[None], sizes=np.array([[new_height, new_width]], np.float32),
        out_width=out_width, scale=scale,
    )
    return batch, geometry


def rescale_scale(config, dets: np.ndarray, geometry) -> np.ndarray:
    """One scale's (B, num_dets, 8) detections (a writable copy) -> (1, n, 8)
    in the image's coordinates: the flipped frame's boxes mirrored back and
    appended, then the resize and pad undone."""
    if config["test_flipped"]:
        dets[1, :, [0, 2]] = geometry["out_width"] - dets[1, :, [2, 0]]
        dets = dets.reshape(1, -1, 8)
    rescale_detections(dets, geometry["ratios"], geometry["borders"], geometry["sizes"])
    dets[:, :, 0:4] /= geometry["scale"]
    return dets


def class_soft_nms(config, detections: np.ndarray, device="cuda"):
    """(n, 8) detections of every scale -> ({category (1-based): (n_j, 5)
    [x1, y1, x2, y2, score]}, steps). Rejected pairings (score -1) are
    dropped; each class's rows pad to a shared power-of-two bucket and all
    classes run as one batched loop on ``device`` (``soft_nms_merge_batch``
    when ``merge_bbox``), for ``steps`` = the largest class's count of real
    rows; rows that decayed to 0 are dropped."""
    categories = config["categories"]
    method = NMS_ALGORITHMS[config["nms_algorithm"]]
    classes = detections[:, -1]
    keep = detections[:, 4] > -1
    detections, classes = detections[keep], classes[keep]

    per_class = [detections[classes == j][:, 0:7].astype(np.float32)
                 for j in range(categories)]
    n_max = max((len(d) for d in per_class), default=0)
    top_bboxes: Dict[int, np.ndarray] = {
        j + 1: np.zeros((0, 5), np.float32) for j in range(categories)}
    if not n_max:
        return top_bboxes, 0
    n_pad = 1 << max(4, (n_max - 1).bit_length())
    if config["merge_bbox"]:
        padded = torch.from_numpy(nms_ops.pad_class_dets(per_class, n_pad, width=7)).to(device)
        out = nms_ops.soft_nms_merge_batch(padded, Nt=config["nms_threshold"], method=method,
                                           weight_exp=config["weight_exp"], steps=n_max)
    else:
        padded = torch.from_numpy(
            nms_ops.pad_class_dets([d[:, :5] for d in per_class], n_pad)).to(device)
        out = nms_ops.soft_nms_batch(padded, Nt=config["nms_threshold"], method=method,
                                     steps=n_max)
    out = out.cpu().numpy()
    for j in range(categories):
        cls = out[j, : len(per_class[j])]
        cls = cls[cls[:, 4] > 0]
        if len(cls):
            top_bboxes[j + 1] = cls[:, 0:5]
    return top_bboxes, n_max


def cap_detections(config, top_bboxes: Dict[int, np.ndarray]) -> Dict[int, np.ndarray]:
    """Keep the ``max_per_image`` best scores over all classes (ties at the
    threshold all stay). In place."""
    categories = config["categories"]
    scores = np.hstack([top_bboxes[j][:, -1] for j in range(1, categories + 1)])
    if len(scores) > config["max_per_image"]:
        kth = len(scores) - config["max_per_image"]
        thresh = np.partition(scores, kth)[kth]
        for j in range(1, categories + 1):
            top_bboxes[j] = top_bboxes[j][top_bboxes[j][:, -1] >= thresh]
    return top_bboxes


def cornernet_inference(config, decode_fn: Callable, image: np.ndarray,
                        device="cuda") -> Dict[int, np.ndarray]:
    """One image (H, W, 3) -> {category (1-based): (n, 5) [x1, y1, x2, y2,
    score]}.

    config: a ``utils.config.DetectionConfig`` or dict; decode_fn(batch NHWC
    float32 numpy, K, ae_threshold, kernel, num_dets) -> (B, num_dets, 8)
    detections as a numpy array; the soft-NMS runs on ``device``."""
    all_dets = []
    for scale in config["test_scales"]:
        batch, geometry = scale_batch(config, image, scale)
        dets = np.array(
            decode_fn(batch, K=config["top_k"], ae_threshold=config["ae_threshold"],
                      kernel=config["nms_kernel"], num_dets=config["num_dets"]),
            dtype=np.float32, copy=True,  # rescale edits in place
        )
        all_dets.append(rescale_scale(config, dets, geometry))
    detections = np.concatenate(all_dets, axis=1)[0]
    top_bboxes, _ = class_soft_nms(config, detections, device)
    return cap_detections(config, top_bboxes)


class Detector:
    """The detector facade: call with an image (H, W, 3) uint8 (the detect
    CLI passes RGB), get {class name: (n, 5) boxes}.

    ``model`` is a ``models.cornernet.CornerNetModel`` (CornerNet or
    CornerNet-Squeeze: the saccade model has its own multi-stage inference). It
    is moved, in place, to ``device`` in channels_last and eval mode; its
    parameters and BatchNorm statistics stay float32 and it computes in
    ``dtype``. The forward and the decode run on ``device`` (the card unless
    ``device="cpu"``) under inference mode with TF32 off, one upload and one
    copy back a scale, and so does the soft-NMS."""

    def __init__(self, model, config, class_names: Optional[dict] = None, device="cuda",
                 dtype=torch.bfloat16):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Detector: device {str(device)!r} asked for, but CUDA is not "
                               "available; pass device='cpu' to detect on the CPU")
        if model.with_attention:
            raise ValueError("Detector runs the single-pass CornerNet and CornerNet-Squeeze; "
                             "CornerNet-Saccade needs its multi-stage inference")
        self.model = model.to(device=device, memory_format=torch.channels_last).eval()
        self.config = config
        self.device, self.dtype = device, dtype
        self.class_names = class_names or {
            i: str(i) for i in range(1, config["categories"] + 1)
        }

    @torch.inference_mode()
    def frames(self, batch: np.ndarray):
        """A host NHWC float32 batch -> contiguous NCHW frames in ``dtype``
        on the device: one upload, one layout-and-type copy there."""
        x = torch.from_numpy(np.ascontiguousarray(batch)).to(self.device)
        return x.permute(0, 3, 1, 2).to(dtype=self.dtype, memory_format=torch.contiguous_format)

    @torch.inference_mode()
    def forward(self, frames, **decode_kwargs):
        """The model's test path on device frames: detections (B, num_dets,
        8) float32 on the device."""
        with no_tf32():
            return self.model(frames, test=True, **decode_kwargs)[0]

    def decode(self, batch: np.ndarray, **decode_kwargs) -> np.ndarray:
        """``cornernet_inference``'s decode_fn: upload, forward + decode,
        copy the detections back."""
        return self.forward(self.frames(batch), **decode_kwargs).cpu().numpy()

    def __call__(self, image) -> Dict[str, np.ndarray]:
        by_id = cornernet_inference(self.config, self.decode, image, self.device)
        return {self.class_names[j]: dets for j, dets in by_id.items()}
