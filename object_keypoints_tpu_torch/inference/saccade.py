"""CornerNet-Saccade two-stage inference: attention pass -> zoom-in crops.

Counterpart of ``object_keypoints_tpu/inference/saccade.py`` (CornerNet-Lite's
core/test/cornernet_saccade.py:15-400). Stage 1 runs downsized views of the
whole image ("init sizes") through the model; attention peaks above
threshold, and the centres of confident stage-1 boxes, become zoom-in
locations; later stages crop those locations at their predicted scales,
decode the crops, and go on until ``att_max_crops`` crops ran or the
attention thresholds are spent. The boxes of every stage then get
per-class soft-NMS (sigma 0.7) and the ``max_per_image`` cap.

``SaccadeDetector`` runs a stage on the device: the raw uint8 frame goes up
once an image; each stage normalizes it, crops every location in one batch
(``crop_zoom_batch``: a fixed number of launches whatever the crop count),
runs the forward and the corner decode, max-pool-suppresses the attention
maps, and copies everything back in one transfer. The location bookkeeping
(``decode_atts``, ``get_ref_locs``, ``location_nms``, ``_rescale_remap``) is
the JAX package's host numpy, copied; the attention maps come back NHWC, as
the JAX model gives them, so that it reads them as it is.
"""

from __future__ import annotations

import functools
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from object_keypoints_tpu_torch.inference.detector import (
    COCO_MEAN,
    COCO_STD,
    NMS_ALGORITHMS,
    cap_detections,
)
from object_keypoints_tpu_torch.ops import nms as nms_ops
from object_keypoints_tpu_torch.ops.decode import maxpool_nms
from object_keypoints_tpu_torch.precision import no_tf32

NMS_SIGMA = 0.7  # the saccade's final soft-NMS (cornernet_saccade.py:383-391)


def crop_zoom(image, center, size, out_size):
    """Crop a (size) window at center and scale it into an out_size canvas
    (crop_image_gpu, cornernet_saccade.py:15-39) by cv2 on the host.
    image: (H, W, 3) float. Returns (canvas, offset)."""
    import cv2

    cty, ctx = int(center[0]), int(center[1])
    height, width = size
    o_height, o_width = out_size
    im_h, im_w = image.shape[:2]
    scale = o_height / max(height, width)

    x0, x1 = max(0, ctx - width // 2), min(ctx + width // 2, im_w)
    y0, y1 = max(0, cty - height // 2), min(cty + height // 2, im_h)
    left, right = ctx - x0, x1 - ctx
    top, bottom = cty - y0, y1 - cty

    cc_y, cc_x = o_height // 2, o_width // 2
    oy0, oy1 = cc_y - int(top * scale), cc_y + int(bottom * scale)
    ox0, ox1 = cc_x - int(left * scale), cc_x + int(right * scale)

    canvas = np.zeros((o_height, o_width, 3), np.float32)
    patch = image[y0:y1, x0:x1]
    if patch.size and (oy1 - oy0) > 0 and (ox1 - ox0) > 0:
        canvas[oy0:oy1, ox0:ox1] = cv2.resize(
            patch, (ox1 - ox0, oy1 - oy0), interpolation=cv2.INTER_LINEAR
        )
    return canvas, np.array([cty - height // 2, ctx - width // 2], np.float32)


def _gather_index(i, n: int):
    """The row (or column) a JAX gather reads for index i of an axis of n:
    a negative index counts from the end once, then any index out of range
    clamps to the nearest end. A CUDA gather out of range is a device-side
    assert, so every index is brought into range here."""
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def crop_zoom_batch(img, centers, sizes, out_size):
    """Crop-zoom every location of a batch in one pass on img's device.

    img (H, W, 3) float32; centers (M, 2) [y, x] and sizes (M, 2) [h, w],
    float. Returns (canvases (M, oh, ow, 3) float32, offsets (M, 2)). The
    counterpart of the JAX package's ``_crop_all_fn`` (saccade.py:61-131)
    and its arithmetic: the window edges of ``crop_zoom`` in int32
    (truncated toward zero), cv2's pixel-centre convention for the source
    coordinate, a clamp at the *patch* border to [lo, hi - 1.001] (which
    falls below lo on an empty or one-pixel patch, where JAX's gather wraps
    and clamps: ``_gather_index``), the far neighbours at min(i + 1, size -
    1), bilinear weights, and zeros outside the destination rectangle.
    """
    oh, ow = out_size
    im_h, im_w = img.shape[:2]
    dev = img.device
    cty = centers[:, 0].to(torch.int32)
    ctx = centers[:, 1].to(torch.int32)
    height = sizes[:, 0].to(torch.int32)
    width = sizes[:, 1].to(torch.int32)
    scale = oh / torch.clamp(torch.maximum(height, width), min=1).to(torch.float32)

    x0 = torch.clamp(ctx - width // 2, min=0)
    x1 = torch.clamp(ctx + width // 2, max=im_w)
    y0 = torch.clamp(cty - height // 2, min=0)
    y1 = torch.clamp(cty + height // 2, max=im_h)
    # the destination rectangle (crop_zoom's int arithmetic)
    oy0 = oh // 2 - ((cty - y0).to(torch.float32) * scale).to(torch.int32)
    oy1 = oh // 2 + ((y1 - cty).to(torch.float32) * scale).to(torch.int32)
    ox0 = ow // 2 - ((ctx - x0).to(torch.float32) * scale).to(torch.int32)
    ox1 = ow // 2 + ((x1 - ctx).to(torch.float32) * scale).to(torch.int32)

    # canvas pixel o <- image (o - o0 + 0.5) * s - 0.5 + lo, cv2's centres
    sy = (y1 - y0).to(torch.float32) / torch.clamp(oy1 - oy0, min=1)
    sx = (x1 - x0).to(torch.float32) / torch.clamp(ox1 - ox0, min=1)
    oys = torch.arange(oh, dtype=torch.float32, device=dev)
    oxs = torch.arange(ow, dtype=torch.float32, device=dev)
    src_y = (oys - oy0[:, None] + 0.5) * sy[:, None] - 0.5 + y0[:, None]
    src_x = (oxs - ox0[:, None] + 0.5) * sx[:, None] - 0.5 + x0[:, None]

    def sample_axis(coords, lo, hi):
        # replicate-clamp at the patch border like cv2.resize
        c = torch.minimum(torch.maximum(coords, lo.to(torch.float32)[:, None]),
                          hi.to(torch.float32)[:, None] - 1.001)
        i0 = torch.floor(c).to(torch.int32)
        return i0, c - i0

    yi, yf = sample_axis(src_y, y0, y1)
    xi, xf = sample_axis(src_x, x0, x1)
    rows = [_gather_index(i, im_h).long() * im_w
            for i in (yi, torch.clamp(yi + 1, max=im_h - 1))]
    cols = [_gather_index(i, im_w).long() for i in (xi, torch.clamp(xi + 1, max=im_w - 1))]
    flat = img.reshape(-1, 3)
    g00, g01, g10, g11 = (flat[r[:, :, None] + c[:, None, :]]
                          for r in rows for c in cols)
    yf, xf = yf[:, :, None, None], xf[:, None, :, None]
    interp = (g00 * ((1 - yf) * (1 - xf)) + g01 * ((1 - yf) * xf)
              + g10 * (yf * (1 - xf)) + g11 * (yf * xf))
    oy = torch.arange(oh, device=dev)[None, :, None]
    ox = torch.arange(ow, device=dev)[None, None, :]
    inside = ((oy >= oy0[:, None, None]) & (oy < oy1[:, None, None])
              & (ox >= ox0[:, None, None]) & (ox < ox1[:, None, None]))
    canvases = torch.where(inside[..., None], interp, 0.0)
    offsets = torch.stack([(cty - height // 2).to(torch.float32),
                           (ctx - width // 2).to(torch.float32)], dim=1)
    return canvases, offsets


def att_nms(atts, kernel_sizes):
    """Max-pool NMS per attention map (cornernet_saccade.py:49-55), on the
    maps' device. atts: (N, h, w, 1) NHWC maps; returns them as host
    arrays."""
    out = []
    for att, k in zip(atts, kernel_sizes):
        att = torch.as_tensor(att)
        out.append(maxpool_nms(att[..., 0], size=k)[..., None].cpu().numpy())
    return out


def decode_atts(config, atts, att_scales, scales, offsets, height, width,
                thresh, ignore_same=False):
    """Attention peaks -> next zoom locations (cornernet_saccade.py:100-133).
    atts: (N, h, w, 1) host maps. Returns (M, 4) [y, x, scale, score]."""
    att_ratios = config["att_ratios"]
    att_scales = np.atleast_1d(np.asarray(att_scales, np.float32))
    ys_out, xs_out, scales_out, scores_out = [], [], [], []
    num_views = atts[0].shape[0]
    for aind in range(num_views):
        for att, att_ratio, att_scale in zip(atts, att_ratios, att_scales):
            ys, xs = np.where(att[aind, :, :, 0] > thresh)
            scores = att[aind, ys, xs, 0]
            ys = ys * att_ratio / scales[aind] + offsets[aind, 0]
            xs = xs * att_ratio / scales[aind] + offsets[aind, 1]
            keep = (ys >= 0) & (ys < height) & (xs >= 0) & (xs < width)
            ys, xs, scores = ys[keep], xs[keep], scores[keep]
            next_scale = att_scale * scales[aind]
            if (ignore_same and att_scale <= 1) or scales[aind] > 2 or next_scale > 4:
                continue
            scales_out += [next_scale] * len(xs)
            scores_out += scores.tolist()
            ys_out += ys.tolist()
            xs_out += xs.tolist()
    if not ys_out:
        return np.zeros((0, 4), np.float32)
    return np.stack(
        [np.array(ys_out), np.array(xs_out), np.array(scales_out), np.array(scores_out)],
        axis=1,
    ).astype(np.float32)


def get_ref_locs(dets):
    """Zoom locations from confident detections
    (cornernet_saccade.py:135-156)."""
    dets = dets[dets[:, 4] > 0.5]
    if not len(dets):
        return np.zeros((0, 4), np.float32)
    ref_xs = (dets[:, 0] + dets[:, 2]) / 2
    ref_ys = (dets[:, 1] + dets[:, 3]) / 2
    maxhw = np.maximum(dets[:, 2] - dets[:, 0], dets[:, 3] - dets[:, 1])
    ref_scales = np.zeros_like(maxhw)
    ref_scales[maxhw > 96] = 192 / maxhw[maxhw > 96]
    ref_scales[(maxhw > 32) & (maxhw <= 96)] = 64 / maxhw[(maxhw > 32) & (maxhw <= 96)]
    ref_scales[maxhw <= 32] = 24 / maxhw[maxhw <= 32]
    out = np.stack([ref_ys, ref_xs, ref_scales, np.ones_like(maxhw)], axis=1)
    return out.astype(np.float32)


def location_nms(locations, thresh=15):
    """Greedy suppression of nearby same-scale zoom locations
    (cornernet_saccade.py:192-221). numpy's argsort, reversed, sets the
    order of tied scores, as in the JAX package."""
    if not len(locations):
        return np.zeros((0, 4), np.float32)
    order = np.argsort(locations[:, -1])[::-1]
    locations = locations[order]
    kept = []
    while len(locations):
        kept.append(locations[0])
        scale = locations[0, 2]
        dist = np.minimum(
            np.abs(locations[0, 0] - locations[:, 0]),
            np.abs(locations[0, 1] - locations[:, 1]),
        )
        ratio = locations[0, 2] / locations[:, 2]
        keep = (dist > (thresh / scale)) | (ratio > 1.2) | (ratio < 0.8)
        locations = locations[keep]
    return np.stack(kept)


def crop_sizes(config, locations):
    """The crop window (h, w) of each location: the input size over its
    scale, floored (cornernet_saccade.py:223-233)."""
    input_size = config["input_size"]
    return np.stack([np.floor(input_size[0] / locations[:, 2]),
                     np.floor(input_size[1] / locations[:, 2])], axis=1).astype(np.float32)


def crop_bucket(m: int) -> int:
    """The power-of-two crop count a stage of m locations pads to."""
    return 1 << max(0, int(m - 1).bit_length())


def pad_locations(config, locations) -> np.ndarray:
    """A stage's (M, >= 3) [y, x, scale, ...] locations -> the fused
    decode's (P, 4) [y, x, h, w] crop windows, P = ``crop_bucket(M)``; the
    pad rows crop at (1, 1) with scale 1 (saccade.py:435-441)."""
    padded = np.ones((crop_bucket(len(locations)), 3), np.float32)
    padded[:len(locations)] = locations[:, :3]
    return np.concatenate([padded[:, :2], crop_sizes(config, padded)], axis=1)


def _prepare_images(config, image, locations, device_crops: bool = True, device="cuda"):
    """The split route's crops of a normalized host image
    (cornernet_saccade.py:223-233): with ``device_crops``, one
    ``crop_zoom_batch`` on ``device``; else ``crop_zoom`` by cv2, one
    location at a time. Returns host (canvases, offsets)."""
    input_size = config["input_size"]
    if device_crops and len(locations):
        img = torch.from_numpy(np.ascontiguousarray(image, np.float32)).to(device)
        locs = torch.from_numpy(np.concatenate(
            [locations[:, :2], crop_sizes(config, locations)], axis=1)).to(device)
        canvases, offsets = crop_zoom_batch(img, locs[:, :2], locs[:, 2:], tuple(input_size))
        return canvases.cpu().numpy(), offsets.cpu().numpy()
    images = np.zeros((len(locations), input_size[0], input_size[1], 3), np.float32)
    offsets = np.zeros((len(locations), 2), np.float32)
    for ind, (y, x, scale) in enumerate(locations[:, :3]):
        crop_h = int(input_size[0] / scale)
        crop_w = int(input_size[1] / scale)
        images[ind], offsets[ind] = crop_zoom(image, (y, x), (crop_h, crop_w), input_size)
    return images, offsets


def _rescale_remap(config, dets, scales, offsets):
    """A stage's (M, num_dets, 8) detections from output-map pixels into
    the image's coordinates, in place."""
    input_size = config["input_size"]
    output_size = config["output_sizes"][0]
    dets[..., 0:4:2] /= output_size[1] / input_size[1]
    dets[..., 1:4:2] /= output_size[0] / input_size[0]
    xs, ys = dets[..., 0:4:2], dets[..., 1:4:2]
    xs /= scales.reshape(-1, 1, 1)
    ys /= scales.reshape(-1, 1, 1)
    xs += offsets[:, 1][:, None, None]
    ys += offsets[:, 0][:, None, None]


def cornernet_saccade_inference(config, decode_fn, image, device_crops: bool = True,
                                device="cuda", stats: Optional[List[dict]] = None
                                ) -> Dict[int, np.ndarray]:
    """Full two-stage saccade inference (cornernet_saccade.py:300-400) of
    one image (H, W, 3) uint8 -> {category (1-based): (n, 5) [x1, y1, x2,
    y2, score]}.

    decode_fn is one of two protocols, told apart by its ``crop_fused`` flag:

    - split: ``decode_fn(images (B, H, W, 3) float32 host, no_att) ->
      (detections (B, num_dets, 8), atts: (B, h, w, 1) maps or None)``;
      the driver crops (``_prepare_images``: on ``device`` when
      ``device_crops``) and, unless ``att_nms_fused``, suppresses the maps;
    - fused (``crop_fused``): ``decode_fn(image (H, W, 3) uint8 on device,
      centers (P, 2), sizes (P, 2), no_att) -> (detections, atts | None,
      offsets (P, 2))``, P the power-of-two bucket of the stage's M
      locations (pad rows at (1, 1), scale 1; their rows are dropped).

    Both return host arrays. ``no_att`` is set on the stage after which the
    loop stops, so its attention maps are never fetched. The final soft-NMS
    runs on ``device`` (``saccade_soft_nms``). With ``stats`` (a list), one
    dict a stage (crops, bucket, no_att, the locations, the count of
    locations it proposed for the next stage, the host-clock ms of the
    decode call and of the host bookkeeping after it) and one for the
    soft-NMS (rows, steps, ms) are appended.
    """
    init_sizes = config["init_sizes"]
    ref_dets = config["ref_dets"]
    att_thresholds = config["att_thresholds"]
    att_scales = config["att_scales"]
    att_max_crops = config["att_max_crops"]
    att_nms_ks = config["att_nms_ks"]
    num_iterations = len(att_thresholds)

    height, width = image.shape[:2]
    att_fused = getattr(decode_fn, "att_nms_fused", False)
    crop_fused = getattr(decode_fn, "crop_fused", False)
    if crop_fused:  # one upload of the raw frame an image
        img_dev = torch.from_numpy(np.ascontiguousarray(image)).to(device)
    else:
        norm = ((image.astype(np.float32) / 255.0) - COCO_MEAN) / COCO_STD
    clock = time.perf_counter

    def run_stage(locations, no_att):
        """One decode pass: (dets (M, num_dets, 8), atts list | None,
        offsets (M, 2)), pad rows dropped."""
        m = len(locations)
        if crop_fused:
            locs = torch.from_numpy(pad_locations(config, locations)).to(device)
            dets, atts, offsets = decode_fn(img_dev, locs[:, :2], locs[:, 2:], no_att)
            dets, offsets = np.array(dets[:m], copy=True), np.asarray(offsets[:m])
            if atts is not None:
                atts = [np.asarray(a[:m]) for a in atts]
            return dets, atts, offsets
        images, offsets = _prepare_images(config, norm, locations, device_crops, device)
        dets, atts = decode_fn(images, no_att)
        dets = np.array(dets, copy=True)
        if atts is not None:
            atts = [np.asarray(a) for a in atts] if att_fused else att_nms(atts, att_nms_ks)
        return dets, atts, offsets

    def record(stage, locations, no_att, proposed, t0, t1):
        if stats is not None:
            stats.append({"stage": stage, "crops": len(locations),
                          "bucket": crop_bucket(len(locations)) if crop_fused else len(locations),
                          "no_att": no_att, "locations": locations.copy(),
                          "proposed": proposed, "decode_ms": 1e3 * (t1 - t0),
                          "host_ms": 1e3 * (clock() - t1)})

    # stage 1: downsized full views
    locations = np.array(
        [[height // 2, width // 2, s / max(height, width)] for s in init_sizes],
        np.float32,
    )
    t0 = clock()
    dets, atts, offsets = run_stage(locations, False)
    t1 = clock()

    scales = locations[:, 2]
    next_locations = decode_atts(
        config, atts, att_scales[0], scales, offsets, height, width, att_thresholds[0]
    )
    _rescale_remap(config, dets, scales, offsets)
    dets = dets.reshape(-1, 8)
    dets = dets[dets[:, 4] > 0.3]
    if ref_dets:
        next_locations = np.concatenate([next_locations, get_ref_locs(dets)], axis=0)
        next_locations = location_nms(next_locations, thresh=16)
    record(0, locations, False, len(next_locations), t0, t1)

    all_dets = [dets]
    locations = next_locations
    num_crops = 0
    for ind in range(1, num_iterations + 1):
        if not len(locations):
            break
        if num_crops + len(locations) > att_max_crops:
            locations = locations[: att_max_crops - num_crops]
        num_crops += len(locations)
        # the loop stops after this stage: its attention is never read
        no_att = num_crops >= att_max_crops or ind >= num_iterations

        t0 = clock()
        dets, atts, offsets = run_stage(locations, no_att)
        t1 = clock()
        _rescale_remap(config, dets, locations[:, 2], offsets)
        dets = dets.reshape(-1, 8)
        dets = dets[dets[:, 4] > -1]
        all_dets.append(dets)

        if not no_att:
            next_locations = decode_atts(
                config, atts, att_scales[ind], locations[:, 2], offsets,
                height, width, att_thresholds[ind], ignore_same=True,
            )
            if ref_dets:
                next_locations = np.concatenate([next_locations, get_ref_locs(dets)], axis=0)
                next_locations = location_nms(next_locations, thresh=16)
        record(ind, locations, no_att, 0 if no_att else len(next_locations), t0, t1)
        if no_att:
            break
        locations = next_locations

    t0 = clock()
    detections = np.concatenate(all_dets, axis=0)
    top_bboxes, steps = saccade_soft_nms(config, detections, device)
    if stats is not None:
        stats.append({"stage": "nms", "rows": len(detections), "steps": steps,
                      "nms_ms": 1e3 * (clock() - t0)})
    return cap_detections(config, top_bboxes)


def saccade_soft_nms(config, detections: np.ndarray, device="cuda"):
    """Every stage's (n, 8) detections -> ({category (1-based): (n_j, 5)}, steps):
    per-class soft-NMS at sigma 0.7 (cornernet_saccade.py:383-391), every
    class padded to one power-of-two bucket and run as one batched loop on
    ``device`` for ``steps`` = the largest class's count of rows; rows that
    decayed to 0 are dropped."""
    categories = config["categories"]
    classes = detections[:, -1]
    per_class = [detections[classes == j][:, 0:5].astype(np.float32)
                 for j in range(categories)]
    n_max = max((len(d) for d in per_class), default=0)
    top_bboxes = {j + 1: np.zeros((0, 5), np.float32) for j in range(categories)}
    if not n_max:
        return top_bboxes, 0
    n_pad = 1 << max(4, (n_max - 1).bit_length())
    padded = torch.from_numpy(nms_ops.pad_class_dets(per_class, n_pad)).to(device)
    out = nms_ops.soft_nms_batch(padded, Nt=config["nms_threshold"],
                                 method=NMS_ALGORITHMS[config["nms_algorithm"]],
                                 sigma=NMS_SIGMA, steps=n_max).cpu().numpy()
    for j in range(categories):
        cls = out[j, : len(per_class[j])]
        cls = cls[cls[:, 4] > 0]
        if len(cls):
            top_bboxes[j + 1] = cls
    return top_bboxes, n_max


def _flagged(fn, **flags):
    """fn as a callable that carries the protocol flags the driver reads."""
    out = functools.partial(fn)
    out.__dict__.update(flags)
    return out


class SaccadeDetector:
    """The CornerNet-Saccade facade: call with an image (H, W, 3) uint8 (the
    detect CLI passes RGB), get {class name: (n, 5) boxes}.

    ``model`` is a ``models.cornernet.CornerNetModel`` with attention heads.
    It is moved, in place, to ``device`` in channels_last and eval mode;
    its parameters and BatchNorm statistics stay float32 and it computes in
    ``dtype``. Every stage runs on ``device`` (the card unless
    ``device="cpu"``) under inference mode with TF32 off, with one copy back
    a stage, and so does the soft-NMS.

    ``fused`` is the driver's fused decode_fn (upload once, crop, forward,
    decode and attention NMS on the device); ``split`` takes host crops.
    The steps are public so that a caller can time them apart:
    ``normalize``, ``crops``, ``frames``, ``forward`` and ``fetch``.
    """

    def __init__(self, model, config, class_names: Optional[dict] = None, device="cuda",
                 dtype=torch.bfloat16):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"SaccadeDetector: device {str(device)!r} asked for, but CUDA is "
                               "not available; pass device='cpu' to detect on the CPU")
        if not model.with_attention:
            raise ValueError("SaccadeDetector runs CornerNet-Saccade, a model with attention "
                             "heads; CornerNet and CornerNet-Squeeze run through Detector")
        self.model = model.to(device=device, memory_format=torch.channels_last).eval()
        self.config = config
        self.device, self.dtype = device, dtype
        self.class_names = class_names or {
            i: str(i) for i in range(1, config["categories"] + 1)
        }
        self.mean = torch.from_numpy(COCO_MEAN).to(device)
        self.std = torch.from_numpy(COCO_STD).to(device)
        self.split = _flagged(self.decode, att_nms_fused=True)
        self.fused = _flagged(self.decode_crops, att_nms_fused=True, crop_fused=True)

    def normalize(self, image):
        """A uint8 (H, W, 3) frame -> COCO-normalized float32, on its device."""
        mean, std = self.mean.to(image.device), self.std.to(image.device)
        return (image.to(torch.float32) / 255.0 - mean) / std

    @torch.inference_mode()
    def crops(self, image, centers, sizes):
        """``crop_zoom_batch`` of the normalized frame: (canvases, offsets)."""
        return crop_zoom_batch(self.normalize(image), centers, sizes,
                               tuple(self.config["input_size"]))

    @torch.inference_mode()
    def frames(self, canvases):
        """NHWC float32 canvases on the device -> contiguous NCHW frames in
        ``dtype``."""
        return canvases.permute(0, 3, 1, 2).to(dtype=self.dtype,
                                               memory_format=torch.contiguous_format).contiguous()

    @torch.inference_mode()
    def forward(self, frames, no_att: bool):
        """The model's test path with ``no_border`` on device frames:
        (detections (B, num_dets, 8) float32, the attention maps NCHW after
        the max-pool NMS, or None when ``no_att``)."""
        config = self.config
        with no_tf32():
            (dets, *_), atts = self.model(
                frames, test=True, K=config["top_k"], ae_threshold=config["ae_threshold"],
                kernel=config["nms_kernel"], num_dets=config["num_dets"], no_border=True)
        if no_att:
            return dets, None
        return dets, [maxpool_nms(a, size=k) for a, k in zip(atts, config["att_nms_ks"])]

    @staticmethod
    def fetch(dets, atts, offsets=None):
        """One copy back of a stage's device outputs, packed as float32:
        (dets, atts as NHWC (B, h, w, 1) | None, offsets | None) host
        arrays."""
        parts = [dets] + ([] if offsets is None else [offsets])
        parts += [a.permute(0, 2, 3, 1) for a in atts or ()]
        flat = torch.cat([p.reshape(-1).to(torch.float32) for p in parts]).cpu().numpy()
        out, start = [], 0
        for p in parts:
            out.append(flat[start:start + p.numel()].reshape(p.shape))
            start += p.numel()
        dets, rest = out[0], out[1:]
        if offsets is not None:
            offsets, rest = rest[0], rest[1:]
        return dets, (rest if atts is not None else None), offsets

    @torch.inference_mode()
    def decode(self, images, no_att: bool):
        """The split decode_fn: host NHWC float32 crops -> one upload,
        forward + decode, one copy back."""
        x = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(self.device)
        dets, atts = self.forward(self.frames(x), no_att)
        dets, atts, _ = self.fetch(dets, atts)
        return dets, atts

    @torch.inference_mode()
    def decode_crops(self, image, centers, sizes, no_att: bool):
        """The fused decode_fn: the device frame's crops, forward + decode,
        one copy back."""
        canvases, offsets = self.crops(image, centers, sizes)
        dets, atts = self.forward(self.frames(canvases), no_att)
        return self.fetch(dets, atts, offsets)

    def __call__(self, image, stats: Optional[List[dict]] = None) -> Dict[str, np.ndarray]:
        by_id = cornernet_saccade_inference(self.config, self.fused, image, device=self.device,
                                            stats=stats)
        return {self.class_names[j]: dets for j, dets in by_id.items()}
