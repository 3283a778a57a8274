"""Detection-training augmentations: random crop, color jitter, lighting.

The port's copy of ``object_keypoints_tpu/data/detection_augment.py`` (the
vendored sampler utilities, core/sample/utils.py:88-163, and the color ops
that sample/cornernet.py:96-99 calls): border-aware random crop with
detection remapping, the zero-padded crop around a point, resize and clip
of detections, brightness / contrast / saturation jitter in a random order,
and PCA lighting noise with the COCO eigen-decomposition. Host numpy and
cv2, used by ``cli.train_detector.batch_stream``; every draw comes from the
``numpy.random.Generator`` passed in, in the JAX package's order.
"""

from __future__ import annotations

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

# COCO PCA eigen-decomposition used by the reference's lighting_ (dbs/coco.py)
COCO_EIG_VAL = np.array([0.2141788, 0.01817699, 0.00341571], np.float32)
COCO_EIG_VEC = np.array(
    [
        [-0.58752847, -0.69563484, 0.41340352],
        [-0.5832747, 0.00994535, -0.81221408],
        [-0.56089297, 0.71832671, 0.41158938],
    ],
    np.float32,
)


def _get_border(border: int, size: int) -> int:
    """Largest border/2^k that leaves a valid crop-center range
    (sample/utils.py:88-92)."""
    i = 1
    while size - border // i <= border // i:
        i *= 2
    return border // i


def random_crop(image, detections, random_scales, view_size, border: int = 64,
                rng: np.random.Generator | None = None):
    """Scale-jittered random crop with detection remapping
    (sample/utils.py:94-128)."""
    rng = rng or np.random.default_rng()
    view_height, view_width = view_size
    image_height, image_width = image.shape[:2]

    scale = rng.choice(np.asarray(random_scales))
    height = int(view_height * scale)
    width = int(view_width * scale)

    cropped = np.zeros((height, width, 3), image.dtype)
    w_border = _get_border(border, image_width)
    h_border = _get_border(border, image_height)
    ctx = int(rng.integers(w_border, image_width - w_border))
    cty = int(rng.integers(h_border, image_height - h_border))

    x0, x1 = max(ctx - width // 2, 0), min(ctx + width // 2, image_width)
    y0, y1 = max(cty - height // 2, 0), min(cty + height // 2, image_height)
    left_w, right_w = ctx - x0, x1 - ctx
    top_h, bottom_h = cty - y0, y1 - cty

    cc_x, cc_y = width // 2, height // 2
    cropped[cc_y - top_h : cc_y + bottom_h, cc_x - left_w : cc_x + right_w] = (
        image[y0:y1, x0:x1]
    )

    out_dets = np.asarray(detections, np.float32).copy()
    if len(out_dets):
        out_dets[:, 0:4:2] += cc_x - left_w - x0
        out_dets[:, 1:4:2] += cc_y - top_h - y0
    return cropped, out_dets


def crop_image_around(image, center_yx, size, output_size=None):
    """Zero-padded crop of ``size`` centered at ``center_yx``, placed in the
    middle of an ``output_size`` canvas (sample/utils.py:130-163).

    Returns (cropped, border, offset): ``border`` = (y0, y1, x0, x1) of the
    valid region inside the canvas, ``offset`` = (dy, dx) mapping source
    pixel coords into canvas coords (subtract it).
    """
    if output_size is None:
        output_size = size
    cty, ctx = center_yx
    height, width = size
    o_height, o_width = output_size
    im_height, im_width = image.shape[:2]
    cropped = np.zeros((o_height, o_width, 3), image.dtype)

    x0, x1 = max(0, ctx - width // 2), min(ctx + width // 2, im_width)
    y0, y1 = max(0, cty - height // 2), min(cty + height // 2, im_height)
    left, right = ctx - x0, x1 - ctx
    top, bottom = cty - y0, y1 - cty

    cc_y, cc_x = o_height // 2, o_width // 2
    cropped[cc_y - top : cc_y + bottom, cc_x - left : cc_x + right] = (
        image[y0:y1, x0:x1]
    )
    border = np.array(
        [cc_y - top, cc_y + bottom, cc_x - left, cc_x + right], np.float32
    )
    offset = np.array([cty - o_height // 2, ctx - o_width // 2])
    return cropped, border, offset


def resize_image(image, detections, size):
    """Resize + detection remap (sample/cornernet.py _resize_image)."""
    h, w = image.shape[:2]
    new_h, new_w = size
    out = cv2.resize(image, (new_w, new_h))
    dets = np.asarray(detections, np.float32).copy()
    if len(dets):
        dets[:, 0:4:2] *= new_w / w
        dets[:, 1:4:2] *= new_h / h
    return out, dets


def clip_detections(image, detections):
    """Clip to image bounds, drop degenerate boxes
    (sample/cornernet.py _clip_detections)."""
    h, w = image.shape[:2]
    dets = np.asarray(detections, np.float32).copy()
    if not len(dets):
        return dets
    dets[:, 0:4:2] = np.clip(dets[:, 0:4:2], 0, w - 1)
    dets[:, 1:4:2] = np.clip(dets[:, 1:4:2], 0, h - 1)
    keep = ((dets[:, 2] - dets[:, 0]) > 0) & ((dets[:, 3] - dets[:, 1]) > 0)
    return dets[keep]


def _blend(alpha, image1, image2):
    image1 *= alpha
    image2 *= 1.0 - alpha
    image1 += image2


def grayscale(image):
    return cv2.cvtColor((image * 255).astype(np.uint8), cv2.COLOR_RGB2GRAY).astype(
        np.float32
    ) / 255.0


def color_jitter(image_f32, rng, var: float = 0.4):
    """Random-order brightness/contrast/saturation jitter on a float [0, 1]
    RGB image (the torchvision-style color_jittering_ the sampler calls)."""
    gs = grayscale(image_f32)
    gs_mean = gs.mean()

    def brightness(img, alpha):
        img *= alpha

    def contrast(img, alpha):
        _blend(alpha, img, np.full_like(img, gs_mean))

    def saturation(img, alpha):
        _blend(alpha, img, grayscale(img)[..., None].repeat(3, axis=2))

    fns = [brightness, contrast, saturation]
    rng.shuffle(fns)
    for fn in fns:
        fn(image_f32, 1.0 + rng.uniform(-var, var))
    return image_f32


def lighting(image_f32, rng, alphastd: float = 0.1,
             eig_val=COCO_EIG_VAL, eig_vec=COCO_EIG_VEC):
    """PCA lighting noise (AlexNet-style 'lighting_')."""
    alpha = rng.normal(scale=alphastd, size=3).astype(np.float32)
    image_f32 += eig_vec @ (eig_val * alpha)
    return image_f32
