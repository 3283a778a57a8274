"""Image + keypoint augmentation on the host (cv2/numpy).

The port's copy of ``object_keypoints_tpu/data/augment.py``, which stands in
for the reference's albumentations stack (SmallestMaxSize, CenterCrop,
RandomBrightnessContrast, RandomGamma, CLAHE(p=.1), Cutout(25x25, p=.5),
H/V flips). Geometry ops carry keypoints with albumentations' conventions
(out-of-frame keypoints are kept); photometric ops use its default
parameter ranges. cv2 is imported by the functions that use it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def smallest_max_size(image, keypoints, max_size: int):
    """Resize so the *smaller* side equals max_size (SmallestMaxSize)."""
    import cv2

    h, w = image.shape[:2]
    scale = max_size / min(h, w)
    new_w, new_h = int(round(w * scale)), int(round(h * scale))
    image = cv2.resize(image, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    return image, np.asarray(keypoints, np.float64) * scale


def center_crop(image, keypoints, height: int, width: int):
    h, w = image.shape[:2]
    y0 = (h - height) // 2
    x0 = (w - width) // 2
    image = image[y0 : y0 + height, x0 : x0 + width]
    keypoints = np.asarray(keypoints, np.float64) - np.array([x0, y0])
    return image, keypoints


def brightness_contrast_lut(rng, brightness_limit=0.2, contrast_limit=0.2):
    """256-entry LUT for RandomBrightnessContrast (brightness_by_max): on
    uint8 frames the per-pixel float math is one table gather."""
    alpha = 1.0 + rng.uniform(-contrast_limit, contrast_limit)
    beta = rng.uniform(-brightness_limit, brightness_limit)
    ramp = np.arange(256, dtype=np.float32) * alpha + beta * 255.0
    return np.clip(ramp, 0, 255).astype(np.uint8)


def gamma_lut(rng, gamma_limit=(80, 120)):
    gamma = rng.uniform(gamma_limit[0], gamma_limit[1]) / 100.0
    return (np.linspace(0, 1, 256) ** gamma * 255.0).astype(np.uint8)


def random_brightness_contrast(image, rng, brightness_limit=0.2, contrast_limit=0.2):
    return brightness_contrast_lut(rng, brightness_limit, contrast_limit)[image]


def random_gamma(image, rng, gamma_limit=(80, 120)):
    return gamma_lut(rng, gamma_limit)[image]


def clahe(image, rng, clip_limit=4.0, tile_grid=(8, 8)):
    """Contrast-limited AHE on the L channel (albumentations CLAHE)."""
    import cv2

    limit = rng.uniform(1.0, clip_limit)
    op = cv2.createCLAHE(clipLimit=limit, tileGridSize=tile_grid)
    lab = cv2.cvtColor(image, cv2.COLOR_RGB2LAB)
    lab[..., 0] = op.apply(lab[..., 0])
    return cv2.cvtColor(lab, cv2.COLOR_LAB2RGB)


def cutout(image, rng, num_holes=8, max_h=25, max_w=25, fill=0):
    """albumentations Cutout(max_h_size=25, max_w_size=25)."""
    out = image.copy()
    h, w = image.shape[:2]
    for _ in range(num_holes):
        cy = int(rng.integers(0, h))
        cx = int(rng.integers(0, w))
        y0, y1 = np.clip([cy - max_h // 2, cy + max_h // 2], 0, h)
        x0, x1 = np.clip([cx - max_w // 2, cx + max_w // 2], 0, w)
        out[y0:y1, x0:x1] = fill
    return out


def hflip(image, keypoints):
    image = image[:, ::-1]
    keypoints = np.asarray(keypoints, np.float64).copy()
    keypoints[:, 0] = (image.shape[1] - 1) - keypoints[:, 0]
    return image, keypoints


def vflip(image, keypoints):
    image = image[::-1]
    keypoints = np.asarray(keypoints, np.float64).copy()
    keypoints[:, 1] = (image.shape[0] - 1) - keypoints[:, 1]
    return image, keypoints


class AugmentationPipeline:
    """Resize/crop (always) + photometric/flip augmentations (train only).
    Call with an RGB uint8 frame and (P, 2) keypoints; returns the
    transformed pair."""

    def __init__(self, image_size: Tuple[int, int], augment: bool = False):
        self.image_size = tuple(image_size)  # (height, width)
        self.augment = augment

    def geometry(self, image, keypoints):
        """The deterministic resize+crop prefix, safe to cache across epochs."""
        image, keypoints = smallest_max_size(image, keypoints, max(self.image_size))
        image, keypoints = center_crop(image, keypoints, *self.image_size)
        return np.ascontiguousarray(image), keypoints

    def photometric(self, image, keypoints, rng: np.random.Generator | None = None):
        """The stochastic suffix (photometric + flips). Never mutates its
        input; draws from ``rng`` in the JAX package's order, so a seeded
        stream gives the same frames there and here."""
        rng = rng or np.random.default_rng()
        if self.augment:
            # brightness/contrast then gamma as one composed LUT gather
            bc = brightness_contrast_lut(rng)
            g = gamma_lut(rng)
            image = g[bc][image]
            if rng.uniform() < 0.1:
                image = clahe(image, rng)
            if rng.uniform() < 0.5:
                image = cutout(image, rng)
            if rng.uniform() < 0.5:
                image, keypoints = hflip(image, keypoints)
            if rng.uniform() < 0.5:
                image, keypoints = vflip(image, keypoints)
        return np.ascontiguousarray(image), keypoints

    def __call__(self, image, keypoints, rng: np.random.Generator | None = None):
        image, keypoints = self.geometry(image, keypoints)
        return self.photometric(image, keypoints, rng)
