"""Photometric augmentation, cutout and flips on the frames' device, batched.

Counterpart of ``object_keypoints_tpu/data/augment_device.py``, the
in-step analog of the host pipeline's ``AugmentationPipeline.photometric``
(``data/augment.py``). Frames are (B, H, W, 3) on any device and every
example draws its own parameters from one ``torch.Generator`` on that
device. The pure functions take their draws explicitly, so a test can hand
the same draws to two devices.

Parity with the host pipeline (albumentations semantics, the reference's
perception/datasets/video.py:85-100):

- brightness/contrast then gamma reproduce the host's composed uint8 LUTs up
  to float rounding: the LUTs floor at each uint8 stage, so ``apply_bcg``
  floors twice (within one uint8 step of the LUTs);
- cutout: 8 holes around integer centers drawn uniformly over the frame,
  each the half-open window [c - 12, c + 12) in both axes, fill 0;
- H/V flips mirror the frame and map keypoints with the same
  (size - 1) - x convention;
- CLAHE (p = 0.1 on the host path) is skipped, as in the JAX package
  (PARITY.md:100-107): adaptive histogram equalization is host-bound cv2.

Distributions match the host's (brightness and contrast U(-0.2, 0.2), gamma
U(0.8, 1.2), p = 0.5 for cutout and each flip); the streams do not: torch's
and numpy's draws differ, so the paths agree in distribution, not sample by
sample.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class PhotometricDraws(NamedTuple):
    """One batch's draws, each (B,) or (B, holes)."""

    alpha: torch.Tensor  # contrast: 1 + U(-0.2, 0.2)
    beta: torch.Tensor  # brightness: U(-0.2, 0.2)
    gamma: torch.Tensor  # U(0.8, 1.2)
    do_cutout: torch.Tensor  # bool
    hole_y: torch.Tensor  # (B, holes) integer centers
    hole_x: torch.Tensor
    do_hflip: torch.Tensor  # bool
    do_vflip: torch.Tensor  # bool


def _per_example(t: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1, 1, 1), to broadcast over (B, H, W, 3) frames."""
    return t.reshape(-1, 1, 1, 1)


def apply_bcg(frames, alpha, beta, gamma):
    """Brightness/contrast then gamma on [0, 255] float frames (B, H, W, 3)
    with the host LUTs' two uint8 floors; alpha, beta, gamma (B,)."""
    x = torch.floor(torch.clamp(frames * _per_example(alpha) + _per_example(beta) * 255.0,
                                0.0, 255.0))
    return torch.floor((x / 255.0) ** _per_example(gamma) * 255.0)


def _uniform(shape, low, high, generator, device):
    return low + (high - low) * torch.rand(shape, generator=generator, device=device)


def _draw_bcg(b, generator, device, brightness_limit=0.2, contrast_limit=0.2,
              gamma_limit=(0.8, 1.2)):
    alpha = 1.0 + _uniform((b,), -contrast_limit, contrast_limit, generator, device)
    beta = _uniform((b,), -brightness_limit, brightness_limit, generator, device)
    gamma = _uniform((b,), gamma_limit[0], gamma_limit[1], generator, device)
    return alpha, beta, gamma


def _draw_holes(b, h, w, num_holes, generator, device):
    return (torch.randint(0, h, (b, num_holes), generator=generator, device=device),
            torch.randint(0, w, (b, num_holes), generator=generator, device=device))


def brightness_contrast_gamma(frames, generator: Optional[torch.Generator] = None,
                              brightness_limit: float = 0.2, contrast_limit: float = 0.2,
                              gamma_limit=(0.8, 1.2)):
    """Draw (alpha, beta, gamma) per example like the host pipeline and apply."""
    return apply_bcg(frames, *_draw_bcg(frames.shape[0], generator, frames.device,
                                        brightness_limit, contrast_limit, gamma_limit))


def cut_holes(frames, hole_y, hole_x, max_h: int = 25, max_w: int = 25):
    """Zero, in each frame, the windows [y - max_h // 2, y + max_h // 2) x
    [x - max_w // 2, x + max_w // 2) around its hole centers (B, holes)."""
    _, h, w, _ = frames.shape
    ys = torch.arange(h, device=frames.device)
    xs = torch.arange(w, device=frames.device)
    rows = (ys >= hole_y[..., None] - max_h // 2) & (ys < hole_y[..., None] + max_h // 2)
    cols = (xs >= hole_x[..., None] - max_w // 2) & (xs < hole_x[..., None] + max_w // 2)
    hole = (rows[:, :, :, None] & cols[:, :, None, :]).any(dim=1)  # (B, H, W)
    return torch.where(hole[..., None], 0.0, frames)


def cutout(frames, generator: Optional[torch.Generator] = None, num_holes: int = 8,
           max_h: int = 25, max_w: int = 25):
    """albumentations Cutout (video.py:93): ``num_holes`` windows around
    integer centers drawn uniformly over each frame, set to 0."""
    b, h, w, _ = frames.shape
    return cut_holes(frames, *_draw_holes(b, h, w, num_holes, generator, frames.device),
                     max_h, max_w)


def flip_device(frames, keypoints, do_h, do_v):
    """Mirror each frame (B, H, W, C) where ``do_h`` (horizontally) or
    ``do_v`` (vertically), (B,) bools, and map its keypoints (B, P, 2) (x,
    y) with the host's (size - 1) - coord convention."""
    _, h, w, _ = frames.shape
    frames = torch.where(_per_example(do_h), frames.flip(2), frames)
    frames = torch.where(_per_example(do_v), frames.flip(1), frames)
    x = torch.where(do_h[:, None], (w - 1) - keypoints[..., 0], keypoints[..., 0])
    y = torch.where(do_v[:, None], (h - 1) - keypoints[..., 1], keypoints[..., 1])
    return frames, torch.stack([x, y], dim=-1)


def draw_photometric(b: int, h: int, w: int, generator: Optional[torch.Generator] = None,
                     device=None, num_holes: int = 8) -> PhotometricDraws:
    """Every draw of ``photometric_device`` for a batch of b frames of h x w."""
    alpha, beta, gamma = _draw_bcg(b, generator, device)
    do_cutout = torch.rand((b,), generator=generator, device=device) < 0.5
    hole_y, hole_x = _draw_holes(b, h, w, num_holes, generator, device)
    flips = torch.rand((2, b), generator=generator, device=device) < 0.5
    return PhotometricDraws(alpha, beta, gamma, do_cutout, hole_y, hole_x, flips[0], flips[1])


def apply_photometric(frames_u8, keypoints, draws: PhotometricDraws):
    """bc/gamma -> (CLAHE skipped) -> cutout -> hflip -> vflip with explicit
    draws. frames_u8 (B, H, W, 3) uint8, keypoints (B, P, 2) image-space
    (x, y). Returns ([0, 255] float32 frames, transformed keypoints)."""
    frames = apply_bcg(frames_u8.to(torch.float32), draws.alpha, draws.beta, draws.gamma)
    frames = torch.where(_per_example(draws.do_cutout),
                         cut_holes(frames, draws.hole_y, draws.hole_x), frames)
    return flip_device(frames, keypoints, draws.do_hflip, draws.do_vflip)


def photometric_device(frames_u8, keypoints, generator: Optional[torch.Generator] = None):
    """The stochastic suffix of a batch, each example drawn on its own from
    ``generator`` (on the frames' device): bc/gamma -> (CLAHE skipped) ->
    cutout (p = .5) -> hflip (p = .5) -> vflip (p = .5)."""
    b, h, w, _ = frames_u8.shape
    draws = draw_photometric(b, h, w, generator, frames_u8.device)
    return apply_photometric(frames_u8, keypoints, draws)
