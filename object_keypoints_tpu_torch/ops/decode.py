"""Heatmap decoding: box filter, max-pool NMS, sub-pixel peaks.

Counterpart of ``object_keypoints_tpu/ops/decode.py``. The JAX package vmaps
a per-channel function over channels and frames; here every function takes
maps with any leading batch dimensions, ``(..., H, W)``, so
``extract_peaks`` covers both ``extract_peaks`` and ``extract_peaks_batch``.

Tie order: ``lax.top_k`` returns equal scores lowest index first, and the
NMS output has plateaus of zeros, so top-K here is a stable descending sort
followed by a slice (``torch.topk`` promises no order for ties).
The box filter is a sum of shifted slices, not a convolution, so it stays
fp32 whatever the TF32 settings.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def box_filter(x, size: int = 5):
    """Sum over a size x size window with zero padding; x (..., H, W)."""
    pad = size // 2
    h, w = x.shape[-2:]
    xp = F.pad(x, (pad, pad, pad, pad))
    rows = sum(xp[..., dy:dy + h, :] for dy in range(size))
    return sum(rows[..., dx:dx + w] for dx in range(size))


def maxpool_nms(x, size: int = 5):
    """Keep only pixels equal to their size x size neighbourhood max (max
    pooling pads with -inf, so border maxima survive); x (..., H, W)."""
    h, w = x.shape[-2:]
    hmax = F.max_pool2d(x.reshape(-1, 1, h, w), size, stride=1, padding=size // 2)
    return torch.where(x == hmax.reshape(x.shape), x, torch.zeros_like(x))


def extract_peaks(probs, max_peaks: int = 32, threshold: float = 0.5, window: int = 5):
    """Peaks of every (H, W) map of ``probs`` (..., H, W).

    Returns points (..., K, 2) in (x, y), confidence (..., K) (the window
    sum of raw probability, which is the box-filter response at the peak)
    and valid (..., K), with K = max_peaks; the threshold applies to the
    suppressed box-filtered map.
    """
    lead, (h, w) = probs.shape[:-2], probs.shape[-2:]
    maps = probs.reshape(-1, h, w)
    b = maps.shape[0]
    suppressed = maxpool_nms(box_filter(maps, window), window)
    scores, idx = torch.sort(suppressed.reshape(b, -1), dim=-1, descending=True, stable=True)
    scores, idx = scores[:, :max_peaks], idx[:, :max_peaks]
    valid = scores > threshold
    py, px = idx // w, idx % w

    # window x window patches of the zero-padded raw map around each peak
    pad = window // 2
    padded = F.pad(maps, (pad, pad, pad, pad)).reshape(b, -1)
    di = torch.arange(window, device=probs.device)
    yy = py[:, :, None, None] + di[:, None]  # (b, K, window, 1)
    xx = px[:, :, None, None] + di  # (b, K, 1, window)
    lin = (yy * (w + 2 * pad) + xx).reshape(b, -1)
    win = padded.gather(1, lin).reshape(b, max_peaks, window, window)

    mass = win.sum(dim=(-2, -1))
    iy = (yy - pad).to(probs.dtype)
    ix = (xx - pad).to(probs.dtype)
    safe = torch.clamp(mass, min=1e-12)
    cy = (win * iy).sum(dim=(-2, -1)) / safe
    cx = (win * ix).sum(dim=(-2, -1)) / safe
    points = torch.stack([cx, cy], dim=-1)
    return (points.reshape(*lead, max_peaks, 2), mass.reshape(*lead, max_peaks),
            valid.reshape(*lead, max_peaks))
