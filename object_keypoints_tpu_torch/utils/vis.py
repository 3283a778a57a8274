"""Visualization helpers: labeled boxes for the detect CLI, heatmap
overlays and a live window for the eval CLI. The port's copy of
``object_keypoints_tpu/utils/vis.py``; host cv2/matplotlib, imported by the
functions that use them."""

from __future__ import annotations

import os

import numpy as np


def draw_bboxes(image, bboxes, font_size: float = 0.5, thresh: float = 0.5,
                colors=None, seed: int = 0):
    """Draw per-category labeled boxes. bboxes: {name: (n, 5) [x1,y1,x2,y2,
    score]}. Category colors default to a *seeded* palette so outputs are
    reproducible."""
    import cv2

    image = np.ascontiguousarray(image).copy()
    rng = np.random.default_rng(seed)
    for cat_name, dets in bboxes.items():
        dets = np.asarray(dets)
        if dets.size == 0:
            continue
        keep = dets[:, -1] > thresh
        if colors is None:
            color = (rng.random(3) * 0.6 + 0.4) * 255
            color = tuple(int(c) for c in color)
        else:
            color = tuple(int(c) for c in colors[cat_name])
        label_size = cv2.getTextSize(cat_name, cv2.FONT_HERSHEY_SIMPLEX, font_size, 2)[0]
        for det in dets[keep]:
            x1, y1, x2, y2 = det[:4].astype(np.int32)
            if y1 - label_size[1] - 2 < 0:
                ty0, ty1 = y1 + 2, y1 + label_size[1] + 2
            else:
                ty0, ty1 = y1 - label_size[1] - 2, y1 - 2
            cv2.rectangle(image, (x1, ty0), (x1 + label_size[0], ty1), color, -1)
            cv2.putText(image, cat_name, (x1, ty1), cv2.FONT_HERSHEY_SIMPLEX,
                        font_size, (0, 0, 0), thickness=1)
            cv2.rectangle(image, (x1, y1), (x2, y2), color, 2)
    return image


class LiveViewer:
    """Interactive playback window (the reference's hud overlay windows) for
    hosts WITH a display; without one (or without cv2) it prints one notice
    and shows nothing, and the frame-dump flags remain the durable path.

    Usage: viewer = LiveViewer("Keypoints"); viewer.show(rgb) per frame
    (returns False when the user closed the window / pressed q).
    """

    def __init__(self, title: str = "object_keypoints", wait_ms: int = 1):
        try:
            import cv2
        except ImportError:
            cv2 = None
        self._cv2 = cv2
        self.title = title
        self.wait_ms = wait_ms
        self._ok = cv2 is not None and bool(os.environ.get("DISPLAY"))
        self._warned = False

    def show(self, rgb_u8) -> bool:
        cv2 = self._cv2
        if not self._ok:
            if not self._warned:
                self._warned = True
                print(f"[{self.title}] no display — live view disabled "
                      "(use the frame-dump flag for overlays)")
            return True
        try:
            cv2.imshow(self.title, np.asarray(rgb_u8)[..., ::-1])  # RGB->BGR
            key = cv2.waitKey(self.wait_ms) & 0xFF
        except cv2.error:
            self._ok = False
            print(f"[{self.title}] cv2 window failed — live view disabled")
            return True
        return key not in (ord("q"), 27)

    def close(self):
        if self._ok:
            try:
                self._cv2.destroyWindow(self.title)
            except self._cv2.error:
                pass


def heatmap_overlay(rgb_u8, heatmaps, alpha: float = 0.7):
    """Composite summed heatmaps over an RGB frame. heatmaps: (H, W, K) or
    (K, H, W) in [0, 1]."""
    import cv2
    from matplotlib import cm

    h = np.asarray(heatmaps)
    if h.ndim == 3 and h.shape[0] < h.shape[-1]:
        h = np.transpose(h, (1, 2, 0))
    summed = np.clip(h.sum(axis=-1), 0.0, 1.0)
    colored = (cm.inferno(summed) * 255).astype(np.uint8)[..., :3]
    colored = cv2.resize(colored, rgb_u8.shape[:2][::-1])
    return ((1 - alpha) * rgb_u8 + alpha * colored).astype(np.uint8)
