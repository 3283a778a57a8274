"""COCO-format detection dataset (annotation JSON reader) and its evaluation.

Counterpart of ``object_keypoints_tpu/data/coco.py`` (CornerNet-Lite's
core/dbs/coco.py:10-169): the annotation JSON is read directly, detections
come out as (N, 5) [x1, y1, x2, y2, class] with contiguous 1-based class
ids, and ``convert_to_coco`` writes the results list. ``evaluate`` runs the
official COCOeval protocol through pycocotools when it is installed, else
through the port's vendored copy (``vendor/cocotools.py``): the same 10-IoU
sweep, area ranges, maxDets and 12-stat summary either way.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from object_keypoints_tpu_torch.ops import nms as nms_ops


class CocoDetectionDataset:
    """Images + (N, 5) [x1, y1, x2, y2, category] detections per image."""

    def __init__(self, annotation_file: str, image_dir: str,
                 shuffle_seed: Optional[int] = None):
        with open(annotation_file, "rt") as f:
            coco = json.load(f)
        self.annotation_file = annotation_file
        self.image_dir = image_dir
        self.images = {im["id"]: im for im in coco["images"]}
        self.categories = sorted(c["id"] for c in coco.get("categories", []))
        # contiguous 1-based class ids like the reference's _cat_ids mapping
        self.cat_to_class = {c: i + 1 for i, c in enumerate(self.categories)}
        self.class_to_cat = {v: k for k, v in self.cat_to_class.items()}
        self.class_names = {
            self.cat_to_class[c["id"]]: c.get("name", str(c["id"]))
            for c in coco.get("categories", [])
        }

        self._annotations = defaultdict(list)
        for ann in coco.get("annotations", []):
            if ann.get("iscrowd", 0):
                continue
            x, y, w, h = ann["bbox"]
            self._annotations[ann["image_id"]].append(
                [x, y, x + w, y + h, self.cat_to_class[ann["category_id"]]]
            )

        self.image_ids: List = sorted(self.images.keys())
        self.db_inds = np.arange(len(self.image_ids))
        self._rng = np.random.default_rng(shuffle_seed)

    def __len__(self):
        return len(self.image_ids)

    def shuffle_inds(self):
        self._rng.shuffle(self.db_inds)

    def image_path(self, ind: int) -> str:
        return os.path.join(self.image_dir, self.images[self.image_ids[ind]]["file_name"])

    def detections(self, ind: int) -> np.ndarray:
        anns = self._annotations.get(self.image_ids[ind], [])
        if not anns:
            return np.zeros((0, 5), np.float32)
        return np.asarray(anns, np.float32)

    def convert_to_coco(self, all_bboxes: Dict) -> List[dict]:
        """{image_id: {class: (n, 5)}} -> COCO results list
        (dbs/coco.py convert_to_coco)."""
        detections = []
        for image_id, boxes_by_class in all_bboxes.items():
            for cls, boxes in boxes_by_class.items():
                cat_id = self.class_to_cat.get(cls, cls)
                for box in boxes:
                    x1, y1, x2, y2, score = box[:5]
                    detections.append(
                        {
                            "image_id": image_id,
                            "category_id": int(cat_id),
                            "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
                            "score": float(score),
                        }
                    )
        return detections

    def evaluate(self, result_json: str, cls_ids=None, image_ids=None):
        """Official COCOeval protocol (core/dbs/coco.py:120-169): the
        installed pycocotools when present, else the vendored copy. Returns
        {"mAP": stats[0], "stats": the 12 summary stats}."""
        try:
            from pycocotools.coco import COCO
            from pycocotools.cocoeval import COCOeval
        except ImportError:
            from object_keypoints_tpu_torch.vendor.cocotools import COCO, COCOeval
        coco = COCO(self.annotation_file)
        coco_dets = coco.loadRes(result_json)
        coco_eval = COCOeval(coco, coco_dets, "bbox")
        if image_ids is not None:
            coco_eval.params.imgIds = list(image_ids)
        if cls_ids is not None:
            coco_eval.params.catIds = [
                self.class_to_cat.get(c, c) for c in cls_ids
            ]
        coco_eval.evaluate()
        coco_eval.accumulate()
        coco_eval.summarize()
        return {"mAP": float(coco_eval.stats[0]), "stats": list(coco_eval.stats)}

    def _evaluate_fallback(self, result_json: str, iou_threshold: float = 0.5):
        """PASCAL-style AP@iou averaged over classes, kept for comparison
        and debugging; ``evaluate`` does not call it. The IoUs come from
        ``ops.nms.bbox_overlaps`` in float32, as the JAX package's do."""
        with open(result_json, "rt") as f:
            results = json.load(f)
        by_class = defaultdict(list)
        for det in results:
            by_class[self.cat_to_class.get(det["category_id"], det["category_id"])].append(det)

        aps = {}
        for cls, dets in by_class.items():
            dets = sorted(dets, key=lambda d: -d["score"])
            gt = {
                img_id: [a for a in self._annotations[img_id] if a[4] == cls]
                for img_id in self.image_ids
            }
            n_gt = sum(len(v) for v in gt.values())
            if n_gt == 0:
                continue
            used = {img_id: np.zeros(len(v), bool) for img_id, v in gt.items()}
            tp = np.zeros(len(dets))
            fp = np.zeros(len(dets))
            for i, det in enumerate(dets):
                x, y, w, h = det["bbox"]
                box = np.array([[x, y, x + w, y + h]], np.float32)
                candidates = gt.get(det["image_id"], [])
                if not candidates:
                    fp[i] = 1
                    continue
                ious = nms_ops.bbox_overlaps(
                    torch.from_numpy(box),
                    torch.from_numpy(np.asarray(candidates, np.float32)[:, :4]),
                ).numpy()[0]
                j = int(ious.argmax())
                if ious[j] >= iou_threshold and not used[det["image_id"]][j]:
                    tp[i] = 1
                    used[det["image_id"]][j] = True
                else:
                    fp[i] = 1
            recall = np.cumsum(tp) / n_gt
            precision = np.cumsum(tp) / np.maximum(np.cumsum(tp) + np.cumsum(fp), 1e-9)
            # 101-point interpolation
            ap = 0.0
            for r in np.linspace(0, 1, 101):
                p = precision[recall >= r]
                ap += (p.max() if p.size else 0.0) / 101.0
            aps[cls] = ap
        mean_ap = float(np.mean(list(aps.values()))) if aps else 0.0
        print(f"AP@{iou_threshold:.2f} (fallback evaluator): {mean_ap:.4f}")
        return {"mAP": mean_ap, "per_class": aps}
