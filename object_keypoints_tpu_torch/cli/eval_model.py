"""Evaluation CLI: 3D keypoint errors of a model (or of the ground-truth
maps) over recorded sequences.

    python -m object_keypoints_tpu_torch.cli.eval_model DATA -m ARTIFACT \
        --keypoints config/valve.json
    python -m object_keypoints_tpu_torch.cli.eval_model DATA --ground-truth --fast \
        --keypoints config/valve.json

The port of ``scripts/eval_model.py``, with its flags. Plays each sequence
under DATA through the pipeline components frame by frame (or, with
``--fast``, in batches through ``evaluation.evaluate_sequence_fast``),
accumulates the errors, prints the rich metric table, optionally writes
overlay frames (``--write``, matplotlib) or shows them (``--live``), and
writes the summary dict (``--json``). It runs on the CUDA card, and raises
without one, unless ``--cpu`` asks for the CPU.
"""

import argparse
import json
import os
import random

import numpy as np


def read_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("data", help="Path to dataset folder.")
    parser.add_argument("--model", "-m", type=str, help="Exported model directory.")
    parser.add_argument("--centers", action="store_true", help="Show center predictions.")
    parser.add_argument("--ground-truth", action="store_true",
                        help="Decode labels instead of predictions.")
    parser.add_argument("--keypoints", type=str, default="config/cups.json")
    parser.add_argument("--write", type=str, help="Write overlay frames to folder.")
    parser.add_argument("--cpu", action="store_true", help="Run on the CPU, not the CUDA card.")
    parser.add_argument("--world", action="store_true",
                        help="Project 3D points instead of 2D detections.")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--fast", action="store_true",
                        help="Batched decode (evaluate_sequence_fast).")
    parser.add_argument("--batch", type=int, default=8, help="--fast batch size.")
    parser.add_argument("--live", action="store_true",
                        help="Show the overlay in an interactive window (needs a display; "
                        "headless hosts fall back to --write frame dumps).")
    parser.add_argument("--json", type=str, default=None,
                        help="Also write the summary dict (the rich table's numbers, "
                        "machine-readable) to this path.")
    return parser.parse_args(argv)


def _points(objects, sequence, world):
    """The points to draw of one frame's objects, in image pixels."""
    out = []
    for obj in objects:
        if world:
            pts = [p for p in obj["p_C"] if p is not None]
            if pts:
                out.append(sequence.camera.project(np.concatenate(pts, axis=0)) + 0.5)
        else:
            pts = [p + 1.0 for p in obj["keypoints"] if getattr(p, "size", 0)]
            if pts:
                out.append(sequence.to_image_points(np.concatenate(pts, axis=0)))
    return out


def _live_overlay(example, objects, sequence, world):
    """cv2 overlay for the --live window."""
    import cv2

    from object_keypoints_tpu_torch.data.scene import SceneDataset
    from object_keypoints_tpu_torch.utils.vis import heatmap_overlay

    rgb = SceneDataset.to_image(example["frame"])
    image = np.ascontiguousarray(heatmap_overlay(rgb, example["heatmaps"]))
    for pts in _points(objects, sequence, world):
        for x, y in np.asarray(pts).reshape(-1, 2):
            cv2.circle(image, (int(round(x)), int(round(y))), 4, (255, 0, 0), -1)
    return image


def _write_overlay(out_dir, frame_number, example, objects, sequence, world):
    from matplotlib import pyplot

    from object_keypoints_tpu_torch.data.scene import SceneDataset
    from object_keypoints_tpu_torch.utils.vis import heatmap_overlay

    image = heatmap_overlay(SceneDataset.to_image(example["frame"]), example["heatmaps"])
    fig = pyplot.figure(figsize=(8, 8))
    ax = fig.add_subplot(111)
    ax.imshow(image)
    for pts in _points(objects, sequence, world):
        ax.scatter(pts[:, 0], pts[:, 1], s=6)
    ax.axis("off")
    fig.savefig(os.path.join(out_dir, f"{frame_number:06}.jpg"), bbox_inches="tight")
    pyplot.close(fig)


def main(argv=None):
    flags = read_args(argv)
    random.seed(flags.seed)

    from object_keypoints_tpu_torch.evaluation import (
        Results,
        Sequence,
        evaluate_sequence_fast,
        example_maps,
    )
    from object_keypoints_tpu_torch.pipeline.components import (
        LearnedKeypointTrackingPipeline,
        ObjectKeypointPipeline,
    )

    if not (flags.model or flags.ground_truth):
        raise SystemExit("--model required unless --ground-truth")
    device = "cpu" if flags.cpu else "cuda"
    with open(flags.keypoints, "rt") as f:
        keypoint_config = json.load(f)

    if flags.write:
        os.makedirs(flags.write, exist_ok=True)

    sequences = sorted(os.path.join(flags.data, s) for s in os.listdir(flags.data))
    random.shuffle(sequences)

    viewer = None
    if flags.live:
        from object_keypoints_tpu_torch.utils.vis import LiveViewer

        viewer = LiveViewer("eval_model")

    inference_fn = None
    if flags.fast and not flags.ground_truth:
        from object_keypoints_tpu_torch.serving.export import load_inference_fn

        inference_fn = load_inference_fn(flags.model, device=device)

    results = Results()
    frame_number = 0
    for seq_path in sequences:
        sequence = Sequence(seq_path, keypoint_config, device=device)
        if flags.fast:
            seq_results = evaluate_sequence_fast(
                sequence, inference_fn, keypoint_config, batch_size=flags.batch,
                max_frames=flags.max_frames, ground_truth=flags.ground_truth,
            )
            results.gt_keypoints.extend(seq_results.gt_keypoints)
            results.predicted_keypoints.extend(seq_results.predicted_keypoints)
            results.set_calibration(sequence.camera_small)
            continue
        if flags.ground_truth:
            pipeline = ObjectKeypointPipeline(
                tuple(sequence.prediction_size), sequence.keypoints, keypoint_config)
        else:
            pipeline = LearnedKeypointTrackingPipeline(
                flags.model, not flags.cpu, tuple(sequence.prediction_size),
                sequence.keypoints, keypoint_config,
            )
        pipeline.reset(sequence.camera_small)
        results.set_calibration(sequence.camera_small)

        for i, example in enumerate(sequence.dataset):
            if flags.max_frames is not None and i >= flags.max_frames:
                break
            if flags.ground_truth:
                objects = pipeline(*example_maps(example, sequence.device))
            else:
                objects, _ = pipeline(np.transpose(example["frame"], (2, 0, 1))[None])
            results.add(example["T_WC"], objects, sequence.world_points)
            if flags.write:
                _write_overlay(flags.write, frame_number, example, objects, sequence,
                               flags.world)
            if viewer is not None:
                if not viewer.show(_live_overlay(example, objects, sequence, flags.world)):
                    viewer.close()
                    viewer = None  # the user closed the window; keep evaluating
            frame_number += 1
    if viewer is not None:
        viewer.close()
    summary = results.print_results()
    if flags.json:
        os.makedirs(os.path.dirname(flags.json) or ".", exist_ok=True)
        with open(flags.json, "wt") as f:
            json.dump({"summary": summary, "data": flags.data, "model": flags.model,
                       "ground_truth": flags.ground_truth, "fast": flags.fast}, f, indent=2)
        print(f"summary written to {flags.json}")
    return summary


if __name__ == "__main__":
    main()
