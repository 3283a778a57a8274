"""Label QA playback: the flags of scripts/show_keypoints.py.

    python -m object_keypoints_tpu_torch.cli.show_keypoints data/sequences \
        --calibration config/calibration.yaml --out keypoints_vis [--max-frames N] [--live]

Projects each sequence's saved world keypoints (keypoints.json) through the
frame's camera pose (data.hdf5) onto its video (frames.mp4) and writes the
overlays as jpgs, ``<sequence>_<frame>.jpg`` under ``--out``, as the JAX
script does (the reference's hud window is replaced with frame dumps).
``--live`` also plays them in a window (``utils.vis.LiveViewer``; it needs a
display). A host tool: the projections run on the port's float64 geometry;
cv2 and h5py are imported when it runs.
"""

import argparse
import json
import os

import numpy as np
import torch

from object_keypoints_tpu_torch.constants import KEYPOINT_FILENAME
from object_keypoints_tpu_torch.geometry import linalg
from object_keypoints_tpu_torch.geometry.cameras import from_calibration


def read_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("base_dir", help="Directory of encoded sequence directories.")
    parser.add_argument("--calibration", type=str, default="config/calibration.yaml")
    parser.add_argument("--out", type=str, default="keypoints_vis",
                        help="Where to write overlay frames.")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--live", action="store_true",
                        help="Play the overlays in an interactive window "
                        "(the reference's hud playback; needs a display).")
    return parser.parse_args(argv)


def main(argv=None):
    flags = read_args(argv)
    import cv2
    import h5py

    camera = from_calibration(flags.calibration)
    sequences = sorted(os.path.join(flags.base_dir, d) for d in os.listdir(flags.base_dir))
    os.makedirs(flags.out, exist_ok=True)
    viewer = None
    if flags.live:
        from object_keypoints_tpu_torch.utils.vis import LiveViewer

        viewer = LiveViewer("show_keypoints", wait_ms=30)
    written = {}
    for seq in sequences:
        with open(os.path.join(seq, KEYPOINT_FILENAME), "rt") as f:
            world_points = np.array(json.load(f)["3d_points"])[:, :3]
        with h5py.File(os.path.join(seq, "data.hdf5"), "r") as f:
            poses = f["camera_transform"][:]
        capture = cv2.VideoCapture(os.path.join(seq, "frames.mp4"))
        name = os.path.basename(seq)
        i = 0
        while i < poses.shape[0]:
            ok, frame = capture.read()
            if not ok:
                break
            if flags.max_frames is not None and i >= flags.max_frames:
                break
            T_CW = linalg.inv_transform(torch.as_tensor(poses[i], dtype=torch.float64)).numpy()
            projected = camera.project(world_points, T_CW)
            for x, y in projected:
                if 0 <= x < frame.shape[1] and 0 <= y < frame.shape[0]:
                    cv2.circle(frame, (int(round(x)), int(round(y))), 5, (0, 0, 255), -1)
            cv2.imwrite(os.path.join(flags.out, f"{name}_{i:06}.jpg"), frame)
            if viewer is not None and not viewer.show(frame[..., ::-1]):
                viewer.close()
                viewer = None
            i += 1
        capture.release()
        written[name] = i
        print(f"{seq}: wrote {i} overlay frames to {flags.out}")
    if viewer is not None:
        viewer.close()
    return written


if __name__ == "__main__":
    main()
