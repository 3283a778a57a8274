"""Shared constants: the port's copy of ``object_keypoints_tpu/constants.py``
(the part the data layer and the evaluation use)."""

import numpy as np

KEYPOINT_FILENAME = "keypoints.json"

# the reference's frame normalization (its video.py:55-56)
RGB_MEAN = np.array([0.40789654, 0.44719302, 0.47026115], dtype=np.float32)
RGB_STD = np.array([0.28863828, 0.27408164, 0.27809835], dtype=np.float32)
