"""Command-line entry points, run as ``python -m object_keypoints_tpu_torch.cli.<name>``."""
