"""The port's precision rule: float32 means float32, bf16 means bf16 compute.

- **float32.** cuDNN runs float32 convolutions in TF32 unless told otherwise
  (``torch.backends.cudnn.allow_tf32`` defaults to True), which keeps about
  three decimal digits; the JAX package's contract is float32. The port's
  entry points that compute (serving's ``infer``, the train and eval steps)
  run under ``no_tf32``, whatever the process's flags say, and restore the
  flags when they return.
- **bf16.** A bf16 forward keeps every parameter and BatchNorm statistic in
  float32 and computes in bf16, the JAX package's ``dtype`` rule
  (object_keypoints_tpu/models/blocks.py): the convolutions cast their
  weights to the input's dtype (``models.blocks.Conv2d``), BatchNorm
  normalizes in float32 and returns the input's dtype
  (``models.blocks.BatchNorm2d``). It is asked for by the frames' dtype,
  never by a global flag.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def no_tf32():
    """Turn TF32 off for cuDNN convolutions and cuBLAS matmuls inside the
    block; restore the process's flags after it."""
    cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul
