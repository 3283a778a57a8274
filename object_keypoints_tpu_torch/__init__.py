"""object_keypoints_tpu_torch — the PyTorch/CUDA port of object_keypoints_tpu.

The JAX package ``object_keypoints_tpu`` is the reference; this package
reproduces its KeypointNet serve path on an NVIDIA H100 and keeps its module
names, so each module here has a counterpart of the same name there:

models     blocks, fire hourglass, KeypointNet (NCHW)
ops        stem_conv (CUDA kernel + plain version), decode, associate
geometry   fisheye / radtan camera functions, calibration loading
pipeline   decode: heatmaps -> associated 3D keypoints (batched)
serving    export (artifact loading, inference fn), weights (JAX -> port)
csrc       CUDA C++ kernels, built by ops/_build.py at first use

It imports torch and never jax, flax or object_keypoints_tpu.
"""
