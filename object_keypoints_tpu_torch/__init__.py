"""object_keypoints_tpu_torch — the PyTorch/CUDA port of object_keypoints_tpu.

The JAX package ``object_keypoints_tpu`` is the reference; this package
reproduces its two KeypointNet serve paths (depth head and
stereo-triangulated) in float and int8, its evaluation path, its training
(the step, the loop, checkpoints and the CLIs) and the single-pass CornerNet
detectors' serve path on an NVIDIA H100 and keeps its module names, so each
module here has a counterpart of the same name there:

models      blocks, fire and residual hourglasses, KeypointNet, cornernet (NCHW)
ops         stem_conv (CUDA kernel + plain version), int8_conv (int8 x int8
            -> int32 convolutions on cuBLASLt's int8 GEMM), decode, associate,
            corner_pool, detection_decode, nms
inference   detector: CornerNet inference and its Detector facade
configs     the detector JSONs
geometry    linalg, fisheye / radtan cameras and host camera classes,
            stereo (Hartley-Sturm correction, DLT)
pipeline    decode: heatmaps -> associated 3D keypoints (batched);
            stereo: heatmap pairs -> matched, triangulated 3D keypoints;
            components: the reference's host API over both
serving     export (artifacts both ways, inference fn), weights (JAX <-> port),
            quantize (int8 calibration and serving), calibration (frames)
data        scene (SceneDataset), targets (batched target rendering),
            augment, augment_device (batched, on the card), encode
            (SequenceWriter), synthetic sequences, combinators, prefetch
training    losses, trainer (AdamW + plateau, train and eval steps),
            device_data (the dataset on the card, train_step_device_data),
            checkpoints (best and last, the port's own files), loop
            (TrainConfig, train, fit)
precision   no_tf32: float32 means float32 at every entry point
evaluation  Sequence, Results, batched and per-frame sequence evaluation
cli         eval_model, train, package_model, detect (the CLIs of scripts/),
            and flagship (scripts/flagship_recipe.sh's data, training and eval)
utils       vis: boxes, heatmap overlays, live viewer; metrics (MetricsLogger),
            tb_events (TensorBoard event files), config (detection configs)
csrc        CUDA C++ kernels, built by ops/_build.py at first use

It imports torch and never jax, flax or object_keypoints_tpu.
"""
