"""Smoke run of the PyTorch port on one CUDA card: serve, eval, train, int8 and detector paths.

    python3 chip_smoke.py

Drives ``object_keypoints_tpu_torch`` (never jax) once, at full width:

1. device and environment (nvidia-smi name and power limit, torch, CUDA);
2. builds the CUDA kernels from ``object_keypoints_tpu_torch/csrc``;
3. the two stem kernels against their plain version: the fp32 CUDA-core
   kernel (TF32 off, atol 1e-4) at (16, 3, 511, 511) and at the eval
   batch's (8, 3, 511, 511), the bf16 tensor-core
   kernel (one output ulp, stated as rtol = atol = 1e-2) at (16, 3, 511, 511),
   at the bf16 eval_step's (8, 3, 511, 511) and at the serve step's
   (96, 3, 511, 511); median times of the kernel, the
   plain version, cuDNN's conv alone and cuDNN's conv + BN + ReLU as
   separate ops (CUDA events around runs of back-to-back calls), each
   kernel's bound (its bytes at 3.35 TB/s against its FLOP at the peak for
   its type) and its share of that bound;
4. the full-width valve KeypointNet (heatmaps_out=3, 24.95M parameters,
   weights from a seeded torch.Generator) in fp32 with TF32 off: the forward
   with the stem kernel against the same forward with the plain stem; the
   fp32 kernel launched once;
5. the serve step as bench.py measures it, in float (bf16): 48 stereo pairs
   of 511x511 frames -> make_inference_fn -> decode_objects_batch
   (keypoints (1, 3), equidistant, 16 peaks, 20 px reject, threshold 0.5)
   through bench.py's camera chain; checks shapes and finiteness, decodes
   the same maps on the CPU for comparison, checks that every stem launch
   went to the bf16 tensor-core kernel, and prints stereo pairs/s from a
   warm timed loop;
6. the stereo-triangulated serve step as bench.py measures it: the same
   model and bf16 inference function, the first 48 frames left and the last
   48 right -> stereo_decode_triangulate (16 peaks, threshold 0.5, epipolar
   threshold 3 px) through bench.py's camera chain for both cameras; checks
   the bf16 stem kernel ran once per step and that every output is on the card
   and finite; holds the card's decode and the CPU decode of the same maps
   to each other and each to the float64 lift of its own matched pixels
   (object_keypoints_tpu_torch.testing.compare_stereo); prints stereo
   pairs/s, ms per step, the forward and the stereo decode alone, peak
   memory, and one whole warm step traced on the card by torch.profiler
   while the host clock times its parts (device busy and idle share, the
   host's time in the forward and in the decode);
7. a stereo scene with known geometry: numpy Gaussians at the port's
   fisheye projections of the valve keypoints of
   tests/test_stereo_pipeline.py, in both views at 180x320, decoded on the
   card: one, one and three matches per channel, each within 5 cm of the
   truth, and equal to the CPU decode and the float64 lift within 1e-4 m;
8. the evaluation path (evaluation.evaluate_sequence_fast, the batched path
   of the eval CLI) on a synthetic valve sequence of 48 frames of 720x1280
   (config/calibration.yaml, keypoints (1, 3), seeded), held in memory: the
   card's machine has no h5py, so the poses and frames are handed to the
   dataset directly and go through the same per-frame code (projection,
   resize/crop) as frames read from files; the CLI is not run here. (a)
   ground truth: targets rendered and decoded on the card, the summary equal
   to the same run on the CPU and under 5 cm mean error; (b) learned, batch
   8: the full-width valve KeypointNet with seeded weights, written by
   export_model and read back by load_inference_fn in float32, launching the
   fp32 stem kernel once a batch and the bf16 one never, outputs finite on
   the card, one batch's decode equal to the CPU decode of the same maps;
   prints frames/s of both, the host's prefix ms per frame, the forward's,
   the decode's and Results.add's ms per batch, peak memory, and the
   device's busy share of one more run of each, traced on the card;
9. training (``training.device_data.train_step_device_data``) on a device
   store of 32 synthetic 511x511 frames with 2 objects each (two in-memory
   sequences, seeded), batch 8, lr 4e-3, augment on, the full-width valve
   KeypointNet: float32 (TF32 off) and bf16 (bf16 compute over float32
   parameters and BatchNorm) step times by CUDA events and by host clock
   over 20 warm steps, frames/s, peak memory, the device's busy share of
   one traced step, the host's time in each part of a step (the data
   suffix, forward and backward, the optimizer, the wait) through the
   public calls the step is made of, and a check that a warm step never
   waits for the card (``torch.cuda.set_sync_debug_mode("error")``); the
   loss over 100 bf16 steps, finite and falling (the mean of the last 10
   below the first 10); one float32 step at batch 2 (augment and dropout
   off) on the card against the same step on the CPU and in float64, with
   a control beside it: the card's step with TF32 on and its pin taken
   away, which must miss float64 by more than the gradient gate allows;
   eval_step in float32 and in bf16,
   each launching the stem kernel of its dtype once; the trained bf16
   weights through export_model -> load_inference_fn (float32) -> decode,
   equal to the CPU decode of the same maps;
10. the training loop (``training.loop.fit``, as the train CLI runs it):
   the full-width valve KeypointNet in bf16, batch 8, lr 4e-3, on the
   flagship's in-memory synthetic sequences (2 train x 16 frames, 1 val x
   16, 2 objects; the device store), 2 epochs (8 steps), log_every 2,
   ckpt_every 1, TensorBoard on; checks that metrics.jsonl holds the train
   keys at each logged step and the val keys after each epoch, that best,
   last, best_val.json, hparams.json, the event file and the export are
   written, and, with ``torch.cuda.set_sync_debug_mode("warn")``, that no
   training step waits for the card and the second epoch waits only for its
   log reads and its val read (checkpoint writes and eval steps apart); then
   a resume from last for one epoch with a fresh optimizer (the step carries
   on; a worse val leaves the best as it was), the package CLI (its artifact
   equal to the loop's export) and the packaged model served on the card,
   its decode equal to the CPU's; the package CLI again with ``--quantize``
   (no sequence directory is readable there, so it calibrates on its
   unit-normal fallback), its artifact served int8 through "auto" and its
   decode equal to the CPU's; prints the loop's ms a step beside phase 9's
   bare step, the second epoch's wall time, checkpoint write and export ms,
   the syncs by site, peak memory and the stem launches;
11. int8 serving (``serving.quantize``, ``ops.int8_conv``): the full-width
   valve model in bf16 calibrated on bench.py's 8 synthetic frames (keypoints
   (1, 3), seed 7, in memory through SceneDataset's 511 resize), its keys
   equal to the name walk's eligible convs; each distinct int8 conv shape of
   the default placement at 96 frames, plus hg_0's up2 unpool: the GEMM
   route's int32 sums equal to the plain version's, the route's and its
   im2col's ms, cuDNN's bf16 conv of the same shape, the route's TOP/s and
   its share of the card's dense int8 peak; the int8 depth-head and stereo
   serve steps in bench.py's int8 mode (bf16 with int8 convs, 48 pairs, the
   decode settings of phases 5 and 6): pairs/s, step ms, the forward's ms in
   turns with the bf16 forward's, device ops per forward, peak memory, the
   max |int8 - bf16| of the maps, every stem launch on the bf16 kernel and
   the card's decode equal to the CPU's; the artifact route (export_model
   with quant.json -> load_inference_fn "auto" in float32, one fp32 stem
   launch, within tests/test_quantize.py's budgets of the CPU's int8
   forward; "never" equal to the float path; "require" without quant.json
   raises FileNotFoundError);
12. the CornerNet detectors' serve path (``inference.detector.Detector``,
   as the detect CLI runs it) at full width in bf16 with seeded weights on a
   synthetic 480x640 uint8 image (numpy seed 0): (a) CornerNet-Squeeze
   under configs/CornerNet_Squeeze.json, frames (1, 3, 511, 767); (b)
   CornerNet under configs/CornerNet.json, flip test, frames (2, 3, 511,
   767), K 100, 1,000 detections, exp soft-NMS; (c) one call of CornerNet
   under configs/CornerNet-multi_scale.json (five scales, flip, merge:
   soft_nms_merge_batch). Checks: every stem launch on the bf16 kernel, one
   a scale; the bf16 stem against its plain version on the detector's own
   frames and stem weights at each new shape; the card's corner decode
   against the CPU decode of the same heads (classes equal, boxes 1e-4 px,
   scores 1e-5, in a device-independent row order) and the card's soft-NMS
   against the CPU's on the same detections and on as many synthetic rows,
   all valid (counts per class equal, boxes 1e-3 px, scores 1e-5); outputs
   finite, frames and detections on the card; the float32 forward (TF32
   off) with the stem kernel against the plain stem (the last stack's heads
   within 1e-4 x max(1, max|ref|)). Prints, for (a) and (b), images/s over
   warm calls, the ms per image by part (host prefix, upload, forward and
   decode by CUDA events, copy back, soft-NMS with its steps and device
   ops, host tail), device ops and busy share of one traced call, the
   forward's device time by kernel (the corner pools' cummax among them)
   and peak memory.

The process's TF32 flags stay at torch's defaults: the port's entry points
(``infer``, the train and eval steps) pin TF32 off themselves; phases 3 and
4 pin it for the plain comparisons.

Any failed check raises, so the exit code is non-zero. The last two lines
are the kernels' JSON and ``{"ok": true, "device": {...}}``. The stem
wrapper counts launches in all and per kernel; phases 4, 5, 6, 8, 9 (its
eval_steps), 10 (the loop's runs and the packaged models' serves), 11
(the int8 serve steps and the int8 artifact's serve) and 12 (the detectors'
calls) each set the counts to 0 before they run and read them after, and
the kernels' line gives each kernel's launches from those runs. The int8 convolutions run on cuBLASLt's
int8 GEMM, not on a kernel of this repository, so they are not in that line;
phase 11 counts their launches apart.
"""

import collections
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

PAIRS = 48  # bench.py's default batch
EVAL_FRAMES = 48
EVAL_BATCH = 8  # scripts/eval_model.py's --batch default
SEED = 0
KEYPOINT_CONFIG = (1, 3)
CALIBRATION = "config/calibration.yaml"
TRAIN_FRAMES, TRAIN_SEQUENCES = 32, 2  # 2 objects a frame
TRAIN_BATCH, TRAIN_LR = 8, 4e-3  # the flagship recipe's
TRAIN_STEPS, TRAIN_TIMED = 100, 20
LOOP_SEQUENCES, LOOP_FRAMES = 2, 16  # train sequences, frames a sequence (the val one too)
STEM_REPLACES = "object_keypoints_tpu/ops/pallas/stem_conv.py:127"
STEM_SOURCE = "object_keypoints_tpu_torch/csrc/stem_conv.cu"
# one H100 SXM (NVIDIA's data sheet): HBM rate, dense peak by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
STEM_KERNELS = {torch.bfloat16: "stem_conv_bf16", torch.float32: "stem_conv_fp32"}


def log(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters=10, warmup=3):
    """Median milliseconds of fn() on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_ms(fn, launches=10, runs=5, warmup=3):
    """Milliseconds per call of fn() on the card: CUDA events around runs of
    back-to-back calls, so that the host's time per call hides behind the
    card's; the median over the runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def check_close(what, got, want, atol, rtol):
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol, msg=lambda m: f"{what}: {m}")
    return err


def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    print(card, flush=True)
    log("device", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        python=sys.version.split()[0])
    return card


def phase_build():
    from object_keypoints_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    seconds = time.perf_counter() - t0
    regs = [line.strip() for line in lib.with_suffix(".log").read_text().splitlines()
            if any(k in line for k in ("entry function", "registers", "spill"))]
    log("build", library=lib.name, seconds=seconds, ptxas=regs)


def stem_inputs(n, dtype, gen):
    x = torch.randn(n, 3, 511, 511, generator=gen).to("cuda", dtype)
    w = (torch.randn(128, 3, 7, 7, generator=gen) * 0.08).cuda()
    scale = (torch.rand(128, generator=gen) + 0.5).cuda()
    bias = (torch.randn(128, generator=gen) * 0.1).cuda()
    return x, w, scale, bias


def stem_counts():
    from object_keypoints_tpu_torch.ops.stem_conv import stem_conv

    return {"all": stem_conv.launches, "stem_conv_bf16": stem_conv.launches_bf16,
            "stem_conv_fp32": stem_conv.launches_fp32}


def reset_stem_counts():
    from object_keypoints_tpu_torch.ops.stem_conv import stem_conv

    stem_conv.launches = stem_conv.launches_bf16 = stem_conv.launches_fp32 = 0


def stem_bound(x, c_out):
    """The least time (ms) the card could take for the stem on x: the bytes
    the kernel must move (frames, its tap matrix, scale and bias read once,
    the output written once) at the HBM rate, against the conv's FLOP (147
    taps a pixel and channel) at the peak for the frames' type."""
    n, _, h, w = x.shape
    size = x.element_size()
    out = n * ((h - 1) // 2 + 1) * ((w - 1) // 2 + 1) * c_out
    taps = 192 * 128 if x.dtype == torch.bfloat16 else 147 * c_out
    moved = x.numel() * size + out * size + taps * size + 2 * 4 * c_out
    flop = 2.0 * out * 147
    bytes_ms, ops_ms = 1e3 * moved / HBM_BYTES_PER_S, 1e3 * flop / PEAK_FLOPS[x.dtype]
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", moved, flop


def phase_stem_kernel():
    from object_keypoints_tpu_torch.ops.stem_conv import stem_conv, stem_conv_plain
    from object_keypoints_tpu_torch.precision import no_tf32

    with no_tf32():  # the plain version and cuDNN's fp32 conv in float32
        return stem_kernel_rows(stem_conv, stem_conv_plain)


def stem_kernel_rows(stem_conv, stem_conv_plain):
    gen = torch.Generator().manual_seed(SEED)
    result = {}
    # 16 frames, then every batch a main path gives each kernel: fp32 the
    # eval's and eval_step's, bf16 eval_step's and the serve step's (last)
    fp32 = [(n, torch.float32, 1e-4, 0.0) for n in (16, *sorted({EVAL_BATCH, TRAIN_BATCH}))]
    bf16 = [(n, torch.bfloat16, 1e-2, 1e-2) for n in (16, TRAIN_BATCH, 2 * PAIRS)]
    for n, dtype, atol, rtol in fp32 + bf16:
        name = STEM_KERNELS[dtype]
        x, w, scale, bias = stem_inputs(n, dtype, gen)
        before = stem_counts()
        out = stem_conv(x, w, scale, bias)
        torch.cuda.synchronize()
        assert stem_counts()[name] == before[name] + 1, (name, before, stem_counts())
        assert out.shape == (n, 128, 256, 256) and out.dtype == dtype
        assert out.is_contiguous(memory_format=torch.channels_last)
        err = check_close(f"{name} {n}", out, stem_conv_plain(x, w, scale, bias), atol, rtol)
        ms = kernel_ms(lambda: stem_conv(x, w, scale, bias))
        plain_ms = kernel_ms(lambda: stem_conv_plain(x, w, scale, bias), launches=3)
        # cuDNN in the frames' dtype (TF32 off): the conv alone, one call that
        # does less than the kernel; then what the eager model would run
        # without the kernel, the conv, then the folded BN and the ReLU as
        # separate ops
        wc = w.to(dtype)
        conv_ms = kernel_ms(lambda: torch.nn.functional.conv2d(x, wc, stride=2, padding=3))
        cudnn_ms = kernel_ms(lambda: torch.relu(
            torch.nn.functional.conv2d(x, wc, stride=2, padding=3)
            * scale.to(dtype)[:, None, None] + bias.to(dtype)[:, None, None]))
        bound_ms, bound_by, moved, flop = stem_bound(x, 128)
        row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": conv_ms}
        log("stem_kernel", kernel=name, shape=list(x.shape), dtype=str(dtype), atol=atol,
            rtol=rtol, **row, cudnn_conv_bn_relu_ms=cudnn_ms, bytes_moved=moved, flop=flop,
            bound_share=bound_ms / ms, kernel_tflops=flop / ms / 1e9,
            hbm_tb_per_s=moved / ms / 1e9)
        result[name] = row  # each kernel's last row: the eval batch (fp32), the serve step (bf16)
        del x, out
    return result


def make_model(dropout=0.1):
    from object_keypoints_tpu_torch.models.keypoint_net import KeypointNet

    return KeypointNet(heatmaps_out=3, dropout=dropout, generator=torch.Generator().manual_seed(SEED))


def phase_full_forward():
    from object_keypoints_tpu_torch.ops.stem_conv import stem_conv_plain
    from object_keypoints_tpu_torch.precision import no_tf32

    model = make_model()
    n_params = sum(p.numel() for p in model.parameters())
    assert round(n_params / 1e6, 2) == 24.95, n_params
    model = model.to("cuda", memory_format=torch.channels_last).eval()
    x = torch.randn(2, 3, 511, 511, generator=torch.Generator().manual_seed(SEED + 1)).cuda()
    with torch.inference_mode(), no_tf32():
        reset_stem_counts()  # this path's run starts here
        out = model(x)
        counts = stem_counts()  # ... and ends here
        ref = model(x, stem=stem_conv_plain)
    assert counts == {"all": 1, "stem_conv_bf16": 0, "stem_conv_fp32": 1}, counts
    worst = 0.0
    for name in ("heatmaps", "depth", "centers"):
        for s, (got, want) in enumerate(zip(getattr(out, name), getattr(ref, name))):
            assert torch.isfinite(got).all(), name
            # fp32 sums in another order in the stem; the rest of the network
            # is the same code, so the outputs agree to fp32 rounding, scaled
            # by the output's magnitude
            scale = max(1.0, want.abs().max().item())
            err = check_close(f"forward {name}[{s}]", got, want, atol=1e-4 * scale, rtol=1e-4)
            worst = max(worst, err / scale)
    log("full_forward", params=n_params, dtype="float32", tf32=False, shape=list(x.shape),
        max_rel_err=worst, tolerance="atol 1e-4 x max(1, max|ref|), rtol 1e-4",
        stem_launches=counts)
    return counts


def check_decode_on_cpu(what, decoded, maps, cam, decode_kw):
    """The card's decode of the first len(maps[0]) frames against the CPU
    decode of the same maps: masks equal, 2D within 1e-4 px, 3D within
    1e-5 m."""
    from object_keypoints_tpu_torch.pipeline.decode import (
        CameraArrays,
        DecodedObjects,
        decode_objects_batch,
    )

    k = len(maps[0])
    cpu = decode_objects_batch(*(t.cpu() for t in maps), CameraArrays.from_camera(cam), **decode_kw)
    for name in DecodedObjects._fields:
        got, want = getattr(decoded, name)[:k].cpu(), getattr(cpu, name)
        if got.is_floating_point():
            tol = 1e-5 if name.endswith("p3d") else 1e-4
            check_close(f"{what} decode {name}", got, want, atol=tol, rtol=0)
        else:
            assert torch.equal(got, want), (what, name)


def phase_serve(card):
    from object_keypoints_tpu_torch.geometry.cameras import load_calibration_params
    from object_keypoints_tpu_torch.pipeline.decode import (
        CameraArrays,
        DecodedObjects,
        decode_objects_batch,
    )
    from object_keypoints_tpu_torch.serving.export import make_inference_fn
    from object_keypoints_tpu_torch.testing import serve_rig

    cam = serve_rig(load_calibration_params(CALIBRATION)).left_camera  # bench.py's chain
    camera = CameraArrays.from_camera(cam, device="cuda")
    decode_kw = dict(keypoint_config=KEYPOINT_CONFIG, model="equidistant", max_peaks=16,
                     reject_distance=20.0, peak_threshold=0.5)

    infer = make_inference_fn(make_model(), dtype=torch.bfloat16, device="cuda")
    frames = torch.randn(2 * PAIRS, 3, 511, 511,
                         generator=torch.Generator().manual_seed(SEED + 2)).to("cuda", torch.bfloat16)

    def step():
        heat, depth, centers = infer(frames)
        return (heat, depth, centers), decode_objects_batch(heat, depth, centers, camera, **decode_kw)

    torch.cuda.reset_peak_memory_stats()
    reset_stem_counts()  # the main path's run starts here
    maps, decoded = step()
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    iters = 20
    t0 = time.perf_counter()
    for _ in range(iters):
        maps, decoded = step()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = stem_counts()  # ... and ends here
    # every stem launch of the bf16 step went to the tensor-core kernel
    assert launches == {"all": 3 + iters, "stem_conv_bf16": 3 + iters, "stem_conv_fp32": 0}, launches

    n, m, T, C = 2 * PAIRS, 16, len(KEYPOINT_CONFIG), max(KEYPOINT_CONFIG)
    heat, depth, centers = maps
    assert heat.shape == (n, 3, 64, 64) and depth.shape == (n, 3, 64, 64)
    assert centers.shape == (n, 2, 2, 64, 64)
    shapes = dict(center_points=(n, m, 2), center_valid=(n, m), center_p3d=(n, m, 3),
                  keypoints=(n, m, T, C, 2), keypoints_valid=(n, m, T, C),
                  keypoints_p3d=(n, m, T, C, 3), predicted_centers=(n, T, m, 2),
                  assignment=(n, T, m), raw_points=(n, T, m, 2), raw_valid=(n, T, m))
    for name in DecodedObjects._fields:
        value = getattr(decoded, name)
        assert tuple(value.shape) == shapes[name], (name, value.shape)
        if value.is_floating_point():
            assert torch.isfinite(value).all(), name
    for t in maps:
        assert torch.isfinite(t).all()

    # the decode on the card against the same decode on the CPU, same maps
    k = 8
    check_decode_on_cpu("serve", decoded, [t[:k] for t in maps], cam, decode_kw)

    pairs_per_sec = PAIRS * iters / seconds
    log("serve", pairs=PAIRS, frames=list(frames.shape), dtype="bfloat16",
        stereo_pairs_per_sec=pairs_per_sec, step_ms=1e3 * seconds / iters,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        valid_centers=int(decoded.center_valid.sum()), stem_launches=launches, card=card)
    return launches


STEREO_KW = dict(max_peaks=16, peak_threshold=0.5, epipolar_threshold=3.0)


def device_events(fn):
    """The device operations (kernels, copies) of one call of fn, as
    (start, end) in us on the card's clock, in order, from torch.profiler
    tracing the card alone (CUPTI)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.device_type == DeviceType.CUDA)


def device_ms_by_name(fn, top=14):
    """The device time of one call of fn by kernel name, from torch.profiler
    tracing the card alone: the ``top`` names by total ms, with counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    totals = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            totals[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
            totals[e.name][1] += 1
    rows = sorted(totals.items(), key=lambda kv: -kv[1][0])
    return {"total_ms": sum(ms for ms, _ in totals.values()),
            "top": [{"name": name[:100], "ms": ms, "count": n} for name, (ms, n) in rows[:top]]}


def busy_us(ops):
    """Time covered by the union of the (start, end) intervals, us."""
    total, reach = 0.0, -float("inf")
    for s, e in ops:
        total += max(0.0, e - max(s, reach))
        reach = max(reach, e)
    return total


def trace_step(forward, decode, n_forward_ops):
    """One warm step, forward then decode, traced on the card while the
    host clock times the step's parts: the host's time in the forward and
    in the decode and its wait at the end, the step's wall time, and from
    the trace the device's busy time and idle share of that wall time, split
    at the end of the forward's last operation (its first n_forward_ops)."""
    marks = []

    def step():
        marks.append(time.perf_counter())
        heat = forward()
        marks.append(time.perf_counter())
        decode(heat)
        marks.append(time.perf_counter())
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    ops = device_events(step)
    assert len(ops) > n_forward_ops, (len(ops), n_forward_ops)
    fwd, dec = ops[:n_forward_ops], ops[n_forward_ops:]
    wall = 1e6 * (marks[3] - marks[0])
    fwd_end = max(e for _, e in fwd)
    busy = busy_us(ops)
    return {"trace_wall_ms": wall / 1e3, "trace_host_forward_ms": 1e3 * (marks[1] - marks[0]),
            "trace_host_decode_ms": 1e3 * (marks[2] - marks[1]),
            "trace_host_wait_ms": 1e3 * (marks[3] - marks[2]), "trace_device_ops": len(ops),
            "trace_device_busy_ms": busy / 1e3, "trace_device_idle_share": 1.0 - busy / wall,
            "trace_device_span_ms": (ops[-1][1] - ops[0][0]) / 1e3,
            "trace_forward_device_span_ms": (fwd_end - ops[0][0]) / 1e3,
            "trace_forward_device_busy_ms": busy_us(fwd) / 1e3,
            "trace_decode_device_span_ms": (max(e for _, e in dec) - fwd_end) / 1e3,
            "trace_decode_device_busy_ms": busy_us(dec) / 1e3}


def phase_stereo_serve(card):
    from object_keypoints_tpu_torch.geometry.cameras import load_calibration_params
    from object_keypoints_tpu_torch.pipeline.stereo import (
        StereoDecoded,
        StereoRigArrays,
        stereo_decode_triangulate,
    )
    from object_keypoints_tpu_torch.serving.export import make_inference_fn
    from object_keypoints_tpu_torch.testing import compare_stereo, lift_exact, serve_rig

    stereo_cam = serve_rig(load_calibration_params(CALIBRATION))
    rig = StereoRigArrays.from_stereo_camera(stereo_cam, device="cuda")
    infer = make_inference_fn(make_model(), dtype=torch.bfloat16, device="cuda")
    frames = torch.randn(2 * PAIRS, 3, 511, 511,
                         generator=torch.Generator().manual_seed(SEED + 2)).to("cuda", torch.bfloat16)

    def decode(heat):  # bench.py:111: the first PAIRS frames are left views
        return stereo_decode_triangulate(heat[:PAIRS], heat[PAIRS:], rig, **STEREO_KW)

    def step():
        heat, _, _ = infer(frames)
        return heat, decode(heat)

    torch.cuda.reset_peak_memory_stats()
    reset_stem_counts()  # the main path's run starts here
    heat, decoded = step()
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    iters = 20
    t0 = time.perf_counter()
    for _ in range(iters):
        heat, decoded = step()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = stem_counts()  # ... and ends here
    assert launches == {"all": 3 + iters, "stem_conv_bf16": 3 + iters, "stem_conv_fp32": 0}, launches
    peak_mem = torch.cuda.max_memory_allocated() / 2**30

    k, m = len(KEYPOINT_CONFIG) + 1, STEREO_KW["max_peaks"]
    shapes = dict(points_left=(PAIRS, k, m, 2), points_right=(PAIRS, k, m, 2),
                  match_valid=(PAIRS, k, m), points_3d=(PAIRS, k, m, 3),
                  left_valid=(PAIRS, k, m), confidence=(PAIRS, k, m))
    for name in StereoDecoded._fields:
        value = getattr(decoded, name)
        assert tuple(value.shape) == shapes[name], (name, value.shape)
        assert value.device.type == "cuda", (name, value.device)
        if value.is_floating_point() and name != "points_3d":
            assert torch.isfinite(value).all(), name
    assert torch.isfinite(heat).all()

    # the card's decode of every pair against the CPU decode of the same
    # maps, and each against the float64 lift of its own matched pixels
    rig64 = StereoRigArrays.from_stereo_camera(stereo_cam, dtype=torch.float64)
    cpu = stereo_decode_triangulate(heat[:PAIRS].cpu(), heat[PAIRS:].cpu(),
                                    StereoRigArrays.from_stereo_camera(stereo_cam), **STEREO_KW)
    exact_card, exact_cpu = lift_exact(decoded, rig64), lift_exact(cpu, rig64)
    card_vs_exact, held, no_depth = compare_stereo(decoded, exact_card, "stereo serve: card vs float64",
                                                   atol_2d=0.0)
    cpu_vs_exact, _, _ = compare_stereo(cpu, exact_cpu, "stereo serve: CPU vs float64", atol_2d=0.0)
    card_vs_cpu, _, _ = compare_stereo(decoded, cpu, "stereo serve: card vs CPU", atol_2d=1e-3,
                                       exact=exact_cpu)
    matched_exact = exact_cpu.points_3d[cpu.match_valid].norm(dim=-1)
    nonfinite = ~torch.isfinite(decoded.points_3d).all(-1)
    assert not (nonfinite & ~decoded.match_valid).any(), "non-finite unmatched slot"

    decode_ms = cuda_ms(lambda: decode(heat))
    forward_ms = cuda_ms(lambda: infer(frames))
    decode_ops = device_events(lambda: decode(heat))
    forward_ops = device_events(lambda: infer(frames))
    trace = trace_step(lambda: infer(frames)[0], decode, len(forward_ops))
    log("stereo_serve", pairs=PAIRS, frames=list(frames.shape), dtype="bfloat16",
        stereo_pairs_per_sec_triangulated=PAIRS * iters / seconds,
        step_ms=1e3 * seconds / iters, forward_ms=forward_ms, stereo_decode_ms=decode_ms,
        forward_device_ops=len(forward_ops), forward_device_ms=busy_us(forward_ops) / 1e3,
        stereo_decode_device_ops=len(decode_ops), stereo_decode_device_ms=busy_us(decode_ops) / 1e3,
        **trace, peak_mem_gib=peak_mem, matches=int(decoded.match_valid.sum()),
        matches_within_1m=int((matched_exact < 1.0).sum()),
        matches_beyond_3m=int((matched_exact >= 3.0).sum()),
        matches_held_3d=held, matches_no_depth=no_depth, nonfinite_3d=int(nonfinite.sum()),
        card_vs_float64=card_vs_exact, cpu_vs_float64=cpu_vs_exact, card_vs_cpu=card_vs_cpu,
        stem_launches=launches, card=card,
        tolerance="masks equal; 2D card vs CPU 1e-3 px; 3D 1e-4 m x max(1, (|p| / 1 m)^3) "
                  "of the float64 lift, as a fraction of which the three 3D errors are given")
    return launches


def phase_stereo_scene():
    from object_keypoints_tpu_torch.pipeline.stereo import StereoRigArrays, stereo_decode_triangulate
    from object_keypoints_tpu_torch.testing import compare_stereo, lift_exact, stereo_scene

    rig, heat_l, heat_r, points, channels = stereo_scene(CALIBRATION)
    kw = dict(max_peaks=8, peak_threshold=0.5, epipolar_threshold=3.0)
    out = stereo_decode_triangulate(torch.from_numpy(heat_l).cuda(), torch.from_numpy(heat_r).cuda(),
                                    StereoRigArrays.from_stereo_camera(rig, device="cuda"), **kw)
    cpu = stereo_decode_triangulate(torch.from_numpy(heat_l), torch.from_numpy(heat_r),
                                    StereoRigArrays.from_stereo_camera(rig), **kw)
    counts = out.match_valid.sum(-1).tolist()
    assert counts == [1, 1, 3], counts
    worst = 0.0
    for c, idx in enumerate(channels):
        for p in out.points_3d[c][out.match_valid[c]].cpu().numpy():
            err = np.linalg.norm(points[idx] - p, axis=1).min()
            assert err < 5e-2, (c, p, err)
            worst = max(worst, float(err))
    exact = lift_exact(out, StereoRigArrays.from_stereo_camera(rig, dtype=torch.float64))
    # every scene point lies within 1.07 m: a flat 1e-4 m, as in the CPU tests
    card_vs_exact, held, no_depth = compare_stereo(out, exact, "stereo scene: card vs float64",
                                                   atol_2d=0.0, flat_to=3.0)
    card_vs_cpu, _, _ = compare_stereo(out, cpu, "stereo scene: card vs CPU", atol_2d=1e-3,
                                       flat_to=3.0)
    assert held == 5 and no_depth == 0, (held, no_depth)
    log("stereo_scene", size=[180, 320], matches_per_channel=counts, worst_3d_err_m=worst,
        gate_m=5e-2, card_vs_float64=card_vs_exact, card_vs_cpu=card_vs_cpu,
        tolerance="masks equal; 2D card vs CPU 1e-3 px; 3D 1e-4 m")

def host_ms(fn):
    """fn()'s result and its milliseconds on the host clock, the card
    synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def traced_busy_share(fn):
    """fn() once, traced on the card (CUPTI) while the host clock times it:
    (share of the wall time the device was busy, device operations, wall
    ms)."""
    marks = []

    def timed():
        marks.append(time.perf_counter())
        fn()
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    ops = device_events(timed)
    wall_us = 1e6 * (marks[1] - marks[0])
    return busy_us(ops) / wall_us, len(ops), wall_us / 1e3


def check_summary(what, got, want):
    """Eval summaries: n_points and missing_pct equal, cm within 1e-3 cm."""
    assert got["n_points"] == want["n_points"] > 0, (what, got, want)
    assert got["missing_pct"] == want["missing_pct"], (what, got, want)
    worst = 0.0
    for key in ("mean_cm", "mean_xy_cm", "std_cm", "p25_cm", "p75_cm"):
        worst = max(worst, abs(got[key] - want[key]))
    assert worst <= 1e-3, (what, worst, got, want)
    return worst


def phase_eval(card):
    from object_keypoints_tpu_torch import evaluation
    from object_keypoints_tpu_torch.pipeline.decode import CameraArrays, decode_objects_batch
    from object_keypoints_tpu_torch.serving.export import export_model, load_inference_fn
    from object_keypoints_tpu_torch.testing import synthetic_sequence_in_memory

    config = {"keypoint_config": list(KEYPOINT_CONFIG)}
    with tempfile.TemporaryDirectory() as tmp:
        seq_dir = f"{tmp}/seq"
        t0 = time.perf_counter()
        recording = synthetic_sequence_in_memory(seq_dir, CALIBRATION, KEYPOINT_CONFIG,
                                                 n_frames=EVAL_FRAMES, seed=SEED)
        generate_s = time.perf_counter() - t0
        assert len(recording[1]) == EVAL_FRAMES and recording[1][0].shape == (720, 1280, 3)
        seq = evaluation.Sequence(seq_dir, config, device="cuda", recording=recording)
        seq_cpu = evaluation.Sequence(seq_dir, config, device="cpu", recording=recording)

        # the host's per-frame prefix: pose inverse, projection, resize/crop
        t0 = time.perf_counter()
        entries = list(seq.dataset.iter_prefix())
        prefix_ms = 1e3 * (time.perf_counter() - t0) / len(entries)

        def run(sequence, inference_fn=None, ground_truth=True):
            return evaluation.evaluate_sequence_fast(sequence, inference_fn, config,
                                                     batch_size=EVAL_BATCH,
                                                     ground_truth=ground_truth)

        # (a) ground truth: targets rendered and decoded on the card
        gt, gt_ms = host_ms(lambda: run(seq))
        gt_summary = gt.summary()
        gt_cpu_summary = run(seq_cpu).summary()
        gt_vs_cpu = check_summary("ground truth: card vs CPU", gt_summary, gt_cpu_summary)
        assert gt_summary["mean_cm"] < 5.0, gt_summary

        # (b) learned, fp32: the full-width model through an exported artifact
        model = make_model()
        assert round(sum(p.numel() for p in model.parameters()) / 1e6, 2) == 24.95
        export_model(f"{tmp}/artifact", {"heatmaps_out": 3, "input_size": 511, **config}, model)
        infer = load_inference_fn(f"{tmp}/artifact", device="cuda")
        batch = evaluation.batch_frames(entries[:EVAL_BATCH], "cuda")
        maps = infer(batch)  # warm-up, and the batch the checks below read
        torch.cuda.reset_peak_memory_stats()
        reset_stem_counts()  # the main path's run starts here
        learned, learned_ms = host_ms(lambda: run(seq, infer, ground_truth=False))
        launches = stem_counts()  # ... and ends here
        peak_mem = torch.cuda.max_memory_allocated() / 2**30
        batches = math.ceil(EVAL_FRAMES / EVAL_BATCH)
        assert launches == {"all": batches, "stem_conv_bf16": 0, "stem_conv_fp32": batches}, launches
        learned_summary = learned.summary()
        assert len(learned.gt_keypoints) == EVAL_FRAMES

    assert [tuple(t.shape) for t in maps] == [(EVAL_BATCH, 3, 64, 64), (EVAL_BATCH, 3, 64, 64),
                                              (EVAL_BATCH, 2, 2, 64, 64)]
    for t in maps:
        assert t.device.type == "cuda" and t.dtype == torch.float32 and torch.isfinite(t).all()
    cam = seq.camera_small
    decode_kw = dict(keypoint_config=KEYPOINT_CONFIG, model=cam.distortion_model, max_peaks=16)
    camera = CameraArrays.from_camera(cam, device="cuda")
    decoded = decode_objects_batch(*maps, camera, **decode_kw)
    check_decode_on_cpu("eval", decoded, maps, cam, decode_kw)
    for t in decoded:
        assert t.device.type == "cuda"
        if t.is_floating_point():
            assert torch.isfinite(t).all()

    # per batch: the forward and the decode by CUDA events, the copy to the
    # host and Results.add on the host clock
    forward_ms = cuda_ms(lambda: infer(batch))
    decode_ms = cuda_ms(lambda: decode_objects_batch(*maps, camera, **decode_kw))
    host, to_host_ms = host_ms(lambda: evaluation.decoded_to_host(decoded))
    results = evaluation.Results()
    results.set_calibration(cam)
    t0 = time.perf_counter()
    for k, entry in enumerate(entries[:EVAL_BATCH]):
        results.add(entry[3], evaluation.decoded_to_objects(host, k, KEYPOINT_CONFIG), seq.world_points)
    add_ms = 1e3 * (time.perf_counter() - t0)
    gt_busy, gt_ops, gt_trace_ms = traced_busy_share(lambda: run(seq))
    learned_busy, learned_ops, learned_trace_ms = traced_busy_share(
        lambda: run(seq, infer, ground_truth=False))
    log("eval", frames=EVAL_FRAMES, frame_size=[720, 1280], batch=EVAL_BATCH,
        source="synthetic recording in memory (no h5py on this machine); the CLI is not run",
        generate_s=generate_s,
        ground_truth_frames_per_sec=1e3 * EVAL_FRAMES / gt_ms, ground_truth_summary=gt_summary,
        ground_truth_card_vs_cpu_cm=gt_vs_cpu,
        learned_frames_per_sec=1e3 * EVAL_FRAMES / learned_ms, learned_summary=learned_summary,
        learned_dtype="float32", prefix_host_ms_per_frame=prefix_ms,
        forward_ms_per_batch=forward_ms, decode_ms_per_batch=decode_ms,
        decoded_to_host_ms_per_batch=to_host_ms, results_add_ms_per_batch=add_ms,
        ground_truth_trace=dict(device_busy_share=gt_busy, device_ops=gt_ops, wall_ms=gt_trace_ms),
        learned_trace=dict(device_busy_share=learned_busy, device_ops=learned_ops,
                           wall_ms=learned_trace_ms),
        peak_mem_gib=peak_mem, stem_launches=launches,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32, card=card,
        tolerance="summaries: n_points, missing_pct equal, cm within 1e-3; decode: masks equal, "
                  "1e-4 px, 1e-5 m")
    return launches


def state_dict_to(model, device):
    return {k: v.detach().to(device, copy=True) for k, v in model.state_dict().items()}


def phase_train(card):
    """The training slice on the device store: step times fp32 (TF32 off)
    and bf16, frames/s, a traced step, peak memory, a falling loss over
    TRAIN_STEPS augmented bf16 steps, one step on the card against the CPU,
    eval_step's stem launches by kernel, and the trained weights through
    export_model -> load_inference_fn -> decode."""
    from object_keypoints_tpu_torch.geometry.cameras import load_calibration_params
    from object_keypoints_tpu_torch.pipeline.decode import CameraArrays, decode_objects_batch
    from object_keypoints_tpu_torch.serving.export import export_model, load_inference_fn
    from object_keypoints_tpu_torch.precision import no_tf32
    from object_keypoints_tpu_torch.testing import serve_rig, synthetic_datasets
    from object_keypoints_tpu_torch.training import device_data, trainer

    config = (1, *KEYPOINT_CONFIG)  # the maps, center map first
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        datasets = synthetic_datasets(tmp, CALIBRATION, KEYPOINT_CONFIG, n_sequences=TRAIN_SEQUENCES,
                                      n_frames=TRAIN_FRAMES // TRAIN_SEQUENCES, n_objects=2, seed=SEED)
        store = device_data.build_device_store(datasets, "cuda")
        store_s = time.perf_counter() - t0
        store_cpu = device_data.DeviceStore(*(t.cpu() for t in store))
    assert store.n_frames == TRAIN_FRAMES and store.frames.shape[1:] == (511, 511, 3)
    assert store.valid.shape[1] == 2 and bool(store.valid.all()), store.valid.shape
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    order = torch.Generator(device="cuda").manual_seed(SEED + 3)

    def indices():
        return torch.randperm(store.n_frames, generator=order, device="cuda")[:TRAIN_BATCH]

    def step_parts(state, gen):
        """One augmented step as train_step_device_data runs it, through the
        same public calls it composes (device_batch, then train_step's
        loss_and_grads and apply_gradients), the host clock around each:
        the host's ms to enqueue the data suffix, the forward and backward,
        the optimizer, then its wait for the card."""
        torch.cuda.synchronize()
        marks = [time.perf_counter()]
        batch = device_data.device_batch(store, indices(), config, generator=gen)
        marks.append(time.perf_counter())
        loss, _, grads = trainer.loss_and_grads(state, batch, gen)
        marks.append(time.perf_counter())
        trainer.apply_gradients(state, grads, loss)
        marks.append(time.perf_counter())
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        names = ("data", "forward_backward", "optimizer", "wait")
        return {n: 1e3 * (b - a) for n, a, b in zip(names, marks, marks[1:])}

    def run(dtype, steps, timed):
        """``steps`` augmented steps from seeded weights; the losses, and the
        step time over ``timed`` steps after the first warm ones, by CUDA
        events and by host clock."""
        state = trainer.create_train_state(make_model(), trainer.make_optimizer(lr=TRAIN_LR), dtype)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
        step = lambda: device_data.train_step_device_data(state, store, indices(), gen, config)[1]
        torch.cuda.reset_peak_memory_stats()
        warm = steps - timed
        losses = [step()["loss"] for _ in range(warm)]
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        losses += [step()["loss"] for _ in range(timed)]
        end.record()
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0) / timed
        cuda_ms = start.elapsed_time(end) / timed
        peak = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.set_sync_debug_mode("error")  # a warm step must not wait for the card
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        busy, ops, wall = traced_busy_share(step)
        parts = [step_parts(state, gen) for _ in range(3)]
        return state, torch.stack(losses).cpu(), dict(
            host_ms_by_part={k: statistics.median(p[k] for p in parts) for k in parts[0]},
            step_ms_cuda_events=cuda_ms, step_ms_host=host_ms,
            frames_per_sec=1e3 * TRAIN_BATCH / host_ms, peak_mem_gib=peak,
            traced_step=dict(device_busy_share=busy, device_ops=ops, wall_ms=wall))

    state32, losses32, fp32 = run(torch.float32, 3 + TRAIN_TIMED, TRAIN_TIMED)
    state16, losses16, bf16 = run(torch.bfloat16, TRAIN_STEPS, TRAIN_TIMED)
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == flags
    assert torch.isfinite(losses32).all() and torch.isfinite(losses16).all()
    first10, last10 = losses16[:10].mean().item(), losses16[-10:].mean().item()
    assert last10 < first10, (first10, last10)
    assert all(p.dtype == torch.float32 for p in state16.model.parameters())

    # one fp32 step, batch 2, augment and dropout off: the card against the
    # CPU, and each against the same step in float64 on the CPU (the witness);
    # last, the control: the card's step with TF32 on and its pin taken away
    init = state_dict_to(make_model(dropout=0.0), "cpu")

    def one_step(dtype, st, device, tf32=False):
        mdl = make_model(dropout=0.0)
        mdl.load_state_dict(init)
        state = trainer.create_train_state(mdl.to(dtype), trainer.make_optimizer(lr=TRAIN_LR),
                                           dtype, device=device)
        batch = device_data.device_batch(st, torch.tensor([0, 1], device=device), config,
                                         augment=False)
        t0 = time.perf_counter()
        if tf32:
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
            trainer.no_tf32 = contextlib.nullcontext
        try:
            loss, _, grads = trainer.loss_and_grads(state, batch)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
            trainer.no_tf32 = no_tf32
        trainer.apply_gradients(state, grads, loss)
        return (loss.cpu().double(), [g.cpu().double() for g in grads],
                {k: v.double() for k, v in state_dict_to(mdl, "cpu").items()},
                time.perf_counter() - t0)

    sides = [one_step(torch.float32, store, "cuda"), one_step(torch.float32, store_cpu, "cpu"),
             one_step(torch.float64, store_cpu, "cpu"),
             one_step(torch.float32, store, "cuda", tf32=True)]
    (card_loss, card_grads, card_sd, _), (cpu_loss, cpu_grads, cpu_sd, cpu_s), exact, tf32 = sides

    def grad_error(grads, want):
        """The gradient's error as a share of the whole gradient's norm, and
        the worst single tensor's as a share of its largest element."""
        whole = (sum((g - w).square().sum() for g, w in zip(grads, want))
                 / sum(w.square().sum() for w in want)).sqrt().item()
        worst = max(((g - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()
                    for g, w in zip(grads, want))
        return whole, worst

    loss_rel = abs(card_loss.item() - cpu_loss.item()) / abs(cpu_loss.item())
    grad_rel, grad_tensor_rel = grad_error(card_grads, cpu_grads)
    card_vs_f64, card_vs_f64_tensor = grad_error(card_grads, exact[1])
    cpu_vs_f64, cpu_vs_f64_tensor = grad_error(cpu_grads, exact[1])
    tf32_vs_f64, tf32_vs_f64_tensor = grad_error(tf32[1], exact[1])
    stats_rel = max(((card_sd[k] - cpu_sd[k]).abs().max() / cpu_sd[k].abs().max()).item()
                    for k in cpu_sd if "running" in k)
    assert loss_rel <= 1e-5 and grad_rel <= 1e-2 and card_vs_f64 <= 1e-2 and stats_rel <= 1e-3, (
        loss_rel, grad_rel, card_vs_f64, stats_rel)
    # the control must fail the gradient gate, or the gate cannot see TF32
    assert tf32_vs_f64 > 1e-2, ("the TF32 control passes the gate", tf32_vs_f64)

    # eval_step on the card: the eval-mode stem runs the kernel of its dtype
    launches = {}
    for name, state in (("float32", state32), ("bfloat16", state16)):
        batch = device_data.device_batch(store, indices(), config, augment=False)
        reset_stem_counts()  # this path's run starts here
        metrics = trainer.eval_step(state, batch)
        launches[name] = stem_counts()  # ... and ends here
        assert all(torch.isfinite(v).all() for v in metrics.values())
        assert 0.0 <= metrics["val_loss"].item() <= 1.0
    assert launches["float32"] == {"all": 1, "stem_conv_bf16": 0, "stem_conv_fp32": 1}, launches
    assert launches["bfloat16"] == {"all": 1, "stem_conv_bf16": 1, "stem_conv_fp32": 0}, launches

    # the trained bf16 weights through an artifact, served in float32, and
    # the card's decode of their maps against the CPU's
    cam = serve_rig(load_calibration_params(CALIBRATION)).left_camera
    decode_kw = dict(keypoint_config=KEYPOINT_CONFIG, model="equidistant", max_peaks=16)
    with tempfile.TemporaryDirectory() as tmp:
        export_model(tmp, {"heatmaps_out": 3, "input_size": 511,
                           "keypoint_config": list(KEYPOINT_CONFIG)}, state16.model)
        infer = load_inference_fn(tmp, device="cuda")
    frames = trainer.prepare_frames(store.frames[:TRAIN_BATCH])
    maps = infer(frames)
    for t in maps:
        assert t.device.type == "cuda" and torch.isfinite(t).all()
    decoded = decode_objects_batch(*maps, CameraArrays.from_camera(cam, device="cuda"), **decode_kw)
    check_decode_on_cpu("trained", decoded, maps, cam, decode_kw)

    eval_launches = {k: sum(v[k] for v in launches.values()) for k in launches["float32"]}
    log("train", frames=TRAIN_FRAMES, frame_size=[511, 511], objects=2, batch=TRAIN_BATCH,
        lr=TRAIN_LR, params=sum(p.numel() for p in state16.model.parameters()),
        source="synthetic recordings in memory -> build_device_store; augment on",
        store_build_s=store_s, float32=fp32, bfloat16=bf16,
        bf16_losses=[round(x, 3) for x in losses16.tolist()],
        bf16_first10_mean=first10, bf16_last10_mean=last10, fp32_losses=losses32.tolist(),
        card_vs_cpu=dict(batch=2, loss_rel=loss_rel, grad_rel=grad_rel,
                         grad_worst_tensor_rel=grad_tensor_rel, card_vs_float64=card_vs_f64,
                         card_vs_float64_worst_tensor=card_vs_f64_tensor,
                         cpu_vs_float64=cpu_vs_f64, cpu_vs_float64_worst_tensor=cpu_vs_f64_tensor,
                         float64_loss_rel=abs(cpu_loss.item() - exact[0].item()) / exact[0].item(),
                         running_stats_rel=stats_rel, cpu_step_s=cpu_s, cpu_float64_step_s=exact[3],
                         tf32_control_vs_float64=tf32_vs_f64,
                         tf32_control_vs_float64_worst_tensor=tf32_vs_f64_tensor,
                         tf32_control_loss_rel=abs(tf32[0].item() - exact[0].item()) / exact[0].item(),
                         tolerance="loss rel 1e-5; the whole gradient within 1e-2 of its norm, card "
                                   "vs CPU and card vs the float64 step (cuDNN's float32 step moves "
                                   "by run: 9.5e-4 to 1.6e-3 of the norm seen; single tensors, which "
                                   "float32 misses by a few % where BatchNorm divides by small "
                                   "batch variances, are reported, not held); each running "
                                   "statistic within 1e-3 of its tensor's largest; the TF32 "
                                   "control beyond 1e-2 of the norm from float64"),
        eval_step_stem_launches=launches, trained_decode_valid_centers=int(decoded.center_valid.sum()),
        process_tf32_flags=dict(cudnn=flags[0], matmul=flags[1]), card=card)
    return eval_launches, bf16["step_ms_host"]


class Watch:
    """Host-clock timing of calls to functions that the loop looks up at
    call time (module globals and class attributes), and the indices in
    ``caught`` (the sync-debug warnings recorded so far) at each call's start
    and end: measurement only, every call is passed through."""

    def __init__(self, caught):
        self.caught, self.calls, self._undo = caught, collections.defaultdict(list), []

    def __call__(self, owner, name):
        original = getattr(owner, name)

        def watched(*args, **kwargs):
            start, t0 = len(self.caught), time.perf_counter()
            try:
                return original(*args, **kwargs)
            finally:
                self.calls[name].append(dict(start=start, end=len(self.caught), t0=t0,
                                             ms=1e3 * (time.perf_counter() - t0)))

        setattr(owner, name, watched)
        self._undo.append((owner, name, original))

    def restore(self):
        for owner, name, original in reversed(self._undo):
            setattr(owner, name, original)

    def syncs(self, name):
        return sum(is_sync(w) for c in self.calls[name] for w in self.caught[c["start"]:c["end"]])


def is_sync(warning):
    """A warning of ``torch.cuda.set_sync_debug_mode("warn")``."""
    return "called a synchronizing CUDA operation" in str(warning.message)


def sync_site(warning):
    return f"{os.path.relpath(warning.filename)}:{warning.lineno}"


def phase_loop(card, bare_step_ms):
    """The training loop, ``training.loop.fit``, on the card: 2 epochs of
    the full-width valve model in bf16 on in-memory sequences, then a resume,
    the package CLI and the packaged model served on the card."""
    from object_keypoints_tpu_torch import evaluation
    from object_keypoints_tpu_torch.cli import flagship, package_model
    from object_keypoints_tpu_torch.pipeline.decode import CameraArrays, decode_objects_batch
    from object_keypoints_tpu_torch.serving.export import load_inference_fn
    from object_keypoints_tpu_torch.training import checkpoints, loop

    options = {"keypoint_config": list(KEYPOINT_CONFIG)}
    phase_t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        train_split = flagship.synthetic_split(f"{tmp}/data", "train", LOOP_SEQUENCES,
                                               KEYPOINT_CONFIG, LOOP_FRAMES, n_objects=2)
        val_split = flagship.synthetic_split(f"{tmp}/data", "val", 1, KEYPOINT_CONFIG,
                                             LOOP_FRAMES, n_objects=2)
        data_s = time.perf_counter() - t0
        run = f"{tmp}/run"
        config = loop.TrainConfig(keypoint_config=list(KEYPOINT_CONFIG), batch_size=TRAIN_BATCH,
                                  lr=TRAIN_LR, bf16=True, seed=SEED, epochs=2, log_every=2,
                                  ckpt_every=1, tensorboard=True, out_dir=run)

        def fit(cfg, caught):
            """loop.fit as a user calls it, watched: the sync-debug warnings
            it raises, its steps, checkpoint writes and export."""
            watch = Watch(caught)
            for owner, name in ((loop, "train_step_device_data"), (loop, "eval_step"),
                                (loop, "export_model"),
                                (checkpoints.CheckpointManager, "save_last"),
                                (checkpoints.CheckpointManager, "flush_best")):
                watch(owner, name)
            sets = [loop.sequences([d for d, _ in split], cfg, train, [r for _, r in split])
                    for split, train in ((train_split, True), (val_split, False))]
            torch.cuda.reset_peak_memory_stats()
            reset_stem_counts()  # the main path's run starts here
            torch.cuda.set_sync_debug_mode("warn")
            try:
                result = loop.fit(cfg, *sets, device="cuda")
            finally:
                torch.cuda.set_sync_debug_mode("default")
                watch.restore()
            return result, stem_counts(), watch  # ... and ends here

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            result, launches, watch = fit(config, caught)
            fit_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps = watch.calls["train_step_device_data"]
        assert result["steps"] == len(steps) == 8, (result, len(steps))
        assert launches == {"all": 2, "stem_conv_bf16": 2, "stem_conv_fp32": 0}, launches
        # no training step waits for the card; the warm epoch's syncs, apart
        # from the checkpoint writes, are the log reads and the val read
        assert watch.syncs("train_step_device_data") == 0, [
            sync_site(w) for c in steps for w in caught[c["start"]:c["end"]]]
        epoch2_start, export = steps[4]["start"], watch.calls["export_model"][0]
        ckpt_windows = [c for n in ("save_last", "flush_best") for c in watch.calls[n]
                        if c["start"] >= epoch2_start]
        apart = {i for c in ckpt_windows + watch.calls["eval_step"]
                 for i in range(c["start"], c["end"])}
        epoch2 = collections.Counter(sync_site(caught[i]) for i in range(epoch2_start, export["start"])
                                     if i not in apart and is_sync(caught[i]))
        assert sum(epoch2.values()) <= 3, epoch2  # the two log reads and the val read

        names = sorted(os.listdir(run))
        assert [n for n in names if not n.startswith("events.out.tfevents.")] == [
            "best.msgpack", "best_val.json", "export", "hparams.json", "last.pt", "metrics.jsonl"]
        assert len(names) == 7 and sorted(os.listdir(f"{run}/export")) == ["config.json",
                                                                           "params.msgpack"]
        with open(f"{run}/metrics.jsonl") as f:
            logged = [json.loads(line) for line in f]
        assert [r["step"] for r in logged] == [2, 4, 4, 6, 8, 8], logged
        train_keys = {"loss", "grad_norm", "lr_scale", "heatmap_loss1", "depth_loss2"}
        for r in logged:
            assert train_keys <= set(r) if "loss" in r else {"val_loss", "total_heatmap_loss"} <= set(r)
            assert all(math.isfinite(v) for v in r.values())
        losses = [r["loss"] for r in logged if "loss" in r]
        vals = [r["val_loss"] for r in logged if "val_loss" in r]
        assert result["best_val_loss"] == min(vals)
        with open(f"{run}/best_val.json") as f:
            assert json.load(f) == {"val_loss": min(vals)}
        loop_step_ms = 1e3 * (logged[4]["time"] - logged[3]["time"]) / 2  # steps 6 -> 8, warm
        epoch2_ms = 1e3 * (ckpt_windows[-1]["t0"] + ckpt_windows[-1]["ms"] / 1e3 - steps[4]["t0"])

        # resume from last for one epoch, a fresh optimizer, into the same run
        best_bytes = open(f"{run}/{checkpoints.BEST}", "rb").read()
        with warnings.catch_warnings(record=True) as resume_caught:
            warnings.simplefilter("always")
            resumed, resume_launches, _ = fit(dataclasses.replace(config, resume=run, epochs=1),
                                              resume_caught)
        assert resumed["steps"] == 12 and resume_launches["stem_conv_bf16"] == 1, (
            resumed, resume_launches)
        with open(f"{run}/metrics.jsonl") as f:
            logged_after = [json.loads(line) for line in f]
        assert [r["step"] for r in logged_after[len(logged):]] == [10, 12, 12]
        resumed_val = logged_after[-1]["val_loss"]
        last = checkpoints.CheckpointManager(run).restore("last")
        assert last["step"] == 12 and last["opt_state"]["count"] == 4, last["opt_state"]["count"]
        if resumed_val >= min(vals):  # a worse val leaves the best as it was
            assert open(f"{run}/{checkpoints.BEST}", "rb").read() == best_bytes
            assert resumed["best_val_loss"] == min(vals)
        else:
            assert resumed["best_val_loss"] == resumed_val
            assert int(checkpoints.CheckpointManager(run).restore("best")["step"]) == 12

        # the package CLI: its artifact is the loop's export, and it serves
        packaged = package_model.main(["--model", run, "--out", f"{tmp}/package", "--which", "best"])
        for name in ("config.json", "params.msgpack"):
            with open(f"{tmp}/package/{name}", "rb") as a, open(f"{run}/export/{name}", "rb") as b:
                assert a.read() == b.read(), name
        val_dir, recording = val_split[0]
        seq = evaluation.Sequence(val_dir, options, device="cuda", recording=recording)
        entries = list(seq.dataset.iter_prefix())[:EVAL_BATCH]
        infer = load_inference_fn(f"{tmp}/package", device="cuda")
        frames = evaluation.batch_frames(entries, "cuda")
        reset_stem_counts()  # the packaged model's serve starts here
        maps = infer(frames)
        serve_launches = stem_counts()  # ... and ends here
        assert serve_launches == {"all": 1, "stem_conv_bf16": 0, "stem_conv_fp32": 1}, serve_launches
        for t in maps:
            assert t.device.type == "cuda" and torch.isfinite(t).all()
        cam = seq.camera_small
        decode_kw = dict(keypoint_config=KEYPOINT_CONFIG, model=cam.distortion_model, max_peaks=16)
        decoded = decode_objects_batch(*maps, CameraArrays.from_camera(cam, device="cuda"),
                                       **decode_kw)
        check_decode_on_cpu("packaged", decoded, maps, cam, decode_kw)

        # the package CLI with --quantize: no h5py and no sequence directory
        # here, so it calibrates on the unit-normal fallback; served "auto"
        t0 = time.perf_counter()
        quantized = package_model.main(["--model", run, "--out", f"{tmp}/package_int8",
                                        "--which", "best", "--quantize"])
        quantize_s = time.perf_counter() - t0
        assert sorted(os.listdir(f"{tmp}/package_int8")) == ["config.json", "params.msgpack",
                                                              "quant.json"]
        infer_int8 = load_inference_fn(f"{tmp}/package_int8", device="cuda")
        reset_stem_counts()  # the int8 packaged model's serve starts here
        maps_int8 = infer_int8(frames)
        int8_launches = stem_counts()  # ... and ends here
        assert int8_launches == {"all": 1, "stem_conv_bf16": 0, "stem_conv_fp32": 1}, int8_launches
        for t in maps_int8:
            assert t.device.type == "cuda" and torch.isfinite(t).all()
        camera = CameraArrays.from_camera(cam, device="cuda")
        decoded_int8 = decode_objects_batch(*maps_int8, camera, **decode_kw)
        check_decode_on_cpu("packaged int8", decoded_int8, maps_int8, cam, decode_kw)

    log("loop", train_frames=LOOP_FRAMES * LOOP_SEQUENCES, val_frames=LOOP_FRAMES,
        objects=2, batch=TRAIN_BATCH, lr=TRAIN_LR, dtype="bfloat16", epochs=2, steps=8,
        source="flagship.synthetic_split sequences in memory -> loop.sequences -> loop.fit "
               "(the device store: the frames fit its budget)",
        data_s=data_s, fit_s=fit_s, loop_step_ms=loop_step_ms, bare_step_ms_phase9=bare_step_ms,
        step_host_enqueue_ms=[round(c["ms"], 3) for c in steps], epoch2_wall_ms=epoch2_ms,
        save_last_ms=[c["ms"] for c in watch.calls["save_last"]],
        flush_best_ms=[c["ms"] for c in watch.calls["flush_best"]], export_ms=export["ms"],
        syncs_in_steps=0, syncs_epoch2_outside_checkpoints_and_eval_steps=dict(epoch2),
        syncs_in_eval_steps=watch.syncs("eval_step"),
        syncs_in_checkpoint_writes=[watch.syncs("save_last"), watch.syncs("flush_best")],
        syncs_whole_fit=sum(map(is_sync, caught)), peak_mem_gib=peak, losses=losses, val_losses=vals,
        resumed_val_loss=resumed_val, best_kept=resumed_val >= min(vals),
        stem_launches=dict(fit=launches, resume=resume_launches, packaged_serve=serve_launches,
                           packaged_int8_serve=int8_launches),
        packaged_equals_export=True, packaged_valid_centers=int(decoded.center_valid.sum()),
        packaged_int8=dict(quantized_convs=quantized["quantized_convs"], seconds=quantize_s,
                           calibration="unit-normal fallback", stem_launches=int8_launches,
                           valid_centers=int(decoded_int8.center_valid.sum())),
        phase_s=time.perf_counter() - phase_t0, card=card)
    return {k: launches[k] + resume_launches[k] + serve_launches[k] + int8_launches[k]
            for k in launches}


INT8_CALIBRATION = dict(n_frames=8, seed=7)  # bench.py's _calibration_batch
# one H100 SXM (NVIDIA's data sheet): dense int8 tensor-core peak, operations/s
PEAK_INT8_OPS = 1979e12
INT8_BUDGETS = {"heat": 0.02, "depth": 0.005, "centers": 0.25}  # tests/test_quantize.py
INT8_TIMED = 10


def int8_counts():
    from object_keypoints_tpu_torch.ops import int8_conv

    return {"int8_conv2d": int8_conv.int8_conv2d.launches,
            "int8_conv_transpose2d": int8_conv.int8_conv_transpose2d.launches}


def reset_int8_counts():
    from object_keypoints_tpu_torch.ops import int8_conv

    int8_conv.int8_conv2d.launches = int8_conv.int8_conv_transpose2d.launches = 0


def int8_shape_rows(model, scales, frames):
    """Each distinct int8 conv geometry of the default placement (its input
    recorded by a hook on a forward of ``frames``), plus hg_0's up2 unpool,
    quantized at its calibrated scale: the GEMM route's int32 sums against
    the plain version's (exact), the route's ms and its im2col's alone,
    cuDNN's bf16 conv of the same shape, and the route's TOP/s against the
    card's dense int8 peak."""
    from object_keypoints_tpu_torch.ops import int8_conv
    from object_keypoints_tpu_torch.serving.quantize import Int8Conv

    seen, handles = {}, []

    def record(module, args):
        x = args[0]
        key = (module.transpose, tuple(x.shape[1:]), module.out_channels, module.kernel_size,
               module.stride, module.padding)
        seen.setdefault(key, (module, []))[1].append(module.path)

    up2 = Int8Conv(model.backbone.hgs[0].up2, scales["backbone/hg_0/up2"], "backbone/hg_0/up2")
    for m in [*(m for m in model.modules() if isinstance(m, Int8Conv)), up2]:
        handles.append(m.register_forward_pre_hook(record))
    with torch.inference_mode():
        model.backbone.hgs[0].up2, float_up2 = up2, model.backbone.hgs[0].up2
        try:
            model(frames)
        finally:
            model.backbone.hgs[0].up2 = float_up2
            for h in handles:
                h.remove()
    torch.cuda.synchronize()
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    for (transpose, (c, h, w), o, k, s, p), (module, paths) in seen.items():
        n = frames.shape[0]
        xq = torch.randint(-127, 128, (n, h, w, c), generator=gen, dtype=torch.int8, device="cuda")
        wq, packed = module.int8_weight(), module.packed
        if transpose:
            def route():
                return int8_conv.int8_conv_transpose2d_gemm(xq, packed, o)

            def columns():  # one chunk at a time, as the route gathers them
                for _ in int8_conv.conv_transpose_im2col_chunks(xq):
                    pass

            def plain():
                return int8_conv.int8_conv_transpose2d_plain(xq, wq)

            def cudnn():
                return torch.nn.functional.conv_transpose2d(xb, wb, stride=2, padding=1)

            wb = wq.to(torch.bfloat16)
            ho, wo, taps = 2 * h, 2 * w, 4 * c
        else:
            def route():
                return int8_conv.int8_conv2d_gemm(xq, packed, o, k, s, p)

            def columns():
                for _ in int8_conv.im2col_chunks(xq, k, s, p):
                    pass

            def plain():
                return int8_conv.int8_conv2d_plain(xq, wq, s, p)

            def cudnn():
                return torch.nn.functional.conv2d(xb, wb, stride=s, padding=p)

            wb = wq.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
            ho, wo, taps = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1, k * k * c
        got = route()
        t0 = time.perf_counter()
        want = plain()
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        assert torch.equal(got, want), ("int8 route != plain", paths)
        del got, want
        xb = xq.permute(0, 3, 1, 2).to(torch.bfloat16)  # channels_last NCHW
        ms = kernel_ms(route, launches=3, runs=3)
        ops = 2.0 * n * ho * wo * taps * o
        rows.append(dict(
            convs=paths, transpose=transpose, frames=n, input_hwc=[h, w, c], out_channels=o,
            kernel=k, stride=s, padding=p, route_ms=ms,
            im2col_ms=kernel_ms(columns, launches=3, runs=3),
            cudnn_bf16_ms=kernel_ms(cudnn, launches=3, runs=3), plain_s=plain_s,
            equal_to_plain=True, route_tops=ops / ms / 1e9,
            int8_peak_share=ops / ms * 1e3 / PEAK_INT8_OPS))
        del xq, xb
    torch.cuda.empty_cache()
    return rows


def phase_int8(card):
    """int8 serving (bench.py's int8 mode): calibration on bench.py's
    synthetic frames, the distinct int8 conv shapes against their plain
    version, the int8 depth-head and stereo serve steps beside the bf16
    forward, and the artifact route (quant.json -> load_inference_fn)."""
    from object_keypoints_tpu_torch.data.scene import SceneDataset
    from object_keypoints_tpu_torch.geometry.cameras import load_calibration_params
    from object_keypoints_tpu_torch.pipeline.decode import CameraArrays, decode_objects_batch
    from object_keypoints_tpu_torch.pipeline.stereo import (
        StereoRigArrays,
        stereo_decode_triangulate,
    )
    from object_keypoints_tpu_torch.serving import calibration, quantize
    from object_keypoints_tpu_torch.serving.export import (
        export_model,
        load_inference_fn,
        make_inference_fn,
    )
    from object_keypoints_tpu_torch.testing import (
        compare_stereo,
        lift_exact,
        serve_rig,
        synthetic_sequence_in_memory,
    )

    phase_t0 = time.perf_counter()
    options = {"keypoint_config": list(KEYPOINT_CONFIG)}
    # 1. calibration: the full-width model in bf16 on bench.py's 8 frames,
    # read back through the per-frame SceneDataset code (511 resize)
    with tempfile.TemporaryDirectory() as tmp:
        recording = synthetic_sequence_in_memory(f"{tmp}/seq", CALIBRATION, KEYPOINT_CONFIG,
                                                 **INT8_CALIBRATION)
        dataset = SceneDataset(f"{tmp}/seq", options, recording=recording)
        frames = calibration.dataset_frames([dataset], INT8_CALIBRATION["n_frames"])
    model = make_model().to("cuda", memory_format=torch.channels_last).eval()
    batch = torch.from_numpy(np.stack(frames)).cuda().permute(0, 3, 1, 2)
    t0 = time.perf_counter()
    scales = quantize.calibrate_activation_scales(
        model, model, [batch.to(torch.bfloat16).contiguous()])
    calibrate_s = time.perf_counter() - t0
    eligible = set(quantize.conv_paths(model).values())
    assert set(scales) == eligible and all(v > 0 for v in scales.values()), len(scales)

    # 2. the int8 serve model (bf16 + int8 convs) and its distinct conv shapes
    cam_pair = serve_rig(load_calibration_params(CALIBRATION))
    camera = CameraArrays.from_camera(cam_pair.left_camera, device="cuda")
    decode_kw = dict(keypoint_config=KEYPOINT_CONFIG, model="equidistant", max_peaks=16,
                     reject_distance=20.0, peak_threshold=0.5)
    int8_model = make_model()
    infer = make_inference_fn(int8_model, dtype=torch.bfloat16, device="cuda", quant_scales=scales)
    n_int8 = sum(isinstance(m, quantize.Int8Conv) for m in int8_model.modules())
    infer_bf16 = make_inference_fn(make_model(), dtype=torch.bfloat16, device="cuda")
    frames = torch.randn(2 * PAIRS, 3, 511, 511, generator=torch.Generator().manual_seed(SEED + 2))
    frames = frames.to("cuda", torch.bfloat16)
    shapes = int8_shape_rows(int8_model, scales, frames)

    # 3. the int8 depth-head and stereo serve steps
    rig = StereoRigArrays.from_stereo_camera(cam_pair, device="cuda")

    def depth_step():
        maps = infer(frames)
        return maps, decode_objects_batch(*maps, camera, **decode_kw)

    def stereo_step():
        heat = infer(frames)[0]
        return heat, stereo_decode_triangulate(heat[:PAIRS], heat[PAIRS:], rig, **STEREO_KW)

    steps, launches = {}, []
    torch.cuda.reset_peak_memory_stats()
    for name, step in (("depth", depth_step), ("stereo", stereo_step)):
        reset_stem_counts()  # this path's run starts here
        reset_int8_counts()
        out = step()
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(INT8_TIMED):
            out = step()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts, int8 = stem_counts(), int8_counts()  # ... and ends here
        runs = 3 + INT8_TIMED
        assert counts == {"all": runs, "stem_conv_bf16": runs, "stem_conv_fp32": 0}, counts
        assert int8["int8_conv2d"] == runs * n_int8 and int8["int8_conv_transpose2d"] == 0, int8
        launches.append(counts)
        steps[name] = dict(pairs_per_sec=PAIRS * INT8_TIMED / seconds,
                           step_ms=1e3 * seconds / INT8_TIMED, stem_launches=counts,
                           int8_launches=int8)
        if name == "depth":
            maps, decoded = out
        else:
            heat, stereo = out
    peak_mem = torch.cuda.max_memory_allocated() / 2**30

    maps_bf16 = infer_bf16(frames)
    vs_bf16 = {}
    for key, got, want in zip(INT8_BUDGETS, maps, maps_bf16):
        assert torch.isfinite(got).all(), key
        vs_bf16[key] = (got - want).abs().max().item()
    check_decode_on_cpu("int8 serve", decoded, [t[:8] for t in maps], cam_pair.left_camera,
                        decode_kw)
    assert torch.isfinite(heat).all()
    rig64 = StereoRigArrays.from_stereo_camera(cam_pair, dtype=torch.float64)
    cpu = stereo_decode_triangulate(heat[:PAIRS].cpu(), heat[PAIRS:].cpu(),
                                    StereoRigArrays.from_stereo_camera(cam_pair), **STEREO_KW)
    card_vs_cpu, _, _ = compare_stereo(stereo, cpu, "int8 stereo serve: card vs CPU",
                                       atol_2d=1e-3, exact=lift_exact(cpu, rig64))
    # the forwards alone, bf16 and int8 in turns, in this call
    forward_ms = {"bfloat16": [], "int8": []}
    for name in ("bfloat16", "int8", "int8", "bfloat16"):
        forward_ms[name].append(cuda_ms(lambda: (infer if name == "int8" else infer_bf16)(frames)))
    ops = {"int8": len(device_events(lambda: infer(frames))),
           "bfloat16": len(device_events(lambda: infer_bf16(frames)))}
    by_kernel = {"int8": device_ms_by_name(lambda: infer(frames)),
                 "bfloat16": device_ms_by_name(lambda: infer_bf16(frames))}
    del frames, maps_bf16, infer, infer_bf16, int8_model

    # 4. the artifact route: quant.json -> load_inference_fn("auto") in float32
    x2 = torch.randn(2, 3, 511, 511, generator=torch.Generator().manual_seed(SEED + 5))
    config = {"heatmaps_out": 3, "input_size": 511, **options}
    with tempfile.TemporaryDirectory() as tmp:
        export_model(f"{tmp}/int8", config, make_model(), quant_scales=scales)
        export_model(f"{tmp}/float", config, make_model())
        assert sorted(os.listdir(f"{tmp}/int8")) == ["config.json", "params.msgpack", "quant.json"]
        auto = load_inference_fn(f"{tmp}/int8", device="cuda")
        reset_stem_counts()  # this path's run starts here
        reset_int8_counts()
        served = auto(x2.cuda())
        artifact_counts, artifact_int8 = stem_counts(), int8_counts()  # ... and ends here
        assert artifact_counts == {"all": 1, "stem_conv_bf16": 0, "stem_conv_fp32": 1}, (
            artifact_counts)
        assert artifact_int8["int8_conv2d"] == n_int8, artifact_int8
        launches.append(artifact_counts)
        t0 = time.perf_counter()
        cpu_maps = load_inference_fn(f"{tmp}/int8", device="cpu")(x2)
        cpu_s = time.perf_counter() - t0
        never = load_inference_fn(f"{tmp}/int8", quantize="never", device="cuda")(x2.cuda())
        plain_float = load_inference_fn(f"{tmp}/float", device="cuda")(x2.cuda())
        try:
            load_inference_fn(f"{tmp}/float", quantize="require", device="cuda")
            raise AssertionError('"require" served an artifact without quant.json')
        except FileNotFoundError:
            pass
    card_vs_cpu_int8 = {}
    for key, got, want in zip(INT8_BUDGETS, served, cpu_maps):
        assert got.device.type == "cuda" and torch.isfinite(got).all(), key
        card_vs_cpu_int8[key] = (got.cpu() - want).abs().max().item()
        assert card_vs_cpu_int8[key] < INT8_BUDGETS[key], (key, card_vs_cpu_int8)
    never_equal = all(torch.equal(a, b) for a, b in zip(never, plain_float))
    for a, b in zip(never, plain_float):
        check_close("never vs float", a, b, atol=1e-5, rtol=0)
    int8_vs_float32 = {k: (a - b).abs().max().item()
                       for k, a, b in zip(INT8_BUDGETS, served, never)}

    log("int8", frames=2 * PAIRS, dtype="bfloat16 + int8 convs (bench.py's int8 mode)",
        calibration=dict(frames=INT8_CALIBRATION["n_frames"], seed=INT8_CALIBRATION["seed"],
                         source="synthetic sequence in memory -> SceneDataset (511 resize)",
                         keys=len(scales), keys_equal_name_walk=True, seconds=calibrate_s),
        int8_convs=n_int8, placement="default: every eligible conv outside /hg_",
        shapes=shapes, depth=steps["depth"], stereo=steps["stereo"],
        forward_ms=forward_ms, forward_device_ops=ops, forward_device_ms_by_kernel=by_kernel,
        peak_mem_gib=peak_mem,
        int8_vs_bf16_max_abs=vs_bf16, stereo_card_vs_cpu=card_vs_cpu,
        artifact=dict(dtype="float32", stem_launches=artifact_counts, int8_launches=artifact_int8,
                      card_vs_cpu_int8_max_abs=card_vs_cpu_int8, budgets=INT8_BUDGETS,
                      cpu_forward_s=cpu_s, never_bitwise_equal_float=never_equal,
                      int8_vs_float32_max_abs=int8_vs_float32, require_raises=True),
        phase_s=time.perf_counter() - phase_t0, card=card)
    return {k: sum(c[k] for c in launches) for k in launches[0]}


DETECT_IMAGE = (480, 640)  # COCO's typical size: non-square frames
DETECT_TIMED = {"CornerNet_Squeeze": 5, "CornerNet": 3}  # warm calls timed
HEAT_GAIN = -30.0


def plant_heads(model):
    """Seeded random heads pair no corners (their top corners fall in other
    classes or inverted boxes), which would leave the decode's pairing and
    the soft-NMS without work. So each heat head's output kernel becomes its
    class 0 kernel, shared by every class and scaled by HEAT_GAIN, with
    biases -2.19 + 0.01 c: tests/test_torch_port_detector.py's recipe. On
    the 480x640 image it gives CornerNet-Squeeze ~100 and CornerNet ~1,100
    valid pairings of one or two classes."""
    with torch.no_grad():
        for heads in (model.tl_heats, model.br_heats):
            for head in heads:
                conv = head[1]
                conv.weight.copy_(conv.weight[:1].expand_as(conv.weight) * HEAT_GAIN)
                conv.bias.copy_(-2.19 + 0.01 * torch.arange(conv.bias.numel(), dtype=torch.float32))


def detector_for(arch, config_name=None):
    """A full-width detector from seeded weights (heads planted), bf16 on
    the card, as the detect CLI builds it."""
    from object_keypoints_tpu_torch.inference.detector import Detector
    from object_keypoints_tpu_torch.models.cornernet import FACTORIES
    from object_keypoints_tpu_torch.utils.config import CONFIG_DIR, DetectionConfig, load_cfg

    config = DetectionConfig(load_cfg(CONFIG_DIR / f"{config_name or arch}.json")[1])
    model = FACTORIES[arch](config["categories"], generator=torch.Generator().manual_seed(SEED))
    plant_heads(model)
    return Detector(model, config, device="cuda", dtype=torch.bfloat16)


def decode_kwargs(config):
    return dict(K=config["top_k"], ae_threshold=config["ae_threshold"],
                kernel=config["nms_kernel"], num_dets=config["num_dets"])


def canonical(dets):
    """Each image's detection rows in a device-independent order: by class
    and box, which the card and the CPU compute bit for bit (pixel indices
    plus gathered offsets); only the scores pass through the sigmoid."""
    out = []
    for d in dets:
        order = np.lexsort((d[:, 3], d[:, 2], d[:, 1], d[:, 0], d[:, 7]))
        out.append(d[order])
    return np.stack(out)


def check_detections(what, got, want, atol_box, atol_score):
    """(B, n, 8) detections: rejected counts and classes equal, boxes and
    scores within the tolerances, in the canonical order."""
    got, want = canonical(got), canonical(want)
    assert (got[..., 4] > -1).sum() == (want[..., 4] > -1).sum(), what
    assert np.array_equal(got[..., 7], want[..., 7]), what
    box = float(np.abs(got[..., :4] - want[..., :4]).max())
    score = float(np.abs(got[..., 4:7] - want[..., 4:7]).max())
    assert box <= atol_box and score <= atol_score, (what, box, score)
    return {"box_px": box, "score": score, "valid": int((want[..., 4] > -1).sum())}


def check_nms(what, card, cpu):
    """Per-class soft-NMS results: equal counts per class; boxes within
    1e-3 px and scores within 1e-5, in the canonical (box) order."""
    worst = {"box_px": 0.0, "score": 0.0}
    for j in cpu:
        a, b = card[j], cpu[j]
        assert a.shape == b.shape, (what, j, a.shape, b.shape)
        if not len(b):
            continue
        a, b = (x[np.lexsort((x[:, 3], x[:, 2], x[:, 1], x[:, 0]))] for x in (a, b))
        worst["box_px"] = max(worst["box_px"], float(np.abs(a[:, :4] - b[:, :4]).max()))
        worst["score"] = max(worst["score"], float(np.abs(a[:, 4] - b[:, 4]).max()))
    assert worst["box_px"] <= 1e-3 and worst["score"] <= 1e-5, (what, worst)
    return worst


def detector_stem_rows(det, batches):
    """The bf16 stem kernel against its plain version on the detector's own
    frames and stem weights, at each new shape: one output ulp, stated as
    rtol = atol = 1e-2; its ms, the plain version's and cuDNN's bf16 conv."""
    from object_keypoints_tpu_torch.ops.stem_conv import fold_bn, stem_conv, stem_conv_plain
    from object_keypoints_tpu_torch.precision import no_tf32

    stem = det.model.hg.pre[0]
    bn = stem.bn
    rows = []
    with torch.inference_mode(), no_tf32():
        w = stem.conv.weight
        scale, bias = fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
        for batch in batches:
            x = det.frames(batch)
            out = stem_conv(x, w, scale, bias)
            err = check_close(f"detector stem {tuple(x.shape)}", out,
                              stem_conv_plain(x, w, scale, bias), 1e-2, 1e-2)
            wc = w.to(torch.bfloat16)
            ms = kernel_ms(lambda: stem_conv(x, w, scale, bias))
            bound_ms, bound_by, _, _ = stem_bound(x, w.shape[0])
            rows.append({"shape": list(x.shape), "max_abs_err": err, "ms": ms,
                         "plain_ms": kernel_ms(lambda: stem_conv_plain(x, w, scale, bias),
                                               launches=3),
                         "library_ms": kernel_ms(lambda: torch.nn.functional.conv2d(
                             x, wc, stride=2, padding=3)),
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "bound_share": bound_ms / ms})
    return rows


def detector_run(det, image, timed):
    """The detector's main path: one cold call, then ``timed`` warm calls on
    the host clock (each returns host arrays, so it ends synchronised).
    Returns the last result, images/s, the stem launches and peak memory."""
    torch.cuda.reset_peak_memory_stats()
    reset_stem_counts()  # the main path's run starts here
    boxes = det(image)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        boxes = det(image)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = stem_counts()  # ... and ends here
    return boxes, timed / seconds, launches, torch.cuda.max_memory_allocated() / 2**30


def detector_split(det, image, trace_nms=True):
    """ms per image by part, each on its own: the host prefix, the upload,
    the forward and the decode (CUDA events), the copy back, the soft-NMS
    (host clock: upload, loop, copy back; its steps and device ops) and the
    host tail; plus the cards' checks of the decode and the soft-NMS against
    the CPU on the same inputs."""
    from object_keypoints_tpu_torch.inference import detector
    from object_keypoints_tpu_torch.ops.detection_decode import decode_detections
    from object_keypoints_tpu_torch.precision import no_tf32

    config, model = det.config, det.model
    kw = decode_kwargs(config)
    split = collections.defaultdict(float)
    all_dets, heads_checked = [], None
    for scale in config["test_scales"]:
        (batch, geometry), ms = host_ms(lambda: detector.scale_batch(config, image, scale))
        split["host_prefix_ms"] += ms
        frames, ms = host_ms(lambda: det.frames(batch))
        split["upload_ms"] += ms
        with torch.inference_mode(), no_tf32():
            def forward():
                return model.heads(model.hg(frames)[-1], model.stacks - 1)

            heads = forward()
            split["forward_ms"] += cuda_ms(forward, iters=5, warmup=1)
            dets = decode_detections(*heads, **kw)
            split["decode_ms"] += cuda_ms(lambda: decode_detections(*heads, **kw), iters=5,
                                          warmup=1)
        host, ms = host_ms(lambda: dets.cpu().numpy())
        split["copy_back_ms"] += ms
        if heads_checked is None:  # the first scale's decode, card vs CPU, same heads
            cpu = decode_detections(*(h.cpu() for h in heads), **kw).numpy()
            heads_checked = check_detections("detector decode: card vs CPU", host, cpu,
                                             atol_box=1e-4, atol_score=1e-5)
        (dets_img, ms) = host_ms(lambda: detector.rescale_scale(config, host.copy(), geometry))
        split["host_tail_ms"] += ms
        all_dets.append(dets_img)
    detections = np.concatenate(all_dets, axis=1)[0]
    (boxes, steps), nms_ms = host_ms(lambda: detector.class_soft_nms(config, detections, "cuda"))
    nms = {"nms_ms": nms_ms, "nms_steps": steps, "nms_rows": len(detections)}
    if trace_nms:  # (the multi-scale loop's ~10^5 operations are not traced)
        ops = device_events(lambda: detector.class_soft_nms(config, detections, "cuda"))
        nms.update(nms_device_ops=len(ops), nms_device_busy_ms=busy_us(ops) / 1e3,
                   nms_launches_per_step=len(ops) / max(steps, 1))
    _, ms = host_ms(lambda: detector.cap_detections(config, dict(boxes)))
    split["host_tail_ms"] += ms
    return dict(split), nms, heads_checked, detections


def synthetic_nms(config, rows):
    """``class_soft_nms`` on ``rows`` synthetic detections, all valid, over
    the config's classes (sizes drawn from a Dirichlet, boxes of 4-120 px in
    a 640x480 image, scores in (0, 1)): the card against the CPU, and the
    card's ms, steps and device ops."""
    from object_keypoints_tpu_torch.inference import detector

    rng = np.random.default_rng(SEED + 12)
    classes = rng.choice(config["categories"], rows, p=rng.dirichlet(np.ones(config["categories"])))
    xy = rng.uniform(0, [640, 480], (rows, 2))
    dets = np.concatenate([xy, xy + rng.uniform(4, 120, (rows, 2)), rng.uniform(0, 1, (rows, 3)),
                           classes[:, None]], axis=1).astype(np.float32)
    (card, steps), ms = host_ms(lambda: detector.class_soft_nms(config, dets, "cuda"))
    ops = device_events(lambda: detector.class_soft_nms(config, dets, "cuda"))
    cpu, _ = detector.class_soft_nms(config, dets, "cpu")
    check = check_nms("synthetic soft-NMS: card vs CPU", card, cpu)
    return {"rows": rows, "ms": ms, "steps": steps, "device_ops": len(ops),
            "device_busy_ms": busy_us(ops) / 1e3, "card_vs_cpu": check,
            "kept": int(sum(len(v) for v in card.values()))}


def phase_detector(card):
    """The CornerNet detectors' serve path through ``Detector`` at full
    width, bf16, seeded weights, on a 480x640 synthetic image: (a)
    CornerNet-Squeeze, one scale, no flip; (b) CornerNet, flip; (c) one call
    of CornerNet under the multi-scale config (five scales, flip, merge)."""
    from object_keypoints_tpu_torch.inference import detector
    from object_keypoints_tpu_torch.ops.stem_conv import stem_conv_plain
    from object_keypoints_tpu_torch.precision import no_tf32

    phase_t0 = time.perf_counter()
    image = np.random.default_rng(SEED).integers(0, 256, (*DETECT_IMAGE, 3), dtype=np.uint8)
    launches, results = [], {}
    for arch in ("CornerNet_Squeeze", "CornerNet"):
        det = detector_for(arch)
        config = det.config
        n_params = sum(p.numel() for p in det.model.parameters())
        flip = 2 if config["test_flipped"] else 1
        batches = [detector.scale_batch(config, image, s)[0] for s in config["test_scales"]]
        assert [b.shape for b in batches] == [(flip, 511, 767, 3)], [b.shape for b in batches]

        boxes, images_per_sec, counts, peak_mem = detector_run(det, image, DETECT_TIMED[arch])
        calls = 1 + DETECT_TIMED[arch]
        # every stem launch of the path went to the bf16 kernel, one a scale
        assert counts == {"all": calls, "stem_conv_bf16": calls, "stem_conv_fp32": 0}, counts
        launches.append(counts)
        assert sorted(boxes, key=int) == [str(i) for i in range(1, 81)]
        for v in boxes.values():
            assert v.shape[1] == 5 and np.isfinite(v).all()
        n_boxes = sum(len(v) for v in boxes.values())
        assert 0 < n_boxes <= config["max_per_image"] + 5, n_boxes  # ties at the cap stay

        split, nms, decode_check, detections = detector_split(det, image)
        assert decode_check["valid"] > 0 and nms["nms_steps"] > 0, (decode_check, nms)
        # the card's soft-NMS against the CPU's on the same detections, and
        # on a stack of the same size where every row is real
        card_nms, _ = detector.class_soft_nms(config, detections, "cuda")
        cpu_nms, _ = detector.class_soft_nms(config, detections, "cpu")
        nms_check = check_nms(f"{arch} soft-NMS: card vs CPU", card_nms, cpu_nms)
        nms_full = synthetic_nms(config, len(detections))

        # the frames and the outputs are on the card and finite
        x = det.frames(batches[0])
        assert x.device.type == "cuda" and x.dtype == torch.bfloat16 and x.is_contiguous()
        with torch.inference_mode():
            out = det.forward(x, **decode_kwargs(config))
        assert out.device.type == "cuda" and torch.isfinite(out).all()

        # the forward in float32 (TF32 off): the stem kernel against the plain stem
        with torch.inference_mode(), no_tf32():
            x32 = x.float()
            reset_stem_counts()
            got = det.model(x32, test=True, **decode_kwargs(config))
            fp32_counts = stem_counts()
            want = det.model(x32, test=True, stem=stem_conv_plain, **decode_kwargs(config))
        assert fp32_counts == {"all": 1, "stem_conv_bf16": 0, "stem_conv_fp32": 1}, fp32_counts
        fp32_err = 0.0
        for name, g, w in zip(("tl_heat", "br_heat", "tl_tag", "br_tag"), got[1:], want[1:]):
            ref = max(1.0, w.abs().max().item())
            fp32_err = max(fp32_err, check_close(f"{arch} fp32 {name}", g, w,
                                                 atol=1e-4 * ref, rtol=1e-4) / ref)

        by_kernel = device_ms_by_name(lambda: det.forward(x, **decode_kwargs(config)), top=40)
        pools = [r for r in by_kernel["top"] if "cummax" in r["name"].lower()
                 or "scan" in r["name"].lower()]
        busy, ops, wall = traced_busy_share(lambda: det(image))
        results[arch] = dict(
            params=n_params, frames=[flip, 3, 511, 767], dtype="bfloat16",
            images_per_sec=images_per_sec, ms_per_image=1e3 / images_per_sec, **split, **nms,
            device_ops_per_image=ops, device_busy_share=busy, traced_wall_ms=wall,
            forward_device_ms=by_kernel["total_ms"], pool_kernels=pools,
            top_kernels=by_kernel["top"][:10], peak_mem_gib=peak_mem, boxes=n_boxes,
            decode_card_vs_cpu=decode_check, nms_card_vs_cpu=nms_check,
            nms_all_rows_valid=nms_full,
            fp32_forward_max_rel_err=fp32_err, stem_launches=counts,
            stem_rows=detector_stem_rows(det, batches))
        log("detector", arch=arch, **results[arch], card=card)
        del det, x, x32, out, got, want
        torch.cuda.empty_cache()

    # (c) CornerNet under the multi-scale config: five scales, flip, merge
    det = detector_for("CornerNet", "CornerNet-multi_scale")
    config = det.config
    batches = [detector.scale_batch(config, image, s)[0] for s in config["test_scales"]]
    shapes = [list(b.shape) for b in batches]
    assert shapes == [[2, 255, 383, 3], [2, 383, 511, 3], [2, 511, 767, 3], [2, 639, 895, 3],
                      [2, 767, 1023, 3]], shapes
    assert config["merge_bbox"]
    boxes, images_per_sec, counts, peak_mem = detector_run(det, image, 1)
    assert counts == {"all": 10, "stem_conv_bf16": 10, "stem_conv_fp32": 0}, counts
    launches.append(counts)
    for v in boxes.values():
        assert v.shape[1] == 5 and np.isfinite(v).all()
    split, nms, decode_check, detections = detector_split(det, image, trace_nms=False)
    log("detector", arch="CornerNet", config="CornerNet-multi_scale", scales=config["test_scales"],
        frames=[[b.shape[0], 3, *b.shape[1:3]] for b in batches], images_per_sec=images_per_sec,
        ms_per_image=1e3 / images_per_sec, **split, **nms, peak_mem_gib=peak_mem,
        boxes=sum(len(v) for v in boxes.values()), decode_card_vs_cpu=decode_check,
        stem_launches=counts, stem_rows=detector_stem_rows(det, batches), card=card,
        tolerance="stem: rtol = atol = 1e-2 (one bf16 ulp); decode: canonical order, "
                  "classes equal, boxes 1e-4 px, scores 1e-5; soft-NMS: counts per class "
                  "equal, boxes 1e-3 px, scores 1e-5; fp32 heads: atol 1e-4 x max(1, max|ref|)")
    log("detector_phase", phase_s=time.perf_counter() - phase_t0)
    return {k: sum(c[k] for c in launches) for k in launches[0]}


def main():
    card = phase_device()
    phase_build()
    stem = phase_stem_kernel()
    paths = [phase_full_forward(), phase_serve(card), phase_stereo_serve(card)]
    phase_stereo_scene()
    paths.append(phase_eval(card))
    train_launches, bare_step_ms = phase_train(card)
    paths.append(train_launches)
    paths.append(phase_loop(card, bare_step_ms))
    paths.append(phase_int8(card))
    paths.append(phase_detector(card))
    assert "jax" not in sys.modules, "the port imported jax"
    kernels = [{"name": name, "route": "cuda", "source": STEM_SOURCE, "replaces": STEM_REPLACES,
                "launches": sum(p[name] for p in paths), **stem[name]}
               for name in STEM_KERNELS.values()]
    for k in kernels:
        assert k["launches"] > 0, f"{k['name']} was not launched on its path"
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
