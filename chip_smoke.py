"""Smoke run of the PyTorch port's serve path on one CUDA card.

    python3 chip_smoke.py

Drives ``object_keypoints_tpu_torch`` (never jax) once, at full width:

1. device and environment (nvidia-smi name and power limit, torch, CUDA);
2. builds the CUDA kernels from ``object_keypoints_tpu_torch/csrc``;
3. the stem kernel against its plain version: fp32 (TF32 off, atol 1e-4)
   and bf16 (one output ulp, stated as rtol = atol = 1e-2) at
   (16, 3, 511, 511), and bf16 at the serve step's (96, 3, 511, 511); median
   times of the kernel, the plain version and cuDNN's bf16 conv + BN + ReLU;
4. the full-width valve KeypointNet (heatmaps_out=3, 24.95M parameters,
   weights from a seeded torch.Generator) in fp32 with TF32 off: the forward
   with the stem kernel against the same forward with the plain stem;
5. the serve step as bench.py measures it, in float (bf16): 48 stereo pairs
   of 511x511 frames -> make_inference_fn -> decode_objects_batch
   (keypoints (1, 3), equidistant, 16 peaks, 20 px reject, threshold 0.5)
   through bench.py's camera chain; checks shapes and finiteness, decodes
   the same maps on the CPU for comparison, checks the stem kernel ran,
   and prints stereo pairs/s from a warm timed loop.

Any failed check raises, so the exit code is non-zero. The last two lines
are the kernels' JSON and ``{"ok": true, "device": {...}}``.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PAIRS = 48  # bench.py's default batch
SEED = 0
KEYPOINT_CONFIG = (1, 3)
STEM_REPLACES = "object_keypoints_tpu/ops/pallas/stem_conv.py:127"


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
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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
            if "registers" in line]
    log("build", library=lib.name, seconds=seconds, ptxas=regs)


def stem_inputs(n, dtype, gen):
    x = torch.randn(n, 3, 511, 511, generator=gen).to("cuda", dtype)
    w = (torch.randn(128, 3, 7, 7, generator=gen) * 0.08).cuda()
    scale = (torch.rand(128, generator=gen) + 0.5).cuda()
    bias = (torch.randn(128, generator=gen) * 0.1).cuda()
    return x, w, scale, bias


def phase_stem_kernel():
    from object_keypoints_tpu_torch.ops.stem_conv import stem_conv, stem_conv_plain

    gen = torch.Generator().manual_seed(SEED)
    result = {}
    for n, dtype, atol, rtol in ((16, torch.float32, 1e-4, 0.0), (16, torch.bfloat16, 1e-2, 1e-2),
                                 (2 * PAIRS, torch.bfloat16, 1e-2, 1e-2)):
        x, w, scale, bias = stem_inputs(n, dtype, gen)
        out = stem_conv(x, w, scale, bias)
        torch.cuda.synchronize()
        assert out.shape == (n, 128, 256, 256) and out.dtype == dtype
        assert out.is_contiguous(memory_format=torch.channels_last)
        err = check_close(f"stem {n} {dtype}", out, stem_conv_plain(x, w, scale, bias), atol, rtol)
        ms = cuda_ms(lambda: stem_conv(x, w, scale, bias))
        plain_ms = cuda_ms(lambda: stem_conv_plain(x, w, scale, bias))
        # what the eager model would run without the kernel: cuDNN conv in
        # the frames' dtype, then the folded BN and the ReLU as separate ops
        xc, wc = x, w.to(dtype)
        cudnn_ms = cuda_ms(lambda: torch.relu(
            torch.nn.functional.conv2d(xc, wc, stride=2, padding=3)
            * scale.to(dtype)[:, None, None] + bias.to(dtype)[:, None, None]))
        flop = 2.0 * n * 256 * 256 * 128 * 147
        log("stem_kernel", shape=list(x.shape), dtype=str(dtype), max_abs_err=err, atol=atol,
            rtol=rtol, ms=ms, plain_ms=plain_ms, cudnn_conv_bn_relu_ms=cudnn_ms,
            kernel_tflops=flop / ms / 1e9)
        result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        del x, out
    return result  # the last row: the serve step's shape and dtype


def make_model():
    from object_keypoints_tpu_torch.models.keypoint_net import KeypointNet

    return KeypointNet(heatmaps_out=3, generator=torch.Generator().manual_seed(SEED))


def phase_full_forward():
    from object_keypoints_tpu_torch.ops.stem_conv import stem_conv, stem_conv_plain

    model = make_model()
    n_params = sum(p.numel() for p in model.parameters())
    assert round(n_params / 1e6, 2) == 24.95, n_params
    model = model.to("cuda", memory_format=torch.channels_last).eval()
    x = torch.randn(2, 3, 511, 511, generator=torch.Generator().manual_seed(SEED + 1)).cuda()
    before = stem_conv.launches
    with torch.inference_mode():
        out = model(x)
        ref = model(x, stem=stem_conv_plain)
    assert stem_conv.launches == before + 1
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
        max_rel_err=worst, tolerance="atol 1e-4 x max(1, max|ref|), rtol 1e-4")


def phase_serve(card):
    from object_keypoints_tpu_torch.geometry.cameras import FisheyeCamera, load_calibration_params
    from object_keypoints_tpu_torch.ops.stem_conv import stem_conv
    from object_keypoints_tpu_torch.pipeline.decode import (
        CameraArrays,
        DecodedObjects,
        decode_objects_batch,
    )
    from object_keypoints_tpu_torch.serving.export import make_inference_fn

    params = load_calibration_params("config/calibration.yaml")
    offset = np.array([(511.0 / 720.0 * 1280.0 - 511.0) / 2.0, 0.0])  # bench.py:194
    cam = (FisheyeCamera(params["K"], params["D"], params["image_size"])
           .scale(511.0 / 720.0).cut(offset).scale(64.0 / 511.0))
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
    stem_conv.launches = 0  # the main path's run starts here
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
    launches = stem_conv.launches  # ... and ends here
    assert launches == 3 + iters, launches

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
    cpu = decode_objects_batch(*(t[:k].cpu() for t in maps),
                               CameraArrays.from_camera(cam), **decode_kw)
    for name in DecodedObjects._fields:
        got, want = getattr(decoded, name)[:k].cpu(), getattr(cpu, name)
        if got.is_floating_point():
            tol = 1e-5 if name.endswith("p3d") else 1e-4
            check_close(f"decode {name}", got, want, atol=tol, rtol=0)
        else:
            assert torch.equal(got, want), name

    pairs_per_sec = PAIRS * iters / seconds
    log("serve", pairs=PAIRS, frames=list(frames.shape), dtype="bfloat16",
        stereo_pairs_per_sec=pairs_per_sec, step_ms=1e3 * seconds / iters,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
        valid_centers=int(decoded.center_valid.sum()), stem_launches=launches, card=card)
    return launches


def main():
    card = phase_device()
    phase_build()
    stem = phase_stem_kernel()
    phase_full_forward()
    launches = phase_serve(card)
    assert "jax" not in sys.modules, "the port imported jax"
    print(json.dumps({"kernels": [{
        "name": "stem_conv", "route": "cuda",
        "source": "object_keypoints_tpu_torch/csrc/stem_conv.cu",
        "replaces": STEM_REPLACES, "launches": launches, **stem,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
