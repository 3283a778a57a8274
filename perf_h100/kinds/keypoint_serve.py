"""Closed-loop serving of stereo frame batches through the keypoint model.

The traffic file gives:

- ``pairs``: stereo pairs a batch (2 x pairs frames of ``frame`` x ``frame``);
- ``pool``: distinct batches made from the seed on the card, cycled;
- ``dtype``: the compute dtype; ``quantize``: null, or the int8 route: its
  calibration (``batches`` of ``batch`` seeded frames, max-abs of each
  convolution's input) and its placement (convolutions with groups 1, at
  least ``min_in_features`` input channels, outside ``skip_prefixes``);
- ``decode``: the object decode's settings;
- ``warm_calls``; ``sample``: how many calls the check compares, drawn from
  the seed among the window's first ``from_first``; ``trace_seconds``: how
  long a traced run profiles the card's activity after the window, calls
  back to back on the pool; ``trace_calls``: calls profiled with the
  host's activity too, for the idle gaps (``harness.trace``), and each of
  the two stretches of the program's own spans and counters, taken after
  every other reading (``harness.program_trace``); ``ref_block``: frames a
  block of the reference's forward.

One client, one batch in flight: each call is submitted when the last one's
objects are on the host, timed on the host's clock from submit until then.
A call is the port's ``serving.export.make_inference_fn`` forward (sigmoid
heatmaps, depth, centers) and ``pipeline.decode.decode_objects_batch``,
then every field of the decoded objects copied to the host.

The check, once the window has closed and the program is freed: the plain
reference (the configuration's ``reference_model``, float32 with TF32 off,
in blocks of frames; for the int8 route its own calibration on the same
frames and the same int8 arithmetic) runs on the sampled calls' frames, and
``reference.decode`` (float32 on the card) decodes the program's own maps:

- ``maps_gap``: the largest |program - reference| over the three maps,
  each over max(1, max |reference|) of its map;
- ``decode_frames_off``: frames whose decoded objects differ from the
  reference's: a mask or an index that differs, a 2D point off by more than
  1e-3 px, or a 3D point off by more than 1e-4 x max(1, |reference|).
"""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from harness import flops, program_trace, trace
from harness.core import device_record, dtype, sync
from harness.camera import camera_tensors, serve_camera
from harness.weights import batchnorm_stats, materialize, meta_model, seeded_state
from reference import decode as ref_decode
from reference import layers as ref_layers
from reference import lowp

PX_TOL, P3D_TOL = 1e-3, 1e-4



def port_model(config):
    """The port's keypoint model of ``config`` on the meta device."""
    from object_keypoints_tpu_torch.serving.export import model_from_config

    return meta_model(model_from_config, config["model"])


class Program:
    """The port's serve path, built from the seeded state."""

    def __init__(self, ctx, state, camera, calibration):
        from object_keypoints_tpu_torch.pipeline.decode import CameraArrays, decode_objects_batch
        from object_keypoints_tpu_torch.serving.export import make_inference_fn

        tr = ctx.traffic
        compute = dtype(tr["dtype"])
        model = materialize(port_model(ctx.config), state, ctx.device)
        scales = None
        if tr.get("quantize"):
            from object_keypoints_tpu_torch.serving.quantize import calibrate_activation_scales

            model.to(memory_format=torch.channels_last).eval()
            with torch.no_grad():
                scales = calibrate_activation_scales(model, lambda b: model(b.to(compute)),
                                                     calibration)
        self.infer = make_inference_fn(model, dtype=compute, device=ctx.device,
                                       quant_scales=scales)
        self.camera = CameraArrays.from_camera(camera, device=ctx.device)
        self.decode_fn = decode_objects_batch
        self.kw = dict(keypoint_config=tuple(ctx.config["keypoint_config"]), **tr["decode"])

    def forward(self, frames):
        return self.infer(frames)

    def decode(self, maps):
        return tuple(self.decode_fn(*maps, self.camera, **self.kw))


class Control:
    """The reference in the program's place, a precision below the one the
    cell serves in: a bfloat16 route's convolutions in float8 e4m3
    (``lowp.fp8``), the int8 route's with int4 codes; the decode in
    bfloat16."""

    def __init__(self, ctx, state, camera, calibration):
        if ctx.traffic.get("quantize"):
            self.model = reference_model(ctx, state, calibration, bits=4)
        else:
            self.model = lowp.set_quant(reference_model(ctx, state), lowp.fp8)
        self.camera = camera_tensors(camera, ctx.device, torch.bfloat16)
        self.ctx = ctx

    def forward(self, frames):
        with torch.no_grad(), lowp.no_tf32():
            return tuple(t.float() for t in self.model(frames.float()))

    def decode(self, maps):
        return reference_decode(self.ctx, [m.bfloat16() for m in maps], self.camera)


CONTROLS = {"control": Control}


def reference_model(ctx, state, calibration=None, bits=8):
    """The configuration's plain reference with the seeded state; for an
    int8 route, calibrated on ``calibration`` and its placed convolutions
    given ``bits``-bit codes."""
    model = ctx.reference.reference_model(ctx.config)
    model.load_state_dict(state, strict=True)
    model = model.to(ctx.device).eval()
    q = ctx.traffic.get("quantize")
    if q:
        placed = {name: m for name, m in model.named_modules()
                  if isinstance(m, (ref_layers.Conv2d, ref_layers.ConvTranspose2d))
                  and m.groups == 1 and m.in_channels >= q["min_in_features"]
                  and not name.startswith(tuple(q["skip_prefixes"]))}
        s_act = {}

        def hook(name):
            def pre(module, args):
                v = args[0].detach().abs().amax()
                s_act[name] = torch.maximum(s_act[name], v) if name in s_act else v
            return pre

        handles = [m.register_forward_pre_hook(hook(n)) for n, m in placed.items()]
        with torch.no_grad(), lowp.no_tf32():
            for batch in calibration:
                model(batch.float())
        for h in handles:
            h.remove()
        for name in s_act:  # the placed convolutions that the serve outputs use
            placed[name].quant = lowp.int_codes(bits, float(s_act[name]))
    return model


def reference_decode(ctx, maps, camera):
    d = ctx.traffic["decode"]
    return ref_decode.decode_objects(*maps, camera, tuple(ctx.config["keypoint_config"]),
                                     d["max_peaks"], d["reject_distance"], d["peak_threshold"])


def make_inputs(ctx, seed):
    """The pool of frame batches and the calibration frames, on the card."""
    tr = ctx.traffic
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(seed)
    n, s = 2 * tr["pairs"], tr["frame"]
    pool = [torch.randn((n, 3, s, s), generator=gen, device=ctx.device).to(dtype(tr["dtype"]))
            for _ in range(tr["pool"])]
    q = tr.get("quantize") or {}
    calibration = [torch.randn((q["batch"], 3, s, s), generator=gen, device=ctx.device)
                   .to(dtype(tr["dtype"])) for _ in range(q.get("batches", 0))]
    return pool, calibration


def run(ctx, program_cls=Program):
    tr, dev = ctx.traffic, ctx.device
    w_seed, in_seed, sample_seed = ctx.streams
    calib = ctx.config["camera"]
    camera = serve_camera(calib, tr["frame"], ctx.config["output_size"])
    phases = {}
    t = time.perf_counter()
    state = seeded_state(meta_model(ctx.reference.reference_model, ctx.config), w_seed, dev,
                         ctx.config.get("weight_overrides"))
    pool, calibration = make_inputs(ctx, in_seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(w_seed)
    bn = ctx.config["batchnorm_stats_frames"]
    batchnorm_stats(ctx.reference.reference_model(ctx.config), state,
                    torch.randn((bn, 3, tr["frame"], tr["frame"]), generator=gen, device=dev))
    phases["weights_inputs"] = time.perf_counter() - t
    t = time.perf_counter()
    program = program_cls(ctx, state, camera, calibration)
    for i in range(tr["warm_calls"]):
        [x.cpu() for x in program.decode(program.forward(pool[i % len(pool)]))]
    sync(dev)
    phases["build_warm"] = time.perf_counter() - t
    rng = np.random.default_rng(sample_seed)
    sample = set(rng.choice(tr["sample"]["from_first"], tr["sample"]["calls"], replace=False).tolist())

    spans = trace.Spans(ctx.trace and dev != "cpu")
    kept, latencies = {}, []
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    i = 0
    while True:
        t = time.perf_counter()
        frames = pool[i % len(pool)]
        a = spans.mark()
        maps = program.forward(frames)
        b = spans.mark()
        decoded = program.decode(maps)
        c = spans.mark()
        host = [x.cpu() for x in decoded]
        latencies.append(time.perf_counter() - t)
        spans.add("forward", a, b)
        spans.add("decode", b, c)
        if i in sample:
            kept[i] = (maps, host)
        i += 1
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    window_s = time.perf_counter() - t_start
    calls = i

    rec = types.SimpleNamespace(
        setup_s=setup_s, window_s=window_s, calls=calls, units=calls * tr["pairs"],
        latencies_s=latencies, spans=spans.ms() if spans.enabled else {}, trace=None,
        attempted=calls, failed=0, readings={}, info={"setup_phases_s": phases})
    if ctx.trace and dev != "cpu":
        def call(rf, j):
            with rf("forward"):
                maps = program.forward(pool[j % len(pool)])
            with rf("decode"):
                decoded = program.decode(maps)
            with rf("to_host"):
                [x.cpu() for x in decoded]

        stretch = trace.profile(call, tr["trace_seconds"], host=False)
        rec.trace = trace.over_window(
            trace.reduce_trace(stretch, trace.profile(call, tr["trace_calls"], host=True)),
            stretch.calls, calls, window_s)
        rec.info["trace_stretch"] = rec.trace.get("stretch")
    rec.info["flops_per_call"] = flops.conv_flops(
        meta_model(ctx.reference.reference_model, ctx.config), (2 * tr["pairs"], 3, tr["frame"],
                                                               tr["frame"]))
    rec.info["frames"] = [2 * tr["pairs"], 3, tr["frame"], tr["frame"]]
    rec.info["peak"] = "int8" if tr.get("quantize") else "bf16"
    rec.device = device_record(ctx)
    if ctx.trace and dev != "cpu":
        rec.program = program_trace.collect(call, tr["trace_calls"])
        rec.info["program_trace"] = rec.program
    del program
    release(dev)
    rec.readings = check(ctx, state, camera, pool, kept, calibration)
    return rec



def release(dev):
    if dev != "cpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()



def check(ctx, state, camera, pool, kept, calibration):
    """The readings of the sampled calls against the plain reference."""
    from contextlib import nullcontext

    model = reference_model(ctx, state, calibration)
    cam = camera_tensors(camera, ctx.device)
    block = ctx.traffic["ref_block"]
    maps_gap, frames_off, frames = 0.0, 0, 0
    no_tf32 = lowp.no_tf32() if ctx.device != "cpu" else nullcontext()
    with torch.no_grad(), no_tf32:
        for i, (maps, host) in sorted(kept.items()):
            x = pool[i % len(pool)].float()
            ref = [torch.cat(parts) for parts in
                   zip(*(model(x[j:j + block]) for j in range(0, len(x), block)))]
            for got, want in zip(maps, ref):
                scale = max(1.0, want.abs().max().item())
                maps_gap = max(maps_gap, (got.float() - want).abs().max().item() / scale)
            want_dec = [t.cpu() for t in reference_decode(ctx, [m.float() for m in maps], cam)]
            frames_off += int(frames_differ(host, want_dec).sum())
            frames += len(x)
    if not kept:
        return {}
    return {"maps_gap": maps_gap, "decode_frames_off": frames_off}


def frames_differ(got, want):
    """(N,) bool: frame n's decoded objects differ (see the module doc)."""
    off = torch.zeros(want[0].shape[0], dtype=torch.bool)
    for name, g, w in zip(ref_decode.FIELDS, got, want):
        g = g.reshape(len(g), -1)
        w = w.reshape(len(w), -1)
        if g.shape != w.shape:
            return torch.ones_like(off)
        if not w.is_floating_point():
            off |= (g != w.to(g.dtype)).any(dim=1)
        elif name.endswith("p3d"):
            off |= ((g.double() - w.double()).abs() > P3D_TOL * w.double().abs().clamp(min=1.0)).any(1)
        else:
            off |= ((g.double() - w.double()).abs() > PX_TOL).any(dim=1)
        off |= ~torch.isfinite(g.double()).all(dim=1)
    return off
