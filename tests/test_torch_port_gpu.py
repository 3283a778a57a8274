"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card: a CUDA
kernel has no CPU mode. The file imports neither jax nor the JAX package,
so it also runs where jax is not installed:

    python -m pytest --noconftest tests/test_torch_port_gpu.py -q

fp32 comparisons run with TF32 off (cuDNN and matmul) and atol 1e-4, the
tolerance of the CPU parity tests; they go to the CUDA-core kernel. bf16
comparisons go to the tensor-core kernel and allow one output ulp, stated as
rtol = atol = 1e-2. The stem wrapper picks its kernel by the frames' dtype
and counts each launch in ``utils.timer``'s ``stem.kernel``, which the
tests read with tracing on. The stereo decode on the card is held to the
CPU decode and to the float64 lift of its own pixels as
``object_keypoints_tpu_torch.testing.compare_stereo`` states: masks equal,
2D within 1e-3 px, 3D within 1e-4 m x max(1, (|p| / 1 m)^3).
"""

import contextlib
import copy
import pathlib
import threading

import numpy
import pytest

torch = pytest.importorskip("torch")

from object_keypoints_tpu_torch.models.keypoint_net import KeypointNet  # noqa: E402
from object_keypoints_tpu_torch.ops.stem_conv import stem_conv, stem_conv_plain  # noqa: E402
from object_keypoints_tpu_torch.testing import traced  # noqa: E402

pytestmark = pytest.mark.gpu
ROOT = pathlib.Path(__file__).resolve().parents[1]
CALIBRATION = "config/calibration.yaml"
FULL_WIDTH = dict(heatmaps_out=3)  # the valve KeypointNet at full width: KeypointNet's defaults


@pytest.fixture
def cuda(monkeypatch):
    """The card, with TF32 off for the test's plain comparisons; the
    process's flags come back after each test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _stem_launches(fn):
    """fn()'s result and the stem kernel's launches in it."""
    out, counts, _ = traced(fn)
    return out, counts.get("stem.kernel", 0)


def _stem_args(c_out, seed, device):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(c_out, 3, 7, 7, generator=g) * 0.1
    scale = torch.rand(c_out, generator=g) + 0.5
    bias = torch.randn(c_out, generator=g) * 0.1
    return g, w.to(device), scale.to(device), bias.to(device)


@pytest.mark.parametrize("size", [64, 63, 37])
@pytest.mark.parametrize("c_out", [4, 8, 128])
def test_stem_fp32_matches_plain(cuda, size, c_out):
    g, w, scale, bias = _stem_args(c_out, size * c_out, cuda)
    x = torch.randn(3, 3, size, size, generator=g).to(cuda)
    out, launched = _stem_launches(lambda: stem_conv(x, w, scale, bias))
    assert launched == 1 and out.dtype == x.dtype == torch.float32  # the fp32 kernel
    assert out.shape == (3, c_out, (size + 1) // 2, (size + 1) // 2)
    assert out.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(out, stem_conv_plain(x, w, scale, bias), atol=1e-4, rtol=0)


def _check_bf16_kernel(x, w, scale, bias):
    """One launch of the tensor-core kernel, within one output ulp of the
    plain version (which rounds the taps to bf16 as the kernel does)."""
    out, launched = _stem_launches(lambda: stem_conv(x, w, scale, bias))
    assert launched == 1 and x.dtype == torch.bfloat16  # the bf16 kernel
    n, _, h, wd = x.shape
    assert out.dtype == torch.bfloat16 and out.shape == (n, w.shape[0], (h + 1) // 2, (wd + 1) // 2)
    assert out.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(out.float(), stem_conv_plain(x, w, scale, bias).float(),
                               atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("size", [64, 63, 37])
@pytest.mark.parametrize("c_out", [8, 64, 128])
def test_stem_bf16_tensor_cores_match_plain(cuda, size, c_out):
    g, w, scale, bias = _stem_args(c_out, 7 * size + c_out, cuda)
    _check_bf16_kernel(torch.randn(3, 3, size, size, generator=g).to(cuda, torch.bfloat16),
                       w, scale, bias)


def test_stem_bf16_within_one_ulp(cuda):
    g, w, scale, bias = _stem_args(128, 1, cuda)
    _check_bf16_kernel(torch.randn(2, 3, 511, 511, generator=g).to(cuda, torch.bfloat16),
                       w, scale, bias)


def test_stem_bf16_follows_weights_written_in_place(cuda):
    """The kernel's tap matrix is kept on the weights between calls; a write
    to the weights must reach the next launch."""
    g, w, scale, bias = _stem_args(64, 3, cuda)
    x = torch.randn(2, 3, 63, 63, generator=g).to(cuda, torch.bfloat16)
    _check_bf16_kernel(x, w, scale, bias)
    w.mul_(-1.5)
    _check_bf16_kernel(x, w, scale, bias)


def test_stem_bf16_rejects_c_out_not_a_multiple_of_8(cuda):
    _, w, scale, bias = _stem_args(12, 2, cuda)
    frame = torch.zeros(1, 3, 16, 16, device=cuda, dtype=torch.bfloat16)

    def rejected():
        with pytest.raises(ValueError, match="C % 8"):
            stem_conv(frame, w, scale, bias)

    assert _stem_launches(rejected)[1] == 0
    stem_conv(frame.float(), w, scale, bias)  # fp32 takes C % 4 == 0


def test_stem_rejects_what_the_kernel_does_not_take(cuda):
    _, w, scale, bias = _stem_args(8, 2, cuda)
    frame = torch.zeros(1, 3, 16, 16, device=cuda)
    with pytest.raises(TypeError):
        stem_conv(frame.half(), w, scale, bias)
    with pytest.raises(ValueError):
        stem_conv(torch.zeros(1, 16, 16, 3, device=cuda).permute(0, 3, 1, 2), w, scale, bias)
    with pytest.raises(ValueError):
        stem_conv(frame, w[:6], scale[:6], bias[:6])
    with pytest.raises(ValueError):
        stem_conv(frame, w, scale.double(), bias)
    with pytest.raises(ValueError):
        stem_conv(frame, w.cpu(), scale, bias)


def test_tiny_keypoint_net_kernel_matches_plain_stem(cuda):
    """The eval forward with the stem kernel equals the same forward with
    the plain stem passed explicitly."""
    g = torch.Generator().manual_seed(3)
    model = KeypointNet(heatmaps_out=3, features=8, dropout=0.0, stacks=2, levels=2,
                        dims=(8, 8, 16), mods=(1, 1, 1), stem_features=(4, 8), cnv_dim=8,
                        generator=g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    model = model.to(cuda, memory_format=torch.channels_last).eval()
    x = torch.randn(2, 3, 64, 64, generator=g).to(cuda)
    with torch.inference_mode():
        (out, ref), launched = _stem_launches(lambda: (model(x), model(x, stem=stem_conv_plain)))
    assert launched == 1
    for got, want in zip((*out.heatmaps, *out.depth, *out.centers),
                         (*ref.heatmaps, *ref.depth, *ref.centers)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_full_width_keypoint_net_kernel_matches_plain_stem(cuda):
    """The full-width valve KeypointNet (KeypointNet's defaults, seeded
    weights) in float32 on two 511x511 frames: the eval forward with the
    fp32 stem kernel, launched once, equals the same forward with the plain
    stem within 1e-4 x max(1, max |ref|) (rtol 1e-4)."""
    model = KeypointNet(**FULL_WIDTH, generator=torch.Generator().manual_seed(0))
    model = model.to(cuda, memory_format=torch.channels_last).eval()
    x = torch.randn(2, 3, 511, 511, generator=torch.Generator().manual_seed(1)).to(cuda)
    with torch.inference_mode():
        (out, ref), launched = _stem_launches(lambda: (model(x), model(x, stem=stem_conv_plain)))
    assert launched == 1
    for got, want in zip((*out.heatmaps, *out.depth, *out.centers),
                         (*ref.heatmaps, *ref.depth, *ref.centers)):
        assert torch.isfinite(got).all()
        scale = max(1.0, want.abs().max().item())
        torch.testing.assert_close(got, want, atol=1e-4 * scale, rtol=1e-4)


def test_stereo_decode_on_card_matches_cpu(cuda, monkeypatch):
    """The analytic stereo scene and seeded random maps through bench.py's
    camera chain, decoded on the card and on the CPU."""
    from object_keypoints_tpu_torch.geometry.cameras import load_calibration_params
    from object_keypoints_tpu_torch.pipeline.stereo import (
        StereoKeypointPipeline,
        StereoRigArrays,
        stereo_decode_triangulate,
    )
    from object_keypoints_tpu_torch.testing import compare_stereo, lift_exact, serve_rig, stereo_scene

    monkeypatch.chdir(ROOT)
    rig, heat_l, heat_r, _, _ = stereo_scene(CALIBRATION)
    g = torch.Generator().manual_seed(4)
    serve = serve_rig(load_calibration_params(CALIBRATION))
    cases = [(rig, torch.from_numpy(heat_l), torch.from_numpy(heat_r), 8),
             (serve, torch.rand(4, 3, 64, 64, generator=g), torch.rand(4, 3, 64, 64, generator=g), 16)]
    for stereo_cam, left, right, max_peaks in cases:
        kw = dict(max_peaks=max_peaks, peak_threshold=0.5, epipolar_threshold=3.0)
        got = stereo_decode_triangulate(left.to(cuda), right.to(cuda),
                                        StereoRigArrays.from_stereo_camera(stereo_cam, device=cuda), **kw)
        want = stereo_decode_triangulate(left, right, StereoRigArrays.from_stereo_camera(stereo_cam), **kw)
        assert all(t.device.type == "cuda" for t in got)
        exact = lift_exact(want, StereoRigArrays.from_stereo_camera(stereo_cam, dtype=torch.float64))
        _, held, _ = compare_stereo(got, want, f"max_peaks={max_peaks}", atol_2d=1e-3, exact=exact)
        assert held > 0
        compare_stereo(got, lift_exact(got, StereoRigArrays.from_stereo_camera(
            stereo_cam, dtype=torch.float64)), f"max_peaks={max_peaks} vs float64", atol_2d=0.0)

    # the host facade decodes where its input lies
    facade = StereoKeypointPipeline({"keypoint_config": [1, 3]}, max_peaks=8,
                                    epipolar_threshold=3.0)
    facade.reset(rig)
    on_card = facade(torch.from_numpy(heat_l).to(cuda), torch.from_numpy(heat_r).to(cuda))
    on_cpu = facade(heat_l, heat_r)
    assert [len(o["p_L"]) for o in on_card] == [len(o["p_L"]) for o in on_cpu] == [1, 1, 3]
    for a, b in zip(on_card, on_cpu):
        torch.testing.assert_close(torch.from_numpy(a["p_L"]), torch.from_numpy(b["p_L"]),
                                   atol=1e-4, rtol=0)


def test_components_decode_on_the_card(cuda, monkeypatch):
    """LearnedKeypointTrackingPipeline(cuda=True) runs inference, peak
    extraction and center association on the card, and its objects equal
    those of the same pipeline on the CPU."""
    from object_keypoints_tpu_torch.geometry.cameras import load_calibration_params
    from object_keypoints_tpu_torch.ops import associate, decode
    from object_keypoints_tpu_torch.pipeline import components
    from object_keypoints_tpu_torch.testing import gaussian_maps, serve_rig

    monkeypatch.chdir(ROOT)
    seen = []

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*args, **kwargs):
            seen.append((name, args[0].device.type))
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapped)

    spy(decode, "extract_peaks")
    spy(associate, "assign_to_centers")
    centers = [(20.0, 30.0), (44.0, 30.0)]
    heat = gaussian_maps([centers, [(21.0, 27.0), (43.0, 27.5)], [(17.0, 33.0), (40.0, 34.0)]],
                         (64, 64))
    depth = torch.full((1, 3, 64, 64), 1.5)
    offsets = torch.zeros(1, 2, 2, 64, 64)
    ys, xs = torch.meshgrid(torch.arange(64.0), torch.arange(64.0), indexing="ij")
    for cx, cy in centers:  # every pixel votes for the nearest center
        near = (xs - cx).abs() <= 16
        offsets[0, :, 0][:, near] = cx - (xs[near] + 0.5)
        offsets[0, :, 1][:, near] = cy - (ys[near] + 0.5)

    def model(frames):
        assert frames.device.type == device
        return (torch.from_numpy(heat)[None].to(frames.device), depth.to(frames.device),
                offsets.to(frames.device))

    camera = serve_rig(load_calibration_params(CALIBRATION)).left_camera
    results = {}
    for device in ("cuda", "cpu"):
        seen.clear()
        pipeline = components.LearnedKeypointTrackingPipeline(
            model, device == "cuda", [64, 64], None, {"keypoint_config": [1, 2]}, max_peaks=8)
        pipeline.reset(camera)
        results[device] = pipeline(torch.zeros(1, 3, 64, 64))
        assert sorted(set(seen)) == [("assign_to_centers", device), ("extract_peaks", device)]
    (card, card_heat), (cpu, cpu_heat) = results["cuda"], results["cpu"]
    assert isinstance(card_heat, numpy.ndarray) and len(card) == len(cpu) == 2
    for a, b in zip(card, cpu):
        for pa, pb in zip(a["p_C"], b["p_C"]):
            torch.testing.assert_close(torch.from_numpy(pa), torch.from_numpy(pb), atol=1e-4, rtol=0)


def test_targets_render_on_card_as_on_cpu(cuda):
    """The target renderer on the card against the same renderer on the CPU,
    a batch of frames with overlapping discs, out-of-frame and invalid
    points: heatmaps within 1e-6 (exp rounds differently), depth and centers
    within 1e-6 with equal support."""
    from object_keypoints_tpu_torch.data import targets

    rng = numpy.random.default_rng(9)
    config = (1, 1, 3)
    points = rng.uniform(-8, 72, size=(6, 3, 5, 2)).astype(numpy.float32)
    points[:, 1:, :2] = points[:, :1, :2] + rng.uniform(-4, 4, size=(6, 2, 2, 2))
    points_C = numpy.concatenate([points, rng.uniform(0.5, 2.0, size=(6, 3, 5, 1))],
                                 axis=-1).astype(numpy.float32)
    valid = rng.uniform(size=(6, 3, 5)) > 0.2
    inputs = [torch.from_numpy(a) for a in (points, points_C, valid)]
    cpu = targets.render_all_targets(*inputs, config, (64, 64))
    card = targets.render_all_targets(*(t.to(cuda) for t in inputs), config, (64, 64))
    for name, got, want in zip(("heatmaps", "depth", "centers"), card, cpu):
        assert got.device.type == "cuda", name
        torch.testing.assert_close(got.cpu(), want, atol=1e-6, rtol=0, msg=lambda m: f"{name}: {m}")
        if name != "heatmaps":
            assert torch.equal(got.cpu() != 0, want != 0), name


def test_ground_truth_fast_eval_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """evaluate_sequence_fast(ground_truth=True) on the card (targets
    rendered and decoded there) against the CPU, on a synthetic sequence
    held in memory: n_points and missing_pct equal, cm within 1e-3; and the
    dataset's examples with targets rendered on the card against the CPU's
    (maps within 1e-6)."""
    from object_keypoints_tpu_torch import evaluation
    from object_keypoints_tpu_torch.testing import synthetic_sequence_in_memory

    monkeypatch.chdir(ROOT)
    seq_dir = str(tmp_path / "seq")
    recording = synthetic_sequence_in_memory(seq_dir, CALIBRATION, (1, 3), n_frames=6, seed=7)
    config = {"keypoint_config": [1, 3]}
    card, cpu = (evaluation.evaluate_sequence_fast(
        evaluation.Sequence(seq_dir, config, device=device, recording=recording), None, config,
        batch_size=4, ground_truth=True).summary() for device in ("cuda", "cpu"))
    assert card["n_points"] == cpu["n_points"] > 0 and card["missing_pct"] == cpu["missing_pct"]
    for key in ("mean_cm", "mean_xy_cm", "std_cm", "p25_cm", "p75_cm"):
        assert abs(card[key] - cpu[key]) <= 1e-3, (key, card[key], cpu[key])
    assert card["mean_cm"] < 5.0

    # the per-frame examples of a dataset rendering on the card
    from object_keypoints_tpu_torch.data.scene import SceneDataset

    on_card = SceneDataset(seq_dir, config, device=cuda, recording=recording)
    on_cpu = SceneDataset(seq_dir, config, recording=recording)
    for got, want in zip(on_card, on_cpu):
        assert torch.equal(torch.from_numpy(got["frame"]), torch.from_numpy(want["frame"]))
        for name in ("heatmaps", "depth", "centers"):
            torch.testing.assert_close(torch.from_numpy(got[name]), torch.from_numpy(want[name]),
                                       atol=1e-6, rtol=0)


def test_learned_fast_eval_on_card_decodes_as_the_cpu(cuda, tmp_path, monkeypatch):
    """evaluate_sequence_fast with a learned model on the card: the
    full-width valve KeypointNet (seeded weights) written by export_model
    and read back by load_inference_fn
    (float32: the fp32 stem kernel once a batch), over a synthetic sequence
    held in memory; its maps finite on the card, and one batch's decode on
    the card equal to the CPU decode of the same maps (masks equal, 2D
    within 1e-4 px, 3D within 1e-5 m)."""
    from object_keypoints_tpu_torch import evaluation
    from object_keypoints_tpu_torch.pipeline.decode import (
        CameraArrays,
        DecodedObjects,
        decode_objects_batch,
    )
    from object_keypoints_tpu_torch.serving.export import export_model, load_inference_fn
    from object_keypoints_tpu_torch.testing import synthetic_sequence_in_memory

    monkeypatch.chdir(ROOT)
    config = {"keypoint_config": [1, 3]}
    seq_dir = str(tmp_path / "seq")
    recording = synthetic_sequence_in_memory(seq_dir, CALIBRATION, (1, 3), n_frames=6, seed=7)
    seq = evaluation.Sequence(seq_dir, config, device=cuda, recording=recording)
    artifact = str(tmp_path / "artifact")
    export_model(artifact, {**FULL_WIDTH, "input_size": 511, **config},
                 KeypointNet(**FULL_WIDTH, generator=torch.Generator().manual_seed(0)))
    infer = load_inference_fn(artifact, device=cuda)
    result, launched = _stem_launches(lambda: evaluation.evaluate_sequence_fast(
        seq, infer, config, batch_size=4, ground_truth=False))
    assert launched == 2 and len(result.gt_keypoints) == 6  # batches of 4 and 2

    maps = infer(evaluation.batch_frames(list(seq.dataset.iter_prefix())[:4], cuda))
    assert [tuple(t.shape) for t in maps] == [(4, 3, 64, 64), (4, 3, 64, 64), (4, 2, 2, 64, 64)]
    for t in maps:
        assert t.device.type == "cuda" and t.dtype == torch.float32 and torch.isfinite(t).all()
    cam = seq.camera_small
    kw = dict(keypoint_config=(1, 3), model=cam.distortion_model, max_peaks=16)
    card = decode_objects_batch(*maps, CameraArrays.from_camera(cam, device=cuda), **kw)
    cpu = decode_objects_batch(*(t.cpu() for t in maps), CameraArrays.from_camera(cam), **kw)
    for name in DecodedObjects._fields:
        got, want = getattr(card, name).cpu(), getattr(cpu, name)
        if got.is_floating_point():
            tol = 1e-5 if name.endswith("p3d") else 1e-4
            torch.testing.assert_close(got, want, atol=tol, rtol=0, msg=lambda m: f"{name}: {m}")
        else:
            assert torch.equal(got, want), name


# ------------------------------------------------- training slice and repairs

GPU_TINY = dict(heatmaps_out=3, features=8, dropout=0.0, stacks=2, levels=2, dims=(8, 8, 16),
                mods=(1, 1, 1), stem_features=(8, 8), cnv_dim=8)


def _tiny_model(seed):
    """A tiny KeypointNet with random BatchNorm statistics (8 stem channels,
    so the bf16 kernel takes it too)."""
    g = torch.Generator().manual_seed(seed)
    model = KeypointNet(**GPU_TINY, generator=g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    return model


def test_infer_pins_tf32_off_whatever_the_process_flags(cuda, monkeypatch):
    """With the process's flags at torch's defaults (TF32 on for cuDNN),
    make_inference_fn's float32 forward equals a TF32-off forward of the same
    model, and the flags are the process's again after the call."""
    from object_keypoints_tpu_torch.models.keypoint_net import outputs_to_reference
    from object_keypoints_tpu_torch.precision import no_tf32
    from object_keypoints_tpu_torch.serving.export import make_inference_fn

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    model = _tiny_model(5)
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(6)).to(cuda)
    infer = make_inference_fn(model, device=cuda)
    got = infer(x)
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    with torch.no_grad(), no_tf32():
        want = outputs_to_reference(model(x), stack=-1)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


def _worst_rel(got, want):
    """The largest |got - want| of any tensor pair, as a share of the
    largest |want| of its tensor."""
    return max(((g.double() - w.double()).abs().max() / w.double().abs().max().clamp(min=1e-30)).item()
               for g, w in zip(got, want))


def test_train_and_eval_steps_pin_tf32_off_whatever_the_process_flags(cuda, monkeypatch):
    """With TF32 on in the process for cuDNN and cuBLAS, one train step's
    loss and gradients (loss_and_grads, then apply_gradients, as train_step
    runs them) and eval_step's metrics equal the same calls made under
    no_tf32(), each tensor within 1e-5 of its largest element, and the
    process's flags are its own again after them. The control shows that the
    gate sees TF32: the same calls with the pin taken away miss by more than
    1e-4 in some tensor. cuDNN is made deterministic so that the three runs
    choose and order their work alike; a model of 16-64 channels, so that
    cuDNN takes its tensor-core kernels where TF32 is let in."""
    from object_keypoints_tpu_torch.precision import no_tf32
    from object_keypoints_tpu_torch.testing import synthetic_batch
    from object_keypoints_tpu_torch.training import trainer

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    wide = {**GPU_TINY, "features": 32, "dims": (32, 32, 64), "stem_features": (16, 32),
            "cnv_dim": 32}
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in synthetic_batch(13, size=128).items()}

    def step():
        model = KeypointNet(**wide, generator=torch.Generator().manual_seed(14))
        state = trainer.create_train_state(model, trainer.make_optimizer(lr=1e-3), device=cuda)
        metrics = trainer.eval_step(state, batch)
        loss, _, grads = trainer.loss_and_grads(state, batch)
        trainer.apply_gradients(state, grads, loss)
        return [loss, *metrics.values(), *grads]

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    got = step()
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    with no_tf32():
        want = step()
    monkeypatch.setattr(trainer, "no_tf32", contextlib.nullcontext)
    control = step()
    assert _worst_rel(got, want) <= 1e-5, _worst_rel(got, want)
    assert _worst_rel(control, want) > 1e-4, _worst_rel(control, want)


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "device_prefetch" and t.is_alive()]


def _host_batches(seed, n):
    rng = numpy.random.default_rng(seed)
    return [{"frame": rng.integers(0, 256, size=(8, 256, 256, 3), dtype=numpy.uint8),
             "heatmaps": rng.normal(size=(8, 256, 256, 3)).astype(numpy.float32)}
            for _ in range(n)]


def test_device_prefetch_copies_batches_to_the_card(cuda):
    """Seeded host batches through device_prefetch arrive on the card equal
    to a direct copy; a sum taken on the consumer's stream as soon as a
    batch is handed over sees the whole copy (the stream waits on the
    copy's event); the worker thread is gone at the end."""
    from object_keypoints_tpu_torch.data.prefetch import device_prefetch

    data = _host_batches(15, 6)
    out = device_prefetch(iter(data), device=cuda, buffer_size=2)
    for got, want in zip(out, data, strict=True):
        sums = {k: v.double().sum() for k, v in got.items()}  # enqueued before any sync
        for k, v in want.items():
            assert got[k].device.type == "cuda" and got[k].dtype == torch.from_numpy(v).dtype
            assert torch.equal(got[k].cpu(), torch.from_numpy(v)), k
            assert sums[k].item() == pytest.approx(float(v.astype(numpy.float64).sum()), rel=1e-9)
    assert not _prefetch_threads()


def test_device_prefetch_on_the_card_raises_the_loaders_error(cuda):
    """A loader that fails after two batches: both arrive, then its error
    is raised on the consumer's side and the worker thread is gone."""
    from object_keypoints_tpu_torch.data.prefetch import device_prefetch

    data = _host_batches(16, 2)

    def loader():
        yield from data
        raise ValueError("loader broke")

    out = device_prefetch(loader(), device=cuda)
    for want in data:
        assert torch.equal(next(out)["frame"].cpu(), torch.from_numpy(want["frame"]))
    with pytest.raises(ValueError, match="loader broke"):
        next(out)
    assert not _prefetch_threads()


def test_device_prefetch_on_the_card_stops_when_the_consumer_does(cuda):
    """A consumer that takes one batch of 50 and closes the iterator: the
    worker stops drawing from the loader and its thread is gone when close()
    returns."""
    from object_keypoints_tpu_torch.data.prefetch import device_prefetch

    drawn = []
    data = _host_batches(17, 1)

    def loader():
        for i in range(50):
            drawn.append(i)
            yield data[0]

    out = device_prefetch(loader(), device=cuda, buffer_size=2)
    assert torch.equal(next(out)["frame"].cpu(), torch.from_numpy(data[0]["frame"]))
    out.close()
    assert not _prefetch_threads()
    assert len(drawn) <= 1 + 2 + 2, len(drawn)  # the one taken, the buffer, one in hand, one put


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_kernel_gradients_equal_the_plain_ones(cuda, dtype):
    """The eval-mode stem on the card is differentiable: the gradients of
    sum(out * r) for frames, w, scale and bias through the kernel's autograd
    op equal those through stem_conv_plain (fp32 rel 1e-4; bf16 one output
    ulp, rtol = atol = 1e-2), and its forward still launches the kernel."""
    g, w, scale, bias = _stem_args(64, 11, cuda)
    x = torch.randn(2, 3, 63, 63, generator=g).to(cuda, dtype)
    r = torch.randn(2, 64, 32, 32, generator=g).to(cuda)
    grads = []
    for fn in (stem_conv, stem_conv_plain):
        leaves = [t.clone().requires_grad_() for t in (x, w, scale, bias)]
        out, launched = _stem_launches(lambda: fn(*leaves))
        assert out.grad_fn is not None
        assert launched == (fn is stem_conv)
        grads.append(torch.autograd.grad((out.float() * r).sum(), leaves))
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    for name, got, want in zip(("frames", "w", "scale", "bias"), *grads):
        scale_ = want.float().abs().max().item()
        torch.testing.assert_close(got.float() / scale_, want.float() / scale_, **tol,
                                   msg=lambda m: f"{name}: {m}")


def test_eval_mode_forward_gives_the_stem_and_its_bn_gradients(cuda):
    """Fine-tuning with BatchNorm frozen: an eval-mode forward on the card
    runs the stem kernel and gives the stem's conv and BN weight and bias
    gradients equal to those of the same forward with the plain stem."""
    model = _tiny_model(7).to(cuda).eval()
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(8)).to(cuda)
    stem = model.backbone.pre[0]
    grads = []
    for kw in ({}, {"stem": stem_conv_plain}):
        out = model(x, **kw)
        loss = sum(t.square().sum() for t in (*out.heatmaps, *out.depth))
        grads.append(torch.autograd.grad(loss, [stem.conv.weight, stem.bn.weight, stem.bn.bias]))
    for got, want in zip(*grads):
        assert got.abs().max() > 0
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())


def test_train_step_on_card_matches_cpu(cuda):
    """One float32 step (dropout 0) on the card against the same step on
    the CPU: loss rel 1e-5, gradients within 1e-4 of each tensor's largest,
    the BatchNorm running statistics within 1e-4, the AdamW update where
    |g| > 1e-3 of its tensor's largest within 1e-6. It never waits for the
    card once warm."""
    from object_keypoints_tpu_torch.testing import synthetic_batch
    from object_keypoints_tpu_torch.training import trainer

    batch = synthetic_batch(3, size=64)
    states = [trainer.create_train_state(_tiny_model(9), trainer.make_optimizer(lr=1e-3),
                                         device=d) for d in ("cpu", cuda)]
    results = []
    for state in states:
        loss, metrics, grads = trainer.loss_and_grads(state, batch)
        trainer.apply_gradients(state, grads, loss)
        results.append((loss, [g.cpu() for g in grads]))
    (cpu_loss, cpu_grads), (card_loss, card_grads) = results
    assert card_loss.device.type == "cuda"
    torch.testing.assert_close(card_loss.cpu(), cpu_loss, rtol=1e-5, atol=0)
    for got, want in zip(card_grads, cpu_grads):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * want.abs().max().item())
    for (name, got), want in zip(states[1].model.state_dict().items(),
                                 states[0].model.state_dict().values()):
        if "running" in name:
            torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-6)
    for got, want, g in zip(states[1].params, states[0].params, cpu_grads):
        big = g.abs() > 1e-3 * g.abs().max()
        torch.testing.assert_close(got.detach().cpu()[big], want.detach()[big], rtol=0, atol=1e-6)

    on_card = {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.train_step(states[1], on_card)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_device_store_step_never_waits_for_the_card(cuda, tmp_path, monkeypatch):
    """train_step_device_data with augmentation on the card: once warm, no
    operation of the step synchronizes with the host; and with augmentation
    off its loss equals the same step's on the CPU (rel 1e-5)."""
    from object_keypoints_tpu_torch.testing import synthetic_datasets
    from object_keypoints_tpu_torch.training import device_data, trainer

    monkeypatch.chdir(ROOT)
    datasets = synthetic_datasets(str(tmp_path), CALIBRATION, (1, 3), n_sequences=1, n_frames=4,
                                  n_objects=2, seed=3)
    tiny = {**GPU_TINY, "stacks": 1}
    losses = []
    for device in ("cpu", cuda):
        store = device_data.build_device_store(datasets, device)
        model = KeypointNet(**tiny, generator=torch.Generator().manual_seed(4))
        state = trainer.create_train_state(model, trainer.make_optimizer(), device=device)
        _, metrics = device_data.train_step_device_data(
            state, store, torch.tensor([0, 2], device=device), None, (1, 1, 3), augment=False)
        losses.append(metrics["loss"].cpu())
    torch.testing.assert_close(losses[1], losses[0], rtol=1e-5, atol=0)

    g = torch.Generator(device=cuda).manual_seed(0)
    indices = torch.tensor([3, 1], device=cuda)
    device_data.train_step_device_data(state, store, indices, g, (1, 1, 3))  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, metrics = device_data.train_step_device_data(state, store, indices, g, (1, 1, 3))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(metrics["loss"]).item()


def test_augment_on_card_matches_cpu_under_the_same_draws(cuda):
    """apply_photometric with the same explicit draws on the card and on the
    CPU: frames within one uint8 level (pow rounds differently at a level's
    edge), keypoints equal."""
    from object_keypoints_tpu_torch.data import augment_device

    rng = numpy.random.default_rng(12)
    frames = torch.from_numpy(rng.integers(0, 256, size=(4, 48, 40, 3), dtype=numpy.uint8))
    kps = torch.from_numpy(rng.uniform(0, 39, size=(4, 6, 2)).astype(numpy.float32))
    draws = augment_device.draw_photometric(4, 48, 40, torch.Generator().manual_seed(1))
    cpu = augment_device.apply_photometric(frames, kps, draws)
    card = augment_device.apply_photometric(frames.to(cuda), kps.to(cuda),
                                            type(draws)(*(t.to(cuda) for t in draws)))
    assert (card[0].cpu() - cpu[0]).abs().max() <= 1.0
    assert torch.equal(card[1].cpu(), cpu[1])


LOOP_TINY = dict(levels=2, dims=(16, 16, 32), mods=(1, 1, 1), stem_features=(8, 16), cnv_dim=16)


def _loop_run(tmp_path, **overrides):
    """A tiny loop run on in-memory sequences (2 train sequences of 4
    frames, 1 val), bf16: (config, train sets, val sets)."""
    from object_keypoints_tpu_torch.cli import flagship
    from object_keypoints_tpu_torch.training import loop

    train_split = flagship.synthetic_split(str(tmp_path / "data"), "train", 2, [1, 3], 4)
    val_split = flagship.synthetic_split(str(tmp_path / "data"), "val", 1, [1, 3], 4)
    config = loop.TrainConfig(keypoint_config=[1, 3], batch_size=2, features=8, dropout=0.0,
                              lr=1e-3, bf16=True, epochs=2, out_dir=str(tmp_path / "run"),
                              model_overrides=LOOP_TINY, **overrides)
    sets = [loop.sequences([d for d, _ in split], config, train, [r for _, r in split])
            for split, train in ((train_split, True), (val_split, False))]
    return config, *sets


def test_loop_on_the_card_checkpoints_and_exports(cuda, tmp_path, monkeypatch):
    """loop.fit on the card (the device store, bf16): best and last written,
    the bf16 stem kernel launched by each epoch's eval_step, and the export
    serves on the card as on the CPU (float32, atol 1e-4)."""
    from object_keypoints_tpu_torch.serving.export import load_inference_fn
    from object_keypoints_tpu_torch.training import checkpoints, loop

    monkeypatch.chdir(ROOT)
    config, train_sets, val_sets = _loop_run(tmp_path)
    result, launched = _stem_launches(lambda: loop.fit(config, train_sets, val_sets, device=cuda))
    assert launched == 2 and config.bf16  # a bf16 eval_step an epoch: the bf16 kernel
    assert result["steps"] == 8 and numpy.isfinite(result["best_val_loss"])
    ckpt = checkpoints.CheckpointManager(config.out_dir)
    assert ckpt.best_val == result["best_val_loss"]
    assert ckpt.restore("last")["step"] == 8
    frames = torch.randn(2, 3, 511, 511, generator=torch.Generator().manual_seed(2))
    card = load_inference_fn(result["export_dir"], device=cuda)(frames.to(cuda))
    cpu = load_inference_fn(result["export_dir"], device="cpu")(frames)
    for got, want in zip(card, cpu):
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


def test_deferred_best_on_the_card_is_a_copy(cuda, tmp_path):
    """The optimizer updates the parameters on the card in place; the
    deferred best keeps the weights of its epoch."""
    from object_keypoints_tpu_torch.testing import synthetic_batch
    from object_keypoints_tpu_torch.training import checkpoints, trainer

    state = trainer.create_train_state(_tiny_model(5), trainer.make_optimizer(lr=1e-3),
                                       device=cuda)
    hparams = {"keypoint_config": [1, 3], "features": GPU_TINY["features"],
               "model_overrides": {k: v for k, v in GPU_TINY.items()
                                   if k in ("stacks", "levels", "dims", "mods",
                                            "stem_features", "cnv_dim")}}
    ckpt = checkpoints.CheckpointManager(str(tmp_path), hparams=hparams)
    before = {k: v.cpu().clone() for k, v in state.model.state_dict().items()}
    assert ckpt.save_if_best(state, 0, 0.5, defer=True)
    trainer.train_step(state, synthetic_batch(1, size=64))
    moved = [k for k, v in state.model.state_dict().items()
             if v.is_floating_point() and not torch.equal(v.cpu(), before[k])]
    assert moved
    ckpt.flush_best()
    best, step = ckpt.restore_state_dict("best")
    assert step == 0
    for k in moved:
        assert torch.equal(best[k], before[k]), k


def test_warm_loop_steps_never_wait_for_the_card(cuda, tmp_path, monkeypatch):
    """From the second step of the loop on to the first validation, the
    loop runs under set_sync_debug_mode("error"): its steps, the order
    slices and its bookkeeping never wait for the card (no log read falls
    in that span: log_every is past the epoch)."""
    from object_keypoints_tpu_torch.training import loop

    monkeypatch.chdir(ROOT)
    config, train_sets, val_sets = _loop_run(tmp_path, log_every=100)
    step, evaluate, calls = loop.train_step_device_data, loop.eval_step, []

    def strict_step(*args, **kwargs):
        if calls:
            torch.cuda.set_sync_debug_mode("error")
        calls.append(1)
        return step(*args, **kwargs)

    def relaxed_eval(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("default")
        return evaluate(*args, **kwargs)

    monkeypatch.setattr(loop, "train_step_device_data", strict_step)
    monkeypatch.setattr(loop, "eval_step", relaxed_eval)
    try:
        result = loop.fit(config, train_sets, val_sets, device=cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(calls) == result["steps"] == 8


# --- int8 serving: ops.int8_conv's GEMM route (torch._int_mm) and serving.quantize ----

INT8_SHAPES = [  # (n, h, w, c_in, c_out, kernel, stride, padding)
    (4, 32, 32, 128, 256, 3, 2, 1),  # pre_res1's conv1
    (4, 16, 16, 256, 256, 3, 1, 1),  # pre_res1's conv2, the 3x3 blocks
    (4, 32, 32, 128, 256, 1, 2, 0),  # pre_res1's skip
    (4, 16, 16, 256, 128, 1, 1, 0),  # a head's conv0
    (4, 16, 16, 32, 3, 1, 1, 0),  # a head's conv_out: N < 8
    (1, 4, 4, 32, 4, 1, 1, 0),  # M = 16 rows, N < 8
    (2, 5, 3, 20, 10, 3, 2, 1),  # K and N off multiples of 8, M <= 16
]


@pytest.mark.parametrize("shape", INT8_SHAPES)
def test_int8_gemm_route_on_card_equals_plain(cuda, shape):
    """The GEMM route on the card gives the plain version's int32 sums
    exactly; its GEMMs open ``int8.mm`` spans, one for the conv (its frames
    fit one chunk of columns) and one for each of the ConvTranspose's four
    output phases."""
    from object_keypoints_tpu_torch.ops import int8_conv

    n, h, w, c, o, k, s, p = shape
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    xq = torch.randint(-127, 128, (n, h, w, c), generator=g, dtype=torch.int8, device=cuda)
    wq = torch.randint(-127, 128, (o, c, k, k), generator=g, dtype=torch.int8, device=cuda)
    got, _, spans = traced(
        lambda: int8_conv.int8_conv2d(xq, int8_conv.pack_conv2d_weight(wq), o, k, s, p))
    assert spans["int8.mm"] == 1 and got.device.type == "cuda"
    assert torch.equal(got, int8_conv.int8_conv2d_plain(xq, wq, s, p))
    wt = torch.randint(-127, 128, (c, o, 4, 4), generator=g, dtype=torch.int8, device=cuda)
    got, _, spans = traced(
        lambda: int8_conv.int8_conv_transpose2d(xq, int8_conv.pack_conv_transpose2d_weight(wt), o))
    assert spans["int8.mm"] == 4
    assert torch.equal(got, int8_conv.int8_conv_transpose2d_plain(xq, wt))


INT8_TINY = dict(heatmaps_out=3, features=32, dims=(32, 32, 48), mods=(1, 1, 1), levels=2,
                 stem_features=(16, 32), cnv_dim=32, stacks=2, dropout=0.0)


def _int8_artifact(path, skip_env=None):
    """A small model's artifact with quant.json, calibrated on the CPU."""
    from object_keypoints_tpu_torch.serving.export import export_model
    from object_keypoints_tpu_torch.serving.quantize import calibrate_activation_scales

    model = KeypointNet(**INT8_TINY, generator=torch.Generator().manual_seed(7)).eval()
    frames = torch.randn(2, 3, 127, 127, generator=torch.Generator().manual_seed(8))
    scales = calibrate_activation_scales(model, model, [frames])
    config = {**{k: list(v) if isinstance(v, tuple) else v for k, v in INT8_TINY.items()},
              "keypoint_config": [1, 3]}
    export_model(str(path), config, model, quant_scales=scales)
    return frames


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_artifact_on_card_matches_cpu(cuda, tmp_path, monkeypatch, dtype):
    """load_inference_fn("auto") serves an artifact with quant.json int8 on
    the card, every eligible conv on the GEMM route (OKT_INT8_SKIP=""),
    within tests/test_quantize.py's budgets of the CPU's int8 forward
    (sigmoid heatmaps 0.02, depth 5 mm, centers 0.25 px). Each of the
    served model's Int8Conv modules quantizes its input once on the kernel
    and multiplies on the GEMM route (``int8.mm`` spans): a conv in one
    GEMM at this size, a ConvTranspose in four, one for each output
    phase."""
    from object_keypoints_tpu_torch.serving.export import load_inference_fn, load_served_model
    from object_keypoints_tpu_torch.serving.quantize import Int8Conv, quantize_model

    monkeypatch.setenv("OKT_INT8_SKIP", "")
    frames = _int8_artifact(tmp_path)
    served, scales = load_served_model(str(tmp_path))
    quantize_model(served, scales)
    transposes = [m.transpose for m in served.modules() if isinstance(m, Int8Conv)]
    n_transpose = sum(transposes)
    assert n_transpose > 0
    dt = getattr(torch, dtype)
    infer = load_inference_fn(str(tmp_path), dtype=dt, device=cuda)
    card, counts, spans = traced(lambda: infer(frames.to(cuda)))
    assert counts.get("int8.quantize.kernel") == len(transposes)
    assert spans["int8.mm"] == len(transposes) - n_transpose + 4 * n_transpose
    cpu = load_inference_fn(str(tmp_path), dtype=dt, device="cpu")(frames)
    for got, want, limit in zip(card, cpu, (0.02, 0.005, 0.25)):
        assert got.device.type == "cuda" and torch.isfinite(got).all()
        assert (got.cpu() - want).abs().max().item() < limit


def test_warm_int8_forward_never_waits_for_the_card(cuda, tmp_path, monkeypatch):
    from object_keypoints_tpu_torch.serving.export import load_inference_fn

    monkeypatch.setenv("OKT_INT8_SKIP", "")
    frames = _int8_artifact(tmp_path).to(cuda).to(torch.bfloat16)
    infer = load_inference_fn(str(tmp_path), dtype=torch.bfloat16, device=cuda)
    infer(frames)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        infer(frames)
    finally:
        torch.cuda.set_sync_debug_mode("default")


# --- the CornerNet detector -------------------------------------------------

STEM_FRAMES = [
    (1, 3, 511, 767), (2, 3, 255, 383),  # a 480x640 image padded to size | 127 at scale 1, 0.5
    (16, 3, 511, 511), (8, 3, 511, 511),  # the eval's batch, eval_step's
    (96, 3, 511, 511),  # the serve step's 48 pairs
    (2, 3, 511, 767), (2, 3, 383, 511),  # the detectors' flipped scales
    (2, 3, 639, 895), (2, 3, 767, 1023),
    (2, 3, 255, 255), (32, 3, 255, 255),  # the saccade's views and its bucket of crops
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", STEM_FRAMES)
def test_stem_kernel_at_the_detectors_frames(cuda, shape, dtype):
    """The frames the main paths give the stem, the detectors' non-square
    ones first, with 128 output channels as every model here has, through
    the kernel of their dtype: fp32 within atol 1e-4, bf16 within one
    output ulp of the plain version."""
    g, w, scale, bias = _stem_args(128, shape[2] + shape[3], cuda)
    x = torch.randn(*shape, generator=g).to(cuda, dtype)
    if dtype == torch.bfloat16:
        _check_bf16_kernel(x, w, scale, bias)
        return
    out, launched = _stem_launches(lambda: stem_conv(x, w, scale, bias))
    assert launched == 1 and out.shape == (shape[0], 128, (shape[2] + 1) // 2, (shape[3] + 1) // 2)
    assert out.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(out, stem_conv_plain(x, w, scale, bias), atol=1e-4, rtol=0)


def test_corner_pools_on_card_keep_bf16_channels_last(cuda):
    from object_keypoints_tpu_torch.ops import corner_pool

    x = torch.randn(2, 8, 33, 47, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    xc = x.to(cuda, memory_format=torch.channels_last)
    for name in ("top_pool", "bottom_pool", "left_pool", "right_pool"):
        out = getattr(corner_pool, name)(xc)
        assert out.dtype == torch.bfloat16
        assert torch.equal(out.cpu(), getattr(corner_pool, name)(x)), name


def _nms_stack(seed, width, counts=(5, 40, 0, 90, 1)):
    from object_keypoints_tpu_torch.ops import nms

    rng = numpy.random.default_rng(seed)
    per_class = []
    for n in counts:
        xy = rng.uniform(0, 200, (n, 2))
        cols = [xy, xy + rng.uniform(4, 60, (n, 2)), rng.uniform(0.01, 1, (n, 3))]
        per_class.append(numpy.concatenate(cols, axis=1).astype(numpy.float32)[:, :width])
    return torch.from_numpy(nms.pad_class_dets(per_class, 128, width=width)), max(counts)


@pytest.mark.parametrize("merge", [False, True])
@pytest.mark.parametrize("method", [0, 1, 2])
def test_soft_nms_on_card_matches_cpu(cuda, method, merge):
    """The batched greedy loop on the card against the CPU on the same
    padded stack, stopped after the largest class: scores within 1e-5,
    boxes (merged ones move) within 1e-3 px."""
    from object_keypoints_tpu_torch.ops import nms

    stack, steps = _nms_stack(method, 7 if merge else 5)

    def run(d):
        if merge:
            return nms.soft_nms_merge_batch(d, method=method, weight_exp=10, steps=steps)
        return nms.soft_nms_batch(d, method=method, steps=steps)

    card, cpu = run(stack.to(cuda)), run(stack)
    assert card.device.type == "cuda" and torch.isfinite(card).all()
    torch.testing.assert_close(card[..., 4].cpu(), cpu[..., 4], atol=1e-5, rtol=0)
    torch.testing.assert_close(card.cpu(), cpu, atol=1e-3, rtol=0)


def test_corner_decode_on_card_matches_cpu(cuda):
    from object_keypoints_tpu_torch.ops.detection_decode import decode_detections

    g = torch.Generator().manual_seed(0)
    heads = [torch.randn(2, 80, 128, 192, generator=g) * 2,
             torch.randn(2, 80, 128, 192, generator=g) * 2,
             torch.randn(2, 1, 128, 192, generator=g) * 0.3,
             torch.randn(2, 1, 128, 192, generator=g) * 0.3,
             torch.rand(2, 2, 128, 192, generator=g), torch.rand(2, 2, 128, 192, generator=g)]
    kw = dict(K=100, kernel=3, ae_threshold=0.5, num_dets=1000)
    card = decode_detections(*(h.to(cuda) for h in heads), **kw)
    cpu = decode_detections(*heads, **kw)
    assert card.device.type == "cuda" and (cpu[..., 4] > -1).sum() > 20
    assert torch.equal(card[..., 7].cpu(), cpu[..., 7])
    torch.testing.assert_close(card.cpu(), cpu, atol=1e-5, rtol=0)


def _tiny_detector(device, seed=2, categories=4):
    """A tiny CornerNet-Squeeze Detector in float32 whose heat heads share
    one kernel across classes (x -30), so that its random weights pair
    corners of one class: tests/test_torch_port_detector.py's recipe."""
    from object_keypoints_tpu_torch.inference.detector import Detector
    from object_keypoints_tpu_torch.models.cornernet import tiny_cornernet
    from object_keypoints_tpu_torch.testing import plant_detector_heads, randomize_batchnorm
    from object_keypoints_tpu_torch.utils.config import DetectionConfig, tiny_db_overrides

    model = tiny_cornernet("CornerNet_Squeeze", categories,
                           generator=torch.Generator().manual_seed(seed))
    randomize_batchnorm(model, torch.Generator().manual_seed(seed))
    plant_detector_heads(model, -30.0)
    db = {**tiny_db_overrides("CornerNet"), "categories": categories, "top_k": 12,
          "num_dets": 40, "max_per_image": 100, "ae_threshold": 100.0,
          "test_scales": [0.75, 1], "merge_bbox": True}
    return Detector(model, DetectionConfig(db), device=device, dtype=torch.float32)


def test_tiny_detector_on_card_matches_cpu(cuda):
    image = numpy.random.default_rng(0).integers(0, 256, (96, 120, 3), dtype=numpy.uint8)
    card, cpu = _tiny_detector(cuda)(image), _tiny_detector("cpu")(image)
    assert sum(len(v) for v in cpu.values()) > 0
    for key, want in cpu.items():
        got = card[key]
        assert got.shape == want.shape, key
        numpy.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0, atol=1e-3)
        numpy.testing.assert_allclose(got[:, 4], want[:, 4], rtol=0, atol=1e-5)


# --- CornerNet-Saccade and the detector eval --------------------------------

def test_crop_zoom_batch_on_card_matches_cpu(cuda):
    """The saccade's batched crop-zoom at its full-width shapes (a 480x640
    frame into 32 canvases of 255x255: windows inside, past every border,
    one pixel high, and the driver's pad rows) on the card against the CPU,
    within 1e-5: the same float32 ops, one rounding each."""
    from object_keypoints_tpu_torch.inference.saccade import crop_zoom_batch

    rng = numpy.random.default_rng(0)
    image = torch.from_numpy(rng.uniform(-2.2, 2.7, (480, 640, 3)).astype(numpy.float32))
    centers = rng.uniform(-20, [500, 660], (32, 2)).astype(numpy.float32)
    sizes = numpy.floor(255 / rng.uniform(0.2, 4.0, (32, 1))).repeat(2, 1).astype(numpy.float32)
    centers[:4], sizes[:4] = [[0, 300], [479, 10], [240, 0], [1, 1]], [[1, 40], [1, 1], [64, 1],
                                                                     [255, 255]]
    sizes[4] = [2000, 2000]  # past every border
    args = [torch.from_numpy(a) for a in (centers, sizes)]
    card = crop_zoom_batch(image.to(cuda), *(a.to(cuda) for a in args), (255, 255))
    cpu = crop_zoom_batch(image, *args, (255, 255))
    torch.cuda.synchronize()
    assert card[0].shape == (32, 255, 255, 3) and card[0].device.type == cuda.type
    torch.testing.assert_close(card[0].cpu(), cpu[0], atol=1e-5, rtol=0)
    assert torch.equal(card[1].cpu(), cpu[1])


def _tiny_saccade(device, seed=0, categories=4):
    """A tiny CornerNet-Saccade SaccadeDetector in float32, BatchNorm at
    random, heat heads shared across classes (x -3) and attention kernels
    x 4, so that stage 2 runs a bucket of crops and corners pair."""
    from object_keypoints_tpu_torch.inference.saccade import SaccadeDetector
    from object_keypoints_tpu_torch.models.cornernet import tiny_cornernet
    from object_keypoints_tpu_torch.testing import plant_detector_heads, randomize_batchnorm
    from object_keypoints_tpu_torch.utils.config import (
        CONFIG_DIR,
        DetectionConfig,
        load_cfg,
        tiny_db_overrides,
    )

    model = tiny_cornernet("CornerNet_Saccade", categories,
                           generator=torch.Generator().manual_seed(seed))
    randomize_batchnorm(model, torch.Generator().manual_seed(seed))
    plant_detector_heads(model, -3.0, att_gain=4.0)
    db = {**load_cfg(CONFIG_DIR / "CornerNet_Saccade.json")[1],
          **tiny_db_overrides("CornerNet_Saccade"), "categories": categories,
          "ae_threshold": 100.0, "top_k": 12, "num_dets": 40, "max_per_image": 100,
          "att_max_crops": 12}
    return SaccadeDetector(model, DetectionConfig(db), device=device, dtype=torch.float32)


def test_tiny_saccade_on_card_matches_cpu(cuda):
    """The two-stage drive on the card against the CPU on the same image:
    the same stages and crops, equal counts per class, boxes within 1e-3 px
    and scores within 1e-5."""
    image = numpy.random.default_rng(0).integers(0, 256, (96, 128, 3), dtype=numpy.uint8)
    card_stats, cpu_stats = [], []
    card = _tiny_saccade(cuda)(image, stats=card_stats)
    cpu = _tiny_saccade("cpu")(image, stats=cpu_stats)
    assert [s.get("crops") for s in card_stats] == [s.get("crops") for s in cpu_stats]
    assert cpu_stats[1]["crops"] > 1 and sum(len(v) for v in cpu.values()) > 10
    for key, want in cpu.items():
        got = card[key]
        assert got.shape == want.shape, key
        numpy.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0, atol=1e-3)
        numpy.testing.assert_allclose(got[:, 4], want[:, 4], rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", ["CornerNet_Squeeze", "CornerNet_Saccade"])
def test_tiny_eval_cli_on_card_matches_cpu(cuda, tmp_path, arch, capsys):
    """cli.evaluate_detector --tiny over four synthetic 192x256 COCO images,
    on the card and with --cpu, from one planted .pth snapshot: the 12
    stats within 1e-3; results.json rows as sets: equal counts per image
    and class, boxes within 1e-3 px and scores within 1e-5."""
    from object_keypoints_tpu_torch.cli import evaluate_detector
    from object_keypoints_tpu_torch.data.synthetic import make_synthetic_coco_dataset
    from object_keypoints_tpu_torch.models.cornernet import tiny_cornernet
    from object_keypoints_tpu_torch.testing import (
        coco_rows,
        compare_coco_rows,
        plant_detector_heads,
        randomize_batchnorm,
    )

    ann, images = make_synthetic_coco_dataset(str(tmp_path / "data"), n_images=4,
                                              image_size=(192, 256), seed=0)
    model = tiny_cornernet(arch, 80, generator=torch.Generator().manual_seed(1))
    randomize_batchnorm(model, torch.Generator().manual_seed(1))
    saccade = arch == "CornerNet_Saccade"
    plant_detector_heads(model, -3.0 if saccade else 3.0, att_gain=4.0 if saccade else None)
    torch.save(model.state_dict(), tmp_path / f"{arch}_1.pth")
    argv = [arch, "--annotations", ann, "--image-dir", images, "--tiny",
            "--snapshot-dir", str(tmp_path), "--testiter", "1"]
    card = evaluate_detector.main([*argv, "--result-dir", str(tmp_path / "card")])
    cpu = evaluate_detector.main([*argv, "--cpu", "--result-dir", str(tmp_path / "cpu")])
    capsys.readouterr()
    numpy.testing.assert_allclose(card["stats"], cpu["stats"], rtol=0, atol=1e-3)
    want = coco_rows(tmp_path / "cpu" / "1" / "validation" / "results.json")
    assert len(want) > 0
    compare_coco_rows(f"{arch} --tiny eval: card vs CPU",
                      coco_rows(tmp_path / "card" / "1" / "validation" / "results.json"), want)


# --- CornerNet detector training: the pools' backward, the step, the CLIs ----


def _tie_map(seed, shape=(2, 8, 33, 46)):
    rng = numpy.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, 4, size=shape).astype(numpy.float32))
    ct = torch.from_numpy(rng.integers(-3, 4, size=shape).astype(numpy.float32))
    return x.bfloat16(), ct.bfloat16()


@pytest.mark.parametrize("name", ["top_pool", "bottom_pool", "left_pool", "right_pool"])
def test_corner_pool_bf16_gradient_on_card_equals_cpu(cuda, name):
    """bf16 channels_last maps full of ties: the card's backward (JAX's
    associative-scan gradient over torch.maximum) equals the CPU's exactly;
    the integer cotangents make every sum exact."""
    from object_keypoints_tpu_torch.ops import corner_pool

    x, ct = _tie_map(3)
    grads = []
    for device, layout in ((cuda, torch.channels_last), ("cpu", torch.contiguous_format)):
        xd = x.to(device, memory_format=layout).requires_grad_()
        (getattr(corner_pool, name)(xd) * ct.to(device)).sum().backward()
        assert xd.grad.dtype == torch.bfloat16
        grads.append(xd.grad.cpu())
    assert torch.equal(grads[0], grads[1]), name


def _tiny_detection_batch(seed, n=4):
    from object_keypoints_tpu_torch.data.detection_targets import render_corner_targets

    rng = numpy.random.default_rng(seed)
    ts = []
    for _ in range(n):
        x0, y0 = rng.uniform(0, 40, 2)
        w, h = rng.uniform(8, 20, 2)
        dets = numpy.array([[x0, y0, x0 + w, y0 + h, 1 + rng.integers(3)]], numpy.float32)
        ts.append(render_corner_targets(dets, 80, (64, 64), (16, 16), gaussian_iou=0.3))
    batch = {k: numpy.stack([t[k] for t in ts]) for k in ts[0]}
    batch["images"] = rng.normal(size=(n, 64, 64, 3)).astype(numpy.float32)
    return batch


def test_tiny_detection_train_step_on_card_matches_cpu(cuda):
    """One float32 step (TF32 off) of the --tiny CornerNet-Squeeze from the
    same weights and batch: the loss within rel 1e-5, the parameters where
    the CPU's |g| is above a fifth of its tensor's largest within 1e-6
    (Adam's first step is lr * sign(g) there), the running statistics within
    rel 1e-3."""
    import copy

    from object_keypoints_tpu_torch.models.cornernet import tiny_cornernet
    from object_keypoints_tpu_torch.training import detection
    from object_keypoints_tpu_torch.utils.config import SystemConfig

    batch = _tiny_detection_batch(0)
    init = tiny_cornernet("CornerNet_Squeeze", 80, generator=torch.Generator().manual_seed(0))
    runs = []
    for device in (cuda, "cpu"):
        tx = detection.make_detection_optimizer(SystemConfig(learning_rate=1e-2))
        state = detection.create_train_state(copy.deepcopy(init), tx, device=device)
        _, grads = detection.loss_and_grads(copy.deepcopy(state), batch)
        state, metrics = detection.detection_train_step(state, batch)
        runs.append((metrics["loss"].item(),
                     {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
                     {k: g.cpu() for (k, _), g in zip(state.model.named_parameters(), grads)}))
    (card_loss, card_sd, _), (cpu_loss, cpu_sd, cpu_grads) = runs
    numpy.testing.assert_allclose(card_loss, cpu_loss, rtol=1e-5)
    for key, want in cpu_sd.items():
        if "running" in key:
            torch.testing.assert_close(card_sd[key], want, rtol=1e-3, atol=1e-6,
                                       msg=lambda m: f"{key}: {m}")
        elif key in cpu_grads:
            g = cpu_grads[key]
            big = g.abs() > 0.2 * g.abs().max()
            torch.testing.assert_close(card_sd[key][big], want[big], rtol=0, atol=1e-6,
                                       msg=lambda m: f"{key}: {m}")


def test_warm_detection_step_never_waits_for_the_card(cuda):
    from object_keypoints_tpu_torch.data.prefetch import device_prefetch
    from object_keypoints_tpu_torch.models.cornernet import tiny_cornernet
    from object_keypoints_tpu_torch.training import detection
    from object_keypoints_tpu_torch.utils.config import SystemConfig

    state = detection.create_train_state(
        tiny_cornernet("CornerNet_Squeeze", 80, generator=torch.Generator().manual_seed(0)),
        detection.make_detection_optimizer(SystemConfig()), torch.bfloat16, device=cuda)
    batches = device_prefetch(iter([_tiny_detection_batch(s) for s in range(3)]), cuda)
    state, metrics = detection.detection_train_step(state, next(batches))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for batch in batches:
            state, metrics = detection.detection_train_step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(metrics["loss"]).item()


@pytest.mark.parametrize("arch", ["CornerNet_Squeeze", "CornerNet_Saccade"])
def test_train_detector_cli_on_card_writes_what_the_eval_cli_reads(cuda, tmp_path, arch, capsys):
    """cli.train_detector --tiny on the card for 6 iterations writes
    <cfg>_6.pth, and cli.evaluate_detector --tiny --testiter 6 reads it on
    the card."""
    from object_keypoints_tpu_torch.cli import evaluate_detector, train_detector
    from object_keypoints_tpu_torch.data.synthetic import make_synthetic_coco_dataset

    ann, images = make_synthetic_coco_dataset(str(tmp_path / "data"), n_images=8,
                                              image_size=(64, 64), seed=0)
    snaps = tmp_path / "nnet"
    state = train_detector.main([arch, "--annotations", ann, "--images", images, "--tiny",
                                 "--max-iter", "6", "--batch-size", "4", "--snapshot-every", "3",
                                 "--snapshot-dir", str(snaps)])
    assert state.device.type == "cuda" and state.step == 6
    assert sorted(p.name for p in snaps.iterdir()) == [f"{arch}_3.pth", f"{arch}_6.pth"]
    out = evaluate_detector.main([arch, "--annotations", ann, "--image-dir", images, "--tiny",
                                  "--testiter", "6", "--snapshot-dir", str(snaps),
                                  "--result-dir", str(tmp_path / "results")])
    assert "loading parameters at iteration: 6" in capsys.readouterr().out
    assert 0.0 <= out["mAP"] <= 1.0


def _wide_conv(kind):
    from object_keypoints_tpu_torch.models import blocks

    torch.manual_seed(0)
    return {"conv3x3": (blocks.Conv2d(64, 256, 3, padding=1, bias=False), 64),
            "depthwise": (blocks.Conv2d(256, 256, 3, padding=1, groups=256, bias=False), 256),
            "conv_transpose": (blocks.ConvTranspose2d(256, 256, 4, stride=2, padding=1), 256)}[kind]


@pytest.mark.parametrize("kind", ["conv3x3", "depthwise", "conv_transpose"])
def test_sharded_conv_on_card_matches_cpu(cuda, kind):
    """A wide conv split over two shards on the card (the model axis in one
    process) against the whole conv on the CPU, float32 with TF32 off:
    output, input gradient and each shard's weight gradient within 1e-4."""
    from object_keypoints_tpu_torch.parallel.tensor import sharded_dim
    from object_keypoints_tpu_torch.serving.sharded import DeviceShardedConv

    conv, cin = _wide_conv(kind)
    split = DeviceShardedConv(conv, [cuda, cuda])
    x = torch.randn(2, cin, 16, 16, requires_grad=True)
    y = conv(x)
    g = torch.randn_like(y)
    gx, gw = torch.autograd.grad(y, (x, conv.weight), g)
    xc = x.detach().to(cuda).contiguous(memory_format=torch.channels_last).requires_grad_()
    yc = split(xc)
    assert yc.device.type == "cuda" and yc.is_contiguous(memory_format=torch.channels_last)
    gxc, *gws = torch.autograd.grad(yc, [xc] + [s.weight for s in split.shards], g.to(cuda))
    torch.testing.assert_close(yc.cpu(), y, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(gxc.cpu(), gx, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(torch.cat(gws, sharded_dim(conv)).cpu(), gw, atol=1e-4, rtol=1e-4)


def test_model_axis_serve_on_card_matches_single(cuda):
    """make_sharded_inference_fn over ["cuda:0"] * 2 at model_parallel=2 (one
    replica, its 28 wide convs split in two) against make_inference_fn on
    the card, float32 with TF32 off: every map within 1e-4, one fp32 stem
    launch a call."""
    from object_keypoints_tpu_torch.serving.export import make_inference_fn
    from object_keypoints_tpu_torch.serving.sharded import make_sharded_inference_fn

    model = KeypointNet(heatmaps_out=3, features=8, stacks=2, levels=2, dims=(256, 256, 512),
                        mods=(1, 1, 1), stem_features=(8, 256), cnv_dim=256,
                        generator=torch.Generator().manual_seed(0))
    frames = torch.randn(4, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    single = make_inference_fn(copy.deepcopy(model), device=cuda)
    split = make_sharded_inference_fn(model, devices=["cuda:0"] * 2, model_parallel=2)
    want = single(frames)
    got, launched = _stem_launches(lambda: split(frames))
    assert launched == 1 and frames.dtype == torch.float32  # the fp32 kernel
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == torch.float32
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
