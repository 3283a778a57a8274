"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card: a CUDA
kernel has no CPU mode. The file imports neither jax nor the JAX package,
so it also runs where jax is not installed:

    python -m pytest --noconftest tests/test_torch_port_gpu.py -q

fp32 comparisons run with TF32 off (cuDNN and matmul) and atol 1e-4, the
tolerance of the CPU parity tests; they go to the CUDA-core kernel. bf16
comparisons go to the tensor-core kernel and allow one output ulp, stated as
rtol = atol = 1e-2. The stereo decode on the card is held to the
CPU decode and to the float64 lift of its own pixels as
``object_keypoints_tpu_torch.testing.compare_stereo`` states: masks equal,
2D within 1e-3 px, 3D within 1e-4 m x max(1, (|p| / 1 m)^3).
"""

import pathlib

import numpy
import pytest

torch = pytest.importorskip("torch")

from object_keypoints_tpu_torch.models.keypoint_net import KeypointNet  # noqa: E402
from object_keypoints_tpu_torch.ops.stem_conv import stem_conv, stem_conv_plain  # noqa: E402

pytestmark = pytest.mark.gpu
ROOT = pathlib.Path(__file__).resolve().parents[1]
CALIBRATION = "config/calibration.yaml"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


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
    before = stem_conv.launches, stem_conv.launches_fp32, stem_conv.launches_bf16
    out = stem_conv(x, w, scale, bias)
    torch.cuda.synchronize()
    assert (stem_conv.launches, stem_conv.launches_fp32, stem_conv.launches_bf16) == (
        before[0] + 1, before[1] + 1, before[2])
    assert out.shape == (3, c_out, (size + 1) // 2, (size + 1) // 2)
    assert out.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(out, stem_conv_plain(x, w, scale, bias), atol=1e-4, rtol=0)


def _check_bf16_kernel(x, w, scale, bias):
    """One launch of the tensor-core kernel, within one output ulp of the
    plain version (which rounds the taps to bf16 as the kernel does)."""
    before = stem_conv.launches, stem_conv.launches_fp32, stem_conv.launches_bf16
    out = stem_conv(x, w, scale, bias)
    torch.cuda.synchronize()
    assert (stem_conv.launches, stem_conv.launches_fp32, stem_conv.launches_bf16) == (
        before[0] + 1, before[1], before[2] + 1)
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
    before = stem_conv.launches
    with pytest.raises(ValueError, match="C % 8"):
        stem_conv(frame, w, scale, bias)
    assert stem_conv.launches == before
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
    before = stem_conv.launches
    with torch.inference_mode():
        out = model(x)
        ref = model(x, stem=stem_conv_plain)
    assert stem_conv.launches == before + 1
    for got, want in zip((*out.heatmaps, *out.depth, *out.centers),
                         (*ref.heatmaps, *ref.depth, *ref.centers)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


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
