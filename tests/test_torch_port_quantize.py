"""Port parity for int8 serving: ``serving.quantize``, ``ops.int8_conv``,
quant.json artifacts and the package CLI's ``--quantize``, against the JAX
package's ``serving/quantize.py`` on the CPU.

The model is tests/test_quantize.py's small KeypointNet (heatmaps_out 3,
features 32, dims (32, 32, 48, 48, 64), 127x127 frames) with stem widths
(16, 32) and cnv_dim 32 in place of (128, 256) and 256: the port checks that
the hourglass input width equals the stem's and cnv_dim, which the JAX
package leaves unchecked. The JAX weights go to the port through
``serving.weights``.

Tolerances, with what they were set from:
- calibration: the key set equal; per-tensor scales (max-abs, percentile
  99.5) within 1e-5 relative (seen 1.4e-6 and 6.0e-6); per-channel scales
  within 1e-5 of their conv's largest scale (seen 1.6e-6 and 5.1e-6: a
  channel whose max is near 0 carries the forwards' float32 differences
  at a larger relative size);
- per conv, on the same input and weights: the int8 codes equal, the output
  within 1e-6 relative; the GEMM route equal to the plain version;
- the whole model against JAX's ``quantized_apply``, same weights and scales:
  tests/test_quantize.py's budgets, sigmoid heatmaps 0.02, depth 5 mm,
  centers 0.25 px (seen, worst stack: float32 4.1e-5 / 1.1e-4 m / 1.5e-4
  px; bf16 with int8 convs 4.6e-5 / 2.0e-4 m / 1.7e-4 px);
- the package CLIs, bf16 calibration in both packages: scales within 2e-2
  relative. The scales are bf16 values; the port normalizes in float32 and
  rounds once, flax's bf16 BatchNorm rounds in bf16, so 8 to 11 of the 63
  keys differ by one bf16 ulp (0.4-0.6%) and the input of
  ``heatmap_head_0/conv1`` by 2 and 4 ulps (1.6% on the synthetic tree,
  1.7% on the unit-normal frames), beyond the 1e-2 first planned.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from object_keypoints_tpu.models import KeypointNet as JKeypointNet  # noqa: E402
from object_keypoints_tpu.serving import export as jexport  # noqa: E402
from object_keypoints_tpu.serving import quantize as JQ  # noqa: E402
from object_keypoints_tpu_torch.models.keypoint_net import KeypointNet  # noqa: E402
from object_keypoints_tpu_torch.ops import int8_conv  # noqa: E402
from object_keypoints_tpu_torch.pipeline.components import InferenceComponent  # noqa: E402
from object_keypoints_tpu_torch.serving import export, weights  # noqa: E402
from object_keypoints_tpu_torch.serving import quantize as Q  # noqa: E402
from object_keypoints_tpu_torch.testing import traced  # noqa: E402

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(heatmaps_out=3, features=32, dims=(32, 32, 48, 48, 64), stem_features=(16, 32),
             cnv_dim=32, stacks=2)
ARCH = dict(stacks=2, levels=4, mods=(2, 2, 2, 2, 4))
CONFIG = {**{k: list(v) if isinstance(v, tuple) else v for k, v in SMALL.items()},
          "input_size": 127, "keypoint_config": [1, 1]}
BUDGETS = {"heat": 0.02, "depth": 0.005, "centers": 0.25}  # tests/test_quantize.py


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def small():
    """(JAX model, variables, its float32 max-abs scales, frames NHWC)."""
    model = JKeypointNet(**SMALL, dtype=jnp.float32)
    x = np.random.default_rng(0).normal(size=(2, 127, 127, 3)).astype(np.float32)
    variables = model.init({"params": jax.random.key(0)}, jnp.asarray(x[:1]), train=False)
    scales = JQ.calibrate_activation_scales(lambda b: model.apply(variables, b, train=False),
                                            [jnp.asarray(x)])
    return model, variables, scales, x


def port_model(variables):
    model = KeypointNet(**SMALL)
    model.load_state_dict(weights.keypoint_net_state_dict(variables, **ARCH), strict=True)
    return model.eval()


def served(outs, stack):
    """(sigmoid heatmaps, depth, centers) of one stack, NCHW numpy."""
    if isinstance(outs.heatmaps[stack], torch.Tensor):
        return (torch.sigmoid(outs.heatmaps[stack].float()).numpy(),
                outs.depth[stack].float().numpy(), outs.centers[stack].float().numpy())
    heat, depth, centers = (np.asarray(a, np.float32) for a in
                            (outs.heatmaps[stack], outs.depth[stack], outs.centers[stack]))
    return (np.asarray(jax.nn.sigmoid(heat)).transpose(0, 3, 1, 2), depth.transpose(0, 3, 1, 2),
            centers.transpose(0, 3, 4, 1, 2))


def worst(a, b):
    return {name: float(np.abs(x - y).max()) for name, x, y in zip(BUDGETS, a, b)}


# --- calibration ------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"percentile": 99.5}, {"per_channel": True},
                                {"percentile": 99.5, "per_channel": True}],
                         ids=["max", "percentile", "per_channel", "per_channel_percentile"])
def test_calibration_matches_jax(small, kw):
    model, variables, _, x = small
    want = JQ.calibrate_activation_scales(lambda b: model.apply(variables, b, train=False),
                                          [jnp.asarray(x)], **kw)
    port = port_model(variables)
    got = Q.calibrate_activation_scales(port, port, [nchw(x)], **kw)
    # every eligible conv, the 3-channel stem and the unpools included
    assert set(got) == set(want) and len(got) == 151
    assert "backbone/pre_conv/Conv_0" in got and "backbone/hg_0/up2" in got
    assert set(got) == set(Q.conv_paths(port).values())
    for key in want:
        w, g = np.asarray(want[key], np.float64), np.asarray(got[key], np.float64)
        assert g.shape == w.shape, key
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), (key, g, w)


def test_percentile_matches_numpy_beyond_torch_quantiles_limit():
    """2^24 + 1 elements, which ``torch.quantile`` refuses; and per column."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal(2**24 + 1).astype(np.float32)
    for q in (99.5, 50.0, 100.0, 0.0):
        got = Q.linear_percentile(torch.from_numpy(a), q).item()
        assert got == pytest.approx(float(np.percentile(a, q)), rel=1e-6, abs=1e-7), q
    m = rng.standard_normal((5, 1001)).astype(np.float32)
    np.testing.assert_allclose(Q.linear_percentile(torch.from_numpy(m), 99.5, dim=1).numpy(),
                               np.percentile(m, 99.5, axis=1), rtol=1e-6)


# --- one conv at a time -----------------------------------------------------------------

CONVS = {  # name: (flax module, port module, input channels, spatial size)
    "3x3_s1": (lambda: fnn.Conv(24, (3, 3), padding=[(1, 1), (1, 1)], use_bias=False),
               lambda: torch.nn.Conv2d(16, 24, 3, padding=1, bias=False), 16, 9),
    "3x3_s2": (lambda: fnn.Conv(24, (3, 3), strides=(2, 2), padding=[(1, 1), (1, 1)],
                                use_bias=False),
               lambda: torch.nn.Conv2d(16, 24, 3, stride=2, padding=1, bias=False), 16, 9),
    "1x1_s2": (lambda: fnn.Conv(32, (1, 1), strides=(2, 2), padding=[(0, 0), (0, 0)],
                                use_bias=False),
               lambda: torch.nn.Conv2d(16, 32, 1, stride=2, bias=False), 16, 8),
    "conv_out": (lambda: fnn.Conv(3, (1, 1), use_bias=True),
                 lambda: torch.nn.Conv2d(32, 3, 1, bias=True), 32, 7),
    "up2": (lambda: fnn.ConvTranspose(16, (4, 4), strides=(2, 2), padding="SAME"),
            lambda: torch.nn.ConvTranspose2d(16, 16, 4, stride=2, padding=1), 16, 5),
}


@pytest.mark.parametrize("per_channel", [False, True], ids=["per_tensor", "per_channel"])
@pytest.mark.parametrize("name", list(CONVS))
def test_int8_conv_matches_jax(name, per_channel, monkeypatch):
    """The port's Int8Conv against JAX's ``quantized_apply`` on the same
    single flax module, weights and input: the int8 activation and weight
    codes the JAX package computes (caught at its int8 product) equal the
    port's, the outputs agree within 1e-6 relative, and the GEMM route gives
    the plain version's int32 sums exactly."""
    make_flax, make_port, c, size = CONVS[name]
    rng = np.random.default_rng(len(name) + 10 * per_channel)
    x = (rng.normal(size=(2, size, size, c)) * rng.uniform(0.2, 3.0, size=c)).astype(np.float32)
    module = make_flax()
    variables = module.init(jax.random.key(0), jnp.asarray(x))
    params = {"kernel": rng.uniform(-0.3, 0.3, variables["params"]["kernel"].shape)
              .astype(np.float32)}
    if "bias" in variables["params"]:
        params["bias"] = rng.normal(size=variables["params"]["bias"].shape).astype(np.float32)
    variables = {"params": params}
    amax = np.abs(x).reshape(-1, c).max(axis=0)
    scale = [float(s) for s in amax] if per_channel else float(amax.max())

    caught = {}
    for op in ("conv_general_dilated", "conv_transpose"):
        original = getattr(jax.lax, op)

        def catch(lhs, rhs, *args, _original=original, **kwargs):
            caught["x"], caught["w"] = np.array(lhs), np.array(rhs)
            return _original(lhs, rhs, *args, **kwargs)

        monkeypatch.setattr(jax.lax, op, catch)
    want = np.asarray(JQ.quantized_apply(module, variables, {"": scale}, jnp.asarray(x)))
    monkeypatch.undo()
    assert caught["x"].dtype == np.int8 and caught["w"].dtype == np.int8

    port = make_port()
    transpose = isinstance(port, torch.nn.ConvTranspose2d)
    to_port = weights.conv_transpose_weight if transpose else weights.conv_weight
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.ascontiguousarray(to_port(params["kernel"]))))
        if port.bias is not None:
            port.bias.copy_(torch.from_numpy(params["bias"]))
    q = Q.Int8Conv(port, scale, name)
    xq = int8_conv.quantize(nchw(x), q.in_scale_inv)
    assert torch.equal(xq, torch.from_numpy(caught["x"]))
    wq = torch.from_numpy(np.ascontiguousarray(to_port(caught["w"])))
    assert torch.equal(q.int8_weight(), wq)
    with torch.inference_mode():
        got = q(nchw(x)).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())

    if transpose:
        gemm = int8_conv.int8_conv_transpose2d_gemm(xq, q.packed, q.out_channels)
        plain = int8_conv.int8_conv_transpose2d_plain(xq, q.int8_weight())
    else:
        gemm = int8_conv.int8_conv2d_gemm(xq, q.packed, q.out_channels, q.kernel_size,
                                          q.stride, q.padding)
        plain = int8_conv.int8_conv2d_plain(xq, q.int8_weight(), q.stride, q.padding)
    assert torch.equal(gemm, plain)


@pytest.mark.parametrize("shape", [(2, 9, 9, 16, 24, 3, 1, 1), (2, 9, 9, 16, 24, 3, 2, 1),
                                   (3, 8, 8, 32, 3, 1, 1, 0), (2, 8, 8, 32, 16, 1, 2, 0),
                                   (1, 3, 3, 16, 8, 3, 1, 1), (2, 5, 7, 20, 10, 7, 2, 3),
                                   (2, 5, 7, 12, 10, 3, 2, 1)])
def test_gemm_route_equals_plain(shape, monkeypatch):
    """The GEMM route's index arithmetic on the CPU (``torch._int_mm`` runs
    here too): im2col by ``as_strided`` (int64 words where C % 8 == 0),
    stride, padding, M <= 16, K and N off multiples of 8, and batch chunks
    (``COLUMN_BYTES`` cut to a few frames); exact."""
    n, h, w, c, o, k, s, p = shape
    g = torch.Generator().manual_seed(sum(shape))
    xq = torch.randint(-127, 128, (n, h, w, c), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (o, c, k, k), generator=g, dtype=torch.int8)
    packed = int8_conv.pack_conv2d_weight(wq)
    assert packed.shape == (-(-o // 8) * 8, -(-(k * k * c) // 8) * 8)
    assert torch.equal(int8_conv.unpack_conv2d_weight(packed, o, c, k), wq)
    plain = int8_conv.int8_conv2d_plain(xq, wq, s, p)
    assert torch.equal(int8_conv.int8_conv2d_gemm(xq, packed, o, k, s, p), plain)
    monkeypatch.setattr(int8_conv, "COLUMN_BYTES", 2 * k * k * c)
    assert torch.equal(int8_conv.int8_conv2d_gemm(xq, packed, o, k, s, p), plain)
    # the conv_transpose route, 4 phases
    wt = torch.randint(-127, 128, (c, o, 4, 4), generator=g, dtype=torch.int8)
    packed_t = int8_conv.pack_conv_transpose2d_weight(wt)
    assert torch.equal(int8_conv.unpack_conv_transpose2d_weight(packed_t, o, c), wt)
    assert torch.equal(int8_conv.int8_conv_transpose2d_gemm(xq, packed_t, o),
                       int8_conv.int8_conv_transpose2d_plain(xq, wt))


def test_wrappers_run_the_plain_version_on_the_cpu():
    g = torch.Generator().manual_seed(1)
    xq = torch.randint(-127, 128, (2, 6, 6, 16), generator=g, dtype=torch.int8)
    wq = torch.randint(-127, 128, (8, 16, 3, 3), generator=g, dtype=torch.int8)
    wt = torch.randint(-127, 128, (16, 8, 4, 4), generator=g, dtype=torch.int8)
    (got, got_t), _, spans = traced(lambda: (
        int8_conv.int8_conv2d(xq, int8_conv.pack_conv2d_weight(wq), 8, 3, 1, 1),
        int8_conv.int8_conv_transpose2d(xq, int8_conv.pack_conv_transpose2d_weight(wt), 8)))
    assert torch.equal(got, int8_conv.int8_conv2d_plain(xq, wq, 1, 1))
    assert torch.equal(got_t, int8_conv.int8_conv_transpose2d_plain(xq, wt))
    assert "int8.mm" not in spans  # the GEMM route's span: no GEMM ran
    with pytest.raises(TypeError):
        int8_conv.int8_conv2d(xq.float(), int8_conv.pack_conv2d_weight(wq), 8, 3)


# --- the whole model --------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whole_model_matches_jax(small, dtype):
    """Both stacks of the port's int8 forward (float32, or bf16 with int8
    convs: bench.py's int8 mode) against JAX's ``quantized_apply`` with the
    same weights and scales, within tests/test_quantize.py's budgets (the
    measured maxima are in the module docstring)."""
    model, variables, scales, x = small
    jmodel = JKeypointNet(**SMALL, dtype=getattr(jnp, dtype))
    want = JQ.quantized_apply(jmodel, variables, scales, jnp.asarray(x, getattr(jnp, dtype)),
                              train=False)
    got = Q.quantized_apply(port_model(variables), scales, nchw(x).to(getattr(torch, dtype)))
    for stack in range(2):
        err = worst(served(got, stack), served(want, stack))
        for name, limit in BUDGETS.items():
            assert err[name] < limit, (dtype, stack, err)


def test_default_placement_keeps_the_hourglass_float(small, monkeypatch):
    """skip=None applies the default: bitwise equal to the explicit /hg_
    predicate, different from quantizing everything."""
    monkeypatch.delenv("OKT_INT8_SKIP", raising=False)
    _, variables, scales, x = small
    port, frames = port_model(variables), nchw(x)
    default = Q.quantized_apply(port, scales, frames)
    explicit = Q.quantized_apply(port, scales, frames, skip=lambda p: "/hg_" in p)
    everything = Q.quantized_apply(port, scales, frames, skip=lambda p: False)
    def flat(outs):
        return [t for group in outs for t in group]

    assert all(torch.equal(a, b) for a, b in zip(flat(default), flat(explicit)))
    assert any(not torch.equal(a, b) for a, b in zip(flat(default), flat(everything)))
    swapped = Q.quantize_model(port_model(variables), scales)
    paths = {m.path for m in swapped.modules() if isinstance(m, Q.Int8Conv)}
    assert paths and all("/hg_" not in p for p in paths)
    assert "backbone/pre_res1/Conv_0" in paths and "heatmap_head_1/conv_out" in paths
    assert "backbone/pre_conv/Conv_0" not in paths  # 3 input channels


def test_skip_predicate_follows_okt_int8_skip(monkeypatch):
    monkeypatch.delenv("OKT_INT8_SKIP", raising=False)
    pred = Q.default_skip()
    assert pred("backbone/hg_0/up1_0/Conv_0") and not pred("backbone/pre_res1/Conv_0")
    monkeypatch.setenv("OKT_INT8_SKIP", "")
    assert Q.default_skip() is None  # empty override = quantize everything
    monkeypatch.setenv("OKT_INT8_SKIP", "pre_res,_head_")
    pred = Q.default_skip()
    assert pred("backbone/pre_res1/Conv_0") and pred("heatmap_head_0/conv0")
    assert not pred("backbone/hg_0/up1_0/Conv_0")
    for env in ("", "pre_res,_head_"):
        monkeypatch.setenv("OKT_INT8_SKIP", env)
        assert Q.DEFAULT_SKIP_SUBSTRINGS == JQ.DEFAULT_SKIP_SUBSTRINGS
        for path in ("backbone/hg_0/up2", "backbone/pre_res1/Conv_0", "heatmap_head_0/conv0"):
            j, p = JQ.default_skip(), Q.default_skip()
            assert (j is None) == (p is None) and (p is None or p(path) == j(path))


def test_narrow_convs_stay_float(small):
    """Convs with fewer than ``min_in_features`` input channels keep their
    float module; with none above the threshold the forward is bitwise the
    float one."""
    _, variables, scales, x = small
    port = Q.quantize_model(port_model(variables), scales, min_in_features=33,
                            skip=lambda p: False)
    for name, path in Q.conv_paths(port).items():
        module = port.get_submodule(name)
        wide = module.weight.shape[0 if "up2" in path else 1] >= 33
        assert isinstance(module, Q.Int8Conv) == wide, path
    frames = nchw(x)
    float_model = port_model(variables)
    with torch.inference_mode():
        want = float_model(frames)
    got = Q.quantized_apply(float_model, scales, frames, min_in_features=1000)
    assert all(torch.equal(a, b) for ga, wa in zip(got, want) for a, b in zip(ga, wa))


def test_stem_handoff_numerics_unchanged(small):
    """With the stem handoff, pre_conv's and pre_res1's outputs leave them
    int8 and their consumers take the codes as they are: bitwise the same
    outputs as without it."""
    _, variables, scales, x = small
    port, frames = port_model(variables), nchw(x)
    handed = Q.quantize_model(port_model(variables), scales, handoffs=Q.STEM_HANDOFFS)
    seen = []
    handed.backbone.pre[1].conv1.register_forward_pre_hook(
        lambda m, args: seen.append(type(args[0]).__name__))
    with torch.inference_mode():
        with_h = handed(frames)
    without = Q.quantized_apply(port, scales, frames, handoffs={})
    assert seen == ["QuantizedActivation"]
    assert all(torch.equal(a, b) for ga, gb in zip(with_h, without) for a, b in zip(ga, gb))


def test_int8_state_dict_is_the_float_one(small):
    _, variables, scales, _ = small
    float_sd = port_model(variables).state_dict()
    quantized = Q.quantize_model(port_model(variables), scales)
    sd = quantized.state_dict()
    assert list(sd) == list(float_sd)
    assert all(torch.equal(sd[k], float_sd[k]) for k in sd)


# --- artifacts --------------------------------------------------------------------------


def test_quant_json_both_ways(small, tmp_path):
    model, variables, scales, x = small
    export.export_model(str(tmp_path / "port"), CONFIG, port_model(variables), quant_scales=scales)
    assert jexport.load_quant_scales(str(tmp_path / "port")) == scales
    jexport.export_model(str(tmp_path / "jax"), CONFIG, variables, quant_scales=scales)
    assert export.load_quant_scales(str(tmp_path / "jax")) == scales
    assert ((tmp_path / "port" / "quant.json").read_bytes()
            == (tmp_path / "jax" / "quant.json").read_bytes())
    export.export_model(str(tmp_path / "float"), CONFIG, port_model(variables))
    assert export.load_quant_scales(str(tmp_path / "float")) is None


def test_port_serves_a_jax_int8_artifact(small, tmp_path):
    """A JAX-written artifact with quant.json: the port's "auto" serves it
    int8 within the budgets of JAX's own ``load_inference_fn``; "never"
    equals the float path; "require" without quant.json raises
    FileNotFoundError."""
    model, variables, scales, x = small
    jexport.export_model(str(tmp_path / "int8"), CONFIG, variables, quant_scales=scales)
    jexport.export_model(str(tmp_path / "float"), CONFIG, variables)
    frames = x.transpose(0, 3, 1, 2).copy()
    want = [np.asarray(a) for a in jexport.load_inference_fn(str(tmp_path / "int8"))(frames)]
    auto = export.load_inference_fn(str(tmp_path / "int8"), device="cpu")(frames)
    err = worst([t.numpy() for t in auto], want)
    assert all(err[k] < BUDGETS[k] for k in BUDGETS), err
    never = export.load_inference_fn(str(tmp_path / "int8"), quantize="never", device="cpu")(frames)
    plain = export.make_inference_fn(port_model(variables), device="cpu")(frames)
    assert all(torch.equal(a, b) for a, b in zip(never, plain))
    assert any(not torch.equal(a, b) for a, b in zip(auto, never))
    with pytest.raises(FileNotFoundError):
        export.load_inference_fn(str(tmp_path / "float"), quantize="require", device="cpu")
    required = export.load_inference_fn(str(tmp_path / "int8"), quantize="require",
                                        device="cpu")(frames)
    assert all(torch.equal(a, b) for a, b in zip(required, auto))


def test_inference_component_serves_int8(small, tmp_path):
    model, variables, scales, x = small
    export.export_model(str(tmp_path), CONFIG, port_model(variables), quant_scales=scales)
    frames = x.transpose(0, 3, 1, 2).copy()
    got = InferenceComponent(str(tmp_path), cuda=False)(frames)
    want = export.load_inference_fn(str(tmp_path), device="cpu")(frames)
    never = export.load_inference_fn(str(tmp_path), quantize="never", device="cpu")(frames)
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(got, want))
    assert any(not np.array_equal(a, b.numpy()) for a, b in zip(got, never))


# --- the package CLIs -------------------------------------------------------------------


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A port checkpoint of the loop tests' tiny model (widths 8 to 32)."""
    pytest.importorskip("h5py")
    from test_torch_port_loop import tiny_hparams, trained_state

    from object_keypoints_tpu_torch.training import checkpoints

    run = tmp_path_factory.mktemp("quant_ckpt") / "run"
    checkpoints.CheckpointManager(str(run), hparams=tiny_hparams()).save_if_best(
        trained_state(), 3, 0.5)
    return run


@pytest.mark.parametrize("source", ["data", "fallback"])
def test_package_clis_calibrate_alike(checkpoint, tmp_path, calibration_file, source):
    """scripts/package_model.py and the port's CLI package the same port
    checkpoint with --quantize, on a synthetic tree (--calibration-data) and
    on the unit-normal fallback: the same keys, scales within 2e-2, equal
    quantized_convs; the port's artifact serves int8 through "auto"."""
    from object_keypoints_tpu.data import synthetic as jsynthetic

    from object_keypoints_tpu_torch.cli import package_model

    flags = ["--quantize", "--calibration-frames", "4"]
    if source == "data":
        train_dir, _ = jsynthetic.make_synthetic_dataset_tree(
            str(tmp_path / "tree"), calibration_file, [1, 3], n_train=1, n_val=0, n_frames=4)
        flags += ["--calibration-data", train_dir]
    ref = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "package_model.py"), "--model", str(checkpoint),
         "--out", str(tmp_path / "jax"), *flags], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert ref.returncode == 0, ref.stderr
    want = json.loads(ref.stdout.strip().splitlines()[-1])
    got = package_model.main(["--model", str(checkpoint), "--out", str(tmp_path / "port"),
                              "--cpu", *flags])
    assert want["quantized_convs"] == got["quantized_convs"] > 0
    jscales = jexport.load_quant_scales(str(tmp_path / "jax"))
    scales = export.load_quant_scales(str(tmp_path / "port"))
    assert set(scales) == set(jscales) and len(scales) == got["quantized_convs"]
    for key in jscales:
        assert scales[key] == pytest.approx(jscales[key], rel=2e-2), key
    frames = np.random.default_rng(4).normal(size=(2, 3, 511, 511)).astype(np.float32)
    auto = export.load_inference_fn(str(tmp_path / "port"), device="cpu")(frames)
    never = export.load_inference_fn(str(tmp_path / "port"), quantize="never",
                                     device="cpu")(frames)
    assert any(not torch.equal(a, b) for a, b in zip(auto, never))
