"""Port parity: the stem kernels' plain version, the space-to-depth tap
matrix the bf16 kernel multiplies by and its cache, the BN-fold stem block,
the kernel build helper.

The plain ``stem_conv`` (what the wrapper runs on a CPU tensor) is held
against the JAX package's Pallas kernel in interpret mode (as
tests/test_pallas.py runs it) and against ``stem_conv_reference``, at
atol 1e-4 as in test_pallas in fp32, and within one bf16 ulp (rtol = atol =
1e-2) in bf16. The port's ``stem_taps`` equals the JAX tap matrix regrouped
exactly, and the kernel's decomposition (space-to-depth, 4 row-shifted
slabs of 48, one matmul) equals the plain conv at atol 1e-4. The CUDA
kernels themselves are compared with the plain version in
tests/test_torch_port_gpu.py, which needs a card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from object_keypoints_tpu.models.blocks import ConvBlock as JConvBlock  # noqa: E402
from object_keypoints_tpu.ops.pallas import stem_conv as jsc  # noqa: E402
from object_keypoints_tpu_torch.models.blocks import StemConvBlock  # noqa: E402
from object_keypoints_tpu_torch.ops import _build  # noqa: E402
from object_keypoints_tpu_torch.ops.stem_conv import (  # noqa: E402
    bf16_taps,
    fold_bn,
    stem_conv,
    stem_conv_plain,
    stem_taps,
)

torch.set_num_threads(1)


def _stem_inputs(rng, size, c_out, n=2):
    x = rng.normal(size=(n, size, size, 3)).astype(np.float32)  # NHWC, as JAX
    w7 = (rng.normal(size=(7, 7, 3, c_out)) * 0.1).astype(np.float32)  # HWIO
    scale = rng.uniform(0.5, 1.5, size=(c_out,)).astype(np.float32)
    bias = rng.normal(size=(c_out,)).astype(np.float32) * 0.1
    return x, w7, scale, bias


def _port_stem(x, w7, scale, bias):
    out = stem_conv(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                    torch.from_numpy(w7.transpose(3, 2, 0, 1).copy()),
                    torch.from_numpy(scale), torch.from_numpy(bias))
    return out.numpy().transpose(0, 2, 3, 1)


class TestStemPlainParity:
    @pytest.mark.parametrize("size", [64, 63])
    @pytest.mark.parametrize("c_out", [8, 128])
    def test_against_pallas_interpret_and_reference(self, size, c_out):
        rng = np.random.default_rng(size + c_out)
        x, w7, scale, bias = _stem_inputs(rng, size, c_out)
        out = _port_stem(x, w7, scale, bias)
        assert out.shape == (2, 32, 32, c_out)

        ref = np.asarray(jsc.stem_conv_reference(jnp.asarray(x), jnp.asarray(w7),
                                                 jnp.asarray(scale), jnp.asarray(bias)))
        np.testing.assert_allclose(out, ref, atol=1e-4)

        # the TPU kernel needs an even frame: zero-pad bottom/right, as
        # stem_conv_pallas_from_frame does (the padded pixels are ones the
        # 7x7 window reads as zero anyway)
        xp = np.pad(x, ((0, 0), (0, size % 2), (0, size % 2), (0, 0)))
        taps = jnp.asarray(jsc.rearrange_stem_kernel(w7))
        pallas = np.asarray(jsc.fused_stem_conv(
            jsc.space_to_depth(jnp.asarray(xp)), taps, jnp.asarray(scale), jnp.asarray(bias),
            rows_per_strip=8, interpret=True))
        np.testing.assert_allclose(out, pallas, atol=1e-4)

    def test_output_is_channels_last(self):
        x = torch.zeros(1, 3, 16, 16)
        out = stem_conv(x, torch.zeros(8, 3, 7, 7), torch.ones(8), torch.zeros(8))
        assert out.shape == (1, 8, 8, 8)
        assert out.is_contiguous(memory_format=torch.channels_last)

    def test_cpu_tensors_launch_nothing(self):
        stem_conv.launches = 0
        rng = np.random.default_rng(5)
        x, w7, scale, bias = _stem_inputs(rng, 32, 8, n=1)
        _port_stem(x, w7, scale, bias)
        assert stem_conv.launches == 0

    def test_fold_bn_matches_batchnorm(self):
        rng = np.random.default_rng(6)
        bn = torch.nn.BatchNorm2d(8).eval()
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 8).astype(np.float32)))
            bn.bias.copy_(torch.from_numpy(rng.normal(size=8).astype(np.float32)))
            bn.running_mean.copy_(torch.from_numpy(rng.normal(size=8).astype(np.float32)))
            bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, 8).astype(np.float32)))
        x = torch.from_numpy(rng.normal(size=(2, 8, 4, 4)).astype(np.float32))
        scale, bias = fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
        with torch.no_grad():
            np.testing.assert_allclose((x * scale[:, None, None] + bias[:, None, None]).numpy(),
                                       bn(x).numpy(), atol=1e-6)


def _s2d_gemm(x, w, scale, bias):
    """The bf16 kernel's arithmetic in fp32: s2d cells (p, q, c) reading zero
    outside the frame, for each output pixel the 4 row-shifted slabs of 48
    contiguous values (cells x - 2 .. x + 1) concatenated to K = 192, one
    matmul with ``stem_taps``, then the affine and ReLU."""
    n, _, h, wd = x.shape
    ho, wo = (h - 1) // 2 + 1, (wd - 1) // 2 + 1
    # s2d rows -2 .. ho and cells -2 .. wo: frame rows and columns from -4
    xp = torch.nn.functional.pad(x, (4, 2 * wo + 2 - wd, 4, 2 * ho + 2 - h))
    s2d = xp.reshape(n, 3, ho + 3, 2, wo + 3, 2).permute(0, 2, 4, 3, 5, 1).reshape(
        n, ho + 3, wo + 3, 12)
    slabs = [s2d[:, u:u + ho].unfold(2, 4, 1).transpose(-1, -2).reshape(n, ho, wo, 48)
             for u in range(4)]
    y = torch.cat(slabs, dim=-1) @ stem_taps(w)
    return torch.relu(y * scale + bias).permute(0, 3, 1, 2)


class TestStemTaps:
    @pytest.mark.parametrize("c_out", [8, 128])
    def test_equals_jax_taps_regrouped_by_row_shift(self, c_out):
        w7 = _stem_inputs(np.random.default_rng(c_out), 8, c_out)[1]
        jax_taps = jsc.rearrange_stem_kernel(w7)  # (v, u * 12 + k, C)
        regrouped = jax_taps.reshape(4, 4, 12, c_out).transpose(1, 0, 2, 3).reshape(192, c_out)
        taps = stem_taps(torch.from_numpy(w7.transpose(3, 2, 0, 1).copy()))
        assert taps.shape == (192, c_out)
        np.testing.assert_array_equal(taps.numpy(), regrouped)
        assert int((taps == 0).all(dim=1).sum()) == 45  # dy or dx would be -1
        wide = stem_taps(torch.from_numpy(w7.transpose(3, 2, 0, 1).copy()), 128)
        assert torch.equal(wide[:, :c_out], taps) and not wide[:, c_out:].any()

    @pytest.mark.parametrize("size", [64, 63, 37])
    @pytest.mark.parametrize("c_out", [8, 128])
    def test_space_to_depth_gemm_matches_plain_conv(self, size, c_out):
        rng = np.random.default_rng(3 * size + c_out)
        x, w7, scale, bias = (torch.from_numpy(a) for a in _stem_inputs(rng, size, c_out))
        frames, w = x.permute(0, 3, 1, 2).contiguous(), w7.permute(3, 2, 0, 1).contiguous()
        got = _s2d_gemm(frames, w, scale, bias)
        want = stem_conv_plain(frames, w, scale, bias)
        assert got.shape == want.shape == (2, c_out, (size + 1) // 2, (size + 1) // 2)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=0)


class TestBf16TapCache:
    """The wrapper's tap matrix for the bf16 kernel is built once per weight
    tensor and rebuilt when the weights change."""

    def _weights(self):
        w7 = _stem_inputs(np.random.default_rng(21), 8, 64)[1]
        return torch.from_numpy(w7.transpose(3, 2, 0, 1).copy())

    def test_equals_stem_taps_of_bf16_weights(self):
        w = self._weights()
        taps = bf16_taps(w)
        assert taps.dtype == torch.bfloat16 and taps.shape == (192, 128) and taps.is_contiguous()
        assert torch.equal(taps, stem_taps(w.to(torch.bfloat16), 128))

    def test_built_once_per_weight_tensor(self):
        w = self._weights()
        assert bf16_taps(w) is bf16_taps(w)
        assert bf16_taps(w.clone()) is not bf16_taps(w)

    @pytest.mark.parametrize("change", ["in_place", "new_data", "dtype"])
    def test_rebuilt_when_the_weights_change(self, change):
        w = torch.nn.Parameter(self._weights())
        first = bf16_taps(w)
        with torch.no_grad():
            if change == "in_place":
                w.mul_(2)
            elif change == "new_data":
                w.data = w.data * 2
            else:
                w.data = w.data.to(torch.bfloat16)
        again = bf16_taps(w)
        assert again is not first
        assert torch.equal(again, stem_taps(w.detach().to(torch.bfloat16), 128))

    def test_inference_tensor_is_not_cached(self):
        with torch.inference_mode():
            w = self._weights() * 1
            assert w.is_inference()
            first = bf16_taps(w)
            w.mul_(2)
            assert torch.equal(bf16_taps(w), stem_taps(w.to(torch.bfloat16), 128))
            assert not torch.equal(bf16_taps(w), first)


class TestStemPlainBf16:
    @pytest.mark.parametrize("size", [64, 63])
    def test_within_one_ulp_of_pallas_interpret(self, size):
        """bf16 frames: the plain version (taps rounded to bf16, fp32 sums,
        one rounding) against the Pallas kernel run in bf16 as
        stem_conv_pallas_from_frame runs it (taps cast to the frames' dtype)."""
        rng = np.random.default_rng(11 + size)
        x, w7, scale, bias = _stem_inputs(rng, size, 128)
        xb = jnp.asarray(x, jnp.bfloat16)
        xp = jnp.pad(xb, ((0, 0), (0, size % 2), (0, size % 2), (0, 0)))
        taps = jnp.asarray(jsc.rearrange_stem_kernel(w7)).astype(jnp.bfloat16)
        pallas = jsc.fused_stem_conv(jsc.space_to_depth(xp), taps, jnp.asarray(scale),
                                     jnp.asarray(bias), rows_per_strip=8, interpret=True)
        pallas = np.asarray(pallas.astype(jnp.float32))

        frames = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(torch.bfloat16)
        out = stem_conv(frames, torch.from_numpy(w7.transpose(3, 2, 0, 1).copy()),
                        torch.from_numpy(scale), torch.from_numpy(bias))
        assert out.dtype == torch.bfloat16
        assert out.is_contiguous(memory_format=torch.channels_last)
        got = out.float().numpy().transpose(0, 2, 3, 1)
        np.testing.assert_allclose(got, pallas, rtol=1e-2, atol=1e-2)


class TestStemBlockParity:
    def test_bn_fold_eval_block_against_flax(self):
        """The eval-mode StemConvBlock (BN folded into the stem) equals flax
        ConvBlock(7, s2) conv + BN + ReLU with random BN statistics."""
        rng = np.random.default_rng(7)
        c_out = 16
        jblock = JConvBlock(c_out, kernel=7, stride=2)
        x = rng.normal(size=(2, 40, 40, 3)).astype(np.float32)
        variables = jblock.init({"params": jax.random.key(0)}, jnp.asarray(x))
        params = flatten_dict(variables["params"])
        params[("BatchNorm_0", "scale")] = rng.uniform(0.5, 1.5, c_out).astype(np.float32)
        params[("BatchNorm_0", "bias")] = rng.normal(size=c_out).astype(np.float32)
        mean = rng.normal(size=c_out).astype(np.float32) * 0.5
        var = rng.uniform(0.5, 2.0, c_out).astype(np.float32)
        jvars = {
            "params": {"Conv_0": {"kernel": params[("Conv_0", "kernel")]},
                       "BatchNorm_0": {"scale": params[("BatchNorm_0", "scale")],
                                       "bias": params[("BatchNorm_0", "bias")]}},
            "batch_stats": {"BatchNorm_0": {"mean": mean, "var": var}},
        }
        ref = np.asarray(jblock.apply(jvars, jnp.asarray(x), train=False))

        block = StemConvBlock(c_out).eval()
        with torch.no_grad():
            block.conv.weight.copy_(torch.from_numpy(
                np.asarray(params[("Conv_0", "kernel")]).transpose(3, 2, 0, 1).copy()))
            block.bn.weight.copy_(torch.from_numpy(params[("BatchNorm_0", "scale")]))
            block.bn.bias.copy_(torch.from_numpy(params[("BatchNorm_0", "bias")]))
            block.bn.running_mean.copy_(torch.from_numpy(mean))
            block.bn.running_var.copy_(torch.from_numpy(var))
            xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
            folded = block(xt).numpy().transpose(0, 2, 3, 1)
        np.testing.assert_allclose(folded, ref, atol=1e-4)


class TestKernelBuild:
    def test_missing_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
        monkeypatch.delenv("CUDA_HOME", raising=False)
        monkeypatch.setenv("PATH", str(tmp_path))
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build()

    def test_failing_nvcc_raises_with_its_stderr(self, monkeypatch, tmp_path):
        fake = tmp_path / "cuda" / "bin" / "nvcc"
        fake.parent.mkdir(parents=True)
        fake.write_text("#!/bin/sh\necho 'stem_conv.cu(1): error: broken' >&2\nexit 2\n")
        fake.chmod(0o755)
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
        monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
        with pytest.raises(RuntimeError, match="error: broken"):
            _build.build()
        assert not any((tmp_path / "_build").glob("*.so"))

    def test_library_name_keys_on_sources(self, monkeypatch, tmp_path):
        (tmp_path / "a.cu").write_text("// one")
        monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
        first = _build.library_path()
        (tmp_path / "a.cu").write_text("// two")
        assert _build.library_path() != first

