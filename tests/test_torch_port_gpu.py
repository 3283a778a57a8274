"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card: a CUDA
kernel has no CPU mode. The file imports neither jax nor the JAX package,
so it also runs where jax is not installed:

    python -m pytest --noconftest tests/test_torch_port_gpu.py -q

fp32 comparisons run with TF32 off (cuDNN and matmul) and atol 1e-4, the
tolerance of the CPU parity tests. bf16 comparisons allow one output ulp,
stated as rtol = atol = 1e-2.
"""

import pytest

torch = pytest.importorskip("torch")

from object_keypoints_tpu_torch.models.keypoint_net import KeypointNet  # noqa: E402
from object_keypoints_tpu_torch.ops.stem_conv import stem_conv, stem_conv_plain  # noqa: E402

pytestmark = pytest.mark.gpu


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
    before = stem_conv.launches
    out = stem_conv(x, w, scale, bias)
    torch.cuda.synchronize()
    assert stem_conv.launches == before + 1
    assert out.shape == (3, c_out, (size + 1) // 2, (size + 1) // 2)
    assert out.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(out, stem_conv_plain(x, w, scale, bias), atol=1e-4, rtol=0)


def test_stem_bf16_within_one_ulp(cuda):
    g, w, scale, bias = _stem_args(128, 1, cuda)
    x = torch.randn(2, 3, 511, 511, generator=g).to(cuda, torch.bfloat16)
    out = stem_conv(x, w, scale, bias)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 128, 256, 256)
    torch.testing.assert_close(out.float(), stem_conv_plain(x, w, scale, bias).float(),
                               atol=1e-2, rtol=1e-2)


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
