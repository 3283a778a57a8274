"""``ops.int8_conv.quantize`` on the CPU: the plain version and its dispatch.

A CPU tensor runs ``quantize_plain`` (the eager chain) and never loads the
CUDA library; its arithmetic, ``clip(round(float32(x) * inv), -127, 127)``
with ties to even and NHWC int8 out, is pinned on hand-made tensors. The
kernel that a CUDA tensor runs is held to ``quantize_plain`` bit for bit in
``tests/test_torch_port_quantize_kernel.py``, on the card.
"""

import pytest

torch = pytest.importorskip("torch")

from object_keypoints_tpu_torch.ops import _build, int8_conv  # noqa: E402
from object_keypoints_tpu_torch.ops.int8_conv import quantize, quantize_plain  # noqa: E402
from object_keypoints_tpu_torch.serving.quantize import Int8Conv  # noqa: E402
from object_keypoints_tpu_torch.utils import timer  # noqa: E402

DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.fixture
def no_library(monkeypatch):
    """Loading the CUDA library fails the test."""
    def refuse():
        raise AssertionError("the CPU path loaded the CUDA library")

    monkeypatch.setattr(_build, "load_library", refuse)


def _nchw(values_hwc, dtype):
    """A (1, C, H, W) view of one frame's HWC values: channels_last memory."""
    return torch.tensor([values_hwc], dtype=torch.float32).to(dtype).permute(0, 3, 1, 2)


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_tensor_takes_the_plain_version(no_library, dtype, per_channel):
    g = torch.Generator().manual_seed(7)
    x = (torch.randn(2, 24, 5, 3, generator=g) * 90).to(dtype)
    inv = torch.rand(24, generator=g) + 0.5 if per_channel else 1.37
    before = quantize.launches
    was = timer.enable(True)
    try:
        got = quantize(x, inv)
        counts = timer.snapshot()["counts"]
    finally:
        timer.enable(was)
    assert torch.equal(got, quantize_plain(x, inv))
    assert got.dtype == torch.int8 and got.shape == (2, 5, 3, 24) and got.is_contiguous()
    assert quantize.launches == before
    if not torch.cuda.is_available():  # nothing in this process launched the kernel
        assert before == 0
    assert "int8.quantize.kernel" not in counts and "int8.quantize.relayout" not in counts


def test_int8_conv_on_cpu_never_loads_the_library(no_library):
    conv = torch.nn.Conv2d(16, 8, 3, padding=1)
    q = Int8Conv(conv, 3.0, "backbone/pre_res1/Conv_0")
    x = torch.randn(2, 16, 6, 6).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        y = q(x)
    assert y.shape == (2, 8, 6, 6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_per_tensor_ties_to_even_and_both_clips(dtype):
    values = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 127.5, -127.5, 300.0, -300.0,
              float("inf"), float("-inf"), 0.49, -0.51]
    want = [0, 2, 2, 0, -2, -2, 126, -126, 127, -127, 127, -127, 127, -127, 0, -1]
    # one frame, 2 x 2 pixels, 4 channels; inv 1.0 keeps the products exact
    x = _nchw([[values[0:4], values[4:8]], [values[8:12], values[12:16]]], dtype)
    got = quantize_plain(x, 1.0)
    assert got.dtype == torch.int8 and got.shape == (1, 2, 2, 4) and got.is_contiguous()
    assert got.reshape(-1).tolist() == want


def test_per_tensor_scale_halves_odd_integers_to_ties():
    x = _nchw([[[1.0, 3.0, 5.0, -7.0, 255.0, -255.0, 257.0, 2.0]]], torch.float32)  # 1 x 1 px
    assert quantize_plain(x, 0.5).reshape(-1).tolist() == [0, 2, 2, -4, 127, -127, 127, 1]


def test_per_channel_vector_scales_each_channel():
    inv = torch.tensor([1.0, 2.0, 0.5, 0.25])
    x = _nchw([[[2.5, 1.25, 3.0, 10.0], [-2.5, -0.75, 255.0, -1000.0]],
               [[0.5, 63.75, -5.0, 2.0], [100.0, -64.0, 1.0, 6.0]]], torch.float32)
    want = [[[2, 2, 2, 2], [-2, -2, 127, -127]],
            [[0, 127, -2, 0], [100, -127, 0, 2]]]
    got = quantize_plain(x, inv)
    assert got.is_contiguous() and got.tolist() == [want]


def test_nchw_contiguous_input_gives_the_same_codes():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 16, 4, 5, generator=g) * 70
    inv = torch.rand(16, generator=g) + 0.5
    cl = x.contiguous(memory_format=torch.channels_last)
    assert torch.equal(quantize(x, inv), quantize(cl, inv))
    assert quantize(x, inv).is_contiguous()


def test_a_device_without_a_kernel_raises(no_library):
    x = torch.empty(1, 8, 2, 2, device="meta")
    before = quantize.launches
    with pytest.raises(ValueError, match="no kernel for device meta"):
        quantize(x, 1.0)
    assert quantize.launches == before


def test_every_dtype_the_kernel_takes_has_a_code():
    assert sorted(int8_conv.QUANTIZE_DTYPES.values()) == [0, 1, 2]
    assert set(int8_conv.QUANTIZE_DTYPES) == set(DTYPES)
    assert (_build.CSRC_DIR / "int8_quantize.cu").exists()
