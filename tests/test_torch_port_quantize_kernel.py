"""The int8 route's quantize kernel against its plain version, on the card.

``ops.int8_conv.quantize`` on a CUDA tensor launches ``okt_quantize_int8``
(``csrc/int8_quantize.cu``); every test compares its codes with
``quantize_plain``'s, the eager chain, on the same CUDA input, by
``torch.equal``: the kernel's arithmetic is the chain's, so nothing may
differ. Every test is marked ``gpu`` and skips without a CUDA card: a CUDA
kernel has no CPU mode. The file imports neither jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_port_quantize_kernel.py -q
"""

import pytest

torch = pytest.importorskip("torch")

from object_keypoints_tpu_torch.ops.int8_conv import quantize, quantize_plain  # noqa: E402
from object_keypoints_tpu_torch.testing import traced  # noqa: E402

pytestmark = pytest.mark.gpu
DTYPES = [torch.bfloat16, torch.float16, torch.float32]
POWERS = (0.25, 0.5, 1.0, 2.0)  # scales that keep x * inv exact, so ties stay ties


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _inv(c, per_channel, device, seed):
    """1 / s_in: a power of two for the tensor, or per channel powers of two
    mixed with scales that are not."""
    if not per_channel:
        return 0.5
    g = torch.Generator().manual_seed(seed)
    inv = torch.tensor([POWERS[i % 4] for i in range(c)])
    other = torch.rand(c, generator=g) * 3 + 0.1
    return torch.where(torch.arange(c) % 3 == 2, other, inv).to(device)


def _activation(shape, dtype, inv, device, seed):
    """(N, C, H, W) in channels_last memory: random values, a third of
    them past the clip, a third exact half-integer ties after scaling (where
    the channel's scale is a power of two), and a few +-inf."""
    n, c, h, w = shape
    g = torch.Generator().manual_seed(seed)
    inv_c = (inv.cpu() if isinstance(inv, torch.Tensor) else torch.full((c,), inv)).double()
    x = torch.randn(n, h, w, c, generator=g, dtype=torch.float64) * 100 / inv_c
    pick = torch.randint(0, 3, x.shape, generator=g)
    odd = torch.randint(-128, 128, x.shape, generator=g, dtype=torch.float64) * 2 + 1
    x = torch.where(pick == 0, odd / 2 / inv_c, x)  # (2k + 1) / 2 after scaling
    x = torch.where(pick == 1, x * 3, x)  # past +-127 after scaling
    flat = x.view(-1)
    flat[torch.randint(0, flat.numel(), (4,), generator=g)] = float("inf")
    flat[torch.randint(0, flat.numel(), (4,), generator=g)] = float("-inf")
    return x.to(dtype).to(device).permute(0, 3, 1, 2)


def _check(x, inv):
    """One launch, the plain version's codes, NHWC int8 contiguous: the
    codes and the call's counts."""
    got, counts, _ = traced(lambda: quantize(x, inv))
    assert counts.get("int8.quantize.kernel") == 1
    n, c, h, w = x.shape
    assert got.dtype == torch.int8 and got.shape == (n, h, w, c) and got.is_contiguous()
    assert got.device == x.device
    want = quantize_plain(x, inv)
    assert torch.equal(got, want)
    return got, counts


@pytest.mark.parametrize("shape", [(2, 16, 9, 7), (3, 24, 5, 5), (2, 256, 17, 13),
                                   (2, 259, 6, 5), (1, 8, 1, 1), (1, 3, 7, 5)])
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_equals_plain(cuda, dtype, per_channel, shape):
    """C of 16, 24, 256 (the vector path) and 259, 3 (the scalar path);
    N * H * W of 126, 75, 442, 60, 1 and 35, none a multiple of 8."""
    seed = sum(shape) * 7 + per_channel
    inv = _inv(shape[1], per_channel, cuda, seed)
    _check(_activation(shape, dtype, inv, cuda, seed), inv)


def test_ties_and_clips_pinned_on_the_card(cuda):
    values = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 127.5, -127.5, 300.0, -300.0,
              float("inf"), float("-inf"), 0.49, -0.51]
    want = [0, 2, 2, 0, -2, -2, 126, -126, 127, -127, 127, -127, 127, -127, 0, -1]
    for dtype in DTYPES:
        x = torch.tensor(values * 2, dtype=dtype, device=cuda).view(1, 2, 2, 8)
        got, _ = _check(x.permute(0, 3, 1, 2), 1.0)
        assert got.reshape(-1).tolist() == want * 2


def test_nan_takes_the_eager_code(cuda):
    x = torch.full((1, 2, 2, 8), float("nan"), device=cuda).permute(0, 3, 1, 2)
    _check(x, 1.0)
    _check(x.bfloat16(), torch.ones(8, device=cuda))


def test_per_tensor_scale_is_rounded_to_float32(cuda):
    """A Python scale that float32 cannot hold: the eager multiply rounds
    it to float32 first, and so does the kernel's call."""
    inv = 1.0 / (7.3 / 127.0)
    g = torch.Generator().manual_seed(11)
    x = (torch.randn(4, 64, 32, 32, generator=g) * 3).to(cuda, torch.bfloat16)
    _check(x.contiguous(memory_format=torch.channels_last), inv)


def test_nchw_contiguous_input_is_relaid_once(cuda):
    inv = _inv(32, True, cuda, 5)
    x = _activation((2, 32, 9, 11), torch.bfloat16, inv, cuda, 5).contiguous()
    assert not x.permute(0, 2, 3, 1).is_contiguous()
    _, counts = _check(x, inv)
    assert counts.get("int8.quantize.relayout") == 1
    assert counts.get("int8.quantize.kernel") == 1


def test_channels_last_input_is_not_relaid(cuda):
    x = _activation((2, 32, 9, 11), torch.bfloat16, 0.5, cuda, 6)
    _, counts = _check(x, 0.5)
    assert "int8.quantize.relayout" not in counts and counts["int8.quantize.kernel"] == 1


def test_unaligned_input_takes_the_scalar_path(cuda):
    """An NHWC-dense view two bytes into its storage: no 16-byte loads."""
    n, c, h, w = 2, 64, 5, 7
    base = _activation((1, 1, 1, n * c * h * w + 1), torch.bfloat16, 0.5, cuda, 8).reshape(-1)
    x = base[1:].view(n, h, w, c).permute(0, 3, 1, 2)
    assert x.data_ptr() % 16 != 0 and x.permute(0, 2, 3, 1).is_contiguous()
    _check(x, 0.5)
    _check(x, _inv(c, True, cuda, 8))


def test_repeated_calls_count_one_launch_each(cuda):
    x = _activation((1, 16, 4, 4), torch.bfloat16, 0.5, cuda, 9)
    _, counts, _ = traced(lambda: [quantize(x, 0.5) for _ in range(3)])
    assert counts["int8.quantize.kernel"] == 3


def test_an_empty_input_launches_nothing(cuda):
    got, counts, _ = traced(
        lambda: quantize(torch.empty(0, 16, 4, 4, dtype=torch.bfloat16, device=cuda), 0.5))
    assert got.shape == (0, 4, 4, 16) and got.dtype == torch.int8
    assert "int8.quantize.kernel" not in counts


@pytest.mark.parametrize("dtype", [torch.int32, torch.int8, torch.float64])
def test_a_dtype_the_kernel_does_not_take_raises(cuda, dtype):
    x = torch.zeros(1, 8, 2, 2, dtype=dtype, device=cuda)

    def rejected():
        with pytest.raises(TypeError, match="bfloat16, float16 or float32"):
            quantize(x, 1.0)

    _, counts, _ = traced(rejected)
    assert "int8.quantize.kernel" not in counts


def test_a_scale_on_another_device_or_width_raises(cuda):
    x = torch.zeros(1, 8, 2, 2, dtype=torch.bfloat16, device=cuda)
    for inv in (torch.ones(8), torch.ones(4, device=cuda), torch.ones(8, device=cuda).double()):
        with pytest.raises(ValueError, match="float32"):
            quantize(x, inv)


@pytest.mark.parametrize("per_channel", [False, True])
def test_largest_input_of_the_serve_cell(cuda, per_channel):
    """The stem's output at the int8 cell's 96 frames: (96, 128, 256, 256)
    bf16, 805M elements, the grid-stride loop's many steps."""
    inv = _inv(128, True, cuda, 12) if per_channel else 16.0
    g = torch.Generator(device=cuda).manual_seed(12)
    nhwc = torch.randn(96, 256, 256, 128, generator=g, device=cuda, dtype=torch.bfloat16)
    nhwc.mul_(4)
    nhwc.view(-1)[::1000003] = 1.5 / 16  # a tie at the per-tensor scale
    _check(nhwc.permute(0, 3, 1, 2), inv)
