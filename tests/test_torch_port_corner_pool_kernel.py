"""The corner pools' CUDA kernels against their plain versions, on the card.

A pool on a CUDA tensor launches ``okt_corner_pool_fwd`` and, in its
backward, ``okt_corner_pool_bwd`` (``csrc/corner_pool.cu``); ``utils.timer``
counts both in ``corner_pool.kernel``, and the pool's spans
``corner_pool.forward`` and ``corner_pool.backward`` tell the passes apart.
The forward is
held to ``torch.cummax`` (flipped for a suffix pool) and the backward to
``scan_max_vjp`` run on the same CUDA tensors, both by ``torch.equal``: a
max is exact, and the backward rounds each two-term sum to the dtype as
the eager ops do, so nothing may differ in bfloat16 or float32. Every test
is marked ``gpu`` and skips without a CUDA card: a CUDA kernel has no CPU
mode. The file imports neither jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_port_corner_pool_kernel.py -q
"""

import numpy
import pytest

torch = pytest.importorskip("torch")

from object_keypoints_tpu_torch.ops import corner_pool  # noqa: E402
from object_keypoints_tpu_torch.testing import traced  # noqa: E402

pytestmark = pytest.mark.gpu
POOLS = {"top_pool": (2, True), "bottom_pool": (2, False), "left_pool": (3, True),
         "right_pool": (3, False)}
DTYPES = [torch.bfloat16, torch.float32]
FWD, BWD = "corner_pool.forward", "corner_pool.backward"  # each pass's span
# the train cells' largest pool inputs: CornerNet at batch 49, CornerNet-Squeeze at 55
TRAIN_SHAPES = [(49, 128, 128, 128), (55, 128, 64, 64)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


def cummax(x, dim, reverse):
    if reverse:
        return torch.cummax(x.flip(dim), dim)[0].flip(dim)
    return torch.cummax(x, dim)[0]


def plain_vjp(x, ct, dim, reverse):
    if reverse:
        return corner_pool.scan_max_vjp(x.flip(dim), ct.flip(dim), dim).flip(dim)
    return corner_pool.scan_max_vjp(x, ct, dim)


def maps(shape, dtype, device, seed, ties):
    """A channels_last map and a cotangent: integers in [0, 4) with
    integer cotangents in [-3, 3] (ties everywhere), or unit normals with
    normal cotangents."""
    g = torch.Generator(device=device).manual_seed(seed)
    n, c, h, w = shape
    if ties:
        x = torch.randint(0, 4, (n, h, w, c), generator=g, device=device)
        ct = torch.randint(-3, 4, (n, h, w, c), generator=g, device=device)
    else:
        x = torch.randn((n, h, w, c), generator=g, device=device)
        ct = torch.randn((n, h, w, c), generator=g, device=device)
    return x.to(dtype).permute(0, 3, 1, 2), ct.to(dtype).permute(0, 3, 1, 2)


def run_pool(name, x, ct):
    """One forward and one backward: (output, input gradient), and the
    counts and spans they made."""
    xd = x.detach().requires_grad_()

    def both():
        out = getattr(corner_pool, name)(xd)
        out.backward(ct)
        return out.detach()

    out, counts, spans = traced(both)
    return out, xd.grad, counts, spans


def check(name, x, ct):
    """A forward and a backward, one launch each; the counts."""
    dim, reverse = POOLS[name]
    out, grad, counts, spans = run_pool(name, x, ct)
    assert counts.get("corner_pool.kernel") == 2 and spans == {FWD: 1, BWD: 1}
    assert out.dtype == grad.dtype == x.dtype
    assert out.permute(0, 2, 3, 1).is_contiguous()
    assert torch.equal(out, cummax(x, dim, reverse)), (name, tuple(x.shape), x.dtype)
    assert torch.equal(grad, plain_vjp(x, ct, dim, reverse)), (name, tuple(x.shape), x.dtype)
    return counts


@pytest.mark.parametrize("shape", [(2, 8, 33, 46), (1, 3, 7, 5), (3, 33, 1, 2), (2, 128, 9, 127),
                                   (1, 40, 300, 3), (1, 8, 2, 1)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", list(POOLS))
def test_kernels_equal_their_plain_versions(cuda, name, dtype, shape):
    """Channels a multiple of 8 (16-byte loads) and not (3, 33: one element
    a thread), lines of 1 to 300, odd and even, partial channel tiles."""
    for ties in (True, False):
        check(name, *maps(shape, dtype, cuda, sum(shape) + ties, ties))


@pytest.mark.parametrize("shape", TRAIN_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("name", list(POOLS))
def test_kernels_at_the_train_cells_shapes(cuda, name, dtype, shape):
    for ties in (True, False):
        check(name, *maps(shape, dtype, cuda, shape[0] + ties, ties))


@pytest.mark.parametrize("name", list(POOLS))
def test_the_longest_line(cuda, name):
    """A line of MAX_LINE: the backward's narrowest channel tile."""
    dim, _ = POOLS[name]
    shape = [1, 3, 2, 2]
    shape[dim] = corner_pool.MAX_LINE
    for dtype in DTYPES:
        check(name, *maps(tuple(shape), dtype, cuda, 7, True))


def test_a_longer_line_raises(cuda):
    x = torch.zeros(1, 2, 1, corner_pool.MAX_LINE + 1, dtype=torch.bfloat16, device=cuda)

    def rejected():
        with pytest.raises(ValueError, match=str(corner_pool.MAX_LINE)):
            corner_pool.right_pool(x.requires_grad_())

    _, counts, _ = traced(rejected)
    assert "corner_pool.kernel" not in counts
    # no gradient asked: the forward takes any length
    out, counts, spans = traced(lambda: corner_pool.right_pool(x.detach()))
    assert counts.get("corner_pool.kernel") == 1 and spans == {FWD: 1} and torch.equal(out, x)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_a_dtype_the_kernels_do_not_take_raises(cuda, dtype):
    x = torch.zeros(1, 8, 4, 4, dtype=dtype, device=cuda)

    def rejected():
        with pytest.raises(TypeError, match="bfloat16 or float32"):
            corner_pool.top_pool(x)

    _, counts, _ = traced(rejected)
    assert "corner_pool.kernel" not in counts


def test_channels_last_input_is_not_relaid(cuda):
    x, ct = maps((2, 16, 9, 11), torch.bfloat16, cuda, 3, False)
    counts = check("left_pool", x, ct)
    assert counts == {"corner_pool.kernel": 2}


def test_nchw_input_is_relaid_once_and_counted(cuda):
    x, ct = maps((2, 16, 9, 11), torch.bfloat16, cuda, 4, True)
    x = x.contiguous()
    assert not x.permute(0, 2, 3, 1).is_contiguous()
    counts = check("top_pool", x, ct)
    assert counts == {"corner_pool.kernel": 2, "corner_pool.relayout": 1}
    counts = check("bottom_pool", x, ct.contiguous())
    assert counts == {"corner_pool.kernel": 2, "corner_pool.relayout": 2}  # the cotangent too


def test_an_empty_map_launches_nothing(cuda):
    x = torch.zeros(0, 8, 4, 4, dtype=torch.bfloat16, device=cuda, requires_grad=True)

    def both():
        out = corner_pool.right_pool(x)
        out.sum().backward()
        return out

    out, counts, _ = traced(both)
    assert out.shape == x.shape and x.grad.shape == x.shape
    assert "corner_pool.kernel" not in counts


def test_a_tiny_train_step_launches_sixteen(cuda):
    """A bf16 train step of a small two-stack CornerNet-Squeeze (two
    corners a stack, two pools each): 8 forward and 8 backward launches, no
    relayout."""
    from object_keypoints_tpu_torch.data.detection_targets import render_corner_targets
    from object_keypoints_tpu_torch.models.cornernet import CornerNetModel
    from object_keypoints_tpu_torch.training import detection
    from object_keypoints_tpu_torch.utils.config import SystemConfig

    rng = numpy.random.default_rng(0)
    targets = []
    for _ in range(2):
        dets = numpy.array([[8, 10, 30, 28, 1]], numpy.float32)
        targets.append(render_corner_targets(dets, 80, (64, 64), (16, 16), gaussian_iou=0.3))
    batch = {k: numpy.stack([t[k] for t in targets]) for k in targets[0]}
    batch["images"] = rng.normal(size=(2, 64, 64, 3)).astype(numpy.float32)
    state = detection.create_train_state(
        CornerNetModel(80, stacks=2, levels=2, dims=(16, 16, 32), mods=(1, 1, 1),
                       hourglass="fire", stem_residuals=1, cnv_dim=16,
                       generator=torch.Generator().manual_seed(0)),
        detection.make_detection_optimizer(SystemConfig()), torch.bfloat16, device=cuda)
    state, _ = detection.detection_train_step(state, batch)  # warm
    torch.cuda.synchronize()
    _, counts, spans = traced(lambda: detection.detection_train_step(state, batch))
    assert spans[FWD] == 8 and spans[BWD] == 8
    assert counts.get("corner_pool.kernel") == 16
    assert "corner_pool.relayout" not in counts
