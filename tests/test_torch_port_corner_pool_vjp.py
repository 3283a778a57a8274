"""The corner pools' backward on the CPU: ``scan_max_vjp``, the two sweeps
the card's kernel runs, against autograd through ``scan_max``.

``scan_max`` is the associative scan JAX differentiates ``cummax`` through
(``tests/test_torch_port_detector_train.py`` holds it to ``jax.grad``);
every pool's backward on a CPU tensor is ``scan_max_vjp``, so each case
runs a pool's forward and backward and compares the input gradient with
autograd's through ``scan_max`` on the same (flipped, for a suffix pool)
line, by ``torch.equal``: each gradient element is a sum of at most two
terms rounded to the dtype, so nothing may differ in float64, float32 or
bfloat16. Maps are tie-heavy integers in [0, 4) and unit normals;
cotangents integers in [-3, 3] and normals scaled over six decades.
"""

import numpy as np
import pytest
import torch

from object_keypoints_tpu_torch.ops import corner_pool
from object_keypoints_tpu_torch.testing import traced

POOLS = {"top_pool": (2, True), "bottom_pool": (2, False), "left_pool": (3, True),
         "right_pool": (3, False)}
LENGTHS = [1, 2, 3, 5, 8, 9, 46, 64, 127, 128]
DTYPES = [torch.float64, torch.float32, torch.bfloat16]


def scan_max_grad(x, ct, dim, reverse):
    """Autograd's gradient through ``scan_max``, flipped for a suffix pool."""
    xd = x.detach().clone().requires_grad_()
    y = scan_max_flipped(xd, dim) if reverse else corner_pool.scan_max(xd, dim)
    (g,) = torch.autograd.grad(y, xd, ct)
    return g


def scan_max_flipped(x, dim):
    return corner_pool.scan_max(x.flip(dim), dim).flip(dim)


def cases(rng, shape, dtype):
    """(map, cotangent) pairs: tie-heavy integer maps with integer and with
    random cotangents, and a random map."""
    ties = rng.integers(0, 4, size=shape).astype(np.float64)
    ints = rng.integers(-3, 4, size=shape).astype(np.float64)
    wide = rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 3, shape)
    normal = rng.standard_normal(shape)
    for x, ct in ((ties, ints), (ties, wide), (normal, wide)):
        yield torch.from_numpy(x).to(dtype), torch.from_numpy(ct).to(dtype)


@pytest.mark.parametrize("length", LENGTHS)
@pytest.mark.parametrize("name", list(POOLS))
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_pool_backward_equals_autograd_through_scan_max(dtype, name, length):
    dim, reverse = POOLS[name]
    shape = [2, 3, 5, 4]
    shape[dim] = length
    rng = np.random.default_rng(length * 10 + list(POOLS).index(name))
    for x, ct in cases(rng, shape, dtype):
        xd = x.clone().requires_grad_()
        out = getattr(corner_pool, name)(xd)
        out.backward(ct)
        want = scan_max_grad(x, ct, dim, reverse)
        assert xd.grad.dtype == dtype
        assert torch.equal(xd.grad, want), (name, length, dtype)
        direct = corner_pool.scan_max_vjp(x.flip(dim), ct.flip(dim), dim).flip(dim) if reverse \
            else corner_pool.scan_max_vjp(x, ct, dim)
        assert torch.equal(direct, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_scan_max_vjp_on_a_short_row_of_ties(dtype):
    """sum(cummax(x)) for x = [1, 3, 3, 2, 3, 0]: a tie splits its cotangent
    along the scan's tree, [1, 2.5, 1.5, 0, 1, 0], as JAX's gradient does."""
    x = torch.tensor([[[[1.0, 3, 3, 2, 3, 0]]]], dtype=dtype)
    got = corner_pool.scan_max_vjp(x, torch.ones_like(x), 3)
    assert got.flatten().tolist() == [1.0, 2.5, 1.5, 0.0, 1.0, 0.0]


def test_scan_max_vjp_keeps_the_strides_it_is_given():
    """A channels_last map and a transposed cotangent: the layout of the
    inputs does not change the result."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 3, size=(2, 4, 9, 7)).astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal((2, 4, 7, 9)).astype(np.float32)).transpose(2, 3)
    want = corner_pool.scan_max_vjp(x, ct.contiguous(), 2)
    got = corner_pool.scan_max_vjp(x.contiguous(memory_format=torch.channels_last), ct, 2)
    assert torch.equal(got, want)


def test_the_cpu_path_launches_nothing():
    """Forward and backward of every pool on a CPU tensor: no kernel launch,
    no counter, no relayout, the two spans."""
    x = torch.randn(2, 4, 6, 5, generator=torch.Generator().manual_seed(0)).to(
        memory_format=torch.channels_last).requires_grad_()
    _, counts, spans = traced(
        lambda: sum(getattr(corner_pool, name)(x).sum() for name in POOLS).backward())
    assert not any(k.startswith("corner_pool.") for k in counts)
    assert spans["corner_pool.forward"] == spans["corner_pool.backward"] == 4
