"""Port parity: blocks, hourglass and KeypointNet against the JAX package.

Weights are made by flax (with random BatchNorm statistics and biases so
the bridge is exercised) and handed to the port through
``serving.weights``; the eval forwards must agree to atol 1e-4 in fp32.
The bridge itself must round-trip bit for bit through the JAX package's
``import_keypoint_net``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict, unflatten_dict  # noqa: E402

from object_keypoints_tpu.models import KeypointNet as JKeypointNet  # noqa: E402
from object_keypoints_tpu.models import blocks as jblocks  # noqa: E402
from object_keypoints_tpu.models.hourglass import FireHourglass as JFireHourglass  # noqa: E402
from object_keypoints_tpu.serving.torch_import import import_keypoint_net  # noqa: E402
from object_keypoints_tpu_torch.models import blocks  # noqa: E402
from object_keypoints_tpu_torch.models.hourglass import FireHourglass  # noqa: E402
from object_keypoints_tpu_torch.models.keypoint_net import KeypointNet  # noqa: E402
from object_keypoints_tpu_torch.serving import weights  # noqa: E402

torch.set_num_threads(1)

TINY = dict(heatmaps_out=3, features=8, dropout=0.0, stacks=2, levels=2,
            dims=(8, 8, 16), mods=(1, 1, 1), stem_features=(4, 8), cnv_dim=8)


def randomize(variables, rng):
    """flax variables with random BN scale/bias/mean/var and conv biases
    (init leaves them at identity / zero, which would hide layout errors)."""
    params = flatten_dict(variables["params"])
    for path, v in params.items():
        if path[-1] == "scale":
            params[path] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif path[-1] == "bias":
            params[path] = (rng.normal(size=v.shape) * 0.1).astype(np.float32)
        else:
            params[path] = np.asarray(v)
    stats = flatten_dict(variables.get("batch_stats", {}))
    for path, v in stats.items():
        stats[path] = (rng.normal(size=v.shape) * 0.1 if path[-1] == "mean"
                       else rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
    return {"params": unflatten_dict(params), "batch_stats": unflatten_dict(stats)}


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def export_block(variables, method, *args):
    """One block's JAX variables -> its port state_dict, through the bridge's
    per-block exporter (keys written under a dummy prefix, then stripped)."""
    ex = weights._Exporter(variables)
    getattr(ex, method)("b", (), *args)
    return {k[2:]: torch.from_numpy(np.array(v, order="C")) for k, v in ex.sd.items()}


def run_both(jmod, tmod, method, x, rng, *args):
    variables = randomize(jmod.init({"params": jax.random.key(0)}, jnp.asarray(x)), rng)
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x), train=False))
    tmod.load_state_dict(export_block(variables, method, *args), strict=True)
    with torch.no_grad():
        out = tmod.eval()(nchw(x)).numpy().transpose(0, 2, 3, 1)
    return out, ref


@pytest.mark.parametrize("case", [
    ("convolution", lambda: (jblocks.ConvBlock(8, kernel=3), blocks.ConvBlock(6, 8, 3)), 6, ()),
    ("residual", lambda: (jblocks.Residual(8, stride=2), blocks.Residual(4, 8, stride=2)), 4,
     (True,)),
    ("residual", lambda: (jblocks.Residual(8), blocks.Residual(8, 8)), 8, (False,)),
    ("fire", lambda: (jblocks.FireModule(8), blocks.FireModule(8, 8)), 8, ()),
    ("fire", lambda: (jblocks.FireModule(16, stride=2), blocks.FireModule(8, 16, stride=2)),
     8, ()),
    ("merge_mod", lambda: (jblocks.MergeBN(8), blocks.MergeBN(6, 8)), 6, ()),
], ids=["conv", "residual-skip", "residual-identity", "fire", "fire-s2", "merge"])
def test_block_parity(case):
    method, make, c_in, args = case
    jmod, tmod = make()
    rng = np.random.default_rng(len(method) + c_in)
    x = rng.normal(size=(2, 16, 16, c_in)).astype(np.float32)
    out, ref = run_both(jmod, tmod, method, x, rng, *args)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_fire_hourglass_parity():
    """Two recursion levels, fire up/low paths and the ConvTranspose unpool
    (the flipped flax kernel) at equal weights."""
    rng = np.random.default_rng(11)
    dims, mods = (8, 8, 16), (1, 1, 1)
    jmod, tmod = JFireHourglass(2, dims, mods), FireHourglass(2, dims, mods)
    x = rng.normal(size=(2, 16, 16, 8)).astype(np.float32)
    out, ref = run_both(jmod, tmod, "hg_module", x, rng, 2, mods)
    np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.fixture(scope="module")
def tiny_jax():
    rng = np.random.default_rng(4)
    model = JKeypointNet(**TINY)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    variables = randomize(model.init({"params": jax.random.key(1)}, jnp.asarray(x)), rng)
    return model, variables, x


def test_tiny_keypoint_net_forward_parity(tiny_jax):
    """Eval forward of the whole tiny model: both stacks, all three heads."""
    jmodel, variables, x = tiny_jax
    ref = jmodel.apply(variables, jnp.asarray(x), train=False)
    port = KeypointNet(**TINY)
    port.load_state_dict(weights.keypoint_net_state_dict(variables, stacks=2, levels=2,
                                                         mods=(1, 1, 1)), strict=True)
    with torch.no_grad():
        out = port.eval()(nchw(x))
    for s in range(2):
        np.testing.assert_allclose(out.heatmaps[s].numpy(),
                                   np.asarray(ref.heatmaps[s]).transpose(0, 3, 1, 2), atol=1e-4)
        np.testing.assert_allclose(out.depth[s].numpy(),
                                   np.asarray(ref.depth[s]).transpose(0, 3, 1, 2), atol=1e-4)
        # JAX (N, H, W, T, 2) -> port (N, T, 2, H, W)
        np.testing.assert_allclose(out.centers[s].numpy(),
                                   np.asarray(ref.centers[s]).transpose(0, 3, 4, 1, 2), atol=1e-4)


def test_bridge_round_trip_is_bit_exact(tiny_jax):
    """JAX -> port state_dict -> import_keypoint_net -> JAX gives back every
    leaf bit for bit, and no key is left over either way."""
    _, variables, _ = tiny_jax
    sd = weights.keypoint_net_state_dict(variables, stacks=2, levels=2, mods=(1, 1, 1))
    back = import_keypoint_net(sd, stacks=2, levels=2, mods=(1, 1, 1))
    for col in ("params", "batch_stats"):
        want, got = flatten_dict(variables[col]), flatten_dict(back[col])
        assert set(want) == set(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
            assert got[k].dtype == np.float32


def test_reference_restatement_loads_strictly():
    """The reference-named torch restatement of test_torch_import loads
    into the port with strict=True and runs the same forward."""
    from test_torch_import import TTinyKeypointNet

    torch.manual_seed(0)
    ref_model = TTinyKeypointNet().eval()
    port = KeypointNet(**TINY)
    port.load_state_dict(ref_model.state_dict(), strict=True)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        heat, depth, cent = ref_model(x)
        out = port.eval()(x)
    for s in range(2):
        torch.testing.assert_close(out.heatmaps[s], heat[s], atol=1e-5, rtol=0)
        torch.testing.assert_close(out.depth[s], depth[s], atol=1e-5, rtol=0)
        torch.testing.assert_close(out.centers[s], cent[s].reshape(out.centers[s].shape),
                                   atol=1e-5, rtol=0)


def test_full_geometry_shapes_and_count():
    """Full valve geometry (heatmaps_out=3, features 128): the port's
    state_dict maps one-to-one onto the JAX model's variables, shape for
    shape, and the parameter counts agree (24.95M). No forward runs."""
    jmodel = JKeypointNet(heatmaps_out=3)
    shapes = jax.eval_shape(
        lambda: jmodel.init({"params": jax.random.key(0)}, jnp.zeros((1, 511, 511, 3)),
                            train=False))
    port = KeypointNet(heatmaps_out=3)
    n_port = sum(p.numel() for p in port.parameters())
    n_jax = sum(int(np.prod(v.shape)) for v in flatten_dict(shapes["params"]).values())
    assert n_port == n_jax
    assert round(n_port / 1e6, 2) == 24.95

    mapped = import_keypoint_net(port.state_dict())  # raises on any unmapped key
    for col in ("params", "batch_stats"):
        want = {k: tuple(v.shape) for k, v in flatten_dict(shapes[col]).items()}
        got = {k: tuple(v.shape) for k, v in flatten_dict(mapped[col]).items()}
        assert got == want


def test_heatmap_bias_quirk_and_seeded_init():
    a = KeypointNet(**TINY, generator=torch.Generator().manual_seed(3))
    b = KeypointNet(**TINY, generator=torch.Generator().manual_seed(3))
    for s in ("output_head1", "output_head2"):
        torch.testing.assert_close(a.heatmap_head[s][2].bias, torch.full((3,), 0.01 / 0.99))
        assert torch.count_nonzero(a.depth_head[s][2].bias) == 0
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
