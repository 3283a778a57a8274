"""Port parity: corner pools, the residual hourglass and the CornerNet models
against the JAX package.

Tolerances:
- the four corner pools equal the JAX package's exactly (a running max
  picks values, it computes none); their gradients, at distinct values so
  that each running max has one argmax, equal ``jax.grad``'s within 1e-6
  (each input's gradient sums the same cotangents in another order; seen
  3.6e-7), and are zero exactly where JAX's are;
- the nearest x2 unpool equals ``jax.image.resize(..., "nearest")`` exactly;
- tiny CornerNetModels (fire, residual, saccade, at tests/test_detection.py's
  sizes) with JAX-initialised variables (BatchNorm statistics and biases
  randomized so that the bridge's layouts show) carried across by
  ``serving.weights.cornernet_state_dict``: every train and test output
  within 1e-4 in float32 (seen ~3e-7), the decoded classes equal;
- the bridge: JAX variables -> port state_dict -> JAX variables bit for bit;
  a full-size port state_dict read by the JAX package's own
  ``import_cornernet{,_squeeze,_saccade}`` equals ``cornernet_variables``
  of it bit for bit, with the leaf paths and shapes of the JAX model's init;
- full-size parameter counts equal the JAX factories'.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from object_keypoints_tpu.models.cornernet import (  # noqa: E402
    CornerNetModel as JCornerNetModel,
    cornernet as jcornernet,
    cornernet_saccade as jcornernet_saccade,
    cornernet_squeeze as jcornernet_squeeze,
)
from object_keypoints_tpu.ops import corner_pool as jpool  # noqa: E402
from object_keypoints_tpu.serving import torch_import  # noqa: E402
from object_keypoints_tpu_torch.models import cornernet  # noqa: E402
from object_keypoints_tpu_torch.models.blocks import ConvBlock  # noqa: E402
from object_keypoints_tpu_torch.models.hourglass import upsample_nearest2  # noqa: E402
from object_keypoints_tpu_torch.ops import corner_pool  # noqa: E402
from object_keypoints_tpu_torch.serving import weights  # noqa: E402
from test_torch_port_model import nchw, randomize  # noqa: E402

torch.set_num_threads(1)

POOLS = ["top_pool", "bottom_pool", "left_pool", "right_pool"]

# tests/test_detection.py's tiny models (TestCornerNetModels)
TINY = {
    "fire": dict(stacks=2, levels=2, dims=(16, 16, 32), mods=(1, 1, 1), hourglass="fire",
                 stem_residuals=2, cnv_dim=16),
    "residual": dict(stacks=1, levels=2, dims=(16, 16, 32), mods=(1, 1, 1),
                     hourglass="residual", stem_residuals=1, cnv_dim=16),
    "saccade": dict(stacks=2, levels=2, dims=(16, 16, 32), mods=(1, 1, 1),
                    hourglass="residual", stem_residuals=1, cnv_dim=16, with_attention=True),
}
JAX_IMPORTS = {"CornerNet": torch_import.import_cornernet,
               "CornerNet_Squeeze": torch_import.import_cornernet_squeeze,
               "CornerNet_Saccade": torch_import.import_cornernet_saccade}
JAX_FACTORIES = {"CornerNet": jcornernet, "CornerNet_Squeeze": jcornernet_squeeze,
                 "CornerNet_Saccade": jcornernet_saccade}
PARAMS = {"CornerNet": 201_035_212, "CornerNet_Squeeze": 31_771_852,
          "CornerNet_Saccade": 116_969_339}


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("name", POOLS)
def test_corner_pool_equals_jax(name):
    x = np.random.default_rng(POOLS.index(name)).normal(size=(2, 5, 9, 11)).astype(np.float32)
    got = getattr(corner_pool, name)(torch.from_numpy(x))
    want = np.asarray(getattr(jpool, name)(jnp.asarray(x.transpose(0, 2, 3, 1))))
    np.testing.assert_array_equal(nhwc(got), want)
    module = {"top_pool": corner_pool.TopPool, "bottom_pool": corner_pool.BottomPool,
              "left_pool": corner_pool.LeftPool, "right_pool": corner_pool.RightPool}[name]
    np.testing.assert_array_equal(module()(torch.from_numpy(x)).numpy(), got.numpy())


@pytest.mark.parametrize("name", POOLS)
def test_corner_pool_gradient_equals_jax(name):
    """At distinct values each output has one argmax; the gradient of
    sum(pool(x) * ct) sends each ct to it, in both packages."""
    rng = np.random.default_rng(10 + POOLS.index(name))
    x = rng.permutation(2 * 3 * 7 * 6).reshape(2, 3, 7, 6).astype(np.float32)
    ct = rng.normal(size=x.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    (getattr(corner_pool, name)(xt) * torch.from_numpy(ct)).sum().backward()
    jfn = getattr(jpool, name)
    want = jax.grad(lambda v: jnp.sum(jfn(v) * ct.transpose(0, 2, 3, 1)))(
        jnp.asarray(x.transpose(0, 2, 3, 1)))
    got, want = xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want)
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("hw", [(4, 4), (5, 7)])
def test_nearest_unpool_equals_jax_resize(hw):
    x = np.random.default_rng(sum(hw)).normal(size=(2, 3, *hw)).astype(np.float32)
    got = upsample_nearest2(torch.from_numpy(x))
    xh = jnp.asarray(x.transpose(0, 2, 3, 1))
    want = jax.image.resize(xh, (2, 2 * hw[0], 2 * hw[1], 3), method="nearest")
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))
    # output pixel o reads input pixel o // 2
    np.testing.assert_array_equal(got.numpy(), x.repeat(2, axis=2).repeat(2, axis=3))


def test_conv_block_without_bn_is_a_biased_conv_and_relu():
    block = ConvBlock(3, 4, 3, with_bn=False)
    assert sorted(block.state_dict()) == ["conv.bias", "conv.weight"]
    x = torch.randn(1, 3, 6, 6, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        block.conv.bias.uniform_(-1, 1)
        want = torch.relu(torch.nn.functional.conv2d(x, block.conv.weight, block.conv.bias,
                                                     padding=1))
        torch.testing.assert_close(block(x), want, rtol=0, atol=0)


def jax_tiny(cfg, seed, categories=4, size=64):
    jm = JCornerNetModel(categories=categories, **cfg)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    variables = jm.init({"params": jax.random.key(seed)}, jnp.asarray(x))
    return jm, randomize(jax.tree_util.tree_map(np.asarray, variables), rng), x


def port_from(variables, cfg, categories=4):
    model = cornernet.CornerNetModel(categories, **cfg)
    model.load_state_dict(weights.cornernet_state_dict(variables, cfg), strict=True)
    return model.eval()


@pytest.mark.parametrize("name", sorted(TINY))
def test_tiny_cornernet_train_outputs_match_jax(name):
    cfg = TINY[name]
    jm, variables, x = jax_tiny(cfg, seed=1)
    model = port_from(variables, cfg)
    with torch.no_grad():
        got = model(nchw(x))
    want = jm.apply(variables, jnp.asarray(x))
    assert len(got) == len(want) == (7 if cfg.get("with_attention") else 6)
    for g_list, w_list in zip(got, want):
        assert len(g_list) == len(w_list) == cfg["stacks"]
        for g, w in zip(g_list, w_list):
            if isinstance(g, list):  # per-level attention maps, deepest first
                assert len(g) == len(w) == cfg["levels"]
                for ga, wa in zip(g, w):
                    np.testing.assert_allclose(nhwc(ga), np.asarray(wa), rtol=0, atol=1e-4)
            else:
                np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", sorted(TINY))
def test_tiny_cornernet_test_path_matches_jax(name):
    cfg = TINY[name]
    jm, variables, x = jax_tiny(cfg, seed=2)
    model = port_from(variables, cfg)
    kw = dict(K=10, num_dets=20, kernel=3, ae_threshold=0.5)
    with torch.no_grad():
        got = model(nchw(x), test=True, **kw)
    want = jm.apply(variables, jnp.asarray(x), False, True, **kw)
    if cfg.get("with_attention"):
        (got, got_atts), (want, want_atts) = got, want
        assert len(got_atts) == len(want_atts) == cfg["levels"]
        for g, w in zip(got_atts, want_atts):
            np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=0, atol=1e-4)
    dets, want_dets = got[0].numpy(), np.asarray(want[0])
    assert dets.shape == want_dets.shape == (2, 20, 8)
    np.testing.assert_array_equal(dets[..., 7], want_dets[..., 7])
    np.testing.assert_allclose(dets, want_dets, rtol=0, atol=1e-4)
    for g, w in zip(got[1:], want[1:]):  # the last stack's heats and tags
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", sorted(TINY))
def test_bridge_round_trips_bit_for_bit(name):
    cfg = TINY[name]
    _, variables, _ = jax_tiny(cfg, seed=3)
    back = weights.cornernet_variables(weights.cornernet_state_dict(variables, cfg), cfg)
    want, got = flatten_dict(variables), flatten_dict(back)
    assert set(got) == set(want)
    for path, v in want.items():
        np.testing.assert_array_equal(got[path], v, err_msg=str(path))


@pytest.mark.parametrize("arch", sorted(PARAMS))
def test_full_size_state_dict_reads_through_the_jax_import(arch):
    """The JAX package's own importer reads the port's names as they are,
    into the JAX model's tree."""
    model = cornernet.FACTORIES[arch](generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    imported = flatten_dict(JAX_IMPORTS[arch](sd))
    ours = flatten_dict(weights.cornernet_variables(sd, arch))
    size = 255 if arch == "CornerNet_Saccade" else 127
    shapes = flatten_dict(jax.eval_shape(lambda: JAX_FACTORIES[arch]().init(
        {"params": jax.random.key(0)}, jnp.zeros((1, size, size, 3)))))
    assert set(imported) == set(ours) == set(shapes)
    for path, v in ours.items():
        assert v.shape == shapes[path].shape, path
        np.testing.assert_array_equal(imported[path], v, err_msg=str(path))
    del model, sd, imported, ours


@pytest.mark.parametrize("arch", sorted(PARAMS))
def test_full_size_parameter_counts(arch):
    with torch.device("meta"):
        model = cornernet.FACTORIES[arch]()
    assert sum(p.numel() for p in model.parameters()) == PARAMS[arch]


def test_head_biases_start_at_minus_2_19():
    model = cornernet.tiny_cornernet("CornerNet_Saccade", categories=3,
                                     generator=torch.Generator().manual_seed(0))
    for heads in (model.tl_heats, model.br_heats, *model.att_modules):
        for head in heads:
            torch.testing.assert_close(head[1].bias, torch.full_like(head[1].bias, -2.19))
    for head in (*model.tl_tags, *model.br_offs):
        assert not head[1].bias.any()
    assert model.hg.hgs[0].collect_ups and len(model.att_modules[0]) == 2


def test_seeded_weights_are_reproducible():
    a = cornernet.tiny_cornernet("CornerNet", generator=torch.Generator().manual_seed(5))
    b = cornernet.tiny_cornernet("CornerNet", generator=torch.Generator().manual_seed(5))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
