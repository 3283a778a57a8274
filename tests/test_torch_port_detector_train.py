"""Port parity for CornerNet detector training: the corner pools' gradient,
the CornerNet losses, the optimizer, the train steps, the loop and the CLIs,
against the JAX package.

Inputs are made from numpy seeds; the tiny detectors (a fire CornerNet and
a residual CornerNet-Saccade with attention, two stacks each, 3 classes,
64x64 input) start from the same JAX init (BatchNorm statistics and biases
randomized) through ``serving.weights.cornernet_state_dict``.

Tolerances, with what they were set from:
- corner pools: forward equal to ``torch.cummax`` and to the JAX pools
  exactly; gradients equal to ``jax.grad``'s exactly in float64 on
  integer-valued inputs with many ties and integer cotangents (every sum is
  exact, so the order of summation cannot hide a difference), at odd and
  even lengths, along H and W, prefix and suffix; in bf16 too. A control
  shows ``torch.cummax``'s own gradient differs from JAX's on those inputs;
- losses: each function's value and its gradient with respect to every head
  within rel 1e-5 (float32; of each gradient tensor's largest element) and
  1e-10 (float64), including no positives, an all-false tag mask and the
  saccade validity masks. bf16 heads: the port's loss is the float32 loss
  of their float32 casts, exactly; JAX's bf16 focal loss is infinite on
  saturated logits, the port's equals JAX's float32 loss (rel 1e-6);
- optimizer against optax: adam and sgd over 8 steps across two stepsize
  boundaries, from count 0 and from a resume at count 4 (both of optax's
  counts replayed): the schedule equal exactly, the parameters within
  rtol 1e-6 / atol 1e-8 in float32 and 1e-14 in float64;
- one train step (float64, ``jax.enable_x64``): loss rel 1e-7, with SGD at
  lr 1 the gradient (p - p') within 1e-6 of each tensor's largest (flax's
  E[x^2] - E[x]^2 batch variance against torch's two passes, as in the keypoint
  step), with Adam the parameters within 1e-9 where |g| is above 1e-3 of
  its tensor's largest and 1e-4, the running statistics rel 1e-8. In
  float32: the loss rel 1e-5, the running statistics rel 1e-3, the
  parameters within 1e-6 where |g| is above a fifth of its tensor's largest
  (Adam's first step is lr * sign(g) there). bf16: the port's bf16 step
  loss within rel 2e-2 of JAX's float32 loss over its bf16 heads (the two
  bf16 forwards round differently);
- the loop's display messages equal JAX's for the same losses; a snapshot
  the port writes gives the JAX test-mode forward the port's boxes (1e-4).
"""

import copy
import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from object_keypoints_tpu.models.cornernet import CornerNetModel as JCornerNetModel  # noqa: E402
from object_keypoints_tpu.ops import corner_pool as jpool  # noqa: E402
from object_keypoints_tpu.training import detection as jdet  # noqa: E402
from object_keypoints_tpu.training import losses as jlosses  # noqa: E402
from object_keypoints_tpu.training.trainer import TrainState as JTrainState  # noqa: E402
from object_keypoints_tpu.utils.config import SystemConfig as JSystemConfig  # noqa: E402
from object_keypoints_tpu_torch.cli import evaluate_detector  # noqa: E402
from object_keypoints_tpu_torch.cli import train_detector as cli  # noqa: E402
from object_keypoints_tpu_torch.data.coco import CocoDetectionDataset  # noqa: E402
from object_keypoints_tpu_torch.data.detection_targets import (  # noqa: E402
    render_corner_targets,
    saccade_sample,
)
from object_keypoints_tpu_torch.data.synthetic import make_synthetic_coco_dataset  # noqa: E402
from object_keypoints_tpu_torch.models import cornernet  # noqa: E402
from object_keypoints_tpu_torch.ops import corner_pool  # noqa: E402
from object_keypoints_tpu_torch.serving import weights  # noqa: E402
from object_keypoints_tpu_torch.training import detection, losses  # noqa: E402
from object_keypoints_tpu_torch.utils.config import (  # noqa: E402
    CONFIG_DIR,
    DetectionConfig,
    SystemConfig,
    load_cfg,
    tiny_db_overrides,
)
from test_torch_port_model import randomize  # noqa: E402

torch.set_num_threads(1)

POOLS = ["top_pool", "bottom_pool", "left_pool", "right_pool"]
CATS = 3
SQUEEZE = dict(stacks=2, levels=2, dims=(16, 16, 32), mods=(1, 1, 1), hourglass="fire",
               stem_residuals=2, cnv_dim=16)
SACCADE = dict(stacks=2, levels=2, dims=(16, 16, 32), mods=(1, 1, 1), hourglass="residual",
               stem_residuals=1, cnv_dim=16, with_attention=True)


def nhwc(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 2, 3, 1))


# --------------------------------------------------------- the corner pools


def tie_input(rng, shape, dtype=np.float64):
    return rng.integers(0, 4, size=shape).astype(dtype)


def pool_grads(name, x, ct, fn=None):
    xt = torch.tensor(x, requires_grad=True)
    out = (fn or getattr(corner_pool, name))(xt)
    (out * torch.tensor(ct)).sum().backward()
    jfn = getattr(jpool, name)
    want = jax.jit(jax.grad(lambda v: jnp.sum(jfn(v) * jnp.asarray(nhwc(ct)))))(
        jnp.asarray(nhwc(x)))
    return out.detach(), xt.grad, np.asarray(want).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("hw", [(6, 7), (7, 6), (33, 64), (1, 2)], ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("name", POOLS)
def test_corner_pool_gradient_equals_jax_on_ties(name, hw):
    rng = np.random.default_rng(POOLS.index(name) * 100 + hw[0])
    x = tie_input(rng, (2, 3, *hw))
    ct = rng.integers(-3, 4, size=x.shape).astype(np.float64)
    with jax.enable_x64(True):
        out, got, want = pool_grads(name, x, ct)
        forward = np.asarray(getattr(jpool, name)(jnp.asarray(nhwc(x)))).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(out.numpy(), forward)
    dim = 2 if name in ("top_pool", "bottom_pool") else 3
    reverse = name in ("top_pool", "left_pool")
    xt = torch.tensor(x)
    cummax = (torch.cummax(xt.flip(dim), dim)[0].flip(dim) if reverse
              else torch.cummax(xt, dim)[0])
    assert torch.equal(out, cummax)


@pytest.mark.parametrize("name", POOLS)
def test_corner_pool_bf16_gradient_equals_jax(name):
    rng = np.random.default_rng(7 + POOLS.index(name))
    x = tie_input(rng, (1, 4, 9, 10), np.float32)
    ct = rng.integers(-3, 4, size=x.shape).astype(np.float32)
    xt = torch.tensor(x, dtype=torch.bfloat16, requires_grad=True)
    (getattr(corner_pool, name)(xt) * torch.tensor(ct, dtype=torch.bfloat16)).sum().backward()
    jfn = getattr(jpool, name)
    want = jax.jit(jax.grad(lambda v: jnp.sum(jfn(v) * jnp.asarray(nhwc(ct), jnp.bfloat16))))(
        jnp.asarray(nhwc(x), jnp.bfloat16))
    assert xt.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  np.asarray(want, np.float32).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("name", POOLS)
def test_torch_cummax_gradient_differs_from_jax_on_ties(name):
    """The control: ``torch.cummax``'s backward gives a tied running max's
    whole gradient to one index, so on these inputs it misses JAX's."""
    dim = 2 if name in ("top_pool", "bottom_pool") else 3

    def plain(x):
        if name in ("top_pool", "left_pool"):
            return torch.cummax(x.flip(dim), dim)[0].flip(dim)
        return torch.cummax(x, dim)[0]

    rng = np.random.default_rng(3)
    x = tie_input(rng, (2, 3, 7, 6))
    ct = np.ones_like(x)
    with jax.enable_x64(True):
        _, got, want = pool_grads(name, x, ct, fn=plain)
    assert not np.array_equal(got.numpy(), want)


def test_corner_pool_gradient_on_a_short_row_of_ties():
    """sum(cummax(x)) for x = [1, 3, 3, 2, 3, 0]: JAX gives [1, 2.5, 1.5, 0,
    1, 0] (a tie splits its cotangent), torch.cummax [1, 1, 2, 0, 2, 0]."""
    x = torch.tensor([[[[1.0, 3, 3, 2, 3, 0]]]], dtype=torch.float64, requires_grad=True)
    corner_pool.right_pool(x).sum().backward()
    assert x.grad.flatten().tolist() == [1.0, 2.5, 1.5, 0.0, 1.0, 0.0]


# ----------------------------------------------------------------- the loss


def loss_case(case, dtype, n=2, h=8, w=8, m=6, stacks=2):
    """Per-stack heads in the port's layout and the targets."""
    rng = np.random.default_rng({"random": 0, "no_positives": 1, "empty_mask": 2}[case])
    heats = [[(rng.normal(size=(n, CATS, h, w)) * 3).astype(dtype) for _ in range(stacks)]
             for _ in range(2)]
    tags = [[rng.normal(size=(n, m)).astype(dtype) for _ in range(stacks)] for _ in range(2)]
    offs = [[(rng.normal(size=(n, m, 2)) * 0.8).astype(dtype) for _ in range(stacks)]
            for _ in range(2)]
    gt_heats = []
    for _ in range(2):
        g = rng.uniform(size=(n, CATS, h, w))
        g = np.where(g > 0.6, g, 0.0)
        if case != "no_positives":
            g[rng.uniform(size=g.shape) > 0.9] = 1.0
        gt_heats.append(g.astype(dtype))
    mask = rng.uniform(size=(n, m)) > 0.4
    mask[0, 0] = True
    if case == "empty_mask":
        mask[:] = False
    gt_offs = [rng.uniform(size=(n, m, 2)).astype(dtype) for _ in range(2)]
    valids = [(rng.uniform(size=(n, CATS, h, w)) > 0.2).astype(dtype) for _ in range(2)]
    atts = [[(rng.normal(size=(n, 1, s, s)) * 3).astype(dtype) for s in (4, 8)]
            for _ in range(stacks)]
    gt_atts = [(rng.uniform(size=(n, 1, s, s)) > 0.85).astype(dtype) for s in (4, 8)]
    return dict(heats=heats, tags=tags, offs=offs, gt_heats=gt_heats, mask=mask,
                gt_offs=gt_offs, valids=valids, atts=atts, gt_atts=gt_atts)


def _sig(lib):
    return (lambda x: losses._clamped_sigmoid(x)) if lib == "torch" else jlosses._clamped_sigmoid


def loss_fn(name, lib, c):
    """(function of the flat differentiable heads, their port-layout arrays,
    which of them are maps); the targets are closed over, in ``lib``'s
    layout."""
    mod, tt = (losses, torch.tensor) if lib == "torch" else (jlosses, jnp.asarray)
    nhwc_ = (lambda a: a) if lib == "torch" else nhwc
    sig = _sig(lib)
    mask = tt(c["mask"])
    gt_heat = [tt(nhwc_(g)) for g in c["gt_heats"]]
    gt_off = [tt(g) for g in c["gt_offs"]]
    valid = [tt(nhwc_(v)) for v in c["valids"]]
    gt_atts = [tt(nhwc_(a)) for a in c["gt_atts"]]
    stacks = len(c["heats"][0])
    if name == "focal":
        return (lambda *hs: mod.focal_loss([sig(h) for h in hs], gt_heat[0]),
                c["heats"][0], [True] * stacks)
    if name == "focal_masked":
        return (lambda *hs: mod.focal_loss_masked([sig(h) for h in hs], gt_heat[0], valid[0]),
                c["heats"][0], [True] * stacks)
    if name in ("ae_pull", "ae_push"):
        k = name == "ae_push"
        return (lambda a, b: mod.ae_loss(a, b, mask)[k], [c["tags"][0][0], c["tags"][1][0]],
                [False, False])
    if name == "offset":
        return (lambda o: mod.offset_loss(o, gt_off[0], mask), [c["offs"][0][0]], [False])
    flat = [*c["heats"][0], *c["heats"][1], *c["tags"][0], *c["tags"][1], *c["offs"][0],
            *c["offs"][1]]
    maps = [True] * (2 * stacks) + [False] * (4 * stacks)
    if name == "saccade":
        flat += [a for stack in c["atts"] for a in stack]
        maps += [True] * (2 * stacks)

    def whole(*xs):
        groups = [list(xs[i * stacks:(i + 1) * stacks]) for i in range(6)]
        targets = (gt_heat[0], gt_heat[1], mask, gt_off[0], gt_off[1])
        if name == "cornernet":
            return mod.cornernet_loss(tuple(groups), targets)
        atts = [list(xs[6 * stacks + 2 * s:6 * stacks + 2 * s + 2]) for s in range(stacks)]
        return mod.cornernet_saccade_loss((*groups, atts),
                                          (*targets, valid[0], valid[1], gt_atts))

    return whole, flat, maps


def run_loss(name, c, dtype):
    fn, arrays, maps = loss_fn(name, "torch", c)
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    value = fn(*ts)
    grads = torch.autograd.grad(value, ts, allow_unused=True)
    jf, jarrays, _ = loss_fn(name, "jax", c)
    js = [jnp.asarray(nhwc(a) if m else a) for a, m in zip(jarrays, maps)]
    jvalue, jgrads = jax.value_and_grad(jf, argnums=tuple(range(len(js))))(*js)
    jgrads = [np.asarray(g).transpose(0, 3, 1, 2) if m else np.asarray(g)
              for g, m in zip(jgrads, maps)]
    return value, grads, np.asarray(jvalue), jgrads


LOSSES = ["focal", "focal_masked", "ae_pull", "ae_push", "offset", "cornernet", "saccade"]


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("case", ["random", "no_positives", "empty_mask"])
@pytest.mark.parametrize("name", LOSSES)
def test_cornernet_losses_match_jax(name, case, dtype):
    c = loss_case(case, dtype)
    rel = 1e-5 if dtype == np.float32 else 1e-10
    with jax.enable_x64(dtype == np.float64):
        value, grads, jvalue, jgrads = run_loss(name, c, dtype)
    assert value.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    np.testing.assert_allclose(value.item(), float(jvalue), rtol=rel, atol=rel * 1e-3)
    for i, (g, jg) in enumerate(zip(grads, jgrads)):
        g = np.zeros_like(jg) if g is None else g.numpy()
        np.testing.assert_allclose(g, jg, rtol=0, atol=rel * max(np.abs(jg).max(), 1e-30),
                                   err_msg=f"{name} gradient {i}")
    if case == "empty_mask" and name in ("ae_pull", "ae_push", "offset"):
        assert value.item() == 0.0
    if case == "no_positives" and name == "focal":
        assert not (c["gt_heats"][0] == 1).any() and value.item() > 0


def test_bf16_heads_give_the_float32_loss_of_their_casts():
    c = loss_case("random", np.float32)
    fn, arrays, _ = loss_fn("saccade", "torch", c)
    bf16 = [torch.tensor(a).bfloat16() for a in arrays]
    got = fn(*bf16)
    assert got.dtype == torch.float32
    assert got.item() == fn(*(t.float() for t in bf16)).item()


def test_jax_bf16_focal_loss_is_inf_where_the_ports_is_finite():
    """The JAX package's bf16 loss clamps at 1 - 1e-4, which rounds to 1 in
    bf16, so log(1 - p) is -inf once a heat logit passes ~6.2; the port
    computes the loss in float32 on the float32 casts of the bf16 heads."""
    logits = np.array([0.0, 4.0, 7.0, 12.0], np.float32).reshape(1, 1, 2, 2)
    gt = np.array([0.0, 0.5, 1.0, 0.0], np.float32).reshape(1, 1, 2, 2)
    jx16 = jnp.asarray(nhwc(logits), jnp.bfloat16)
    jloss16, jgrad16 = jax.value_and_grad(lambda x: jlosses.focal_loss(
        [jlosses._clamped_sigmoid(x)], jnp.asarray(nhwc(gt), jnp.bfloat16)))(jx16)
    assert np.isinf(float(jloss16)) and np.isnan(np.asarray(jgrad16, np.float32)).any()
    want = jlosses.focal_loss([jlosses._clamped_sigmoid(jx16.astype(jnp.float32))],
                              jnp.asarray(nhwc(gt)))
    x = torch.tensor(logits, dtype=torch.bfloat16, requires_grad=True)
    loss = losses.focal_loss([losses._clamped_sigmoid(x)], torch.tensor(gt).bfloat16())
    loss.backward()
    assert loss.dtype == torch.float32 and torch.isfinite(x.grad.float()).all()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-6)
    assert np.isfinite(loss.item())


# ------------------------------------------------------------ the optimizer


def configs(**kw):
    return SystemConfig(**kw), JSystemConfig(**kw)


def test_schedule_equals_jax_exactly():
    for lr, stepsize, rate in [(2.5e-4, 5, 10), (2.5e-3, 3, 10), (1e-3, 4, 3), (7e-4, 2, 10.0)]:
        ours, theirs = (detection.step_decay_schedule(lr, stepsize, rate),
                        jdet.step_decay_schedule(lr, stepsize, rate))
        for count in range(0, 12):
            assert ours(count) == float(theirs(jnp.asarray(count, jnp.int32))), (lr, count)
        with jax.enable_x64(True):
            for count in range(0, 12):
                assert ours(count, np.float64) == float(theirs(jnp.asarray(count, jnp.int32)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("start", [0, 4], ids=["fresh", "resume"])
@pytest.mark.parametrize("algo", ["adam", "sgd"])
def test_detection_optimizer_matches_optax(algo, start, dtype):
    """8 steps of seeded gradients, stepsize 3: the learning rate drops
    twice; a resume sets both of optax's counts (tree_set) and the port's
    one count."""
    ours_cfg, jax_cfg = configs(learning_rate=0.05, stepsize=3, decay_rate=10, opt_algo=algo)
    rng = np.random.default_rng(11)
    shapes = [(4, 3), (7,), (2, 2, 3)]
    params = [rng.normal(size=s).astype(dtype) for s in shapes]
    with jax.enable_x64(dtype == np.float64):
        tx = jdet.make_detection_optimizer(jax_cfg)
        jparams = [jnp.asarray(p) for p in params]
        jstate = tx.init(jparams)
        if start:
            jstate = optax.tree_utils.tree_set(jstate, count=jnp.asarray(start, jnp.int32))
        opt = detection.make_detection_optimizer(ours_cfg)
        tparams = [torch.tensor(p) for p in params]
        state = opt.init(tparams)
        state.count = start
        for _ in range(8):
            grads = [rng.normal(size=s).astype(dtype) for s in shapes]
            updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jparams)
            jparams = optax.apply_updates(jparams, updates)
            opt.step(tparams, [torch.tensor(g) for g in grads], state)
            for got, want in zip(tparams, jparams):
                assert got.dtype == torch.from_numpy(np.array(want)).dtype
                if dtype == np.float32:
                    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-8)
                else:
                    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-14)
    assert state.count == start + 8


def test_unknown_opt_algo_raises():
    with pytest.raises(ValueError, match="unknown opt_algo"):
        detection.make_detection_optimizer(SystemConfig(opt_algo="rmsprop"))


# ---------------------------------------------------------- the train steps


def image_dets(rng, size=64):
    n = int(rng.integers(1, 4))
    x0, y0 = rng.uniform(0, size - 20, n), rng.uniform(0, size - 20, n)
    bw, bh = rng.uniform(6, 18, n), rng.uniform(6, 18, n)
    return np.stack([x0, y0, x0 + bw, y0 + bh, rng.integers(1, CATS + 1, n)], 1).astype(np.float32)


def detection_batch(seed, n=2, out=8):
    """64x64 images; SQUEEZE's two stem residuals give 8x8 maps, the --tiny
    model's one 16x16."""
    rng = np.random.default_rng(seed)
    ts = [render_corner_targets(image_dets(rng), CATS, (64, 64), (out, out), gaussian_iou=0.3,
                                max_tag_len=8) for _ in range(n)]
    batch = {k: np.stack([t[k] for t in ts]) for k in ts[0]}
    batch["images"] = rng.normal(size=(n, 64, 64, 3)).astype(np.float32)
    return batch


def saccade_db():
    _, db = load_cfg(CONFIG_DIR / "CornerNet_Saccade.json")
    return DetectionConfig({**db, **tiny_db_overrides("CornerNet_Saccade"), "categories": CATS,
                            "min_scale": 4})


def saccade_batch(seed, n=2):
    rng = np.random.default_rng(seed)
    images, ts = [], []
    for _ in range(n):
        image = rng.integers(0, 255, (96, 128, 3)).astype(np.uint8)
        img, t = saccade_sample(image, image_dets(rng, 96), saccade_db(), rng, max_tag_len=8)
        images.append(((img.astype(np.float32) / 255.0) - 0.45) / 0.28)
        ts.append(t)
    batch = {k: np.stack([t[k] for t in ts]) for k in ts[0] if k != "attentions"}
    batch["attentions"] = tuple(np.stack([t["attentions"][i] for t in ts]) for i in range(2))
    batch["images"] = np.stack(images)
    return batch


ARCHS = {"squeeze": (SQUEEZE, detection_batch, jdet.detection_train_step,
                     detection.detection_train_step),
         "saccade": (SACCADE, saccade_batch, jdet.saccade_train_step,
                     detection.saccade_train_step)}


def jax_variables(cfg):
    """The JAX init of ``cfg`` (key 1), BatchNorm and biases randomized; made
    once a configuration (an eager flax init takes seconds)."""
    return _jax_variables(tuple(sorted(cfg.items())))


@functools.lru_cache(maxsize=None)
def _jax_variables(items):
    jm = JCornerNetModel(categories=CATS, **dict(items))
    variables = jm.init({"params": jax.random.key(1)}, jnp.zeros((1, 64, 64, 3)))
    return randomize(jax.tree_util.tree_map(np.asarray, variables), np.random.default_rng(1))


STEP_OPT = dict(learning_rate=1e-2, stepsize=3)  # a resume at 4 starts one decay in


def port_state(variables, cfg, dtype=torch.float32):
    model = cornernet.CornerNetModel(CATS, **cfg)
    model.load_state_dict(weights.cornernet_state_dict(variables, cfg), strict=True)
    if dtype == torch.float64:
        model.double()
    optimizer = detection.make_detection_optimizer(SystemConfig(**STEP_OPT))
    return detection.create_train_state(model, optimizer, dtype, device="cpu")


@functools.lru_cache(maxsize=None)
def jax_model(name, dtype):
    """One JAX model object per configuration, so that its jitted steps are
    compiled once."""
    return JCornerNetModel(categories=CATS, **ARCHS[name][0], dtype=dtype)


@functools.lru_cache(maxsize=None)
def jax_tx(algo="adam", learning_rate=STEP_OPT["learning_rate"], stepsize=STEP_OPT["stepsize"]):
    return jdet.make_detection_optimizer(JSystemConfig(opt_algo=algo, learning_rate=learning_rate,
                                                       stepsize=stepsize))


def jax_step(name, variables, batch, dtype, start=0, **opt):
    """One JAX step from ``variables`` at optimizer count ``start`` (set as
    the JAX loop's resume sets it): (loss, state_dict of its parameters and
    batch statistics in the port's layout)."""
    jm, tx = jax_model(name, dtype), jax_tx(**opt)
    v = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), dtype), variables)
    opt_state = tx.init(v["params"])
    if start:  # distinct buffers: the jitted step donates each leaf
        opt_state = jax.tree.map(jnp.copy, optax.tree_utils.tree_set(
            opt_state, count=jnp.asarray(start, jnp.int32)))
    state = JTrainState(step=jnp.asarray(start, jnp.int32), params=v["params"],
                        batch_stats=v["batch_stats"], opt_state=opt_state, tx=tx)
    jbatch = {k: (tuple(jnp.asarray(a, dtype) for a in b) if isinstance(b, tuple)
                  else jnp.asarray(b, dtype) if b.dtype == np.float32 else jnp.asarray(b))
              for k, b in batch.items()}
    state, metrics = ARCHS[name][2](jm, state, jbatch)
    want = weights.cornernet_state_dict({"params": state.params,
                                         "batch_stats": state.batch_stats}, ARCHS[name][0])
    return float(metrics["loss"]), want


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_train_step_float64_matches_jax(name):
    """The loss, every gradient (JAX's from an SGD step at lr 1: p - p'),
    the running statistics, and the port's Adam update of its gradients
    against optax's Adam update of JAX's."""
    cfg, make_batch, _, _ = ARCHS[name]
    batch = make_batch(0)
    variables = jax_variables(cfg)
    state = port_state(variables, cfg, torch.float64)
    names = [k for k, _ in state.model.named_parameters()]
    before = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    loss, grads = detection.loss_and_grads(state, batch, saccade=name == "saccade")
    state.tx.step(state.params, grads, state.opt_state)
    with jax.enable_x64(True):
        jloss, want = jax_step(name, variables, batch, jnp.float64, algo="sgd", learning_rate=1.0)
        jgrads = [before[k] - want[k] for k in names]
        tx = jax_tx()

        @jax.jit
        def adam_step(g, p):
            return optax.apply_updates(p, tx.update(g, tx.init(p), p)[0])

        adam = [torch.from_numpy(np.asarray(p)) for p in adam_step(
            [jnp.asarray(g.numpy()) for g in jgrads], [jnp.asarray(before[k].numpy()) for k in names])]
    assert loss.dtype == torch.float64
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-7)
    for key, param, g, want_g, want_p in zip(names, state.params, grads, jgrads, adam):
        torch.testing.assert_close(g, want_g, rtol=0, atol=1e-6 * want_g.abs().max().item() + 1e-30,
                                   msg=lambda m: f"{key}: {m}")
        moved = g.abs() > max(1e-3 * g.abs().max().item(), 1e-4)
        assert param.dtype == want_p.dtype == torch.float64
        torch.testing.assert_close(param.detach()[moved], want_p[moved], rtol=0, atol=1e-9,
                                   msg=lambda m: f"{key}: {m}")
    for key, buf in state.model.named_buffers():
        if "running" in key:
            torch.testing.assert_close(buf, want[key], rtol=1e-8, atol=1e-12,
                                       msg=lambda m: f"{key}: {m}")


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_train_step_float32_matches_jax(name):
    cfg, make_batch, _, step = ARCHS[name]
    batch = make_batch(1)
    variables = jax_variables(cfg)
    state = port_state(variables, cfg)
    probe = copy.deepcopy(state)
    _, grads = detection.loss_and_grads(probe, batch, saccade=name == "saccade")
    state, metrics = step(state, batch)
    assert state.step == 1 and state.opt_state.count == 1
    assert metrics["loss"].dtype == torch.float32 and metrics["loss"].dim() == 0
    jloss, want = jax_step(name, variables, batch, jnp.float32)
    np.testing.assert_allclose(metrics["loss"].item(), jloss, rtol=1e-5)
    for (key, param), g in zip(state.model.named_parameters(), grads):
        big = g.abs() > 0.2 * g.abs().max()
        torch.testing.assert_close(param.detach()[big], want[key][big], rtol=0, atol=1e-6,
                                   msg=lambda m: f"{key}: {m}")
    for key, buf in state.model.named_buffers():
        if "running" in key:
            torch.testing.assert_close(buf, want[key], rtol=1e-3, atol=1e-6,
                                       msg=lambda m: f"{key}: {m}")


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_bf16_train_step_loss_matches_jax_float32_loss_of_its_bf16_heads(name):
    """The port's bf16 step against JAX's bf16 forward with its loss taken
    over the float32 casts of the heads (JAX's own bf16 loss is wrong where
    logits saturate: test_jax_bf16_focal_loss_is_inf_where_the_ports_is_finite)."""
    cfg, make_batch, _, step = ARCHS[name]
    batch = make_batch(2)
    variables = jax_variables(cfg)
    state = port_state(variables, cfg, torch.bfloat16)
    state, metrics = step(state, batch)
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    jm = jax_model(name, jnp.bfloat16)
    outs = jax.jit(lambda v, x: jm.apply(v, x, True, mutable=["batch_stats"])[0])(
        variables, jnp.asarray(batch["images"], jnp.bfloat16))
    f32 = jax.tree.map(lambda a: a.astype(jnp.float32), outs)
    from object_keypoints_tpu.data.detection_targets import gather_tags as jgather

    tl_tags = [jgather(t, jnp.asarray(batch["tl_tags"]))[..., 0] for t in f32[2]]
    br_tags = [jgather(t, jnp.asarray(batch["br_tags"]))[..., 0] for t in f32[3]]
    tl_offs = [jgather(t, jnp.asarray(batch["tl_tags"])) for t in f32[4]]
    br_offs = [jgather(t, jnp.asarray(batch["br_tags"])) for t in f32[5]]
    heads = (f32[0], f32[1], tl_tags, br_tags, tl_offs, br_offs)
    targets = (jnp.asarray(batch["tl_heatmaps"]), jnp.asarray(batch["br_heatmaps"]),
               jnp.asarray(batch["tag_mask"]), jnp.asarray(batch["tl_regrs"]),
               jnp.asarray(batch["br_regrs"]))
    if name == "squeeze":
        want = jlosses.cornernet_loss(heads, targets)
    else:
        want = jlosses.cornernet_saccade_loss(
            (*heads, f32[6]), (*targets, jnp.asarray(batch["tl_valids"]),
                               jnp.asarray(batch["br_valids"]),
                               [jnp.asarray(a) for a in batch["attentions"]]))
    assert metrics["loss"].dtype == torch.float32
    np.testing.assert_allclose(metrics["loss"].item(), float(want), rtol=2e-2)


def test_attention_heads_pair_with_the_targets_coarse_to_fine():
    """Each stack's attention maps run deepest level first, the order of
    the batch's attentions (coarse to fine), in both packages."""
    batch = saccade_batch(4)
    model = cornernet.CornerNetModel(CATS, **SACCADE, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        atts = model(torch.from_numpy(batch["images"]).permute(0, 3, 1, 2))[6]
    jm = JCornerNetModel(categories=CATS, **SACCADE)
    jatts = jax.eval_shape(jm.apply, jax_variables(SACCADE), jnp.asarray(batch["images"]))[6]
    for stack, jstack in zip(atts, jatts):
        assert [tuple(a.shape[2:]) for a in stack] == [a.shape[1:3] for a in batch["attentions"]]
        assert [tuple(a.shape[1:3]) for a in jstack] == [a.shape[1:3] for a in batch["attentions"]]


# ----------------------------------------------------------------- the loop


def repeat(batch):
    while True:
        yield batch


def tiny_squeeze(seed=0):
    return cornernet.tiny_cornernet("CornerNet_Squeeze", CATS,
                                    generator=torch.Generator().manual_seed(seed))


def test_train_detector_snapshots_at_the_cadence(tmp_path):
    messages = []
    cfg = SystemConfig(max_iter=5, snapshot=2, display=2, snapshot_name="det", learning_rate=1e-3)
    state = detection.train_detector(tiny_squeeze(), cfg, repeat(detection_batch(0, out=16)),
                                     snapshot_dir=str(tmp_path), on_display=messages.append,
                                     device="cpu")
    assert state.step == 5 and state.opt_state.count == 5
    assert sorted(os.listdir(tmp_path)) == ["det_2.pth", "det_4.pth"]
    assert [m.split(":")[0] for m in messages] == ["iter 2", "iter 4"]
    sd = torch.load(tmp_path / "det_4.pth", weights_only=True)
    assert set(sd) == set(tiny_squeeze().state_dict())


@pytest.mark.parametrize("start_iter", [0, 3])
def test_display_messages_equal_jax_for_the_same_losses(start_iter):
    values = np.random.default_rng(5).uniform(0.5, 30.0, 14).astype(np.float32)
    cfg = dict(max_iter=start_iter + 11, display=4, snapshot=1000)

    def fake(losses_iter):
        def step(*args):
            return args[-2], {"loss": next(losses_iter)}
        return step

    ours, theirs = [], []
    detection.train_detector(tiny_squeeze(), SystemConfig(**cfg), repeat(None), start_iter,
                             on_display=ours.append, device="cpu",
                             train_step_fn=fake(iter(torch.from_numpy(values))))
    jdet.train_detector(None, {"params": [jnp.zeros(1)]}, JSystemConfig(**cfg), repeat(None),
                        start_iter,
                        on_display=theirs.append,
                        train_step_fn=fake(iter(jnp.asarray(v) for v in values)))
    assert ours == theirs and len(ours) >= 2


def test_resume_replays_both_counts_as_jax():
    """train_detector from start_iter 4 for one step (stepsize 3: the
    learning rate already divided once, Adam's bias corrections at count
    5) against the JAX step from the same weights and batch with optax's
    counts set to 4, as the JAX loop's resume sets them. (The JAX loop
    itself cannot resume on the CPU: tree_set puts one count array in both
    of optax's states, and the jitted step donates it twice.)"""
    batch = detection_batch(6)
    variables = jax_variables(SQUEEZE)
    cfg = dict(max_iter=5, display=100, snapshot=1000, **STEP_OPT)
    model = cornernet.CornerNetModel(CATS, **SQUEEZE)
    start = weights.cornernet_state_dict(variables, SQUEEZE)
    model.load_state_dict(start, strict=True)
    probe = port_state(variables, SQUEEZE)
    _, grads = detection.loss_and_grads(probe, batch)
    state = detection.train_detector(model, SystemConfig(**cfg), repeat(batch), start_iter=4,
                                     device="cpu")
    assert state.step == 5 and state.opt_state.count == 5
    _, want = jax_step("squeeze", variables, batch, jnp.float32, start=4)
    lr = STEP_OPT["learning_rate"] / 10
    bc1, bc2 = 1 - 0.9 ** 5, 1 - 0.999 ** 5  # Adam's first step at count 5
    step_size = lr * (0.1 / bc1) / (0.001 / bc2) ** 0.5
    for (key, param), g in zip(state.model.named_parameters(), grads):
        big = g.abs() > 0.2 * g.abs().max()
        torch.testing.assert_close(param.detach()[big], want[key][big], rtol=0,
                                   atol=1e-6, msg=lambda m: f"{key}: {m}")
        moved = (param.detach() - start[key])[big]
        torch.testing.assert_close(moved.abs(), torch.full_like(moved, step_size), rtol=1e-3,
                                   atol=0, msg=lambda m: f"{key}: {m}")


def test_a_port_snapshot_gives_the_jax_test_forward_the_ports_boxes(tmp_path):
    cfg = SystemConfig(max_iter=3, snapshot=3, display=100, snapshot_name="CornerNet_Squeeze",
                       learning_rate=2.5e-3)
    model = tiny_squeeze(seed=2)
    detection.train_detector(model, cfg, repeat(detection_batch(7, out=16)),
                             snapshot_dir=str(tmp_path),
                             device="cpu")
    sd = torch.load(tmp_path / "CornerNet_Squeeze_3.pth", weights_only=True)
    arch = cornernet.tiny_arch("CornerNet_Squeeze")
    port = cornernet.CornerNetModel(CATS, **arch)
    port.load_state_dict(sd, strict=True)
    jm = JCornerNetModel(categories=CATS, **arch)
    variables = weights.cornernet_variables(sd, arch)
    x = np.random.default_rng(8).normal(size=(2, 64, 64, 3)).astype(np.float32)
    kw = dict(K=8, num_dets=12, kernel=3, ae_threshold=0.5)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(), test=True,
                          **kw)[0]
    want = np.asarray(jm.apply(variables, jnp.asarray(x), False, True, **kw)[0])
    assert got.shape == want.shape == (2, 12, 8)
    np.testing.assert_array_equal(got[..., 7].numpy(), want[..., 7])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


# ------------------------------------------------------------------ the CLIs


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    return make_synthetic_coco_dataset(str(tmp_path_factory.mktemp("coco")), n_images=16,
                                       image_size=(64, 64), seed=0)


@pytest.mark.parametrize("arch", ["CornerNet_Squeeze", "CornerNet_Saccade"])
def test_train_cli_then_eval_cli_on_the_cpu(coco, tmp_path, arch, capsys):
    ann, images = coco
    snaps = tmp_path / "nnet"
    cli.main([arch, "--annotations", ann, "--images", images, "--tiny", "--cpu",
              "--max-iter", "4", "--batch-size", "2", "--snapshot-every", "2",
              "--snapshot-dir", str(snaps), "--workers", "1"])
    assert sorted(os.listdir(snaps)) == [f"{arch}_2.pth", f"{arch}_4.pth"]
    capsys.readouterr()
    out = evaluate_detector.main([arch, "--annotations", ann, "--image-dir", images, "--tiny",
                                  "--cpu", "--testiter", "4", "--snapshot-dir", str(snaps),
                                  "--result-dir", str(tmp_path / "results"), "--max-images", "4"])
    printed = capsys.readouterr().out
    assert "loading parameters at iteration: 4" in printed
    assert json.loads(printed.strip().splitlines()[-1])["images"] == 4
    assert 0.0 <= out["mAP"] <= 1.0


def test_train_cli_resume_replays_the_schedule(coco, tmp_path, capsys):
    """--iter 6 with --max-iter 8: two iterations, snapshot at 8, and the
    loop's count starts at 6 (the JAX CLI's --iter, which loads no
    weights)."""
    ann, images = coco
    state = cli.main(["CornerNet_Squeeze", "--annotations", ann, "--images", images, "--tiny",
                      "--cpu", "--iter", "6", "--max-iter", "8", "--batch-size", "2",
                      "--snapshot-every", "8", "--snapshot-dir", str(tmp_path), "--workers", "1"])
    assert state.step == 8 and state.opt_state.count == 8
    assert os.listdir(tmp_path) == ["CornerNet_Squeeze_8.pth"]


def test_tiny_detector_loss_falls(coco):
    """30 iterations of the tiny CornerNet-Squeeze on the synthetic set
    through the CLI's batch stream: the last display's mean loss is below
    half the first's."""
    ann, images = coco
    _, db = load_cfg(CONFIG_DIR / "CornerNet_Squeeze.json")
    config = DetectionConfig({**db, **tiny_db_overrides("CornerNet_Squeeze")})
    stream = cli.batch_stream(CocoDetectionDataset(ann, images), config, 4, 1)
    messages = []
    model = cornernet.tiny_cornernet("CornerNet_Squeeze", 80,
                                     generator=torch.Generator().manual_seed(0))
    detection.train_detector(model, SystemConfig(max_iter=30, display=10, learning_rate=2.5e-3,
                                                 snapshot=1000),
                             stream, on_display=messages.append, device="cpu")
    stream.close()
    first, last = (float(m.split("loss ")[1]) for m in (messages[0], messages[-1]))
    assert len(messages) == 3 and last < 0.5 * first, messages


def test_detector_training_defaults_to_the_card(coco, tmp_path, monkeypatch):
    """With no device given, train_detector and the train CLI ask for CUDA
    and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        detection.train_detector(tiny_squeeze(), SystemConfig(max_iter=1), repeat(None))
    ann, images = coco
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["CornerNet_Squeeze", "--annotations", ann, "--images", images, "--tiny",
                  "--max-iter", "1", "--batch-size", "1", "--snapshot-dir", str(tmp_path)])
