"""Port parity for the training slice, and the repairs it carries.

Each test runs the JAX package's function and its port on the same numpy
inputs (seeded), the tiny KeypointNet of test_torch_port_model with dropout
0 and augmentation off where steps are compared (the packages' random
streams differ). Weights go into the port through ``serving.weights`` and
back out in the JAX layout.

Tolerances, with what they were set from:
- loss: float32 rel 1e-5 (values and per-stack lists), gradients with
  respect to the predictions rel 1e-5 of each tensor's largest;
- optimizer against optax itself: the plateau scale equal step for step,
  parameters within rtol 1e-5 / atol 1e-6 over 16 steps (float32 rounding
  of parameters near 1, accumulated; seen 3.3e-7);
- one train step in float64 (``jax.enable_x64``): the loss rel 1e-7,
  gradients within 1e-6 of each tensor's largest (seen 2e-7: flax's
  E[x^2] - E[x]^2 batch variance, below), BatchNorm statistics rel 1e-8, and
  the updated parameters within 1e-9 where |g| is above 1e-3 of its
  tensor's largest and 1e-4 (Adam's first step, lr * g / (|g| + eps), is
  held where the gradient is known to 1e-3 of itself and 1e4 x eps).
  In float32 single gradient elements are no reference: flax computes the
  batch variance as E[x^2] - E[x]^2, which cancels where a channel's mean
  is many of its standard deviations, and a BatchNorm that divides by a
  small batch variance magnifies float32 rounding in either package. So
  float32 is held on the loss and the per-stack losses (rel 1e-5), the
  gradient norm (rel 1e-4), the running statistics (rel 1e-3, against an
  unbiased fold's 1 / (n - 1) >= 14% at the smallest BatchNorm here, 2 x 2
  x 2 values) and the updated parameters whose gradient is above a fifth
  of its tensor's largest (atol 1e-6; Adam's first step is about
  lr * sign(g) there);
- bf16 step: loss rel 2e-3 of JAX's bf16 step;
- bf16 serve forward (repair 2) against JAX's bf16 ``make_inference_fn``
  on briefly trained weights: maps within a few bf16 ulps (seen: heatmaps
  0.0156, depth 0.0156, centers 0.0088); the decode at the BASELINE.md
  gates, 2D within 1 px and 3D within 5 mm (seen: 0.008 px, 3.9 mm, one
  bf16 ulp of a 0.6 m depth);
- device augment: ``apply_bcg`` within one uint8 step of the host LUTs,
  flips and cutout equal to the host's;
- the device-store step (augment off): loss rel 1e-4 of the host-pipeline
  step and of JAX's ``train_step_device_data``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from object_keypoints_tpu.data import combinators as jcomb  # noqa: E402
from object_keypoints_tpu.geometry import cameras as jcam  # noqa: E402
from object_keypoints_tpu.models import KeypointNet as JKeypointNet  # noqa: E402
from object_keypoints_tpu.pipeline import decode_jit as jpipe  # noqa: E402
from object_keypoints_tpu.serving import export as jexport  # noqa: E402
from object_keypoints_tpu.training import losses as jlosses  # noqa: E402
from object_keypoints_tpu.training import trainer as jtrainer  # noqa: E402
from object_keypoints_tpu_torch.data import augment, augment_device, combinators  # noqa: E402
from object_keypoints_tpu_torch.data.prefetch import device_prefetch  # noqa: E402
from object_keypoints_tpu_torch.geometry import cameras as cam  # noqa: E402
from object_keypoints_tpu_torch.models.keypoint_net import KeypointNet, dropout  # noqa: E402
from object_keypoints_tpu_torch.ops import stem_conv as stem_ops  # noqa: E402
from object_keypoints_tpu_torch.pipeline import decode as pipe  # noqa: E402
from object_keypoints_tpu_torch.serving import export, weights  # noqa: E402
from object_keypoints_tpu_torch.testing import synthetic_batch  # noqa: E402
from object_keypoints_tpu_torch.training import losses, trainer  # noqa: E402
from test_torch_port_model import TINY, randomize  # noqa: E402

torch.set_num_threads(1)

ARCH = dict(stacks=2, levels=2, mods=(1, 1, 1))


def jax_variables(seed=1, size=64, tiny=TINY):
    model = JKeypointNet(**tiny)
    init = model.init({"params": jax.random.key(seed)}, jnp.zeros((1, size, size, 3)), train=False)
    return model, randomize(init, np.random.default_rng(seed))


def port_state(variables, tiny=TINY, dtype=torch.float32, **opt):
    model = KeypointNet(**tiny)
    arch = dict(stacks=tiny["stacks"], levels=tiny["levels"], mods=tiny["mods"])
    model.load_state_dict(weights.keypoint_net_state_dict(variables, **arch), strict=True)
    if dtype == torch.float64:
        model.double()
    return trainer.create_train_state(model, trainer.make_optimizer(**opt), dtype, device="cpu")


def port_variables(state, tensors=None):
    """The port's parameters (or ``tensors`` in their place) and BN
    statistics in the JAX layout, through the weight bridge (float32)."""
    sd = dict(state.model.state_dict())
    if tensors is not None:
        sd.update({n: t for (n, _), t in zip(state.model.named_parameters(), tensors)})
    variables = weights.keypoint_net_variables(sd, **ARCH)
    return {col: {k: v.astype(np.float64) for k, v in flatten_dict(variables[col]).items()}
            for col in variables}


def flat64(tree):
    return {k: np.asarray(v, np.float64) for k, v in flatten_dict(tree).items()}


# ---------------------------------------------------------------- the loss


def loss_inputs(seed, n=3, k=4, h=8, w=8, zero_mask=False):
    rng = np.random.default_rng(seed)
    t = k - 1
    p_heat = [rng.normal(size=(n, k, h, w)).astype(np.float32) for _ in range(2)]
    gt_heat = rng.uniform(size=(n, k, h, w)).astype(np.float32)
    gt_heat = np.where(gt_heat > 0.7, gt_heat, 0.0).astype(np.float32)
    if zero_mask:
        gt_heat[:] = 0.005  # below the 0.01 mask everywhere
    p_depth = [rng.normal(size=(n, k, h, w)).astype(np.float32) for _ in range(2)]
    gt_depth = rng.uniform(0.5, 2.0, size=(n, k, h, w)).astype(np.float32)
    p_centers = [rng.normal(size=(n, t, 2, h, w)).astype(np.float32) * 2 for _ in range(2)]
    gt_centers = rng.normal(size=(n, t, 2, h, w)).astype(np.float32)
    return p_heat, gt_heat, p_depth, gt_depth, p_centers, gt_centers


@pytest.mark.parametrize("case", [dict(seed=0), dict(seed=1, zero_mask=True), dict(seed=2, n=1)],
                         ids=["random", "all-zero-mask", "batch-of-1"])
def test_keypoint_loss_matches_jax(case):
    p_heat, gt_heat, p_depth, gt_depth, p_centers, gt_centers = loss_inputs(**case)
    tp = [[torch.tensor(a, requires_grad=True) for a in arrays]
          for arrays in (p_heat, p_depth, p_centers)]
    total, hm, dl, cl = losses.keypoint_loss(tp[0], torch.tensor(gt_heat), tp[1],
                                             torch.tensor(gt_depth), tp[2], torch.tensor(gt_centers))
    grads = torch.autograd.grad(total, [t for group in tp for t in group])

    def jax_loss(ph, pd, pc):
        return jlosses.keypoint_loss(
            [nchw_to_nhwc(a) for a in ph], jnp.asarray(nchw_to_nhwc(gt_heat)),
            [nchw_to_nhwc(a) for a in pd], jnp.asarray(nchw_to_nhwc(gt_depth)),
            [nchw_to_nhwc(a) for a in pc], jnp.asarray(nchw_to_nhwc(gt_centers)))

    jinputs = [[jnp.asarray(a) for a in arrays] for arrays in (p_heat, p_depth, p_centers)]
    jtotal, jhm, jdl, jcl = jax_loss(*jinputs)
    jgrads = jax.grad(lambda *a: jax_loss(*a)[0], argnums=(0, 1, 2))(*jinputs)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    for got, want in zip((hm, dl, cl), (jhm, jdl, jcl)):
        assert len(got) == len(want) == 2
        np.testing.assert_allclose([g.item() for g in got], [float(x) for x in want], rtol=1e-5)
    if case.get("zero_mask"):
        assert all(d.item() == 0.0 for d in dl) and all(c.item() == 0.0 for c in cl)
    for got, want in zip(grads, [g for group in jgrads for g in group]):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * max(np.abs(want).max(), 1e-30))


def nchw_to_nhwc(a):
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 else a.transpose(0, 3, 4, 1, 2)


def test_keypoint_loss_class_matches_function():
    args = [torch.tensor(a) if isinstance(a, np.ndarray) else [torch.tensor(x) for x in a]
            for a in loss_inputs(3)]
    fn = losses.KeypointLoss([1, 3], depth_weight=5.0, center_weight=2.0)
    assert fn.n_keypoint_maps == 3
    assert fn(*args)[0].item() == losses.keypoint_loss(*args, depth_weight=5.0,
                                                       center_weight=2.0)[0].item()
    with pytest.raises(NotImplementedError):
        losses.KeypointLoss([1, 3], reduction="max")


# ---------------------------------------------------------- the optimizer


@pytest.mark.parametrize("grad_clip", [None, 0.5], ids=["no-clip", "clip"])
def test_optimizer_matches_optax_step_for_step(grad_clip):
    """AdamW + plateau with accumulation 2 and patience 2 over 16 steps of
    seeded gradients and a loss that stalls: the scale is cut on the same
    steps as optax's (twice here) and every parameter follows optax's."""
    rng = np.random.default_rng(5)
    shapes = [(4, 3), (7,), (2, 2, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    values = [5.0, 4.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 2.0, 2.0, 2.5, 2.5, 2.5, 2.5]
    kw = dict(lr=0.05, weight_decay=0.01, plateau_factor=0.5, plateau_patience=2,
              plateau_accumulation=2, grad_clip=grad_clip)
    tx = jtrainer.make_optimizer(**kw)
    jparams = [jnp.asarray(p) for p in params]
    jstate = tx.init(jparams)
    opt = trainer.make_optimizer(**kw)
    tparams = [torch.tensor(p) for p in params]
    state = opt.init(tparams)
    scales = []
    for value in values:
        grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
        updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jparams,
                                    value=jnp.asarray(value, jnp.float32))
        jparams = optax.apply_updates(jparams, updates)
        opt.step(tparams, [torch.tensor(g) for g in grads], state, torch.tensor(value))
        assert state.scale.item() == float(jstate[-1].scale)
        scales.append(state.scale.item())
        for got, want in zip(tparams, jparams):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert scales[-1] == 0.25 and scales.count(1.0) < len(scales), scales


def test_plateau_trips_at_lr_zero_as_optax():
    """lr = 0: the parameters stay put and so does the loss, so the plateau
    (patience 2) cuts the scale, as tests/test_training.py:80-92 has it for
    the JAX step; the cuts fall on the steps where optax's plateau, fed the
    same losses, makes them."""
    state = trainer.create_train_state(
        KeypointNet(**{**TINY, "stacks": 1}, generator=torch.Generator().manual_seed(1)),
        trainer.make_optimizer(lr=0.0, plateau_factor=0.1, plateau_patience=2), device="cpu")
    tx = jtrainer.make_optimizer(lr=0.0, plateau_factor=0.1, plateau_patience=2)
    zeros = [jnp.zeros(1)]
    jstate = tx.init(zeros)
    batch = synthetic_batch(0)
    for _ in range(8):
        state, metrics = trainer.train_step(state, batch)
        _, jstate = tx.update(zeros, jstate, zeros, value=jnp.asarray(metrics["loss"].item()))
        assert state.lr_scale.item() == float(jstate[-1].scale)
    assert state.lr_scale.item() < 1.0


# --------------------------------------------------------- the train step


def test_train_step_float64_matches_jax():
    """The loss, every gradient and the BatchNorm running statistics of one
    train-mode step, in float64 on both sides; then the port's AdamW update
    of those gradients against optax's. Compared in the port's layout: the
    JAX trees come in through the weight bridge, which keeps float64."""
    batch = synthetic_batch(0, size=64)
    _, variables = jax_variables()
    state = port_state(variables, dtype=torch.float64, lr=1e-3, plateau_patience=1000)
    loss, metrics, grads = trainer.loss_and_grads(state, batch)
    trainer.apply_gradients(state, grads, loss)
    with jax.enable_x64(True):
        model64 = JKeypointNet(**TINY, dtype=jnp.float64)
        v64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), variables)
        jbatch = {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()}

        @jax.jit
        def value_and_grad(params):
            return jax.value_and_grad(lambda p: jtrainer.loss_and_metrics(
                model64, p, v64["batch_stats"], jbatch, True, jax.random.key(0))[:2],
                has_aux=True)(params)

        (jloss, (jstats, _, _)), jgrads = value_and_grad(v64["params"])
        tx = jtrainer.make_optimizer(lr=1e-3, plateau_patience=1000)
        updates, _ = tx.update(jgrads, tx.init(v64["params"]), v64["params"], value=jloss)
        jparams = optax.apply_updates(v64["params"], updates)
        want = weights.keypoint_net_state_dict({"params": jparams, "batch_stats": jstats}, **ARCH)
        want_grads = weights.keypoint_net_state_dict({"params": jgrads, "batch_stats": jstats},
                                                     **ARCH)
        jloss = float(jloss)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-7)
    np.testing.assert_allclose(metrics["grad_norm"].item(), trainer.global_norm(
        [want_grads[name] for name, _ in state.model.named_parameters()]).item(), rtol=1e-6)
    for (name, param), grad in zip(state.model.named_parameters(), grads):
        assert param.dtype == grad.dtype == want[name].dtype == torch.float64
        g = want_grads[name]
        torch.testing.assert_close(grad, g, rtol=0, atol=1e-6 * g.abs().max().item(),
                                   msg=lambda m: f"{name}: {m}")
        # Adam's first step is lr * g / (|g| + eps): held where g is known
        # to 1e-3 of itself and is far above eps
        moved = g.abs() > max(1e-3 * g.abs().max().item(), 1e-4)
        torch.testing.assert_close(param.detach()[moved], want[name][moved], rtol=0, atol=1e-9,
                                   msg=lambda m: f"{name}: {m}")
    for name, buf in state.model.named_buffers():
        if "running" in name:
            torch.testing.assert_close(buf, want[name], rtol=1e-8, atol=1e-12,
                                       msg=lambda m: f"{name}: {m}")


def test_train_step_float32_matches_jax():
    batch = synthetic_batch(0, size=64)
    jmodel, variables = jax_variables()
    state = port_state(variables, lr=1e-3, plateau_patience=1000)
    tx = jtrainer.make_optimizer(lr=1e-3, plateau_patience=1000)
    jstate = jtrainer.create_train_state(jmodel, jax.tree.map(jnp.copy, variables), tx)
    jstate, jmetrics = jtrainer.train_step(jmodel, jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                           jax.random.key(2))
    loss, metrics, grads = trainer.loss_and_grads(state, batch)
    state = trainer.apply_gradients(state, grads, loss)
    assert state.step == 1 and set(metrics) == set(jmetrics)
    for name, value in metrics.items():
        assert value.dtype == torch.float32 and value.dim() == 0
        np.testing.assert_allclose(value.item(), float(jmetrics[name]),
                                   rtol=1e-4 if name == "grad_norm" else 1e-5, err_msg=name)
    after, g = port_variables(state), port_variables(state, tensors=grads)["params"]
    for key, want in flat64(jstate.params).items():
        # where |g| is above the JAX float32 gradients' error, the signs agree
        big = np.abs(g[key]) > 0.2 * np.abs(g[key]).max()
        np.testing.assert_allclose(after["params"][key][big], want[big], rtol=0, atol=1e-6,
                                   err_msg=str(key))
    for key, want in flat64(jstate.batch_stats).items():
        np.testing.assert_allclose(after["batch_stats"][key], want, rtol=1e-3, atol=1e-6,
                                   err_msg=str(key))


def test_bf16_train_step_loss_matches_jax():
    """bf16 compute over float32 parameters and BatchNorm on both sides."""
    batch = synthetic_batch(1, size=64)
    jmodel, variables = jax_variables()
    jbf16 = JKeypointNet(**TINY, dtype=jnp.bfloat16)
    jstate = jtrainer.create_train_state(jbf16, variables, jtrainer.make_optimizer())
    _, jmetrics = jtrainer.train_step(jbf16, jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                      jax.random.key(2))
    state = port_state(variables, dtype=torch.bfloat16)
    _, metrics = trainer.train_step(state, batch)
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(b.dtype == torch.float32 for n, b in state.model.named_buffers()
               if "running" in n)
    assert metrics["loss"].dtype == torch.float32
    np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=2e-3)


def test_eval_step_matches_jax():
    batch = synthetic_batch(2, size=64)
    jmodel, variables = jax_variables()
    jstate = jtrainer.create_train_state(jmodel, variables, jtrainer.make_optimizer())
    want = jtrainer.eval_step(jmodel, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    got = trainer.eval_step(port_state(variables), batch)
    assert set(got) == set(want) and "val_heatmap_loss2" in got
    for name, value in got.items():
        np.testing.assert_allclose(value.item(), float(want[name]), rtol=1e-5, err_msg=name)
    assert 0.0 <= got["val_loss"].item() <= 1.0


def test_single_batch_overfit():
    """The loss falls below half in 100 steps on one batch
    (tests/test_training.py:51-69, OverfittingTest.ipynb semantics)."""
    batch = synthetic_batch(0)
    model = KeypointNet(**TINY, generator=torch.Generator().manual_seed(1))
    state = trainer.create_train_state(model, trainer.make_optimizer(lr=1e-3, plateau_patience=1000),
                                       device="cpu")
    for i in range(100):
        state, metrics = trainer.train_step(state, batch)
        if i == 0:
            first = metrics["loss"].item()
    last = metrics["loss"].item()
    assert np.isfinite(first) and np.isfinite(last)
    assert last < 0.5 * first, (first, last)


def test_train_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainer.create_train_state(KeypointNet(**TINY), trainer.make_optimizer())


def test_dropout_draws_from_the_generator_given():
    model = KeypointNet(**{**TINY, "dropout": 0.5}, generator=torch.Generator().manual_seed(0))
    model.train()
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    a, b = (model(x, generator=torch.Generator().manual_seed(7)).heatmaps[-1] for _ in range(2))
    c = model(x, generator=torch.Generator().manual_seed(8)).heatmaps[-1]
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = dropout(torch.ones(1000), 0.5, torch.Generator().manual_seed(3))
    assert 400 < torch.count_nonzero(kept) < 600  # keep probability 0.5
    assert set(kept.unique().tolist()) == {0.0, 2.0}  # kept values scaled by 1 / 0.5


# ------------------------------------------------------------ the repairs


@pytest.fixture(scope="module")
def trained():
    """The tiny model trained on one batch of three central Gaussian blobs
    (depth 0.6 m) for 150 steps, its BatchNorm running statistics then set
    to the trained weights' batch statistics: maps with distinct peaks."""
    rng = np.random.default_rng(0)
    n, size, m = 2, 128, 16
    frame = (rng.normal(size=(n, size, size, 3)) * 0.1).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    heat = np.zeros((n, m, m, 3), np.float32)
    for i, (cy, cx) in enumerate([(7, 7), (5, 10), (10, 5)]):
        heat[..., i] = np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / 2.0)
    batch = {"frame": frame, "heatmaps": heat,
             "depth": np.where(heat > 0.01, 0.6, 0.0).astype(np.float32),
             "centers": np.zeros((n, m, m, 2, 2), np.float32)}
    model = KeypointNet(**TINY, generator=torch.Generator().manual_seed(1))
    state = trainer.create_train_state(model, trainer.make_optimizer(lr=1e-2, plateau_patience=1000),
                                       device="cpu")
    for _ in range(150):
        trainer.train_step(state, batch)
    with torch.no_grad():
        model.train()
        for _ in range(40):  # momentum 0.9: the running statistics converge
            model(trainer.prepare_frames(torch.from_numpy(frame)))
    return model, frame.transpose(0, 3, 1, 2).copy()


def test_bf16_serve_forward_and_decode_match_jax_bf16(trained, calibration_file):
    """make_inference_fn(dtype=bfloat16) keeps parameters and BatchNorm in
    float32 and computes in bf16, as KeypointNet(dtype=bfloat16) does."""
    model, frames = trained
    variables = weights.keypoint_net_variables(model.state_dict(), **ARCH)
    jinfer = jexport.make_inference_fn(JKeypointNet(**TINY, dtype=jnp.bfloat16), variables,
                                       dtype=jnp.bfloat16)
    want = [np.asarray(a) for a in jinfer(jnp.asarray(frames))]
    got = export.make_inference_fn(model, dtype=torch.bfloat16, device="cpu")(frames)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 for n, b in model.named_buffers() if "running" in n)
    for name, g, w, atol in zip(("heat", "depth", "centers"), got, want, (0.03, 0.03, 0.02)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol, err_msg=name)

    offset = np.array([(511.0 / 720.0 * 1280.0 - 511.0) / 2.0, 0.0])
    chain = []
    for mod in (cam, jcam):
        p = mod.load_calibration_params(calibration_file)
        chain.append(mod.FisheyeCamera(p["K"], p["D"], p["image_size"])
                     .scale(511.0 / 720.0).cut(offset).scale(16 / 511.0))
    jcamera = jpipe.CameraArrays(*(jnp.asarray(a, jnp.float32) for a in
                                   (chain[1].K, chain[1].D, chain[1].Kinv, chain[1].image_size)))
    kw = dict(max_peaks=4, reject_distance=20.0, peak_threshold=0.5)
    dec = pipe.decode_objects_batch(*got, pipe.CameraArrays.from_camera(chain[0]), (1, 2), **kw)
    jdec = jpipe.decode_objects_batch(*(jnp.asarray(a) for a in want), jcamera, (1, 2), **kw)
    for points, valid, p3d in (("center_points", "center_valid", "center_p3d"),
                               ("keypoints", "keypoints_valid", "keypoints_p3d")):
        mask = getattr(dec, valid).numpy()
        np.testing.assert_array_equal(mask, np.asarray(getattr(jdec, valid)), err_msg=valid)
        assert mask.any(), valid
        d2 = np.abs(getattr(dec, points).numpy() - np.asarray(getattr(jdec, points)))[mask]
        d3 = np.linalg.norm(getattr(dec, p3d).numpy() - np.asarray(getattr(jdec, p3d)), axis=-1)
        assert d2.max() <= 1.0 and d3[mask].max() <= 5e-3, (points, d2.max(), d3[mask].max())


def test_stem_autograd_op_gives_the_plain_gradients(monkeypatch):
    """The stem kernel's autograd op (kernel forward, plain-version
    backward), with the launch replaced by the plain version so it runs on
    the CPU: its gradients for frames, w, scale and bias equal those through
    ``stem_conv_plain``, and BatchNorm's get theirs through ``fold_bn``."""
    monkeypatch.setattr(stem_ops, "_launch", stem_ops.stem_conv_plain)
    g = torch.Generator().manual_seed(0)
    inputs = [torch.randn(2, 3, 21, 21, generator=g), torch.randn(8, 3, 7, 7, generator=g) * 0.1,
              torch.rand(8, generator=g) + 0.5, torch.randn(8, generator=g) * 0.1]
    r = torch.randn(2, 8, 11, 11, generator=g)
    grads = []
    for fn in (stem_ops.StemConvKernel.apply, stem_ops.stem_conv_plain):
        leaves = [t.clone().requires_grad_() for t in inputs]
        out = fn(*leaves)
        grads.append(torch.autograd.grad((out * r).sum(), leaves))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    leaves = [t.clone().requires_grad_(i == 1) for i, t in enumerate(inputs)]
    (gw,) = torch.autograd.grad((stem_ops.StemConvKernel.apply(*leaves) * r).sum(), leaves[1])
    torch.testing.assert_close(gw, grads[1][1], rtol=1e-6, atol=0)


# --------------------------------------------------------- device augment


def test_apply_bcg_matches_host_luts():
    ramp = torch.arange(256, dtype=torch.float32).reshape(1, 16, 16, 1).expand(3, 16, 16, 3)
    params = ((1.13, -0.07, 0.85), (0.86, 0.19, 1.17), (1.0, 0.0, 1.0))
    alpha, beta, gamma = (torch.tensor(p, dtype=torch.float32) for p in zip(*params))
    out = augment_device.apply_bcg(ramp, alpha, beta, gamma)
    for i, (a, b, gm) in enumerate(params):
        host_rng = _FixedDraws(uniform=[a - 1.0, b, gm * 100.0])
        bc = augment.brightness_contrast_lut(host_rng)
        lut = augment.gamma_lut(host_rng)
        host = lut[bc][np.arange(256).reshape(16, 16)]
        assert np.abs(out[i, ..., 0].numpy() - host).max() <= 1.0


class _FixedDraws:
    """A stand-in for numpy's Generator that returns given draws in order,
    so the host augmentation runs its own code on known parameters."""

    def __init__(self, uniform=(), integers=()):
        self._uniform, self._integers = list(uniform), list(integers)

    def uniform(self, low=0.0, high=1.0):
        return self._uniform.pop(0)

    def integers(self, low, high=None):
        return self._integers.pop(0)


def test_flips_match_host():
    img = np.arange(2 * 40 * 30 * 3, dtype=np.float32).reshape(2, 40, 30, 3)
    kps = np.array([[[10.0, 20.0], [3.0, 7.0]], [[1.0, 2.0], [29.0, 39.0]]], np.float32)
    for do_h, do_v in ((True, False), (False, True), (True, True)):
        d_img, d_kps = augment_device.flip_device(torch.from_numpy(img), torch.from_numpy(kps),
                                                  torch.tensor([do_h, False]),
                                                  torch.tensor([do_v, False]))
        h_img, h_kps = img[0], kps[0]
        if do_h:
            h_img, h_kps = augment.hflip(h_img, h_kps)
        if do_v:
            h_img, h_kps = augment.vflip(h_img, h_kps)
        np.testing.assert_array_equal(d_img[0].numpy(), h_img)
        np.testing.assert_allclose(d_kps[0].numpy(), h_kps)
        np.testing.assert_array_equal(d_img[1].numpy(), img[1])  # not flipped
        np.testing.assert_array_equal(d_kps[1].numpy(), kps[1])


def test_cutout_geometry_matches_host():
    """Integer centers, half-open [c - 12, c + 12) windows, clipped at the
    borders, fill 0: the host's cutout on the same centers."""
    frames = np.full((2, 64, 48, 3), 200, np.uint8)
    centers = np.array([[[3, 60], [30, 20], [63, 47], [0, 0], [10, 10], [40, 5], [50, 30],
                         [20, 44]],
                        [[1, 1], [62, 2], [32, 24], [5, 40], [60, 46], [12, 30], [44, 11],
                         [25, 25]]])
    got = augment_device.cut_holes(torch.from_numpy(frames).float(),
                                   torch.from_numpy(centers[..., 0]),
                                   torch.from_numpy(centers[..., 1])).numpy()
    for i in range(2):
        host = augment.cutout(frames[i], _FixedDraws(integers=centers[i].reshape(-1).tolist()))
        np.testing.assert_array_equal(got[i], host.astype(np.float32))
    assert (got == 0).any() and not (got == 0).all()


def test_photometric_device_range_shapes_and_determinism():
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(0, 256, size=(6, 32, 40, 3), dtype=np.uint8))
    kps = torch.from_numpy(rng.uniform(0, 31, size=(6, 8, 2)).astype(np.float32))
    runs = [augment_device.photometric_device(frames, kps, torch.Generator().manual_seed(s))
            for s in (4, 4, 5)]
    out, kout = runs[0]
    assert out.shape == frames.shape and out.dtype == torch.float32 and kout.shape == kps.shape
    assert out.min() >= 0.0 and out.max() <= 255.0
    assert torch.equal(out, out.floor())  # whole uint8 levels, as the LUTs give
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    assert not torch.equal(runs[0][0], runs[2][0])

    g = torch.Generator().manual_seed(6)
    cut = augment_device.cutout(torch.full((3, 64, 64, 3), 200.0), g)
    holes = cut[..., 0] == 0
    assert holes.any() and not holes.all() and torch.equal(cut[holes], torch.zeros_like(cut[holes]))
    out = augment_device.brightness_contrast_gamma(frames.float(), g)
    assert out.min() >= 0.0 and out.max() <= 255.0 and torch.equal(out, out.floor())


# ----------------------------------------------------------- device store


def test_device_store_step_matches_host_pipeline_and_jax(tmp_path, calibration_file):
    """Same frames, augment off: one step through the device store has the
    loss of the host-pipeline step (``batched`` over the port's SceneDataset)
    and of JAX's train_step_device_data, from the same init."""
    pytest.importorskip("cv2")
    from object_keypoints_tpu.data.scene import SceneDataset as JSceneDataset
    from object_keypoints_tpu.data.synthetic import write_synthetic_sequence
    from object_keypoints_tpu.training import device_data as jdevice_data
    from object_keypoints_tpu_torch.data.scene import SceneDataset
    from object_keypoints_tpu_torch.training import device_data

    seq = str(tmp_path / "seq_00")
    write_synthetic_sequence(seq, calibration_file, keypoint_config=[1, 3], n_objects=2,
                             n_frames=2, seed=11)
    config = {"keypoint_config": [1, 3]}
    tiny = {**TINY, "stacks": 1}
    jmodel, variables = jax_variables(size=511, tiny=tiny)
    opt = dict(lr=1e-3, plateau_patience=1000)

    store = device_data.build_device_store([SceneDataset(seq, config, normalize=False)], "cpu")
    assert store.n_frames == 2 and bool(store.valid.all()) and store.valid.shape == (2, 2, 5)
    assert store.frames.dtype == torch.uint8 and store.frames.shape == (2, 511, 511, 3)
    _, dev = device_data.train_step_device_data(port_state(variables, tiny, **opt), store,
                                                torch.tensor([0, 1]), None, (1, 1, 3),
                                                augment=False)
    host_batch = next(combinators.batched(SceneDataset(seq, config, normalize=False), 2))
    _, host = trainer.train_step(port_state(variables, tiny, **opt), host_batch)

    jstore = jdevice_data.build_device_store([JSceneDataset(seq, config, normalize=False)])
    jstate = jtrainer.create_train_state(jmodel, variables, jtrainer.make_optimizer(**opt))
    _, jdev = jdevice_data.train_step_device_data(jmodel, jstate, jstore, jnp.asarray([0, 1]),
                                                  jax.random.key(2), keypoint_config=(1, 1, 3),
                                                  augment=False)
    np.testing.assert_allclose(dev["loss"].item(), host["loss"].item(), rtol=1e-4)
    np.testing.assert_allclose(dev["loss"].item(), float(jdev["loss"]), rtol=1e-4)

    # with augmentation on, the step runs from an explicit generator
    state = port_state(variables, tiny, **opt)
    g = torch.Generator().manual_seed(0)
    for _ in range(2):
        state, metrics = device_data.train_step_device_data(state, store, torch.tensor([1, 0]), g,
                                                            (1, 1, 3))
        assert torch.isfinite(metrics["loss"])


# ------------------------------------------------------ host data helpers


def test_combinators_match_jax():
    data = [[1, 2, 3], [10, 20], [100]]
    rr, jrr = iter(combinators.RoundRobin(data)), iter(jcomb.RoundRobin(data))
    assert [next(rr) for _ in range(11)] == [next(jrr) for _ in range(11)]
    for shuffle, infinite in ((False, False), (True, False)):
        assert (list(combinators.Chain(data, shuffle=shuffle, infinite=infinite, seed=3))
                == list(jcomb.Chain(data, shuffle=shuffle, infinite=infinite, seed=3)))
    assert list(combinators.SamplingPool(range(50), 10, seed=1)) == list(
        jcomb.SamplingPool(range(50), 10, seed=1))
    rows = [{"x": np.full(2, i, np.float32), "y": np.arange(3) * i} for i in range(5)]
    for drop_last in (True, False):
        got = list(combinators.batched(rows, 2, drop_last))
        want = list(jcomb.batched(rows, 2, drop_last))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_device_prefetch_on_the_cpu():
    data = [{"x": np.ones((2, 2)) * i} for i in range(4)]
    out = list(device_prefetch(iter(data), device="cpu"))
    assert len(out) == 4 and isinstance(out[3]["x"], torch.Tensor)
    assert out[3]["x"][0, 0].item() == 3.0

    def gen():
        yield {"x": np.ones(2)}
        raise ValueError("boom")

    with pytest.raises(ValueError, match="boom"):
        list(device_prefetch(gen(), device="cpu"))
