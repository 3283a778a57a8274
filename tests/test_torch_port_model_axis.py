"""Port parity for the mesh's ``model`` axis: the (data, model) grid, the
sharding rule, ``parallel.tensor``'s output-channel split, the train step
over a (2, 2) grid of gloo ranks and the sharded serve, against the JAX
package on the CPU (the conftest's 8-device mesh).

Process groups start only in child processes (``testing.launch_ranks``, a
deadline, every rank killed when one fails), never in a pytest worker.

The grid's model is a tiny KeypointNet whose wide convs cover every kind the
rule shards: 3x3 and 1x1 convs (the stem's residuals, ``cnv``, the merges,
a fire's squeeze), the fire's depthwise 3x3 (groups 256) and the
ConvTranspose unpools; dropout 0 where steps are compared.

Tolerances, with what they were set from:
- the sharded paths: the JAX list letter for letter;
- one sharded module (built from its shards in one process) against the
  whole module in float64: outputs, input gradients and weight gradients
  within 1e-12 of the whole one's largest (seen 2.4e-15); an int8 conv's
  shards equal to the whole int8 conv, bit for bit (integer sums);
- the (2, 2) gloo step in float64 against the port's one-process step on the
  whole batch: the loss, the metrics and ``eval_step``'s metrics rel 1e-10,
  every gradient tensor within 1e-10 of its norm, the running statistics and
  the weights after the step atol 1e-12 (the two-rank step's tolerances),
  the weights where |g| > 1e-6 (Adam's first step normalizes g by |g|, so a
  gradient at rounding level moves its weight by +-lr either way). A
  tensor's norm is floored at 1e-3 of the whole gradient's: a BatchNorm
  shift ahead of a conv and another BatchNorm has a gradient that is zero
  but for rounding (seen 1.3e-15, and 1.6e-15 between the two sides);
- the same step against the JAX package's step after ``shard_params`` over a
  4-device mesh at model_parallel=2 in float64 (``jax.enable_x64``; flax's
  model and ``keypoint_loss`` composed as in tests/test_torch_port_parallel.py):
  the loss and metrics rel 1e-10, every gradient within 1e-8 of its norm
  (floored as above),
  the running statistics and the weights (where |g| > 1e-6) atol 1e-9;
- the clip: Adam's first moment after a clipped step, (1 - b1) * c * g,
  within 1e-10 of the one-process step's (floored as the gradients), and
  c, read off it where |g| is above 1e-3 of its largest, rel 1e-8 of the
  one-process clip factor, which is below 1;
- dropout on: every rank's weights after two steps equal, bit for bit;
- the sharded serve at model_parallel=2 over 8 CPU devices against JAX's on
  the same mesh: float32 within 1e-5; int8 within tests/test_quantize.py's
  budgets (heatmaps 0.02, depth 5e-3, centers 0.25).
"""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from object_keypoints_tpu import parallel as jparallel  # noqa: E402
from object_keypoints_tpu.models import KeypointNet as JKeypointNet  # noqa: E402
from object_keypoints_tpu.serving import export as jexport  # noqa: E402
from object_keypoints_tpu.serving import sharded as jsharded  # noqa: E402
from object_keypoints_tpu.serving.quantize import calibrate_activation_scales  # noqa: E402
from object_keypoints_tpu.training import losses as jlosses  # noqa: E402
from object_keypoints_tpu.training import trainer as jtrainer  # noqa: E402
from object_keypoints_tpu_torch import parallel, testing  # noqa: E402
from object_keypoints_tpu_torch.models import blocks  # noqa: E402
from object_keypoints_tpu_torch.models.keypoint_net import KeypointNet  # noqa: E402
from object_keypoints_tpu_torch.ops.int8_conv import quantize as quantize_codes  # noqa: E402
from object_keypoints_tpu_torch.parallel import tensor  # noqa: E402
from object_keypoints_tpu_torch.serving import export, quantize, sharded, weights  # noqa: E402
from object_keypoints_tpu_torch.training import trainer  # noqa: E402
from test_torch_port_model import randomize  # noqa: E402

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GRID = dict(heatmaps_out=3, features=8, dropout=0.0, stacks=2, levels=2, dims=(256, 256, 512),
            mods=(1, 1, 1), stem_features=(8, 256), cnv_dim=256)
ARCH = dict(stacks=2, levels=2, mods=(1, 1, 1))
WORLD, MODEL_PARALLEL = 4, 2
GLOBAL_BATCH, SIZE = 4, 32
STEP_OPT = dict(lr=1e-3, plateau_patience=1000)
CLIP_OPT = dict(STEP_OPT, grad_clip=1e-3)
RANK_TIMEOUT = 150  # seconds for the launch of the four ranks, start-up included
B1 = 0.9  # optax.adamw's


def jax_variables(seed=1, size=SIZE):
    model = JKeypointNet(**GRID)
    init = model.init({"params": jax.random.key(seed)}, jnp.zeros((1, size, size, 3)), train=False)
    return model, randomize(init, np.random.default_rng(seed))


def global_batch(seed=0):
    batch = testing.synthetic_batch(seed, n=GLOBAL_BATCH, size=SIZE, k=3)
    return {k: v.astype(np.float64) for k, v in batch.items()}


# --- the grid and the rule ----------------------------------------------------------------


@pytest.fixture(scope="module")
def full_width():
    """The full-width valve KeypointNet in both packages: the port's module
    and JAX's parameter shapes (``jax.eval_shape``, nothing computed)."""
    model = JKeypointNet(heatmaps_out=3)
    shapes = jax.eval_shape(lambda: model.init({"params": jax.random.key(0)},
                                               jnp.zeros((1, 127, 127, 3)), train=False))
    return KeypointNet(heatmaps_out=3), shapes["params"]


@pytest.mark.parametrize("model_parallel,count", [(2, 62), (4, 62)])
def test_sharded_paths_are_the_jax_list(full_width, model_parallel, count):
    port, params = full_width
    grid = jparallel.create_mesh(model_parallel=model_parallel)
    want = jparallel.model_sharded_paths(params, grid)
    mesh = parallel.create_mesh(["cpu"] * 8, model_parallel=model_parallel)
    assert parallel.model_sharded_paths(port, mesh) == want and len(want) == count
    specs = jparallel.param_specs(params, grid)
    flat = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))}
    got = parallel.param_specs(port, mesh)
    assert set(got) == set(flat)
    for path, spec in got.items():
        assert P(*spec) == flat[path], path


def test_sharded_paths_map_to_the_torch_dim(full_width):
    """Each sharded flax kernel (kh, kw, in, out) is a Conv2d whose weight's
    dim 0 is out, or a ConvTranspose2d whose weight's dim 1 is out; every
    other conv stays whole."""
    port, params = full_width
    mesh = parallel.create_mesh(["cpu"] * 8, model_parallel=2)
    paths = set(parallel.model_sharded_paths(port, mesh))
    by_path = {"".join(f"[{p!r}]" for p in (*fp.split("/"), "kernel")): name
               for name, (fp, _) in weights.conv_module_paths().items()}
    wide = dict(parallel.wide_convs(port, 2))
    assert {by_path[p] for p in paths} == set(wide)
    flat = {jax.tree_util.keystr(p): v.shape for p, v in jax.tree_util.tree_leaves_with_path(params)}
    kinds = {"Conv2d": 0, "ConvTranspose2d": 0}
    for path in paths:
        conv = wide[by_path[path]]
        dim = tensor.sharded_dim(conv)
        assert dim == (1 if isinstance(conv, torch.nn.ConvTranspose2d) else 0)
        assert conv.weight.shape[dim] == flat[path][-1] >= 256
        kinds[type(conv).__name__] += 1
    assert kinds == {"Conv2d": 54, "ConvTranspose2d": 8}
    assert sum(conv.groups > 1 for conv in wide.values()) == 14  # the depthwise fire convs


def test_grid_is_the_jax_row_major_grid():
    grid = jparallel.create_mesh(model_parallel=2)
    ids = np.vectorize(lambda d: d.id)(grid.devices)
    devices = [torch.device("cpu", i) for i in range(8)]
    mesh = parallel.create_mesh(devices, model_parallel=2)
    assert mesh.shape == dict(grid.shape) == {"data": 4, "model": 2}
    assert [[d.index for d in row] for row in mesh.rows] == ids.tolist()
    assert parallel.create_mesh(["cpu", "cpu"]) == (torch.device("cpu"),) * 2  # the data axis
    with pytest.raises(ValueError) as port_error:
        parallel.create_mesh(["cpu"] * 6, model_parallel=4)
    with pytest.raises(ValueError) as jax_error:
        jparallel.create_mesh(jax.devices()[:6], model_parallel=4)
    assert str(port_error.value) == str(jax_error.value)


def test_shard_params_needs_the_groups_grid():
    """Outside a process group there are no model groups to shard over; a
    data-only mesh leaves the model whole."""
    model = KeypointNet(**GRID)
    with pytest.raises(ValueError, match="create_mesh"):
        parallel.shard_params(model, parallel.create_mesh(["cpu"] * 4, model_parallel=2))
    assert parallel.shard_params(model, parallel.create_mesh(["cpu"] * 4)) is model
    assert parallel.sharded_mask(model) is None


# --- one sharded module in one process ------------------------------------------------------


CONVS = {
    "conv3x3": (lambda: blocks.Conv2d(64, 256, 3, padding=1, bias=False), 64),
    "conv1x1_bias": (lambda: blocks.Conv2d(32, 512, 1, bias=True), 32),
    "depthwise": (lambda: blocks.Conv2d(256, 256, 3, padding=1, groups=256, bias=False), 256),
    "conv_transpose": (lambda: blocks.ConvTranspose2d(256, 256, 4, stride=2, padding=1), 256),
}


@pytest.mark.parametrize("count", [2, 4])
@pytest.mark.parametrize("kind", sorted(CONVS))
def test_shards_of_one_conv_equal_the_whole_conv(kind, count):
    make, cin = CONVS[kind]
    torch.manual_seed(0)
    conv = make().double()
    split = sharded.DeviceShardedConv(conv, [torch.device("cpu")] * count)
    x = torch.randn(2, cin, 6, 6, dtype=torch.float64, requires_grad=True)
    y = conv(x)
    g = torch.randn_like(y)
    gx, gw = torch.autograd.grad(y, (x, conv.weight), g)
    x2 = x.detach().clone().requires_grad_()
    y2 = split(x2)
    gx2, *gws = torch.autograd.grad(y2, [x2] + [s.weight for s in split.shards], g)
    for got, want in ((y2, y), (gx2, gx), (torch.cat(gws, tensor.sharded_dim(conv)), gw)):
        assert got.shape == want.shape
        assert (got - want).abs().max() <= 1e-12 * want.abs().max()


@pytest.mark.parametrize("transpose", [False, True])
def test_shards_of_an_int8_conv_equal_the_whole_int8_conv(transpose):
    torch.manual_seed(1)
    conv = (blocks.ConvTranspose2d(256, 256, 4, stride=2, padding=1) if transpose
            else blocks.Conv2d(64, 256, 3, padding=1, bias=True))
    with torch.no_grad():
        conv.bias.normal_()
    whole = quantize.Int8Conv(conv, 2.5, "p")
    split = sharded.DeviceShardedConv(whole, [torch.device("cpu")] * 2)
    assert [s.out_channels for s in split.shards] == [128, 128]
    x = torch.randn(2, conv.in_channels, 5, 5)
    with torch.inference_mode():
        torch.testing.assert_close(split(x), whole(x), rtol=0, atol=0)
        torch.testing.assert_close(torch.cat([s.int8_weight() for s in split.shards],
                                             tensor.sharded_dim(conv)), whole.int8_weight(),
                                   rtol=0, atol=0)
        xq = quantize.QuantizedActivation(quantize_codes(x, 127 / 2.5), 2.5, torch.float32)
        torch.testing.assert_close(split(xq), whole(xq), rtol=0, atol=0)
    with pytest.raises(ValueError, match="multiple of 8"):
        whole.output_shard(0, 64)  # 4 channels a shard: not a GEMM width


# --- the train step over a (2, 2) grid of gloo ranks ---------------------------------------


def assert_grads_close(names, got, want, rtol):
    """Each gradient tensor within ``rtol`` of its norm, floored at 1e-3 of
    the whole gradient's."""
    floor = 1e-3 * torch.linalg.vector_norm(torch.stack([w.norm() for w in want]))
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape and g.dtype == torch.float64, name
        assert (g - w).norm() <= rtol * max(w.norm(), floor), name


def run_ranks(tmp_path, spec):
    spec_path, out = str(tmp_path / "spec.pt"), str(tmp_path / "out")
    torch.save(spec, spec_path)
    results = testing.launch_ranks(["-m", "object_keypoints_tpu_torch.testing", "steps",
                                    spec_path, out], WORLD, RANK_TIMEOUT,
                                   env={"PYTHONPATH": str(ROOT)})
    for code, _, err in results:
        assert code == 0, err[-4000:]
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(WORLD)]


@pytest.fixture(scope="module")
def grid_steps(tmp_path_factory):
    """One launch of four gloo ranks on a (data 2, model 2) grid: run 0 one
    float64 step, run 1 one float64 step clipped at 1e-3 (Adam's first moment
    recorded), run 2 two float64 steps with dropout 0.1."""
    _, variables = jax_variables()
    state_dict = weights.keypoint_net_state_dict(variables, **ARCH)
    batch = global_batch()
    spec = dict(model=GRID, state_dict=state_dict, device="cpu", backend="gloo", timeout=90,
                model_parallel=MODEL_PARALLEL,
                runs=[dict(dtype="float64", optimizer=STEP_OPT, batches=[batch]),
                      dict(dtype="float64", optimizer=CLIP_OPT, batches=[batch], moments=True),
                      dict(dtype="float64", optimizer=STEP_OPT, batches=[batch] * 2,
                           model=dict(dropout=0.1))])
    outs = run_ranks(tmp_path_factory.mktemp("grid"), spec)
    return variables, state_dict, batch, outs


def one_process_step(state_dict, batch, opt=STEP_OPT):
    model = KeypointNet(**GRID)
    model.load_state_dict(state_dict)
    state = trainer.create_train_state(model.double(), trainer.make_optimizer(**opt),
                                       torch.float64, device="cpu")
    loss, metrics, grads = trainer.loss_and_grads(state, batch)
    trainer.apply_gradients(state, grads, loss)
    evaluated = {k: v.item() for k, v in trainer.eval_step(state, batch).items()}
    return ({k: v.item() for k, v in metrics.items()}, grads, model.state_dict(), evaluated,
            state.opt_state.mu)


def test_ranks_sit_on_the_grid_and_shard(grid_steps):
    outs = grid_steps[-1]
    assert [(o["rank"], o["data_rank"], o["model_rank"]) for o in outs] == [
        (0, 0, 0), (1, 0, 1), (2, 1, 0), (3, 1, 1)]
    names = [n for n, _ in KeypointNet(**GRID).named_parameters()]
    assert all(len(o["runs"][0]["grads"]) == len(names) for o in outs)


def test_grid_step_equals_one_process_on_the_whole_batch(grid_steps):
    _, state_dict, batch, outs = grid_steps
    metrics, grads, after, evaluated, _ = one_process_step(state_dict, batch)
    names = [n for n, _ in KeypointNet(**GRID).named_parameters()]
    for out in outs:
        run = out["runs"][0]
        assert set(run["metrics"][0]) == set(metrics)
        for k, want in metrics.items():
            np.testing.assert_allclose(run["metrics"][0][k], want, rtol=1e-10, err_msg=k)
        # eval_step on each data row's half: the whole batch's metrics
        assert set(run["eval"]) == set(evaluated)
        for k, want in evaluated.items():
            np.testing.assert_allclose(run["eval"][k], want, rtol=1e-10, err_msg=k)
        assert_grads_close(names, run["grads"], grads, 1e-10)
        moved = {name: g.abs() > 1e-6 for name, g in zip(names, grads)}
        for k, want in after.items():
            got = run["state_dict"][k]
            if k in moved:
                got, want = got[moved[k]], want[moved[k]]
            torch.testing.assert_close(got, want, rtol=0, atol=1e-12, msg=lambda m: f"{k}: {m}")


def jax_sharded_step(variables, batch, opt=STEP_OPT):
    """The JAX package's step with its params placed by ``shard_params`` over
    a 4-device mesh at model_parallel=2 and the batch over ``data``, in
    float64: (metrics, gradients, weights after the step) in the port's
    layout, and the number of kernels on the ``model`` axis."""
    with jax.enable_x64(True):
        model = JKeypointNet(**GRID, dtype=jnp.float64)
        v = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), variables)
        grid = jparallel.create_mesh(devices=jax.devices()[:WORLD], model_parallel=MODEL_PARALLEL)
        params = jparallel.shard_params(v["params"], grid)
        stats = jax.device_put(v["batch_stats"], NamedSharding(grid, P()))
        jbatch = {k: jax.device_put(jnp.asarray(a, jnp.float64),
                                    jparallel.batch_sharding(grid, a.ndim))
                  for k, a in batch.items()}

        @jax.jit
        def value_and_grad(params, batch_stats):
            def loss_fn(p):
                outs, new = model.apply({"params": p, "batch_stats": batch_stats},
                                        jtrainer.prepare_frames(jbatch["frame"], jnp.float64),
                                        train=True, mutable=["batch_stats"])
                total, hm, dl, cl = jlosses.keypoint_loss(
                    outs.heatmaps, jbatch["heatmaps"], outs.depth, jbatch["depth"], outs.centers,
                    jbatch["centers"])
                metrics = {"loss": total}
                for i, (h, d, c) in enumerate(zip(hm, dl, cl)):
                    metrics.update({f"heatmap_loss{i + 1}": h, f"depth_loss{i + 1}": d,
                                    f"center_loss{i + 1}": c})
                return total, (new["batch_stats"], metrics)

            return jax.value_and_grad(loss_fn, has_aux=True)(params)

        (loss, (stats, metrics)), grads = value_and_grad(params, stats)
        tx = jtrainer.make_optimizer(**opt)
        updates, _ = tx.update(grads, tx.init(params), params, value=loss)
        after = optax.apply_updates(params, updates)
        metrics = {k: float(x) for k, x in metrics.items()}
        metrics["grad_norm"] = float(optax.global_norm(grads))
        n_sharded = len(jparallel.model_sharded_paths(params, grid))
        return (metrics, weights.keypoint_net_state_dict({"params": grads, "batch_stats": stats},
                                                         **ARCH),
                weights.keypoint_net_state_dict({"params": after, "batch_stats": stats}, **ARCH),
                n_sharded)


def test_grid_step_equals_the_jax_model_sharded_step(grid_steps):
    variables, _, batch, outs = grid_steps
    jmetrics, jgrads, final, n_sharded = jax_sharded_step(variables, batch)
    port = KeypointNet(**GRID)
    assert n_sharded == len(parallel.wide_convs(port, MODEL_PARALLEL)) == 28
    run = outs[0]["runs"][0]
    assert set(run["metrics"][0]) == set(jmetrics)
    for k, want in jmetrics.items():
        np.testing.assert_allclose(run["metrics"][0][k], want, rtol=1e-10, err_msg=k)
    names = [n for n, _ in port.named_parameters()]
    assert_grads_close(names, run["grads"], [jgrads[n] for n in names], 1e-8)
    for name in names:
        moved = jgrads[name].abs() > 1e-6
        torch.testing.assert_close(run["state_dict"][name][moved], final[name][moved], rtol=0,
                                   atol=1e-9, msg=lambda m: f"{name}: {m}")
    for name, _ in port.named_buffers():
        if "running" in name:
            torch.testing.assert_close(run["state_dict"][name], final[name], rtol=0, atol=1e-9,
                                       msg=lambda m: f"{name}: {m}")


def test_grid_clip_uses_the_whole_gradients_norm(grid_steps):
    _, state_dict, batch, outs = grid_steps
    metrics, grads, _, _, mu = one_process_step(state_dict, batch, CLIP_OPT)
    factor = CLIP_OPT["grad_clip"] / metrics["grad_norm"]
    assert factor < 1.0  # the clip trips
    for out in outs:
        run = out["runs"][1]
        np.testing.assert_allclose(run["metrics"][0]["grad_norm"], metrics["grad_norm"],
                                   rtol=1e-10)
        assert_grads_close([str(i) for i in range(len(mu))], run["mu"], mu, 1e-10)
        # the first moment is (1 - b1) * c * g: c is the one-process clip factor
        got = torch.cat([m.reshape(-1) for m in run["mu"]])
        g = torch.cat([t.reshape(-1) for t in grads])
        big = g.abs() > 1e-3 * g.abs().max()
        np.testing.assert_allclose((got[big] / ((1 - B1) * g[big])).numpy(), factor, rtol=1e-8)


def test_grid_with_dropout_keeps_every_rank_equal(grid_steps):
    """Dropout on: the two model ranks of a row draw one mask (seeded by the
    data rank), so after two steps every rank holds the same weights, bit
    for bit; the rows drew different masks."""
    outs = grid_steps[-1]
    runs = [o["runs"][2] for o in outs]
    for run in runs[1:]:
        for k, v in runs[0]["state_dict"].items():
            assert torch.equal(v, run["state_dict"][k]), k
    assert runs[0]["metrics"][0]["loss"] != outs[0]["runs"][0]["metrics"][0]["loss"]
    assert np.isfinite(runs[0]["metrics"][1]["loss"])


# --- the sharded serve over the 8 CPU devices -------------------------------------------------


@pytest.fixture(scope="module")
def served():
    model, variables = jax_variables(seed=3, size=64)
    port = KeypointNet(**GRID)
    port.load_state_dict(weights.keypoint_net_state_dict(variables, **ARCH))
    frames = np.random.default_rng(0).normal(size=(8, 3, 64, 64)).astype(np.float32)
    return model, variables, port, frames


def test_model_axis_serve_matches_jax(served):
    model, variables, port, frames = served
    grid = jparallel.create_mesh(model_parallel=2)
    want = jsharded.make_sharded_inference_fn(model, variables, mesh=grid)(frames)
    infer = sharded.make_sharded_inference_fn(port, devices=["cpu"] * 8, model_parallel=2)
    got = infer(frames)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="not divisible by 4 data rows"):
        infer(frames[:6])
    assert not any(isinstance(m, sharded.DeviceShardedConv) for m in port.modules())


def artifact_config():
    return {**GRID, "dims": list(GRID["dims"]), "mods": list(GRID["mods"]),
            "stem_features": list(GRID["stem_features"]), "input_size": 64,
            "keypoint_config": [1, 1]}


def test_model_axis_int8_serve_matches_jax(served, tmp_path):
    model, variables, port, frames = served
    calib = jnp.asarray(np.random.default_rng(3).normal(size=(2, 64, 64, 3)), jnp.float32)
    scales = calibrate_activation_scales(lambda b: model.apply(variables, b, train=False),
                                         [calib])
    jexport.export_model(str(tmp_path), artifact_config(), variables, quant_scales=scales)
    grid = jparallel.create_mesh(model_parallel=2)
    want = jsharded.load_sharded_inference_fn(str(tmp_path), mesh=grid)(frames)
    served_model, got_scales = export.load_served_model(str(tmp_path))
    infer = sharded.make_sharded_inference_fn(served_model, devices=["cpu"] * 8,
                                              quant_scales=got_scales, model_parallel=2)
    got = infer(frames)
    budgets = (0.02, 5e-3, 0.25)  # heatmaps, depth (m), centers (px): tests/test_quantize.py's
    for g, w, budget in zip(got, want, budgets):
        assert g.shape == w.shape
        assert np.abs(g.numpy() - np.asarray(w)).max() < budget
    # the int8 convs outside the hourglasses split, float convs inside them too
    loaded = sharded.load_sharded_inference_fn(str(tmp_path), devices=["cpu"] * 8,
                                               model_parallel=2)
    for a, b in zip(loaded(frames), got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    replica = quantize.quantize_model(KeypointNet(**GRID), got_scales)
    sharded.shard_across_devices(replica, [torch.device("cpu")] * 2)
    splits = [m for m in replica.modules() if isinstance(m, sharded.DeviceShardedConv)]
    assert sum(isinstance(m.shards[0], quantize.Int8Conv) for m in splits) > 0
    assert sum(not isinstance(m.shards[0], quantize.Int8Conv) for m in splits) > 0
