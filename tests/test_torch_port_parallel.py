"""Port parity for multi-device training and serving: ``parallel``, the
synced BatchNorm, the trainer's reductions, ``training.loop`` and the train
CLI over a process group, and ``serving.sharded``, against the JAX package
on the CPU.

Process groups start only in child processes (``testing.launch_ranks``: gloo
on 127.0.0.1, a free port each launch, a deadline, every rank killed when one
fails): BatchNorm takes the synced path whenever a group is initialized, so
a group left in a pytest worker would change every later test there.

The model is the tiny KeypointNet of tests/test_torch_port_model.py (dropout
0), its weights from the JAX package through ``serving.weights``.

Tolerances, with what they were set from:
- a 2-rank gloo step in float64 against the port's one-process step on the
  concatenated batch: the loss, the metrics and ``eval_step``'s metrics
  after it rel 1e-10, every gradient
  tensor within 1e-10 of its norm, the updated weights and running
  statistics atol 1e-12 (seen 2.9e-14 of a tensor's norm, 4.4e-16 on the
  weights: the two sides differ only in the order of BatchNorm's sums);
- the same step against the JAX package's global step over a 2-device mesh
  in float64 (``jax.enable_x64``; flax's model and the package's
  ``keypoint_loss`` composed as ``loss_and_metrics`` composes them, without
  its float32 cast of the heads, which would round every gradient to
  float32): the loss and rank 0's metrics rel 1e-10 (seen 8.7e-16), every
  gradient tensor within 1e-8 of its norm (seen 3.3e-14), the running
  statistics and the updated weights atol 1e-9 (seen 4.4e-16; Adam's first
  step, lr g / (|g| + eps), is held where |g| is above 1e-6);
- the plateau schedule: both ranks' ``lr_scale`` after every step equal to
  JAX's, and the ranks' weights equal bit for bit;
- sharded serving over 8 CPU replicas against JAX's ``make_sharded_inference_fn``
  on the 8-device mesh: float32 within 1e-5 (tests/test_serving_sharded.py's;
  seen 6.0e-8); int8 against JAX's sharded int8 within 1e-4 (seen 6.0e-8;
  JAX holds its sharded int8 to its single-device int8 at 1e-4).
"""

import dataclasses
import json
import os
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cv2")
pytest.importorskip("h5py")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from object_keypoints_tpu import parallel as jparallel  # noqa: E402
from object_keypoints_tpu.data import combinators as jcomb  # noqa: E402
from object_keypoints_tpu.data import synthetic as jsynthetic  # noqa: E402
from object_keypoints_tpu.models import KeypointNet as JKeypointNet  # noqa: E402
from object_keypoints_tpu.serving import export as jexport  # noqa: E402
from object_keypoints_tpu.serving import sharded as jsharded  # noqa: E402
from object_keypoints_tpu.serving.quantize import calibrate_activation_scales  # noqa: E402
from object_keypoints_tpu.training import checkpoints as jcheckpoints  # noqa: E402
from object_keypoints_tpu.training import loop as jloop  # noqa: E402
from object_keypoints_tpu.training import losses as jlosses  # noqa: E402
from object_keypoints_tpu.training import trainer as jtrainer  # noqa: E402
from object_keypoints_tpu_torch import parallel, testing  # noqa: E402
from object_keypoints_tpu_torch.data import combinators  # noqa: E402
from object_keypoints_tpu_torch.models.keypoint_net import KeypointNet  # noqa: E402
from object_keypoints_tpu_torch.parallel import mesh  # noqa: E402
from object_keypoints_tpu_torch.serving import export, sharded, weights  # noqa: E402
from object_keypoints_tpu_torch.training import loop, trainer  # noqa: E402
from test_torch_port_model import TINY, randomize  # noqa: E402

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = dict(stacks=2, levels=2, mods=(1, 1, 1))
WORLD = 2
GLOBAL_BATCH = 4
STEP_OPT = dict(lr=1e-3, plateau_patience=1000)
# lr high enough that the tiny model's loss rises on the fixed batch: the
# plateau (patience 1) then cuts
PLATEAU_OPT = dict(lr=0.3, plateau_patience=1, plateau_accumulation=1)
PLATEAU_STEPS = 5
RANK_TIMEOUT = 120  # seconds for a launch of the ranks, start-up included


def jax_variables(seed=1):
    model = JKeypointNet(**TINY)
    init = model.init({"params": jax.random.key(seed)}, jnp.zeros((1, 64, 64, 3)), train=False)
    return model, randomize(init, np.random.default_rng(seed))


def global_batch(seed=0):
    batch = testing.synthetic_batch(seed, n=GLOBAL_BATCH, size=64, k=3)
    return {k: v.astype(np.float64) for k, v in batch.items()}


def run_ranks(tmp_path, mode, spec, world=WORLD):
    spec_path, out = str(tmp_path / f"{mode}_spec.pt"), str(tmp_path / f"{mode}_out")
    torch.save(spec, spec_path)
    results = testing.launch_ranks(["-m", "object_keypoints_tpu_torch.testing", mode, spec_path,
                                    out], world, RANK_TIMEOUT, env={"PYTHONPATH": str(ROOT)})
    for code, _, err in results:
        assert code == 0, err[-4000:]
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(world)], results


# --- one step and the plateau over two ranks ------------------------------------------


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """One launch of two gloo ranks: run 0 is one float64 step (lr 1e-3),
    run 1 is PLATEAU_STEPS steps on the same batch with patience 1."""
    _, variables = jax_variables()
    state_dict = weights.keypoint_net_state_dict(variables, **ARCH)
    batch = global_batch()
    spec = dict(model=TINY, state_dict=state_dict, device="cpu", backend="gloo", timeout=60,
                runs=[dict(dtype="float64", optimizer=STEP_OPT, batches=[batch]),
                      dict(dtype="float64", optimizer=PLATEAU_OPT,
                           batches=[batch] * PLATEAU_STEPS)])
    outs, _ = run_ranks(tmp_path_factory.mktemp("steps"), "steps", spec)
    return variables, state_dict, batch, outs


def one_process_step(state_dict, batch, opt=STEP_OPT):
    model = KeypointNet(**TINY)
    model.load_state_dict(state_dict)
    state = trainer.create_train_state(model.double(), trainer.make_optimizer(**opt),
                                       torch.float64, device="cpu")
    loss, metrics, grads = trainer.loss_and_grads(state, batch)
    trainer.apply_gradients(state, grads, loss)
    evaluated = {k: v.item() for k, v in trainer.eval_step(state, batch).items()}
    return {k: v.item() for k, v in metrics.items()}, grads, model.state_dict(), evaluated


def jax_global_steps(variables, batch, runs):
    """The JAX package's global step over a 2-device mesh in float64: for
    each (optimizer arguments, n) of ``runs``, ``n`` steps on ``batch`` from
    ``variables``, giving (metrics, gradients, lr_scale) after each step and
    the final weights, in the port's layout."""
    with jax.enable_x64(True):
        model = JKeypointNet(**TINY, dtype=jnp.float64)
        v = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), variables)
        grid = jparallel.create_mesh(devices=jax.devices()[:WORLD])
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

        results = []
        for opt, n in runs:
            tx = jtrainer.make_optimizer(**opt)
            params, stats = v["params"], v["batch_stats"]
            opt_state = tx.init(params)
            history = []
            for _ in range(n):
                (loss, (stats, metrics)), grads = value_and_grad(params, stats)
                updates, opt_state = tx.update(grads, opt_state, params, value=loss)
                params = optax.apply_updates(params, updates)
                metrics = {k: float(x) for k, x in metrics.items()}
                metrics["grad_norm"] = float(optax.global_norm(grads))
                history.append((metrics, weights.keypoint_net_state_dict(
                    {"params": grads, "batch_stats": stats}, **ARCH),
                    float(opt_state[-1].scale)))
            results.append((history, weights.keypoint_net_state_dict(
                {"params": params, "batch_stats": stats}, **ARCH)))
    return results


@pytest.fixture(scope="module")
def jax_steps(steps):
    variables, _, batch, _ = steps
    return jax_global_steps(variables, batch, [(STEP_OPT, 1), (PLATEAU_OPT, PLATEAU_STEPS)])


def test_two_rank_step_equals_one_process_on_the_whole_batch(steps):
    _, state_dict, batch, outs = steps
    metrics, grads, after, evaluated = one_process_step(state_dict, batch)
    names = [n for n, _ in KeypointNet(**TINY).named_parameters()]
    for out in outs:
        run = out["runs"][0]
        assert out["world"] == WORLD and set(run["metrics"][0]) == set(metrics)
        for k, want in metrics.items():
            np.testing.assert_allclose(run["metrics"][0][k], want, rtol=1e-10, err_msg=k)
        # eval_step on each rank's half: the whole batch's metrics (the depth
        # and center losses summed over the ranks, the rest averaged)
        assert set(run["eval"]) == set(evaluated)
        for k, want in evaluated.items():
            np.testing.assert_allclose(run["eval"][k], want, rtol=1e-10, err_msg=k)
        for name, got, want in zip(names, run["grads"], grads):
            assert got.dtype == torch.float64
            assert (got - want).norm() <= 1e-10 * want.norm(), name
        for k, want in after.items():
            torch.testing.assert_close(run["state_dict"][k], want, rtol=0, atol=1e-12,
                                       msg=lambda m: f"{k}: {m}")
    # the ranks hold the same weights, bit for bit
    for k, v in outs[0]["runs"][0]["state_dict"].items():
        assert torch.equal(v, outs[1]["runs"][0]["state_dict"][k]), k


def test_two_rank_step_equals_the_jax_global_step(steps, jax_steps):
    outs = steps[-1]
    history, final = jax_steps[0]
    jmetrics, jgrads, _ = history[0]
    run = outs[0]["runs"][0]
    assert set(run["metrics"][0]) == set(jmetrics)
    for k, want in jmetrics.items():
        np.testing.assert_allclose(run["metrics"][0][k], want, rtol=1e-10, err_msg=k)
    model = KeypointNet(**TINY)
    for (name, _), got in zip(model.named_parameters(), run["grads"]):
        want = jgrads[name]
        assert (got - want).norm() <= 1e-8 * want.norm(), name
        moved = want.abs() > 1e-6
        torch.testing.assert_close(run["state_dict"][name][moved], final[name][moved], rtol=0,
                                   atol=1e-9, msg=lambda m: f"{name}: {m}")
    for name, _ in model.named_buffers():
        if "running" in name:
            torch.testing.assert_close(run["state_dict"][name], final[name], rtol=0, atol=1e-9,
                                       msg=lambda m: f"{name}: {m}")


def test_plateau_cuts_on_the_global_loss_as_jax(steps, jax_steps):
    outs = steps[-1]
    history, _ = jax_steps[1]
    want = [scale for _, _, scale in history]
    assert min(want) < 1.0, want  # the schedule cut at least once
    for out in outs:
        run = out["runs"][1]
        np.testing.assert_allclose(run["lr_scale"], want, rtol=1e-6)
        np.testing.assert_allclose([m["loss"] for m in run["metrics"]],
                                   [m["loss"] for m, _, _ in history], rtol=1e-8)
    for k, v in outs[0]["runs"][1]["state_dict"].items():
        assert torch.equal(v, outs[1]["runs"][1]["state_dict"][k]), k


# --- the loop over two ranks ------------------------------------------------------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory, calibration_file):
    """The loop tests' JAX-written synthetic valve tree: 2 train sequences
    of 4 frames, 1 val sequence of 3."""
    root = tmp_path_factory.mktemp("parallel_tree")
    return jsynthetic.make_synthetic_dataset_tree(str(root), calibration_file, [1, 3],
                                                  n_train=2, n_val=1, n_frames=4)


LOOP_TINY = dict(levels=2, dims=(16, 16, 32), mods=(1, 1, 1), stem_features=(8, 16), cnv_dim=16)
RUN = dict(keypoint_config=[1, 3], batch_size=2, features=8, dropout=0.0, pool=4, seed=0,
           model_overrides=LOOP_TINY)


@pytest.mark.parametrize("rank", [0, 1])
def test_rank_draws_the_jax_host_batches_of_its_seed(tree, monkeypatch, rank):
    """Rank r's first host batch is the JAX host pipeline's with data seed
    seed + 1009 r (the JAX loop's per-process seeds, loop.py:145-155)."""
    train_dir, _ = tree
    config = loop.TrainConfig(train=train_dir, **RUN)
    monkeypatch.setattr(parallel, "rank", lambda: rank)
    seed = loop.data_seed(config)
    assert seed == config.seed + 1009 * rank

    def first_batch(sets, comb):
        next(iter(sets[0]))  # the loop's sample, taken before the batches
        chain = comb.Chain(sets, shuffle=True, seed=seed)
        return next(iter(comb.batched(comb.SamplingPool(chain, config.pool, seed=seed),
                                      config.batch_size)))

    got = first_batch(loop.sequences(loop._sequence_dirs(train_dir), config, train=True),
                      combinators)
    want = first_batch(jloop._build_sequences(train_dir, config.keypoint_config, seed=seed,
                                              augment=True, normalize=False), jcomb)
    assert set(got) == set(want)
    for k in want:
        if np.asarray(want[k]).dtype == np.uint8:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
        else:
            np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                       np.asarray(want[k], np.float64), rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def test_fit_over_two_ranks_writes_from_rank_zero(tree, tmp_path):
    train_dir, val_dir = tree
    out_dir = tmp_path / "run"
    config = dict(RUN, train=train_dir, val=val_dir, epochs=1, log_every=1, out_dir=str(out_dir))
    spec = dict(config=config, device="cpu", backend="gloo", timeout=60)
    outs, procs = run_ranks(tmp_path, "fit", spec)
    for out in outs:
        assert "single process" in out["device_data_error"]
        # each rank draws all 8 train frames in its own order, 2 a step
        assert out["result"]["steps"] == 4 and np.isfinite(out["result"]["best_val_loss"])
    assert outs[0]["result"] == outs[1]["result"]
    names = sorted(os.listdir(out_dir))
    assert names == ["best.msgpack", "best_val.json", "export", "hparams.json", "last.pt",
                     "metrics.jsonl"]
    with open(out_dir / "metrics.jsonl") as f:
        logged = [json.loads(line) for line in f]
    assert [r["step"] for r in logged] == [1, 2, 3, 4, 4]  # rank 0's log alone
    assert logged[-1]["val_loss"] == outs[0]["result"]["best_val_loss"]
    assert "[val]" in procs[0][1] and "[val]" not in procs[1][1]
    restored = jcheckpoints.CheckpointManager(str(out_dir)).restore("best")
    assert int(restored["step"]) == 4
    model, _ = export.load_model(str(out_dir / "export"))
    assert sum(p.numel() for p in model.parameters()) > 0


# --- the process group's contract ---------------------------------------------------------


def test_initialize_distributed_reads_the_jax_contract(monkeypatch):
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    calls = []
    monkeypatch.setattr(mesh.dist, "init_process_group", lambda *a, **k: calls.append((a, k)))
    assert parallel.initialize_distributed() is None and calls == []  # unset: nothing

    monkeypatch.setenv("COORDINATOR_ADDRESS", "127.0.0.1:29999")
    monkeypatch.setenv("NUM_PROCESSES", "2")
    with pytest.raises(ValueError) as port_error:
        parallel.initialize_distributed(device="cpu")
    with pytest.raises(ValueError) as jax_error:
        jparallel.initialize_distributed()
    assert str(port_error.value) == str(jax_error.value) and calls == []

    monkeypatch.setenv("PROCESS_ID", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parallel.initialize_distributed()
    assert parallel.initialize_distributed(device="cpu", timeout=30) == torch.device("cpu")
    (args, kwargs), = calls
    assert args == ("gloo",) and kwargs["init_method"] == "tcp://127.0.0.1:29999"
    assert kwargs["world_size"] == 2 and kwargs["rank"] == 1
    assert kwargs["timeout"].total_seconds() == 30
    calls.clear()
    monkeypatch.delenv("NUM_PROCESSES")  # the address alone: a group of one
    parallel.initialize_distributed(backend="nccl", device="cpu")
    assert calls[0][0] == ("nccl",) and calls[0][1]["world_size"] == 1
    assert not parallel.is_distributed() and parallel.world_size() == 1


def test_batch_sharding_slices_by_rank():
    batch = {"a": np.arange(8), "b": torch.arange(16).reshape(8, 2)}
    part = parallel.batch_sharding(batch, 1, 4)
    np.testing.assert_array_equal(part["a"], [2, 3])
    assert torch.equal(part["b"], torch.tensor([[4, 5], [6, 7]]))
    assert np.array_equal(parallel.batch_sharding(np.arange(4)), np.arange(4))  # no group
    with pytest.raises(ValueError, match="not divisible"):
        parallel.batch_sharding(np.arange(7), 0, 2)


def test_batchnorm_without_a_group_is_the_plain_path(monkeypatch):
    """Outside a process group the train-mode BatchNorm never calls a
    collective."""
    def refuse(*_):
        raise AssertionError("a collective outside a process group")

    monkeypatch.setattr(parallel, "all_reduce_autograd", refuse)
    monkeypatch.setattr(parallel, "all_reduce_", refuse)
    state = trainer.create_train_state(KeypointNet(**TINY), trainer.make_optimizer(),
                                       device="cpu")
    _, metrics = trainer.train_step(state, testing.synthetic_batch(0, n=2, size=64, k=3))
    assert np.isfinite(metrics["loss"].item())


# --- sharded serving ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    model, variables = jax_variables(seed=3)
    port = KeypointNet(**TINY)
    port.load_state_dict(weights.keypoint_net_state_dict(variables, **ARCH))
    frames = np.random.default_rng(0).normal(size=(8, 3, 64, 64)).astype(np.float32)
    return model, variables, port, frames


def test_sharded_serve_matches_jax_on_eight_replicas(served):
    model, variables, port, frames = served
    grid = jparallel.create_mesh(model_parallel=1)
    assert grid.shape["data"] == 8
    want = jsharded.make_sharded_inference_fn(model, variables, mesh=grid)(frames)
    infer = sharded.make_sharded_inference_fn(port, devices=["cpu"] * 8)
    got = infer(frames)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)
    single = export.make_inference_fn(KeypointNet(**TINY), device="cpu")  # other weights
    assert not torch.equal(single(frames)[0], got[0])
    with pytest.raises(ValueError, match="not divisible"):
        infer(frames[:7])


def artifact_config():
    return {**TINY, "dims": list(TINY["dims"]), "mods": list(TINY["mods"]),
            "stem_features": list(TINY["stem_features"]), "input_size": 64,
            "keypoint_config": [1, 1]}


def test_sharded_artifact_round_trip_and_int8_match_jax(served, tmp_path):
    model, variables, port, frames = served
    calib = jnp.asarray(np.random.default_rng(3).normal(size=(2, 64, 64, 3)), jnp.float32)
    scales = calibrate_activation_scales(lambda b: model.apply(variables, b, train=False),
                                         [calib])
    jexport.export_model(str(tmp_path / "float"), artifact_config(), variables)
    jexport.export_model(str(tmp_path / "int8"), artifact_config(), variables,
                         quant_scales=scales)
    for name, tol in (("float", 1e-5), ("int8", 1e-4)):
        path = str(tmp_path / name)
        want = jsharded.load_sharded_inference_fn(path)(frames)
        got = sharded.load_sharded_inference_fn(path, devices=["cpu"] * 8)(frames)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol, rtol=tol, err_msg=name)
    with pytest.raises(FileNotFoundError):
        sharded.load_sharded_inference_fn(str(tmp_path / "float"), devices=["cpu"],
                                          quantize="require")
    never = sharded.load_sharded_inference_fn(str(tmp_path / "int8"), devices=["cpu"] * 2,
                                              quantize="never")(frames)
    plain = export.load_inference_fn(str(tmp_path / "float"), device="cpu")(frames)
    for a, b in zip(never, plain):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_sharded_serve_asks_for_the_cards_and_the_data_axis_only(served, monkeypatch):
    _, _, port, _ = served
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sharded.make_sharded_inference_fn(port)
    assert parallel.create_mesh(["cpu", "cpu"]) == (torch.device("cpu"),) * 2

