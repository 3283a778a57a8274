"""Port parity for the training loop and its tools: the metrics log, the
event file, checkpoints, ``training.loop``, and the train, package and
flagship CLIs, against the JAX package on the CPU.

Runs use the tiny KeypointNet of tests/test_training.py (features 8,
levels 2) at 511x511 on JAX-written synthetic valve sequences, dropout 0.
The port's host augmentation draws what the JAX package's draws for the
same seeds (tests/test_torch_port_data.py), so it stays on.

Tolerances, with what they were set from:
- the metrics log and the event file: equal records, lines and bytes
  (wall time and host name pinned);
- checkpoints: bit for bit;
- the loop against the JAX loop, from the JAX loop's own initial weights,
  over 2 epochs of 4 steps: with lr 0 the weights stay put, so each step's
  loss depends on its batch alone and is held at rel 1e-5 (float32 sums
  and the ~5e-5 px between the packages' keypoints; seen 8e-8), and each
  epoch's val_loss, which reads the running statistics, at rel 1e-4 (seen
  3.7e-6); with lr 1e-3 Adam's first updates, lr * g / (|g| + eps), turn
  float32 gradient differences of small elements into whole-lr steps, so
  the losses after the first step and the val_loss are held at rel 1e-2
  (seen 4.0e-3 and 1.4e-3), the first step's loss at rel 1e-5.
"""

import dataclasses
import functools
import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cv2")
h5py = pytest.importorskip("h5py")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax.traverse_util import flatten_dict  # noqa: E402

from object_keypoints_tpu.data import synthetic as jsynthetic  # noqa: E402
from object_keypoints_tpu.training import checkpoints as jcheckpoints  # noqa: E402
from object_keypoints_tpu.training import loop as jloop  # noqa: E402
from object_keypoints_tpu.utils import metrics as jmetrics  # noqa: E402
from object_keypoints_tpu.utils import tb_events as jtb_events  # noqa: E402
from object_keypoints_tpu_torch import testing  # noqa: E402
from object_keypoints_tpu_torch.cli import flagship, package_model  # noqa: E402
from object_keypoints_tpu_torch.cli import train as train_cli  # noqa: E402
from object_keypoints_tpu_torch.serving import weights  # noqa: E402
from object_keypoints_tpu_torch.training import checkpoints, loop, trainer  # noqa: E402
from object_keypoints_tpu_torch.utils import metrics, tb_events  # noqa: E402

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(levels=2, dims=(16, 16, 32), mods=(1, 1, 1), stem_features=(8, 16), cnv_dim=16)
ARCH = dict(stacks=2, levels=2, mods=(1, 1, 1))
RUN = dict(keypoint_config=[1, 3], batch_size=2, features=8, dropout=0.0, pool=4, seed=0,
           model_overrides=TINY)


@pytest.fixture(scope="module")
def tree(tmp_path_factory, calibration_file):
    """A JAX-written synthetic valve tree: 2 train sequences of 4 frames, 1
    val sequence of 3 (one padded val batch of 4)."""
    root = tmp_path_factory.mktemp("loop_tree")
    return jsynthetic.make_synthetic_dataset_tree(str(root), calibration_file, [1, 3],
                                                  n_train=2, n_val=1, n_frames=4)


def records(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def tiny_state(fill=None, seed=0):
    """A CPU train state of the tiny model; ``fill`` sets every parameter."""
    model = loop.build_model(loop.TrainConfig(**{**RUN, "seed": seed}))
    if fill is not None:
        with torch.no_grad():
            for p in model.parameters():
                p.fill_(fill)
    return trainer.create_train_state(model, trainer.make_optimizer(lr=1e-3), device="cpu")


def tiny_hparams():
    return dict(RUN)


def port_weight(state_dict):
    return state_dict["backbone.pre.0.conv.weight"]


# --- the metrics log and the event file -------------------------------------------------


def test_metrics_logger_and_print_match_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    monkeypatch.setattr(socket, "gethostname", lambda: "host")
    rows = [(10, {"loss": 1.5, "grad_norm": np.float32(2.25)}, ""),
            (20, {"val_loss": 0.125}, "val_"), (30, {"loss": float("inf")}, "")]
    lines = {}
    for name, module in (("jax", jmetrics), ("port", metrics)):
        logger = module.MetricsLogger(str(tmp_path / name), tensorboard=True)
        for step, values, prefix in rows:
            logger.log(step, values, prefix=prefix)
            module.print_metrics(step, values, every=10, extra="epoch=1")
        module.print_metrics(15, {"loss": 1.0}, every=10)
        logger.close()
        lines[name] = capsys.readouterr().out
    assert lines["port"] == lines["jax"] and lines["port"].count("\n") == 3
    assert records(tmp_path / "port") == records(tmp_path / "jax")
    names = {n: sorted(os.listdir(tmp_path / n)) for n in ("jax", "port")}
    assert names["port"] == names["jax"] == ["events.out.tfevents.1700000000.host",
                                             "metrics.jsonl"]
    event = names["jax"][0]
    assert ((tmp_path / "port" / event).read_bytes() == (tmp_path / "jax" / event).read_bytes())


def test_event_writer_writes_the_jax_bytes(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    monkeypatch.setattr(socket, "gethostname", lambda: "h")
    scalars = [(0, {"a": 1.0}), (7, {"loss": 3.25, "lr_scale": 0.1}), (2**40, {"x": -0.0})]
    files = []
    for name, module in (("jax", jtb_events), ("port", tb_events)):
        writer = module.EventFileWriter(str(tmp_path / name))
        for step, values in scalars:
            writer.add_scalars(step, values)
        writer.add_scalars(9, {"pinned": 2.0}, wall_time=99.0)
        writer.close()
        files.append(pathlib.Path(writer.path))
    assert files[0].name == files[1].name
    assert files[1].read_bytes() == files[0].read_bytes()
    assert tb_events.crc32c(b"123456789") == 0xE3069283  # the crc32c check value


# --- checkpoints -------------------------------------------------------------------------


class TestCheckpointBestTracking:
    """tests/test_training.py's TestCheckpointBestTracking on port train
    states: the best is tracked every epoch and written at flush, and
    best_val survives a new manager over the same directory."""

    def test_deferred_best_flush_and_sidecar(self, tmp_path):
        hparams = tiny_hparams()
        ckpt = checkpoints.CheckpointManager(str(tmp_path), hparams=hparams)
        assert ckpt.save_if_best(tiny_state(1.0), 1, 0.5, defer=True)
        assert not (tmp_path / checkpoints.BEST).exists()
        assert not ckpt.save_if_best(tiny_state(2.0), 2, 0.7, defer=True)
        ckpt.flush_best()
        best = ckpt.restore("best")
        assert float(best["val_loss"]) == 0.5 and int(best["step"]) == 1
        weights_, step = ckpt.restore_state_dict("best")
        assert step == 1 and bool((port_weight(weights_) == 1.0).all())

        # a new manager recovers best_val from the sidecar: a worse first
        # validation must not steal "best"
        ckpt2 = checkpoints.CheckpointManager(str(tmp_path))
        assert ckpt2.best_val == 0.5
        assert not ckpt2.save_if_best(tiny_state(3.0), 3, 0.6, defer=True)
        ckpt2.flush_best()  # no stash: nothing written
        assert bool((port_weight(ckpt2.restore_state_dict("best")[0]) == 1.0).all())
        assert ckpt2.save_if_best(tiny_state(4.0), 4, 0.1, defer=True)
        ckpt2.flush_best()
        assert float(ckpt2.restore("best")["val_loss"]) == 0.1
        assert bool((port_weight(ckpt2.restore_state_dict("best")[0]) == 4.0).all())
        assert json.loads((tmp_path / "best_val.json").read_text()) == {"val_loss": 0.1}
        assert checkpoints.CheckpointManager.load_hparams(str(tmp_path)) == json.loads(
            json.dumps(hparams))
        assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]

    def test_not_deferred_writes_at_once(self, tmp_path):
        ckpt = checkpoints.CheckpointManager(str(tmp_path), hparams=tiny_hparams())
        assert ckpt.save_if_best(tiny_state(1.5), 5, 0.25)
        assert (tmp_path / checkpoints.BEST).exists()
        assert bool((port_weight(ckpt.restore_state_dict("best")[0]) == 1.5).all())


def trained_state(steps=3, seed=0):
    """A tiny state a few steps in: Adam's moments, the plateau's running
    mean and the BatchNorm statistics all moved off their start."""
    state = tiny_state(seed=seed)
    state.tx = trainer.make_optimizer(lr=1e-3, plateau_patience=1, plateau_accumulation=2)
    state.opt_state = state.tx.init(state.params)
    from object_keypoints_tpu_torch.testing import synthetic_batch

    for i in range(steps):
        trainer.train_step(state, synthetic_batch(seed=i, n=2, size=64, k=3))
    return state


def test_last_round_trips_bit_for_bit(tmp_path):
    state = trained_state()
    assert state.opt_state.plateau_accumulated == 1 and state.opt_state.count == 3
    ckpt = checkpoints.CheckpointManager(str(tmp_path), hparams=tiny_hparams())
    ckpt.save_last(state, 3)
    restored = ckpt.restore("last")
    assert restored["step"] == 3
    got = state.model.state_dict()
    assert set(restored["model"]) == set(got)
    for k, v in got.items():
        assert torch.equal(restored["model"][k], v), k
    opt = checkpoints.opt_state_from_dict(restored["opt_state"], "cpu")
    for f in dataclasses.fields(trainer.OptState):
        want, have = getattr(state.opt_state, f.name), getattr(opt, f.name)
        if isinstance(want, list):
            assert len(have) == len(want) and all(torch.equal(a, b) for a, b in zip(have, want))
        elif isinstance(want, torch.Tensor):
            assert torch.equal(have, want) and have.dtype == want.dtype, f.name
        else:
            assert have == want, f.name
    assert weights_equal(ckpt.restore_state_dict("last")[0], got)


def weights_equal(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a
                                    if not k.endswith("num_batches_tracked"))


def test_jax_package_restores_the_ports_best(tmp_path):
    """The JAX CheckpointManager reads best.msgpack: its weights are the
    port's through the bridge, bit for bit."""
    state = trained_state()
    ckpt = checkpoints.CheckpointManager(str(tmp_path), hparams=tiny_hparams())
    ckpt.save_if_best(state, 3, 0.75)
    restored = jcheckpoints.CheckpointManager(str(tmp_path)).restore("best")
    assert int(restored["step"]) == 3 and float(restored["val_loss"]) == 0.75
    want = weights.keypoint_net_variables(state.model.state_dict(), **ARCH)
    for collection in ("params", "batch_stats"):
        got, ref = flatten_dict(restored[collection]), flatten_dict(want[collection])
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(np.asarray(got[k]), ref[k], err_msg=str(k))


def test_jax_package_cli_packages_a_port_checkpoint(tmp_path):
    """scripts/package_model.py reads a port checkpoint directory; its
    artifact holds the port package CLI's weights, bit for bit."""
    state = trained_state()
    run = tmp_path / "run"
    checkpoints.CheckpointManager(str(run), hparams=tiny_hparams()).save_if_best(state, 3, 0.5)
    ref = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "package_model.py"), "--model", str(run),
         "--out", str(tmp_path / "jax")], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert ref.returncode == 0, ref.stderr
    assert json.loads(ref.stdout.strip().splitlines()[-1]) == {
        "out": str(tmp_path / "jax"), "step": 3, "quantized_convs": 0}
    package_model.main(["--model", str(run), "--out", str(tmp_path / "port")])
    from object_keypoints_tpu_torch.serving.export import load_model

    (jax_model, jax_config), (port_model, port_config) = (
        load_model(str(tmp_path / name)) for name in ("jax", "port"))
    assert jax_config == port_config
    assert weights_equal(jax_model.state_dict(), port_model.state_dict())
    assert weights_equal(port_model.state_dict(), state.model.state_dict())


def test_deferred_best_is_a_copy(tmp_path):
    """The optimizer writes the parameters in place: a deferred best must
    keep the weights of its epoch, not follow the state."""
    state = trained_state(steps=1)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    ckpt = checkpoints.CheckpointManager(str(tmp_path), hparams=tiny_hparams())
    assert ckpt.save_if_best(state, 1, 0.5, defer=True)
    from object_keypoints_tpu_torch.testing import synthetic_batch

    for i in range(2):
        trainer.train_step(state, synthetic_batch(seed=10 + i, n=2, size=64, k=3))
    after = state.model.state_dict()
    assert not torch.equal(port_weight(after), port_weight(before))
    ckpt.flush_best()
    assert weights_equal(ckpt.restore_state_dict("best")[0], before)


# --- the loop ------------------------------------------------------------------------------


def jax_initial_state_dict(config):
    """The JAX loop's initial weights (the split of jax.random.key(seed) at
    its loop.py:160-166) as a port state_dict."""
    model = jloop.build_model(config)
    init_rng, _ = jax.random.split(jax.random.key(config.seed))
    variables = model.init({"params": init_rng}, jnp.zeros((1, 511, 511, 3), model.dtype),
                           train=False)
    return weights.keypoint_net_state_dict(jax.tree.map(np.asarray, variables), **ARCH)


def start_from(monkeypatch, state_dict):
    build = loop.build_model

    def build_model(config):
        model = build(config)
        model.load_state_dict(state_dict)
        return model

    monkeypatch.setattr(loop, "build_model", build_model)


@pytest.mark.parametrize("lr, later_rtol", [(0.0, 1e-5), (1e-3, 1e-2)], ids=["lr0", "lr1e-3"])
def test_loop_matches_the_jax_loop(tree, tmp_path, monkeypatch, lr, later_rtol):
    """The host pipeline (OKT_DEVICE_DATA=0, the JAX loop's on its 2-device
    CPU mesh): 2 epochs of 4 steps, each step logged, from the JAX loop's
    initial weights."""
    monkeypatch.setenv("OKT_DEVICE_DATA", "0")
    monkeypatch.setenv("OKT_CACHE_VAL", "1")
    train_dir, val_dir = tree
    kw = dict(RUN, train=train_dir, val=val_dir, lr=lr, epochs=2, log_every=1)
    jconfig = jloop.TrainConfig(out_dir=str(tmp_path / "jax"), **kw)
    want = jloop.train(jconfig)
    start_from(monkeypatch, jax_initial_state_dict(jconfig))
    got = loop.train(loop.TrainConfig(out_dir=str(tmp_path / "port"), **kw), device="cpu")

    assert got["steps"] == want["steps"] == 8
    val_rtol = 1e-4 if lr == 0 else 1e-2
    np.testing.assert_allclose(got["best_val_loss"], want["best_val_loss"], rtol=val_rtol)
    theirs, ours = records(tmp_path / "jax"), records(tmp_path / "port")
    assert [(r["step"], sorted(r)) for r in ours] == [(r["step"], sorted(r)) for r in theirs]
    assert [r["step"] for r in ours if "val_loss" in r] == [4, 8]
    for mine, ref in zip(ours, theirs):
        if "val_loss" in ref:
            np.testing.assert_allclose(mine["val_loss"], ref["val_loss"], rtol=val_rtol)
        else:
            rtol = 1e-5 if mine["step"] == 1 else later_rtol
            np.testing.assert_allclose(mine["loss"], ref["loss"], rtol=rtol, err_msg=mine["step"])


@pytest.mark.parametrize("budget, renders", [("every field", 1), ("frames only", 3)])
def test_val_batches_render_once_when_they_fit(tree, tmp_path, monkeypatch, budget, renders):
    """The val split is rendered once and replayed when the whole padded
    batches fit the budget, every field counted: a budget that the frames
    alone fit leaves the cache off (the JAX loop counts frame bytes only)."""
    monkeypatch.setenv("OKT_CACHE_VAL", "1")
    monkeypatch.setenv("OKT_DEVICE_DATA", "0")
    frame = 511 * 511 * 3
    fields = frame + 4 * 64 * 64 * (3 + 3 + 2 * 2)  # uint8 frame; heatmaps, depth, centers
    batch = 4  # 3 val frames padded to 2 x batch_size
    monkeypatch.setattr(loop, "VAL_CACHE_BUDGET_BYTES",
                        batch * (fields if budget == "every field" else frame))
    counts = {"val": 0}

    class CountingChain(loop.Chain):
        def __init__(self, datasets, shuffle=False, **kwargs):
            counts["val"] += not shuffle
            super().__init__(datasets, shuffle=shuffle, **kwargs)

    monkeypatch.setattr(loop, "Chain", CountingChain)
    train_dir, val_dir = tree
    result = loop.train(loop.TrainConfig(out_dir=str(tmp_path), train=train_dir, val=val_dir,
                                         lr=1e-3, epochs=3, log_every=100, ckpt_every=100,
                                         steps_per_epoch=1, **RUN), device="cpu")
    assert np.isfinite(result["best_val_loss"]) and result["steps"] == 3
    assert counts["val"] == renders, counts


def test_device_store_loop_on_the_cpu(tree, tmp_path, monkeypatch, capsys):
    """The device-store path on the CPU: the store is chosen, every epoch
    runs 4 steps, the records, checkpoints and artifact are written and the
    artifact serves the best weights."""
    monkeypatch.setenv("OKT_DEVICE_DATA", "1")
    train_dir, val_dir = tree
    config = loop.TrainConfig(out_dir=str(tmp_path / "run"), train=train_dir, val=val_dir,
                              lr=1e-3, epochs=2, log_every=2, ckpt_every=1, tensorboard=True,
                              **RUN)
    result = loop.train(config, device="cpu")
    assert "device store: 8 frames" in capsys.readouterr().out
    assert result["steps"] == 8 and np.isfinite(result["best_val_loss"])
    files = sorted(os.listdir(tmp_path / "run"))
    assert [f for f in files if not f.startswith("events.out.tfevents.")] == [
        "best.msgpack", "best_val.json", "export", "hparams.json", "last.pt", "metrics.jsonl"]
    assert len(files) == 7
    logged = records(tmp_path / "run")
    assert [r["step"] for r in logged] == [2, 4, 4, 6, 8, 8]
    assert {"loss", "grad_norm", "lr_scale"} <= set(logged[0])
    assert min(r["val_loss"] for r in logged if "val_loss" in r) == result["best_val_loss"]
    from object_keypoints_tpu_torch.serving.export import load_model

    served, served_config = load_model(result["export_dir"])
    best, _ = checkpoints.CheckpointManager(config.out_dir).restore_state_dict("best")
    assert weights_equal(served.state_dict(), best)
    assert served_config == checkpoints.model_config(json.loads(
        (tmp_path / "run" / "hparams.json").read_text()))


@pytest.mark.parametrize("fresh", [True, False], ids=["fresh optimizer", "exact optimizer"])
def test_resume_carries_the_step_on(tree, tmp_path, monkeypatch, fresh):
    """Resume through ``last``: weights, BatchNorm statistics and step
    restored; the optimizer fresh (the reference's --resume) or exact."""
    monkeypatch.setenv("OKT_DEVICE_DATA", "1")
    train_dir, val_dir = tree
    config = loop.TrainConfig(out_dir=str(tmp_path / "run"), train=train_dir, val=val_dir,
                              lr=1e-3, epochs=1, log_every=4, **RUN)
    loop.train(config, device="cpu")
    first = checkpoints.CheckpointManager(config.out_dir).restore("last")
    seen = {}
    build = loop.build_model

    def build_model(cfg):  # the model before the resumed weights go in
        seen["model"] = build(cfg)
        return seen["model"]

    monkeypatch.setattr(loop, "build_model", build_model)
    resumed = dataclasses.replace(config, out_dir=str(tmp_path / "resumed"), resume=config.out_dir,
                                  resume_fresh_optimizer=fresh)
    result = loop.train(resumed, device="cpu")
    assert result["steps"] == 8
    assert [r["step"] for r in records(resumed.out_dir)] == [8, 8]
    last = checkpoints.CheckpointManager(resumed.out_dir).restore("last")
    assert last["step"] == 8 and last["opt_state"]["count"] == (4 if fresh else 8)
    assert first["opt_state"]["count"] == 4
    # the resumed run started from the first run's weights, not fresh ones
    assert not weights_equal(seen["model"].state_dict(), build(config).state_dict())


def test_fit_runs_on_the_card_unless_asked(tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device does not raise")
    train_dir, val_dir = tree
    config = loop.TrainConfig(out_dir=str(tmp_path), train=train_dir, val=val_dir, **RUN)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loop.train(config)


# --- the CLIs ------------------------------------------------------------------------------


@pytest.fixture
def tiny_cli(monkeypatch):
    """The train CLI building the tiny model (it has no layout flags)."""
    monkeypatch.setattr(train_cli, "TrainConfig",
                        functools.partial(loop.TrainConfig, model_overrides=TINY))


def test_train_and_package_clis_on_the_cpu(tree, tmp_path, tiny_cli, capsys):
    train_dir, val_dir = tree
    out = tmp_path / "run"
    t0 = time.perf_counter()
    result = train_cli.main(["--train", train_dir, "--val", val_dir, "--keypoints",
                             str(ROOT / "config/valve.json"), "--batch-size", "2", "--pool", "4",
                             "--features", "8", "--dropout", "0", "--epochs", "1", "--lr", "1e-3",
                             "--out", str(out), "--depth-weight", "5", "--fp16", "--cpu"])
    seconds = time.perf_counter() - t0
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.rindex("{\n"):]) == result
    assert result["steps"] == 4 and np.isfinite(result["best_val_loss"])
    hparams = json.loads((out / "hparams.json").read_text())
    assert hparams["bf16"] is True and hparams["depth_weight"] == 5.0
    assert hparams["keypoint_config"] == [1, 3] and hparams["model_overrides"]["levels"] == 2
    assert seconds < 60, seconds

    for which in ("best", "last"):
        package = package_model.main(["--model", str(out), "--out", str(tmp_path / which),
                                      "--which", which])
        assert package == {"out": str(tmp_path / which), "step": 4, "quantized_convs": 0}
    for name in ("config.json", "params.msgpack"):
        assert (tmp_path / "best" / name).read_bytes() == (out / "export" / name).read_bytes()
    # one epoch: the best is the last
    assert (tmp_path / "last" / "params.msgpack").read_bytes() == (
        out / "export" / "params.msgpack").read_bytes()


@pytest.mark.parametrize("flags", [["--calibration-data", "data"], ["--per-channel"],
                                   ["--calibration-frames", "8"],
                                   ["--calibration-percentile", "99.9"], []])
def test_package_cli_refuses_int8(tmp_path, flags):
    """The name dates from before int8 calibration was ported: without
    ``--quantize`` the CLI writes no quant.json whatever calibration flags
    it is given, as scripts/package_model.py; on a directory without a
    checkpoint it raises and writes nothing."""
    with pytest.raises(FileNotFoundError):
        package_model.main(["--model", str(tmp_path), "--out", str(tmp_path / "a"), *flags])
    assert not (tmp_path / "a").exists()
    run = tmp_path / "run"
    ckpt = checkpoints.CheckpointManager(str(run), hparams=tiny_hparams())
    ckpt.save_if_best(tiny_state(), 1, 0.5)
    result = package_model.main(["--model", str(run), "--out", str(tmp_path / "a"), *flags])
    assert result["quantized_convs"] == 0
    assert sorted(os.listdir(tmp_path / "a")) == ["config.json", "params.msgpack"]


def test_train_cli_trains_over_two_processes(tree, tmp_path):
    """The train CLI under COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID
    with --cpu (two gloo ranks, each in its own process): both ranks train
    and print the same result; rank 0 alone writes the run."""
    train_dir, val_dir = tree
    out = tmp_path / "run"
    code = ("import functools, sys\n"
            "import torch\n"
            "from object_keypoints_tpu_torch.cli import train\n"
            "from object_keypoints_tpu_torch.training import loop\n"
            f"train.TrainConfig = functools.partial(loop.TrainConfig, model_overrides={TINY!r})\n"
            "torch.set_num_threads(1)\n"
            "train.main(sys.argv[1:])\n")
    flags = ["--train", train_dir, "--val", val_dir, "--keypoints",
             str(ROOT / "config/valve.json"), "--batch-size", "2", "--pool", "4",
             "--features", "8", "--dropout", "0", "--epochs", "1", "--out", str(out), "--cpu"]
    ranks = testing.launch_ranks(["-c", code, *flags], 2, 120, env={"PYTHONPATH": str(ROOT)})
    printed = []
    for code_, stdout, err in ranks:
        assert code_ == 0, err[-4000:]
        printed.append(json.loads(stdout[stdout.rindex("{\n"):]))
    # each process draws all 8 train frames in its own order, 2 a step
    assert printed[0] == printed[1] and printed[0]["steps"] == 4
    assert sorted(os.listdir(out)) == ["best.msgpack", "best_val.json", "export",
                                       "hparams.json", "last.pt", "metrics.jsonl"]
    assert [r["step"] for r in records(out)] == [4]  # rank 0's val record alone
    assert "[val]" in ranks[0][1] and "[val]" not in ranks[1][1]


def test_train_cli_raises_the_jax_contract_error(tree, tmp_path, monkeypatch):
    """NUM_PROCESSES without PROCESS_ID raises the JAX package's ValueError
    before anything is written."""
    from object_keypoints_tpu.parallel import initialize_distributed

    monkeypatch.setenv("COORDINATOR_ADDRESS", "127.0.0.1:1234")
    monkeypatch.setenv("NUM_PROCESSES", "2")
    monkeypatch.delenv("PROCESS_ID", raising=False)
    train_dir, val_dir = tree
    with pytest.raises(ValueError) as want:
        initialize_distributed()
    with pytest.raises(ValueError) as got:
        train_cli.main(["--train", train_dir, "--val", val_dir, "--out", str(tmp_path), "--cpu"])
    assert str(got.value) == str(want.value)
    assert not os.listdir(tmp_path)


def test_flagship_sequences_are_the_jax_trees(tmp_path, calibration_file, monkeypatch):
    """The flagship's in-memory sequences have the world points and poses
    of the JAX tree's sequences of the same names."""
    monkeypatch.chdir(ROOT)
    jax_root = tmp_path / "jax"
    jsynthetic.make_synthetic_dataset_tree(str(jax_root), calibration_file, [1, 3], n_train=2,
                                           n_val=1, n_frames=3, n_objects=2)
    for split, n in (("train", 2), ("val", 1)):
        built = flagship.synthetic_split(str(tmp_path / "port"), split, n, [1, 3], n_frames=3)
        assert [os.path.basename(d) for d, _ in built] == sorted(os.listdir(jax_root / split))
        for seq_dir, (poses, frames) in built:
            want_dir = jax_root / split / os.path.basename(seq_dir)
            assert json.loads((pathlib.Path(seq_dir) / "keypoints.json").read_text()) == \
                json.loads((want_dir / "keypoints.json").read_text())
            with h5py.File(want_dir / "data.hdf5", "r") as f:
                np.testing.assert_array_equal(poses, f["camera_transform"][:])
            assert len(frames) == 3 and frames[0].shape == (720, 1280, 3)


def test_flagship_cli_on_the_cpu(tmp_path, monkeypatch):
    """The recipe end to end at a tiny size: its files, and an eval.json
    with the keys of results/flagship/runA/eval.json."""
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(flagship, "N_TRAIN", 1)
    monkeypatch.setattr(flagship, "N_VAL", 1)
    monkeypatch.setattr(flagship, "N_FRAMES", 4)
    monkeypatch.setattr(flagship, "RECIPE", {**flagship.RECIPE, "batch_size": 2, "features": 8,
                                             "bf16": False, "model_overrides": TINY})
    summary, run = flagship.main(["--out", str(tmp_path), "--pool", "4", "--epochs", "1",
                                  "--cpu"])
    want = json.loads((ROOT / "results/flagship/runA/eval.json").read_text())
    got = json.loads((tmp_path / "eval.json").read_text())
    assert sorted(got) == sorted(want) and sorted(got["summary"]) == sorted(want["summary"])
    assert got["summary"] == summary and got["fast"] is True and got["ground_truth"] is False
    assert run["result"]["steps"] == 2 and run["card"] == "cpu"
    assert run["train_frames"] == 4 and run["val_frames"] == 4
    for name in ("metrics.jsonl", "hparams.json", "run.json", "best.msgpack", "last.pt"):
        assert (tmp_path / name).exists(), name
    assert json.loads((tmp_path / "hparams.json").read_text())["seed"] == 1
