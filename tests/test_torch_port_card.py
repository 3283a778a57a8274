"""Checks on the card that span the port's modules: training that must
learn, a full-width detector step and the full-width detectors' inference
that no benchmark cell runs, process groups and sharded serves sharing one
card, and the detector eval CLI in bf16.

Every test is marked ``gpu`` and skips without a CUDA card. The file imports
neither jax nor the JAX package:

    python -m pytest --noconftest tests/test_torch_port_card.py -q

Each result is held to the same work in one process, on the CPU, or to a
gate the port's CPU tests state; each test's docstring gives its
tolerances. Launches are read from ``utils.timer``'s counters with tracing
on. Process groups start in child processes only (``testing.launch_ranks``:
a free port on 127.0.0.1, a deadline, every rank killed when one fails).
"""

import copy
import json
import math
import os
import pathlib

import numpy
import pytest

torch = pytest.importorskip("torch")

from object_keypoints_tpu_torch.models.keypoint_net import KeypointNet  # noqa: E402
from object_keypoints_tpu_torch.testing import traced  # noqa: E402

pytestmark = pytest.mark.gpu
ROOT = pathlib.Path(__file__).resolve().parents[1]
CALIBRATION = "config/calibration.yaml"
LR = 4e-3  # the flagship recipe's
RANK_TIMEOUT = 300  # seconds for a launch of the ranks, start-up and the build included
GROUP_TIMEOUT = 120  # seconds a collective may wait
SMALL = dict(heatmaps_out=3, features=8, dropout=0.0, stacks=2, levels=2, dims=(16, 16, 32),
             mods=(1, 1, 1), stem_features=(8, 16), cnv_dim=16)
# a 256-wide level, so that the model axis has convs to split (28 of them at 2 shards)
WIDE = dict(SMALL, dims=(256, 256, 512), stem_features=(8, 256), cnv_dim=256)
FULL_WIDTH = dict(heatmaps_out=3)  # the valve KeypointNet at full width: KeypointNet's defaults


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _displayed_losses(text):
    return [float(line.split("loss ")[1]) for line in text.splitlines()
            if line.startswith("iter ") and ": loss " in line]


# --- training that must learn ----------------------------------------------------------


def test_valve_training_loss_falls_over_augmented_bf16_steps(cuda, tmp_path, monkeypatch):
    """100 augmented steps of train_step_device_data in bf16 over float32
    parameters (the full-width valve KeypointNet, dropout 0.1, lr 4e-3,
    batch 8) on a device store of 32 synthetic 511x511 frames with 2
    objects each: every loss finite, the mean of the last 10 below that of
    the first 10, the parameters still float32."""
    from object_keypoints_tpu_torch.testing import synthetic_datasets
    from object_keypoints_tpu_torch.training import device_data, trainer

    monkeypatch.chdir(ROOT)
    datasets = synthetic_datasets(str(tmp_path), CALIBRATION, (1, 3), n_sequences=2, n_frames=16,
                                  n_objects=2, seed=0)
    store = device_data.build_device_store(datasets, cuda)
    assert store.n_frames == 32 and store.frames.shape[1:] == (511, 511, 3)
    model = KeypointNet(**FULL_WIDTH, generator=torch.Generator().manual_seed(0))
    state = trainer.create_train_state(model, trainer.make_optimizer(lr=LR), torch.bfloat16,
                                       device=cuda)
    order = torch.Generator(device=cuda).manual_seed(3)
    augment = torch.Generator(device=cuda).manual_seed(4)
    losses = []
    for _ in range(100):
        indices = torch.randperm(store.n_frames, generator=order, device=cuda)[:8]
        _, metrics = device_data.train_step_device_data(state, store, indices, augment, (1, 1, 3))
        losses.append(metrics["loss"])
    losses = torch.stack(losses).cpu()
    assert torch.isfinite(losses).all()
    assert losses[-10:].mean() < losses[:10].mean(), losses.tolist()
    assert all(p.dtype == torch.float32 for p in state.model.parameters())


def _tiny_coco(tmp_path, n_images):
    from object_keypoints_tpu_torch.data.synthetic import make_synthetic_coco_dataset

    return make_synthetic_coco_dataset(str(tmp_path / "coco"), n_images=n_images,
                                       image_size=(64, 64), seed=0)


def _train_detector(arch, ann, images, snapshots, iterations, capsys):
    """cli.train_detector --tiny on the card (batch 8, lr 2.5e-3): its
    displayed losses, finite and the last below the first."""
    from object_keypoints_tpu_torch.cli import train_detector

    capsys.readouterr()
    state = train_detector.main([arch, "--annotations", ann, "--images", images, "--tiny",
                                 "--batch-size", "8", "--max-iter", str(iterations), "--lr",
                                 "2.5e-3", "--snapshot-every", str(iterations),
                                 "--snapshot-dir", snapshots])
    losses = _displayed_losses(capsys.readouterr().out)
    assert state.device.type == "cuda" and state.step == iterations
    assert os.path.exists(os.path.join(snapshots, f"{arch}_{iterations}.pth"))
    assert numpy.isfinite(losses).all() and losses[-1] < losses[0], (arch, losses)


def test_tiny_cornernet_squeeze_learns_on_the_card(cuda, tmp_path, capsys):
    """The JAX package's learning gate on the port's CLIs on the card: the
    tiny CornerNet-Squeeze trained 800 iterations by cli.train_detector
    over 64 synthetic 64x64 COCO images, then scored on them by
    cli.evaluate_detector --tiny: mAP > 0.3; the eval's float32 stem
    kernel launched once an image."""
    from object_keypoints_tpu_torch.cli import evaluate_detector

    ann, images = _tiny_coco(tmp_path, 64)
    snapshots = str(tmp_path / "nnet")
    _train_detector("CornerNet_Squeeze", ann, images, snapshots, 800, capsys)
    result, counts, _ = traced(lambda: evaluate_detector.main(
        ["CornerNet_Squeeze", "--annotations", ann, "--image-dir", images, "--tiny",
         "--testiter", "800", "--snapshot-dir", snapshots,
         "--result-dir", str(tmp_path / "results")]))
    assert "loading parameters at iteration: 800" in capsys.readouterr().out
    assert counts.get("stem.kernel") == 64  # float32 frames: the fp32 kernel
    assert result["mAP"] > 0.3, result["stats"]


def test_tiny_cornernet_saccade_loss_falls_on_the_card(cuda, tmp_path, capsys):
    """The tiny CornerNet-Saccade trained 100 iterations by
    cli.train_detector on the card over 64 synthetic 64x64 COCO images: its
    displayed loss falls."""
    ann, images = _tiny_coco(tmp_path, 64)
    _train_detector("CornerNet_Saccade", ann, images, str(tmp_path / "nnet"), 100, capsys)


# --- a full-width detector step that no cell runs ------------------------------------------


def test_saccade_full_width_train_steps_at_its_batch(cuda, tmp_path):
    """CornerNet-Saccade at full width, bf16 over float32 parameters, at its
    config's batch of 48 at 255x255 (the train CLI's saccade sampler over 8
    synthetic 480x640 COCO images): 12 steps on one batch resident on the
    card, every loss finite and the last below the first; each corner pool
    kernel launched 4 times a stack a step (``corner_pool.kernel`` counts
    both kernels: a forward and a backward in each pool's two spans); a
    warm step never waits for the card."""
    from object_keypoints_tpu_torch.cli.train_detector import batch_stream, build_model
    from object_keypoints_tpu_torch.data.coco import CocoDetectionDataset
    from object_keypoints_tpu_torch.data.synthetic import make_synthetic_coco_dataset
    from object_keypoints_tpu_torch.training import detection
    from object_keypoints_tpu_torch.utils.config import (
        CONFIG_DIR,
        DetectionConfig,
        SystemConfig,
        load_cfg,
    )

    arch = "CornerNet_Saccade"
    sys_cfg, db_cfg = load_cfg(CONFIG_DIR / f"{arch}.json")
    system_config = SystemConfig(snapshot_name=arch).update_config(sys_cfg)
    db_config = DetectionConfig(db_cfg)
    batch_size = system_config.batch_size
    assert batch_size == 48 and list(db_config["input_size"]) == [255, 255]
    ann, images = make_synthetic_coco_dataset(str(tmp_path / "coco"), n_images=8,
                                              image_size=(480, 640), seed=0)
    stream = batch_stream(CocoDetectionDataset(ann, images), db_config, batch_size, 1,
                          saccade=True)
    try:
        batch = next(stream)
    finally:
        stream.close()
    model, dtype = build_model(arch, db_config["categories"], tiny=False)
    state = detection.create_train_state(model, detection.make_detection_optimizer(system_config),
                                         dtype, cuda)
    fixed = detection.to_device(batch, cuda)
    assert dtype == torch.bfloat16 and fixed["images"].shape == (batch_size, 255, 255, 3)

    def step():
        return detection.saccade_train_step(state, fixed)[1]["loss"]

    losses, counts, spans = traced(lambda: torch.stack([step() for _ in range(12)]).cpu())
    pools = 4 * model.stacks * 12  # two corners a stack, two pools a corner
    assert counts.get("corner_pool.kernel") == 2 * pools
    assert spans["corner_pool.forward"] == spans["corner_pool.backward"] == pools
    assert torch.isfinite(losses).all() and losses[-1] < losses[0], losses.tolist()
    torch.cuda.set_sync_debug_mode("error")  # a warm step waits for nothing on the card
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode("default")


# --- the full-width detectors' inference, which no cell runs ---------------------------------

DETECT_IMAGE = (480, 640)  # COCO's typical size: non-square frames
HEAT_GAIN = -30.0  # the heat heads' shared class-0 kernel, so that seeded weights pair corners
DETECTORS = {  # config: (model, the frames of each scale without their channels)
    "CornerNet_Squeeze": ("CornerNet_Squeeze", [(1, 511, 767)]),
    "CornerNet": ("CornerNet", [(2, 511, 767)]),  # flip
    "CornerNet-multi_scale": ("CornerNet", [(2, 255, 383), (2, 383, 511), (2, 511, 767),
                                            (2, 639, 895), (2, 767, 1023)]),  # flip, merge
}


def _detection_config(name):
    from object_keypoints_tpu_torch.utils.config import CONFIG_DIR, DetectionConfig, load_cfg

    return DetectionConfig(load_cfg(CONFIG_DIR / f"{name}.json")[1])


def _detect_image():
    return numpy.random.default_rng(0).integers(0, 256, (*DETECT_IMAGE, 3), dtype=numpy.uint8)


def _decode_kwargs(config):
    return dict(K=config["top_k"], ae_threshold=config["ae_threshold"],
                kernel=config["nms_kernel"], num_dets=config["num_dets"])


def _canonical(dets):
    """Each image's rows by class and box, which the card and the CPU
    compute bit for bit (pixel indices plus gathered offsets); only the
    scores pass through the sigmoid."""
    return numpy.stack([d[numpy.lexsort((d[:, 3], d[:, 2], d[:, 1], d[:, 0], d[:, 7]))]
                        for d in dets])


def _card_decode_against_the_cpus(heads, kw, atol_box, atol_score):
    """The card's corner decode of ``heads`` against the CPU's of the same
    heads, in the canonical order: valid rows and classes equal, boxes and
    scores within the tolerances. Returns the card's detections on the
    host, in the card's order."""
    from object_keypoints_tpu_torch.ops.detection_decode import decode_detections

    card = decode_detections(*heads, **kw).cpu().numpy()
    got = _canonical(card)
    want = _canonical(decode_detections(*(h.cpu() for h in heads), **kw).numpy())
    assert (got[..., 4] > -1).sum() == (want[..., 4] > -1).sum()
    assert numpy.array_equal(got[..., 7], want[..., 7])
    numpy.testing.assert_allclose(got[..., :4], want[..., :4], rtol=0, atol=atol_box)
    numpy.testing.assert_allclose(got[..., 4:7], want[..., 4:7], rtol=0, atol=atol_score)
    return card


def _soft_nms_against_the_cpus(card, cpu, atol_box):
    """Per-class soft-NMS results: equal counts a class; boxes within
    ``atol_box`` px and scores within 1e-5, in box order."""
    for j, want in cpu.items():
        got = card[j]
        assert got.shape == want.shape, j
        got, want = (x[numpy.lexsort((x[:, 3], x[:, 2], x[:, 1], x[:, 0]))] for x in (got, want))
        numpy.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0, atol=atol_box)
        numpy.testing.assert_allclose(got[:, 4], want[:, 4], rtol=0, atol=1e-5)


def _boxes_hold(boxes, config):
    """Every class named, every box finite, no more than the cap (ties at
    the cap stay) and at least one."""
    assert sorted(boxes, key=int) == [str(i) for i in range(1, config["categories"] + 1)]
    for v in boxes.values():
        assert v.shape[1] == 5 and numpy.isfinite(v).all()
    assert 0 < sum(len(v) for v in boxes.values()) <= config["max_per_image"] + 5


def _stem_kernel_holds(model, frames):
    """The stem kernel on the model's own stem weights at each of the
    model's bf16 ``frames``: within one output ulp of the plain version,
    stated as rtol = atol = 1e-2."""
    from object_keypoints_tpu_torch.ops.stem_conv import fold_bn, stem_conv, stem_conv_plain
    from object_keypoints_tpu_torch.precision import no_tf32

    stem = model.hg.pre[0]
    w, bn = stem.conv.weight, stem.bn
    with torch.inference_mode(), no_tf32():
        scale, bias = fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
        for x in frames:
            assert x.dtype == torch.bfloat16
            torch.testing.assert_close(stem_conv(x, w, scale, bias).float(),
                                       stem_conv_plain(x, w, scale, bias).float(),
                                       atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("config_name", list(DETECTORS))
def test_full_width_detector_on_card_matches_the_cpu(cuda, config_name):
    """Detector, as the detect CLI runs it, at full width in bf16 from
    seeded weights with the heat heads planted, on a 480x640 synthetic
    image: CornerNet-Squeeze, CornerNet with flip, and CornerNet under the
    five-scale merge config. One call launches the stem kernel once a scale
    and the corner pools' forward kernel four times a scale (the last
    stack's heads), and gives finite boxes of the 80 classes, capped. Then
    each scale's corner decode on the card against the CPU's of the same
    heads (valid rows and classes equal, boxes within 1e-4 px, scores
    1e-5), and the stem kernel on the model's weights at the call's frames.
    Where one scale runs without merge: the soft-NMS on the card against
    the CPU's on the same detections (counts a class equal, boxes within
    1e-3 px, scores 1e-5), and the float32 forward (TF32 off) with the
    stem kernel against the plain stem, the last stack's heads within 1e-4
    x max(1, max |ref|) (rtol 1e-4)."""
    from object_keypoints_tpu_torch.inference import detector
    from object_keypoints_tpu_torch.models.cornernet import FACTORIES
    from object_keypoints_tpu_torch.ops.stem_conv import stem_conv_plain
    from object_keypoints_tpu_torch.precision import no_tf32
    from object_keypoints_tpu_torch.testing import plant_detector_heads

    arch, frames = DETECTORS[config_name]
    config = _detection_config(config_name)
    model = FACTORIES[arch](config["categories"], generator=torch.Generator().manual_seed(0))
    plant_detector_heads(model, HEAT_GAIN)
    det = detector.Detector(model, config, device=cuda, dtype=torch.bfloat16)
    image = _detect_image()
    scaled = [detector.scale_batch(config, image, s) for s in config["test_scales"]]
    assert [b.shape for b, _ in scaled] == [(*f, 3) for f in frames]
    assert config["merge_bbox"] == (config_name == "CornerNet-multi_scale")

    boxes, counts, spans = traced(lambda: det(image))
    assert counts.get("stem.kernel") == len(frames)  # bf16 frames: the bf16 kernel
    assert counts.get("corner_pool.kernel") == spans["corner_pool.forward"] == 4 * len(frames)
    _boxes_hold(boxes, config)

    kw = _decode_kwargs(config)
    xs, rows = [], []
    for batch, geometry in scaled:
        x = det.frames(batch)
        assert x.device.type == "cuda" and x.dtype == torch.bfloat16 and x.is_contiguous()
        with torch.inference_mode(), no_tf32():
            heads = model.heads(model.hg(x)[-1], model.stacks - 1)
            card = _card_decode_against_the_cpus(heads, kw, atol_box=1e-4, atol_score=1e-5)
        assert (card[..., 4] > -1).any()
        rows.append(detector.rescale_scale(config, card.copy(), geometry))
        xs.append(x)
    _stem_kernel_holds(model, xs)
    if len(frames) > 1:
        return

    detections = numpy.concatenate(rows, axis=1)[0]
    _soft_nms_against_the_cpus(detector.class_soft_nms(config, detections, cuda)[0],
                               detector.class_soft_nms(config, detections, "cpu")[0], 1e-3)
    x32 = xs[0].float()
    with torch.inference_mode(), no_tf32():
        got, counts, _ = traced(lambda: model(x32, test=True, **kw))
        want = model(x32, test=True, stem=stem_conv_plain, **kw)
    assert counts.get("stem.kernel") == 1  # float32 frames: the fp32 kernel
    for name, g, w in zip(("tl_heat", "br_heat", "tl_tag", "br_tag"), got[1:], want[1:]):
        assert torch.isfinite(g).all(), name
        ref = max(1.0, w.abs().max().item())
        torch.testing.assert_close(g, w, atol=1e-4 * ref, rtol=1e-4, msg=lambda m: f"{name}: {m}")


def test_full_width_saccade_on_card_matches_the_cpu(cuda):
    """SaccadeDetector, as the detect CLI runs it, at full width in bf16
    from seeded weights with the heat heads planted and the attention
    kernels x 4, on the 480x640 image: stage 1's two 255x255 views propose
    more than att_max_crops (30) locations, so stage 2 runs a full bucket
    of 32 crops. One call launches the stem kernel once a stage and the
    corner pools' forward kernel four times a stage, and gives finite boxes
    of the 80 classes, capped. Then each stage again from the locations it
    was given: stage 1's float32 crops on the card against the CPU's
    (1e-5, offsets equal); each stage's decode on the card equal to the
    fused stage's and held to the CPU's of the same heads (classes and
    boxes equal, scores within 1e-6); the host's bookkeeping on stage 1's
    copy back proposes what stage 2 cropped; the final soft-NMS (sigma 0.7)
    on the card against the CPU's on the same rows (steps equal, counts a
    class equal, boxes within 2e-4 px, scores 1e-5); the stem kernel on the
    model's weights at both stages' frames."""
    from object_keypoints_tpu_torch.inference import saccade
    from object_keypoints_tpu_torch.models.cornernet import cornernet_saccade
    from object_keypoints_tpu_torch.precision import no_tf32
    from object_keypoints_tpu_torch.testing import plant_detector_heads

    config = _detection_config("CornerNet_Saccade")
    model = cornernet_saccade(config["categories"], generator=torch.Generator().manual_seed(0))
    plant_detector_heads(model, HEAT_GAIN, att_gain=4.0)
    det = saccade.SaccadeDetector(model, config, device=cuda, dtype=torch.bfloat16)
    image = _detect_image()
    stats = []
    boxes, counts, spans = traced(lambda: det(image, stats=stats))
    stages, nms = stats[:-1], stats[-1]
    assert len(stages) == 2 and counts.get("stem.kernel") == 2  # bf16 frames: the bf16 kernel
    assert counts.get("corner_pool.kernel") == spans["corner_pool.forward"] == 8
    assert stages[0]["crops"] == len(config["init_sizes"])
    assert stages[0]["proposed"] > config["att_max_crops"], stages[0]["proposed"]
    assert stages[1]["crops"] == config["att_max_crops"] and stages[1]["bucket"] == 32
    assert stages[1]["no_att"] and nms["rows"] > 0 and nms["steps"] > 0
    _boxes_hold(boxes, config)

    height, width = image.shape[:2]
    image_dev = torch.from_numpy(image).to(cuda)
    kw = dict(_decode_kwargs(config), no_border=True)
    rows, xs = [], []
    for s in stages:
        m, scales = s["crops"], s["locations"][:, 2]
        locs = torch.from_numpy(saccade.pad_locations(config, s["locations"])).to(cuda)
        assert len(locs) == s["bucket"]
        canvases, offsets = det.crops(image_dev, locs[:, :2], locs[:, 2:])
        frames = det.frames(canvases)
        dets, atts, host_offsets = det.fetch(*det.forward(frames, s["no_att"]), offsets)
        with torch.inference_mode():
            if s is stages[0]:
                cpu_crops, cpu_offsets = saccade.crop_zoom_batch(
                    det.normalize(torch.from_numpy(image)), locs[:, :2].cpu(), locs[:, 2:].cpu(),
                    tuple(config["input_size"]))
                torch.testing.assert_close(canvases.cpu(), cpu_crops, atol=1e-5, rtol=0)
                assert torch.equal(offsets.cpu(), cpu_offsets)
            with no_tf32():
                heads = model.heads(model.hg(frames)[0][-1], model.stacks - 1)
                card = _card_decode_against_the_cpus(heads, kw, atol_box=0.0, atol_score=1e-6)
        assert numpy.array_equal(card, dets), "the fused stage and its parts disagree"

        kept, kept_offsets = dets[:m].copy(), host_offsets[:m]
        if s is stages[0]:
            proposed = saccade.decode_atts(config, [a[:m] for a in atts], config["att_scales"][0],
                                           scales, kept_offsets, height, width,
                                           config["att_thresholds"][0])
        saccade._rescale_remap(config, kept, scales, kept_offsets)
        kept = kept.reshape(-1, 8)
        kept = kept[kept[:, 4] > (0.3 if s is stages[0] else -1)]
        if s is stages[0]:
            if config["ref_dets"]:
                proposed = saccade.location_nms(
                    numpy.concatenate([proposed, saccade.get_ref_locs(kept)], axis=0), thresh=16)
            assert len(proposed) == s["proposed"]
            assert numpy.array_equal(stages[1]["locations"], proposed[:stages[1]["crops"]])
        rows.append(kept)
        xs.append(frames)

    detections = numpy.concatenate(rows, axis=0)
    assert len(detections) == nms["rows"]
    card, steps = saccade.saccade_soft_nms(config, detections, cuda)
    cpu, cpu_steps = saccade.saccade_soft_nms(config, detections, "cpu")
    assert steps == cpu_steps == nms["steps"]
    _soft_nms_against_the_cpus(card, cpu, 2e-4)
    _stem_kernel_holds(model, xs)


# --- process groups on one card ----------------------------------------------------------


def _ranks(tmp_path, mode, spec, world):
    """``testing.rank_steps`` or ``rank_fit`` in ``world`` child processes
    on the card; each rank's output."""
    from object_keypoints_tpu_torch.testing import launch_ranks

    spec_path, out = tmp_path / f"{mode}_{world}_spec.pt", tmp_path / f"{mode}_{world}_out"
    torch.save(spec, spec_path)
    results = launch_ranks(["-m", "object_keypoints_tpu_torch.testing", mode, str(spec_path),
                            str(out)], world, RANK_TIMEOUT, env={"PYTHONPATH": str(ROOT)},
                           cwd=str(ROOT))
    for rank, (code, stdout, err) in enumerate(results):
        assert code == 0, f"{mode} rank {rank} of {world} exited {code}:\n{stdout[-3000:]}\n{err[-6000:]}"
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(world)]


def _group_inputs(layout, seed):
    """Seeded weights (BatchNorm statistics at random) and a batch of 8
    synthetic 64x64 frames."""
    from object_keypoints_tpu_torch.testing import randomize_batchnorm, synthetic_batch

    model = KeypointNet(**layout, generator=torch.Generator().manual_seed(seed))
    randomize_batchnorm(model, torch.Generator().manual_seed(seed))
    return ({k: v.detach().clone() for k, v in model.state_dict().items()},
            synthetic_batch(seed, n=8, size=64))


def _one_process_step(layout, init, batch, device):
    """The first float32 step in this process, no group: (loss, gradients,
    weights and buffers after it)."""
    from object_keypoints_tpu_torch.training import trainer

    model = KeypointNet(**layout)
    model.load_state_dict(init)
    state = trainer.create_train_state(model, trainer.make_optimizer(lr=LR), torch.float32,
                                       device=device)
    loss, _, grads = trainer.loss_and_grads(state, batch)
    trainer.apply_gradients(state, grads, loss)
    return (loss.item(), [g.cpu() for g in grads],
            {k: v.detach().cpu() for k, v in model.state_dict().items()})


def _step_against(run, want, loss_rtol=1e-5):
    """A group's first float32 step against the one-process step: loss rel
    ``loss_rtol``, the whole gradient within 1e-2 of its norm, each running
    statistic within 1e-4 of its tensor's largest."""
    loss, grads, sd = want
    got_loss = run["metrics"][0]["loss"]
    loss_rel = abs(got_loss - loss) / abs(loss)
    grad_rel = (sum((g.double() - w.double()).square().sum() for g, w in zip(run["grads"], grads))
                / sum(w.double().square().sum() for w in grads)).sqrt().item()
    stats_rel = max(((run["state_dict"][k].double() - sd[k].double()).abs().max()
                     / sd[k].double().abs().max()).item() for k in sd if "running" in k)
    assert loss_rel <= loss_rtol and grad_rel <= 1e-2 and stats_rel <= 1e-4, (
        loss_rel, grad_rel, stats_rel)


@pytest.mark.parametrize("backend,world", [(None, 1), ("gloo", 2)], ids=["nccl-1", "gloo-2"])
def test_group_step_on_one_card_equals_one_process(cuda, tmp_path, backend, world):
    """One float32 step (TF32 off) over a process group on the card, the
    launch contract's variables set: a group of one over NCCL (the card's
    default backend), and two ranks sharing the card over gloo on 4 + 4 of
    the 8 frames, against the same step in this process on the 8 (loss rel
    1e-5, the whole gradient within 1e-2 of its norm, each running statistic
    within 1e-4 of its tensor's largest); the ranks' weights equal."""
    init, batch = _group_inputs(SMALL, 5)
    want = _one_process_step(SMALL, init, batch, cuda)
    outs = _ranks(tmp_path, "steps", dict(
        model=SMALL, state_dict=init, device="cuda", backend=backend, timeout=GROUP_TIMEOUT,
        runs=[dict(dtype="float32", optimizer=dict(lr=LR), batches=[batch])]), world)
    for out in outs:
        _step_against(out["runs"][0], want)
    for k, v in outs[0]["runs"][0]["state_dict"].items():
        assert torch.equal(v, outs[-1]["runs"][0]["state_dict"][k]), k


def test_two_ranks_fit_on_one_card(cuda, tmp_path):
    """loop.fit over two gloo ranks sharing the card (bf16, batch 4 a rank,
    3 steps, in-memory synthetic sequences per rank): device_data=True
    raises, both ranks return the same result, rank 0 alone writes the run,
    and its export serves on the card (the fp32 stem kernel once)."""
    from object_keypoints_tpu_torch.serving.export import load_inference_fn

    out_dir = tmp_path / "run"
    config = dict(keypoint_config=[1, 3], batch_size=4, lr=LR, bf16=True, seed=0, epochs=1,
                  steps_per_epoch=3, log_every=1, out_dir=str(out_dir), features=8,
                  model_overrides={k: SMALL[k] for k in ("levels", "dims", "mods",
                                                          "stem_features", "cnv_dim")})
    outs = _ranks(tmp_path, "fit", dict(
        config=config, device="cuda", backend="gloo", timeout=GROUP_TIMEOUT,
        synthetic=dict(root=str(tmp_path / "data"), n_train=2, n_frames=8, n_objects=2)), 2)
    assert outs[0]["result"] == outs[1]["result"]
    assert outs[0]["result"]["steps"] == 3 and "single process" in outs[0]["device_data_error"]
    assert sorted(os.listdir(out_dir)) == ["best.msgpack", "best_val.json", "export",
                                           "hparams.json", "last.pt", "metrics.jsonl"]
    with open(out_dir / "metrics.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2, 3, 3]
    frames = torch.randn(2, 3, 511, 511, generator=torch.Generator().manual_seed(1)).to(cuda)
    infer = load_inference_fn(str(out_dir / "export"), device=cuda)
    maps, counts, _ = traced(lambda: infer(frames))
    assert counts.get("stem.kernel") == 1  # float32 frames: the fp32 kernel
    for t in maps:
        assert t.device.type == "cuda" and torch.isfinite(t).all()


GRID_MODEL_PARALLEL = 2  # a (data 2, model 2) grid: four gloo ranks share the card
GRID_BIAS_SLACK = 1e-5  # float32 bias corrections move Adam's g / (|g| + eps) by < 7e-6 of itself
GRID_UPDATE_SLACK = 1e-6  # x lr: the update's own float32 roundings, a few 6e-8 of it


def _grid_weights_within_adams_bound(run, want):
    """Every weight after the grid's first float32 step within the bound
    that the two gradients set on it. Adam's first step (no clip, scale 1)
    moves a weight w by -lr * (f(g) + wd * w) with f(g) = g / (|g| + eps),
    so two steps from one w part by lr * |f(g) - f(g')|: at most lr * eps *
    |g - g'| / (min(|g|, |g'|) + eps)^2 where g and g' share a sign (f's
    slope on that interval), and at most lr * (|f(g)| + |f(g')|) everywhere
    (a sign that float32 noise flips). Each bound is widened by
    GRID_BIAS_SLACK of itself, by GRID_UPDATE_SLACK * lr and by one float32
    rounding of each weight."""
    from object_keypoints_tpu_torch.training.trainer import AdamWPlateau

    _, grads, sd = want
    eps, rounding = AdamWPlateau.eps, torch.finfo(torch.float32).eps
    names = [k for k in sd if k.rsplit(".", 1)[-1] not in ("running_mean", "running_var",
                                                            "num_batches_tracked")]
    for k, g, mine in zip(names, grads, run["grads"]):
        g, mine = g.double(), mine.double()
        w, w_mine = sd[k].double(), run["state_dict"][k].double()
        loose = g.abs() / (g.abs() + eps) + mine.abs() / (mine.abs() + eps)
        slope = eps * (g - mine).abs() / (torch.minimum(g.abs(), mine.abs()) + eps).square()
        bound = torch.where(g * mine > 0, torch.minimum(loose, slope), loose)
        bound = (LR * ((1 + GRID_BIAS_SLACK) * bound + GRID_UPDATE_SLACK)
                 + rounding * torch.maximum(w.abs(), w_mine.abs()))
        assert ((w_mine - w).abs() <= bound).all(), k


def test_model_axis_grid_step_on_one_card(cuda, tmp_path):
    """The mesh's model axis as the JAX package's multichip dry run drives
    it: a (data 2, model 2) grid of four gloo ranks sharing the card, the
    wide convs sharded. One float32 step (TF32 off) against the
    one-process step on the whole batch (loss rel 1e-6, the unsharded
    gradient within 1e-2 of its norm, running statistics within 1e-4 of
    their largest, every weight within Adam's first-step bound); then bf16
    steps with dropout 0.1: finite losses, the model ranks of each data row
    bit for bit equal."""
    m = GRID_MODEL_PARALLEL
    init, batch = _group_inputs(WIDE, 6)
    want = _one_process_step(WIDE, init, batch, cuda)
    runs = [dict(dtype="float32", optimizer=dict(lr=LR), batches=[batch]),
            dict(dtype="bfloat16", optimizer=dict(lr=LR), model=dict(dropout=0.1),
                 batches=[batch] * 4, warm=2)]
    outs = _ranks(tmp_path, "steps", dict(model=WIDE, state_dict=init, device="cuda",
                                          backend="gloo", timeout=GROUP_TIMEOUT,
                                          model_parallel=m, runs=runs), 2 * m)
    assert [(o["data_rank"], o["model_rank"]) for o in outs] == [(r // m, r % m)
                                                                 for r in range(2 * m)]
    for out in outs:
        _step_against(out["runs"][0], want, loss_rtol=1e-6)
        _grid_weights_within_adams_bound(out["runs"][0], want)
        assert all(math.isfinite(x["loss"]) for x in out["runs"][1]["metrics"])
    for row in range(0, 2 * m, m):
        first = outs[row]["runs"][1]["state_dict"]
        for out in outs[row + 1:row + m]:
            for k, v in first.items():
                assert torch.equal(v, out["runs"][1]["state_dict"][k]), (out["rank"], k)


# --- sharded serves on one card -----------------------------------------------------------


def _map_errors(got, want):
    """Each map's largest |got - want| over max(1, max |want|)."""
    return [((g - w).abs().max() / max(1.0, w.abs().max().item())).item()
            for g, w in zip(got, want)]


def test_sharded_serves_on_one_card_match_the_single_serve(cuda, tmp_path):
    """make_sharded_inference_fn in one process: over every visible card
    (a replica each) in bf16, bit for bit make_inference_fn's, the bf16 stem
    kernel once a replica; over ["cuda:0"] * 4 at model_parallel 2 (2 data
    rows x 2 shards) in bf16, each map within 5e-2 x max(1, max |map|) of
    the single serve. An int8 artifact (scales calibrated in bf16 on 4
    unit-normal frames) served float32 by load_sharded_inference_fn over
    both grids: within 1e-3 of load_inference_fn's (the int8 serve on the
    card differs from call to call by ~1e-4), every conv's input quantized
    by the kernel."""
    from object_keypoints_tpu_torch.parallel import create_mesh
    from object_keypoints_tpu_torch.serving.calibration import calibration_batches
    from object_keypoints_tpu_torch.serving.export import (
        export_model,
        load_inference_fn,
        make_inference_fn,
    )
    from object_keypoints_tpu_torch.serving.quantize import calibrate_activation_scales
    from object_keypoints_tpu_torch.serving.sharded import (
        load_sharded_inference_fn,
        make_sharded_inference_fn,
    )
    from object_keypoints_tpu_torch.testing import randomize_batchnorm

    model = KeypointNet(**WIDE, generator=torch.Generator().manual_seed(0))
    randomize_batchnorm(model, torch.Generator().manual_seed(0))
    frames = torch.randn(8, 3, 64, 64, generator=torch.Generator().manual_seed(1)).to(cuda)
    grid = dict(devices=["cuda:0"] * 2 * GRID_MODEL_PARALLEL, model_parallel=GRID_MODEL_PARALLEL)

    devices = create_mesh()
    single = make_inference_fn(copy.deepcopy(model), dtype=torch.bfloat16, device=cuda)
    want = single(frames.bfloat16())
    got, counts, _ = traced(
        lambda: make_sharded_inference_fn(copy.deepcopy(model), dtype=torch.bfloat16)(
            frames.bfloat16()))
    assert counts.get("stem.kernel") == len(devices)
    for g, w in zip(got, want):
        assert g.device == devices[0] and g.dtype == torch.float32 and torch.isfinite(g).all()
        assert torch.equal(g, w)
    got = make_sharded_inference_fn(copy.deepcopy(model), dtype=torch.bfloat16, **grid)(
        frames.bfloat16())
    assert all(torch.isfinite(g).all() for g in got)
    assert max(_map_errors(got, want)) <= 5e-2, _map_errors(got, want)

    calib = list(numpy.random.default_rng(0).normal(size=(4, 64, 64, 3)).astype(numpy.float32))
    model.to(cuda, memory_format=torch.channels_last).eval()

    def apply(batch):
        model(torch.from_numpy(batch).to(cuda).permute(0, 3, 1, 2).bfloat16().contiguous())

    scales = calibrate_activation_scales(model, apply, calibration_batches(calib))
    artifact = str(tmp_path / "int8")
    export_model(artifact, {**{k: list(v) if isinstance(v, tuple) else v for k, v in WIDE.items()},
                            "keypoint_config": [1, 3]}, model, quant_scales=scales)
    want = load_inference_fn(artifact, device=cuda)(frames)
    for kw in ({}, grid):
        got, counts, spans = traced(lambda: load_sharded_inference_fn(artifact, **kw)(frames))
        assert spans["int8.mm"] >= counts.get("int8.quantize.kernel", 0) > 0
        assert all(torch.isfinite(g).all() for g in got)
        errors = [(g - w).abs().max().item() for g, w in zip(got, want)]
        assert max(errors) <= 1e-3, (kw, errors)


# --- the detector eval CLI in bf16 -------------------------------------------------------


def _cpu_rows_of_card_heads(snapshot, db, config):
    """results.json rows of the full-width CornerNet-Squeeze as the CPU
    computes them from the card's heads: the forward on the card in bf16,
    then the corner decode, rescale, soft-NMS and cap of
    ``cornernet_inference`` on the CPU."""
    import cv2

    from object_keypoints_tpu_torch.cli.detect import load_state_dict
    from object_keypoints_tpu_torch.inference.detector import Detector, cornernet_inference
    from object_keypoints_tpu_torch.models.cornernet import cornernet_squeeze
    from object_keypoints_tpu_torch.ops.detection_decode import decode_detections
    from object_keypoints_tpu_torch.precision import no_tf32
    from object_keypoints_tpu_torch.testing import coco_rows

    model = cornernet_squeeze(config["categories"])
    model.load_state_dict(load_state_dict(snapshot), strict=True)
    det = Detector(model, config, device="cuda", dtype=torch.bfloat16)

    def decode_fn(batch, **kw):
        with torch.inference_mode(), no_tf32():
            heads = model.heads(model.hg(det.frames(batch))[-1], model.stacks - 1)
        return decode_detections(*(h.cpu() for h in heads), **kw).numpy()

    results = {}
    for ind, image_id in enumerate(db.image_ids):
        image = cv2.imread(db.image_path(ind))[..., ::-1]
        results[image_id] = cornernet_inference(config, decode_fn, image, device="cpu")
    return coco_rows(db.convert_to_coco(results))


def test_full_width_eval_cli_in_bf16_on_card_matches_the_cpus_decode(cuda, tmp_path, capsys):
    """cli.evaluate_detector over 4 synthetic 192x256 COCO images with the
    full-width CornerNet-Squeeze in bf16 (heat heads planted), from a .pth
    snapshot, on the card and with --cpu. A bf16 forward on the card and on
    the CPU round partial sums differently and the top-K follows, so the
    card's results.json rows are held to the CPU's decode, soft-NMS and cap
    of the card's own heads (counts per image and class equal, boxes within
    1e-3 px, scores within 1e-5), and the --cpu run's 12 stats to the
    card's within 1e-3."""
    from object_keypoints_tpu_torch.cli import evaluate_detector
    from object_keypoints_tpu_torch.data.coco import CocoDetectionDataset
    from object_keypoints_tpu_torch.data.synthetic import make_synthetic_coco_dataset
    from object_keypoints_tpu_torch.models.cornernet import cornernet_squeeze
    from object_keypoints_tpu_torch.testing import coco_rows, compare_coco_rows, plant_detector_heads
    from object_keypoints_tpu_torch.utils.config import CONFIG_DIR, DetectionConfig, load_cfg

    ann, images = make_synthetic_coco_dataset(str(tmp_path / "data"), n_images=4,
                                              image_size=(192, 256), seed=0)
    model = cornernet_squeeze(generator=torch.Generator().manual_seed(0))
    plant_detector_heads(model, -30.0)
    snapshot = tmp_path / "CornerNet_Squeeze_1.pth"
    torch.save(model.state_dict(), snapshot)
    argv = ["CornerNet_Squeeze", "--annotations", ann, "--image-dir", images,
            "--snapshot-dir", str(tmp_path), "--testiter", "1"]
    card = evaluate_detector.main([*argv, "--result-dir", str(tmp_path / "card")])
    cpu = evaluate_detector.main([*argv, "--cpu", "--result-dir", str(tmp_path / "cpu")])
    capsys.readouterr()
    numpy.testing.assert_allclose(card["stats"], cpu["stats"], rtol=0, atol=1e-3)
    want = _cpu_rows_of_card_heads(str(snapshot), CocoDetectionDataset(ann, images),
                                   DetectionConfig(load_cfg(CONFIG_DIR / "CornerNet_Squeeze.json")[1]))
    assert len(want) > 0
    compare_coco_rows("CornerNet_Squeeze eval: card vs the CPU's decode of the card's heads",
                      coco_rows(tmp_path / "card" / "1" / "validation" / "results.json"), want)
