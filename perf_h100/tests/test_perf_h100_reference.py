"""The frozen plain references agree with the port at a tiny size on the CPU
(float32), from the same seeded weights and inputs."""

import numpy as np
import torch

from harness.camera import camera_tensors, serve_camera
from harness.weights import materialize, meta_model, seeded_state
from reference import decode as ref_decode


def test_keypoint_net_forward(tiny_cell):
    from object_keypoints_tpu_torch.serving.export import make_inference_fn, model_from_config

    cell = tiny_cell("valve-depth-b48")
    cfg = cell.config
    state = seeded_state(meta_model(cell.reference.reference_model, cfg), 123, "cpu")
    port = materialize(meta_model(model_from_config, cfg["model"]), state, "cpu")
    infer = make_inference_fn(port, dtype=torch.float32, device="cpu")
    ref = cell.reference.reference_model(cfg)
    ref.load_state_dict(state)
    x = torch.randn(2, 3, 63, 63, generator=torch.Generator().manual_seed(0))
    got = infer(x)
    with torch.no_grad():
        want = ref.eval()(x)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        # float32 in another order (the port folds the stem's BatchNorm), grown
        # by the seeded network's gain: far under bf16's 1e-2
        torch.testing.assert_close(g, w, atol=1e-3 * max(1.0, float(w.abs().max())), rtol=1e-3)


def test_cornernet_squeeze_loss_and_gradients(tiny_cell):
    from object_keypoints_tpu_torch.training import detection

    cell = tiny_cell("squeeze-train-b55")
    kind, cfg = cell.kind, cell.config
    ctx = type("Ctx", (), dict(config=cfg, traffic=cell.traffic, device="cpu",
                               reference=cell.reference))
    state = seeded_state(meta_model(cell.reference.reference_model, cfg), 7, "cpu",
                         cfg.get("weight_overrides"))
    batch = kind.make_pool(ctx, 11)[0]
    program = kind.Program(ctx, state)
    loss, grads = detection.loss_and_grads(program.state, batch)
    ref = kind.Reference(ctx, state)
    with torch.enable_grad():
        want = cell.reference.loss(ref.model(batch["images"].permute(0, 3, 1, 2).contiguous()),
                                   batch)
        want_grads = torch.autograd.grad(want, ref.params())
    torch.testing.assert_close(loss, want.detach(), atol=1e-5, rtol=1e-5)
    assert program.names == ref.names
    for g, w in zip(grads, want_grads):
        torch.testing.assert_close(g, w, atol=1e-5 * float(w.abs().max()) + 1e-7, rtol=1e-4)


def test_decode(tiny_cell):
    from object_keypoints_tpu_torch.pipeline.decode import CameraArrays, decode_objects_batch

    cell = tiny_cell("valve-depth-b48")
    d = cell.traffic["decode"]
    cam = serve_camera(cell.config["camera"], 511, 64)
    gen = torch.Generator().manual_seed(3)
    probs = torch.rand(6, 3, 64, 64, generator=gen) ** 4
    depth = torch.rand(6, 3, 64, 64, generator=gen) * 2.0
    offsets = torch.randn(6, 2, 2, 64, 64, generator=gen) * 5.0
    got = decode_objects_batch(probs, depth, offsets, CameraArrays.from_camera(cam), (1, 3), **d)
    want = ref_decode.decode_objects(probs, depth, offsets, camera_tensors(cam, "cpu"), (1, 3),
                                     d["max_peaks"], d["reject_distance"], d["peak_threshold"])
    assert int(cell.kind.frames_differ(list(got), list(want)).sum()) == 0
    assert bool(got.center_valid.any()) and bool(got.keypoints_valid.any())


def test_camera_is_the_ports_bench_chain():
    from object_keypoints_tpu_torch.geometry import cameras
    from object_keypoints_tpu_torch.testing import bench_camera
    from conftest import ROOT

    params = cameras.load_calibration_params(ROOT + "/config/calibration.yaml")
    port = bench_camera(cameras.FisheyeCamera(params["K"], params["D"], params["image_size"]))
    import json
    cfg = json.load(open(ROOT + "/perf_h100/configs/valve_keypointnet.json"))
    mine = serve_camera(cfg["camera"], 511, 64)
    for a in ("K", "D", "Kinv", "image_size"):
        np.testing.assert_allclose(getattr(mine, a), getattr(port, a), rtol=1e-12, atol=1e-12)
