"""Scenes, rigs, comparisons and rank launchers shared by the port's tests.

- ``bench_camera`` / ``serve_rig``: bench.py's camera chain (511 tall,
  centre cut, into size x size prediction space), for one camera of either
  package or for the stereo rig of config/calibration.yaml.
- ``stereo_scene``: numpy Gaussian heatmaps of known 3D keypoints at their
  fisheye projections in both views of the 180x320 rig.
- ``compare_stereo``: one stereo decode held to another (masks equal, 2D
  within a pixel tolerance, 3D within ``stereo_3d_tolerance``).
- ``synthetic_sequence_in_memory``: a synthetic sequence whose poses and
  frames stay in memory, for machines without h5py.
- ``synthetic_datasets``: ``SceneDataset``s over such sequences, what
  ``training.device_data.build_device_store`` takes.
- ``synthetic_batch``: a seeded train batch of Gaussian-blob targets, the
  batch of tests/test_training.py made with numpy, for both packages.
- ``randomize_batchnorm`` / ``plant_detector_heads``: seeded CornerNet
  weights that give the decode, the NMS and the saccade's later stages
  work (random heads pair no corners and attend nowhere).
- ``coco_rows`` / ``compare_coco_rows``: COCO results (results.json) as
  rows, and two of them compared as sets of boxes.
- ``traced``: a call with ``utils.timer``'s spans and counters on, and what
  it counted: how the tests count kernel launches.
- ``launch_ranks``: one process a rank under the launch contract
  (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``), each with a
  deadline, all killed when one fails; ``rank_steps`` and ``rank_fit``, what
  the ranks run (``python -m object_keypoints_tpu_torch.testing steps|fit
  <spec> <out>``): train steps on each rank's slice of global batches, and
  ``training.loop`` over the group.
"""

from __future__ import annotations

import collections
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from object_keypoints_tpu_torch.data.encode import SequenceWriter
from object_keypoints_tpu_torch.data.scene import SceneDataset
from object_keypoints_tpu_torch.data.synthetic import synthetic_recording
from object_keypoints_tpu_torch.geometry import cameras, stereo
from object_keypoints_tpu_torch.utils import timer

BENCH_OFFSET = np.array([(511.0 / 720.0 * 1280.0 - 511.0) / 2.0, 0.0])  # bench.py:194
# the valve keypoints of tests/test_stereo_pipeline.py, in the left camera frame (m)
SCENE_KEYPOINTS = np.array([[0.0, 0.0, 1.0], [0.25, 0.15, 1.0], [-0.25, -0.25, 1.0],
                            [0.25, -0.25, 1.0]])
SCENE_CHANNELS = ([0], [1], [2, 3, 4])  # centroid; first keypoint; the other three
SCENE_SIZE = (180, 320)


def bench_camera(camera, size: int = 64):
    """A 1280x720 camera of either package through bench.py's chain."""
    return camera.scale(511.0 / 720.0).cut(BENCH_OFFSET).scale(size / 511.0)


def serve_rig(params, size: int = 64) -> cameras.StereoCamera:
    """The stereo rig of calibration ``params`` through bench.py's chain."""
    return cameras.StereoCamera(*(bench_camera(cameras.FisheyeCamera(K, D, params["image_size"]), size)
                                  for K, D in ((params["K"], params["D"]),
                                               (params["Kp"], params["Dp"]))),
                                params["T_RL"])


def gaussian_maps(points, size, sigma: float = 2.0) -> np.ndarray:
    """(K, H, W) float32 maps: channel c holds unit Gaussians at points[c]."""
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    maps = np.zeros((len(points), h, w), np.float32)
    for c, pts in enumerate(points):
        for x, y in pts:
            maps[c] = np.maximum(maps[c], np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / sigma**2))
    return maps


def stereo_scene(calibration_file: str):
    """The calibration's rig at 180x320 and the Gaussian maps of
    SCENE_KEYPOINTS and their centroid in both views. Returns (rig, left
    maps, right maps, the 5 points, SCENE_CHANNELS)."""
    p = cameras.load_calibration_params(calibration_file)
    scale = SCENE_SIZE[0] / 720.0
    rig = cameras.StereoCamera(cameras.FisheyeCamera(p["K"], p["D"], p["image_size"]).scale(scale),
                               cameras.FisheyeCamera(p["Kp"], p["Dp"], p["image_size"]).scale(scale),
                               p["T_RL"])
    points = np.concatenate([SCENE_KEYPOINTS.mean(0, keepdims=True), SCENE_KEYPOINTS])
    p_l = rig.left_camera.project(points)
    p_r = rig.right_camera.project(points @ rig.T_RL[:3, :3].T + rig.T_RL[:3, 3])
    return (rig, gaussian_maps([p_l[c] for c in SCENE_CHANNELS], SCENE_SIZE),
            gaussian_maps([p_r[c] for c in SCENE_CHANNELS], SCENE_SIZE), points, SCENE_CHANNELS)


def stereo_3d_tolerance(points, flat_to: float = 1.0) -> np.ndarray:
    """Per-point 3D tolerance in m: 1e-4 m within ``flat_to`` (>= 1) m of
    the camera, 1e-4 m x (|p| / 1 m)^3 from there on.

    Why the cube: the DLT solves the 3x3 normal equations of two rays
    ``B`` apart, whose condition number grows as (z / B)^2; float32
    rounding (eps ~6e-8) then moves a point at distance z by about
    eps z^3 / B^2, ~1.5e-5 m x (z / 1 m)^3 on a 6.24 cm baseline."""
    dist = np.linalg.norm(np.asarray(points, np.float64), axis=-1)
    return np.where(dist < flat_to, 1e-4, 1e-4 * np.maximum(1.0, dist**3))


def _numpy(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.numpy() if x.dtype == torch.bool else x.double().numpy()
    return np.asarray(x)


def lift_exact(decoded, rig):
    """``decoded`` with its 3D points lifted anew, in float64 on the CPU,
    from its own matched pixels: the same port code (undistort,
    Hartley-Sturm, DLT) that the decode ran, with ``rig``'s arrays as
    float64. The witness for ``stereo_3d_tolerance``."""
    r = [torch.as_tensor(a).detach().cpu().double() for a in rig]
    p3 = stereo.triangulate_pixels(decoded.points_left.detach().cpu().double(),
                                   decoded.points_right.detach().cpu().double(), *r)
    valid = decoded.match_valid.detach().cpu()
    return decoded._replace(points_3d=torch.where(valid[..., None], p3, torch.zeros_like(p3)))


def compare_stereo(got, want, what: str, atol_2d: float = 1e-4, flat_to: float = 1.0,
                   exact=None):
    """Hold a ``StereoDecoded`` (torch, any device) to another (torch, or the
    JAX package's): shapes equal, masks equal, points and confidences
    within ``atol_2d``, unmatched 3D slots 0 in both, and each matched 3D
    point within ``stereo_3d_tolerance(exact, flat_to)``, where
    ``exact`` is a float64 lift of the same pixels (``lift_exact``) and
    defaults to ``want``.

    A matched point whose tolerance is at least its own exact distance (or
    that is non-finite in ``exact``) carries no depth at this precision: its
    rays are all but parallel. It is counted and not compared, and may be
    non-finite in either. Returns (worst 3D error as a fraction of its
    tolerance, points compared, points that carry no depth)."""
    fields = ("points_left", "points_right", "match_valid", "points_3d", "left_valid",
              "confidence")
    g = {name: _numpy(getattr(got, name)) for name in fields}
    w = {name: _numpy(getattr(want, name)) for name in fields}
    for name in fields:
        assert g[name].shape == w[name].shape, (what, name, g[name].shape, w[name].shape)
    for name in ("match_valid", "left_valid"):
        np.testing.assert_array_equal(g[name], w[name], err_msg=f"{what}: {name}")
    for name in ("points_left", "points_right", "confidence"):
        np.testing.assert_allclose(g[name], w[name], atol=atol_2d, rtol=0, err_msg=f"{what}: {name}")
    matched = w["match_valid"]
    np.testing.assert_array_equal(g["points_3d"][~matched], 0.0, err_msg=f"{what}: unmatched 3D")
    np.testing.assert_array_equal(w["points_3d"][~matched], 0.0, err_msg=f"{what}: unmatched 3D")
    g3, w3 = g["points_3d"][matched], w["points_3d"][matched]
    e3 = w3 if exact is None else _numpy(exact.points_3d)[matched]
    with np.errstate(invalid="ignore"):
        tol = stereo_3d_tolerance(e3, flat_to)
        held = np.isfinite(e3).all(-1) & (tol < np.linalg.norm(e3, axis=-1))
    ratio = np.abs(g3[held] - w3[held]).max(-1, initial=0.0) / tol[held]
    ratio = np.where(np.isfinite(ratio), ratio, np.inf)
    worst = float(ratio.max(initial=0.0))
    assert worst <= 1.0, f"{what}: 3D error {worst:.3g} x its tolerance"
    return worst, int(held.sum()), int((~held).sum())


def synthetic_sequence_in_memory(out_dir: str, calibration_file: str, keypoint_config,
                                 n_frames: int, seed: int = 0, n_objects: int = 1):
    """A synthetic sequence (``data.synthetic.synthetic_recording``) with
    only its labels on disk: writes calibration.yaml and keypoints.json into
    ``out_dir`` (neither needs cv2 or h5py) and returns the ``recording``
    (poses, RGB uint8 frames) that ``evaluation.Sequence`` and
    ``SceneDataset`` take in place of data.hdf5 and frames.mp4."""
    world_points, poses, frames = synthetic_recording(calibration_file, keypoint_config,
                                                      n_objects, n_frames=n_frames, seed=seed)
    labels = SequenceWriter(out_dir, preview=False)  # no frames: nothing to close
    labels.write_calibration(calibration_file)
    labels.write_keypoints(world_points)
    return poses, list(frames)


def synthetic_datasets(root: str, calibration_file: str, keypoint_config, n_sequences: int,
                       n_frames: int, n_objects: int = 1, seed: int = 0) -> list:
    """``n_sequences`` synthetic sequences held in memory under ``root``
    (seeds ``seed``, ``seed`` + 1, ...), each as a ``SceneDataset`` with
    augmentation and normalization off: raw uint8 frames, the device
    store's input."""
    datasets = []
    for i in range(n_sequences):
        seq_dir = os.path.join(root, f"seq_{i:02d}")
        recording = synthetic_sequence_in_memory(seq_dir, calibration_file, keypoint_config,
                                                 n_frames, seed + i, n_objects)
        datasets.append(SceneDataset(seq_dir, {"keypoint_config": list(keypoint_config)},
                                     normalize=False, recording=recording))
    return datasets


def synthetic_batch(seed: int = 0, n: int = 2, size: int = 32, k: int = 3) -> dict:
    """A consistent (frame, targets) train batch in the data layer's layout
    (numpy, NHWC): noise frames (n, size, size, 3) with a std of 0.1,
    Gaussian blobs on (size / 8)^2 heatmaps at fixed places, depth 1.5 x the
    heatmaps, centers (.., k - 1, 2) holding 0.5 in x."""
    h = w = size // 8
    frame = (np.random.default_rng(seed).normal(size=(n, size, size, 3)) * 0.1).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    heat = np.zeros((n, h, w, k), np.float32)
    for i in range(k):
        cy, cx = (i + 1) % h, (2 * i + 1) % w
        heat[..., i] = np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / 2.0)[None]
    centers = np.zeros((n, h, w, k - 1, 2), np.float32)
    centers[..., 0] = 0.5
    return {"frame": frame, "heatmaps": heat, "depth": np.clip(heat * 1.5, 0, None),
            "centers": centers}


@torch.no_grad()
def randomize_batchnorm(model, generator: torch.Generator):
    """Every BatchNorm's scale, shift and running statistics drawn at
    random (init leaves them at identity, which hides layout errors)."""
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.weight.uniform_(0.5, 1.5, generator=generator)
            m.bias.normal_(0, 0.1, generator=generator)
            m.running_mean.normal_(0, 0.1, generator=generator)
            m.running_var.uniform_(0.5, 1.5, generator=generator)


@torch.no_grad()
def plant_detector_heads(model, heat_gain: float, att_gain: float | None = None,
                         att_bias: float = 0.0):
    """Seeded CornerNet heads that pair corners: each heat head's output
    kernel becomes its class 0 kernel, shared by every class and scaled by
    ``heat_gain``, with biases -2.19 + 0.01 c (tests/test_torch_port_detector.py's
    recipe). With ``att_gain``, each attention head's output kernel is
    scaled by it and its bias set to ``att_bias``, so that the saccade's
    attention passes its thresholds and later stages get crops."""
    for heads in (model.tl_heats, model.br_heats):
        for head in heads:
            conv = head[1]
            conv.weight.copy_(conv.weight[:1].expand_as(conv.weight) * heat_gain)
            conv.bias.copy_(-2.19 + 0.01 * torch.arange(conv.bias.numel(), dtype=torch.float32))
    if att_gain is not None:
        for stack in model.att_modules:
            for head in stack:
                head[1].weight.mul_(att_gain)
                head[1].bias.fill_(att_bias)


def coco_rows(results) -> np.ndarray:
    """COCO results (a results.json path or its list of dicts) -> float64
    rows (image_id, category_id, x, y, w, h, score), ordered by image,
    class and box."""
    if isinstance(results, (str, os.PathLike)):
        with open(results) as f:
            results = json.load(f)
    table = np.array([[r["image_id"], r["category_id"], *r["bbox"], r["score"]]
                      for r in results], np.float64).reshape(-1, 7)
    return table[np.lexsort(table[:, 5::-1].T)]


def compare_coco_rows(what: str, got: np.ndarray, want: np.ndarray, atol_box: float = 1e-3,
                      atol_score: float = 1e-5) -> dict:
    """Two ``coco_rows`` tables as sets: equal counts of rows per (image,
    class), each row of got paired with the nearest unpaired row of want in
    its group (greedy on max |box| + |score|: a sorted order pairs the
    wrong rows where boxes clipped to the border tie), boxes within
    atol_box px and scores within atol_score. Raises AssertionError with the
    worst pair; returns the rows' count and the worst differences."""
    if got.shape != want.shape or not np.array_equal(got[:, :2], want[:, :2]):
        raise AssertionError(f"{what}: rows differ: {got.shape} against {want.shape}")
    box = score = 0.0
    worst = None
    for key in np.unique(want[:, :2], axis=0):
        a = got[(got[:, :2] == key).all(1)]
        b = want[(want[:, :2] == key).all(1)]
        dist = (np.abs(a[:, None, 2:6] - b[None, :, 2:6]).max(-1)
                + np.abs(a[:, None, 6] - b[None, :, 6]))
        for _ in range(len(a)):
            i, j = np.unravel_index(np.argmin(dist), dist.shape)
            if dist[i, j] > box + score:
                worst = (a[i].tolist(), b[j].tolist())
            box = max(box, float(np.abs(a[i, 2:6] - b[j, 2:6]).max()))
            score = max(score, float(abs(a[i, 6] - b[j, 6])))
            dist[i, :], dist[:, j] = np.inf, np.inf
    if box > atol_box or score > atol_score:
        raise AssertionError(f"{what}: boxes {box} px, scores {score}; worst pair {worst}")
    return {"rows": len(want), "box_px": box, "score": score}


def traced(fn):
    """fn()'s result, the counts ``utils.timer`` took during it and the
    number of spans of each name it opened (the card, where there is one,
    synchronised before the store is read)."""
    was = timer.enable(True)
    try:
        timer.snapshot()
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        taken = timer.snapshot()
    finally:
        timer.enable(was)
    return out, taken["counts"], collections.Counter(s["name"] for s in taken["spans"])


# ---------------------------------------------------------------- several ranks


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def launch_ranks(args, world: int, timeout: float, env=None, cwd=None) -> list:
    """Run ``python <args>`` once per rank with ``COORDINATOR_ADDRESS`` (a
    free port on 127.0.0.1), ``NUM_PROCESSES`` and ``PROCESS_ID`` set; wait
    for them all, at most ``timeout`` seconds in all. When one exits with
    an error the others are killed; past the deadline all are, and
    ``TimeoutError`` is raised. Returns each rank's (returncode, stdout,
    stderr)."""
    base = {**os.environ, **(env or {}), "COORDINATOR_ADDRESS": f"127.0.0.1:{free_port()}",
            "NUM_PROCESSES": str(world)}
    with tempfile.TemporaryDirectory() as tmp:
        logs = [(open(f"{tmp}/{r}.out", "w+"), open(f"{tmp}/{r}.err", "w+")) for r in range(world)]
        procs = [subprocess.Popen([sys.executable, *args], env={**base, "PROCESS_ID": str(r)},
                                  cwd=cwd, stdout=out, stderr=err)
                 for r, (out, err) in enumerate(logs)]
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if any(p.returncode for p in procs) or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        timed_out = time.monotonic() > deadline
        results = []
        for p, (out, err) in zip(procs, logs):
            out.seek(0)
            err.seek(0)
            results.append((p.returncode, out.read(), err.read()))
            out.close()
            err.close()
    if timed_out:
        raise TimeoutError(f"ranks did not finish in {timeout} s: "
                           + " | ".join(e[-2000:] for _, _, e in results))
    return results


def _rank_device(spec: dict):
    from object_keypoints_tpu_torch import parallel

    if spec["device"] == "cpu":
        torch.set_num_threads(spec.get("threads", 1))
    return parallel.initialize_distributed(spec.get("backend"), spec["device"], spec["timeout"])


def _steps(spec: dict, run: dict, device, mesh) -> dict:
    """One run of ``rank_steps``: a fresh train state from the spec's
    weights (sharded over ``mesh``'s model axis), then a step on this rank's
    data row's slice of each of ``run["batches"]``."""
    from object_keypoints_tpu_torch import parallel
    from object_keypoints_tpu_torch.models.keypoint_net import KeypointNet
    from object_keypoints_tpu_torch.training import trainer

    dtype = getattr(torch, run.get("dtype", "float32"))
    model = KeypointNet(**{**spec["model"], **run.get("model", {})})
    model.load_state_dict(spec["state_dict"])
    if dtype == torch.float64:
        model.double()
    parallel.shard_params(model, mesh)
    state = trainer.create_train_state(model, trainer.make_optimizer(**run["optimizer"]), dtype,
                                       device)
    # the ranks of a data row draw the same dropout mask: their activations are one replica's
    generator = torch.Generator(device=device).manual_seed(
        run.get("seed", 0) + 1009 * parallel.data_rank())
    out = {"metrics": [], "lr_scale": []}
    warm = run.get("warm", len(run["batches"]))
    for i, batch in enumerate(run["batches"]):
        if i == warm:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            calls = collections.Counter(parallel.COLLECTIVES)
        loss, metrics, grads = trainer.loss_and_grads(state, parallel.batch_sharding(batch),
                                                      generator)
        if i == 0:
            out["grads"] = [g.cpu() for g in parallel.unshard_like_parameters(model, grads)]
        trainer.apply_gradients(state, grads, loss)
        if i == 0 and run.get("moments"):
            out["mu"] = [m.cpu() for m in parallel.unshard_like_parameters(model,
                                                                           state.opt_state.mu)]
        if i < warm:
            out["metrics"].append({k: v.item() for k, v in metrics.items()})
            out["lr_scale"].append(state.lr_scale.item())
    if warm < len(run["batches"]):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timed = len(run["batches"]) - warm
        out["step_ms"] = 1e3 * (time.perf_counter() - t0) / timed
        out["collectives_per_step"] = {k: (v - calls[k]) / timed
                                       for k, v in parallel.COLLECTIVES.items()}
    eval_metrics = trainer.eval_step(state, parallel.batch_sharding(run["batches"][0]))
    out["eval"] = {k: v.item() for k, v in eval_metrics.items()}
    out["state_dict"] = {k: v.detach().cpu() for k, v in parallel.unshard(model).items()}
    return out


def rank_steps(spec_path: str, out_path: str) -> None:
    """A rank's part of train steps over a process group: ``spec`` (a
    ``torch.save``d dict) holds the KeypointNet's arguments (``model``), its
    weights (``state_dict``), the ``device``, ``backend`` and ``timeout``,
    optionally ``model_parallel`` (the (data, model) grid's model axis, 1 by
    default), and ``runs``, each with its ``optimizer`` arguments, ``dtype``,
    global ``batches`` (numpy dicts; a rank steps on its data row's slice)
    and optionally ``model`` (arguments over the spec's), ``moments`` (record
    Adam's first moment after the first step) and ``warm``: the steps after
    the first ``warm`` are timed, with their collectives a step
    (``parallel.COLLECTIVES``), not recorded. Writes ``out_path.<rank>``: per
    run the metrics and ``lr_scale`` after each step, the first step's
    gradients, ``eval_step``'s metrics on the rank's slice of the first batch
    after the steps, the final weights and buffers, the sharded ones gathered
    whole (``parallel.unshard``)."""
    from object_keypoints_tpu_torch import parallel

    spec = torch.load(spec_path, weights_only=False)
    device = _rank_device(spec)
    try:
        devices = [device] * parallel.world_size() if device.type == "cpu" else None
        mesh = parallel.create_mesh(devices, spec.get("model_parallel", 1))
        runs = [_steps(spec, run, device, mesh) for run in spec["runs"]]
        torch.save({"rank": parallel.rank(), "world": parallel.world_size(),
                    "data_rank": parallel.data_rank(), "model_rank": parallel.model_rank(),
                    "runs": runs}, f"{out_path}.{parallel.rank()}")
    finally:
        parallel.destroy_distributed()


def rank_fit(spec_path: str, out_path: str) -> None:
    """A rank's part of ``training.loop`` over a process group: ``spec``
    holds the ``TrainConfig`` fields (``config``), the ``device``,
    ``backend`` and ``timeout``, and either sequence directories in the
    config (``loop.train``) or ``synthetic``, the arguments of
    ``cli.flagship.synthetic_split`` for in-memory train and val splits that
    each rank makes under its own root (``loop.fit``). First checks that
    ``device_data=True`` raises. Writes ``out_path.<rank>``: the loop's
    result and that error's message."""
    import dataclasses

    from object_keypoints_tpu_torch import parallel
    from object_keypoints_tpu_torch.training import loop

    spec = torch.load(spec_path, weights_only=False)
    device = _rank_device(spec)
    try:
        config = loop.TrainConfig(**spec["config"])
        synthetic = spec.get("synthetic")
        if synthetic is None:
            splits = [(loop._sequence_dirs(d), None, train)
                      for d, train in ((config.train, True), (config.val, False))]
        else:
            from object_keypoints_tpu_torch.cli.flagship import synthetic_split

            root = f"{synthetic['root']}/rank{parallel.rank()}"
            splits = []
            for split, n, train in (("train", synthetic["n_train"], True), ("val", 1, False)):
                built = synthetic_split(root, split, n, config.keypoint_config,
                                        synthetic["n_frames"], n_objects=synthetic["n_objects"])
                splits.append(([d for d, _ in built], [r for _, r in built], train))

        def datasets():  # fresh augment streams for each fit
            return [loop.sequences(dirs, config, train, recordings)
                    for dirs, recordings, train in splits]

        try:
            loop.fit(dataclasses.replace(config, device_data=True), *datasets(), device=device)
            error = None
        except ValueError as e:
            error = str(e)
        result = loop.fit(config, *datasets(), device=device)
        torch.save({"rank": parallel.rank(), "result": result, "device_data_error": error},
                   f"{out_path}.{parallel.rank()}")
    finally:
        parallel.destroy_distributed()


if __name__ == "__main__":
    {"steps": rank_steps, "fit": rank_fit}[sys.argv[1]](*sys.argv[2:])
