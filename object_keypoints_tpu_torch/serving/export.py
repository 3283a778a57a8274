"""Serving artifacts and the inference contract.

Counterpart of ``object_keypoints_tpu/serving/export.py``. An artifact is the
directory the JAX package's ``export_model`` writes:

    config.json    — model hyperparameters + keypoint config
    params.msgpack — flax params + batch_stats (float32), flax msgpack format
    quant.json     — int8 activation scales (optional)

``load_model`` reads it with ``msgpack`` alone (no flax) and loads the
weights through ``serving.weights``; ``export_model`` writes one from a port
model, in the same format, for either package to read, quant.json included.
``make_inference_fn`` keeps the reference contract: frames (N, 3, H, W) in;
sigmoid heatmaps (N, K, h, w), depth (N, K, h, w) and center offsets (N, T,
2, h, w) out, all float32. With activation scales it serves int8
(``serving.quantize``): ``load_inference_fn`` does so for an artifact that
holds quant.json, as the JAX package does.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from object_keypoints_tpu_torch.models.keypoint_net import KeypointNet, outputs_to_reference
from object_keypoints_tpu_torch.precision import no_tf32
from object_keypoints_tpu_torch.serving.quantize import quantize_model
from object_keypoints_tpu_torch.serving.weights import (
    keypoint_net_state_dict,
    keypoint_net_variables,
)
from object_keypoints_tpu_torch.utils import timer

CONFIG_NAME = "config.json"
PARAMS_NAME = "params.msgpack"
QUANT_NAME = "quant.json"
_MSGPACK_NDARRAY = 1  # flax.serialization._MsgpackExtType.ndarray


def model_from_config(config: dict, generator: Optional[torch.Generator] = None) -> KeypointNet:
    return KeypointNet(
        heatmaps_out=config["heatmaps_out"],
        features=config.get("features", 128),
        dropout=config.get("dropout", 0.1),
        stacks=config.get("stacks", 2),
        levels=config.get("levels", 4),
        dims=tuple(config.get("dims", (256, 256, 384, 384, 512))),
        mods=tuple(config.get("mods", (2, 2, 2, 2, 4))),
        stem_features=tuple(config.get("stem_features", (128, 256))),
        cnv_dim=config.get("cnv_dim", 256),
        generator=generator,
    )


def read_flax_msgpack(data: bytes) -> dict:
    """Decode flax's msgpack state: nested maps whose array leaves are ext
    type 1 holding ``msgpack((shape, dtype_name, C-order bytes))``."""
    import msgpack

    def ext_hook(code, payload):
        if code != _MSGPACK_NDARRAY:
            raise ValueError(f"unsupported flax msgpack ext type {code}")
        shape, dtype_name, buffer = msgpack.unpackb(payload, raw=True)
        return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape)

    return msgpack.unpackb(data, ext_hook=ext_hook, raw=False)


def write_flax_msgpack(tree: dict) -> bytes:
    """Encode nested dicts of numpy arrays as flax's msgpack state (the
    inverse of ``read_flax_msgpack``)."""
    import msgpack

    def ext(x):
        if isinstance(x, np.ndarray):
            payload = msgpack.packb((x.shape, x.dtype.name, x.tobytes("C")), use_bin_type=True)
            return msgpack.ExtType(_MSGPACK_NDARRAY, payload)
        raise TypeError(f"cannot encode {type(x).__name__} as a flax msgpack leaf")

    return msgpack.packb(tree, default=ext, strict_types=True)


def architecture(config: dict) -> dict:
    """The layout arguments of ``serving.weights``'s name walk in ``config``."""
    return dict(stacks=config.get("stacks", 2), levels=config.get("levels", 4),
                mods=tuple(config.get("mods", (2, 2, 2, 2, 4))))


def export_model(path: str, config: dict, model, quant_scales: Optional[dict] = None) -> None:
    """Write the serving artifact of ``model`` (a port KeypointNet, its
    state_dict, or JAX-layout ``{"params", "batch_stats"}`` variables, written
    as they are) with ``config``: config.json and params.msgpack as the JAX
    package's ``export_model`` writes them, float32, and with
    ``quant_scales`` (``serving.quantize.calibrate_activation_scales``)
    quant.json. The weights go through a temporary file and ``os.replace``,
    so a killed process leaves no truncated artifact."""
    if isinstance(model, dict) and "params" in model:
        variables = model
    else:
        state = model.state_dict() if isinstance(model, torch.nn.Module) else model
        variables = keypoint_net_variables(state, **architecture(config))
    os.makedirs(path, exist_ok=True)
    if quant_scales:
        with open(os.path.join(path, QUANT_NAME), "wt") as f:
            json.dump(quant_scales, f, indent=2, sort_keys=True)
    with open(os.path.join(path, CONFIG_NAME), "wt") as f:
        json.dump(config, f, indent=2)
    tmp = os.path.join(path, PARAMS_NAME + ".tmp")
    with open(tmp, "wb") as f:
        f.write(write_flax_msgpack(variables))
    os.replace(tmp, os.path.join(path, PARAMS_NAME))


def load_model(path: str):
    """Load (model, config) from an exported artifact; the model is on the
    CPU in float32."""
    with open(os.path.join(path, CONFIG_NAME), "rt") as f:
        config = json.load(f)
    with open(os.path.join(path, PARAMS_NAME), "rb") as f:
        variables = read_flax_msgpack(f.read())
    model = model_from_config(config)
    state = keypoint_net_state_dict(variables, **architecture(config))
    model.load_state_dict(state, strict=True)
    return model, config


def load_quant_scales(path: str) -> Optional[dict]:
    """The activation scales saved with the artifact (quant.json), or None."""
    qpath = os.path.join(path, QUANT_NAME)
    if not os.path.exists(qpath):
        return None
    with open(qpath, "rt") as f:
        return json.load(f)


def make_inference_fn(model: KeypointNet, dtype=torch.float32, device="cuda",
                      quant_scales: Optional[dict] = None):
    """Eval-mode reference-contract inference: NCHW frames in, (sigmoid
    heatmaps, depth, centers) of the last stack out, float32 and contiguous;
    a call is the span ``serve`` (``utils.timer``). With ``quant_scales`` the eligible convs run int8
    (``serving.quantize.quantize_model``, its default placement), the rest
    in ``dtype``.

    Moves ``model`` (in place) to ``device``, channels_last, eval mode; its
    parameters and BatchNorm statistics stay float32. ``dtype`` is the
    compute dtype, the JAX package's rule (``precision``): bfloat16 frames
    through bf16 convolutions and float32 BatchNorm. A float32 forward runs
    with TF32 off whatever the process's flags say. The stem runs the CUDA
    stem kernel on a CUDA device. It serves on the card unless
    ``device="cpu"`` is asked for, and raises where a CUDA device is asked
    for and there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"make_inference_fn: device {str(device)!r} asked for, but CUDA "
                           "is not available; pass device='cpu' to serve on the CPU")
    model.to(device=device, memory_format=torch.channels_last).eval()
    if quant_scales:
        quantize_model(model, quant_scales)

    @torch.inference_mode()
    def infer(frames):
        with timer.span("serve"):
            x = torch.as_tensor(frames).to(device=device, dtype=dtype).contiguous()
            with no_tf32():
                outs = outputs_to_reference(model(x), stack=-1)
            return tuple(t.float().contiguous() for t in outs)

    return infer


def load_served_model(path: str, quantize: str = "auto"):
    """(model, activation scales or None) of an artifact as it is served.
    ``quantize`` as in the JAX package: "auto" serves int8 if and only if
    the artifact holds quant.json, "require" int8 (raising
    ``FileNotFoundError`` where there is no quant.json), "never" float."""
    if quantize not in ("auto", "never", "require"):
        raise ValueError(f"quantize={quantize!r}: expected 'auto', 'never' or 'require'")
    scales = None if quantize == "never" else load_quant_scales(path)
    if quantize == "require" and not scales:
        raise FileNotFoundError(f"no {QUANT_NAME} in artifact {path}")
    return load_model(path)[0], scales


def load_inference_fn(path: str, dtype=torch.float32, quantize: str = "auto", device="cuda"):
    """``make_inference_fn`` over an artifact (``load_served_model``'s
    ``quantize`` modes), on the card unless ``device="cpu"``."""
    model, scales = load_served_model(path, quantize)
    return make_inference_fn(model, dtype=dtype, device=device, quant_scales=scales)
