"""The port's CornerNet (the residual Hourglass-104 with 3x3 heads) against
the benchmark's plain float32 reference (``perf_h100/configs/cornernet.py``,
loaded by path), at a tiny size on the CPU: ``perf_h100/tests/tiny/cornernet.json``,
two stacks of a two-level residual hourglass, 3 categories, 64x64 in and
16x16 out, train mode, seeded weights, two images with corner targets.

Compared: the twelve head maps of a train-mode forward, the CornerNet loss,
and every parameter's gradient. Tolerances, each with its reason:

- heads: within 1e-4 of max(1, the map's largest |value|) (read 3.0e-5):
  float32 in another order (the port's blocks against ``torch.nn``'s, the
  corner pools' scan against ``torch.cummax``) grown through both stacks;
  bf16 rounds each value by up to 4e-3;
- loss: rel 1e-5, float32 (the focal, pull, push and offset sums over
  twelve maps in another order);
- gradients: within 1e-4 of each tensor's largest |value| plus rel 1e-3
  (read 1% of that): the float32 backward through the same layers, where
  ties in the pools' running maxima split the gradient in the port and go
  to one index in ``torch.cummax`` (only where ReLU has zeroed it already).

The reference with its convolutions' operands and outputs rounded to bf16
breaks all three (heads by 2.7e3 times their tolerance), so the comparison
tells float32 from bf16.
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from object_keypoints_tpu_torch.models.cornernet import CornerNetModel  # noqa: E402
from object_keypoints_tpu_torch.training import detection  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERF = os.path.join(ROOT, "perf_h100")
HEAD_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL, GRAD_RTOL = 1e-4, 1e-3


@pytest.fixture(scope="module")
def plain():
    """The reference module, its tiny configuration, and the harness's
    seeded weights and corner targets (all plain torch and numpy)."""
    if PERF not in sys.path:
        sys.path.insert(0, PERF)
    from harness.core import load_module
    from harness.weights import meta_model, seeded_state
    from reference.corner_targets import corner_targets

    ref = load_module(os.path.join(PERF, "configs", "cornernet.py"), "perf_config_cornernet")
    with open(os.path.join(PERF, "configs", "cornernet.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(PERF, "tests", "tiny", "cornernet.json")) as f:
        tiny = json.load(f)
    for key, value in tiny.items():
        if isinstance(value, dict) and isinstance(cfg.get(key), dict):
            cfg[key].update(value)
        else:
            cfg[key] = value
    state = seeded_state(meta_model(ref.reference_model, cfg), 5, "cpu",
                         cfg["weight_overrides"])
    db = cfg["db"]
    boxes = [np.array([[4.0, 6.0, 30.0, 40.0, 1.0], [20.0, 10.0, 50.0, 28.0, 3.0]]),
             np.array([[10.0, 12.0, 60.0, 50.0, 2.0]])]
    ts = [corner_targets(b, db["categories"], db["input_size"], db["output_sizes"][0],
                         db["gaussian_iou"], max_tag_len=8) for b in boxes]
    batch = {k: torch.from_numpy(np.stack([t[k] for t in ts])) for k in ts[0]}
    batch["images"] = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(3))
    return ref, cfg, state, batch


def port_run(cfg, state, batch):
    """(heads, loss, grads) of the port's train-mode forward and loss."""
    torch.manual_seed(0)
    model = CornerNetModel(cfg["db"]["categories"], **cfg["program_kwargs"])
    model.load_state_dict(state, strict=True)
    with torch.no_grad():
        heads = [t for head in model.train()(batch["images"].permute(0, 3, 1, 2))[:6]
                 for t in head]
    loss = detection.detection_loss(model, batch, torch.float32)
    return heads, loss.detach(), torch.autograd.grad(loss, list(model.parameters()))


def reference_run(ref, cfg, state, batch, quant=None):
    """(heads, loss, grads) of the reference as the benchmark's check runs it."""
    from reference.lowp import set_quant

    model = ref.reference_model(cfg)
    model.load_state_dict(state, strict=True)
    set_quant(model.train(), quant)
    x = batch["images"].permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        heads = [t for head in model(x) for t in head]
    loss = ref.loss(model(x), batch)
    return heads, loss.detach(), torch.autograd.grad(loss, list(model.parameters()))


def gaps(got, want):
    """The worst excess of each comparison over its tolerance (<= 1 holds)."""
    g_heads, g_loss, g_grads = got
    w_heads, w_loss, w_grads = want
    heads = max(float((g - w).abs().max()) / (HEAD_TOL * max(1.0, float(w.abs().max())))
                for g, w in zip(g_heads, w_heads))
    loss = float((g_loss - w_loss).abs() / (LOSS_RTOL * w_loss.abs()))
    grads = max(float(((g - w).abs() / (GRAD_TOL * float(w.abs().max()) + GRAD_RTOL * w.abs()))
                      .max()) for g, w in zip(g_grads, w_grads))
    return {"heads": heads, "loss": loss, "grads": grads}


def test_port_matches_the_plain_reference(plain):
    ref, cfg, state, batch = plain
    got, want = port_run(cfg, state, batch), reference_run(ref, cfg, state, batch)
    assert len(got[0]) == len(want[0]) == 12
    for g, w in zip(got[0], want[0]):
        assert g.shape == w.shape
    assert len(got[2]) == len(want[2])
    worst = gaps(got, want)
    assert max(worst.values()) <= 1.0, worst


def test_bf16_convolutions_in_the_reference_break_a_tolerance(plain):
    ref, cfg, state, batch = plain

    def bf16(t):
        return t.bfloat16().float()

    def quant(x, w, out_axis):
        return bf16(x), bf16(w), bf16

    got = port_run(cfg, state, batch)
    worst = gaps(got, reference_run(ref, cfg, state, batch, quant=quant))
    assert max(worst.values()) > 1.0, worst
