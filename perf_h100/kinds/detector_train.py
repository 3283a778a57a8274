"""The CornerNet detector's bare train step on batches resident on the card.

The traffic file gives:

- ``batch``: images a step, of the configuration's ``input_size``;
- ``pool``: distinct batches made at set-up from the seed and cycled (at
  least ``checked_steps`` + 1, so the checked steps' rows all differ);
- ``dtype``: the compute dtype over float32 parameters;
- ``objects``: the synthetic COCO-like boxes an image: a Poisson count
  (``mean``, at least ``min``, at most ``max``), a size class by COCO's
  shares (``size_shares`` of small / medium / large, with the side ranges
  ``sides`` in input pixels) and an aspect ratio log-uniform in
  ``aspect``; categories uniform;
- ``checked_steps``: the set-up's first steps, which the check follows;
  ``trace_seconds``: how long a traced run profiles the card's activity
  after the window, steps back to back on the pool; ``trace_calls``: steps
  profiled with the host's activity too, for the idle gaps
  (``harness.trace``), and each of the two stretches of the program's own
  spans and counters, taken after every other reading
  (``harness.program_trace``).

Images are unit-normal noise on the card (the step takes normalized
frames); the corner targets come from the boxes through
``reference.corner_targets``. Set-up builds one train state (the port's
``training.detection.create_train_state`` with Adam as the configuration
states), runs the checked steps through ``detection_train_step`` (they warm
every kernel), and hands that state to the window, which runs the same call
on the pool's next batches until ``--seconds`` have passed and ends in a
synchronise.

The check, once the window has closed and the program is freed: the plain
reference (float32, TF32 off) runs the checked steps from the same seeded
weights on the same batches with Adam, and compares:

- ``heads_gap``: the first checked step's head outputs (the six heads of
  every stack, as the step's forward produced them): the largest
  |program - reference| of a map over max(1, max |reference|) of that map;
- ``loss_gap``: the largest |program - reference| / |reference| of the
  checked steps' losses;
- ``grad_gap``: the worst leaf's |norm(program) - norm(reference)| of the
  first step's gradient (the program's read from Adam's first moment after
  one step), over the larger of the reference's norm of that leaf and of the
  median leaf;
- ``update_gap``: the same of each leaf's change after the checked steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (they move by round-off alone under Adam).
"""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from harness import flops, program_trace, trace
from harness.core import device_record, dtype, sync
from harness.weights import materialize, meta_model, seeded_state
from reference import lowp
from reference.adam import Adam
from reference.corner_targets import corner_targets

BATCH_KEYS = ("tl_heatmaps", "br_heatmaps", "tl_regrs", "br_regrs", "tl_tags", "br_tags",
              "tag_mask")
B1 = 0.9



def _factory(path):
    module, _, name = path.partition(":")
    return getattr(__import__(module, fromlist=[name]), name)


def port_model(config):
    """The port's detector of ``config`` (its ``program_factory`` with the
    categories and ``program_kwargs``) on the meta device."""
    return meta_model(_factory(config["program_factory"]), config["db"]["categories"],
                      **config.get("program_kwargs", {}))


class Program:
    """The port's train state and step, built from the seeded state."""

    def __init__(self, ctx, state):
        from object_keypoints_tpu_torch.training import detection

        cfg = ctx.config
        model = materialize(port_model(cfg), state, ctx.device)
        opt = detection.DetectionOptimizer(cfg["system"]["opt_algo"], detection.step_decay_schedule(
            cfg["system"]["learning_rate"], cfg["system"]["stepsize"],
            cfg["system"]["decay_rate"]))
        self.state = detection.create_train_state(model, opt, dtype(ctx.traffic["dtype"]),
                                                  ctx.device)
        self.train_step = detection.detection_train_step
        self.model = model
        self.names = [n for n, _ in model.named_parameters()]

    def step(self, batch):
        return self.train_step(self.state, batch)[1]["loss"]

    def first_grad_norms(self):
        """After the first step: Adam's first moment is (1 - b1) g."""
        return [n / (1.0 - B1) for n in torch._foreach_norm(self.state.opt_state.mu)]

    def params(self):
        return list(self.state.model.parameters())


class Reference:
    """The plain reference's train step (float32, TF32 off, Adam); with
    ``quant`` its convolutions take lower-precision operands (the control)."""

    def __init__(self, ctx, state, quant=None):
        cfg = ctx.config
        self.model = ctx.reference.reference_model(cfg)
        self.model.load_state_dict(state, strict=True)
        self.model.to(ctx.device).train()
        lowp.set_quant(self.model, quant)
        self.loss_fn = ctx.reference.loss
        self.names = [n for n, _ in self.model.named_parameters()]
        self.opt = Adam(list(self.model.parameters()), cfg["system"]["learning_rate"])
        self.grads = None

    def step(self, batch):
        with lowp.no_tf32():
            loss = self.loss_fn(self.model(batch["images"].permute(0, 3, 1, 2).float().contiguous()), batch)
            grads = torch.autograd.grad(loss, list(self.model.parameters()))
        if self.grads is None:
            self.grads = [g.norm() for g in grads]
        self.opt.step(grads)
        return loss.detach()

    def first_grad_norms(self):
        return self.grads

    def params(self):
        return list(self.model.parameters())


class Control(Reference):
    """The reference in the program's place, its convolutions in float8 e4m3
    and their gradients in e5m2 (``lowp.fp8``, the precision below
    bfloat16)."""

    def __init__(self, ctx, state):
        super().__init__(ctx, state, lowp.fp8)


class ControlForward(Reference):
    """The reference in the program's place with the forward's convolutions
    alone in float8 e4m3, the gradients passed through (``lowp.fp8_forward``)."""

    def __init__(self, ctx, state):
        super().__init__(ctx, state, lowp.fp8_forward)


CONTROLS = {"control": Control, "control_forward": ControlForward}


def keep_heads(model):
    """A list that the next forward of ``model`` fills with its six head
    outputs of every stack (detached), once."""
    kept = []

    def hook(module, args, out):
        handle.remove()
        kept.extend(t.detach() for head in out[:6] for t in head)

    handle = model.register_forward_hook(hook)
    return kept


def sample_boxes(rng, spec, size, categories):
    """(n, 5) [x1, y1, x2, y2, category] boxes inside a ``size`` (h, w) image."""
    n = int(np.clip(rng.poisson(spec["mean"]), spec["min"], spec["max"]))
    cls = rng.choice(len(spec["size_shares"]), size=n, p=np.asarray(spec["size_shares"]) /
                     np.sum(spec["size_shares"]))
    lo, hi = np.asarray(spec["sides"], np.float64)[cls].T
    side = np.exp(rng.uniform(np.log(lo), np.log(hi)))
    aspect = np.exp(rng.uniform(*np.log(spec["aspect"]), size=n))
    w = np.minimum(side * np.sqrt(aspect), size[1] - 2.0)
    h = np.minimum(side / np.sqrt(aspect), size[0] - 2.0)
    x1 = rng.uniform(0.0, size[1] - 1.0 - w)
    y1 = rng.uniform(0.0, size[0] - 1.0 - h)
    cat = rng.integers(1, categories + 1, size=n)
    return np.stack([x1, y1, x1 + w, y1 + h, cat], axis=1)


def make_pool(ctx, seed):
    """The pool of batches on the card, from ``seed``."""
    tr, db = ctx.traffic, ctx.config["db"]
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(seed)
    h, w = db["input_size"]
    pool = []
    for _ in range(tr["pool"]):
        targets = [corner_targets(sample_boxes(rng, tr["objects"], (h, w), db["categories"]),
                                  db["categories"], db["input_size"], db["output_sizes"][0],
                                  db["gaussian_iou"]) for _ in range(tr["batch"])]
        batch = {k: torch.from_numpy(np.stack([t[k] for t in targets])).to(ctx.device)
                 for k in BATCH_KEYS}
        batch["images"] = torch.randn((tr["batch"], h, w, 3), generator=gen, device=ctx.device)
        pool.append(batch)
    return pool



def run(ctx, program_cls=Program):
    tr, dev = ctx.traffic, ctx.device
    w_seed, in_seed, _ = ctx.streams
    phases = {}
    t = time.perf_counter()
    state = seeded_state(meta_model(ctx.reference.reference_model, ctx.config), w_seed, dev,
                         ctx.config.get("weight_overrides"))
    pool = make_pool(ctx, in_seed)
    phases["weights_inputs"] = time.perf_counter() - t
    t = time.perf_counter()
    program = program_cls(ctx, state)
    k = tr["checked_steps"]
    losses, heads = [], keep_heads(program.model)
    for i in range(k):
        losses.append(program.step(pool[i % len(pool)]))
        if i == 0:
            grads = program.first_grad_norms()
    deltas = [(p.detach() - state[n]).norm() for n, p in zip(program.names, program.params())]
    sync(dev)
    phases["build_checked_steps"] = time.perf_counter() - t

    spans = trace.Spans(ctx.trace and dev != "cpu")
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t0
    steps = 0
    while True:
        a = spans.mark()
        program.step(pool[(k + steps) % len(pool)])
        spans.add("step", a, spans.mark())
        steps += 1
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    sync(dev)
    window_s = time.perf_counter() - t_start

    rec = types.SimpleNamespace(
        setup_s=setup_s, window_s=window_s, calls=steps, units=steps * tr["batch"],
        latencies_s=[], spans=spans.ms() if spans.enabled else {}, trace=None,
        attempted=steps, failed=0, readings={}, info={"setup_phases_s": phases})
    if ctx.trace and dev != "cpu":
        def call(rf, j):
            with rf("step"):
                program.step(pool[j % len(pool)])

        stretch = trace.profile(call, tr["trace_seconds"], host=False)
        rec.trace = trace.over_window(
            trace.reduce_trace(stretch, trace.profile(call, tr["trace_calls"], host=True)),
            stretch.calls, steps, window_s)
        rec.info["trace_stretch"] = rec.trace.get("stretch")
    h, w = ctx.config["db"]["input_size"]
    rec.info["flops_per_call"] = 3 * flops.conv_flops(
        meta_model(ctx.reference.reference_model, ctx.config), (tr["batch"], 3, h, w))
    rec.info["peak"] = "bf16"
    rec.device = device_record(ctx)
    if ctx.trace and dev != "cpu":
        rec.program = program_trace.collect(call, tr["trace_calls"])
        rec.info["program_trace"] = rec.program
    got = {"losses": torch.stack(losses).float().cpu(), "grads": torch.stack(grads).float().cpu(),
           "deltas": torch.stack(deltas).float().cpu(), "heads": heads}
    names = program.names
    del program
    if dev != "cpu":
        torch.cuda.empty_cache()
    rec.readings = check(ctx, state, pool, names, got, rec.info)
    return rec



def reference_run(ctx, state, pool, got_heads):
    """The reference's checked steps: (losses, first grad norms, change norms,
    names, the first step's heads_gap against ``got_heads``)."""
    ref = Reference(ctx, state)
    want_heads = keep_heads(ref.model)
    losses = [ref.step(pool[0])]
    gap = heads_gap(got_heads, want_heads)
    del want_heads[:]
    losses += [ref.step(pool[i % len(pool)]) for i in range(1, ctx.traffic["checked_steps"])]
    deltas = [(p.detach() - state[n]).norm() for n, p in zip(ref.names, ref.params())]
    return (torch.stack(losses).double().cpu(), torch.stack(ref.first_grad_norms()).double().cpu(),
            torch.stack(deltas).double().cpu(), ref.names, gap)


def heads_gap(got, want):
    """max over maps of max |got - want| / max(1, max |want|); infinite where
    the maps differ in number or shape."""
    if len(got) != len(want) or any(g.shape != w.shape for g, w in zip(got, want)):
        return float("inf")
    gap = 0.0
    for g, w in zip(got, want):
        scale = max(1.0, w.abs().max().item())
        gap = max(gap, (g.float() - w).abs().max().item() / scale)
    return gap


def check(ctx, state, pool, names, got, info=None):
    want_loss, want_grad, want_delta, ref_names, gap = reference_run(ctx, state, pool,
                                                                     got.pop("heads"))
    if ref_names != names:
        raise RuntimeError("the program's parameters are not the reference's")
    if info is not None:
        info["leaves"] = leaf_report(names, got, want_grad, want_delta)
    return dict(readings(got, want_loss, want_grad, want_delta), heads_gap=gap)


def leaf_report(names, got, want_grad, want_delta):
    """The five worst leaves of each gap and the median leaf's, to look at."""
    out = {}
    for key, want in (("grads", want_grad), ("deltas", want_delta)):
        floor = want.median()
        gap = (got[key].double() - want).abs() / torch.maximum(want, floor)
        worst = torch.argsort(gap, descending=True)[:5].tolist()
        out[key] = {"median_gap": float(gap.median()), "median_norm": float(floor),
                    "worst": [[names[i], float(gap[i]), float(want[i])] for i in worst]}
    return out


def worst_leaf(got, want, keep=None):
    """max over leaves of |got - want| / max(want, median(want))."""
    keep = torch.ones_like(want, dtype=torch.bool) if keep is None else keep
    floor = want[keep].median()
    gap = (got.double() - want).abs() / torch.maximum(want, floor)
    return float(gap[keep].max())


def readings(got, want_loss, want_grad, want_delta):
    loss_gap = float(((got["losses"].double() - want_loss).abs() / want_loss.abs()).max())
    keep = want_grad >= 1e-3 * want_grad.median()
    return {"loss_gap": loss_gap, "grad_gap": worst_leaf(got["grads"], want_grad),
            "update_gap": worst_leaf(got["deltas"], want_delta, keep)}
