"""The CornerNet cell's own pieces: the readers of the detector's spans and
of the backward, and the reference's recompute (``torch.utils.checkpoint``),
which must change neither its state_dict's keys nor its gradients."""

import types

import pytest
import torch

from harness import core
from harness.weights import meta_model, seeded_state

# metric -> the program span whose device ms it reads
READS = {"backbone_ms.b49": "detector.backbone", "heads_ms.b49": "detector.heads",
         "backward_ms.b49": "train.backward"}


def reader(name):
    return core.load_module(core.reader_path(name), "perf_metric_" + name.replace(".", "_"))


def record(spans):
    """A program trace as ``program_trace.collect`` gives it, a row a span."""
    return {"calls": 3, "counts": {}, "device": {
        s: {"ms": 10.0 * i + 1.5, "kernels": 7.0, "self_ms": 0.5, "idle_ms": 0.0}
        for i, s in enumerate(spans)}}


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_reads_its_span_or_nothing(name):
    read = reader(name).read
    span = READS[name]
    everything = record(sorted(READS.values()) + ["train.step"])
    assert read(types.SimpleNamespace(program=everything)) == everything["device"][span]["ms"]
    assert read(types.SimpleNamespace()) is None
    assert read(types.SimpleNamespace(program=None)) is None
    rest = record([s for s in sorted(READS.values()) if s != span])
    assert read(types.SimpleNamespace(program=rest)) is None


def test_recompute_changes_no_key_and_no_gradient(tiny_cell):
    cell = tiny_cell("cornernet-train-b49")
    cfg, ref = cell.config, cell.reference
    state = seeded_state(meta_model(ref.reference_model, cfg), 3, "cpu", cfg["weight_overrides"])
    ctx = types.SimpleNamespace(config=cfg, traffic=cell.traffic, device="cpu")
    batch = cell.kind.make_pool(ctx, 9)[0]
    x = batch["images"].permute(0, 3, 1, 2).contiguous()
    grads, kept = {}, {}
    for recompute in (True, False):
        model = ref.reference_model(cfg, recompute=recompute)
        model.load_state_dict(state, strict=True)
        assert list(model.state_dict()) == list(state)
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t,
                                                      lambda t: t):
            loss = ref.loss(model.train()(x), batch)
        kept[recompute] = len(saved)
        grads[recompute] = torch.autograd.grad(loss, list(model.parameters()))
    # the segments keep their inputs alone: the loss's tensors and a few more
    assert kept[True] < kept[False] / 4, kept
    for a, b in zip(grads[True], grads[False]):
        # the recompute runs the same float32 operations on the same inputs
        torch.testing.assert_close(a, b, rtol=0.0, atol=0.0)
