"""The per-layer metrics read from the program's own spans and counters
(``harness.program_trace.collect``'s record, ``run.program``): each reads
its field of a hand-made record, and nothing where the run has no record or
the record lacks its span."""

import types

import pytest

from harness import core

MANIFEST = core.read_json(f"{core.ROOT}/BENCHMARK.json")
# metric -> (span, field) of the record's ``device`` table that it reads
READS = {
    "decode_idle_ms.serve": ("decode", "idle_ms"),
    "decode_kernels.serve": ("decode", "kernels"),
    "quantize_ms.int8": ("int8.quantize", "ms"),
    "im2col_ms.int8": ("int8.im2col", "ms"),
    "int8_mm_ms.int8": ("int8.mm", "ms"),
    "rescale_ms.int8": ("int8.rescale", "ms"),
    "optimizer_ms.train": ("train.optimizer", "ms"),
    "step_kernels.train": ("train.step", "kernels"),
}
COUNTERS = ("weight_builds.serve", "weight_builds.int8")
SPANS = ("serve", "decode", "decode.lift", "int8.quantize", "int8.im2col", "int8.mm",
         "int8.rescale", "train.step", "train.optimizer", "corner_pool.forward",
         "corner_pool.backward")
FIELDS = ("ms", "kernels", "self_ms", "self_kernels", "idle_ms", "self_idle_ms")


def reader(name):
    return core.load_module(core.reader_path(name), "perf_metric_" + name.replace(".", "_"))


def program(spans=SPANS, counts=None):
    """A record as ``collect`` gives it, every (span, field) a number of its own."""
    device = {s: {f: 100.0 * i + j + 0.5 for j, f in enumerate(FIELDS)}
              for i, s in enumerate(spans)}
    return {"calls": 3, "wall_ms": 80.0, "host": {}, "counts": counts or {}, "device": device,
            "outside": {"ms": 1.0, "kernels": 2.0, "idle_ms": 3.0}, "ops": 10, "launched": 10,
            "clock_ms": 0.01}


def run(record):
    return types.SimpleNamespace(program=record)


NEW = sorted(READS) + list(COUNTERS) + ["corner_pool_ms.train"]


def test_every_program_metric_is_in_the_manifest_as_a_program_span():
    entries = {m["name"]: m for m in MANIFEST["per_layer"]}
    for name in NEW:
        assert entries[name]["source"] == "program_span", name


@pytest.mark.parametrize("name", NEW)
def test_nothing_without_a_program_record(name):
    assert reader(name).read(types.SimpleNamespace()) is None
    assert reader(name).read(run(None)) is None


@pytest.mark.parametrize("name", sorted(READS))
def test_reads_its_span_and_field(name):
    span, field = READS[name]
    rec = program()
    assert reader(name).read(run(rec)) == rec["device"][span][field]
    assert reader(name).read(run(program(spans=[s for s in SPANS if s != span]))) is None


def test_corner_pools_are_both_passes():
    rec = program()
    dev = rec["device"]
    want = dev["corner_pool.forward"]["ms"] + dev["corner_pool.backward"]["ms"]
    assert reader("corner_pool_ms.train").read(run(rec)) == want
    for gone in ("corner_pool.forward", "corner_pool.backward"):
        rest = program(spans=[s for s in SPANS if s != gone])
        assert reader("corner_pool_ms.train").read(run(rest)) is None


@pytest.mark.parametrize("name", COUNTERS)
def test_weight_builds_read_the_counter_a_call(name):
    assert reader(name).read(run(program(counts={"weights.built": 2.0, "other": 5.0}))) == 2.0
    # a counter that never fired is a count of nought, not a missing reading
    assert reader(name).read(run(program(counts={"int8.quantize.kernel": 30.0}))) == 0.0
