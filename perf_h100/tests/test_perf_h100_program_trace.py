"""The program's spans reduced against hand-made profiles
(``harness.program_trace``): which span a kernel and an idle gap go to,
annotations left out of the device operations, and ``collect`` on the CPU."""

import threading
import types

import pytest
import torch
from torch.autograd import DeviceType

from harness import program_trace
from object_keypoints_tpu_torch.utils import timer

MAIN, AUTOGRAD = 1, 2


def span(name, start, end, thread=MAIN, parent=None, call=0):
    """A store record, its times given in us."""
    return {"name": name, "parent": parent, "call": call, "thread": thread,
            "start": int(start * 1e3), "end": int(end * 1e3)}


def event(name, start, end, device=DeviceType.CPU, id=0, annotation=False):
    """A profile event as ``prof.events()`` gives it, its times in us."""
    return types.SimpleNamespace(name=name, device_type=device, id=id,
                                 time_range=types.SimpleNamespace(start=start, end=end),
                                 is_user_annotation=annotation)


def kernel(name, start, end, corr):
    return event(name, start, end, DeviceType.CUDA, corr)


def launch(start, corr):
    return event("cudaLaunchKernel", start, start + 1, id=corr)


def test_a_kernel_launched_by_a_second_thread_goes_to_the_later_started_span():
    spans = [span("train.step", 0, 100), span("train.backward", 10, 90, parent=0),
             span("corner_pool.backward", 20, 40, thread=AUTOGRAD)]
    events = [launch(30, 7), kernel("scan", 32, 36, 7),
              launch(50, 8), kernel("wgrad", 52, 60, 8)]
    ops = program_trace.device_ops(events, 0)
    assert [at for *_, at in ops] == [30_000, 50_000]
    out = program_trace.attribute(spans, ops, MAIN, 0, calls=1)
    dev = out["device"]
    assert dev["corner_pool.backward"]["self_kernels"] == 1.0
    assert dev["corner_pool.backward"]["self_ms"] == pytest.approx(0.004)
    assert dev["train.backward"]["self_kernels"] == 1.0
    assert dev["train.backward"]["kernels"] == dev["train.step"]["kernels"] == 2.0
    assert dev["train.step"]["ms"] == pytest.approx(0.012) and dev["train.step"]["self_ms"] == 0.0
    assert out["ops"] == out["launched"] == 2


def test_annotations_are_never_device_operations():
    events = [kernel("okt::decode", 0, 50, 1), launch(1, 2), kernel("peaks", 5, 10, 2),
              event("gpu_user_annotation", 0, 50, DeviceType.CUDA, 3, annotation=True),
              event("okt::decode", 0, 60)]
    ops = program_trace.device_ops(events, 0)
    assert [name for _, _, name, _ in ops] == ["peaks"]


def test_a_kernel_takes_the_runtime_call_of_its_correlation_id():
    """Not an operator that shares the id, nor a call after the kernel."""
    events = [event("aten::relu", 19, 23, id=5), launch(20, 5), launch(30, 5),
              kernel("relu", 25, 26, 5), kernel("orphan", 40, 41, 6)]
    assert [at for *_, at in program_trace.device_ops(events, 1_000)] == [1_000 + 20_000, None]


def test_idle_gaps_go_to_the_innermost_span_on_the_calling_thread():
    spans = [span("decode", 0, 100), span("decode.capacity", 40, 80, parent=0),
             span("other", 5, 100, thread=AUTOGRAD)]
    ops = [(0, 40_000, "peaks", 1_000), (60_000, 70_000, "mask", 45_000)]
    out = program_trace.attribute(spans, ops, MAIN, 0, calls=2)
    dev = out["device"]
    # the card idles 40-60 us, opening inside decode.capacity on the calling thread
    assert dev["decode.capacity"]["self_idle_ms"] == pytest.approx(0.010)
    assert dev["decode"]["idle_ms"] == pytest.approx(0.010)
    assert dev["decode"]["self_idle_ms"] == 0.0
    assert "other" not in dev or dev["other"]["idle_ms"] == 0.0
    assert dev["decode.capacity"]["kernels"] == 0.5 and dev["decode"]["kernels"] == 1.0


def test_work_and_idle_under_no_span_are_outside():
    ops = [(10_000, 20_000, "k", 5_000), (30_000, 40_000, "k", None)]
    out = program_trace.attribute([span("serve", 0, 8)], ops, MAIN, 0, calls=1)
    assert out["outside"]["kernels"] == 1.0 and out["device"]["serve"]["kernels"] == 1.0
    assert out["outside"]["idle_ms"] == pytest.approx(0.010)  # 20-30 us
    assert out["device"]["serve"]["idle_ms"] == pytest.approx(0.010)  # 0-10 us
    assert out["launched"] == 1


def test_collect_on_the_cpu():
    def call(rf, j):
        with rf("a harness mark"), timer.span("serve"):
            timer.count("weights.built", 2)
            with timer.span("decode"):
                torch.relu(torch.randn(8, 8))

    out = program_trace.collect(call, 3, device="cpu")
    assert not timer.enabled() and timer.snapshot() == {"spans": [], "counts": {}}
    assert out["calls"] == 3 and out["counts"] == {"weights.built": 2.0}
    assert out["host"]["serve"]["spans"] == out["host"]["decode"]["spans"] == 1.0
    host = out["host"]["serve"]
    assert host["self_ms"] == pytest.approx(host["ms"] - out["host"]["decode"]["ms"])
    assert out["wall_ms"] > 0 and out["ops"] == 0 and out["device"] == {}
    assert out["clock_ms"] is not None and out["clock_ms"] < 1.0


@pytest.mark.parametrize("was", [False, True])
def test_collect_restores_the_tracing_state_after_an_error(was):
    def call(rf, j):
        with timer.span("serve"):
            raise RuntimeError("inside")

    timer.enable(was)
    try:
        with pytest.raises(RuntimeError):
            program_trace.collect(call, 2, device="cpu")
        assert timer.enabled() is was
    finally:
        timer.enable(False)
        timer.snapshot()


def test_spans_of_another_thread_keep_to_their_call():
    """A thread with no open span joins the call open on the calling thread
    (autograd's backward thread does)."""
    timer.enable(True)
    try:
        with timer.span("train.step"):
            t = threading.Thread(target=lambda: timer.span("corner_pool.backward").__enter__()
                                 .__exit__(None, None, None))
            t.start()
            t.join()
        spans = timer.snapshot()["spans"]
    finally:
        timer.enable(False)
    assert [s["call"] for s in spans] == [spans[0]["call"]] * 2
    assert spans[1]["parent"] is None and spans[1]["thread"] != spans[0]["thread"]
