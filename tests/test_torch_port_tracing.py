"""The port's spans and counters (``utils.timer``) on the CPU.

Off (the default), a serve call, an int8 serve call and a detector train
step leave no ``okt::`` range in a profile and nothing in the store. On,
each names its spans with the right parents and one call id per call; the
store's arithmetic (``self_ms``, ``count``, ``snapshot``), its threads, its
clock against the profiler's and ``trace``'s export are held on hand-made
spans. Tiny widths: the same code paths at a size the CPU runs in seconds.
"""

import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from object_keypoints_tpu_torch.data.detection_targets import render_corner_targets  # noqa: E402
from object_keypoints_tpu_torch.models import cornernet  # noqa: E402
from object_keypoints_tpu_torch.ops import int8_conv  # noqa: E402
from object_keypoints_tpu_torch.ops.int8_conv import quantize  # noqa: E402
from object_keypoints_tpu_torch.pipeline.decode import (  # noqa: E402
    CameraArrays,
    decode_objects_batch,
)
from object_keypoints_tpu_torch.serving import export  # noqa: E402
from object_keypoints_tpu_torch.serving.quantize import (  # noqa: E402
    Int8Conv,
    QuantizedActivation,
    calibrate_activation_scales,
)
from object_keypoints_tpu_torch.training import detection  # noqa: E402
from object_keypoints_tpu_torch.utils import timer  # noqa: E402
from object_keypoints_tpu_torch.utils.config import SystemConfig  # noqa: E402

torch.set_num_threads(1)

KEYPOINTS = (1, 3)
TINY_KEYPOINT = dict(heatmaps_out=3, features=8, levels=2, dims=[16, 16, 32], mods=[1, 1, 1],
                     stem_features=[8, 16], cnv_dim=16)
TINY_SQUEEZE = dict(stacks=2, levels=2, dims=(16, 16, 32), mods=(1, 1, 1), hourglass="fire",
                    stem_residuals=2, cnv_dim=16)
TINY_CORNERNET = dict(stacks=2, levels=2, dims=(16, 16, 32), mods=(1, 1, 1),
                      hourglass="residual", stem_residuals=1, cnv_dim=16, head_kernel=3)
CATS = 3
DECODE = ("decode.peaks", "decode.assign", "decode.capacity", "decode.lift")
TRAIN = ("train.forward", "train.loss", "train.backward", "train.optimizer")
DETECTOR = ("detector.backbone", "detector.heads")


@pytest.fixture(autouse=True)
def fresh_store():
    """Every test starts and ends with tracing off and the store empty."""
    timer.enable(False)
    timer.snapshot()
    yield
    timer.enable(False)
    timer.snapshot()


def camera():
    k = torch.tensor([[60.0, 0.0, 32.0], [0.0, 60.0, 32.0], [0.0, 0.0, 1.0]])
    return CameraArrays(K=k, D=torch.zeros(4), Kinv=torch.linalg.inv(k),
                        image_size=torch.tensor([64.0, 64.0]))


def serve_fn(int8=False, dtype=torch.float32):
    """A tiny serve call, forward then decode, on the CPU."""
    torch.manual_seed(0)
    model = export.model_from_config(TINY_KEYPOINT).eval()
    scales = None
    if int8:
        batches = [torch.randn(2, 3, 63, 63)]
        scales = calibrate_activation_scales(model, model, batches)
    infer = export.make_inference_fn(model, dtype=dtype, device="cpu", quant_scales=scales)
    frames = torch.randn(2, 3, 63, 63)
    cam = camera()

    def call():
        return decode_objects_batch(*infer(frames), cam, KEYPOINTS, max_peaks=4)
    return call


def train_fn(arch=TINY_SQUEEZE):
    """A tiny CornerNet-Squeeze (or ``arch``) train step on the CPU."""
    torch.manual_seed(0)
    model = cornernet.CornerNetModel(CATS, **arch)
    optimizer = detection.make_detection_optimizer(SystemConfig(learning_rate=1e-3, stepsize=10))
    state = detection.create_train_state(model, optimizer, torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    boxes = np.array([[4.0, 6.0, 30.0, 40.0, 1.0], [20.0, 10.0, 50.0, 28.0, 2.0]], np.float32)
    out = 64 // 2 ** (1 + arch["stem_residuals"])
    ts = [render_corner_targets(boxes, CATS, (64, 64), (out, out), gaussian_iou=0.3,
                                max_tag_len=8)
          for _ in range(2)]
    batch = {k: np.stack([t[k] for t in ts]) for k in ts[0]}
    batch["images"] = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)

    def call():
        return detection.detection_train_step(state, batch)
    return call


CALLS = {"serve": serve_fn, "serve_int8": lambda: serve_fn(int8=True), "train": train_fn,
         "train_cornernet": lambda: train_fn(TINY_CORNERNET)}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_off_leaves_no_range_and_no_record(name):
    call = CALLS[name]()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    assert not [e.name for e in prof.events() if e.name.startswith(timer.PREFIX)]
    assert timer.snapshot() == {"spans": [], "counts": {}}


def test_off_span_is_one_shared_context():
    assert not timer.enabled()
    assert timer.span("a") is timer.span("b")


def by_name(spans):
    out = {}
    for i, s in enumerate(spans):
        out.setdefault(s["name"], []).append(i)
    return out


def test_serve_spans_parents_and_calls():
    call = serve_fn()
    call()  # warm
    timer.enable(True)
    for _ in range(2):
        call()
    spans = timer.snapshot()["spans"]
    names = by_name(spans)
    assert set(names) == {"serve", "decode", *DECODE}
    assert len(names["serve"]) == len(names["decode"]) == 2
    for root in names["serve"] + names["decode"]:
        assert spans[root]["parent"] is None
    # serve and decode are two calls each time: four call ids in all
    assert len({spans[i]["call"] for i in names["serve"] + names["decode"]}) == 4
    for stage in DECODE:
        for i in names[stage]:
            parent = spans[i]["parent"]
            assert spans[parent]["name"] == "decode" and spans[i]["call"] == spans[parent]["call"]
            assert spans[parent]["start"] <= spans[i]["start"] <= spans[i]["end"] <= spans[parent]["end"]


def test_weights_built_counts_a_cast_made_again():
    call = serve_fn(dtype=torch.bfloat16)
    timer.enable(True)
    call()
    first = timer.snapshot()["counts"].get("weights.built", 0)
    call()
    again = timer.snapshot()["counts"].get("weights.built", 0)
    assert first > 0 and again == 0  # the casts are kept from the first call on


def test_int8_serve_spans():
    call = serve_fn(int8=True)
    call()
    timer.enable(True)
    call()
    taken = timer.snapshot()
    spans, names = taken["spans"], by_name(taken["spans"])
    assert {"serve", "int8.quantize", "int8.rescale"} <= set(names)
    serve_call = spans[names["serve"][0]]["call"]
    for name in ("int8.quantize", "int8.rescale"):
        assert all(spans[i]["call"] == serve_call for i in names[name])
    assert taken["counts"] == {}  # the int8 weights are made once, at the swap


def test_weights_built_counts_int8_weights_quantized_again():
    """An input quantized at another scale than the conv's own makes the
    conv quantize its weights again, in every call."""
    conv = torch.nn.Conv2d(16, 8, 3, padding=1)
    qconv = Int8Conv(conv, 2.0, "conv")
    x = torch.randn(1, 16, 5, 5)
    timer.enable(True)
    qconv(x)
    assert timer.snapshot()["counts"] == {}
    for scale in (2.0, 3.0):
        qconv(QuantizedActivation(quantize(x, 127.0 / scale), scale, x.dtype))
    assert timer.snapshot()["counts"] == {"weights.built": 1}


def test_int8_gemm_route_spans():
    """The GEMM route (``torch._int_mm`` runs on the CPU too): one im2col span
    for the padding and one a chunk, one ``int8.mm`` a GEMM, and the
    ConvTranspose's interleave under ``int8.rescale``."""
    gen = torch.Generator().manual_seed(0)
    xq = torch.randint(-127, 128, (2, 9, 9, 16), dtype=torch.int8, generator=gen)
    w = torch.randint(-127, 128, (24, 16, 3, 3), dtype=torch.int8, generator=gen)
    wt = torch.randint(-127, 128, (16, 24, 4, 4), dtype=torch.int8, generator=gen)
    timer.enable(True)
    got = int8_conv.int8_conv2d_gemm(xq, int8_conv.pack_conv2d_weight(w), 24, 3, 1, 1)
    names = [s["name"] for s in timer.snapshot()["spans"]]
    assert names == ["int8.im2col", "int8.im2col", "int8.mm"]
    assert torch.equal(got, int8_conv.int8_conv2d_plain(xq, w, 1, 1))
    got = int8_conv.int8_conv_transpose2d_gemm(xq, int8_conv.pack_conv_transpose2d_weight(wt), 24)
    names = [s["name"] for s in timer.snapshot()["spans"]]
    assert names == ["int8.im2col"] + ["int8.im2col", "int8.mm"] * 4 + ["int8.rescale"]
    assert torch.equal(got, int8_conv.int8_conv_transpose2d_plain(xq, wt))


def test_train_spans_parents_and_calls():
    call = train_fn()
    timer.enable(True)
    for _ in range(2):
        call()
    spans = timer.snapshot()["spans"]
    names = by_name(spans)
    assert set(names) == {"train.step", *TRAIN, *DETECTOR, "corner_pool.forward",
                          "corner_pool.backward"}
    steps = names["train.step"]
    assert len(steps) == 2 and all(spans[i]["parent"] is None for i in steps)
    assert len({spans[i]["call"] for i in steps}) == 2
    for name in TRAIN:
        assert [spans[spans[i]["parent"]]["name"] for i in names[name]] == ["train.step"] * 2
    # four pools a stack, two stacks: eight a step each way; a CPU backward runs on this thread
    assert len(names["corner_pool.forward"]) == len(names["corner_pool.backward"]) == 16
    for name, parent in (("corner_pool.forward", "detector.heads"),
                         ("corner_pool.backward", "train.backward")):
        assert {spans[spans[i]["parent"]]["name"] for i in names[name]} == {parent}
    for i, s in enumerate(spans):
        root = i
        while spans[root]["parent"] is not None:
            root = spans[root]["parent"]
        assert s["call"] == spans[root]["call"]


@pytest.mark.parametrize("arch", ["squeeze", "cornernet"])
def test_detector_spans_in_a_train_step(arch):
    """One step: the backbone and the heads once each under ``train.forward``,
    every forward pool inside the heads, none of the backward's."""
    call = train_fn(TINY_SQUEEZE if arch == "squeeze" else TINY_CORNERNET)
    timer.enable(True)
    call()
    spans = timer.snapshot()["spans"]
    names = by_name(spans)
    for name in DETECTOR:
        assert len(names[name]) == 1
        assert spans[spans[names[name][0]]["parent"]]["name"] == "train.forward"
    backbone, heads = (spans[names[n][0]] for n in DETECTOR)
    assert backbone["end"] <= heads["start"]
    assert len(names["corner_pool.forward"]) == 8
    assert {spans[i]["parent"] for i in names["corner_pool.forward"]} == {names["detector.heads"][0]}


def test_detector_spans_in_the_test_path():
    """The test path: the backbone, then the last stack's heads (four pools),
    and the decode after both, outside them."""
    torch.manual_seed(0)
    model = cornernet.CornerNetModel(CATS, **TINY_CORNERNET).eval()
    x = torch.randn(1, 3, 64, 64)
    timer.enable(True)
    with torch.no_grad():
        model(x, test=True)
    spans = timer.snapshot()["spans"]
    names = by_name(spans)
    assert set(names) == {*DETECTOR, "corner_pool.forward"}
    assert [s["name"] for s in spans if s["parent"] is None] == list(DETECTOR)
    assert len(names["corner_pool.forward"]) == 4
    timer.enable(False)
    with torch.no_grad():
        model(x, test=True)
    assert timer.snapshot() == {"spans": [], "counts": {}}


def record(name, parent, start, end, call=0, thread=1):
    return {"name": name, "parent": parent, "call": call, "thread": thread,
            "start": int(start * 1e6), "end": int(end * 1e6)}


def test_self_ms_of_nested_spans():
    spans = [record("outer", None, 0.0, 10.0), record("inner", 0, 2.0, 5.0),
             record("inner", 0, 6.0, 7.5), record("leaf", 2, 6.5, 7.0)]
    got = timer.self_ms(spans)
    assert got == pytest.approx({"outer": 5.5, "inner": 4.0, "leaf": 0.5})


def test_a_second_thread_keeps_its_own_parent_chain():
    timer.enable(True)
    seen = {}

    def worker():
        with timer.span("thread.outer"):
            with timer.span("thread.inner"):
                seen["thread"] = threading.get_ident()

    with timer.span("main"):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
        with timer.span("main.inner"):
            pass
    spans = timer.snapshot()["spans"]
    names = {s["name"]: i for i, s in enumerate(spans)}
    main, outer, inner = names["main"], names["thread.outer"], names["thread.inner"]
    assert spans[outer]["parent"] is None and spans[inner]["parent"] == outer
    assert spans[names["main.inner"]]["parent"] == main
    assert spans[outer]["thread"] == spans[inner]["thread"] == seen["thread"]
    assert spans[outer]["thread"] != spans[main]["thread"]
    # a thread with no open span joins the call open on another
    assert len({s["call"] for s in spans}) == 1


def test_count_accumulates_and_snapshot_clears():
    timer.count("x")  # off: not counted
    timer.enable(True)
    timer.count("x")
    timer.count("x", 3)
    timer.count("y", 2)
    with timer.span("s"):
        pass
    taken = timer.snapshot()
    assert taken["counts"] == {"x": 4, "y": 2} and len(taken["spans"]) == 1
    assert timer.snapshot() == {"spans": [], "counts": {}}


def test_span_clock_is_the_profilers():
    timer.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with timer.span("clock"):
                torch.relu(torch.randn(64, 64))
            time.sleep(0.002)
    spans = timer.snapshot()["spans"]
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    events = sorted(e.time_range.start for e in prof.events() if e.name == timer.PREFIX + "clock")
    assert len(events) == len(spans) == 3
    # the median of the three, so that one preemption between the two clock reads cannot fail it
    assert np.median([abs(start_ns + e * 1e3 - s["start"]) for s, e in zip(spans, events)]) < 1e6


@pytest.mark.parametrize("was", [False, True])
def test_trace_writes_okt_ranges_and_restores_the_state(tmp_path, was):
    timer.enable(was)
    with timer.trace(str(tmp_path)):
        assert timer.enabled()
        with timer.span("region"):
            torch.relu(torch.randn(64, 64))
    assert timer.enabled() is was
    with open(tmp_path / timer.TRACE_NAME) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == timer.PREFIX + "region" for e in events)
    left = timer.snapshot()["spans"]
    if was:  # the store's owner takes the region's spans
        assert [s["name"] for s in left] == ["region"]
    else:  # they left the store for spans.json
        assert not left
        with open(tmp_path / timer.SPANS_NAME) as f:
            exported = json.load(f)
        assert [s["name"] for s in exported["spans"]] == ["region"]
        assert set(exported["self_ms"]) == {"region"}


def test_trace_restores_the_state_after_an_exception(tmp_path):
    with pytest.raises(RuntimeError):
        with timer.trace(str(tmp_path)):
            raise RuntimeError("inside")
    assert not timer.enabled() and timer.snapshot() == {"spans": [], "counts": {}}
