"""The device trace's reduction on hand-made events: busy time, window, the
idle gaps by span, and kernel names cut so that kernels stay apart."""

import types

from torch.autograd import DeviceType

from harness import trace


def event(name, start, end, device=True):
    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=start, end=end),
                                 device_type=DeviceType.CUDA if device else DeviceType.CPU)


def prof(events):
    return types.SimpleNamespace(events=lambda: events)


def test_busy_window_and_gaps():
    device = prof([event("k1", 10, 20), event("k2", 15, 30), event("k3", 50, 60),
                   event("forward", 10, 30)])  # a span's annotation: not an operation
    host = prof([event("call", 0, 60, False), event("forward", 0, 35, False),
                 event("decode", 35, 60, False), event("k1", 10, 20), event("k3", 50, 60)])
    out = trace.reduce_trace(device, host)
    assert out["busy_s"] == 30e-6 and out["window_s"] == 50e-6
    assert out["kernels"] == {"k1": [10e-6, 1], "k2": [15e-6, 1], "k3": [10e-6, 1]}
    # in the host's profile the card is idle 0-10 and 20-50, both gaps opening in "forward"
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert list(gaps) == ["forward"] and abs(gaps["forward"] - 40e-6) < 1e-12


def test_program_ranges_are_not_device_operations():
    """The program's ``okt::`` ranges, left on, neither count as kernels nor
    fill the card's idle time."""
    device = prof([event("k1", 10, 20), event("okt::decode", 20, 50), event("k3", 50, 60)])
    host = prof([event("call", 0, 60, False), event("decode", 0, 60, False),
                 event("okt::decode", 15, 55, False), event("k1", 10, 20),
                 event("okt::decode", 20, 50), event("k3", 50, 60)])
    out = trace.reduce_trace(device, host)
    assert out["busy_s"] == 20e-6 and out["window_s"] == 50e-6
    assert set(out["kernels"]) == {"k1", "k3"}
    assert dict(out["breakdown"]["idle_gaps"]) == {"decode": 40e-6}


def test_no_device_operation_reads_nothing():
    out = trace.reduce_trace(prof([]), prof([]))
    assert out["busy_s"] == 0.0 and out["breakdown"] is None


def test_kernel_names_stay_apart():
    names = [
        "void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::"
        "sigmoid_kernel_cuda(at::TensorIteratorBase&)::{lambda()#2}::operator()() const::"
        "{lambda(float)#1}, std::array<char*, 2ul> >(int, ...)",
        "void at::native::vectorized_elementwise_kernel<8, at::native::CUDAFunctor_add<c10::"
        "BFloat16>, std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<c10::BFloat16>, ...)",
        "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize64x128x64_"
        "warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_cudnn",
        "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64_"
        "warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_cudnn",
        "(anonymous namespace)::stem_conv_bf16_kernel(__nv_bfloat16 const*, float const*)",
    ]
    short = [trace.short_kernel_name(n) for n in names]
    assert len(set(short)) == len(short)
    assert all(len(s) <= trace.NAME_LENGTH for s in short)
    assert short[0] == "vectorized_elementwise_kernel:sigmoid_kernel_cuda"
    assert "CUDAFunctor_add" in short[1] and "stem_conv_bf16" in short[4]


def test_over_window_takes_the_stretch_busy_time_a_call():
    red = {"busy_s": 2.0, "window_s": 4.0}
    out = trace.over_window(red, stretch_calls=10, window_calls=90, window_s=30.0)
    assert out["busy_s"] == 18.0 and out["window_s"] == 30.0
    assert out["stretch"] == {"busy_s": 2.0, "window_s": 4.0, "calls": 10}
    empty = trace.over_window({"busy_s": 0.0, "window_s": 0.0}, 0, 90, 30.0)
    assert empty["busy_s"] == 0.0 and "stretch" not in empty
