"""int8 x int8 -> int32 convolutions, the products of the int8 serving path.

Counterpart of the int8 products in ``object_keypoints_tpu/serving/quantize.py``
(:297-318): ``jax.lax.conv_general_dilated`` and ``jax.lax.conv_transpose``
with ``preferred_element_type=int32``. XLA lowers them outside any Pallas
kernel, so there is no TPU kernel to port here: on the card they run on
cuBLASLt's int8 GEMM on the tensor cores (``torch._int_mm``), over
channels_last activations.

- A 1x1 convolution is one GEMM over the (N*H*W, C) view of the NHWC input
  (a stride-2 one over its strided slice).
- A kxk convolution gathers an int8 im2col from ``as_strided`` views of the
  zero-padded NHWC input: the activations are quantized before the gather,
  so the columns are one byte wide. The columns of a batch are made a chunk
  of frames at a time, each chunk near ``COLUMN_BYTES``.
- The 4x4/s2/p1 ConvTranspose (the hourglass unpool, the port's float
  ``ConvTranspose2d``'s geometry) is four 2x2 sub-pixel convolutions, one for
  each output phase (y % 2, x % 2), each over its own taps of the kernel:
  the zero-inserted input's work without its zeros.

``torch._int_mm`` on CUDA takes M > 16 rows and K, N multiples of 8. Weights
are packed once, at load, as (N, K) matrices with N and K padded to multiples
of 8 by zero rows and columns (the heads' ``conv_out`` has 3 or 4 outputs);
an input with M <= 16 rows, or K short of the packed width, is padded with
zeros per call. Nothing falls back: on a CUDA tensor a wrapper runs the GEMM
or raises. The plain versions (``F.conv2d`` / ``F.conv_transpose2d`` in
float64 on the integer-valued tensors, rounded back to int32; exact, since
every sum stays far below 2^53) run for CPU tensors and in the tests.

The activations' quantize, ``quantize``, runs the hand-written kernel
``csrc/int8_quantize.cu::okt_quantize_int8`` on a CUDA tensor: one read of
the activation in its own dtype, one write of the int8 NHWC codes, the codes
of the plain version bit for bit. The plain version, ``quantize_plain``
(the eager chain), runs for CPU tensors and in the tests.

Spans (``utils.timer``): ``int8.im2col`` over each gather of columns (and
the padding before them), ``int8.mm`` over each GEMM, ``int8.rescale`` over
the ConvTranspose's phase interleave (the rest of that pass is
``serving.quantize.Int8Conv``'s). Counters: ``int8.quantize.kernel``, a
launch of the quantize kernel; ``int8.quantize.relayout``, an input made
channels_last before it.

Layouts: activations NHWC int8 (the memory of a channels_last NCHW tensor),
accumulators NHWC int32; unpacked weights in torch's layouts, (O, I, kH, kW)
and (I, O, kH, kW).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from object_keypoints_tpu_torch.ops import _build
from object_keypoints_tpu_torch.utils import timer

MIN_ROWS = 17  # torch._int_mm on CUDA: M > 16
ALIGN = 8  # ... and K, N multiples of 8
COLUMN_BYTES = 1 << 30  # the im2col of one chunk of frames
# ConvTranspose 4x4/s2/p1: output row 2m + p reads the zero-padded input
# rows m + p and m + p + 1 (padding 1) with the kernel rows TAPS[p]
TAPS = ((3, 1), (2, 0))
# okt_quantize_int8's code for each activation dtype it takes
QUANTIZE_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def quantize_plain(x, inv_scale):
    """The plain version of ``quantize``: the eager chain, a permute and a
    float32 cast, the multiply, ``torch.round``, the clip, the int8 cast."""
    if isinstance(inv_scale, torch.Tensor):
        inv_scale = inv_scale.view(1, 1, 1, -1)
    y = x.permute(0, 2, 3, 1).float() * inv_scale
    return torch.round(y).clamp_(-127, 127).to(torch.int8).contiguous()


def quantize(x, inv_scale):
    """x (N, C, H, W), any float dtype -> int8 codes (N, H, W, C), contiguous:
    ``clip(round(float32(x) * inv_scale), -127, 127)``, rounding half to
    even. ``inv_scale`` is a Python float (per tensor) or a float32 (C,)
    tensor (per input channel). A CPU tensor runs ``quantize_plain``; a CUDA
    tensor (bfloat16, float16 or float32) the kernel ``okt_quantize_int8``,
    counted in ``quantize.launches``, or raises. An input whose memory is
    not NHWC-dense (channels_last) is made so first, counted in the
    counter ``int8.quantize.relayout``."""
    if x.device.type == "cpu":
        return quantize_plain(x, inv_scale)
    if x.device.type != "cuda":
        raise ValueError(f"quantize: no kernel for device {x.device}")
    dtype_code = QUANTIZE_DTYPES.get(x.dtype)
    if dtype_code is None:
        raise TypeError(f"quantize: bfloat16, float16 or float32 activations, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"quantize: an (N, C, H, W) activation, got {tuple(x.shape)}")
    n, c, h, w = x.shape
    inv, inv_value = None, 0.0
    if isinstance(inv_scale, torch.Tensor):
        if (inv_scale.dtype != torch.float32 or inv_scale.numel() != c
                or inv_scale.device != x.device):
            raise ValueError(f"quantize: a float32 ({c},) scale on {x.device}, got "
                             f"{inv_scale.dtype} {tuple(inv_scale.shape)} on {inv_scale.device}")
        inv = inv_scale.contiguous()
    else:
        inv_value = float(inv_scale)  # rounded to float32 by the call, as CUDA's multiply does
    if not x.permute(0, 2, 3, 1).is_contiguous():
        x = x.contiguous(memory_format=torch.channels_last)
        timer.count("int8.quantize.relayout")
    out = torch.empty((n, h, w, c), dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        err = lib.okt_quantize_int8(x.data_ptr(), dtype_code,
                                    None if inv is None else inv.data_ptr(), inv_value,
                                    out.data_ptr(), out.numel(), c,
                                    torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"quantize kernel launch failed: cudaError {err}")
    quantize.launches += 1
    timer.count("int8.quantize.kernel")
    return out


def _round_up(n: int, m: int = ALIGN) -> int:
    return -(-n // m) * m


def _pad_matrix(w2d):
    """(O, K) int8 -> (O8, K8), zero rows and columns to multiples of 8."""
    o, k = w2d.shape
    return F.pad(w2d, (0, _round_up(k) - k, 0, _round_up(o) - o)).contiguous()


def pack_conv2d_weight(wq):
    """(O, I, kH, kW) int8 -> the GEMM's (O8, K8) matrix, columns in
    (ky, kx, i) order, the im2col's."""
    return _pad_matrix(wq.permute(0, 2, 3, 1).reshape(wq.shape[0], -1))


def unpack_conv2d_weight(packed, out_channels: int, in_channels: int, kernel: int):
    """The inverse of ``pack_conv2d_weight``: (O, I, kH, kW) int8."""
    k = kernel * kernel * in_channels
    return packed[:out_channels, :k].reshape(out_channels, kernel, kernel, in_channels).permute(
        0, 3, 1, 2)


def pack_conv_transpose2d_weight(wq):
    """(I, O, 4, 4) int8 -> (4, O8, K8): phase 2 py + px's (O, 4 I) matrix,
    columns in (a, b, i) order, a window tap (a, b) holding kernel tap
    (TAPS[py][a], TAPS[px][b])."""
    i, o = wq.shape[:2]
    if tuple(wq.shape[2:]) != (4, 4):
        raise ValueError(f"int8 conv_transpose: a 4x4 kernel only, got {tuple(wq.shape)}")
    phases = []
    for py in range(2):
        for px in range(2):
            taps = wq[:, :, list(TAPS[py])][:, :, :, list(TAPS[px])]  # (I, O, a, b)
            phases.append(_pad_matrix(taps.permute(1, 2, 3, 0).reshape(o, 4 * i)))
    return torch.stack(phases)


def unpack_conv_transpose2d_weight(packed, out_channels: int, in_channels: int):
    """The inverse of ``pack_conv_transpose2d_weight``: (I, O, 4, 4) int8."""
    wq = packed.new_zeros(in_channels, out_channels, 4, 4)
    for py in range(2):
        for px in range(2):
            taps = packed[2 * py + px, :out_channels, :4 * in_channels]
            taps = taps.reshape(out_channels, 2, 2, in_channels).permute(3, 0, 1, 2)
            for a in range(2):
                for b in range(2):
                    wq[:, :, TAPS[py][a], TAPS[px][b]] = taps[:, :, a, b]
    return wq


def int8_conv2d_plain(xq, wq, stride: int = 1, padding: int = 0):
    """The plain version: xq (N, H, W, I) int8, wq (O, I, kH, kW) int8 ->
    (N, Ho, Wo, O) int32, ``F.conv2d`` in float64, exact."""
    y = F.conv2d(xq.permute(0, 3, 1, 2).double(), wq.double(), stride=stride, padding=padding)
    return torch.round(y).to(torch.int32).permute(0, 2, 3, 1)


def int8_conv_transpose2d_plain(xq, wq, stride: int = 2, padding: int = 1):
    """The plain version: xq (N, H, W, I) int8, wq (I, O, kH, kW) int8 ->
    (N, Ho, Wo, O) int32, ``F.conv_transpose2d`` in float64, exact."""
    y = F.conv_transpose2d(xq.permute(0, 3, 1, 2).double(), wq.double(), stride=stride,
                           padding=padding)
    return torch.round(y).to(torch.int32).permute(0, 2, 3, 1)


def int8_mm(a, packed, out=None):
    """a (M, K) int8 @ packed (N8, K8) int8 transposed -> (M, N8) int32 by
    ``torch._int_mm`` (into ``out``, a contiguous (M, N8) int32, if given),
    its shape rules met by zero padding: columns of ``a`` up to K8, rows up
    to MIN_ROWS."""
    m, k = a.shape
    k8 = packed.shape[1]
    if k > k8:
        raise ValueError(f"int8_mm: {k} columns against a packed width of {k8}")
    with timer.span("int8.mm"):
        if k < k8 or m < MIN_ROWS:
            a = F.pad(a, (0, k8 - k, 0, max(MIN_ROWS - m, 0)))
            y = torch._int_mm(a, packed.t())[:m]
            return y if out is None else out.copy_(y)
        if out is None:
            return torch._int_mm(a, packed.t())
        return torch._int_mm(a, packed.t(), out=out)


def _windows(xp, oy: int, ox: int, kernel: int, stride: int, ho: int, wo: int, n: int):
    """The (n * ho * wo, kernel^2 * C) im2col of the padded NHWC xp's first
    n frames, windows starting at (oy + stride * y, ox + stride * x): a copy
    gathered from one ``as_strided`` view (a view, where that is already a
    matrix: the 1x1 stride-1 case). Where C is a multiple of 8 the gather
    moves 8 channels as one int64, 8x fewer elements for the copy."""
    c = xp.shape[3]
    word = 8 if c % 8 == 0 else 1
    if word > 1:
        xp = xp.view(torch.int64)
    sn, sh, sw, sc = xp.stride()
    view = xp.as_strided((n, ho, wo, kernel, kernel, c // word),
                         (sn, sh * stride, sw * stride, sh, sw, sc),
                         xp.storage_offset() + oy * sh + ox * sw)
    return view.reshape(n * ho * wo, kernel * kernel * c // word).view(torch.int8)


def _chunk(frames: int, rows_per_frame: int, k: int) -> int:
    """Frames a chunk so that its columns stay near COLUMN_BYTES."""
    return max(1, min(frames, COLUMN_BYTES // max(rows_per_frame * k, 1)))


def _output_size(size: int, kernel: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - kernel) // stride + 1


def im2col_chunks(xq, kernel: int, stride: int = 1, padding: int = 0):
    """The int8 im2col of a kxk convolution over xq (N, H, W, C), a chunk of
    frames at a time: yields (first output row, (rows, k * k * C) columns)."""
    n, h, w, c = xq.shape
    ho, wo = (_output_size(s, kernel, stride, padding) for s in (h, w))
    with timer.span("int8.im2col"):
        xq = xq.contiguous()
        xp = F.pad(xq, (0, 0, padding, padding, padding, padding)) if padding else xq
    step = _chunk(n, ho * wo, kernel * kernel * c)
    for i in range(0, n, step):
        b = min(step, n - i)
        with timer.span("int8.im2col"):
            cols = _windows(xp[i:i + b], 0, 0, kernel, stride, ho, wo, b)
        yield i * ho * wo, cols


def conv_transpose_im2col_chunks(xq):
    """The int8 im2col of the 4x4/s2/p1 ConvTranspose over xq (N, H, W, C):
    yields (output phase 2 py + px, first row, (rows, 4 C) columns of the 2x2
    windows of the input padded by 1)."""
    n, h, w, c = xq.shape
    with timer.span("int8.im2col"):
        xp = F.pad(xq.contiguous(), (0, 0, 1, 1, 1, 1))
    step = _chunk(n, h * w, 4 * c)
    for py in range(2):
        for px in range(2):
            for i in range(0, n, step):
                b = min(step, n - i)
                with timer.span("int8.im2col"):
                    cols = _windows(xp[i:i + b], py, px, 2, 1, h, w, b)
                yield 2 * py + px, i * h * w, cols


def int8_conv2d_gemm(xq, packed, out_channels: int, kernel: int, stride: int = 1,
                     padding: int = 0):
    """The GEMM route: xq (N, H, W, I) int8 -> (N, Ho, Wo, O) int32 through
    ``int8_mm`` over an int8 im2col (none for a 1x1, stride 1)."""
    n, h, w, _ = xq.shape
    ho, wo = (_output_size(s, kernel, stride, padding) for s in (h, w))
    n8 = packed.shape[0]
    acc = torch.empty(n * ho * wo, n8, dtype=torch.int32, device=xq.device)
    for row, cols in im2col_chunks(xq, kernel, stride, padding):
        int8_mm(cols, packed, out=acc[row:row + cols.shape[0]])
    return acc.view(n, ho, wo, n8)[..., :out_channels]


def int8_conv_transpose2d_gemm(xq, packed, out_channels: int):
    """The GEMM route of the 4x4/s2/p1 ConvTranspose: xq (N, H, W, I) int8
    -> (N, 2H, 2W, O) int32, one ``int8_mm`` for each output phase over the
    2x2 windows of the input padded by 1, then the phases interleaved."""
    n, h, w, _ = xq.shape
    n8 = packed.shape[1]
    acc = torch.empty(4, n * h * w, n8, dtype=torch.int32, device=xq.device)
    for phase, row, cols in conv_transpose_im2col_chunks(xq):
        int8_mm(cols, packed[phase], out=acc[phase, row:row + cols.shape[0]])
    with timer.span("int8.rescale"):
        acc = acc.view(2, 2, n, h, w, n8).permute(2, 3, 0, 4, 1, 5).reshape(n, 2 * h, 2 * w, n8)
    return acc[..., :out_channels]


def _check(name, xq, packed):
    if xq.dtype != torch.int8 or packed.dtype != torch.int8 or xq.dim() != 4:
        raise TypeError(f"{name}: int8 (N, H, W, C) activations and packed int8 weights, got "
                        f"{xq.dtype} {tuple(xq.shape)} and {packed.dtype}")
    if packed.device != xq.device:
        raise ValueError(f"{name}: weights on {packed.device}, activations on {xq.device}")


def int8_conv2d(xq, packed, out_channels: int, kernel: int, stride: int = 1, padding: int = 0):
    """xq (N, H, W, I) int8, ``packed`` from ``pack_conv2d_weight`` ->
    (N, Ho, Wo, O) int32. A CPU tensor runs the plain version; a CUDA tensor
    the GEMM route (counted in ``int8_conv2d.launches``) or raises."""
    _check("int8_conv2d", xq, packed)
    if xq.device.type == "cpu":
        wq = unpack_conv2d_weight(packed, out_channels, xq.shape[3], kernel)
        return int8_conv2d_plain(xq, wq, stride, padding)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_conv2d: no GEMM route for device {xq.device}")
    out = int8_conv2d_gemm(xq, packed, out_channels, kernel, stride, padding)
    int8_conv2d.launches += 1
    return out


def int8_conv_transpose2d(xq, packed, out_channels: int):
    """xq (N, H, W, I) int8, ``packed`` from ``pack_conv_transpose2d_weight``
    -> (N, 2H, 2W, O) int32, as ``int8_conv2d``; counted in
    ``int8_conv_transpose2d.launches``."""
    _check("int8_conv_transpose2d", xq, packed)
    if xq.device.type == "cpu":
        wq = unpack_conv_transpose2d_weight(packed, out_channels, xq.shape[3])
        return int8_conv_transpose2d_plain(xq, wq)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_conv_transpose2d: no GEMM route for device {xq.device}")
    out = int8_conv_transpose2d_gemm(xq, packed, out_channels)
    int8_conv_transpose2d.launches += 1
    return out


# convolutions run on the GEMM route, quantize kernels launched (CUDA tensors)
quantize.launches = 0
int8_conv2d.launches = 0
int8_conv_transpose2d.launches = 0
