// The int8 route's input quantize for Hopper (sm_90a), plain C interface.
//
// Computes out = int8(clip(rint(float32(x) * inv), -127, 127)), rounding half
// to even, for the NHWC memory of a channels_last (N, C, H, W) activation:
// the codes that every int8 convolution of the serve path takes
// (ops/int8_conv.quantize). inv is one float32 for the tensor, or a float32
// (C,) vector indexed by the channel, flat index % C.
//
// Replaces no Pallas kernel: the JAX package's quantize
// (object_keypoints_tpu/serving/quantize.py) is elementwise code that XLA
// fuses. On the card the same arithmetic in eager PyTorch was five passes
// over float32 intermediates (permute-cast, multiply, round, clamp, int8
// cast), about 35 bytes moved for each element.
//
// What bounds it on the H100: bytes. Each element is read once in its own
// dtype and written once as one int8 byte, 3 B for a bf16 element; the 30
// quantized inputs of a 96-frame serve call hold 4.50e9 elements, 13.5 GB,
// 4.03 ms at 3.35 TB/s. The arithmetic is a few instructions an element.
//
// The design moves each byte once. Where C % 8 == 0 (every input of the
// serve path: 32 to 256 channels) and x is 16-byte aligned, a thread takes 8
// elements at a time: one 16-byte load of bf16 or fp16, two of fp32, and one
// 8-byte store of the codes; neighbouring threads read neighbouring 16-byte
// words. A grid-stride loop over blocks sized to fill every SM keeps
// kUnroll independent loads of each thread in flight before any of them is
// used. The 8 elements of a load share a channel group (C % 8 == 0), so a
// per-channel scale is two 16-byte __ldg loads from a vector that stays in
// L1. Any other C, or an unaligned x, takes the scalar kernel: one element a
// thread and step.
//
// Exactness: float32(x) is exact for bf16 and fp16; the product is one
// IEEE float32 multiply (no contraction: there is no add); rintf rounds half
// to even as torch.round does; the clip leaves NaN as NaN, which converts to
// 0 as PyTorch's float-to-int8 cast does on the card. A per-tensor inv comes
// in already rounded to float32, as PyTorch's CUDA multiply rounds a Python
// scalar, so the codes equal the eager chain's bit for bit.
//
// The kernels launch on the caller's stream, allocate nothing and do not
// synchronise; each entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // 8-element vectors a thread has in flight

__device__ __forceinline__ int code(float v, float inv) {
  float r = rintf(__fmul_rn(v, inv));
  r = r < -127.f ? -127.f : r;  // comparisons leave NaN as it is
  r = r > 127.f ? 127.f : r;
  return __float2int_rn(r);
}

// 8 elements of one 16-byte-aligned vector, as float32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const __half* p, float (&v)[8]) {
  const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(p));
  const __half2* h = reinterpret_cast<const __half2*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) | ((uint32_t)(c & 0xff) << 16) |
         ((uint32_t)(d & 0xff) << 24);
}

// nvec 8-element vectors; groups = C / 8 channel groups. inv is the (C,)
// vector where kPerChannel, else the scalar inv_scalar.
template <typename T, bool kPerChannel>
__global__ void __launch_bounds__(kThreads) quantize_vec_kernel(
    const T* __restrict__ x, const float* __restrict__ inv, float inv_scalar,
    int8_t* __restrict__ out, long long nvec, long long groups) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long base = (long long)blockIdx.x * kThreads + threadIdx.x; base < nvec;
       base += stride * kUnroll) {
    float v[kUnroll][8];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      if (i < nvec) load8(x + 8 * i, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      if (i >= nvec) break;
      float s[8];
      if constexpr (kPerChannel) {
        const float4* p = reinterpret_cast<const float4*>(inv + 8 * (i % groups));
        const float4 a = __ldg(p), b = __ldg(p + 1);
        s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
        s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) s[k] = inv_scalar;
      }
      int q[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) q[k] = code(v[u][k], s[k]);
      const uint2 packed = make_uint2(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]));
      *reinterpret_cast<uint2*>(out + 8 * i) = packed;
    }
  }
}

template <typename T, bool kPerChannel>
__global__ void __launch_bounds__(kThreads) quantize_scalar_kernel(
    const T* __restrict__ x, const float* __restrict__ inv, float inv_scalar,
    int8_t* __restrict__ out, long long total, long long channels) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < total; i += stride) {
    const float s = kPerChannel ? __ldg(inv + i % channels) : inv_scalar;
    out[i] = (int8_t)code(to_float(x[i]), s);
  }
}

// Blocks to keep every SM full: the occupancy of `kernel` times the SMs,
// and no more than `work` (> 0) threads' worth.
cudaError_t grid_for(const void* kernel, long long work, int* grid) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long full = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long need = (work + kThreads - 1) / kThreads;
  *grid = (int)(need < full ? need : full);
  return cudaSuccess;
}

template <typename T, bool kPerChannel>
cudaError_t launch(const void* x, const float* inv, float inv_scalar, void* out, long long total,
                   long long channels, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  int8_t* o = static_cast<int8_t*>(out);
  const bool vector = channels % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 8 == 0 &&
                      (!kPerChannel || reinterpret_cast<uintptr_t>(inv) % 16 == 0);
  int grid = 0;
  cudaError_t err;
  if (vector) {
    const long long nvec = total / 8;
    const void* kernel = (const void*)quantize_vec_kernel<T, kPerChannel>;
    if ((err = grid_for(kernel, (nvec + kUnroll - 1) / kUnroll, &grid)) != cudaSuccess) return err;
    quantize_vec_kernel<T, kPerChannel><<<grid, kThreads, 0, stream>>>(xt, inv, inv_scalar, o, nvec,
                                                                        channels / 8);
  } else {
    const void* kernel = (const void*)quantize_scalar_kernel<T, kPerChannel>;
    if ((err = grid_for(kernel, total, &grid)) != cudaSuccess) return err;
    quantize_scalar_kernel<T, kPerChannel><<<grid, kThreads, 0, stream>>>(xt, inv, inv_scalar, o,
                                                                          total, channels);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* inv, float inv_scalar, void* out, long long total,
                     long long channels, cudaStream_t stream) {
  if (total <= 0 || channels <= 0 || total % channels != 0) return cudaErrorInvalidValue;
  if (inv != nullptr)
    return launch<T, true>(x, static_cast<const float*>(inv), 0.f, out, total, channels, stream);
  return launch<T, false>(x, nullptr, inv_scalar, out, total, channels, stream);
}

}  // namespace

// x: the NHWC memory of `total` elements, C = `channels` innermost, in the
// dtype `dtype` names (0 bf16, 1 fp16, 2 fp32); out: `total` int8 codes in
// the same order. inv: a float32 (C,) vector on the card, or null for the
// per-tensor inv_scalar. Returns a cudaError_t.
extern "C" int okt_quantize_int8(const void* x, int dtype, const void* inv, float inv_scalar,
                                 void* out, long long total, long long channels, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch<__nv_bfloat16>(x, inv, inv_scalar, out, total, channels, s);
    case 1: return (int)dispatch<__half>(x, inv, inv_scalar, out, total, channels, s);
    case 2: return (int)dispatch<float>(x, inv, inv_scalar, out, total, channels, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
