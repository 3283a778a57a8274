// KeypointNet stem convolution for Hopper (sm_90a), plain C interface.
//
// Computes relu(conv7x7/s2/pad3(x, w) * scale + bias) for a 3-channel frame,
// with the BatchNorm of the stem folded into (scale, bias). It is the first
// layer of the eval-mode serve forward (the `pre.0` ConvBlock).
//
// Replaces the TPU kernel object_keypoints_tpu/ops/pallas/stem_conv.py
// (`fused_stem_conv`, pl.pallas_call at line 127, body `_stem_kernel`). The
// TPU form padded the frame to an even size, applied space-to-depth by 2 and
// ran 4 MXU matmuls of K = 48 per 16-row strip. Here the frame is read
// directly: pixels outside the frame read as zero, so an odd 511 frame needs
// no pad-to-512 copy.
//
// Layouts: x is NCHW (N, 3, H, W), contiguous; w is (3*7*7, c_out) fp32 with
// the tap index (ci, ky, kx) row-major; scale and bias are (c_out,) fp32; out
// is NHWC (N, Ho, Wo, c_out), i.e. an (N, c_out, Ho, Wo) tensor in
// channels_last memory format, which is the layout the rest of the port's
// forward runs in. Ho = (H - 1) / 2 + 1. x and out are fp32 or bf16 (the same
// type); the sums are fp32.
//
// What bounds it on the H100: 2.47 GFLOP per 511x511 frame (256*256*128
// outputs * 147 taps * 2) against 18.4 MB of traffic per frame in bf16
// (1.6 MB frame in, 16.8 MB out), about 134 FLOP/B, below the card's ~295
// FLOP/B bf16 ridge. Memory alone would allow ~5.5 us per frame; on the CUDA
// cores (67 TFLOP/s fp32) the arithmetic needs ~37 us, so this kernel is
// compute-bound about 7x above the memory floor.
//
// Design: a persistent grid (two blocks per SM) walks 8x16-pixel output
// tiles. Each block keeps the whole 147 x c_out weight matrix in dynamic
// shared memory (75 KB at c_out 128) for its lifetime, and stages one
// 21x37x3 input patch per tile. Warp r owns output row r of the tile; lane l
// owns output channels 4l..4l+3 and holds 16 pixels x 4 channels of fp32
// accumulators, so each 16-byte weight load feeds 64 FMAs and each patch
// value is a shared-memory broadcast. NHWC stores are 16 B (fp32) or 8 B
// (bf16) per lane and contiguous across the warp.
//
// The route past the CUDA-core bound is the TPU kernel's own regrouping:
// space-to-depth turns the strided 7x7 into 16 unit-stride taps over 12
// channels, a K = 192 GEMM per pixel that `wgmma` can run on the tensor
// cores. That is left for a later change; this kernel is the simple,
// correct baseline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSize = 7;
constexpr int kCin = 3;
constexpr int kTaps = kCin * kSize * kSize;  // 147
constexpr int kTileH = 8;                    // output rows per tile, one warp each
constexpr int kTileW = 16;                   // output columns per tile, per lane
constexpr int kPatchH = 2 * kTileH + 5;      // 21 input rows
constexpr int kPatchW = 2 * kTileW + 5;      // 37 input columns
constexpr int kThreads = 32 * kTileH;
constexpr int kMaxCout = 128;                // 4 channels per lane, one warp wide

__device__ __forceinline__ float load_float(const float* p) { return *p; }
__device__ __forceinline__ float load_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store4(float* dst, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float a, float b, float c,
                                       float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    stem_conv_kernel(const T* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     T* __restrict__ out, int n, int h, int wd, int ho, int wo,
                     int c_out) {
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);  // [kTaps][c_out]
  float* s_x = s_w + kTaps * c_out;              // [kCin][kPatchH][kPatchW]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row = tid >> 5;
  const bool active = lane < c_out / 4;
  const int c0 = 4 * lane;

  for (int i = tid; i < kTaps * c_out; i += kThreads) s_w[i] = w[i];
  float sc[4] = {0.f, 0.f, 0.f, 0.f};
  float bi[4] = {0.f, 0.f, 0.f, 0.f};
  if (active) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sc[j] = scale[c0 + j];
      bi[j] = bias[c0 + j];
    }
  }

  const int tiles_x = (wo + kTileW - 1) / kTileW;
  const int tiles_y = (ho + kTileH - 1) / kTileH;
  const long long total = (long long)n * tiles_y * tiles_x;

  for (long long tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const int tx = (int)(tile % tiles_x);
    const int ty = (int)((tile / tiles_x) % tiles_y);
    const int b = (int)(tile / ((long long)tiles_x * tiles_y));
    const int oy0 = ty * kTileH;
    const int ox0 = tx * kTileW;
    const int iy0 = 2 * oy0 - 3;
    const int ix0 = 2 * ox0 - 3;
    const T* xb = x + (long long)b * kCin * h * wd;

    __syncthreads();  // the previous tile is done with s_x
    for (int i = tid; i < kCin * kPatchH * kPatchW; i += kThreads) {
      const int c = i / (kPatchH * kPatchW);
      const int r = (i / kPatchW) % kPatchH;
      const int col = i % kPatchW;
      const int iy = iy0 + r;
      const int ix = ix0 + col;
      float v = 0.f;
      if (iy >= 0 && iy < h && ix >= 0 && ix < wd)
        v = load_float(xb + ((long long)c * h + iy) * wd + ix);
      s_x[i] = v;
    }
    __syncthreads();  // s_x (and, on the first tile, s_w) is complete
    if (!active) continue;

    float acc[kTileW][4];
#pragma unroll
    for (int p = 0; p < kTileW; ++p)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[p][j] = 0.f;

    for (int c = 0; c < kCin; ++c) {
      for (int ky = 0; ky < kSize; ++ky) {
        const float* xrow = s_x + (c * kPatchH + 2 * row + ky) * kPatchW;
        const float* wrow = s_w + ((c * kSize + ky) * kSize) * c_out + c0;
#pragma unroll
        for (int kx = 0; kx < kSize; ++kx) {
          const float4 wv = *reinterpret_cast<const float4*>(wrow + kx * c_out);
#pragma unroll
          for (int p = 0; p < kTileW; ++p) {
            const float xv = xrow[2 * p + kx];
            acc[p][0] = fmaf(xv, wv.x, acc[p][0]);
            acc[p][1] = fmaf(xv, wv.y, acc[p][1]);
            acc[p][2] = fmaf(xv, wv.z, acc[p][2]);
            acc[p][3] = fmaf(xv, wv.w, acc[p][3]);
          }
        }
      }
    }

    const int oy = oy0 + row;
    if (oy >= ho) continue;
    T* orow = out + (((long long)b * ho + oy) * wo + ox0) * c_out + c0;
#pragma unroll
    for (int p = 0; p < kTileW; ++p) {
      if (ox0 + p < wo) {
        store4(orow + (long long)p * c_out,
               fmaxf(fmaf(acc[p][0], sc[0], bi[0]), 0.f),
               fmaxf(fmaf(acc[p][1], sc[1], bi[1]), 0.f),
               fmaxf(fmaf(acc[p][2], sc[2], bi[2]), 0.f),
               fmaxf(fmaf(acc[p][3], sc[3], bi[3]), 0.f));
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* w, const float* scale, const float* bias,
                   void* out, int n, int h, int wd, int c_out, cudaStream_t stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || c_out <= 0 || c_out % 4 != 0 || c_out > kMaxCout)
    return cudaErrorInvalidValue;
  const int ho = (h - 1) / 2 + 1;
  const int wo = (wd - 1) / 2 + 1;
  const size_t smem = sizeof(float) * ((size_t)kTaps * c_out + kCin * kPatchH * kPatchW);
  cudaError_t err = cudaFuncSetAttribute(
      stem_conv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;

  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem_conv_kernel<T>,
                                                           kThreads, smem)) != cudaSuccess)
    return err;
  const long long tiles = (long long)n * ((ho + kTileH - 1) / kTileH) *
                          ((wo + kTileW - 1) / kTileW);
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > tiles) grid = tiles;

  stem_conv_kernel<T><<<(unsigned)grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), w, scale, bias, static_cast<T*>(out), n, h, wd, ho, wo,
      c_out);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out). Returns a cudaError_t.
extern "C" int okt_stem_conv(const void* x, const void* w, const void* scale,
                             const void* bias, void* out, int n, int h, int wd, int c_out,
                             int dtype, void* stream) {
  const float* wf = static_cast<const float*>(w);
  const float* sf = static_cast<const float*>(scale);
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, wf, sf, bf, out, n, h, wd, c_out, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, wf, sf, bf, out, n, h, wd, c_out, s);
  return (int)cudaErrorInvalidValue;
}
