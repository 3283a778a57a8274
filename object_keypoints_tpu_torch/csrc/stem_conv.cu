// KeypointNet stem convolution for Hopper (sm_90a), plain C interface.
//
// Computes relu(conv7x7/s2/pad3(x, w) * scale + bias) for a 3-channel frame,
// with the BatchNorm of the stem folded into (scale, bias). It is the first
// layer of the eval-mode serve forward (the `pre.0` ConvBlock).
//
// Replaces the TPU kernel object_keypoints_tpu/ops/pallas/stem_conv.py
// (`fused_stem_conv`, pl.pallas_call at line 127, body `_stem_kernel`). The
// TPU form padded the frame to an even size, applied space-to-depth by 2 and
// ran 4 MXU matmuls of K = 48 per 16-row strip. Both kernels here read the
// frame directly: pixels outside the frame read as zero, so an odd 511 frame
// needs no pad-to-512 copy.
//
// Layouts: x is NCHW (N, 3, H, W), contiguous; scale and bias are (c_out,)
// fp32; out is NHWC (N, Ho, Wo, c_out), i.e. an (N, c_out, Ho, Wo) tensor in
// channels_last memory format, which is the layout the rest of the port's
// forward runs in. Ho = (H - 1) / 2 + 1. The sums are fp32 in both kernels.
//
// Two kernels:
//
// okt_stem_conv_bf16 -- bf16 frames, the serve path. A tensor-core implicit
// GEMM over the TPU kernel's space-to-depth form. Let s2d cell (i, j) hold
// the 12 frame values (2i+p, 2j+q, c), ordered (p, q, c). Then
//   out(y, x) = sum over u, v in -2..1 of s2d(y+u, x+v) . T[u, v],
// one [1 x 192] . [192 x c_out] product per pixel (45 of the 192 tap rows are
// zero: dy or dx would be -1). taps is that (192, 128) bf16 matrix, row
// (u+2)*48 + (v+2)*12 + (2p+q)*3 + c, columns past c_out zero; the wrapper
// builds it (ops/stem_conv.stem_taps) with the taps rounded to bf16, as the
// TPU path rounds them to the frames' dtype.
//   What bounds it on the H100: per 511x511 frame, 1.57 MB of frame in and
// 16.8 MB of bf16 NHWC out, against 2.47 GFLOP (3.22 GFLOP as the K = 192
// GEMM). 96 frames move 1.76 GB, 0.53 ms at 3.35 TB/s, while the GEMM needs
// 0.31 ms at the 989 TFLOP/s bf16 peak: the output write is the bound.
//   Design: a persistent grid, two blocks of 4 warps on each SM. Each block
// keeps the whole tap matrix in shared memory for its lifetime (48 KB, laid
// out in mma fragment order, one 16-byte load per lane for two n-tiles) and
// walks 2 x 64-pixel output tiles. It stages a tile's 5 x 67 s2d cells as
// (row, cell, p, q, c) bf16, so that for a row shift u the 48 K-values of
// taps v = -2..1 are contiguous for every output pixel: K = 192 is 4 slabs
// of 48, 12 k-steps of mma.sync m16n8k16. Each warp owns one output row of
// 64 pixels x 64 channels (128 fp32 accumulators a lane), so each A
// fragment feeds 8 MMAs and each B fragment 4. An m-tile's rows are its 16
// pixels even ones first, which makes the 32-bit A loads at a 24-byte pixel
// stride free of bank conflicts. The epilogue applies scale, bias and ReLU
// and rounds to bf16 into the warp's own shared tile (16-byte chunks
// XOR-swizzled by pixel); the warp then writes its 128-byte halves of 64
// NHWC pixels, whole cache lines, with 16-byte coalesced stores, while the
// next tile's frame values, loaded into registers just before, are in
// flight. The output stream then overlaps the other block's MMAs. Measured
// on the card (PERF.md), the MMA phase runs near 8 clocks per m16n8k16 per
// SM sub-partition and the frame staging's load latency is only partly
// hidden; tensor-memory-accelerator loads and warpgroup MMAs are the next
// step.
//
// okt_stem_conv_fp32 -- fp32 frames, on the CUDA cores (the tensor cores have
// no fp32 product, and TF32 would not hold fp32 to 1e-4). w is (3*7*7,
// c_out) fp32 with the tap index (ci, ky, kx) row-major. 2.47 GFLOP per
// frame at 67 TFLOP/s fp32 is ~37 us, 7x above its memory floor. A
// persistent grid walks 8x16-pixel output tiles; each block keeps the
// 147 x c_out weights in shared memory and stages one 21x37x3 input patch
// per tile. Warp r owns output row r; lane l owns channels 4l..4l+3 and 16
// pixels x 4 channels of accumulators, so each 16-byte weight load feeds 64
// FMAs. NHWC stores are 16 B per lane, contiguous across the warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSize = 7;
constexpr int kCin = 3;
constexpr int kMaxCout = 128;

// Grid of a persistent kernel: as many blocks as fit on the card at once,
// and no more than there are tiles.
cudaError_t persistent_grid(const void* kernel, int threads, size_t smem, long long tiles,
                            long long* grid) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return err;
  *grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (*grid > tiles) *grid = tiles;
  return cudaSuccess;
}

// ---------------------------------------------------------------- fp32 ----

constexpr int kTaps = kCin * kSize * kSize;  // 147
constexpr int kTileH = 8;                    // output rows per tile, one warp each
constexpr int kTileW = 16;                   // output columns per tile, per lane
constexpr int kPatchH = 2 * kTileH + 5;      // 21 input rows
constexpr int kPatchW = 2 * kTileW + 5;      // 37 input columns
constexpr int kThreads = 32 * kTileH;

__global__ void __launch_bounds__(kThreads, 2)
    stem_conv_fp32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ scale, const float* __restrict__ bias,
                          float* __restrict__ out, int n, int h, int wd, int ho, int wo,
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
    const float* xb = x + (long long)b * kCin * h * wd;

    __syncthreads();  // the previous tile is done with s_x
    for (int i = tid; i < kCin * kPatchH * kPatchW; i += kThreads) {
      const int c = i / (kPatchH * kPatchW);
      const int r = (i / kPatchW) % kPatchH;
      const int col = i % kPatchW;
      const int iy = iy0 + r;
      const int ix = ix0 + col;
      float v = 0.f;
      if (iy >= 0 && iy < h && ix >= 0 && ix < wd) v = xb[((long long)c * h + iy) * wd + ix];
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
    float* orow = out + (((long long)b * ho + oy) * wo + ox0) * c_out + c0;
#pragma unroll
    for (int p = 0; p < kTileW; ++p) {
      if (ox0 + p < wo) {
        *reinterpret_cast<float4*>(orow + (long long)p * c_out) =
            make_float4(fmaxf(fmaf(acc[p][0], sc[0], bi[0]), 0.f),
                        fmaxf(fmaf(acc[p][1], sc[1], bi[1]), 0.f),
                        fmaxf(fmaf(acc[p][2], sc[2], bi[2]), 0.f),
                        fmaxf(fmaf(acc[p][3], sc[3], bi[3]), 0.f));
      }
    }
  }
}

cudaError_t launch_fp32(const float* x, const float* w, const float* scale, const float* bias,
                        float* out, int n, int h, int wd, int c_out, cudaStream_t stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || c_out <= 0 || c_out % 4 != 0 || c_out > kMaxCout)
    return cudaErrorInvalidValue;
  const int ho = (h - 1) / 2 + 1;
  const int wo = (wd - 1) / 2 + 1;
  const size_t smem = sizeof(float) * ((size_t)kTaps * c_out + kCin * kPatchH * kPatchW);
  const long long tiles =
      (long long)n * ((ho + kTileH - 1) / kTileH) * ((wo + kTileW - 1) / kTileW);
  long long grid = 0;
  cudaError_t err =
      persistent_grid((const void*)stem_conv_fp32_kernel, kThreads, smem, tiles, &grid);
  if (err != cudaSuccess) return err;
  stem_conv_fp32_kernel<<<(unsigned)grid, kThreads, smem, stream>>>(x, w, scale, bias, out, n,
                                                                    h, wd, ho, wo, c_out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16 ----

constexpr int kTcRows = 2;                       // output rows per tile
constexpr int kTcCols = 64;                      // output columns per tile
constexpr int kTcThreads = 64 * kTcRows;         // a warp per (row, 64 channels)
constexpr int kCell = 4 * kCin;                  // 12 bf16 per s2d cell, (p, q, c)
constexpr int kInRows = kTcRows + 3;             // s2d rows y0-2 .. y0+kTcRows
constexpr int kInCells = kTcCols + 3;            // s2d cells x0-2 .. x0+kTcCols
constexpr int kInRowElems = kInCells * kCell;    // 804 bf16 = 1608 B
constexpr int kInRowWords = kInRowElems / 2;     // 402
constexpr int kFrameCols = 2 * kInCells;         // 134 frame columns staged
constexpr int kLines = kInRows * 2 * kCin;       // (s2d row, p, c) frame lines staged
constexpr int kColsPerThread = (kFrameCols + kTcThreads - 1) / kTcThreads;
constexpr int kK = 16 * kCell;                   // 4 x 4 taps x 12 = 192
constexpr int kKSteps = kK / 16;                 // 12 mma k-steps
constexpr int kWarpChunks = 64 * 8;              // a warp's 64 px x 8 16-byte chunks
constexpr size_t kTcSmemB = sizeof(uint4) * kKSteps * (kMaxCout / 16) * 32;  // 48 KB
constexpr size_t kTcSmemOut = sizeof(uint4) * (kTcThreads / 32) * kWarpChunks;
constexpr size_t kTcSmemAffine = sizeof(float) * 2 * kMaxCout;
constexpr size_t kTcSmemIn = (sizeof(__nv_bfloat16) * kInRows * kInRowElems + 15) / 16 * 16;
constexpr size_t kTcSmem = kTcSmemB + kTcSmemOut + kTcSmemAffine + kTcSmemIn;

static_assert(kInRowElems % 2 == 0, "s2d rows hold whole 32-bit words");

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t relu_affine_bf16x2(float a, float b, float2 sc, float2 bi) {
  __nv_bfloat162 v =
      __floats2bfloat162_rn(fmaxf(fmaf(a, sc.x, bi.x), 0.f), fmaxf(fmaf(b, sc.y, bi.y), 0.f));
  return *reinterpret_cast<uint32_t*>(&v);
}

struct TileOrigin {
  int b, oy0, ox0;
};

__device__ __forceinline__ TileOrigin tile_origin(long long tile, int tiles_x, int tiles_y) {
  return {(int)(tile / ((long long)tiles_x * tiles_y)),
          (int)((tile / tiles_x) % tiles_y) * kTcRows, (int)(tile % tiles_x) * kTcCols};
}

// The frame values of a tile's s2d rows oy0-2 .. oy0+kTcRows and cells
// ox0-2 .. ox0+kTcCols: thread tid reads frame columns 2(ox0-2) + tid + k *
// kTcThreads for every (row, p, c) line, coalesced along the frame row, zero
// outside the frame.
__device__ __forceinline__ void load_tile_input(const __nv_bfloat16* __restrict__ x,
                                                TileOrigin o, int h, int wd,
                                                __nv_bfloat16 (&v)[kColsPerThread][kLines]) {
  const long long plane = (long long)h * wd;
  const __nv_bfloat16* xb = x + (long long)o.b * kCin * plane;
#pragma unroll
  for (int k = 0; k < kColsPerThread; ++k) {
    const int fc = threadIdx.x + k * kTcThreads;
    const int gc = 2 * (o.ox0 - 2) + fc;
    const bool col_in = fc < kFrameCols && gc >= 0 && gc < wd;
#pragma unroll
    for (int line = 0; line < kLines; ++line) {
      const int r = line / (2 * kCin), p = (line / kCin) & 1, c = line % kCin;
      const int gr = 2 * (o.oy0 - 2 + r) + p;
      v[k][line] = col_in && gr >= 0 && gr < h ? xb[c * plane + (long long)gr * wd + gc]
                                               : __float2bfloat16(0.f);
    }
  }
}

// ... stored as (s2d row, cell, p, q, c).
__device__ __forceinline__ void store_tile_input(__nv_bfloat16* s_in,
                                                 const __nv_bfloat16 (&v)[kColsPerThread][kLines]) {
#pragma unroll
  for (int k = 0; k < kColsPerThread; ++k) {
    const int fc = threadIdx.x + k * kTcThreads;
    if (fc >= kFrameCols) break;
    __nv_bfloat16* dst = s_in + (fc >> 1) * kCell + (fc & 1) * kCin;
#pragma unroll
    for (int line = 0; line < kLines; ++line) {
      const int r = line / (2 * kCin), p = (line / kCin) & 1, c = line % kCin;
      dst[r * kInRowElems + p * 2 * kCin + c] = v[k][line];
    }
  }
}

__global__ void __launch_bounds__(kTcThreads, 1)
    stem_conv_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                          const uint16_t* __restrict__ taps,  // (192, 128) bf16 bits
                          const float* __restrict__ scale, const float* __restrict__ bias,
                          __nv_bfloat16* __restrict__ out, int n, int h, int wd, int ho, int wo,
                          int c_out) {
  extern __shared__ uint4 smem[];
  uint4* s_b = smem;                            // [k-step][n-tile pair][lane], fragment order
  uint4* s_out = s_b + kKSteps * (kMaxCout / 16) * 32;  // [warp][pixel][chunk ^ swizzle]
  float* s_scale = reinterpret_cast<float*>(s_out + (kTcThreads / 32) * kWarpChunks);
  float* s_bias = s_scale + kMaxCout;
  __nv_bfloat16* s_in = reinterpret_cast<__nv_bfloat16*>(s_bias + kMaxCout);  // [row][cell][12]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // mma groupID
  const int t = lane & 3;   // mma thread in group
  const int wr = warp >> 1;   // the warp's output row in the tile
  const int half = warp & 1;  // the warp's 64 output channels

  const int tiles_x = (wo + kTcCols - 1) / kTcCols;
  const int tiles_y = (ho + kTcRows - 1) / kTcRows;
  const long long total = (long long)n * tiles_y * tiles_x;

  __nv_bfloat16 staged[kColsPerThread][kLines];
  load_tile_input(x, tile_origin(blockIdx.x, tiles_x, tiles_y), h, wd, staged);

  // B fragments: word j of lane l's uint4 at (k-step s, pair) is register
  // j & 1 of n-tile 2 * pair + (j >> 1): rows k, k + 1 of column n, with
  // k = 16 s + 2 (l & 3) + 8 (j & 1) and n = 8 n-tile + (l >> 2).
  for (int i = tid; i < kKSteps * (kMaxCout / 16) * 32 * 4; i += kTcThreads) {
    const int j = i & 3;
    const int l = (i >> 2) & 31;
    const int pair = (i >> 7) & 7;
    const int s = i >> 10;
    const int k = 16 * s + 2 * (l & 3) + 8 * (j & 1);
    const int col = 8 * (2 * pair + (j >> 1)) + (l >> 2);
    reinterpret_cast<uint32_t*>(s_b)[i] =
        (uint32_t)taps[k * kMaxCout + col] | ((uint32_t)taps[(k + 1) * kMaxCout + col] << 16);
  }
  for (int i = tid; i < kMaxCout; i += kTcThreads) {
    s_scale[i] = i < c_out ? scale[i] : 0.f;
    s_bias[i] = i < c_out ? bias[i] : 0.f;
  }
  store_tile_input(s_in, staged);

  // A fragment of m-tile i at k-step s, as 32-bit words of s_in: rows g and
  // g + 8 are pixels 16 i + 2 g and 16 i + 2 g + 1 (word stride 6 a pixel),
  // columns 2t, 2t + 1 and 2t + 8, 2t + 9 of the 16 K-values.
  const uint32_t* a_base =
      reinterpret_cast<const uint32_t*>(s_in) + wr * kInRowWords + 12 * g + t;
  const uint4* b_base = s_b + half * (kMaxCout / 32) * 32 + lane;
  uint4* s_warp = s_out + warp * kWarpChunks;
  const int cpp = c_out >> 3;  // 16-byte chunks per output pixel

  for (long long tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const TileOrigin o = tile_origin(tile, tiles_x, tiles_y);
    __syncthreads();  // s_in holds this tile (and on the first, s_b and the affine)

    float acc[4][8][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
    for (int s = 0; s < kKSteps; ++s) {
      uint4 bf[4];
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) bf[pp] = b_base[(s * (kMaxCout / 16) + pp) * 32];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t* a = a_base + (s / 3) * kInRowWords + 96 * i + (s % 3) * 8;
        const uint32_t af[4] = {a[0], a[6], a[4], a[10]};
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          mma_bf16_16816(acc[i][2 * pp], af, bf[pp].x, bf[pp].y);
          mma_bf16_16816(acc[i][2 * pp + 1], af, bf[pp].z, bf[pp].w);
        }
      }
    }

    // Epilogue into the warp's own 64 px x 128 B: pixel P's chunk j sits at
    // P * 8 + (j ^ ((P >> 1) & 7)), so the 8 groups write 8 different bank quads.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ch = half * 64 + 8 * j + 2 * t;
      const float2 sc = *reinterpret_cast<const float2*>(s_scale + ch);
      const float2 bi = *reinterpret_cast<const float2*>(s_bias + ch);
      const int chunk = j ^ g;  // (P >> 1) & 7 == g for both pixels below
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int px = 16 * i + 2 * g;
        reinterpret_cast<uint32_t*>(s_warp + px * 8 + chunk)[t] =
            relu_affine_bf16x2(acc[i][j][0], acc[i][j][1], sc, bi);
        reinterpret_cast<uint32_t*>(s_warp + (px + 1) * 8 + chunk)[t] =
            relu_affine_bf16x2(acc[i][j][2], acc[i][j][3], sc, bi);
      }
    }

    // The next tile's frame values are in flight while this one is stored.
    const long long next = tile + gridDim.x;
    if (next < total) load_tile_input(x, tile_origin(next, tiles_x, tiles_y), h, wd, staged);
    __syncwarp();

    // The warp's half pixels (128 B, a whole cache line each), 16-byte
    // stores, 8 lanes to a pixel.
    const int oy = o.oy0 + wr;
    const int valid = min(kTcCols, wo - o.ox0);
    if (oy < ho) {
      __nv_bfloat16* orow = out + (((long long)o.b * ho + oy) * wo + o.ox0) * c_out + half * 64;
#pragma unroll 4
      for (int i = lane; i < kWarpChunks; i += 32) {
        const int px = i >> 3, c = i & 7;
        if (px < valid && half * 8 + c < cpp)
          *reinterpret_cast<uint4*>(orow + px * c_out + 8 * c) =
              s_warp[px * 8 + (c ^ ((px >> 1) & 7))];
      }
    }
    __syncthreads();  // every warp is done with s_in
    if (next < total) store_tile_input(s_in, staged);
  }
}

cudaError_t launch_bf16(const __nv_bfloat16* x, const uint16_t* taps, const float* scale,
                        const float* bias, __nv_bfloat16* out, int n, int h, int wd, int c_out,
                        cudaStream_t stream) {
  if (n <= 0 || h <= 0 || wd <= 0 || c_out <= 0 || c_out % 8 != 0 || c_out > kMaxCout)
    return cudaErrorInvalidValue;
  const int ho = (h - 1) / 2 + 1;
  const int wo = (wd - 1) / 2 + 1;
  const long long tiles =
      (long long)n * ((ho + kTcRows - 1) / kTcRows) * ((wo + kTcCols - 1) / kTcCols);
  const void* kernel = (const void*)stem_conv_bf16_kernel;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  long long grid = 0;
  if ((err = persistent_grid(kernel, kTcThreads, kTcSmem, tiles, &grid)) != cudaSuccess)
    return err;
  stem_conv_bf16_kernel<<<(unsigned)grid, kTcThreads, kTcSmem, stream>>>(
      x, taps, scale, bias, out, n, h, wd, ho, wo, c_out);
  return cudaGetLastError();
}

}  // namespace

// fp32 frames: w is the (147, c_out) fp32 tap matrix. Returns a cudaError_t.
extern "C" int okt_stem_conv_fp32(const void* x, const void* w, const void* scale,
                                  const void* bias, void* out, int n, int h, int wd, int c_out,
                                  void* stream) {
  return (int)launch_fp32(static_cast<const float*>(x), static_cast<const float*>(w),
                          static_cast<const float*>(scale), static_cast<const float*>(bias),
                          static_cast<float*>(out), n, h, wd, c_out,
                          static_cast<cudaStream_t>(stream));
}

// bf16 frames: taps is the (192, 128) bf16 space-to-depth tap matrix.
// Returns a cudaError_t.
extern "C" int okt_stem_conv_bf16(const void* x, const void* taps, const void* scale,
                                  const void* bias, void* out, int n, int h, int wd, int c_out,
                                  void* stream) {
  return (int)launch_bf16(static_cast<const __nv_bfloat16*>(x), static_cast<const uint16_t*>(taps),
                          static_cast<const float*>(scale), static_cast<const float*>(bias),
                          static_cast<__nv_bfloat16*>(out), n, h, wd, c_out,
                          static_cast<cudaStream_t>(stream));
}
