// The corner pools' running max and its gradient for Hopper (sm_90a), plain C interface.
//
// A corner pool (ops/corner_pool.py) is a running max along H or W of an
// (N, C, H, W) map, from the start (a prefix pool: bottom, right) or from
// the end (a suffix pool: top, left). Both kernels read the NHWC memory of a
// channels_last map and take the axis and the direction as arguments, so no
// pool flips its input or its output.
//
// Replaces no TPU kernel: the JAX package lowers the pools through XLA's
// lax.cummax (object_keypoints_tpu/ops/corner_pool.py) and differentiates
// cummax through the associative scan it is defined by. On the card the same
// work was torch.cummax with its int64 indices (and a flip before and after
// for a suffix pool) and, for the gradient, about 260 eager launches a pool
// that re-ran that scan under autograd.
//
// What bounds them on the H100: bytes. The forward reads x and writes y
// once; the backward reads x and the cotangent and writes the input
// gradient once. A CornerNet step's 8 pools at batch 49 on 128 x 128 maps of
// 128 channels move 3.3 GB forward and 4.9 GB backward, 0.98 ms and 1.47 ms
// at 3.35 TB/s. The arithmetic is a few instructions an element.
//
// okt_corner_pool_fwd: one thread walks one line (an image and a row or a
// column) for 16 bytes of neighbouring channels, so a warp's loads and
// stores are coalesced across channels, and keeps kUnroll 16-byte loads in
// flight before their maxima are taken. Its values are torch.cummax's bit
// for bit: the same comparison, in which a later element wins a tie and a
// NaN wins and stays, and the winner's bits are copied.
//
// okt_corner_pool_bwd: the vector-Jacobian product of scan_max
// (ops/corner_pool.py), the associative scan's odd/even recursion over
// torch.maximum, whose gradient gives half the cotangent to each operand of
// a tie. A block takes a tile of channels of one whole line, a thread one
// channel, and keeps the line on chip: shared memory holds two trees a
// channel, the maxima and the cotangents, in which level l + 1 takes the
// odd slots of level l. Two sweeps walk the levels, and only the input
// gradient goes back out.
//   Down-sweep, level l of length n (n >= 2): level l + 1 is the max of each
//   complete pair, x[l+1][i] = max(x[l][2i], x[l][2i+1]), and the pair's
//   order (less, tie, greater) replaces x[l][2i]. The even output 2i (i >= 1)
//   is max(before, x[l][2i]) with before the running max of level l + 1 up
//   to i - 1; its cotangent g[l][2i] is split between the two, x[l][2i]'s
//   share replacing it, and the next level's cotangent is
//   g[l+1][i] = g[l][2i+1] + the share of before at the even output 2i + 2.
//   Up-sweep, from the deepest level (length < 2, where the input cotangent
//   is the output's): level l + 1's input cotangent is split over each pair
//   by its order, the even position's share added to what its slot holds.
// A suffix pool indexes its line from the end, so the tree is that of the
// flipped line, as scan_max(x.flip) builds it. Every node is a sum of at most
// two terms; each is taken in float32 and rounded to the map's dtype before
// it is used again, as the eager ops round, so the result equals the plain
// version's (scan_max_vjp) bit for bit in bfloat16 and float32.
//
// Shared memory is 2 x L values of the map's dtype a channel; the tile is the
// widest power of two up to 32 channels that fits kSmemBytes, so a line of
// 128 takes 32 channels (16 KB in bf16, 32 KB in float32) and the longest
// line, kMaxLine = 4,096, one or two.
//
// The kernels launch on the caller's stream, allocate nothing and do not
// synchronise; each entry point returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // forward
constexpr int kUnroll = 8;     // forward loads a thread has in flight
constexpr int kTile = 32;      // backward: most channels a block
constexpr int kSmemBytes = 48 * 1024;
constexpr int kMaxLine = 4096;

// Where the lines of an NHWC-dense (N, C, H, W) map lie, for a scan along H
// or W. A line is (image, position on the other axis); its elements sit
// `along` apart, starting at image * image_elems + other * across + channel.
struct Lines {
  long long count;        // N x the other axis
  long long other;        // the other axis' size
  long long image_elems;  // H x W x C
  long long across;
  long long along;
  int length;
  int channels;
};

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ __nv_bfloat16 from_float(float v) { return __float2bfloat16_rn(v); }
template <> __device__ __forceinline__ float from_float(float v) { return v; }

// v rounded to the map's dtype, as a float.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_float(from_float<T>(v)); }

// torch.cummax's step: the new element wins a tie; a NaN wins and stays.
__device__ __forceinline__ bool takes(float v, float m) {
  return isnan(v) || (!isnan(m) && v >= m);
}

// torch.maximum's value: a NaN operand propagates.
__device__ __forceinline__ float max_nan(float a, float b) { return (isnan(a) || a > b) ? a : b; }

// torch.maximum's backward: the share of cotangent g of max(l, r) that goes
// to l (to_left) or to r; a tie gives each g / 2 in the map's dtype.
template <typename T>
__device__ __forceinline__ float to_left(float l, float r, float g) {
  return l < r ? 0.f : (l == r ? round_to<T>(g * 0.5f) : g);
}
template <typename T>
__device__ __forceinline__ float to_right(float l, float r, float g) {
  return l > r ? 0.f : (l == r ? round_to<T>(g * 0.5f) : g);
}

// The elements of T in a 32-bit word: two bfloat16 (element 0 in the low
// half) or one float32; each read as a float32 and selected as raw bits.
template <typename T> struct Words;
template <> struct Words<__nv_bfloat16> {
  static constexpr int kPer = 2;
  __device__ static float get(uint32_t w, int e) {
    return __uint_as_float(e ? (w & 0xffff0000u) : (w << 16));
  }
  __device__ static uint32_t mask(int e) { return e ? 0xffff0000u : 0x0000ffffu; }
};
template <> struct Words<float> {
  static constexpr int kPer = 1;
  __device__ static float get(uint32_t w, int) { return __uint_as_float(w); }
  __device__ static uint32_t mask(int) { return 0xffffffffu; }
};

// The forward with one 16-byte load and store a thread and position: 8
// bfloat16 or 4 float32 channels. Every offset of the lines is a multiple of
// that (C is), and x and y are 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kThreads) pool_forward_vec(const uint4* __restrict__ x,
                                                             uint4* __restrict__ y, Lines ln,
                                                             int reverse) {
  using W = Words<T>;
  constexpr int kElems = 4 * W::kPer;
  const long long groups = ln.channels / kElems;
  const long long total = ln.count * groups;
  const long long along = ln.along / kElems;
  const long long step = reverse ? -along : along;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x; t < total;
       t += (long long)gridDim.x * kThreads) {
    const long long line = t / groups;
    const long long image = line / ln.other;
    const uint4* xp = x + (image * ln.image_elems + (line - image * ln.other) * ln.across) / kElems +
                      (t - line * groups) + (reverse ? (long long)(ln.length - 1) * along : 0);
    uint4* yp = y + (xp - x);
    float m[kElems];
    uint32_t out[4];
    for (int p0 = 0; p0 < ln.length; p0 += kUnroll) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (p0 + u < ln.length) v[u] = __ldg(xp + (p0 + u) * step);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (p0 + u >= ln.length) break;
        const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int e = 0; e < W::kPer; ++e) {
            const float f = W::get(w[i], e);
            if (p0 + u == 0 || takes(f, m[i * W::kPer + e])) {
              m[i * W::kPer + e] = f;
              out[i] = (p0 + u == 0) ? w[i] : ((out[i] & ~W::mask(e)) | (w[i] & W::mask(e)));
            }
          }
        }
        yp[(p0 + u) * step] = make_uint4(out[0], out[1], out[2], out[3]);
      }
    }
  }
}

// The forward for any C and alignment: one element a thread and position.
template <typename T>
__global__ void __launch_bounds__(kThreads) pool_forward_scalar(const T* __restrict__ x,
                                                                T* __restrict__ y, Lines ln,
                                                                int reverse) {
  const long long total = ln.count * ln.channels;
  const long long step = reverse ? -ln.along : ln.along;
  for (long long t = (long long)blockIdx.x * kThreads + threadIdx.x; t < total;
       t += (long long)gridDim.x * kThreads) {
    const long long line = t / ln.channels;
    const long long image = line / ln.other;
    const long long at = image * ln.image_elems + (line - image * ln.other) * ln.across +
                         (t - line * ln.channels) +
                         (reverse ? (long long)(ln.length - 1) * ln.along : 0);
    T m = x[at];
    float fm = to_float(m);
    y[at] = m;
    for (int p = 1; p < ln.length; ++p) {
      const T v = x[at + p * step];
      const float f = to_float(v);
      if (takes(f, fm)) {
        m = v;
        fm = f;
      }
      y[at + p * step] = m;
    }
  }
}

// The order of a pair (a, b) of one level, kept for the up-sweep in place of
// a: -1 where a < b, 1 where a > b, 0 where they tie, 2 where a NaN leaves
// them unordered (each operand then takes the whole cotangent, as
// torch.maximum's backward gives it).
__device__ __forceinline__ float order(float a, float b) {
  return a < b ? -1.f : (a > b ? 1.f : (a == b ? 0.f : 2.f));
}

// One 16-byte copy from the map into shared memory, asynchronous (cp.async).
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void copies_done() { asm volatile("cp.async.wait_all;\n" ::); }

template <typename T, bool kVec>
__global__ void pool_backward(const T* __restrict__ x, const T* __restrict__ g,
                              T* __restrict__ gx, Lines ln, int reverse, long long blocks) {
  constexpr int kV = 16 / sizeof(T);  // channels in 16 bytes
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockDim.x, t = threadIdx.x, L = ln.length;
  // Two trees of L slots a channel, slot-major (channel t of slot s at s * tile + t): level l's
  // element k at slot ((k + 1) << l) - 1, so level l + 1 takes level l's odd slots.
  T* const x0 = reinterpret_cast<T*>(smem);  // the line's maxima; a pair's order once used
  T* const g0 = x0 + L * tile;                // the cotangents
  T* const xs = x0 + t;
  T* const gs = g0 + t;
  const long long tiles = (ln.channels + tile - 1) / tile;
  const long long step = reverse ? -ln.along : ln.along;
  for (long long b = blockIdx.x; b < blocks; b += gridDim.x) {
    const long long line = b / tiles;
    const long long c0 = (b - line * tiles) * tile;
    const int width = (int)(ln.channels - c0 < tile ? ln.channels - c0 : tile);
    const long long image = line / ln.other;
    const long long at = image * ln.image_elems + (line - image * ln.other) * ln.across + c0 +
                         (reverse ? (long long)(L - 1) * ln.along : 0);
    if constexpr (kVec) {
      // The tile's L x width values of x and of the cotangent, 16 bytes a copy.
      const int per = width / kV;
      for (int v = t; v < L * per; v += tile) {
        const int p = v / per, q = (v - p * per) * kV;
        copy16_async(x0 + p * tile + q, x + at + p * step + q);
        copy16_async(g0 + p * tile + q, g + at + p * step + q);
      }
      copies_done();
      __syncthreads();
    } else if (t < width) {
      const T* xp = x + at + t;
      const T* gp = g + at + t;
#pragma unroll 8
      for (int p = 0; p < L; ++p, xp += step, gp += step) {
        xs[p * tile] = *xp;
        gs[p * tile] = *gp;
      }
    }
    if (t < width) {
      // Down-sweep: level l + 1's maxima and output cotangents into level l's
      // odd slots; each pair's order into its even slot; the share of each even
      // output 2i + 2 that goes to x[2i + 2] into that output's slot.
      int level = 0;
      for (int n = L; n >= 2; n >>= 1, ++level) {
        const int k = n >> 1, half = tile << level, pair = half << 1;
        T* px = xs + (half - tile);
        T* pg = gs + (half - tile);
        float a = to_float(*px), before = 0.f;
        for (int i = 0; i < k; ++i, px += pair, pg += pair) {
          const float b2 = to_float(px[half]);
          const float up = max_nan(a, b2);
          *px = from_float<T>(order(a, b2));
          px[half] = from_float<T>(up);
          before = i == 0 ? up : max_nan(before, up);
          float sum = to_float(pg[half]);
          if (i + 1 < k || (n & 1)) {
            a = to_float(px[pair]);
            const float ge = to_float(pg[pair]);
            pg[pair] = from_float<T>(to_right<T>(before, a, ge));
            sum = round_to<T>(sum + to_left<T>(before, a, ge));
          }
          pg[half] = from_float<T>(sum);
        }
      }
      // Up-sweep: the deepest level's input cotangent is its output's; each
      // level splits the next one's over the pair that made it.
      while (level > 0) {
        --level;
        const int k = (L >> level) >> 1, half = tile << level, pair = half << 1;
        const T* px = xs + (half - tile);
        T* pg = gs + (half - tile);
        for (int j = 0; j < k; ++j, px += pair, pg += pair) {
          const float o = to_float(*px), up = to_float(pg[half]);
          const float shared = o == 0.f ? round_to<T>(up * 0.5f) : up;
          *pg = from_float<T>((o == -1.f ? 0.f : shared) + to_float(*pg));
          pg[half] = from_float<T>(o == 1.f ? 0.f : shared);
        }
      }
    }
    if constexpr (kVec) {
      __syncthreads();
      const int per = width / kV;
      for (int v = t; v < L * per; v += tile) {
        const int p = v / per, q = (v - p * per) * kV;
        *reinterpret_cast<uint4*>(gx + at + p * step + q) =
            *reinterpret_cast<const uint4*>(g0 + p * tile + q);
      }
      __syncthreads();  // the next line's copies overwrite shared memory
    } else if (t < width) {
      T* op = gx + at + t;
#pragma unroll 8
      for (int p = 0; p < L; ++p, op += step) *op = gs[p * tile];
    }
  }
}

// Blocks to keep every SM full: the occupancy of `kernel` times the SMs,
// and no more than `need`.
cudaError_t grid_for(const void* kernel, int threads, size_t smem, long long need, int* grid) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  const long long full = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *grid = (int)(need < full ? need : full);
  return cudaSuccess;
}

// The lines of an (n, c, h, w) map for a scan along dim (2: H, 3: W).
bool make_lines(long long n, int c, int h, int w, int dim, Lines* ln) {
  if (n <= 0 || c <= 0 || h <= 0 || w <= 0 || (dim != 2 && dim != 3)) return false;
  ln->image_elems = (long long)h * w * c;
  ln->channels = c;
  if (dim == 2) {  // along H: a line is a column
    ln->length = h;
    ln->other = w;
    ln->across = c;
    ln->along = (long long)w * c;
  } else {  // along W: a line is a row
    ln->length = w;
    ln->other = h;
    ln->across = (long long)w * c;
    ln->along = c;
  }
  ln->count = n * ln->other;
  return true;
}

template <typename T>
cudaError_t forward(const void* x, void* y, const Lines& ln, int reverse, cudaStream_t stream) {
  constexpr int kElems = 16 / sizeof(T);
  const bool vector = ln.channels % kElems == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const long long threads = ln.count * (vector ? ln.channels / kElems : ln.channels);
  const long long need = (threads + kThreads - 1) / kThreads;
  int grid = 0;
  cudaError_t err;
  if (vector) {
    if ((err = grid_for((const void*)pool_forward_vec<T>, kThreads, 0, need, &grid)) != cudaSuccess)
      return err;
    pool_forward_vec<T><<<grid, kThreads, 0, stream>>>(static_cast<const uint4*>(x),
                                                       static_cast<uint4*>(y), ln, reverse);
  } else {
    if ((err = grid_for((const void*)pool_forward_scalar<T>, kThreads, 0, need, &grid)) !=
        cudaSuccess)
      return err;
    pool_forward_scalar<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                                          static_cast<T*>(y), ln, reverse);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const void* x, const void* g, void* gx, const Lines& ln, int reverse,
                     cudaStream_t stream) {
  if (ln.length > kMaxLine) return cudaErrorInvalidValue;
  constexpr int kV = 16 / sizeof(T);
  const size_t per_channel = 2 * (size_t)ln.length * sizeof(T);
  int tile = kTile;
  while (tile > 1 && tile * per_channel > kSmemBytes) tile >>= 1;
  while (tile > 1 && tile / 2 >= ln.channels) tile >>= 1;  // no idle half of a block
  const bool vector = tile % kV == 0 && ln.channels % kV == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(gx) % 16 == 0;
  const size_t smem = tile * per_channel;
  const long long blocks = ln.count * ((ln.channels + tile - 1) / tile);
  const void* kernel = vector ? (const void*)pool_backward<T, true> : (const void*)pool_backward<T, false>;
  int grid = 0;
  cudaError_t err = grid_for(kernel, tile, smem, blocks, &grid);
  if (err != cudaSuccess) return err;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* gxt = static_cast<T*>(gx);
  if (vector)
    pool_backward<T, true><<<grid, tile, smem, stream>>>(xt, gt, gxt, ln, reverse, blocks);
  else
    pool_backward<T, false><<<grid, tile, smem, stream>>>(xt, gt, gxt, ln, reverse, blocks);
  return cudaGetLastError();
}

}  // namespace

// x, y: the NHWC memory of an (n, c, h, w) map in the dtype `dtype` names
// (0 bfloat16, 1 float32). y = the running max of x along dim (2: H, 3: W),
// from the end where `reverse`. Returns a cudaError_t.
extern "C" int okt_corner_pool_fwd(const void* x, void* y, int dtype, long long n, int c, int h,
                                   int w, int dim, int reverse, void* stream) {
  Lines ln;
  if (!make_lines(n, c, h, w, dim, &ln)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)forward<__nv_bfloat16>(x, y, ln, reverse, s);
    case 1: return (int)forward<float>(x, y, ln, reverse, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x (the pool's input), g (the cotangent of its output), gx (the input
// gradient): the NHWC memory of (n, c, h, w) maps in the dtype `dtype`
// names; lines of at most 4,096. Returns a cudaError_t.
extern "C" int okt_corner_pool_bwd(const void* x, const void* g, void* gx, int dtype, long long n,
                                   int c, int h, int w, int dim, int reverse, void* stream) {
  Lines ln;
  if (!make_lines(n, c, h, w, dim, &ln)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)backward<__nv_bfloat16>(x, g, gx, ln, reverse, s);
    case 1: return (int)backward<float>(x, g, gx, ln, reverse, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
