// Segment reduction for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel segment_reduce_tc / _segment_kernel of
// the JAX package (repro/kernels/window_agg/kernel.py). It computes
//   x[T, C] (row-major, f32 or bf16) -> out[T / stride, C]
// the max, min or sum of each run of `stride` rows, accumulated in fp32
// and rounded to x's type once per segment. Rows after n_seg * stride are
// ignored; the caller need not pad T or C (the TPU's tiling did).
//
// What bounds it: device-memory bandwidth. Every input byte is read once
// for one compare or add, far below the card's ridge point, so the least
// time is (input + output bytes) / 3.35 TB/s.
//
// What the design does about it:
//  * Threads run along C: a warp reads 32 neighbouring columns of a row,
//    so every load is coalesced. Each thread keeps one fp32 accumulator
//    and issues four independent loads before it combines them.
//  * The main path (HybridExecutor's fold of a Q2 window) has ONE segment
//    of up to 648,000 rows x 128 columns. A grid of segments x column
//    tiles would then be 4 blocks. A third grid dimension cuts each
//    segment's rows into n_split chunks (chosen by the host so that the
//    grid fills every SM), which keeps enough loads in flight.
//  * Determinism: pass 1 writes fp32 partials [n_split, n_seg, C]; pass 2
//    combines them in a fixed order. There are no float atomics, so
//    reruns are bit-identical.
//  * NaN propagates as in jnp.max and torch.amax; fmaxf / fminf would
//    drop it.
//
// Plain C interface, loaded with ctypes. The launches go to the caller's
// stream; nothing here allocates or synchronises. Each entry point returns
// the cudaError_t of its launches (0 on success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;  // threads along C: one warp
constexpr int kRows = 8;   // row lanes of a block
constexpr int kFinishThreads = 256;

enum Agg { kMax = 0, kMin = 1, kSum = 2 };
enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int AGG>
__device__ __forceinline__ float identity() {
  return AGG == kMax ? -CUDART_INF_F : (AGG == kMin ? CUDART_INF_F : 0.0f);
}

template <int AGG>
__device__ __forceinline__ float combine(float acc, float v) {
  if (AGG == kMax) return (v > acc || v != v) ? v : acc;
  if (AGG == kMin) return (v < acc || v != v) ? v : acc;
  return acc + v;
}

// Pass 1. grid.x = n_seg * n_col_tiles (column tile fastest), grid.y =
// n_split; block (kCols, kRows). Block (tile, seg, split) reduces rows
// [split * rows_per_split, min(+rows_per_split, stride)) of segment seg,
// columns [tile * kCols, +kCols), into part[split, seg, :].
template <typename T, int AGG>
__global__ void __launch_bounds__(kCols * kRows)
segment_partial(const T* __restrict__ x, float* __restrict__ part,
                int64_t C, int64_t stride, int64_t n_seg,
                int64_t rows_per_split, int64_t n_col_tiles) {
  const int64_t tile = blockIdx.x % n_col_tiles;
  const int64_t seg = blockIdx.x / n_col_tiles;
  const int64_t split = blockIdx.y;
  const int64_t col = tile * kCols + threadIdx.x;
  const int64_t r_split_end = (split + 1) * rows_per_split;
  const int64_t r_end = r_split_end < stride ? r_split_end : stride;

  float acc = identity<AGG>();
  if (col < C) {
    const T* p = x + seg * stride * C + col;
    int64_t r = split * rows_per_split + threadIdx.y;
    for (; r + 3 * kRows < r_end; r += 4 * kRows) {
      const float v0 = to_f32(p[r * C]);
      const float v1 = to_f32(p[(r + kRows) * C]);
      const float v2 = to_f32(p[(r + 2 * kRows) * C]);
      const float v3 = to_f32(p[(r + 3 * kRows) * C]);
      acc = combine<AGG>(acc, v0);
      acc = combine<AGG>(acc, v1);
      acc = combine<AGG>(acc, v2);
      acc = combine<AGG>(acc, v3);
    }
    for (; r < r_end; r += kRows) acc = combine<AGG>(acc, to_f32(p[r * C]));
  }

  // combine the row lanes in a fixed order
  __shared__ float lanes[kRows][kCols];
  lanes[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && col < C) {
    float a = lanes[0][threadIdx.x];
#pragma unroll
    for (int i = 1; i < kRows; ++i) a = combine<AGG>(a, lanes[i][threadIdx.x]);
    part[(split * n_seg + seg) * C + col] = a;
  }
}

// Pass 2: out[i] = combine over splits of part[split, i], split in order,
// rounded to T once. i runs over n_seg * C.
template <typename T, int AGG>
__global__ void __launch_bounds__(kFinishThreads)
segment_finish(const float* __restrict__ part, T* __restrict__ out,
               int64_t n_out, int64_t n_split) {
  const int64_t i = blockIdx.x * (int64_t)kFinishThreads + threadIdx.x;
  if (i >= n_out) return;
  float a = part[i];
  for (int64_t s = 1; s < n_split; ++s) a = combine<AGG>(a, part[s * n_out + i]);
  out[i] = from_f32<T>(a);
}

template <typename T, int AGG>
int launch(const T* x, T* out, float* part, int64_t C, int64_t stride,
           int64_t n_seg, int64_t n_split, int64_t rows_per_split,
           cudaStream_t stream) {
  const int64_t n_col_tiles = (C + kCols - 1) / kCols;
  const dim3 grid1((unsigned)(n_seg * n_col_tiles), (unsigned)n_split);
  segment_partial<T, AGG><<<grid1, dim3(kCols, kRows), 0, stream>>>(
      x, part, C, stride, n_seg, rows_per_split, n_col_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n_out = n_seg * C;
  const unsigned grid2 = (unsigned)((n_out + kFinishThreads - 1) / kFinishThreads);
  segment_finish<T, AGG><<<grid2, kFinishThreads, 0, stream>>>(part, out, n_out,
                                                               n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_agg(const void* x, void* out, void* part, int agg, int64_t C,
               int64_t stride, int64_t n_seg, int64_t n_split,
               int64_t rows_per_split, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  float* pt = static_cast<float*>(part);
  switch (agg) {
    case kMax:
      return launch<T, kMax>(xt, ot, pt, C, stride, n_seg, n_split,
                             rows_per_split, stream);
    case kMin:
      return launch<T, kMin>(xt, ot, pt, C, stride, n_seg, n_split,
                             rows_per_split, stream);
    case kSum:
      return launch<T, kSum>(xt, ot, pt, C, stride, n_seg, n_split,
                             rows_per_split, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x: [n_seg * stride (+ ignored rows), C] contiguous; out: [n_seg, C] of
// x's type; part: fp32 scratch [n_split, n_seg, C]. The splits must cover
// the segment: (n_split - 1) * rows_per_split < stride <= n_split *
// rows_per_split. dtype: 0 f32, 1 bf16; agg: 0 max, 1 min, 2 sum.
int window_agg_segment_reduce(const void* x, void* out, void* part, int dtype,
                              int agg, int64_t C, int64_t stride,
                              int64_t n_seg, int64_t n_split,
                              int64_t rows_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_agg<float>(x, out, part, agg, C, stride, n_seg, n_split,
                               rows_per_split, s);
    case kBF16:
      return launch_agg<__nv_bfloat16>(x, out, part, agg, C, stride, n_seg,
                                       n_split, rows_per_split, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* window_agg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
