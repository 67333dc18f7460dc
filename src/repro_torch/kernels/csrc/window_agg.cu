// Segment reduction for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel segment_reduce_tc / _segment_kernel of
// the JAX package (src/repro/kernels/window_agg/kernel.py:45, its
// pallas_call at :56). It computes
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
//  * 16-byte loads. Each thread owns 16 bytes of a row (4 f32 or 8 bf16
//    columns) and reads them with one read-only 128-bit load, so a warp
//    covers 512 contiguous bytes of a row: a whole row of the Q2 fold
//    (128 f32), a quarter of a fleet row in f32, an eighth in bf16. The
//    wide loads need C * elsize % 16 == 0 and a 16-byte aligned x; else
//    the same template runs with one element per load (VEC = 1). The
//    wide loads are streamed past L1 (ld.global.nc.L1::no_allocate), since
//    each byte is read once, and kept as loaded until they are combined,
//    so that eight in flight cost 32 registers in either type.
//  * Bytes in flight. A thread walks its rows kUnroll = 8 at a time, all
//    eight loads issued before the first is combined (the ragged tail
//    too, under predicates): 4 KB in flight per warp.
//  * Work items. An item is (split, segment, column tile of 32 * VEC
//    columns). When there are many items (the fleet: 1,440 segments x 4
//    or 8 tiles) each warp owns whole items, LANES = 1: it walks all of
//    its segment's rows and writes the result, with no shared memory and
//    no barrier; a block of 8 warps takes 8 items, in a grid-stride loop.
//    When there are few (the Q2 fold: one segment of 648,000 rows x 128
//    columns, one tile) the block's 8 warps are the row lanes of one item
//    (LANES = 8) and combine once through shared memory, after some
//    hundreds of rows each, and the host cuts each segment's rows into
//    n_split splits so that every SM has blocks.
//  * One pass when there is no split: with n_split == 1 the pass writes
//    out in x's type. With n_split > 1 it writes fp32 partials
//    [n_split, n_seg, C] and segment_finish combines them in a fixed
//    order, 32 split lanes to an output column.
//  * Determinism: no float atomics and a fixed order of every combine, so
//    reruns are bit-identical.
//  * NaN propagates as in jnp.max and torch.amax; fmaxf / fminf would
//    drop it.
// The launch plan (VEC, LANES, n_split, grid) is the host's pure function
// of the shape (kernels/window_agg/kernel.py launch_plan).
//
// Plain C interface, loaded with ctypes. The launches go to the caller's
// stream; nothing here allocates or synchronises. The entry point returns
// the cudaError_t of its launches (0 on success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;            // warps of a block
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 8;           // loads in flight per thread
constexpr int kFinishLanes = 32;     // split lanes of an output column

enum Agg { kMax = 0, kMin = 1, kSum = 2 };
enum DType { kF32 = 0, kBF16 = 1 };

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

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// VEC consecutive elements of x as loaded: one 16-byte word, kept as
// loaded until it is combined (8 in flight cost 32 registers in either
// type), or one element as fp32
template <typename T, int VEC>
struct Raw {
  using type = uint4;
};
template <typename T>
struct Raw<T, 1> {
  using type = float;
};

template <typename T, int VEC>
__device__ __forceinline__ typename Raw<T, VEC>::type load(const T* p) {
  if constexpr (VEC == 1) {
    if constexpr (sizeof(T) == 4)
      return __ldg(reinterpret_cast<const float*>(p));
    else
      return bf16_lo(__ldg(reinterpret_cast<const unsigned short*>(p)));
  } else {
    // read-only, streamed past L1 (each byte is read once), with a
    // 256-byte L2 prefetch
    uint4 w;
    asm volatile(
        "ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(w.x), "=r"(w.y), "=r"(w.z), "=r"(w.w)
        : "l"(p));
    return w;
  }
}

// acc[e] = combine(acc[e], element e of w), in column order
template <typename T, int AGG, int VEC>
__device__ __forceinline__ void combine_raw(
    float (&acc)[VEC], const typename Raw<T, VEC>::type& w) {
  if constexpr (VEC == 1) {
    acc[0] = combine<AGG>(acc[0], w);
  } else {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        acc[i] = combine<AGG>(acc[i], __uint_as_float(u[i]));
      } else {
        acc[2 * i] = combine<AGG>(acc[2 * i], bf16_lo(u[i]));
        acc[2 * i + 1] = combine<AGG>(acc[2 * i + 1], bf16_hi(u[i]));
      }
    }
  }
}

// the VEC results of a thread, rounded to T once
template <typename T, int VEC>
__device__ __forceinline__ void store_out(T* p, const float (&a)[VEC]) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (VEC == 1) {
      *reinterpret_cast<float*>(p) = a[0];
    } else {
      *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
    }
  } else {
    if constexpr (VEC == 1) {
      *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16(a[0]);
    } else {
      __nv_bfloat162 h[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        h[i] = __floats2bfloat162_rn(a[2 * i], a[2 * i + 1]);
      *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
    }
  }
}

// the VEC fp32 partials of a thread
template <int VEC>
__device__ __forceinline__ void store_part(float* p, const float (&a)[VEC]) {
  if constexpr (VEC == 1) {
    *p = a[0];
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(a[i], a[i + 1], a[i + 2], a[i + 3]);
  }
}

// The pass. grid.x blocks of kWarps warps walk the items (segment,
// column tile), column tile fastest, kWarps / LANES items a block at a
// time; grid.y = n_split. An item's LANES warps take rows
// [split * rows_per_split, min(+rows_per_split, stride)) of its segment,
// warp l the rows l, l + LANES, ... of them, each lane VEC columns from
// (tile * 32 + lane) * VEC. With part == nullptr (n_split == 1) the
// result goes to out in x's type, else to part[split, seg, :] in fp32.
template <typename T, int AGG, int VEC, int LANES>
__global__ void __launch_bounds__(kThreads)
segment_pass(const T* __restrict__ x, T* __restrict__ out,
             float* __restrict__ part, int64_t C, int64_t stride,
             int64_t n_seg, int64_t rows_per_split, int64_t tiles) {
  constexpr int kItemsPerBlock = kWarps / LANES;
  __shared__ float lanes[LANES][32][VEC];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lrow = warp % LANES;
  const int64_t split = blockIdx.y;
  const int64_t n_items = n_seg * tiles;
  const int64_t r_begin = split * rows_per_split;
  const int64_t r_split_end = r_begin + rows_per_split;
  const int64_t r_end = r_split_end < stride ? r_split_end : stride;

  for (int64_t item = blockIdx.x * (int64_t)kItemsPerBlock + warp / LANES;
       item < n_items; item += (int64_t)gridDim.x * kItemsPerBlock) {
    const int64_t tile = item % tiles, seg = item / tiles;
    const int64_t col = (tile * 32 + lane) * VEC;
    const bool active = col < C;
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = identity<AGG>();
    if (active) {
      const T* p = x + seg * stride * C + col;
      int64_t r = r_begin + lrow;
      typename Raw<T, VEC>::type w[kUnroll];
      for (; r + (kUnroll - 1) * LANES < r_end; r += kUnroll * LANES) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          w[u] = load<T, VEC>(p + (r + u * LANES) * C);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) combine_raw<T, AGG, VEC>(acc, w[u]);
      }
      // the ragged tail: its loads issued together, combined in row order
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (r + u * LANES < r_end)
          w[u] = load<T, VEC>(p + (r + u * LANES) * C);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (r + u * LANES < r_end) combine_raw<T, AGG, VEC>(acc, w[u]);
    }
    if constexpr (LANES > 1) {
      // combine the row lanes in a fixed order
#pragma unroll
      for (int e = 0; e < VEC; ++e) lanes[lrow][lane][e] = acc[e];
      __syncthreads();
      if (lrow == 0) {
#pragma unroll
        for (int i = 1; i < LANES; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[e] = combine<AGG>(acc[e], lanes[i][lane][e]);
      }
      __syncthreads();   // before the next item writes the lanes again
    }
    if (lrow == 0 && active) {
      if (part == nullptr)
        store_out<T, VEC>(out + seg * C + col, acc);
      else
        store_part<VEC>(part + (split * n_seg + seg) * C + col, acc);
    }
  }
}

// The second pass when n_split > 1: out[i] = the combine over splits of
// part[split, i], rounded to T once. Block (32, kFinishLanes): 32 outputs,
// split lane y taking splits y, y + kFinishLanes, ... in order, then the
// lanes in order.
template <typename T, int AGG>
__global__ void __launch_bounds__(32 * kFinishLanes)
segment_finish(const float* __restrict__ part, T* __restrict__ out,
               int64_t n_out, int64_t n_split) {
  __shared__ float lanes[kFinishLanes][32];
  const int64_t i = blockIdx.x * 32ll + threadIdx.x;
  float a = identity<AGG>();
  if (i < n_out) {
#pragma unroll 8
    for (int64_t s = threadIdx.y; s < n_split; s += kFinishLanes)
      a = combine<AGG>(a, part[s * n_out + i]);
  }
  lanes[threadIdx.y][threadIdx.x] = a;
  __syncthreads();
  if (threadIdx.y == 0 && i < n_out) {
#pragma unroll
    for (int l = 1; l < kFinishLanes; ++l)
      a = combine<AGG>(a, lanes[l][threadIdx.x]);
    float r[1] = {a};
    store_out<T, 1>(out + i, r);
  }
}

template <typename T, int AGG, int VEC>
int launch(const T* x, T* out, float* part, int lanes, int64_t C,
           int64_t stride, int64_t n_seg, int64_t n_split,
           int64_t rows_per_split, int64_t grid_x, cudaStream_t stream) {
  const int64_t tiles = (C + 32 * VEC - 1) / (32 * VEC);
  const dim3 grid((unsigned)grid_x, (unsigned)n_split);
  float* p = n_split > 1 ? part : nullptr;
  if (lanes == 1)
    segment_pass<T, AGG, VEC, 1><<<grid, kThreads, 0, stream>>>(
        x, out, p, C, stride, n_seg, rows_per_split, tiles);
  else if (lanes == kWarps)
    segment_pass<T, AGG, VEC, kWarps><<<grid, kThreads, 0, stream>>>(
        x, out, p, C, stride, n_seg, rows_per_split, tiles);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  const int64_t n_out = n_seg * C;
  segment_finish<T, AGG><<<(unsigned)((n_out + 31) / 32),
                           dim3(32, kFinishLanes), 0, stream>>>(part, out,
                                                                n_out, n_split);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_agg(const void* x, void* out, void* part, int agg, int lanes,
               int64_t C, int64_t stride, int64_t n_seg, int64_t n_split,
               int64_t rows_per_split, int64_t grid_x, cudaStream_t stream) {
  if (VEC > 1 && (C % VEC != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if (n_split > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  float* pt = static_cast<float*>(part);
  switch (agg) {
    case kMax:
      return launch<T, kMax, VEC>(xt, ot, pt, lanes, C, stride, n_seg,
                                  n_split, rows_per_split, grid_x, stream);
    case kMin:
      return launch<T, kMin, VEC>(xt, ot, pt, lanes, C, stride, n_seg,
                                  n_split, rows_per_split, grid_x, stream);
    case kSum:
      return launch<T, kSum, VEC>(xt, ot, pt, lanes, C, stride, n_seg,
                                  n_split, rows_per_split, grid_x, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x: [n_seg * stride (+ ignored rows), C] contiguous; out: [n_seg, C] of
// x's type; part: fp32 scratch [n_split, n_seg, C], or null when n_split
// is 1. dtype: 0 f32, 1 bf16; agg: 0 max, 1 min, 2 sum; wide: 16-byte
// loads (needs C * elsize % 16 == 0 and a 16-byte aligned x), else one
// element per load; lanes: 1 or 8 warps per item. The splits must cover
// the segment: (n_split - 1) * rows_per_split < stride <= n_split *
// rows_per_split; grid_x <= 2^31 - 1 and n_split <= 65535.
int window_agg_segment_reduce(const void* x, void* out, void* part, int dtype,
                              int agg, int wide, int lanes, int64_t C,
                              int64_t stride, int64_t n_seg, int64_t n_split,
                              int64_t rows_per_split, int64_t grid_x,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype * 2 + (wide ? 1 : 0)) {
    case kF32 * 2:
      return launch_agg<float, 1>(x, out, part, agg, lanes, C, stride, n_seg,
                                  n_split, rows_per_split, grid_x, s);
    case kF32 * 2 + 1:
      return launch_agg<float, 4>(x, out, part, agg, lanes, C, stride, n_seg,
                                  n_split, rows_per_split, grid_x, s);
    case kBF16 * 2:
      return launch_agg<__nv_bfloat16, 1>(x, out, part, agg, lanes, C, stride,
                                          n_seg, n_split, rows_per_split,
                                          grid_x, s);
    case kBF16 * 2 + 1:
      return launch_agg<__nv_bfloat16, 8>(x, out, part, agg, lanes, C, stride,
                                          n_seg, n_split, rows_per_split,
                                          grid_x, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* window_agg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
