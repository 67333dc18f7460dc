// The MoE's dispatch and combine for Hopper (sm_90a): the slot map and
// the row gathers through it (models/moe.py _moe_local).
//
// Replaces no TPU kernel: the JAX package's MoE (src/repro/models/moe.py)
// is plain JAX, its dispatch a one-hot scan over each choice and a
// scatter, left to XLA. The port computes one slot map and moves tokens
// into the [n_local, C] expert buffer and back by gathers only, in both
// directions:
//
//   slot_map     GShard's sequential-choice positions. Assignment
//                a = j * T + t is token t's j-th choice, expert
//                e = top_e[t, j]; its position is the number of earlier
//                assignments to e; it is kept below C at a local expert
//                (e0 <= e < e0 + n_local) in slot (e - e0) * C + pos.
//                Writes slot[t, j] (S = n_local * C where dropped), and
//                for each slot its token tok[s] (T where empty) and its
//                choice t * k + j (T * k where empty), and base[e], every
//                expert's assignments.
//   gather_sum   out[t] = sum_j w[t, j] * src[idx[t, j]], over the j < k
//                whose idx lies in [0, R); w absent: 1. The combine
//                (src = the experts' output, w = the routing weights) and
//                the dispatch's backward (src = the buffer's gradient).
//   gather_rows  out[s] = ws * src[idx[s]], zero where idx[s] is not in
//                [0, R); ws = w[widx[s]], zero where widx[s] is not in
//                [0, n_w); w absent: 1. The dispatch (src = the tokens)
//                and the combine's backward into the experts' output
//                (src = dy, w = the routing weights by the slot's choice).
//   gather_dot   out[t, j] = <src[idx[t, j]], b[t]>, zero where idx[t, j]
//                is not in [0, R). The combine's backward into the
//                routing weights.
//
// What bounds them: the gathers, device-memory bandwidth (each row read
// feeds one multiply-add an element; least time = bytes / 3.35 TB/s);
// the slot map, its launches (a few hundred KB of indices). A decode
// step runs all of them in each MoE layer, so the host's launches count
// as much as the card's time.
//
// What the design does about it:
//  * The slot map in two launches, where plain torch takes some thirty
//    (a sort, a search, a scatter and the elementwise steps around them).
//    slot_hist counts each chunk's assignments per expert (1,024 a chunk,
//    in GShard's order); slot_place ranks each assignment in its chunk by
//    __match_any_sync within its warp and a prefix over the block's
//    warps, adds the earlier chunks' counts, and writes the slot, the
//    inverse maps and the empty slots. Integer counts only: the result is
//    exact and the same on every run.
//  * The gathers in one pass: each gathered row is read once, only the
//    output is written; in plain torch the combine gathered a [T, k, d]
//    block of rows, scaled and summed it, three trips through device
//    memory besides a copy of the source with a zero row.
//  * 16-byte loads: a thread owns 8 bf16 or 4 f32 columns of a row when
//    d * elsize % 16 == 0 and the pointers are 16-byte aligned; else the
//    same template runs with one element per load (VEC = 1). A block of
//    up to 128 threads covers a row (d = 1,024 in bf16: one load a
//    thread); a narrower row gets one warp.
//  * A dropped choice or an empty slot is skipped by its index: no zero
//    row is read and no weight multiplied into it.
//  * fp32 accumulation, rounded to the row's type once; the choices are
//    summed in the order j = 0 .. k - 1 and gather_dot's block in a fixed
//    tree, with no atomics, so reruns are bit-identical.
//
// Plain C interface, loaded with ctypes. The launches go to the caller's
// stream; nothing here allocates or synchronises. Each entry point returns
// the cudaError_t of its launches (0 on success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum DType { kF32 = 0, kBF16 = 1 };
constexpr int kMaxThreads = 128;     // a gather's block: one row
constexpr int kChunk = 1024;         // the slot map's block: assignments
constexpr int kChunkWarps = kChunk / 32;

__device__ __forceinline__ bool in_range(int64_t i, int64_t n) {
  return static_cast<uint64_t>(i) < static_cast<uint64_t>(n);
}

// ---------------------------------------------------------------- slots
__global__ void __launch_bounds__(kChunk)
slot_hist(const int64_t* __restrict__ top_e, int64_t ld, int64_t T, int k,
          int E, int* __restrict__ hist) {
  extern __shared__ int count[];                         // [E]
  for (int e = threadIdx.x; e < E; e += blockDim.x) count[e] = 0;
  __syncthreads();
  const int64_t a = static_cast<int64_t>(blockIdx.x) * kChunk + threadIdx.x;
  if (a < T * k) {
    const int64_t j = a / T, t = a - j * T;
    atomicAdd(&count[top_e[t * ld + j]], 1);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x)
    hist[static_cast<int64_t>(blockIdx.x) * E + e] = count[e];
}

__global__ void __launch_bounds__(kChunk)
slot_place(const int64_t* __restrict__ top_e, int64_t ld, int64_t T, int k,
           int E, int64_t C, int e0, int n_local,
           const int* __restrict__ hist, int chunks,
           int64_t* __restrict__ slot, int64_t* __restrict__ tok,
           int64_t* __restrict__ choice, int64_t* __restrict__ base) {
  extern __shared__ int sm[];
  int* before = sm;              // [E]: assignments in the earlier chunks
  int* total = sm + E;           // [E]: all assignments
  int* warp_at = sm + 2 * E;     // [warps, E]: counts, then their prefix
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    int b = 0, s = 0;
    for (int c = 0; c < chunks; ++c) {
      const int h = hist[static_cast<int64_t>(c) * E + e];
      b += c < static_cast<int>(blockIdx.x) ? h : 0;
      s += h;
    }
    before[e] = b;
    total[e] = s;
    if (blockIdx.x == 0) base[e] = s;
  }
  for (int i = threadIdx.x; i < kChunkWarps * E; i += blockDim.x)
    warp_at[i] = 0;
  __syncthreads();

  const int64_t n = T * k;
  const int64_t a = static_cast<int64_t>(blockIdx.x) * kChunk + threadIdx.x;
  const bool valid = a < n;
  int64_t j = 0, t = 0;
  int e = -1;                    // past the end: a group of its own
  if (valid) {
    j = a / T;
    t = a - j * T;
    e = static_cast<int>(top_e[t * ld + j]);
  }
  const unsigned same = __match_any_sync(0xffffffffu, e);
  const int rank = __popc(same & ((1u << lane) - 1u));
  if (valid && rank == 0) warp_at[warp * E + e] = __popc(same);
  __syncthreads();
  for (int x = threadIdx.x; x < E; x += blockDim.x) {
    int run = 0;
    for (int w = 0; w < kChunkWarps; ++w) {
      const int c = warp_at[w * E + x];
      warp_at[w * E + x] = run;
      run += c;
    }
  }
  __syncthreads();

  const int64_t S = static_cast<int64_t>(n_local) * C;
  if (valid) {
    const int64_t pos = before[e] + warp_at[warp * E + e] + rank;
    const bool keep = pos < C && e >= e0 && e < e0 + n_local;
    const int64_t s = keep ? (e - e0) * C + pos : S;
    slot[t * k + j] = s;
    if (keep) {
      tok[s] = t;
      choice[s] = t * k + j;
    }
  }
  // the empty slots, past their expert's assignments
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * kChunk + threadIdx.x;
       s < S; s += static_cast<int64_t>(gridDim.x) * kChunk) {
    if (s % C >= total[e0 + s / C]) {
      tok[s] = T;
      choice[s] = n;
    }
  }
}

// -------------------------------------------------------------- gathers
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// VEC elements of T moved by one load or store
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const T* p) {
  return *reinterpret_cast<const Pack<T, VEC>*>(p);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
gather_sum(const T* __restrict__ src, int64_t R, int d,
           const int64_t* __restrict__ idx, const float* __restrict__ w,
           int k, T* __restrict__ out) {
  const int64_t t = blockIdx.x;
  for (int c = threadIdx.x * VEC; c < d; c += blockDim.x * VEC) {
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
    for (int j = 0; j < k; ++j) {
      const int64_t r = idx[t * k + j];
      if (!in_range(r, R)) continue;
      const float s = w ? w[t * k + j] : 1.0f;
      const Pack<T, VEC> x = load<T, VEC>(src + r * d + c);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += s * to_f32(x.v[e]);
    }
    Pack<T, VEC> o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) o.v[e] = from_f32<T>(acc[e]);
    *reinterpret_cast<Pack<T, VEC>*>(out + t * d + c) = o;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
gather_rows(const T* __restrict__ src, int64_t R, int d,
            const int64_t* __restrict__ idx, const float* __restrict__ w,
            const int64_t* __restrict__ widx, int64_t n_w,
            T* __restrict__ out) {
  const int64_t s = blockIdx.x;
  const int64_t r = idx[s];
  const bool hit = in_range(r, R);
  float ws = 1.0f;
  if (w) {
    const int64_t a = widx[s];
    ws = in_range(a, n_w) ? w[a] : 0.0f;
  }
  for (int c = threadIdx.x * VEC; c < d; c += blockDim.x * VEC) {
    Pack<T, VEC> o;
    if (hit) {
      const Pack<T, VEC> x = load<T, VEC>(src + r * d + c);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o.v[e] = w ? from_f32<T>(ws * to_f32(x.v[e])) : x.v[e];
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) o.v[e] = from_f32<T>(0.0f);
    }
    *reinterpret_cast<Pack<T, VEC>*>(out + s * d + c) = o;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
gather_dot(const T* __restrict__ src, int64_t R, int d,
           const int64_t* __restrict__ idx, const T* __restrict__ b, int k,
           float* __restrict__ out) {
  __shared__ float part[kMaxThreads / 32];
  const int64_t t = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  for (int j = 0; j < k; ++j) {
    const int64_t r = idx[t * k + j];
    // the same for the whole block: every thread takes the same branch
    if (!in_range(r, R)) {
      if (threadIdx.x == 0) out[t * k + j] = 0.0f;
      continue;
    }
    float acc = 0.0f;
    for (int c = threadIdx.x * VEC; c < d; c += blockDim.x * VEC) {
      const Pack<T, VEC> x = load<T, VEC>(src + r * d + c);
      const Pack<T, VEC> y = load<T, VEC>(b + t * d + c);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc += to_f32(x.v[e]) * to_f32(y.v[e]);
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) part[warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = 0.0f;
      for (int i = 0; i < warps; ++i) sum += part[i];
      out[t * k + j] = sum;
    }
    __syncthreads();
  }
}

// the launch of one gather in each type and load width
template <template <typename, int> class Launch, typename... Args>
void in_type(int dtype, int wide, Args... args) {
  if (dtype == kBF16)
    wide ? Launch<__nv_bfloat16, 8>::go(args...)
         : Launch<__nv_bfloat16, 1>::go(args...);
  else
    wide ? Launch<float, 4>::go(args...) : Launch<float, 1>::go(args...);
}

template <typename T, int VEC>
struct Sum {
  static void go(const void* src, int64_t R, int d, const int64_t* idx,
                 const float* w, int64_t n, int k, void* out, int threads,
                 cudaStream_t st) {
    gather_sum<T, VEC><<<n, threads, 0, st>>>(
        static_cast<const T*>(src), R, d, idx, w, k, static_cast<T*>(out));
  }
};

template <typename T, int VEC>
struct Rows {
  static void go(const void* src, int64_t R, int d, const int64_t* idx,
                 const float* w, const int64_t* widx, int64_t n_w, int64_t S,
                 void* out, int threads, cudaStream_t st) {
    gather_rows<T, VEC><<<S, threads, 0, st>>>(
        static_cast<const T*>(src), R, d, idx, w, widx, n_w,
        static_cast<T*>(out));
  }
};

template <typename T, int VEC>
struct Dot {
  static void go(const void* src, int64_t R, int d, const int64_t* idx,
                 const void* b, int64_t n, int k, float* out, int threads,
                 cudaStream_t st) {
    gather_dot<T, VEC><<<n, threads, 0, st>>>(
        static_cast<const T*>(src), R, d, idx, static_cast<const T*>(b), k,
        out);
  }
};

}  // namespace

extern "C" {

// top_e [T, k] with row stride ld; hist: [chunks, E] int scratch with
// chunks = ceil(T * k / 1,024); E * 34 ints of shared memory, at most
// 48 KB (the host checks).
int moe_slot_map(const int64_t* top_e, int64_t ld, int64_t T, int k, int E,
                 int64_t C, int e0, int n_local, int* hist, int64_t* slot,
                 int64_t* tok, int64_t* choice, int64_t* base, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = static_cast<int>((T * k + kChunk - 1) / kChunk);
  slot_hist<<<chunks, kChunk, E * sizeof(int), st>>>(top_e, ld, T, k, E,
                                                      hist);
  slot_place<<<chunks, kChunk, (2 + kChunkWarps) * E * sizeof(int), st>>>(
      top_e, ld, T, k, E, C, e0, n_local, hist, chunks, slot, tok, choice,
      base);
  return static_cast<int>(cudaGetLastError());
}

// dtype: kF32 or kBF16; wide: 16-byte loads (the host checked d and the
// pointers); threads: a multiple of 32, at most 128.
int moe_gather_sum(const void* src, int64_t R, int d, const int64_t* idx,
                   const float* w, int64_t n, int k, void* out, int dtype,
                   int wide, int threads, void* stream) {
  in_type<Sum>(dtype, wide, src, R, d, idx, w, n, k, out, threads,
               static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

int moe_gather_rows(const void* src, int64_t R, int d, const int64_t* idx,
                    const float* w, const int64_t* widx, int64_t n_w,
                    int64_t S, void* out, int dtype, int wide, int threads,
                    void* stream) {
  in_type<Rows>(dtype, wide, src, R, d, idx, w, widx, n_w, S, out, threads,
                static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

int moe_gather_dot(const void* src, int64_t R, int d, const int64_t* idx,
                   const void* b, int64_t n, int k, float* out, int dtype,
                   int wide, int threads, void* stream) {
  in_type<Dot>(dtype, wide, src, R, d, idx, b, n, k, out, threads,
               static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

const char* moe_dispatch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
