// Mamba-2 SSD chunk scan (arXiv:2405.21060) for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel ssd_scan_bhl / _ssd_kernel of the JAX
// package (repro/kernels/ssd_scan/kernel.py). For every (b, h) it computes
// the state-space recurrence
//   h_t = exp(dt_t A_h) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t
// with h [P, N] and y [P] per step, in the model layout x, y [B, L, H, P],
// dt [B, L, H], A [H], B/C [B, L, G, N]. Head h reads group g = h / (H / G)
// of B and C; no repeated copy of them is made. x, B and C are f32 or bf16
// (widened on load), dt and A f32; y is rounded to x's type once.
//
// It evaluates the recurrence chunk by chunk, as the TPU kernel does (state
// space duality). Per chunk of Q steps, with cum the running sum of dt A
// inside the chunk and total its last value:
//   y  = (C B^T . exp(cum_i - cum_j) . dt_j, for j <= i) X
//        + exp(cum) . (C h^T)                                  (carry-in)
//   h' = exp(total) h + X^T (B . dt . exp(total - cum))        (update)
// The result does not depend on Q beyond rounding, so the kernel uses its
// own Q = 64 whatever chunk the caller names: a chunk of 256 rows of B and
// C at N = 128 would be 128 KB each in fp32, past shared memory.
//
// What bounds it: operations, about 2 Q (N + P) + 4 N P flops per step
// against (2 P + 2 N + 1) values read or written; at mamba2-1.3b width
// (P = 64, N = 128) that is far past the ridge point. This first version
// runs fp32 FMA on the CUDA cores, not wgmma.
//
// What the design does about it:
//  * One block of 256 threads per (b, h); the chunks run in order inside
//    it, with h kept in fp32 in shared memory between them. The grid is
//    only B * H blocks (64 at mamba2-1.3b with B = 1): correct, not fast.
//    Splitting the work into chunk-state, state-passing and chunk-output
//    passes is a later step.
//  * Each product is spread over a 16 x 16 grid of threads, each thread
//    holding a register tile of outputs; shared-memory rows are padded to
//    an odd length, so the column-strided reads hit distinct banks.
//  * exp(cum_i - cum_j) is taken only where j <= i: above the diagonal the
//    exponent is positive and may overflow to inf, and inf . 0 is NaN.
//  * Steps past L are read as zeros (dt = 0 leaves h unchanged), so the
//    caller pads nothing.
//  * No atomics and a fixed order of every sum: reruns are bit-identical.
//
// Plain C interface, loaded with ctypes. The launch goes to the caller's
// stream; nothing here allocates or synchronises. The entry point returns
// the cudaError_t of its launch (0 on success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;          // steps per chunk
constexpr int kGrid = 16;       // threads along each side of a product
constexpr int kThreads = kGrid * kGrid;
constexpr int kMaxTile = 8;     // outputs per thread along a side: dims <= 128
constexpr int kMaxDim = kGrid * kMaxTile;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// the shared-memory layout; rows padded to odd lengths
struct Layout {
  int P, N;
  __host__ __device__ int xs() const { return P + 1; }   // X  [kQ][P + 1]
  __host__ __device__ int bs() const { return N + 1; }   // B, C [kQ][N + 1]
  __host__ __device__ int hs() const { return N + 1; }   // h  [P][N + 1]
  __host__ __device__ int ms() const { return kQ + 1; }  // M  [kQ][kQ + 1]
  __host__ __device__ size_t floats() const {
    return (size_t)kQ * xs() + 2 * (size_t)kQ * bs() + (size_t)P * hs() +
           (size_t)kQ * ms() + 3 * kQ;
  }
};

// rows [t0, t0 + kQ) of a [*, width] slab whose step t starts at
// base + t * row_stride, into smem [kQ][ld]; steps >= L are zero
template <typename T>
__device__ __forceinline__ void stage(float* smem, int ld, const T* base,
                                      int64_t row_stride, int width,
                                      int64_t t0, int64_t L) {
  for (int e = threadIdx.x; e < kQ * width; e += kThreads) {
    const int r = e / width;
    const int c = e % width;
    const int64_t t = t0 + r;
    smem[r * ld + c] = t < L ? to_f32(base[t * row_stride + c]) : 0.f;
  }
}

// grid (B * H), block kThreads
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_forward(const T* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const T* __restrict__ Bm,
            const T* __restrict__ Cm, T* __restrict__ y, int64_t L,
            int64_t H, int64_t G, int P, int N) {
  extern __shared__ float smem[];
  const Layout lay{P, N};
  float* Xs = smem;
  float* Bs = Xs + kQ * lay.xs();
  float* Cs = Bs + kQ * lay.bs();
  float* Hs = Cs + kQ * lay.bs();
  float* Ms = Hs + P * lay.hs();
  float* dts = Ms + kQ * lay.ms();
  float* cum = dts + kQ;
  float* wts = cum + kQ;            // dt_j exp(total - cum_j)

  const int64_t b = blockIdx.x / H;
  const int64_t h = blockIdx.x % H;
  const int64_t g = h / (H / G);
  const float a_h = A[h];
  const int tx = threadIdx.x % kGrid;
  const int ty = threadIdx.x / kGrid;
  const int np = (P + kGrid - 1) / kGrid;   // register tile along P
  const int nn = (N + kGrid - 1) / kGrid;   // register tile along N

  const T* xb = x + (b * L * H + h) * P;     // step t at xb + t * H * P
  const T* bb = Bm + (b * L * G + g) * N;    // step t at bb + t * G * N
  const T* cb = Cm + (b * L * G + g) * N;
  const float* db = dt + b * L * H + h;      // step t at db + t * H
  T* yb = y + (b * L * H + h) * P;

  for (int e = threadIdx.x; e < P * lay.hs(); e += kThreads) Hs[e] = 0.f;

  for (int64_t t0 = 0; t0 < L; t0 += kQ) {
    __syncthreads();  // the previous chunk's state update is done
    stage(Xs, lay.xs(), xb, H * P, P, t0, L);
    stage(Bs, lay.bs(), bb, G * N, N, t0, L);
    stage(Cs, lay.bs(), cb, G * N, N, t0, L);
    if (threadIdx.x < kQ) {
      const int64_t t = t0 + threadIdx.x;
      dts[threadIdx.x] = t < L ? db[t * H] : 0.f;
    }
    __syncthreads();
    if (threadIdx.x == 0) {       // inclusive running sum of dt A, in order
      float c = 0.f;
      for (int i = 0; i < kQ; ++i) {
        c += dts[i] * a_h;
        cum[i] = c;
      }
    }
    __syncthreads();
    const float total = cum[kQ - 1];
    if (threadIdx.x < kQ)
      wts[threadIdx.x] = dts[threadIdx.x] * expf(total - cum[threadIdx.x]);

    // M[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i, else 0;
    // i = ty + 16 a, j = tx + 16 c
    {
      float acc[kQ / kGrid][kQ / kGrid];
#pragma unroll
      for (int a = 0; a < kQ / kGrid; ++a)
#pragma unroll
        for (int c = 0; c < kQ / kGrid; ++c) acc[a][c] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[kQ / kGrid], bv[kQ / kGrid];
#pragma unroll
        for (int a = 0; a < kQ / kGrid; ++a)
          cv[a] = Cs[(ty + kGrid * a) * lay.bs() + n];
#pragma unroll
        for (int c = 0; c < kQ / kGrid; ++c)
          bv[c] = Bs[(tx + kGrid * c) * lay.bs() + n];
#pragma unroll
        for (int a = 0; a < kQ / kGrid; ++a)
#pragma unroll
          for (int c = 0; c < kQ / kGrid; ++c)
            acc[a][c] = fmaf(cv[a], bv[c], acc[a][c]);
      }
#pragma unroll
      for (int a = 0; a < kQ / kGrid; ++a)
#pragma unroll
        for (int c = 0; c < kQ / kGrid; ++c) {
          const int i = ty + kGrid * a, j = tx + kGrid * c;
          Ms[i * lay.ms() + j] =
              j <= i ? acc[a][c] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
        }
    }
    __syncthreads();

    // y[i][p] = sum_j M[i][j] X[j][p] + exp(cum_i) sum_n C[i][n] h[p][n];
    // i = ty + 16 a, p = tx + 16 c
    {
      float ya[kQ / kGrid][kMaxTile], yc[kQ / kGrid][kMaxTile];
#pragma unroll
      for (int a = 0; a < kQ / kGrid; ++a)
#pragma unroll
        for (int c = 0; c < kMaxTile; ++c) ya[a][c] = yc[a][c] = 0.f;
      for (int j = 0; j < kQ; ++j) {
        float mv[kQ / kGrid];
#pragma unroll
        for (int a = 0; a < kQ / kGrid; ++a)
          mv[a] = Ms[(ty + kGrid * a) * lay.ms() + j];
#pragma unroll
        for (int c = 0; c < kMaxTile; ++c) {
          if (c >= np) break;
          const int p = tx + kGrid * c;
          const float xv = p < P ? Xs[j * lay.xs() + p] : 0.f;
#pragma unroll
          for (int a = 0; a < kQ / kGrid; ++a)
            ya[a][c] = fmaf(mv[a], xv, ya[a][c]);
        }
      }
      for (int n = 0; n < N; ++n) {
        float cv[kQ / kGrid];
#pragma unroll
        for (int a = 0; a < kQ / kGrid; ++a)
          cv[a] = Cs[(ty + kGrid * a) * lay.bs() + n];
#pragma unroll
        for (int c = 0; c < kMaxTile; ++c) {
          if (c >= np) break;
          const int p = tx + kGrid * c;
          const float hv = p < P ? Hs[p * lay.hs() + n] : 0.f;
#pragma unroll
          for (int a = 0; a < kQ / kGrid; ++a)
            yc[a][c] = fmaf(cv[a], hv, yc[a][c]);
        }
      }
#pragma unroll
      for (int a = 0; a < kQ / kGrid; ++a) {
        const int i = ty + kGrid * a;
        const int64_t t = t0 + i;
        if (t >= L) continue;
        const float e = expf(cum[i]);
#pragma unroll
        for (int c = 0; c < kMaxTile; ++c) {
          if (c >= np) break;
          const int p = tx + kGrid * c;
          if (p < P) store(yb + t * H * P + p, ya[a][c] + e * yc[a][c]);
        }
      }
    }
    __syncthreads();  // every read of the old h is done

    // h[p][n] = exp(total) h[p][n] + sum_j X[j][p] B[j][n] w_j;
    // p = ty + 16 a, n = tx + 16 c
    {
      float acc[kMaxTile][kMaxTile];
#pragma unroll
      for (int a = 0; a < kMaxTile; ++a)
#pragma unroll
        for (int c = 0; c < kMaxTile; ++c) acc[a][c] = 0.f;
      for (int j = 0; j < kQ; ++j) {
        const float w = wts[j];
        float xv[kMaxTile];
#pragma unroll
        for (int a = 0; a < kMaxTile; ++a) {
          const int p = ty + kGrid * a;
          xv[a] = p < P ? Xs[j * lay.xs() + p] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < kMaxTile; ++c) {
          if (c >= nn) break;
          const int n = tx + kGrid * c;
          const float bw = n < N ? Bs[j * lay.bs() + n] * w : 0.f;
#pragma unroll
          for (int a = 0; a < kMaxTile; ++a) {
            if (a >= np) break;
            acc[a][c] = fmaf(xv[a], bw, acc[a][c]);
          }
        }
      }
      const float decay = expf(total);
#pragma unroll
      for (int a = 0; a < kMaxTile; ++a) {
        const int p = ty + kGrid * a;
        if (a >= np || p >= P) break;
#pragma unroll
        for (int c = 0; c < kMaxTile; ++c) {
          const int n = tx + kGrid * c;
          if (c >= nn || n >= N) break;
          float* hp = Hs + p * lay.hs() + n;
          *hp = decay * *hp + acc[a][c];
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, int64_t B, int64_t L, int64_t H,
           int64_t G, int P, int N, cudaStream_t stream) {
  auto kernel = ssd_forward<T>;
  const size_t smem = Layout{P, N}.floats() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)(B * H), kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), L, H, G, P, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y: [B, L, H, P]; dt: [B, L, H] f32; A: [H] f32; Bm, Cm: [B, L, G, N];
// all contiguous; x, Bm, Cm and y of one type (dtype 0 f32, 1 bf16);
// H a multiple of G; 1 <= P, N <= 128.
int ssd_scan_forward(const void* x, const void* dt, const void* A,
                     const void* Bm, const void* Cm, void* y, int dtype,
                     int64_t B, int64_t L, int64_t H, int64_t G, int64_t P,
                     int64_t N, void* stream) {
  if (P < 1 || N < 1 || P > kMaxDim || N > kMaxDim)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  switch (dtype) {
    case kF32:
      return launch<float>(x, dtf, Af, Bm, Cm, y, B, L, H, G, (int)P, (int)N,
                           s);
    case kBF16:
      return launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, y, B, L, H, G, (int)P,
                                   (int)N, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
