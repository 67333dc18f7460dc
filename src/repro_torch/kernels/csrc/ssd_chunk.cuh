// The pieces of the SSD chunk scan that the forward (ssd_scan.cu) and its
// backward (ssd_scan_bwd_sm90.cu) share: the chunk length and the block's
// indices, the staging of dt and of bf16 tiles into 128-byte-swizzled
// shared memory by cp.async, the running sum of dt A over a chunk, and the
// forward's bf16 passes 1 and 2 (chunk_state_wgmma, state_pass), which the
// backward runs again to recompute the states entering each chunk as the
// forward rounded them. ssd_scan.cu's header says what they compute.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kQ = 64;          // steps per chunk
constexpr int kMaxDim = 128;    // P and N
constexpr int kWgThreads = 128;   // one warpgroup
constexpr int kPassThreads = 256;

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// The indices of one (chunk, b, h) block.
struct Chunk {
  int64_t b, h, g, bh, t0;
  int nv;  // steps of the chunk inside L
  __device__ Chunk(int64_t L, int64_t H, int64_t G) {
    bh = blockIdx.y;
    b = bh / H;
    h = bh % H;
    g = h / (H / G);
    t0 = static_cast<int64_t>(blockIdx.x) * kQ;
    nv = static_cast<int>(L - t0 < kQ ? L - t0 : kQ);
  }
};

// dt of the chunk's steps into dts[kQ] (0 past L)
__device__ __forceinline__ void stage_dt(float* dts, const float* dt,
                                         const Chunk& ch, int64_t L,
                                         int64_t H) {
  if (threadIdx.x < kQ)
    dts[threadIdx.x] =
        threadIdx.x < ch.nv ? dt[(ch.b * L + ch.t0 + threadIdx.x) * H + ch.h]
                            : 0.f;
}

// inclusive running sum of dt a over the chunk, by the first warp: lane l
// holds steps 2l and 2l + 1
__device__ __forceinline__ void chunk_cumsum(const float* dts, float a,
                                             float* cum) {
  if (threadIdx.x < 32) {
    const int l = threadIdx.x;
    const float v0 = dts[2 * l] * a, v1 = dts[2 * l + 1] * a;
    float s = v0 + v1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, s, o);
      if (l >= o) s += n;
    }
    float excl = __shfl_up_sync(0xffffffffu, s, 1);
    if (l == 0) excl = 0.f;
    cum[2 * l] = excl + v0;
    cum[2 * l + 1] = excl + v0 + v1;
  }
}

// 16 bytes from global to shared memory without a register round trip;
// with ok false it writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// 4 bytes, as cp_async16
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
// the copies started since the last commit form a group; wait until at
// most `pending` groups are still in flight
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int pending>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// ---- wgmma staging (bf16) ----------------------------------------------------

// rows [0, rows) x cols [0, cpad) of a bf16 slab (row r at src + r *
// stride) into a 128-byte-swizzled tile (sm90.cuh): cpad / 64 chunks of
// [rows][64], zeros past nv rows or width columns. cpad is a multiple of
// 64 and rows of 8; 16-byte rows go by cp.async (the caller waits with
// cp_async_wait), others by plain loads.
__device__ __forceinline__ void stage_sw128(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src,
                                            int64_t stride, int width,
                                            int cpad, int rows, int nv) {
  const bool vec = width % 8 == 0 && stride % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0;
  const int vpr = cpad / 8;   // 16-byte vectors a row
  uint8_t* base = reinterpret_cast<uint8_t*>(dst);
  for (int e = threadIdx.x; e < rows * vpr; e += blockDim.x) {
    const int r = e / vpr, v = e % vpr, c = 8 * v;
    uint8_t* d = base + ((size_t)(v / 8) * rows + r) * 128 +
                 (((v % 8) ^ (r % 8)) << 4);
    if (vec) {
      const bool ok = r < nv && c < width;
      cp_async16(d, ok ? src + r * stride + c : src, ok);
    } else {
      alignas(16) __nv_bfloat16 t[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        t[u] = r < nv && c + u < width ? src[r * stride + c + u]
                                       : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(t);
    }
  }
}

// generic-proxy writes to shared memory (plain stores, cp.async) made
// visible to wgmma, which reads through the async proxy; then a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// ---- pass 1: chunk states (bf16) --------------------------------------------

// bf16: the same product on wgmma, one warpgroup: 64 x 64 output tiles
// (64 state rows n by 64 columns p), K = the chunk's kQ steps. B . w and X
// lie [j][*] in 128-byte swizzled tiles, so both operands are MN-major
// (trans-a, trans-b).
__global__ void __launch_bounds__(kWgThreads)
chunk_state_wgmma(const __nv_bfloat16* __restrict__ x,
                  const float* __restrict__ dt, const float* __restrict__ A,
                  const __nv_bfloat16* __restrict__ Bm,
                  float* __restrict__ states, float* __restrict__ totals,
                  int64_t L, int64_t H, int64_t G, int P, int N) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const int NC = round_up(N, 64), PC = round_up(P, 64);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(align1024(smem_raw));
  __nv_bfloat16* Xs = Bs + kQ * NC;                  // [kQ][PC], swizzled
  float* dts = reinterpret_cast<float*>(Xs + kQ * PC);
  float* cum = dts + kQ;
  float* ws = cum + kQ;
  const Chunk ch(L, H, G);
  stage_sw128(Bs, Bm + ((ch.b * L + ch.t0) * G + ch.g) * N, G * N, N, NC, kQ,
              ch.nv);
  stage_sw128(Xs, x + ((ch.b * L + ch.t0) * H + ch.h) * P, H * P, P, PC, kQ,
              ch.nv);
  stage_dt(dts, dt, ch, L, H);
  cp_async_wait();
  __syncthreads();
  chunk_cumsum(dts, A[ch.h], cum);
  __syncthreads();
  const float total = cum[kQ - 1];
  if (threadIdx.x < kQ)
    ws[threadIdx.x] = dts[threadIdx.x] * expf(total - cum[threadIdx.x]);
  __syncthreads();
  // B . w, rounded to bf16 (a rounding point): a 16-byte vector of the
  // swizzled tile lies in one row j
  for (int e = threadIdx.x; e < kQ * NC / 8; e += blockDim.x) {
    const float w = ws[(e % (kQ * 8)) / 8];
    __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(Bs) + 4 * e;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 f = __bfloat1622float2(v[u]);
      v[u] = __floats2bfloat162_rn(f.x * w, f.y * w);
    }
  }
  fence_proxy_async();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = 16 * warp + lane / 4, cq = lane % 4;
  const uint32_t bs = smem_u32(Bs), xs = smem_u32(Xs);
  constexpr uint32_t kChunk = kQ * 128;   // bytes of a 64-column chunk
  float* S = states + (ch.bh * gridDim.x + blockIdx.x) * (int64_t)N * P;
  for (int mt = 0; mt < NC / 64; ++mt)
    for (int pt = 0; pt < PC / 64; ++pt) {
      float acc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk)
        wgmma_ss_m64n64<1, 1>(
            acc, make_desc(bs + mt * kChunk + kk * 2048, kChunk, 1024, 1),
            make_desc(xs + pt * kChunk + kk * 2048, kChunk, 1024, 1), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(acc);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int hrow = 0; hrow < 2; ++hrow) {
          const int n = 64 * mt + row + 8 * hrow;
          const int p = 64 * pt + 8 * nb + 2 * cq;
          if (n >= N || p >= P) continue;
          float* sp = S + n * P + p;
          const float a0 = acc[4 * nb + 2 * hrow], a1 = acc[4 * nb + 2 * hrow + 1];
          if (P % 2 == 0) {
            *reinterpret_cast<float2*>(sp) = make_float2(a0, a1);
          } else {
            sp[0] = a0;
            if (p + 1 < P) sp[1] = a1;
          }
        }
    }
  if (threadIdx.x == 0) totals[ch.bh * gridDim.x + blockIdx.x] = total;
}

// ---- pass 2: the states entering each chunk ---------------------------------

// grid (ceil(N P / kPassThreads), B*H): the states S [B*H][nc][N*P] to
// h_in of the same layout, in place for fp32 (hin == states), into a bf16
// copy for the bf16 path (the rounding point of its carry-in)
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename OutT>
__global__ void __launch_bounds__(kPassThreads)
state_pass(const float* states, const float* __restrict__ totals,
           OutT* hin, float* __restrict__ hfinal, int nc, int P, int NPe) {
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= NPe) return;
  // this form, with B*H*nc < 2^31 checked at launch, ran 2.4x faster in
  // fp32 than one widened to 64 bits first (PERF.md §6)
  const int64_t base = blockIdx.y * nc * (int64_t)NPe + e;
  const float* s = states + base;
  OutT* o = hin + base;
  const float* tot = totals + blockIdx.y * (int64_t)nc;
  constexpr int kInFlight = 8;
  float run = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kInFlight) {
    // every load of the batch before its first store: in fp32 the stores
    // may alias the loads, so the compiler would not hoist them itself
    float v[kInFlight], d[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (c0 + u < nc) {
        v[u] = s[(c0 + u) * (int64_t)NPe];
        d[u] = tot[c0 + u];
      }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (c0 + u >= nc) break;
      put(o + (c0 + u) * (int64_t)NPe, run);
      run = fmaf(expf(d[u]), run, v[u]);
    }
  }
  // element e is (n, p) = (e / P, e % P) of the [N][P] state; h_final is
  // [P][N] per (b, h), as the model's cache holds it
  if (hfinal)
    hfinal[blockIdx.y * (int64_t)NPe + (e % P) * (int64_t)(NPe / P) + e / P] =
        run;
}

// ---- launch ---------------------------------------------------------------

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename OutT>
int launch_state_pass(const float* states, const float* totals, OutT* hin,
                      float* hfinal, int64_t BH, int nc, int P, int N,
                      cudaStream_t stream) {
  const int NPe = P * N;
  const dim3 grid((unsigned)((NPe + kPassThreads - 1) / kPassThreads),
                  (unsigned)BH);
  state_pass<OutT><<<grid, kPassThreads, 0, stream>>>(states, totals, hin,
                                                       hfinal, nc, P, NPe);
  return (int)cudaGetLastError();
}

}  // namespace
