// Mamba-2 SSD chunk scan (arXiv:2405.21060) for Hopper (sm_90a), in three
// passes over chunks.
//
// Replaces the TPU Pallas kernel ssd_scan_bhl / _ssd_kernel of the JAX
// package (src/repro/kernels/ssd_scan/kernel.py:71, its pallas_call at
// :80). For every (b, h) it computes the state-space recurrence
//   h_t = exp(dt_t A_h) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t
// with h [P, N] and y [P] per step, in the model layout x, y [B, L, H, P],
// dt [B, L, H], A [H], B/C [B, L, G, N]. Head h reads group g = h / (H / G)
// of B and C; no repeated copy of them is made. x, B and C are f32 or
// bf16, dt and A f32; y (without the D x skip) is rounded to x's type once.
// Steps past L read as zeros (dt = 0 leaves h unchanged), so the caller
// pads nothing.
//
// It evaluates the recurrence chunk by chunk (state space duality). Per
// chunk c of kQ = 64 steps, with cum the running sum of dt A inside it and
// total_c its last value:
//   1. chunk_state  (grid n_chunks x B*H): w_j = dt_j exp(total_c - cum_j),
//      S_c = X_c^T (B_c . w) [P, N], fp32, written with total_c;
//   2. state_pass   (grid tiles of N*P x B*H): per state element, in chunk
//      order, h_in[c] = running; running = exp(total_c) running + S_c. In
//      fp32 it overwrites S with h_in in place; in bf16 it writes h_in,
//      rounded to bf16, to a buffer of its own. Where the caller asks for
//      it, the running state after the last chunk (the state at step L)
//      goes to h_final [B, H, P, N] in fp32; it is held in a register, so
//      neither the fp32 overwrite nor the bf16 copy has lost it;
//   3. chunk_output (grid n_chunks x B*H):
//      y = (C B^T . exp(cum_i - cum_j) . dt_j, for j <= i) X
//          + exp(cum_i) (C h_in[c]^T).
// The result does not depend on the chunk beyond rounding; the kernel
// takes its own kQ whatever chunk the caller names. The states are stored
// [N][P] (p contiguous) in fp32, 4 B H P N (L / kQ) bytes: 134 MB at
// mamba2-1.3b width (B 1, L 4,096, H 64, P 64, N 128), written by pass 1
// and read by pass 2; h_in is written by pass 2 and read by pass 3, 134 MB
// in fp32 and 67 MB in bf16.
//
// What bounds it: bytes in bf16, operations in fp32. The function must
// read x, dt, B, C and write y once: 70.3 MB in bf16 at that width,
// 0.021 ms at 3.35 TB/s; its least work is the recurrence's 4 N P flops
// per step and head, 8.59 GFLOP, 0.128 ms at 67 TFLOP/s of fp32. The
// chunked form does 15.0 GFLOP at kQ = 64 and moves the states' 536 MB
// (fp32) or 402 MB (bf16) on top, 0.16 or 0.12 ms: the price of running
// every chunk in parallel.
//
// What the design does about it:
//  * Every pass spans the chunks: n_chunks x B*H blocks (4,096 at that
//    width) in place of one block per (b, h) walking its chunks in order.
//    Only pass 2 walks the chunks, elementwise and memory-bound.
//  * The running sum of dt A is a warp-level scan. Each block puts all
//    its tile loads in flight at once (cp.async, 16 bytes each) before it
//    waits.
//  * bf16: the four chunk products run on the tensor cores as wgmma
//    m64n64k16 with fp32 accumulators, one warpgroup per block: a chunk's
//    64 steps are one 64-row tile. Operands are staged by cp.async into
//    128-byte swizzled tiles (sm90.cuh); C and B are K-major, X, h_in and
//    (B . w)^T MN-major (trans), and the masked decay matrix M goes from
//    G's accumulators to the register-A operand of M X without shared
//    memory. The operands computed in between are rounded to bf16 where
//    the products take them: B . w in pass 1, h_in in pass 2, M in pass 3.
//  * fp32: the same passes on CUDA-core FMA (one TF32 product misses the
//    JAX package's fp32 tolerance; the 3xTF32 split that
//    flash_attention_sm90_f32.cu uses would hold it on the tensor cores),
//    each thread a 4 x 4 to 8 x 8 register tile read from shared memory
//    in 16-byte vectors.
//  * exp(cum_i - cum_j) is taken only where j <= i: above the diagonal the
//    exponent is positive and may overflow to inf, and inf . 0 is NaN. In
//    fp32 the blocks of C B^T above the diagonal are not computed.
//  * P and N are padded with zeros in shared memory; the wrapper pads
//    nothing. No atomics and a fixed order of every sum: reruns are
//    bit-identical.
//
// The bf16 passes 1 and 2 and the helpers they share with the backward
// (ssd_scan_bwd_sm90.cu), which runs them again, live in ssd_chunk.cuh.
//
// Plain C interface, loaded with ctypes. The launches go to the caller's
// stream; nothing here allocates or synchronises: the caller passes the
// states' scratch. The entry point returns the cudaError_t of its launches
// (0 on success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "ssd_chunk.cuh"

namespace {

constexpr int kLdQ = kQ + 4;    // row stride of [*, kQ] fp32 tiles
constexpr int kFmaThreads = 256;

enum DType { kF32 = 0, kBF16 = 1 };

// rows [0, rows) x cols [0, wpad) of an fp32 slab whose row r starts at
// src + r * stride, into shared dst[r * ld + c]; zeros past nv rows or
// width columns. Where the rows are 16-byte aligned every thread puts all
// its copies in flight at once (cp.async; the caller waits with
// cp_async_wait), else plain loads. wpad and ld are multiples of 4.
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* src, int64_t stride,
                                           int width, int wpad, int rows,
                                           int nv) {
  if (width % 4 == 0 && stride % 4 == 0 &&
      reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const int vw = wpad / 4;
    for (int e = threadIdx.x; e < rows * vw; e += blockDim.x) {
      const int r = e / vw, c = (e % vw) * 4;
      const bool ok = r < nv && c < width;
      cp_async16(dst + r * ld + c, ok ? src + r * stride + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * wpad; e += blockDim.x) {
      const int r = e / wpad, c = e % wpad;
      dst[r * ld + c] = r < nv && c < width ? src[r * stride + c] : 0.f;
    }
  }
}

// ---- pass 1: chunk states ---------------------------------------------------

// fp32: S[n][p] = sum_j B[j][n] w_j X[j][p]; thread (ty, tx) holds n =
// 4 ty + 64 a + e, p = 4 tx + 64 c + f
__global__ void __launch_bounds__(kFmaThreads)
chunk_state_fma(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                float* __restrict__ states, float* __restrict__ totals,
                int64_t L, int64_t H, int64_t G, int P, int N) {
  extern __shared__ float4 smem4[];
  const int PP = round_up(P, 64), NP = round_up(N, 64);
  float* Xs = reinterpret_cast<float*>(smem4);  // [kQ][PP]
  float* Bs = Xs + kQ * PP;                     // [kQ][NP], then B . w
  float* dts = Bs + kQ * NP;
  float* cum = dts + kQ;
  float* ws = cum + kQ;
  const Chunk ch(L, H, G);
  stage_rows(Xs, PP, x + ((ch.b * L + ch.t0) * H + ch.h) * P, H * P, P, PP,
             kQ, ch.nv);
  stage_rows(Bs, NP, Bm + ((ch.b * L + ch.t0) * G + ch.g) * N, G * N, N, NP,
             kQ, ch.nv);
  stage_dt(dts, dt, ch, L, H);
  cp_async_wait();
  __syncthreads();
  chunk_cumsum(dts, A[ch.h], cum);
  __syncthreads();
  const float total = cum[kQ - 1];
  if (threadIdx.x < kQ)
    ws[threadIdx.x] = dts[threadIdx.x] * expf(total - cum[threadIdx.x]);
  __syncthreads();
  for (int e = threadIdx.x; e < kQ * NP; e += blockDim.x) Bs[e] *= ws[e / NP];
  __syncthreads();

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int na = NP / 64, nc = PP / 64;
  float acc[2][4][2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int f = 0; f < 4; ++f) acc[a][e][c][f] = 0.f;
#pragma unroll 4
  for (int j = 0; j < kQ; ++j) {
    float4 bv[2], xv[2];
#pragma unroll
    for (int a = 0; a < 2; ++a)
      if (a < na)
        bv[a] = *reinterpret_cast<const float4*>(Bs + j * NP + 4 * ty + 64 * a);
#pragma unroll
    for (int c = 0; c < 2; ++c)
      if (c < nc)
        xv[c] = *reinterpret_cast<const float4*>(Xs + j * PP + 4 * tx + 64 * c);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      if (a >= na) break;
      const float bs[4] = {bv[a].x, bv[a].y, bv[a].z, bv[a].w};
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (c >= nc) break;
        const float xs[4] = {xv[c].x, xv[c].y, xv[c].z, xv[c].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int f = 0; f < 4; ++f)
            acc[a][e][c][f] = fmaf(bs[e], xs[f], acc[a][e][c][f]);
      }
    }
  }
  float* S = states + (ch.bh * gridDim.x + blockIdx.x) * (int64_t)N * P;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 4 * ty + 64 * a + e;
      if (a >= na || n >= N) continue;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int p = 4 * tx + 64 * c;
        if (c >= nc || p >= P) continue;
        float* sp = S + n * P + p;
        if (P % 4 == 0)
          *reinterpret_cast<float4*>(sp) =
              make_float4(acc[a][e][c][0], acc[a][e][c][1], acc[a][e][c][2],
                          acc[a][e][c][3]);
        else
#pragma unroll
          for (int f = 0; f < 4; ++f)
            if (p + f < P) sp[f] = acc[a][e][c][f];
      }
    }
  if (threadIdx.x == 0) totals[ch.bh * gridDim.x + blockIdx.x] = total;
}

// ---- pass 3: chunk outputs ----------------------------------------------------

// fp32: G = C B^T and M = G . decay . dt (j <= i), thread (ty, tx) holding
// i = ty + 16 e, j = tx + 16 f (f <= e: the blocks above the diagonal
// stay 0); then y with i = ty + 16 e, p = 4 tx + 64 c + f. All tiles are
// row-major, read in 16-byte vectors along their rows. Once G is in
// registers, X and M take B's place in shared memory and X loads while the
// carry-in computes, so two blocks fit an SM at mamba2-1.3b width.
__host__ __device__ constexpr int out_fma_region(int N4, int PP) {
  return kQ * (N4 + 4) > kQ * (PP + kLdQ) ? kQ * (N4 + 4) : kQ * (PP + kLdQ);
}

__global__ void __launch_bounds__(kFmaThreads, 2)
chunk_output_fma(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, const float* __restrict__ hin,
                 float* __restrict__ y, int64_t L, int64_t H, int64_t G,
                 int P, int N) {
  extern __shared__ float4 smem4[];
  const int PP = round_up(P, 64), N4 = round_up(N, 4), ldn = N4 + 4;
  float* Cs = reinterpret_cast<float*>(smem4);  // [kQ][ldn]
  float* Bs = Cs + kQ * ldn;                    // [kQ][ldn], then X and M:
  float* Xs = Bs;                               //   [kQ][PP]
  float* Ms = Xs + kQ * PP;                     //   [kQ (i)][kLdQ (j)]
  float* Hs = Bs + out_fma_region(N4, PP);      // [N4][PP]
  float* dts = Hs + N4 * PP;
  float* cum = dts + kQ;
  const Chunk ch(L, H, G);
  const int64_t bg = (ch.b * L + ch.t0) * G + ch.g;
  stage_rows(Cs, ldn, Cm + bg * N, G * N, N, N4, kQ, ch.nv);
  stage_rows(Bs, ldn, Bm + bg * N, G * N, N, N4, kQ, ch.nv);
  stage_rows(Hs, PP, hin + (ch.bh * gridDim.x + blockIdx.x) * (int64_t)N * P,
             P, P, PP, N4, N);
  stage_dt(dts, dt, ch, L, H);
  cp_async_wait();
  __syncthreads();
  chunk_cumsum(dts, A[ch.h], cum);
  __syncthreads();

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float g[4][4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int f = 0; f < 4; ++f) g[e][f] = 0.f;
#pragma unroll 2
  for (int n = 0; n < N4; n += 4) {
    float4 cv[4], bv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      cv[e] = *reinterpret_cast<const float4*>(Cs + (ty + 16 * e) * ldn + n);
#pragma unroll
    for (int f = 0; f < 4; ++f)
      bv[f] = *reinterpret_cast<const float4*>(Bs + (tx + 16 * f) * ldn + n);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int f = 0; f <= e; ++f) {
        g[e][f] = fmaf(cv[e].x, bv[f].x, g[e][f]);
        g[e][f] = fmaf(cv[e].y, bv[f].y, g[e][f]);
        g[e][f] = fmaf(cv[e].z, bv[f].z, g[e][f]);
        g[e][f] = fmaf(cv[e].w, bv[f].w, g[e][f]);
      }
  }
  __syncthreads();   // B is read: its region takes X and M
  stage_rows(Xs, PP, x + ((ch.b * L + ch.t0) * H + ch.h) * P, H * P, P, PP,
             kQ, ch.nv);
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int i = ty + 16 * e, j = tx + 16 * f;
      Ms[i * kLdQ + j] =
          j <= i ? g[e][f] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
    }

  const int nc = PP / 64;
  float acc[4][2][4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int f = 0; f < 4; ++f) acc[e][c][f] = 0.f;
  // the carry-in: sum_n C[i][n] h_in[n][p], then . exp(cum_i)
#pragma unroll 2
  for (int n = 0; n < N4; n += 4) {
    float4 cv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      cv[e] = *reinterpret_cast<const float4*>(Cs + (ty + 16 * e) * ldn + n);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (c >= nc) break;
      float4 hv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        hv[u] = *reinterpret_cast<const float4*>(Hs + (n + u) * PP + 4 * tx +
                                                 64 * c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float cs[4] = {cv[e].x, cv[e].y, cv[e].z, cv[e].w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[e][c][0] = fmaf(cs[u], hv[u].x, acc[e][c][0]);
          acc[e][c][1] = fmaf(cs[u], hv[u].y, acc[e][c][1]);
          acc[e][c][2] = fmaf(cs[u], hv[u].z, acc[e][c][2]);
          acc[e][c][3] = fmaf(cs[u], hv[u].w, acc[e][c][3]);
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float d = expf(cum[ty + 16 * e]);
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int f = 0; f < 4; ++f) acc[e][c][f] *= d;
  }
  cp_async_wait();
  __syncthreads();   // X has landed and M is written
  // + M X, over j up to the thread's last row (M is 0 above the diagonal)
  const int j_end = min(kQ, (ty + 48 + 4) & ~3);
#pragma unroll 2
  for (int j = 0; j < j_end; j += 4) {
    float4 mv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mv[e] = *reinterpret_cast<const float4*>(Ms + (ty + 16 * e) * kLdQ + j);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (c >= nc) break;
      float4 xv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        xv[u] = *reinterpret_cast<const float4*>(Xs + (j + u) * PP + 4 * tx +
                                                 64 * c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ms[4] = {mv[e].x, mv[e].y, mv[e].z, mv[e].w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[e][c][0] = fmaf(ms[u], xv[u].x, acc[e][c][0]);
          acc[e][c][1] = fmaf(ms[u], xv[u].y, acc[e][c][1]);
          acc[e][c][2] = fmaf(ms[u], xv[u].z, acc[e][c][2]);
          acc[e][c][3] = fmaf(ms[u], xv[u].w, acc[e][c][3]);
        }
      }
    }
  }
  float* yb = y + ((ch.b * L + ch.t0) * H + ch.h) * P;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = ty + 16 * e;
    if (i >= ch.nv) continue;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int p = 4 * tx + 64 * c;
      if (c >= nc || p >= P) continue;
      float* yp = yb + i * H * P + p;
      if (P % 4 == 0)
        *reinterpret_cast<float4*>(yp) = make_float4(
            acc[e][c][0], acc[e][c][1], acc[e][c][2], acc[e][c][3]);
      else
#pragma unroll
        for (int f = 0; f < 4; ++f)
          if (p + f < P) yp[f] = acc[e][c][f];
    }
  }
}

// bf16 on wgmma, one warpgroup (warp w holds the steps i = 16 w + lane / 4
// and i + 8): G = C B^T (both K-major), M = G . decay . dt rounded to bf16
// in registers, where the accumulator layout of G is the register-A layout
// of M X; then per 64 columns of p the carry-in C h_in^T (h_in [n][p],
// MN-major), scaled by exp(cum_i), plus M X (X [j][p], MN-major).
__global__ void __launch_bounds__(kWgThreads)
chunk_output_wgmma(const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ dt, const float* __restrict__ A,
                   const __nv_bfloat16* __restrict__ Bm,
                   const __nv_bfloat16* __restrict__ Cm,
                   const __nv_bfloat16* __restrict__ hin,
                   __nv_bfloat16* __restrict__ y, int64_t L, int64_t H,
                   int64_t G, int P, int N) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const int NC = round_up(N, 64), PC = round_up(P, 64), NK = round_up(N, 16);
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(align1024(smem_raw));
  __nv_bfloat16* Bs = Cs + kQ * NC;   // [kQ][NC], swizzled, as Cs
  __nv_bfloat16* Xs = Bs + kQ * NC;   // [kQ][PC]
  __nv_bfloat16* Hs = Xs + kQ * PC;   // [NK][PC]
  float* dts = reinterpret_cast<float*>(Hs + NK * PC);
  float* cum = dts + kQ;
  const Chunk ch(L, H, G);
  const int64_t bg = (ch.b * L + ch.t0) * G + ch.g;
  stage_sw128(Cs, Cm + bg * N, G * N, N, NC, kQ, ch.nv);
  stage_sw128(Bs, Bm + bg * N, G * N, N, NC, kQ, ch.nv);
  stage_sw128(Xs, x + ((ch.b * L + ch.t0) * H + ch.h) * P, H * P, P, PC, kQ,
              ch.nv);
  stage_sw128(Hs, hin + (ch.bh * gridDim.x + blockIdx.x) * (int64_t)N * P, P,
              P, PC, NK, N);
  stage_dt(dts, dt, ch, L, H);
  cp_async_wait();
  fence_proxy_async();
  __syncthreads();
  chunk_cumsum(dts, A[ch.h], cum);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cq = lane % 4;
  const int i0 = 16 * warp + lane / 4, i1 = i0 + 8;
  const uint32_t cs = smem_u32(Cs), bs = smem_u32(Bs), xs = smem_u32(Xs),
                 hs = smem_u32(Hs);
  constexpr uint32_t kChunk = kQ * 128;   // bytes of a 64-column chunk
  const int nks = NK / 16;                // k-steps over n

  float g[32];
  wgmma_fence();
  for (int kk = 0; kk < nks; ++kk) {
    const uint32_t off = (kk / 4) * kChunk + (kk % 4) * 32;
    wgmma_ss_m64n64<0, 0>(g, make_desc(cs + off, 16, 1024, 1),
                          make_desc(bs + off, 16, 1024, 1), kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_operands(g);
  uint32_t ma[4][4];   // M as the A operand: k-step kk = steps 16 kk..+15
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e < 2 ? i0 : i1;
      const int j = 8 * nb + 2 * cq + (e & 1);
      v[e] = j <= i ? g[4 * nb + e] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
    }
    ma[nb / 2][(nb % 2) * 2] = pack_bf16(v[0], v[1]);       // rounding point
    ma[nb / 2][(nb % 2) * 2 + 1] = pack_bf16(v[2], v[3]);
  }

  const float d0 = expf(cum[i0]), d1 = expf(cum[i1]);
  __nv_bfloat16* yb = y + ((ch.b * L + ch.t0) * H + ch.h) * P;
  for (int pt = 0; pt < PC / 64; ++pt) {
    float acc[32];
    wgmma_fence();
    for (int kk = 0; kk < nks; ++kk)
      wgmma_ss_m64n64<0, 1>(
          acc,
          make_desc(cs + (kk / 4) * kChunk + (kk % 4) * 32, 16, 1024, 1),
          make_desc(hs + pt * NK * 128 + kk * 2048, NK * 128, 1024, 1),
          kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(acc);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      acc[4 * nb] *= d0;
      acc[4 * nb + 1] *= d0;
      acc[4 * nb + 2] *= d1;
      acc[4 * nb + 3] *= d1;
    }
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk)
      wgmma_rs_m64n64_tb(acc, ma[kk],
                         make_desc(xs + pt * kChunk + kk * 2048, kChunk, 1024,
                                   1));
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(acc);
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int hrow = 0; hrow < 2; ++hrow) {
        const int i = hrow ? i1 : i0;
        const int p = 64 * pt + 8 * nb + 2 * cq;
        if (i >= ch.nv || p >= P) continue;
        __nv_bfloat16* yp = yb + i * H * P + p;
        const float a0 = acc[4 * nb + 2 * hrow], a1 = acc[4 * nb + 2 * hrow + 1];
        if (P % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(yp) = __floats2bfloat162_rn(a0, a1);
        } else {
          yp[0] = __float2bfloat16(a0);
          if (p + 1 < P) yp[1] = __float2bfloat16(a1);
        }
      }
  }
}

// ---- launch -------------------------------------------------------------------

int launch_f32(const float* x, const float* dt, const float* A,
               const float* Bm, const float* Cm, float* y, float* hfinal,
               float* states, float* totals, int64_t B, int64_t L, int64_t H,
               int64_t G, int P, int N, cudaStream_t stream) {
  const int nc = (int)((L + kQ - 1) / kQ);
  const int PP = round_up(P, 64), NP = round_up(N, 64), N4 = round_up(N, 4);
  const size_t s1 = sizeof(float) * ((size_t)kQ * (PP + NP) + 3 * kQ);
  const size_t s3 = sizeof(float) * ((size_t)kQ * (N4 + 4) +
                                     out_fma_region(N4, PP) +
                                     (size_t)N4 * PP + 2 * kQ);
  int err = set_smem(chunk_state_fma, s1);
  if (!err) err = set_smem(chunk_output_fma, s3);
  if (err) return err;
  const dim3 grid((unsigned)nc, (unsigned)(B * H));
  chunk_state_fma<<<grid, kFmaThreads, s1, stream>>>(x, dt, A, Bm, states,
                                                     totals, L, H, G, P, N);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = launch_state_pass(states, totals, states, hfinal, B * H, nc, P,
                               N, stream)))
    return err;
  chunk_output_fma<<<grid, kFmaThreads, s3, stream>>>(x, dt, A, Bm, Cm,
                                                      states, y, L, H, G, P, N);
  return (int)cudaGetLastError();
}

int launch_bf16(const __nv_bfloat16* x, const float* dt, const float* A,
                const __nv_bfloat16* Bm, const __nv_bfloat16* Cm,
                __nv_bfloat16* y, float* hfinal, float* states,
                __nv_bfloat16* hin, float* totals, int64_t B, int64_t L,
                int64_t H, int64_t G, int P, int N, cudaStream_t stream) {
  const int nc = (int)((L + kQ - 1) / kQ);
  const int NC = round_up(N, 64), PC = round_up(P, 64), NK = round_up(N, 16);
  // 1,024 bytes of slack to align the swizzled tiles
  const size_t s1 = 1024 + 2 * (size_t)kQ * (NC + PC) + 4 * 3 * kQ;
  const size_t s3 = 1024 + 2 * ((size_t)2 * kQ * NC + (size_t)kQ * PC +
                                (size_t)NK * PC) + 4 * 2 * kQ;
  int err = set_smem(chunk_state_wgmma, s1);
  if (!err) err = set_smem(chunk_output_wgmma, s3);
  if (err) return err;
  const dim3 grid((unsigned)nc, (unsigned)(B * H));
  chunk_state_wgmma<<<grid, kWgThreads, s1, stream>>>(
      x, dt, A, Bm, states, totals, L, H, G, P, N);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = launch_state_pass(states, totals, hin, hfinal, B * H, nc, P, N,
                               stream)))
    return err;
  chunk_output_wgmma<<<grid, kWgThreads, s3, stream>>>(
      x, dt, A, Bm, Cm, hin, y, L, H, G, P, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// the steps per chunk. The scratch: `states` holds B * H * ceil(L /
// chunk) * N * P floats, `totals` B * H * ceil(L / chunk) floats, and for
// bf16 `hin` as many bf16 values as `states` floats (ignored for f32,
// whose states become h_in in place).
int ssd_scan_chunk() { return kQ; }

// x, y: [B, L, H, P]; dt: [B, L, H] f32; A: [H] f32; Bm, Cm: [B, L, G, N];
// all contiguous; x, Bm, Cm and y of one type (dtype 0 f32, 1 bf16); H a
// multiple of G; 1 <= P, N <= 128; B * H <= 65535; B * H * n_chunks <
// 2^31. h_final, f32 [B, H, P, N], receives the state after step L; null
// where the caller does not want it.
int ssd_scan_forward(const void* x, const void* dt, const void* A,
                     const void* Bm, const void* Cm, void* y, void* h_final,
                     void* states, void* hin, void* totals, int dtype,
                     int64_t B, int64_t L, int64_t H, int64_t G, int64_t P,
                     int64_t N, void* stream) {
  if (P < 1 || N < 1 || P > kMaxDim || N > kMaxDim ||
      B * H * ((L + kQ - 1) / kQ) >= (int64_t{1} << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* st = static_cast<float*>(states);
  float* tot = static_cast<float*>(totals);
  float* hf = static_cast<float*>(h_final);
  switch (dtype) {
    case kF32:
      return launch_f32(static_cast<const float*>(x), dtf, Af,
                        static_cast<const float*>(Bm),
                        static_cast<const float*>(Cm), static_cast<float*>(y),
                        hf, st, tot, B, L, H, G, (int)P, (int)N, s);
    case kBF16:
      return launch_bf16(static_cast<const __nv_bfloat16*>(x), dtf, Af,
                         static_cast<const __nv_bfloat16*>(Bm),
                         static_cast<const __nv_bfloat16*>(Cm),
                         static_cast<__nv_bfloat16*>(y), hf, st,
                         static_cast<__nv_bfloat16*>(hin), tot, B, L, H, G,
                         (int)P, (int)N, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
