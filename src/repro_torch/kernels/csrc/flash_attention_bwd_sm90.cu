// The backward of causal flash attention for Hopper (sm_90a), bf16 on the
// tensor cores: FlashAttention-2/3's backward on wgmma, fed by TMA, in two
// passes with no atomics, so that reruns are bit-identical.
//
// The JAX package has no backward kernel: its language models train by
// XLA's autodiff of chunked_attention (src/repro/models/layers.py:132).
// This is the gradient of the port's bf16 forward, flash_attention_sm90.cu
// (the port of the TPU Pallas kernel flash_attention_bhsd / _flash_kernel,
// src/repro/kernels/flash_attention/kernel.py:87, its pallas_call at
// :109), and it takes the place of the blockwise formula in torch ops
// (kernels/flash_attention/backward.py) on the card for bf16. From q, do
// [B, Sq, H, d] and k, v [B, Skv, KV, d] it computes
//   S = q k^T, P = softmax(S * scale) under the forward's mask,
//   dP = do v^T, D = rowsum(P * dP), dS = P * (dP - D) * scale,
//   dq = dS k, dk = sum over the H / KV query heads of dS^T q,
//   dv = sum over them of P^T do,
// with GQA by index, the right-aligned causal mask (query i sees key
// j <= i + Skv - Sq), rows past Sq and keys past Skv read as zeros through
// TMA's out-of-bounds fill and masked, and a row that sees no key given
// P = 0, so its dq is exactly 0.
//
// Rounding points, those of the formula: S and dP are fp32 sums of bf16
// products (bf16 wgmma, fp32 accumulators); the softmax, lse, D and every
// accumulator are fp32; P and dS are rounded to bf16 as the A operands of
// dV, dK and dQ; dq, dk and dv are rounded to bf16 once, at the end. D is
// rowsum(P * dP) from the same fp32 dP it is subtracted from, never
// rowsum(do * o) with the bf16 output, which left bf16 error in dP - D.
//
// What bounds it: operations. At qwen3-1.7b's training shape (B 2, S
// 4,096, H 16, KV 8, d 128, causal) the function is 2.5 times the
// forward's products over the kept (query, key) pairs, 343.5 GFLOP, or
// 0.347 ms at the card's 989 TFLOP/s of dense bf16; q, k, v, do read once
// (100.7 MB) and dq, dk, dv written once (67.1 MB) are 167.8 MB (0.050 ms
// at 3.35 TB/s). This
// design runs nine products of the forward's size, 619 GFLOP: pass 1 five
// (S and dP twice, dQ), pass 2 four (S^T, dV, dP^T, dK). Atomics on dQ
// would save three of them and make the sums' order depend on the
// schedule; chip_smoke's dist phase compares two training steps to 1e-6
// and reads 0.0, so the order is kept fixed instead. FlashAttention-3's
// deterministic backward, which keeps the order with counters and takes
// dQ in pass 2 (seven products), ran slower than this on the card: its
// fp32 dQ accumulator (67 MB at that shape, more than L2) is read and
// written by every key tile in turn, and the key tiles wait on one
// another (PERF.md).
//
// The design:
//  * Pass 1, flash_bwd_dq: one CTA per (b * H + h, tile of 128 queries),
//    two consumer warpgroups of 64 query rows and one producer warpgroup
//    whose one thread starts every TMA copy (setmaxnreg: 24 registers for
//    the producer, 240 for the consumers), as in the forward. The producer
//    loads the Q and dO tiles once and streams K and V tiles of kBN1 = 128
//    keys through a 2-stage ring twice, one sweep after the other (128
//    keys a tile ran 0.83 times as long as 64). Sweep 1: S = Q K^T and
//    dP = dO V^T (wgmma m64n128k16, both operands in shared memory), the
//    online max m and sum l as the forward keeps them, and
//    Dacc = Dacc exp(m_old - m_new) + sum_j exp(s_j - m_new) dP_j, so that
//    D = Dacc / l is rowsum(P * dP) in fp32 without a second pass; then
//    lse = m * scale + log l (base 2, as the kernel's exp2). Sweep 2:
//    S and dP again, P = exp2(S * scale * log2 e - lse), dS in registers,
//    whose accumulator layout is already the register-A layout of
//    dQ += dS K (wgmma m64n{d}k16, K the MN-major B operand). lse and D go
//    to fp32 scratch [B, H, Sq_pad] for pass 2; dq to the model layout.
//  * Pass 2, flash_bwd_dkdv: one CTA per (b * KV + kv, tile of 128 keys),
//    two consumer warpgroups of 64 keys each, K and V in shared memory for
//    the whole CTA. The producer streams Q and dO tiles of 64 queries,
//    with their 64 lse and D values (a plain bulk copy), for every query
//    head of the KV head, and only the query tiles whose rows see the key
//    tile. S^T = K Q^T and dP^T = V dO^T put P^T and dS^T in the
//    accumulator layout that dV += P^T dO and dK += dS^T Q take as their
//    register A operand. dK and dV stay in fp32 registers across the query
//    heads and tiles, so the GQA sum needs no atomics.
//  * Tiles are stored with TMA's 128-byte swizzle (64-byte at 32 columns)
//    that wgmma reads without conflicts; d = 16 loads 32-column boxes over
//    the 16 columns of the tensor, whose out-of-bounds fill zeroes the
//    other 16 in shared memory, and runs as d = 32 (the zero columns add
//    nothing to S or dP; the columns past d of dq, dk, dv are not
//    written).
//  * Only tiles on the causal diagonal or on a ragged edge are masked; the
//    tiles past a tile's causal frontier are never loaded. Pass 1 launches
//    its query tiles last first and pass 2 its key tiles first first: the
//    heaviest CTAs start first.
//
// Plain C interface, loaded with ctypes. cuTensorMapEncodeTiled is reached
// at run time through the runtime's entry-point query (tma.cuh). Both
// passes go to the caller's stream; nothing here allocates or
// synchronises: the caller passes the outputs and the lse and D scratch.
// The entry point returns 0 on success, a cudaError_t, or kEncodeFailed +
// the CUresult of a refused tensor map.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "tma.cuh"

namespace {

constexpr int kConsumers = 2;   // consumer warpgroups of 64 rows
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kBM1 = 128;       // pass 1: queries per CTA
constexpr int kBN1 = 128;       // pass 1: keys per tile (64 or 128)
constexpr int kStages1 = 2;     // pass 1: K/V ring depth
constexpr int kBN2 = 128;       // pass 2: keys per CTA
constexpr int kBM2 = 64;        // pass 2: queries per tile
constexpr int kStages2 = 2;     // pass 2: Q/dO ring depth
constexpr float kLog2e = 1.4426950408889634f;

// the tiles of one head dim in shared memory: kDT columns (d, or 32 at
// d = 16), each row split into chunks of one swizzle span (128 bytes, or
// 64 at 32 columns) stored one after another; a tile of R rows is
// [chunk][R][kSwBytes]
template <int D>
struct Tile {
  static constexpr int kDT = D < 32 ? 32 : D;
  static constexpr int kSwBytes = kDT * 2 >= 128 ? 128 : kDT * 2;
  static constexpr int kCW = kSwBytes / 2;          // columns per chunk
  static constexpr int kChunks = kDT / kCW;
  static constexpr uint32_t kLayout = kSwBytes == 128 ? 1 : 2;  // B128, B64
  __host__ __device__ static constexpr int bytes(int rows) {
    return rows * kDT * 2;
  }

  // K-major operand (d the depth) of 64 rows at `base` inside a tile of
  // `rows` rows: k-step kk of 16 columns
  __device__ static uint64_t kmajor(uint32_t base, int rows, int kk) {
    const int c = kk * 16 / kCW;
    const int off = (kk * 16 % kCW) * 2;
    return make_desc(base + c * rows * kSwBytes + off, 16, 8 * kSwBytes,
                     kLayout);
  }
  // MN-major B operand (the tile's rows the depth, d the width) of a tile
  // of `rows` rows: k-step kk of 16 rows
  __device__ static uint64_t mnmajor(uint32_t base, int rows, int kk) {
    return make_desc(base + kk * 16 * kSwBytes, rows * kSwBytes,
                     8 * kSwBytes, kLayout);
  }
};

// a 64 x N fp32 product of two K-major operands from shared memory
template <int N>
__device__ void wgmma_kk(float (&d)[N / 2], uint64_t a, uint64_t b,
                         int scale_d);
template <>
__device__ __forceinline__ void wgmma_kk<64>(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  wgmma_ss_m64n64<0, 0>(d, a, b, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_kk<128>(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  wgmma_ss_m64n128(d, a, b, scale_d);
}

__device__ __forceinline__ void init_barriers(uint32_t bar_once,
                                              uint32_t bar_full,
                                              uint32_t bar_empty,
                                              int stages) {
  if (threadIdx.x == 0) {
    mbar_init(bar_once, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// a 64 x D fp32 accumulator (rows r and r + 8 of each thread, columns
// 8 j + 2 cq) to bf16 rows of `stride` elements, rows < n_rows, columns
// < D
template <int D, int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N],
                                           __nv_bfloat16* base,
                                           int64_t stride, int r, int n_rows,
                                           int cq) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * cq;
    if (r < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(base + r * stride + col) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    if (r + 8 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(base + (r + 8) * stride + col) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// ---- pass 1: lse, D and dq ------------------------------------------------
// grid (B * H, ceil(Sq / kBM1)), block kThreads
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq(const __grid_constant__ CUtensorMap map_q,
             const __grid_constant__ CUtensorMap map_do,
             const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v,
             __nv_bfloat16* __restrict__ dq, float* __restrict__ lse_out,
             float* __restrict__ d_out, int H, int KV, int Sq, int Skv,
             int sq_pad, int causal, float scale) {
  using T = Tile<D>;
  constexpr int kQB = T::bytes(kBM1);    // the Q (and dO) tile
  constexpr int kKB = T::bytes(kBN1);    // a K (and V) tile
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  const uint32_t sDO = sQ + kQB;
  const uint32_t sK = sDO + kQB;                   // [stage]
  const uint32_t sV = sK + kStages1 * kKB;         // [stage]
  const uint32_t bar_q = sV + kStages1 * kKB;
  const uint32_t bar_full = bar_q + 8;             // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages1;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM1;   // heaviest first
  const int q_offset = Skv - Sq;
  const int k_end = causal ? min(Skv, q0 + kBM1 + q_offset) : Skv;
  const int n_kt = k_end > 0 ? (k_end + kBN1 - 1) / kBN1 : 0;

  init_barriers(bar_q, bar_full, bar_empty, kStages1);

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread starts every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(bar_q, 2 * kQB);
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c) {
        tma_load_4d(sQ + c * kBM1 * T::kSwBytes, &map_q, c * T::kCW, h, q0,
                    b, bar_q);
        tma_load_4d(sDO + c * kBM1 * T::kSwBytes, &map_do, c * T::kCW, h,
                    q0, b, bar_q);
      }
      // the key tiles twice: sweep 1, then sweep 2
      for (int t = 0; t < 2 * n_kt; ++t) {
        const int s = t % kStages1;
        if (t >= kStages1)   // the consumers released tile t - kStages1
          mbar_wait(bar_empty + 8 * s, ((t / kStages1) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * kKB);
        const int k0 = (t % n_kt) * kBN1;
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c) {
          const int off = s * kKB + c * kBN1 * T::kSwBytes;
          tma_load_4d(sK + off, &map_k, c * T::kCW, kvh, k0, b, full);
          tma_load_4d(sV + off, &map_v, c * T::kCW, kvh, k0, b, full);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int cq = lane % 4;
    const int first_row = q0 + wg * 64;                 // of the warpgroup
    const int row0 = first_row + warp * 16 + lane / 4;  // and row0 + 8
    // the key tiles with a key that some row of this warpgroup sees
    const int my_end = causal ? min(Skv, first_row + 64 + q_offset) : Skv;
    const int my_kt = my_end > 0 ? (my_end + kBN1 - 1) / kBN1 : 0;
    const float scale_log2 = scale * kLog2e;

    float acc[T::kDT / 2];
#pragma unroll
    for (int i = 0; i < T::kDT / 2; ++i) acc[i] = 0.f;
    // per row (row0, row0 + 8): running max, this lane's partial sums of
    // p and of p * dP; after sweep 1 the row's lse (base 2) and D
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    float r0 = 0.f, r1 = 0.f, lse0 = 0.f, lse1 = 0.f, dd0 = 0.f, dd1 = 0.f;
    const uint32_t qa = sQ + wg * 64 * T::kSwBytes;
    const uint32_t da = sDO + wg * 64 * T::kSwBytes;

    mbar_wait(bar_q, 0);
    for (int t = 0; t < 2 * n_kt; ++t) {
      const int s = t % kStages1;
      const int kt = t % n_kt;
      const bool sweep2 = t >= n_kt;
      if (t == n_kt) {
        // end of sweep 1: the four lanes of a quad hold a row's partials
#pragma unroll
        for (int w = 1; w < 4; w <<= 1) {
          l0 += __shfl_xor_sync(0xffffffffu, l0, w);
          l1 += __shfl_xor_sync(0xffffffffu, l1, w);
          r0 += __shfl_xor_sync(0xffffffffu, r0, w);
          r1 += __shfl_xor_sync(0xffffffffu, r1, w);
        }
        // a row that sees no key: lse 0, D 0, and P = 0 below
        lse0 = l0 > 0.f ? m0 * scale_log2 + log2f(l0) : 0.f;
        lse1 = l1 > 0.f ? m1 * scale_log2 + log2f(l1) : 0.f;
        dd0 = l0 > 0.f ? r0 / l0 : 0.f;
        dd1 = l1 > 0.f ? r1 / l1 : 0.f;
      }
      mbar_wait(bar_full + 8 * s, (t / kStages1) & 1);
      if (kt < my_kt) {
        // S = Q K^T and dP = dO V^T: 64 x kBN1 each, d deep
        float sc[kBN1 / 2], dp[kBN1 / 2];
        const uint32_t kb = sK + s * kKB, vb = sV + s * kKB;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < T::kDT / 16; ++kk)
          wgmma_kk<kBN1>(sc, T::kmajor(qa, kBM1, kk), T::kmajor(kb, kBN1, kk),
                         kk > 0);
#pragma unroll
        for (int kk = 0; kk < T::kDT / 16; ++kk)
          wgmma_kk<kBN1>(dp, T::kmajor(da, kBM1, kk), T::kmajor(vb, kBN1, kk),
                         kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_operands(sc);
        fence_operands(dp);

        // sc[4i + e]: row row0 (+8 for e >= 2), key k0 + 8i + 2cq + (e & 1)
        const int k0 = kt * kBN1;
        if (k0 + kBN1 > Skv ||
            (causal && k0 + kBN1 - 1 > first_row + q_offset)) {
#pragma unroll
          for (int i = 0; i < kBN1 / 8; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = k0 + 8 * i + 2 * cq + (e & 1);
              const int row = row0 + (e >= 2 ? 8 : 0);
              if (key >= Skv || (causal && key > row + q_offset))
                sc[4 * i + e] = -INFINITY;
            }
        }
        if (!sweep2) {
          float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
          for (int i = 0; i < kBN1 / 8; ++i) {
            mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
            mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
          }
#pragma unroll
          for (int w = 1; w < 4; w <<= 1) {
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
          }
          const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
          // a row that has seen no key yet keeps p = 0 and alpha = 0
          const float ms0 = mn0 == -INFINITY ? 0.f : mn0 * scale_log2;
          const float ms1 = mn1 == -INFINITY ? 0.f : mn1 * scale_log2;
          const float al0 = exp2f(m0 * scale_log2 - ms0);
          const float al1 = exp2f(m1 * scale_log2 - ms1);
          m0 = mn0;
          m1 = mn1;
          float ps0 = 0.f, ps1 = 0.f, pd0 = 0.f, pd1 = 0.f;
#pragma unroll
          for (int i = 0; i < kBN1 / 8; ++i) {
            const float p0 = exp2f(fmaf(sc[4 * i], scale_log2, -ms0));
            const float p1 = exp2f(fmaf(sc[4 * i + 1], scale_log2, -ms0));
            const float p2 = exp2f(fmaf(sc[4 * i + 2], scale_log2, -ms1));
            const float p3 = exp2f(fmaf(sc[4 * i + 3], scale_log2, -ms1));
            ps0 += p0 + p1;
            ps1 += p2 + p3;
            pd0 += p0 * dp[4 * i] + p1 * dp[4 * i + 1];
            pd1 += p2 * dp[4 * i + 2] + p3 * dp[4 * i + 3];
          }
          l0 = l0 * al0 + ps0;
          l1 = l1 * al1 + ps1;
          r0 = r0 * al0 + pd0;
          r1 = r1 * al1 + pd1;
        } else {
          // dS = P (dP - D) scale, to bf16 as dQ's register A operand:
          // the accumulator of keys 16kk..16kk+15 is k-step kk's fragment
          uint32_t pa[kBN1 / 16][4];
#pragma unroll
          for (int i = 0; i < kBN1 / 8; ++i) {
            const float p0 = exp2f(fmaf(sc[4 * i], scale_log2, -lse0));
            const float p1 = exp2f(fmaf(sc[4 * i + 1], scale_log2, -lse0));
            const float p2 = exp2f(fmaf(sc[4 * i + 2], scale_log2, -lse1));
            const float p3 = exp2f(fmaf(sc[4 * i + 3], scale_log2, -lse1));
            pa[i / 2][(i % 2) * 2] =
                pack_bf16(p0 * (dp[4 * i] - dd0) * scale,
                          p1 * (dp[4 * i + 1] - dd0) * scale);
            pa[i / 2][(i % 2) * 2 + 1] =
                pack_bf16(p2 * (dp[4 * i + 2] - dd1) * scale,
                          p3 * (dp[4 * i + 3] - dd1) * scale);
          }
          // dQ += dS K: K [kBN1 keys][d], d contiguous (MN-major, trans-b)
          fence_operands(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBN1 / 16; ++kk)
            wgmma_rs_tb<T::kDT>(acc, pa[kk], T::mnmajor(kb, kBN1, kk));
          wgmma_commit();
          wgmma_wait_all();
          fence_operands(acc);
        }
      }
      mbar_arrive(bar_empty + 8 * s);   // this thread is done with stage s
    }

    if (cq == 0) {   // every row of the tile, < sq_pad
      const int64_t at = static_cast<int64_t>(bh) * sq_pad + row0;
      lse_out[at] = lse0;
      lse_out[at + 8] = lse1;
      d_out[at] = dd0;
      d_out[at + 8] = dd1;
    }
    store_rows<D>(acc, dq + (static_cast<int64_t>(b) * Sq * H + h) * D,
                  static_cast<int64_t>(H) * D, row0, Sq, cq);
  }
}

// ---- pass 2: dk and dv ----------------------------------------------------
// grid (B * KV, ceil(Skv / kBN2)), block kThreads
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv(const __grid_constant__ CUtensorMap map_q,
               const __grid_constant__ CUtensorMap map_do,
               const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v,
               const float* __restrict__ lse, const float* __restrict__ dd,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               int H, int KV, int Sq, int Skv, int sq_pad, int causal,
               float scale) {
  using T = Tile<D>;
  constexpr int kQB = T::bytes(kBM2);    // a Q (and dO) tile
  constexpr int kKB = T::bytes(kBN2);    // the K (and V) tile
  constexpr int kStat = 2 * kBM2 * 4;    // a tile's lse and D
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023) & ~1023u;
  const uint32_t sV = sK + kKB;
  const uint32_t sQ = sV + kKB;                    // [stage]
  const uint32_t sDO = sQ + kStages2 * kQB;        // [stage]
  const uint32_t sStat = sDO + kStages2 * kQB;     // [stage][lse 64, D 64]
  const uint32_t bar_kv = sStat + kStages2 * kStat;
  const uint32_t bar_full = bar_kv + 8;            // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages2;

  const int bkv = blockIdx.x;
  const int b = bkv / KV, kvh = bkv % KV;
  const int rep = H / KV;
  const int k0 = blockIdx.y * kBN2;   // under causal the first keys weigh most
  const int q_offset = Skv - Sq;
  const int n_qt = (Sq + kBM2 - 1) / kBM2;
  // the first query tile with a row that sees a key of this CTA
  const int qt_first = causal ? max(0, k0 - q_offset) / kBM2 : 0;
  const int per_head = n_qt - qt_first;   // >= 1: the last query sees all
  const int n_it = rep * per_head;

  init_barriers(bar_kv, bar_full, bar_empty, kStages2);

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(bar_kv, 2 * kKB);
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c) {
        tma_load_4d(sK + c * kBN2 * T::kSwBytes, &map_k, c * T::kCW, kvh, k0,
                    b, bar_kv);
        tma_load_4d(sV + c * kBN2 * T::kSwBytes, &map_v, c * T::kCW, kvh, k0,
                    b, bar_kv);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages2;
        if (it >= kStages2)
          mbar_wait(bar_empty + 8 * s, ((it / kStages2) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * s;
        const int h = kvh * rep + it / per_head;
        const int q0 = (qt_first + it % per_head) * kBM2;
        mbar_expect_tx(full, 2 * kQB + kStat);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c) {
          const int off = s * kQB + c * kBM2 * T::kSwBytes;
          tma_load_4d(sQ + off, &map_q, c * T::kCW, h, q0, b, full);
          tma_load_4d(sDO + off, &map_do, c * T::kCW, h, q0, b, full);
        }
        const int64_t at = (static_cast<int64_t>(b) * H + h) * sq_pad + q0;
        bulk_load(sStat + s * kStat, lse + at, kBM2 * 4, full);
        bulk_load(sStat + s * kStat + kBM2 * 4, dd + at, kBM2 * 4, full);
      }
    }
  } else {
    // ---- consumers: 64 keys each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int cq = lane % 4;
    const int first_key = k0 + wg * 64;                  // of the warpgroup
    const int key0 = first_key + warp * 16 + lane / 4;   // and key0 + 8
    const int my_qt = causal ? max(0, first_key - q_offset) / kBM2 : 0;
    const float scale_log2 = scale * kLog2e;

    float dk_acc[T::kDT / 2], dv_acc[T::kDT / 2];
#pragma unroll
    for (int i = 0; i < T::kDT / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    const uint32_t ka = sK + wg * 64 * T::kSwBytes;
    const uint32_t va = sV + wg * 64 * T::kSwBytes;

    mbar_wait(bar_kv, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kStages2;
      const int qt = qt_first + it % per_head;
      mbar_wait(bar_full + 8 * s, (it / kStages2) & 1);
      if (qt >= my_qt) {
        // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries, d deep
        float st[32], dpt[32];
        const uint32_t qb = sQ + s * kQB, dob = sDO + s * kQB;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < T::kDT / 16; ++kk)
          wgmma_ss_m64n64<0, 0>(st, T::kmajor(ka, kBN2, kk),
                                T::kmajor(qb, kBM2, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < T::kDT / 16; ++kk)
          wgmma_ss_m64n64<0, 0>(dpt, T::kmajor(va, kBN2, kk),
                                T::kmajor(dob, kBM2, kk), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_operands(st);
        fence_operands(dpt);

        // st[4i + e]: key key0 (+8 for e >= 2), query q0 + 8i + 2cq + (e & 1)
        const int q0 = qt * kBM2;
        if (q0 + kBM2 > Sq || first_key + 64 > Skv ||
            (causal && first_key + 63 > q0 + q_offset)) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int query = q0 + 8 * i + 2 * cq + (e & 1);
              const int key = key0 + (e >= 2 ? 8 : 0);
              if (query >= Sq || key >= Skv ||
                  (causal && key > query + q_offset))
                st[4 * i + e] = -INFINITY;
            }
        }
        // P^T = exp2(S^T scale log2 e - lse), dS^T = P^T (dP^T - D) scale,
        // both to bf16 as the register A operands of dV and dK
        const float* stat = reinterpret_cast<const float*>(
            smem_raw + (sStat + s * kStat - raw));
        uint32_t pa[4][4], dsa[4][4];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float2 L =
              *reinterpret_cast<const float2*>(stat + 8 * i + 2 * cq);
          const float2 Dv =
              *reinterpret_cast<const float2*>(stat + kBM2 + 8 * i + 2 * cq);
          const float p0 = exp2f(fmaf(st[4 * i], scale_log2, -L.x));
          const float p1 = exp2f(fmaf(st[4 * i + 1], scale_log2, -L.y));
          const float p2 = exp2f(fmaf(st[4 * i + 2], scale_log2, -L.x));
          const float p3 = exp2f(fmaf(st[4 * i + 3], scale_log2, -L.y));
          pa[i / 2][(i % 2) * 2] = pack_bf16(p0, p1);
          pa[i / 2][(i % 2) * 2 + 1] = pack_bf16(p2, p3);
          dsa[i / 2][(i % 2) * 2] =
              pack_bf16(p0 * (dpt[4 * i] - Dv.x) * scale,
                        p1 * (dpt[4 * i + 1] - Dv.y) * scale);
          dsa[i / 2][(i % 2) * 2 + 1] =
              pack_bf16(p2 * (dpt[4 * i + 2] - Dv.x) * scale,
                        p3 * (dpt[4 * i + 3] - Dv.y) * scale);
        }
        // dV += P^T dO and dK += dS^T Q: dO, Q [64 queries][d], d
        // contiguous (MN-major, trans-b)
        fence_operands(dv_acc);
        fence_operands(dk_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBM2 / 16; ++kk)
          wgmma_rs_tb<T::kDT>(dv_acc, pa[kk], T::mnmajor(dob, kBM2, kk));
#pragma unroll
        for (int kk = 0; kk < kBM2 / 16; ++kk)
          wgmma_rs_tb<T::kDT>(dk_acc, dsa[kk], T::mnmajor(qb, kBM2, kk));
        wgmma_commit();
        wgmma_wait_all();
        fence_operands(dv_acc);
        fence_operands(dk_acc);
      }
      mbar_arrive(bar_empty + 8 * s);
    }

    const int64_t stride = static_cast<int64_t>(KV) * D;
    const int64_t at = (static_cast<int64_t>(b) * Skv * KV + kvh) * D;
    store_rows<D>(dk_acc, dk + at, stride, key0, Skv, cq);
    store_rows<D>(dv_acc, dv + at, stride, key0, Skv, cq);
  }
}

// a 4-D map of a [B, S, heads, D] bf16 tensor (d, heads, rows, batch)
// whose box is one chunk of `rows` rows of one head; at D = 16 the box is
// 32 columns wide and TMA fills the 16 past the tensor with zeros
template <int D>
int make_map(CUtensorMap* map, const void* ptr, int64_t B, int64_t S,
             int64_t heads, int rows) {
  using T = Tile<D>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(D * 2),
                                 (cuuint64_t)(heads * D * 2),
                                 (cuuint64_t)(S * heads * D * 2)};
  const cuuint32_t box[4] = {(cuuint32_t)T::kCW, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      T::kSwBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                         : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           void* dq, void* dk, void* dv, float* lse, float* dd, int64_t B,
           int64_t H, int64_t KV, int64_t Sq, int64_t Skv, int causal,
           float scale, cudaStream_t stream) {
  using T = Tile<D>;
  CUtensorMap q1, do1, k1, v1, q2, do2, k2, v2;
  int err = make_map<D>(&q1, q, B, Sq, H, kBM1);
  if (!err) err = make_map<D>(&do1, dout, B, Sq, H, kBM1);
  if (!err) err = make_map<D>(&k1, k, B, Skv, KV, kBN1);
  if (!err) err = make_map<D>(&v1, v, B, Skv, KV, kBN1);
  if (!err) err = make_map<D>(&q2, q, B, Sq, H, kBM2);
  if (!err) err = make_map<D>(&do2, dout, B, Sq, H, kBM2);
  if (!err) err = make_map<D>(&k2, k, B, Skv, KV, kBN2);
  if (!err) err = make_map<D>(&v2, v, B, Skv, KV, kBN2);
  if (err) return err;
  const int sq_pad = (int)((Sq + kBM1 - 1) / kBM1 * kBM1);
  // 1,024 bytes of slack to align the tiles, the tiles, the mbarriers
  const int smem1 =
      1024 + 2 * T::bytes(kBM1) + 2 * kStages1 * T::bytes(kBN1) + 64;
  const int smem2 = 1024 + 2 * T::bytes(kBN2) +
                    kStages2 * (2 * T::bytes(kBM2) + 2 * kBM2 * 4) + 64;
  auto pass1 = flash_bwd_dq<D>;
  auto pass2 = flash_bwd_dkdv<D>;
  cudaError_t e = cudaFuncSetAttribute(
      pass1, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        pass2, cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (e != cudaSuccess) return (int)e;
  pass1<<<dim3((unsigned)(B * H), (unsigned)(sq_pad / kBM1)), kThreads, smem1,
          stream>>>(q1, do1, k1, v1, static_cast<__nv_bfloat16*>(dq), lse, dd,
                    (int)H, (int)KV, (int)Sq, (int)Skv, sq_pad, causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  pass2<<<dim3((unsigned)(B * KV), (unsigned)((Skv + kBN2 - 1) / kBN2)),
          kThreads, smem2, stream>>>(
      q2, do2, k2, v2, lse, dd, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), (int)H, (int)KV, (int)Sq, (int)Skv,
      sq_pad, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// the queries of one pass-1 CTA: its grid's y extent is ceil(Sq / this),
// and the lse and D scratch rows are Sq rounded up to it
int flash_attention_bwd_sm90_query_tile() { return kBM1; }

// the keys of one pass-2 CTA: its grid's y extent is ceil(Skv / this)
int flash_attention_bwd_sm90_key_tile() { return kBN2; }

// q, dout, dq: [B, Sq, H, d]; k, v, dk, dv: [B, Skv, KV, d]; all contiguous
// bf16, 16-byte aligned; lse, dd: fp32 scratch [B, H, Sq_pad], Sq_pad = Sq
// rounded up to the query tile, 16-byte aligned; d in {16, 32, 64, 128};
// H a multiple of KV; 1 <= Sq, Skv < 2^31; ceil(Sq / query tile) and
// ceil(Skv / key tile) <= 65535. scale multiplies q . k.
int flash_attention_bwd_sm90_backward(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      void* dq, void* dk, void* dv,
                                      float* lse, float* dd, int64_t B,
                                      int64_t H, int64_t KV, int64_t Sq,
                                      int64_t Skv, int64_t d, int causal,
                                      float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return launch<16>(q, k, v, dout, dq, dk, dv, lse, dd, B, H, KV, Sq, Skv,
                        causal, scale, s);
    case 32:
      return launch<32>(q, k, v, dout, dq, dk, dv, lse, dd, B, H, KV, Sq, Skv,
                        causal, scale, s);
    case 64:
      return launch<64>(q, k, v, dout, dq, dk, dv, lse, dd, B, H, KV, Sq, Skv,
                        causal, scale, s);
    case 128:
      return launch<128>(q, k, v, dout, dq, dk, dv, lse, dd, B, H, KV, Sq,
                         Skv, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_bwd_sm90_error_string(int err) {
  if (err >= kEncodeFailed) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
