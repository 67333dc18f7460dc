// The backward of the Mamba-2 SSD chunk scan for Hopper (sm_90a), bf16 on
// the tensor cores, in five passes over chunks with no atomics and every
// sum in a fixed order, so that reruns are bit-identical.
//
// The JAX package has no backward kernel: it trains mamba2 by XLA's
// autodiff of ssd_chunked (src/repro/models/ssm.py:85). This is the
// gradient of the port's bf16 forward, ssd_scan.cu (the port of the TPU
// Pallas kernel ssd_scan_bhl / _ssd_kernel, src/repro/kernels/ssd_scan/
// kernel.py:71, its pallas_call at :80), and it takes the place of the
// VJP of the chunked form in torch ops (kernels/ssd_scan/backward.py) on
// the card for bf16. For the recurrence of the forward,
//   h_t = exp(dt_t A_h) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t,
// and the cotangent dy [B, L, H, P] it computes dx [B, L, H, P], ddt
// [B, L, H], dA [H], dB and dC [B, L, G, N] (head h reads group
// g = h / (H / G)), on the forward's own chunks of kQ = 64 steps whatever
// chunk the caller names. Steps past L read as zeros (dt = 0), as in the
// forward, and their gradients are not written.
//
// Per chunk c, with cum the running sum of dt A inside it, T_c its last
// value, w_j = dt_j exp(T_c - cum_j), L[i][j] = exp(cum_i - cum_j) for
// j <= i (else 0), and h_in[c] the state entering the chunk:
//  0. chunk_state_wgmma, state_pass (ssd_chunk.cuh): the forward's passes
//     1 and 2 again, h_in rounded to bf16 as the forward rounds it;
//  1. chunk_dstate_wgmma: dh[c] = (C . e^cum)^T dY [N, P], the cotangent
//     of h_in[c] through the chunk's own carry-in term (C . e^cum rounded
//     to bf16, as B . w in pass 0); fp32, over pass 0's states;
//  2. state_pass_reverse: per state element, from the last chunk to the
//     first, dS_c = Gh[c + 1] and Gh[c] = dh[c] + exp(T_c) Gh[c + 1]
//     (Gh past the last chunk is 0: the final state has no cotangent);
//     dS rounded to bf16 (the products take it);
//  3. chunk_adjoint_wgmma, two warpgroups per (chunk, b, hb heads of one
//     group), every product on wgmma m64n64k16 with fp32 accumulators:
//       CB = C B^T, once for the block's heads (it has no head in it);
//     then per head, in head order: dM = dY X^T; M = CB . L . dt_j and
//     D = dM . L . dt_j rounded to bf16; Z = D . CB (fp32), its row and
//     column sums, and the column sums of dM . CB . L;
//       dX = M^T dY + w_j (B dS^T), dw_j = <x_j, (B dS^T)_j>;
//       dB = D^T C + w_j (X dS^T);
//       dC = D B + e^cum_i (dY h_in^T), and <dC's carry-in row, C_i>;
//       dT = exp(T_c) <h_in, dS> + sum_j dw_j w_j;
//       dcum = rowsum(Z) - colsum(Z) + the carry-in dots - dw . w;
//       da = the reverse running sum of dcum + dT, ddt = colsum(dM . CB
//       . L) + dw exp(T - cum) + A da, and the chunk's sum of dt . da;
//     the two terms of dX, of dB and of dC each go to the tensor cores as
//     one group. Warpgroup 0 takes the diagonal term while warpgroup 1
//     takes <h_in, dS>; then each takes every other 64-column tile of dC
//     and dB, and warpgroup 1 dX. dx and ddt are written once; dB and dC
//     are summed over the block's heads in fp32, in head order (each
//     thread's own floats in shared memory, in the warpgroup that takes the
//     tile), and written once a block: fp32 partials [B, L, G,
//     H / (G hb), N], or bf16 dB and dC where hb = H / G. B and C are
//     staged once a block, and the next head's X, dY, h_in, dS and dt by
//     cp.async into a second buffer while this head computes (where two
//     buffers fit in shared memory: at P = N = 128 one does);
//  4. group_sum (only where a group has more than one block): dB and dC
//     summed over a group's blocks in block order, so every head's terms
//     are summed in head order; dA_sum: dA_h summed over b and the chunks
//     in order.
// Each sum inside a block runs in a fixed order (warp shuffles in a fixed
// pattern, then the warps in order), so the result does not depend on
// the schedule.
//
// What bounds it: bytes. At mamba2-1.3b's training shape (B 2, L 4,096,
// H 64, P 64, N 128, G 1) the function reads x, dt, A, B, C and dy once
// and writes their gradients once: 213.9 MB, 0.064 ms at 3.35 TB/s; its
// least work, the recurrence's adjoint, 2 x 4 N P flops per step and
// head (0.035 ms at 989 TFLOP/s). This design moves more: the states
// (fp32 and bf16 h_in, dh and dS: 4 + 2 + 4 + 2 bytes per state element,
// 805 MB), B and C staged once per block (268 / hb MB), and the fp32
// partials of dB and dC (537 / hb MB written and read again). Why hb =
// kHeadsPerBlock = 16: at G = 1 all 64 heads share B and C, so dB and dC
// are 64-way sums; one head a block wrote them as 537 MB of per-head
// partials and staged the same B and C, and took the same CB, 64 times. A
// block that walked all 64 heads would leave 128 blocks for 132 SMs; 16
// heads leave 512, and ran fastest of 4, 8 and 16 (PERF.md).
//
// Tiles are staged by cp.async into 128-byte-swizzled shared memory
// (ssd_chunk.cuh); P and N are padded with zeros there, so the caller
// pads nothing. M and D go from their accumulators to shared memory as
// bf16 for the products that take them transposed (M^T dY, D^T C); D is
// also D B's K-major A operand.
//
// Plain C interface, loaded with ctypes. The launches go to the caller's
// stream; nothing here allocates or synchronises: the caller passes the
// outputs and the scratch. The entry point returns the cudaError_t of
// its launches (0 on success).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "ssd_chunk.cuh"

namespace {

constexpr int kReduceThreads = 256;
constexpr uint32_t kTile = kQ * 128;   // bytes of a 64-column chunk of kQ rows

// the byte offset of element (r, c) in a 128-byte-swizzled bf16 tile of
// `rows` rows (64-column chunks one after another)
__device__ __forceinline__ uint32_t sw128_offset(int rows, int r, int c) {
  return (uint32_t)(c / 64) * rows * 128 + r * 128 +
         ((((c % 64) / 8) ^ (r % 8)) << 4) + (c % 8) * 2;
}

// the bf16 pair at row r, columns c and c + 1 (c even) of such a tile
__device__ __forceinline__ float2 get_pair(const __nv_bfloat16* tile,
                                           int rows, int r, int c) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
      reinterpret_cast<const uint8_t*>(tile) + sw128_offset(rows, r, c)));
}

__device__ __forceinline__ void put_pair(__nv_bfloat16* tile, int rows,
                                         int r, int c, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<uint8_t*>(tile) +
                                     sw128_offset(rows, r, c)) =
      __floats2bfloat162_rn(a, b);
}

// every row j of a swizzled [kQ][cpad] bf16 tile times s[j], rounded to
// bf16 (a 16-byte vector lies in one row)
__device__ __forceinline__ void scale_rows(__nv_bfloat16* tile,
                                           const float* s, int cpad) {
  for (int e = threadIdx.x; e < kQ * cpad / 8; e += blockDim.x) {
    const float w = s[(e % (kQ * 8)) / 8];
    __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(tile) + 4 * e;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 f = __bfloat1622float2(v[u]);
      v[u] = __floats2bfloat162_rn(f.x * w, f.y * w);
    }
  }
}

// v summed over the four lanes of a quad (one accumulator row), in a
// fixed pattern
__device__ __forceinline__ float quad_sum(float v) {
#pragma unroll
  for (int w = 1; w < 4; w <<= 1) v += __shfl_xor_sync(0xffffffffu, v, w);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int w = 1; w < 32; w <<= 1) v += __shfl_xor_sync(0xffffffffu, v, w);
  return v;
}

// rows r0, r0 + 8 of a 64 x 64 fp32 accumulator (columns 64 ct + 8 nb +
// 2 cq + e % 2) to fp32 rows of `stride` elements: rows < nv, columns < W
__device__ __forceinline__ void store_f32(const float (&acc)[32], float* out,
                                          int64_t stride, int ct, int r0,
                                          int cq, int nv, int W) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int hrow = 0; hrow < 2; ++hrow) {
      const int r = r0 + 8 * hrow;
      const int c = 64 * ct + 8 * nb + 2 * cq;
      if (r >= nv || c >= W) continue;
      float* o = out + r * stride + c;
      const float a0 = acc[4 * nb + 2 * hrow], a1 = acc[4 * nb + 2 * hrow + 1];
      if (W % 2 == 0) {
        *reinterpret_cast<float2*>(o) = make_float2(a0, a1);
      } else {
        o[0] = a0;
        if (c + 1 < W) o[1] = a1;
      }
    }
}

// ---- 1. the state cotangent of each chunk ----------------------------------

// dh[n][p] = sum_j C[j][n] e^cum_j dY[j][p]: chunk_state_wgmma's product
// with C . e^cum in place of B . w and dY in place of X; written [N][P]
// per (b * H + h, chunk), the layout of the states
__global__ void __launch_bounds__(kWgThreads)
chunk_dstate_wgmma(const __nv_bfloat16* __restrict__ dy,
                   const float* __restrict__ dt, const float* __restrict__ A,
                   const __nv_bfloat16* __restrict__ Cm,
                   float* __restrict__ dh, int64_t L, int64_t H, int64_t G,
                   int P, int N) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const int NC = round_up(N, 64), PC = round_up(P, 64);
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(align1024(smem_raw));
  __nv_bfloat16* Ys = Cs + kQ * NC;                  // [kQ][PC], swizzled
  float* dts = reinterpret_cast<float*>(Ys + kQ * PC);
  float* cum = dts + kQ;
  float* es = cum + kQ;
  const Chunk ch(L, H, G);
  stage_sw128(Cs, Cm + ((ch.b * L + ch.t0) * G + ch.g) * N, G * N, N, NC, kQ,
              ch.nv);
  stage_sw128(Ys, dy + ((ch.b * L + ch.t0) * H + ch.h) * P, H * P, P, PC, kQ,
              ch.nv);
  stage_dt(dts, dt, ch, L, H);
  cp_async_wait();
  __syncthreads();
  chunk_cumsum(dts, A[ch.h], cum);
  __syncthreads();
  if (threadIdx.x < kQ) es[threadIdx.x] = expf(cum[threadIdx.x]);
  __syncthreads();
  scale_rows(Cs, es, NC);   // C . e^cum, rounded to bf16 (a rounding point)
  fence_proxy_async();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = 16 * warp + lane / 4, cq = lane % 4;
  const uint32_t cs = smem_u32(Cs), ys = smem_u32(Ys);
  float* D = dh + (ch.bh * gridDim.x + blockIdx.x) * (int64_t)N * P;
  for (int mt = 0; mt < NC / 64; ++mt)
    for (int pt = 0; pt < PC / 64; ++pt) {
      float acc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk)
        wgmma_ss_m64n64<1, 1>(
            acc, make_desc(cs + mt * kTile + kk * 2048, kTile, 1024, 1),
            make_desc(ys + pt * kTile + kk * 2048, kTile, 1024, 1), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(acc);
      // rows n = 64 mt + row (+ 8), columns p
      store_f32(acc, D + (int64_t)(64 * mt) * P, P, pt, row, cq, N - 64 * mt,
                P);
    }
}

// ---- 2. the reverse pass over the chunks ------------------------------------

// grid (ceil(N P / kPassThreads), B*H): per state element, from the last
// chunk to the first, ds[c] = Gh[c + 1] (bf16), Gh[c] = dh[c] + exp(T_c)
// Gh[c + 1]; dh and ds in the states' layout [B*H][nc][N*P]
__global__ void __launch_bounds__(kPassThreads)
state_pass_reverse(const float* __restrict__ dh,
                   const float* __restrict__ totals,
                   __nv_bfloat16* __restrict__ ds, int nc, int NPe) {
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= NPe) return;
  const int64_t base = blockIdx.y * nc * (int64_t)NPe + e;
  const float* s = dh + base;
  __nv_bfloat16* o = ds + base;
  const float* tot = totals + blockIdx.y * (int64_t)nc;
  constexpr int kInFlight = 8;
  float run = 0.f;
  for (int c1 = nc - 1; c1 >= 0; c1 -= kInFlight) {
    // every load of the batch (chunks c1, c1 - 1, ...) before its stores
    float v[kInFlight], d[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
      if (c1 - u >= 0) {
        v[u] = s[(c1 - u) * (int64_t)NPe];
        d[u] = tot[c1 - u];
      }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (c1 - u < 0) break;
      o[(c1 - u) * (int64_t)NPe] = __float2bfloat16(run);
      run = fmaf(expf(d[u]), run, v[u]);
    }
  }
}

// ---- 3. the adjoint of each chunk ---------------------------------------------

// the most heads of one group that a chunk_adjoint_wgmma block walks; a
// launch takes the largest power of 2 up to it that divides H / G
constexpr int kHeadsPerBlock = 16;
constexpr int kAdjThreads = 2 * kWgThreads;   // two warpgroups
constexpr size_t kMaxSmem = 232448;   // a block's dynamic shared memory

// the bytes of chunk_adjoint_wgmma's shared memory with `bufs` buffers of
// a head's tiles: 1,024 of slack to align the tiles; B, C [kQ][NC]; per
// buffer X, dY [kQ][PC] and h_in, dS [NC][PC]; M, D [kQ][kQ], all bf16;
// the fp32 sums of dB and dC over the block's heads, NC / 64 x 2 tiles of
// 32 floats for each thread of a warpgroup; a dt vector of kQ per buffer,
// 12 more float vectors of kQ and 4 floats
__host__ __device__ constexpr size_t adjoint_smem(int NC, int PC, int bufs) {
  return 1024 +
         2 * ((size_t)2 * kQ * NC +
              (size_t)bufs * (2 * kQ * PC + 2 * NC * PC) +
              (size_t)2 * kQ * kQ) +
         4 * ((size_t)NC / 64 * 2 * 32 * kWgThreads + (size_t)14 * kQ + 4);
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void zero(float (&acc)[32]) {
#pragma unroll
  for (int q = 0; q < 32; ++q) acc[q] = 0.f;
}

// the 64 x 64 accumulator tile nt (rows j, columns 64 nt + 8 nb + 2 cq +
// e % 2) to bf16 rows of `stride` elements: rows < nv, columns < W
__device__ __forceinline__ void store_bf16(const float (&acc)[32],
                                           __nv_bfloat16* out,
                                           int64_t stride, int ct, int r0,
                                           int cq, int nv, int W) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int hrow = 0; hrow < 2; ++hrow) {
      const int r = r0 + 8 * hrow;
      const int c = 64 * ct + 8 * nb + 2 * cq;
      if (r >= nv || c >= W) continue;
      __nv_bfloat16* o = out + r * stride + c;
      const float a0 = acc[4 * nb + 2 * hrow], a1 = acc[4 * nb + 2 * hrow + 1];
      if (W % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a0, a1);
      } else {
        o[0] = __float2bfloat16(a0);
        if (c + 1 < W) o[1] = __float2bfloat16(a1);
      }
    }
}

// grid (n_chunks, B * H / hb), two warpgroups: warp w of each holds the
// accumulator rows 16 w + lane / 4 and + 8, columns 8 nb + 2 (lane % 4) +
// e % 2. The block walks heads h0 .. h0 + hb - 1 of one group in order (h0
// a multiple of hb, which divides H / G). Per head, warpgroup 0 takes the
// diagonal term while warpgroup 1 takes <h_in, dS>; then warpgroup w takes
// the 64-column tiles nt = w, w + 2 of dC and dB, and warpgroup 1 dX. dB
// and dC are summed over the heads in fp32 in head order, a tile's sum
// kept by the warpgroup that takes it, and written once: to the fp32
// partials [B, L, G, H / (G hb), N] or, where hb = H / G, in bf16 to dB,
// dC [B, L, G, N].
__global__ void __launch_bounds__(kAdjThreads)
chunk_adjoint_wgmma(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ dt, const float* __restrict__ A,
                    const __nv_bfloat16* __restrict__ Bm,
                    const __nv_bfloat16* __restrict__ Cm,
                    const __nv_bfloat16* __restrict__ dy,
                    const __nv_bfloat16* __restrict__ hin,
                    const __nv_bfloat16* __restrict__ ds,
                    __nv_bfloat16* __restrict__ dx, float* __restrict__ ddt,
                    float* __restrict__ dB_part, float* __restrict__ dC_part,
                    __nv_bfloat16* __restrict__ dB,
                    __nv_bfloat16* __restrict__ dC,
                    float* __restrict__ dA_part, int64_t L, int64_t H,
                    int64_t G, int P, int N, int hb, int bufs) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const int NC = round_up(N, 64), PC = round_up(P, 64);
  const int NK = round_up(N, 16), PK = round_up(P, 16);
  const int per_buf = 2 * kQ * PC + 2 * NC * PC;   // a head's tiles
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(align1024(smem_raw));
  __nv_bfloat16* Cs = Bs + kQ * NC;      // C [i][n]
  __nv_bfloat16* heads = Cs + kQ * NC;   // [buffer]: X, dY, h_in, dS
  __nv_bfloat16* Ms = heads + bufs * per_buf;   // M [i][j]
  __nv_bfloat16* Ds = Ms + kQ * kQ;   // D = dM . L . dt [i][j]
  float* sums = reinterpret_cast<float*>(Ds + kQ * kQ);
  float* dtb = sums + NC / 64 * 2 * 32 * kWgThreads;   // [buffer][kQ]
  float* cum = dtb + 2 * kQ;
  float* ws = cum + kQ;       // w_j
  float* rowz = ws + kQ;      // sum_j Z[i][j]
  float* colz = rowz + kQ;    // sum_i Z[i][j]
  float* colw = colz + kQ;    // sum_i (dM . CB . L)[i][j]
  float* dcin = colw + kQ;    // [warpgroup][kQ]: the carry-in term of dcum_i
  float* dws = dcin + 2 * kQ;   // dw_j
  float* partz = dws + kQ;    // [2 halves][kQ]: column sums, warps 0-1 / 2-3
  float* partw = partz + 2 * kQ;
  float* red = partw + 2 * kQ;   // [4]: <h_in, dS> per warp

  const int64_t nc = gridDim.x, c = blockIdx.x;
  const int64_t blocks_b = H / hb;   // blocks of one batch row
  const int64_t b = blockIdx.y / blocks_b;
  const int64_t h0 = (blockIdx.y % blocks_b) * hb;
  const int64_t rep = H / G, g = h0 / rep;
  const int64_t n_part = rep / hb, part = (h0 % rep) / hb;
  const int64_t t0 = c * kQ;
  const int nv = static_cast<int>(L - t0 < kQ ? L - t0 : kQ);
  const int64_t bo = ((b * L + t0) * G + g) * N;
  // the block's first head: its rows of x, dy, dx, its dt and ddt, its
  // states; the next head's are P, 1, 1 and nc N P further on
  const int64_t xo = ((b * L + t0) * H + h0) * P;
  const int64_t to = (b * L + t0) * H + h0;
  const int64_t so = ((b * H + h0) * nc + c) * (int64_t)N * P;

  // head i's X, dY, h_in, dS and dt into buffer u, one cp.async group
  auto stage_head = [&](int i, int u) {
    __nv_bfloat16* Xs = heads + u * per_buf;
    const int64_t sh = so + i * nc * (int64_t)N * P;
    stage_sw128(Xs, x + xo + i * P, H * P, P, PC, kQ, nv);
    stage_sw128(Xs + kQ * PC, dy + xo + i * P, H * P, P, PC, kQ, nv);
    stage_sw128(Xs + 2 * kQ * PC, hin + sh, P, P, PC, NC, N);
    stage_sw128(Xs + 2 * kQ * PC + NC * PC, ds + sh, P, P, PC, NC, N);
    if (threadIdx.x < kQ) {
      const bool ok = (int)threadIdx.x < nv;
      cp_async4(dtb + u * kQ + threadIdx.x,
                ok ? dt + to + i + threadIdx.x * H : dt, ok);
    }
    cp_async_commit();
  };
  stage_sw128(Bs, Bm + bo, G * N, N, NC, kQ, nv);
  stage_sw128(Cs, Cm + bo, G * N, N, NC, kQ, nv);
  stage_head(0, 0);   // one group with B and C

  const int wg = threadIdx.x / kWgThreads, tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32, lane = tid % 32;
  const int cq = lane % 4;
  const int r0 = 16 * warp + lane / 4, r1 = r0 + 8;
  const uint32_t bs = smem_u32(Bs), cs = smem_u32(Cs), msa = smem_u32(Ms),
                 dsa = smem_u32(Ds);
  const uint32_t kState = NC * 128;   // bytes of a 64-column chunk of NC rows
  const int64_t rowBC = G * n_part * N;   // the partials' row stride
  float cb[32];   // CB = C B^T (rows i, columns j), the same for every head

  // head i's dB (which 0) or dC (1) tile nt in acc, added to the heads'
  // running sum before it (this thread's own floats in `sums`); the last
  // head writes the block's sum
  auto accumulate = [&](float (&acc)[32], int i, int nt, int which) {
    float* s = sums + (nt * 2 + which) * 32 * kWgThreads + tid;
    if (i > 0) {
#pragma unroll
      for (int q = 0; q < 32; ++q) acc[q] += s[q * kWgThreads];
    }
    if (i + 1 < hb) {
#pragma unroll
      for (int q = 0; q < 32; ++q) s[q * kWgThreads] = acc[q];
    } else if (n_part == 1) {
      store_bf16(acc, (which ? dC : dB) + bo, G * N, nt, r0, cq, nv, N);
    } else {
      store_f32(acc,
                (which ? dC_part : dB_part) +
                    ((b * L + t0) * G + g) * n_part * N + part * N,
                rowBC, nt, r0, cq, nv, N);
    }
  };

  // every accumulator is zeroed before its product: in this loop an
  // uninitialised one would read as carried from the last head, and keep
  // every accumulator's registers live across the loop
#pragma unroll 1
  for (int i = 0; i < hb; ++i) {
    const int u = bufs == 2 ? i & 1 : 0;
    const int64_t h = h0 + i;
    if (bufs == 2 && i + 1 < hb) {   // the next head's tiles, in flight
      stage_head(i + 1, u ^ 1);      // while this head computes
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_group<0>();
    }
    fence_proxy_async();
    __syncthreads();
    __nv_bfloat16* Xs = heads + u * per_buf;
    __nv_bfloat16* Ys = Xs + kQ * PC;   // dY [i][p]
    __nv_bfloat16* Hs = Ys + kQ * PC;   // h_in [n][p]
    __nv_bfloat16* Ss = Hs + NC * PC;   // dS [n][p]
    const float* dts = dtb + u * kQ;
    const uint32_t xs = smem_u32(Xs), ys = smem_u32(Ys), hs = smem_u32(Hs),
                   ss = smem_u32(Ss);
    chunk_cumsum(dts, A[h], cum);
    __syncthreads();
    const float total = cum[kQ - 1];
    if (threadIdx.x < kQ)
      ws[threadIdx.x] = dts[threadIdx.x] * expf(total - cum[threadIdx.x]);

    // -- warpgroup 0: the diagonal term, CB = C B^T (the first head) and
    // dM = dY X^T (rows i, columns j), one group
    if (wg == 0) {
      float m[32];
      zero(m);
      if (i == 0) zero(cb);
      fence_operands(m);
      fence_operands(cb);
      wgmma_fence();
      if (i == 0) {
        for (int kk = 0; kk < NK / 16; ++kk) {
          const uint32_t off = (kk / 4) * kTile + (kk % 4) * 32;
          wgmma_ss_m64n64<0, 0>(cb, make_desc(cs + off, 16, 1024, 1),
                                make_desc(bs + off, 16, 1024, 1), kk > 0);
        }
      }
      for (int kk = 0; kk < PK / 16; ++kk) {
        const uint32_t off = (kk / 4) * kTile + (kk % 4) * 32;
        wgmma_ss_m64n64<0, 0>(m, make_desc(ys + off, 16, 1024, 1),
                              make_desc(xs + off, 16, 1024, 1), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(cb);
      fence_operands(m);
      float rz0 = 0.f, rz1 = 0.f, cz[16], cw[16];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        float mv[4], dv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ii = e < 2 ? r0 : r1;
          const int j = 8 * nb + 2 * cq + (e & 1);
          const int at = 4 * nb + e;
          float z = 0.f, wz = 0.f;
          mv[e] = dv[e] = 0.f;
          if (j <= ii) {   // exp(cum_i - cum_j) overflows above the diagonal
            const float l = expf(cum[ii] - cum[j]);
            const float cbl = cb[at] * l;
            mv[e] = cbl * dts[j];
            dv[e] = m[at] * l * dts[j];
            z = dv[e] * cb[at];
            wz = m[at] * cbl;
          }
          if (e < 2)
            rz0 += z;
          else
            rz1 += z;
          if (e < 2) {
            cz[2 * nb + e] = z;
            cw[2 * nb + e] = wz;
          } else {
            cz[2 * nb + e - 2] += z;
            cw[2 * nb + e - 2] += wz;
          }
        }
        const int j = 8 * nb + 2 * cq;
        put_pair(Ms, kQ, r0, j, mv[0], mv[1]);   // rounding points
        put_pair(Ms, kQ, r1, j, mv[2], mv[3]);
        put_pair(Ds, kQ, r0, j, dv[0], dv[1]);
        put_pair(Ds, kQ, r1, j, dv[2], dv[3]);
      }
      rz0 = quad_sum(rz0);
      rz1 = quad_sum(rz1);
      if (cq == 0) {
        rowz[r0] = rz0;
        rowz[r1] = rz1;
      }
      // a column's 16 rows of this warp lie in the 8 lane groups lane / 4
#pragma unroll
      for (int cc = 0; cc < 16; ++cc)
#pragma unroll
        for (int w = 4; w < 32; w <<= 1) {
          cz[cc] += __shfl_xor_sync(0xffffffffu, cz[cc], w);
          cw[cc] += __shfl_xor_sync(0xffffffffu, cw[cc], w);
        }
      // warps 0 and 1 write their columns, then 2 and 3 add theirs in
      // order: (w0 + w2) + (w1 + w3) by half, a fixed order
      for (int half = 0; half < 2; ++half) {
        if (lane < 4 && warp / 2 == half) {
#pragma unroll
          for (int cc = 0; cc < 16; ++cc) {
            const int j = 8 * (cc / 2) + 2 * lane + (cc & 1);
            float* pz = partz + (warp % 2) * kQ + j;
            float* pw = partw + (warp % 2) * kQ + j;
            *pz = half ? *pz + cz[cc] : cz[cc];
            *pw = half ? *pw + cw[cc] : cw[cc];
          }
        }
        named_sync(1, kWgThreads);
      }
      if (threadIdx.x < kQ) {
        colz[threadIdx.x] = partz[threadIdx.x] + partz[kQ + threadIdx.x];
        colw[threadIdx.x] = partw[threadIdx.x] + partw[kQ + threadIdx.x];
      }
    } else {
      // -- warpgroup 1: <h_in, dS> over the chunk's state: both tiles share
      // one layout, so their 16-byte vectors pair up wherever they lie
      float hd = 0.f;
      for (int v = tid; v < NC * PC / 8; v += kWgThreads) {
        const uint4 hv = reinterpret_cast<const uint4*>(Hs)[v];
        const uint4 sv = reinterpret_cast<const uint4*>(Ss)[v];
        const __nv_bfloat162* h2 =
            reinterpret_cast<const __nv_bfloat162*>(&hv);
        const __nv_bfloat162* s2 =
            reinterpret_cast<const __nv_bfloat162*>(&sv);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 a = __bfloat1622float2(h2[q]),
                       bb = __bfloat1622float2(s2[q]);
          hd += a.x * bb.x + a.y * bb.y;
        }
      }
      hd = warp_sum(hd);
      if (lane == 0) red[warp] = hd;
    }
    fence_proxy_async();   // M and D, written by the threads, read by wgmma
    __syncthreads();

    // -- dC = D B + e^cum_i (dY h_in^T), per 64 columns of n (this
    // warpgroup's), both terms in one group; the carry-in term of dcum_i =
    // <e^cum_i (dY h_in^T)_i, C_i>
    const float e0 = expf(cum[r0]), e1 = expf(cum[r1]);
    const float w0 = ws[r0], w1 = ws[r1];
    float ci0 = 0.f, ci1 = 0.f;
    for (int nt = wg; nt < NC / 64; nt += 2) {
      float acc[32], t[32];
      zero(acc);
      zero(t);
      fence_operands(acc);
      fence_operands(t);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk)   // D [i][j], K-major; B MN-major
        wgmma_ss_m64n64<0, 1>(
            acc, make_desc(dsa + kk * 32, 16, 1024, 1),
            make_desc(bs + nt * kTile + kk * 2048, kTile, 1024, 1), kk > 0);
      for (int kk = 0; kk < PK / 16; ++kk)
        wgmma_ss_m64n64<0, 0>(
            t, make_desc(ys + (kk / 4) * kTile + (kk % 4) * 32, 16, 1024, 1),
            make_desc(hs + (kk / 4) * kState + nt * 64 * 128 + (kk % 4) * 32,
                      16, 1024, 1),
            kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(acc);
      fence_operands(t);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int n = 64 * nt + 8 * nb + 2 * cq;
        const float2 c0 = get_pair(Cs, kQ, r0, n), c1 = get_pair(Cs, kQ, r1, n);
        const float v0 = t[4 * nb] * e0, v1 = t[4 * nb + 1] * e0;
        const float v2 = t[4 * nb + 2] * e1, v3 = t[4 * nb + 3] * e1;
        ci0 += v0 * c0.x + v1 * c0.y;
        ci1 += v2 * c1.x + v3 * c1.y;
        acc[4 * nb] += v0;
        acc[4 * nb + 1] += v1;
        acc[4 * nb + 2] += v2;
        acc[4 * nb + 3] += v3;
      }
      accumulate(acc, i, nt, 1);
    }
    ci0 = quad_sum(ci0);
    ci1 = quad_sum(ci1);
    if (cq == 0) {
      dcin[wg * kQ + r0] = ci0;
      dcin[wg * kQ + r1] = ci1;
    }

    // -- dB = D^T C + w_j (X dS^T), per 64 columns of n (this
    // warpgroup's; rows j), both terms in one group
    for (int nt = wg; nt < NC / 64; nt += 2) {
      float acc[32], t[32];
      zero(acc);
      zero(t);
      fence_operands(acc);
      fence_operands(t);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk)
        wgmma_ss_m64n64<1, 1>(
            acc, make_desc(dsa + kk * 2048, kTile, 1024, 1),
            make_desc(cs + nt * kTile + kk * 2048, kTile, 1024, 1), kk > 0);
      for (int kk = 0; kk < PK / 16; ++kk)
        wgmma_ss_m64n64<0, 0>(
            t, make_desc(xs + (kk / 4) * kTile + (kk % 4) * 32, 16, 1024, 1),
            make_desc(ss + (kk / 4) * kState + nt * 64 * 128 + (kk % 4) * 32,
                      16, 1024, 1),
            kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(acc);
      fence_operands(t);
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        acc[4 * nb] += w0 * t[4 * nb];
        acc[4 * nb + 1] += w0 * t[4 * nb + 1];
        acc[4 * nb + 2] += w1 * t[4 * nb + 2];
        acc[4 * nb + 3] += w1 * t[4 * nb + 3];
      }
      accumulate(acc, i, nt, 0);
    }

    if (wg == 1) {
      // -- warpgroup 1: dX = M^T dY + w_j (B dS^T), per 64 columns of p
      // (rows j), both terms in one group; dw_j = <x_j, (B dS^T)_j>
      float dw0 = 0.f, dw1 = 0.f;
      __nv_bfloat16* dxb = dx + xo + i * P;
      for (int pt = 0; pt < PC / 64; ++pt) {
        float acc[32], t[32];
        zero(acc);
        zero(t);
        fence_operands(acc);
        fence_operands(t);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kQ / 16; ++kk)
          wgmma_ss_m64n64<1, 1>(
              acc, make_desc(msa + kk * 2048, kTile, 1024, 1),
              make_desc(ys + pt * kTile + kk * 2048, kTile, 1024, 1), kk > 0);
        for (int kk = 0; kk < NK / 16; ++kk)
          wgmma_ss_m64n64<0, 1>(
              t, make_desc(bs + (kk / 4) * kTile + (kk % 4) * 32, 16, 1024, 1),
              make_desc(ss + pt * kState + kk * 2048, kState, 1024, 1), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_operands(acc);
        fence_operands(t);
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
          const int p = 64 * pt + 8 * nb + 2 * cq;
          const float2 x0 = get_pair(Xs, kQ, r0, p), x1 = get_pair(Xs, kQ, r1, p);
          dw0 += x0.x * t[4 * nb] + x0.y * t[4 * nb + 1];
          dw1 += x1.x * t[4 * nb + 2] + x1.y * t[4 * nb + 3];
          acc[4 * nb] += w0 * t[4 * nb];
          acc[4 * nb + 1] += w0 * t[4 * nb + 1];
          acc[4 * nb + 2] += w1 * t[4 * nb + 2];
          acc[4 * nb + 3] += w1 * t[4 * nb + 3];
        }
        store_bf16(acc, dxb, H * P, pt, r0, cq, nv, P);
      }
      dw0 = quad_sum(dw0);
      dw1 = quad_sum(dw1);
      if (cq == 0) {
        dws[r0] = dw0;
        dws[r1] = dw1;
      }
    }
    __syncthreads();   // dcin, dws, red

    // -- finish, by the first warp: lane l holds steps 2 l and 2 l + 1
    if (threadIdx.x < 32) {
      const int l = threadIdx.x;
      const float hds = (red[0] + red[1]) + (red[2] + red[3]);
      float dc[2], dwv[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int k = 2 * l + q;
        dwv[q] = dws[k] * ws[k];
        dc[q] = rowz[k] - colz[k] + (dcin[k] + dcin[kQ + k]) - dwv[q];
      }
      const float dT = expf(total) * hds + warp_sum(dwv[0] + dwv[1]);
      // da_k = sum_{i >= k} dcum_i + dT: a suffix sum over the lanes
      float suf = dc[0] + dc[1];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float nx = __shfl_down_sync(0xffffffffu, suf, o);
        if (l + o < 32) suf += nx;
      }
      float after = __shfl_down_sync(0xffffffffu, suf, 1);   // lanes > l
      if (l == 31) after = 0.f;
      const float da1 = after + dc[1] + dT;
      const float da0 = after + dc[1] + dc[0] + dT;
      const float a = A[h];
      float sdA = 0.f;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int k = 2 * l + q;
        const float dak = q ? da1 : da0;
        sdA += dts[k] * dak;
        if (k < nv)
          ddt[to + i + k * H] =
              colw[k] + dws[k] * expf(total - cum[k]) + a * dak;
      }
      sdA = warp_sum(sdA);
      if (l == 0) dA_part[(b * H + h0 + i) * nc + c] = sdA;
    }
    // every thread is done with this head's vectors, M, D and tiles
    __syncthreads();
    if (bufs == 1 && i + 1 < hb) stage_head(i + 1, 0);
  }
}

// ---- 4. the sums over blocks and chunks -----------------------------------------

// grid (ceil(rows N / kReduceThreads), 2): out[row][n] = sum over the
// group's n_part head blocks, in order, of part[row * n_part + r][n], to
// bf16; y = 0 for dB, 1 for dC. A row is (b * L + t) * G + g.
__global__ void __launch_bounds__(kReduceThreads)
group_sum(const float* __restrict__ dB_part,
          const float* __restrict__ dC_part, __nv_bfloat16* __restrict__ dB,
          __nv_bfloat16* __restrict__ dC, int64_t rows, int n_part, int N) {
  const int64_t e = blockIdx.x * (int64_t)kReduceThreads + threadIdx.x;
  if (e >= rows * N) return;
  const float* part = blockIdx.y ? dC_part : dB_part;
  const float* p = part + (e / N) * n_part * N + e % N;
  float s = 0.f;
  for (int r = 0; r < n_part; ++r) s += p[r * (int64_t)N];
  (blockIdx.y ? dC : dB)[e] = __float2bfloat16(s);
}

// dA[h] = sum over b, then the chunks, in order, of part[(b * H + h) nc + c]
__global__ void __launch_bounds__(kReduceThreads)
dA_sum(const float* __restrict__ part, float* __restrict__ dA, int64_t B,
       int64_t H, int nc) {
  const int64_t h = blockIdx.x * (int64_t)kReduceThreads + threadIdx.x;
  if (h >= H) return;
  float s = 0.f;
  for (int64_t b = 0; b < B; ++b)
    for (int c = 0; c < nc; ++c) s += part[(b * H + h) * nc + c];
  dA[h] = s;
}

// the heads an adjoint block walks: the largest power of 2 up to
// kHeadsPerBlock that divides H / G
int heads_per_block(int64_t H, int64_t G) {
  int hb = kHeadsPerBlock;
  while ((H / G) % hb) hb /= 2;
  return hb;
}

int launch(const __nv_bfloat16* x, const float* dt, const float* A,
           const __nv_bfloat16* Bm, const __nv_bfloat16* Cm,
           const __nv_bfloat16* dy, __nv_bfloat16* dx, float* ddt, float* dA,
           __nv_bfloat16* dB, __nv_bfloat16* dC, float* states, float* totals,
           __nv_bfloat16* hin, __nv_bfloat16* ds, float* dB_part,
           float* dC_part, float* dA_part, int64_t B, int64_t L, int64_t H,
           int64_t G, int P, int N, cudaStream_t stream) {
  const int nc = (int)((L + kQ - 1) / kQ);
  const int NC = round_up(N, 64), PC = round_up(P, 64);
  const int hb = heads_per_block(H, G);
  const int n_part = (int)(H / G / hb);
  // the forward's pass-1 tiles, 1,024 bytes of slack to align them
  const size_t s_state = 1024 + 2 * (size_t)kQ * (NC + PC) + 4 * 3 * kQ;
  // two buffers of a head's tiles where they fit, so that the next head's
  // load overlaps this head's products
  const int bufs = adjoint_smem(NC, PC, 2) <= kMaxSmem ? 2 : 1;
  const size_t s_adj = adjoint_smem(NC, PC, bufs);
  int err = set_smem(chunk_state_wgmma, s_state);
  if (!err) err = set_smem(chunk_dstate_wgmma, s_state);
  if (!err) err = set_smem(chunk_adjoint_wgmma, s_adj);
  if (err) return err;
  const dim3 grid((unsigned)nc, (unsigned)(B * H));
  // 0. the states entering each chunk, as the forward rounds them
  chunk_state_wgmma<<<grid, kWgThreads, s_state, stream>>>(
      x, dt, A, Bm, states, totals, L, H, G, P, N);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = launch_state_pass(states, totals, hin, (float*)nullptr, B * H,
                               nc, P, N, stream)))
    return err;
  // 1. each chunk's dh, over the states pass 0 no longer needs
  chunk_dstate_wgmma<<<grid, kWgThreads, s_state, stream>>>(
      dy, dt, A, Cm, states, L, H, G, P, N);
  if ((err = (int)cudaGetLastError())) return err;
  // 2. dS, from the last chunk to the first
  const int NPe = P * N;
  state_pass_reverse<<<dim3((unsigned)((NPe + kPassThreads - 1) /
                                       kPassThreads),
                            (unsigned)(B * H)),
                       kPassThreads, 0, stream>>>(states, totals, ds, nc,
                                                  NPe);
  if ((err = (int)cudaGetLastError())) return err;
  // 3. the adjoint of every chunk, hb heads a block
  chunk_adjoint_wgmma<<<dim3((unsigned)nc, (unsigned)(B * H / hb)),
                        kAdjThreads, s_adj, stream>>>(
      x, dt, A, Bm, Cm, dy, hin, ds, dx, ddt, dB_part, dC_part, dB, dC,
      dA_part, L, H, G, P, N, hb, bufs);
  if ((err = (int)cudaGetLastError())) return err;
  // 4. the sums over each group's head blocks (none where one block walks
  // the whole group), and dA's over b and the chunks
  if (n_part > 1) {
    const int64_t rows = B * L * G;
    group_sum<<<dim3((unsigned)((rows * N + kReduceThreads - 1) /
                                kReduceThreads),
                     2),
                kReduceThreads, 0, stream>>>(dB_part, dC_part, dB, dC, rows,
                                             n_part, N);
    if ((err = (int)cudaGetLastError())) return err;
  }
  dA_sum<<<(unsigned)((H + kReduceThreads - 1) / kReduceThreads),
           kReduceThreads, 0, stream>>>(dA_part, dA, B, H, nc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// the steps per chunk. The scratch, n_chunks = ceil(L / chunk): `states`
// B * H * n_chunks * N * P floats, `totals` and `dA_part` B * H * n_chunks
// floats, `hin` and `ds` B * H * n_chunks * N * P bf16 values, `dB_part`
// and `dC_part` B * L * (H / heads per block) * N floats (not written
// where the heads per block are H / G).
int ssd_scan_bwd_sm90_chunk() { return kQ; }

// the heads of one group that an adjoint block walks, for H heads in G
// groups (H a multiple of G)
int ssd_scan_bwd_sm90_heads_per_block(int64_t H, int64_t G) {
  return heads_per_block(H, G);
}

// x, dy, dx: [B, L, H, P] bf16; dt, ddt: [B, L, H] f32; A, dA: [H] f32;
// Bm, Cm, dB, dC: [B, L, G, N] bf16; all contiguous, 16-byte aligned; H a
// multiple of G; 1 <= P, N <= 128; B * H <= 65535; B * H * n_chunks <
// 2^31; B * L * G * N < 2^31 * 256.
int ssd_scan_bwd_sm90_backward(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, const void* dy,
                               void* dx, void* ddt, void* dA, void* dB,
                               void* dC, void* states, void* totals,
                               void* hin, void* ds, void* dB_part,
                               void* dC_part, void* dA_part, int64_t B,
                               int64_t L, int64_t H, int64_t G, int64_t P,
                               int64_t N, void* stream) {
  if (P < 1 || N < 1 || P > kMaxDim || N > kMaxDim || G < 1 || H % G ||
      B * H > 65535 || B * H * ((L + kQ - 1) / kQ) >= (int64_t{1} << 31))
    return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  return launch(static_cast<const bf*>(x), static_cast<const float*>(dt),
                static_cast<const float*>(A), static_cast<const bf*>(Bm),
                static_cast<const bf*>(Cm), static_cast<const bf*>(dy),
                static_cast<bf*>(dx), static_cast<float*>(ddt),
                static_cast<float*>(dA), static_cast<bf*>(dB),
                static_cast<bf*>(dC), static_cast<float*>(states),
                static_cast<float*>(totals), static_cast<bf*>(hin),
                static_cast<bf*>(ds), static_cast<float*>(dB_part),
                static_cast<float*>(dC_part), static_cast<float*>(dA_part), B,
                L, H, G, (int)P, (int)N, static_cast<cudaStream_t>(stream));
}

const char* ssd_scan_bwd_sm90_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
