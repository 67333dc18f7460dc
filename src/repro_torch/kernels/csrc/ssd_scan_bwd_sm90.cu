// The backward of the Mamba-2 SSD chunk scan for Hopper (sm_90a), bf16 on
// the tensor cores, in five passes over chunks with no atomics, so that
// reruns are bit-identical.
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
//  3. chunk_adjoint_wgmma, one warpgroup per (chunk, b * H + h), every
//     product on wgmma m64n64k16 with fp32 accumulators:
//       CB = C B^T, dM = dY X^T; M = CB . L . dt_j and D = dM . L . dt_j
//       rounded to bf16; Z = D . CB (fp32), its row and column sums, and
//       the column sums of dM . CB . L;
//       dX = M^T dY + w_j (B dS^T), dw_j = <x_j, (B dS^T)_j>;
//       dB = D^T C + w_j (X dS^T);
//       dC = D B + e^cum_i (dY h_in^T), and <dC's carry-in row, C_i>;
//       dT = exp(T_c) <h_in, dS> + sum_j dw_j w_j;
//       dcum = rowsum(Z) - colsum(Z) + the carry-in dots - dw . w;
//       da = the reverse running sum of dcum + dT, ddt = colsum(dM . CB
//       . L) + dw exp(T - cum) + A da, and the chunk's sum of dt . da;
//     dx and ddt are written once; dB and dC go to fp32 partials per head;
//  4. group_sum: dB and dC summed over each group's heads in head order;
//     dA_sum: dA_h summed over b and the chunks in order.
// Each sum inside a block runs in a fixed order (warp shuffles in a fixed
// pattern, then the warps in order), so the result does not depend on
// the schedule.
//
// What bounds it: bytes. At mamba2-1.3b's training shape (B 2, L 4,096,
// H 64, P 64, N 128, G 1) the function reads x, dt, A, B, C and dy once
// and writes their gradients once: 213.9 MB, 0.064 ms at 3.35 TB/s; its
// least work, the recurrence's adjoint, 2 x 4 N P flops per step and
// head (0.035 ms at 989 TFLOP/s). This design moves far more: the states
// (fp32 and bf16 h_in, dh and dS: 4 + 2 + 4 + 2 bytes per state element,
// 805 MB) and the per-head fp32 partials of dB and dC (537 MB written and
// read again). Why per-head partials: at G = 1 all 64 heads share B and
// C, so dB and dC are 64-way sums; a block that looped over a group's
// heads would leave 128 blocks for 132 SMs at that shape, where the
// partials keep 8,192 blocks in flight and cost two passes over 537 MB.
//
// Tiles are staged by cp.async into 128-byte-swizzled shared memory
// (ssd_chunk.cuh); P and N are padded with zeros there, so the caller
// pads nothing. M and D go from their accumulators to shared memory as
// bf16 for the products that take them transposed (M^T dY, D^T C); D is
// also D B's register A operand.
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

// the bytes of chunk_adjoint_wgmma's shared memory: 1,024 of slack to
// align the tiles; X, dY [kQ][PC], B, C [kQ][NC], h_in, dS [NC][PC], M, D
// [kQ][kQ] in bf16; 12 float vectors of kQ and 4 floats
__host__ __device__ constexpr size_t adjoint_smem(int NC, int PC) {
  return 1024 + 2 * ((size_t)2 * kQ * PC + (size_t)2 * kQ * NC +
                     (size_t)2 * NC * PC + (size_t)2 * kQ * kQ) +
         4 * ((size_t)12 * kQ + 4);
}

// grid (n_chunks, B*H), one warpgroup: warp w holds the accumulator rows
// 16 w + lane / 4 and + 8, columns 8 nb + 2 (lane % 4) + e % 2
__global__ void __launch_bounds__(kWgThreads)
chunk_adjoint_wgmma(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ dt, const float* __restrict__ A,
                    const __nv_bfloat16* __restrict__ Bm,
                    const __nv_bfloat16* __restrict__ Cm,
                    const __nv_bfloat16* __restrict__ dy,
                    const __nv_bfloat16* __restrict__ hin,
                    const __nv_bfloat16* __restrict__ ds,
                    __nv_bfloat16* __restrict__ dx, float* __restrict__ ddt,
                    float* __restrict__ dB_part, float* __restrict__ dC_part,
                    float* __restrict__ dA_part, int64_t L, int64_t H,
                    int64_t G, int P, int N) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const int NC = round_up(N, 64), PC = round_up(P, 64);
  const int NK = round_up(N, 16), PK = round_up(P, 16);
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(align1024(smem_raw));
  __nv_bfloat16* Ys = Xs + kQ * PC;   // dY [i][p]
  __nv_bfloat16* Bs = Ys + kQ * PC;   // B [j][n]
  __nv_bfloat16* Cs = Bs + kQ * NC;   // C [i][n]
  __nv_bfloat16* Hs = Cs + kQ * NC;   // h_in [n][p]
  __nv_bfloat16* Ss = Hs + NC * PC;   // dS [n][p]
  __nv_bfloat16* Ms = Ss + NC * PC;   // M [i][j]
  __nv_bfloat16* Ds = Ms + kQ * kQ;   // D = dM . L . dt [i][j]
  float* dts = reinterpret_cast<float*>(Ds + kQ * kQ);
  float* cum = dts + kQ;
  float* ws = cum + kQ;       // w_j
  float* rowz = ws + kQ;      // sum_j Z[i][j]
  float* colz = rowz + kQ;    // sum_i Z[i][j]
  float* colw = colz + kQ;    // sum_i (dM . CB . L)[i][j]
  float* dcin = colw + kQ;    // the carry-in term of dcum_i
  float* dws = dcin + kQ;     // dw_j
  float* partz = dws + kQ;    // [2 halves][kQ]: column sums, warps 0-1 / 2-3
  float* partw = partz + 2 * kQ;
  float* red = partw + 2 * kQ;   // [4]: <h_in, dS> per warp

  const Chunk ch(L, H, G);
  const int64_t xo = ((ch.b * L + ch.t0) * H + ch.h) * P;
  const int64_t bo = ((ch.b * L + ch.t0) * G + ch.g) * N;
  const int64_t so = (ch.bh * gridDim.x + blockIdx.x) * (int64_t)N * P;
  stage_sw128(Xs, x + xo, H * P, P, PC, kQ, ch.nv);
  stage_sw128(Ys, dy + xo, H * P, P, PC, kQ, ch.nv);
  stage_sw128(Bs, Bm + bo, G * N, N, NC, kQ, ch.nv);
  stage_sw128(Cs, Cm + bo, G * N, N, NC, kQ, ch.nv);
  stage_sw128(Hs, hin + so, P, P, PC, NC, N);
  stage_sw128(Ss, ds + so, P, P, PC, NC, N);
  stage_dt(dts, dt, ch, L, H);
  cp_async_wait();
  fence_proxy_async();
  __syncthreads();
  chunk_cumsum(dts, A[ch.h], cum);
  __syncthreads();
  const float total = cum[kQ - 1];
  if (threadIdx.x < kQ)
    ws[threadIdx.x] = dts[threadIdx.x] * expf(total - cum[threadIdx.x]);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cq = lane % 4;
  const int r0 = 16 * warp + lane / 4, r1 = r0 + 8;
  const uint32_t xs = smem_u32(Xs), ys = smem_u32(Ys), bs = smem_u32(Bs),
                 cs = smem_u32(Cs), hs = smem_u32(Hs), ss = smem_u32(Ss),
                 msa = smem_u32(Ms), dsa = smem_u32(Ds);
  const uint32_t kState = NC * 128;   // bytes of a 64-column chunk of NC rows

  // -- the diagonal term: CB = C B^T and dM = dY X^T (rows i, columns j)
  uint32_t da[4][4];   // D as the register A operand of D B
  {
    float g[32], m[32];
    wgmma_fence();
    for (int kk = 0; kk < NK / 16; ++kk) {
      const uint32_t off = (kk / 4) * kTile + (kk % 4) * 32;
      wgmma_ss_m64n64<0, 0>(g, make_desc(cs + off, 16, 1024, 1),
                            make_desc(bs + off, 16, 1024, 1), kk > 0);
    }
    for (int kk = 0; kk < PK / 16; ++kk) {
      const uint32_t off = (kk / 4) * kTile + (kk % 4) * 32;
      wgmma_ss_m64n64<0, 0>(m, make_desc(ys + off, 16, 1024, 1),
                            make_desc(xs + off, 16, 1024, 1), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(g);
    fence_operands(m);
    float rz0 = 0.f, rz1 = 0.f, cz[16], cw[16];
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      float mv[4], dv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? r0 : r1;
        const int j = 8 * nb + 2 * cq + (e & 1);
        const int at = 4 * nb + e;
        float z = 0.f, wz = 0.f;
        mv[e] = dv[e] = 0.f;
        if (j <= i) {   // exp(cum_i - cum_j) overflows above the diagonal
          const float l = expf(cum[i] - cum[j]);
          const float cbl = g[at] * l;
          mv[e] = cbl * dts[j];
          dv[e] = m[at] * l * dts[j];
          z = dv[e] * g[at];
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
      da[nb / 2][(nb % 2) * 2] = pack_bf16(dv[0], dv[1]);
      da[nb / 2][(nb % 2) * 2 + 1] = pack_bf16(dv[2], dv[3]);
    }
    rz0 = quad_sum(rz0);
    rz1 = quad_sum(rz1);
    if (cq == 0) {
      rowz[r0] = rz0;
      rowz[r1] = rz1;
    }
    // a column's 16 rows of this warp lie in the 8 lane groups lane / 4
#pragma unroll
    for (int c = 0; c < 16; ++c)
#pragma unroll
      for (int w = 4; w < 32; w <<= 1) {
        cz[c] += __shfl_xor_sync(0xffffffffu, cz[c], w);
        cw[c] += __shfl_xor_sync(0xffffffffu, cw[c], w);
      }
    // warps 0 and 1 write their columns, then 2 and 3 add theirs in
    // order: (w0 + w2) + (w1 + w3) by half, a fixed order
    for (int half = 0; half < 2; ++half) {
      if (lane < 4 && warp / 2 == half) {
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const int j = 8 * (c / 2) + 2 * lane + (c & 1);
          float* pz = partz + (warp % 2) * kQ + j;
          float* pw = partw + (warp % 2) * kQ + j;
          *pz = half ? *pz + cz[c] : cz[c];
          *pw = half ? *pw + cw[c] : cw[c];
        }
      }
      __syncthreads();
    }
    if (threadIdx.x < kQ) {
      colz[threadIdx.x] = partz[threadIdx.x] + partz[kQ + threadIdx.x];
      colw[threadIdx.x] = partw[threadIdx.x] + partw[kQ + threadIdx.x];
    }
  }
  fence_proxy_async();   // M and D, written by the threads, read by wgmma
  __syncthreads();

  // -- dC = D B + e^cum_i (dY h_in^T), per 64 columns of n; the carry-in
  // term of dcum_i = <e^cum_i (dY h_in^T)_i, C_i>
  const float e0 = expf(cum[r0]), e1 = expf(cum[r1]);
  const float w0 = ws[r0], w1 = ws[r1];
  const int64_t rowBC = H * N;   // the partials' row stride
  float ci0 = 0.f, ci1 = 0.f;
  for (int nt = 0; nt < NC / 64; ++nt) {
    float acc[32], t[32];
#pragma unroll
    for (int u = 0; u < 32; ++u) acc[u] = 0.f;
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk)
      wgmma_rs_m64n64_tb(acc, da[kk],
                         make_desc(bs + nt * kTile + kk * 2048, kTile, 1024,
                                   1));
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
    store_f32(acc, dC_part + ((ch.b * L + ch.t0) * H + ch.h) * N, rowBC, nt,
              r0, cq, ch.nv, N);
  }
  ci0 = quad_sum(ci0);
  ci1 = quad_sum(ci1);
  if (cq == 0) {
    dcin[r0] = ci0;
    dcin[r1] = ci1;
  }

  // -- dB = D^T C + w_j (X dS^T), per 64 columns of n (rows j)
  for (int nt = 0; nt < NC / 64; ++nt) {
    float acc[32], t[32];
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
    store_f32(acc, dB_part + ((ch.b * L + ch.t0) * H + ch.h) * N, rowBC, nt,
              r0, cq, ch.nv, N);
  }

  // -- dX = M^T dY + w_j (B dS^T), per 64 columns of p (rows j); dw_j =
  // <x_j, (B dS^T)_j>
  float dw0 = 0.f, dw1 = 0.f;
  __nv_bfloat16* dxb = dx + xo;
  for (int pt = 0; pt < PC / 64; ++pt) {
    float acc[32], t[32];
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
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
#pragma unroll
      for (int hrow = 0; hrow < 2; ++hrow) {
        const int j = hrow ? r1 : r0;
        const int p = 64 * pt + 8 * nb + 2 * cq;
        if (j >= ch.nv || p >= P) continue;
        __nv_bfloat16* o = dxb + j * H * P + p;
        const float a0 = acc[4 * nb + 2 * hrow], a1 = acc[4 * nb + 2 * hrow + 1];
        if (P % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a0, a1);
        } else {
          o[0] = __float2bfloat16(a0);
          if (p + 1 < P) o[1] = __float2bfloat16(a1);
        }
      }
  }
  dw0 = quad_sum(dw0);
  dw1 = quad_sum(dw1);
  if (cq == 0) {
    dws[r0] = dw0;
    dws[r1] = dw1;
  }

  // -- <h_in, dS> over the chunk's state: both tiles share one layout, so
  // their 16-byte vectors pair up wherever they lie
  float hd = 0.f;
  for (int v = threadIdx.x; v < NC * PC / 8; v += blockDim.x) {
    const uint4 hv = reinterpret_cast<const uint4*>(Hs)[v];
    const uint4 sv = reinterpret_cast<const uint4*>(Ss)[v];
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&hv);
    const __nv_bfloat162* s2 = reinterpret_cast<const __nv_bfloat162*>(&sv);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 a = __bfloat1622float2(h2[u]), b = __bfloat1622float2(s2[u]);
      hd += a.x * b.x + a.y * b.y;
    }
  }
  hd = warp_sum(hd);
  if (lane == 0) red[warp] = hd;
  __syncthreads();

  // -- finish, by the first warp: lane l holds steps 2 l and 2 l + 1
  if (threadIdx.x < 32) {
    const int l = threadIdx.x;
    const float hds = (red[0] + red[1]) + (red[2] + red[3]);
    float dc[2], dwv[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = 2 * l + u;
      dwv[u] = dws[k] * ws[k];
      dc[u] = rowz[k] - colz[k] + dcin[k] - dwv[u];
    }
    const float dT = expf(total) * hds + warp_sum(dwv[0] + dwv[1]);
    // da_k = sum_{i >= k} dcum_i + dT: a suffix sum over the lanes
    float suf = dc[0] + dc[1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_down_sync(0xffffffffu, suf, o);
      if (l + o < 32) suf += n;
    }
    float after = __shfl_down_sync(0xffffffffu, suf, 1);   // lanes > l
    if (l == 31) after = 0.f;
    const float da1 = after + dc[1] + dT;
    const float da0 = after + dc[1] + dc[0] + dT;
    const float a = A[ch.h];
    float sdA = 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int k = 2 * l + u;
      const float dak = u ? da1 : da0;
      sdA += dts[k] * dak;
      if (k < ch.nv)
        ddt[(ch.b * L + ch.t0 + k) * H + ch.h] =
            colw[k] + dws[k] * expf(total - cum[k]) + a * dak;
    }
    sdA = warp_sum(sdA);
    if (l == 0) dA_part[ch.bh * gridDim.x + blockIdx.x] = sdA;
  }
}

// ---- 4. the sums over heads and chunks ------------------------------------------

// grid (ceil(rows N / kReduceThreads), 2): out[row][n] = sum over the
// group's rep heads, in order, of part[row * rep + r][n], to bf16; y = 0
// for dB, 1 for dC. A row is (b * L + t) * G + g.
__global__ void __launch_bounds__(kReduceThreads)
group_sum(const float* __restrict__ dB_part,
          const float* __restrict__ dC_part, __nv_bfloat16* __restrict__ dB,
          __nv_bfloat16* __restrict__ dC, int64_t rows, int rep, int N) {
  const int64_t e = blockIdx.x * (int64_t)kReduceThreads + threadIdx.x;
  if (e >= rows * N) return;
  const float* part = blockIdx.y ? dC_part : dB_part;
  const float* p = part + (e / N) * rep * N + e % N;
  float s = 0.f;
  for (int r = 0; r < rep; ++r) s += p[r * (int64_t)N];
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

int launch(const __nv_bfloat16* x, const float* dt, const float* A,
           const __nv_bfloat16* Bm, const __nv_bfloat16* Cm,
           const __nv_bfloat16* dy, __nv_bfloat16* dx, float* ddt, float* dA,
           __nv_bfloat16* dB, __nv_bfloat16* dC, float* states, float* totals,
           __nv_bfloat16* hin, __nv_bfloat16* ds, float* dB_part,
           float* dC_part, float* dA_part, int64_t B, int64_t L, int64_t H,
           int64_t G, int P, int N, cudaStream_t stream) {
  const int nc = (int)((L + kQ - 1) / kQ);
  const int NC = round_up(N, 64), PC = round_up(P, 64);
  // the forward's pass-1 tiles, 1,024 bytes of slack to align them
  const size_t s_state = 1024 + 2 * (size_t)kQ * (NC + PC) + 4 * 3 * kQ;
  const size_t s_adj = adjoint_smem(NC, PC);
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
  // 3. the adjoint of every chunk
  chunk_adjoint_wgmma<<<grid, kWgThreads, s_adj, stream>>>(
      x, dt, A, Bm, Cm, dy, hin, ds, dx, ddt, dB_part, dC_part, dA_part, L, H,
      G, P, N);
  if ((err = (int)cudaGetLastError())) return err;
  // 4. the sums over each group's heads, and dA's over b and the chunks
  const int64_t rows = B * L * G;
  group_sum<<<dim3((unsigned)((rows * N + kReduceThreads - 1) /
                              kReduceThreads),
                   2),
              kReduceThreads, 0, stream>>>(dB_part, dC_part, dB, dC, rows,
                                           (int)(H / G), N);
  if ((err = (int)cudaGetLastError())) return err;
  dA_sum<<<(unsigned)((H + kReduceThreads - 1) / kReduceThreads),
           kReduceThreads, 0, stream>>>(dA_part, dA, B, H, nc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// the steps per chunk. The scratch, n_chunks = ceil(L / chunk): `states`
// B * H * n_chunks * N * P floats, `totals` and `dA_part` B * H * n_chunks
// floats, `hin` and `ds` B * H * n_chunks * N * P bf16 values, `dB_part`
// and `dC_part` B * L * H * N floats.
int ssd_scan_bwd_sm90_chunk() { return kQ; }

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
