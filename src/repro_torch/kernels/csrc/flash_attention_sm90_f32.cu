// Causal flash attention for Hopper (sm_90a), float32 on the tensor cores
// in 3xTF32: wgmma on tf32 operands split in two, fed by TMA.
//
// Replaces the TPU Pallas kernel flash_attention_bhsd / _flash_kernel of
// the JAX package (src/repro/kernels/flash_attention/kernel.py:87, its
// pallas_call at :109) for float32 inputs; bf16 runs in
// flash_attention_sm90.cu. It computes
//   o[b, i, h, :] = sum_j softmax_j(q[b, i, h, :] . k[b, j, kv, :] / sqrt(d))
//                   v[b, j, kv, :]
// in the model layout q [B, Sq, H, d], k/v [B, Skv, KV, d], o like q, with
//  * GQA by index: kv = h / (H / KV); repeated K/V never exist in memory;
//  * a right-aligned causal mask: query i sees key j <= i + Skv - Sq (the
//    offset may be negative);
//  * key rows j >= Skv masked here, rows past Sq or Skv read as zeros
//    through TMA's out-of-bounds fill;
//  * a row that sees no key giving 0, as the TPU kernel's safe_l does.
// The running (m, l), the O accumulator and the output are fp32.
//
// The split (CUTLASS's 3xTF32). One TF32 product keeps 11 significant
// bits, about 4.9e-4 of each term, which the JAX package's fp32 tolerance
// of 2e-5 rules out. Each fp32 operand a is split as a = hi + lo with
// hi = tf32_rna(a), lo = tf32_rna(a - hi) (sm90.cuh), and a product is
// a_lo b_hi + a_hi b_lo + a_hi b_hi with fp32 accumulation, the two cross
// terms first: the dropped a_lo b_lo and the rounding of lo leave about
// 2^-21 of each term. wgmma reads a 32-bit word and ignores its low 13
// bits, so both parts are stored explicitly. P is split in registers.
//
// What bounds it: operations. At qwen3-1.7b width (B 1, S 4,096, H 16,
// KV 8, d 128, causal) the kept (query, key) pairs cost 4 d flops each,
// 68.7 GFLOP, three times over in 3xTF32: 206.1 GFLOP, 0.416 ms at the
// card's 495 TFLOP/s of dense TF32 (against 1.026 ms for 68.7 GFLOP on
// the CUDA cores at 67 TFLOP/s). The bytes it must move are q, k, v and o
// once, 100.7 MB (0.030 ms at 3.35 TB/s).
//
// What the design does about it:
//  * tf32 wgmma takes both shared-memory operands K-major only. For
//    S = Q K^T, Q [rows, d] and K [keys, d] are K-major in place. For
//    O = P V the depth is the keys, and V has d contiguous: a pre-pass
//    (split_kv, one launch before the main kernel) writes K's hi and lo
//    parts in K's layout and V^T's hi and lo parts as [B, KV, d, Skv_pad]
//    (Skv_pad = Skv rounded up to the key tile, zeros past Skv). It reads
//    K and V once and writes twice their bytes (100.7 MB at full width,
//    about 0.03 ms), so no CTA splits or transposes K or V again.
//  * P from registers: S's accumulator holds keys 2t and 2t+1 of each
//    group of 8 where the tf32 register-A fragment holds k-indices t and
//    t+4. The pre-pass stores V^T's keys of each group of 8 in the order
//    0 2 4 6 1 3 5 7, so S's accumulator is used as the A fragment as it
//    lies; the sum over keys does not depend on their order.
//  * The shared-memory budget. A 64-row fp32 tile of d = 128 is 32 KB,
//    64 KB with its lo part. One CTA per (b * H + h, tile of 64 queries):
//    one consumer warpgroup and one producer warp, whose one thread starts
//    every TMA copy. Q hi and lo (64 KB at d = 128: Q arrives by TMA and
//    the consumers split it in place once) and a 2-stage ring of 32-key
//    tiles, K hi and lo and V^T hi and lo (64 KB a stage), take 192 KB,
//    one CTA an SM; at d = 64 96 KB, two. Every tile row is 128 bytes of
//    one 32-column chunk, stored with TMA's 128-byte swizzle, which wgmma
//    reads without conflicts.
//  * Registers per consumer thread: O (64 x d fp32) is d / 2 (64 at
//    d = 128), S for 32 keys 16, P hi and lo 16 each.
//  * S = Q K^T: wgmma m64n32k8, three chains of d / 8 k-steps into one
//    accumulator (lo hi, hi lo, then hi hi). O += P V: wgmma m64n{d}k8
//    with P from registers, V^T the K-major shared-memory B operand.
//  * Only tiles on the causal diagonal, or past Skv, are masked; tiles
//    past the causal frontier of the query tile are never loaded. Query
//    tiles launch heaviest first (reversed in blockIdx.y).
//  * No atomics and a fixed order of every sum: reruns are bit-identical.
//
// At d = 16 (every reduced() configuration) the entry point launches the
// kernel of flash_d16.cuh instead: 3xTF32 on warp-level mma.sync, its
// operands split in registers, so without the pre-pass or its scratch.
//
// Plain C interface, loaded with ctypes. The launches go to the caller's
// stream; nothing here allocates or synchronises: the caller passes the
// pre-pass's buffers. The entry point returns 0 on success, a cudaError_t,
// or kEncodeFailed + the CUresult of a refused tensor map.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_d16.cuh"
#include "sm90.cuh"
#include "tma.cuh"

namespace {

constexpr int kBM = 64;               // queries per CTA: one warpgroup
constexpr int kBN = 32;               // keys per tile: a 128-byte V^T row
constexpr int kStages = 2;            // K/V ring depth
constexpr int kThreads = 128 + 32;    // consumer warpgroup + producer warp
constexpr int kCW = 32;               // fp32 columns per 128-byte chunk
constexpr int kSplitThreads = 256;

// the tiles of one head dim: each part (hi, lo) of a tile stored as
// 32-column chunks of 128-byte rows, one after another
template <int D>
struct Cfg {
  static constexpr int kChunks = D / kCW;
  static constexpr int kChunkQ = kBM * 128;          // bytes of a Q chunk
  static constexpr int kChunkK = kBN * 128;          // bytes of a K chunk
  static constexpr int kQBytes = kBM * D * 4;        // one part of Q
  static constexpr int kKBytes = kBN * D * 4;        // one part of K
  static constexpr int kVBytes = D * kBN * 4;        // one part of V^T
  static constexpr int kStageBytes = 2 * kKBytes + 2 * kVBytes;
  // 1,024 bytes of slack to align the tiles, the tiles, 5 mbarriers
  static constexpr int kSmem = 1024 + 2 * kQBytes + kStages * kStageBytes + 64;
};

// the key at position p of a V^T row: within each group of 8 the keys
// lie in the order 0 2 4 6 1 3 5 7 (the register-A fragment's k-indices
// t and t + 4 are S's columns 2t and 2t + 1)
__device__ __forceinline__ int key_at(int p) {
  const int q = p & 7;
  return (p & ~7) | (q < 4 ? 2 * q : 2 * (q - 4) + 1);
}

// grid (Skv_pad / kBN, B * KV), block kSplitThreads. K's parts in K's
// layout (rows < Skv); V^T's parts [B, KV, D, Skv_pad], keys permuted as
// key_at says, zeros past Skv.
template <int D>
__global__ void __launch_bounds__(kSplitThreads)
split_kv(const float* __restrict__ k, const float* __restrict__ v,
         float* __restrict__ k_hi, float* __restrict__ k_lo,
         float* __restrict__ vt_hi, float* __restrict__ vt_lo, int KV,
         int Skv, int Skv_pad) {
  __shared__ float tile[kBN][D + 1];
  const int bk = blockIdx.y;
  const int b = bk / KV, kvh = bk % KV;
  const int k0 = blockIdx.x * kBN;
  const int64_t row_stride = static_cast<int64_t>(KV) * D;
  for (int e = threadIdx.x; e < kBN * D / 4; e += kSplitThreads) {
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    float4 vv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k0 + r < Skv) {
      const int64_t off =
          (static_cast<int64_t>(b) * Skv + k0 + r) * row_stride + kvh * D + c;
      const float4 kk = *reinterpret_cast<const float4*>(k + off);
      float4 hi, lo;
      split_tf32(kk.x, hi.x, lo.x);
      split_tf32(kk.y, hi.y, lo.y);
      split_tf32(kk.z, hi.z, lo.z);
      split_tf32(kk.w, hi.w, lo.w);
      *reinterpret_cast<float4*>(k_hi + off) = hi;
      *reinterpret_cast<float4*>(k_lo + off) = lo;
      vv = *reinterpret_cast<const float4*>(v + off);
    }
    tile[r][c] = vv.x;
    tile[r][c + 1] = vv.y;
    tile[r][c + 2] = vv.z;
    tile[r][c + 3] = vv.w;
  }
  __syncthreads();
  const int64_t base = static_cast<int64_t>(bk) * D * Skv_pad + k0;
  for (int e = threadIdx.x; e < D * kBN; e += kSplitThreads) {
    const int d = e / kBN, p = e % kBN;
    float hi, lo;
    split_tf32(tile[key_at(p)][d], hi, lo);
    vt_hi[base + static_cast<int64_t>(d) * Skv_pad + p] = hi;
    vt_lo[base + static_cast<int64_t>(d) * Skv_pad + p] = lo;
  }
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void wgmma_pv<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  wgmma_rs_m64n32k8_tf32(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  wgmma_rs_m64n64k8_tf32(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  wgmma_rs_m64n128k8_tf32(d, a, b);
}

// a K-major descriptor of a 128-byte swizzled tile: 8-row groups 1,024
// bytes apart
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return make_desc(addr, 16, 1024, 1);
}

// grid (B * H, ceil(Sq / kBM)), block kThreads
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_forward_3xtf32(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k_hi,
                     const __grid_constant__ CUtensorMap map_k_lo,
                     const __grid_constant__ CUtensorMap map_vt_hi,
                     const __grid_constant__ CUtensorMap map_vt_lo,
                     float* __restrict__ o, int H, int KV, int Sq, int Skv,
                     int causal, float scale_log2) {
  using C = Cfg<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;          // hi, then lo
  const uint32_t sKV = sQ + 2 * C::kQBytes;           // [stage]: K hi, K lo,
                                                      // V^T hi, V^T lo
  const uint32_t bar_q = sKV + kStages * C::kStageBytes;
  const uint32_t bar_full = bar_q + 8;                // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;  // + 8 * stage

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // heaviest first
  const int q_offset = Skv - Sq;
  const int k_end = causal ? min(Skv, q0 + kBM + q_offset) : Skv;
  const int n_tiles = k_end > 0 ? (k_end + kBN - 1) / kBN : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer: one thread starts every copy ----
    if (threadIdx.x == 128) {
      mbar_expect_tx(bar_q, C::kQBytes);
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c)
        tma_load_3d(sQ + c * C::kChunkQ, &map_q, h * D + c * kCW, q0, b,
                    bar_q);
      const int vt_row = (b * KV + kvh) * D;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages)   // the consumers released tile t - kStages
          mbar_wait(bar_empty + 8 * s, ((t / kStages) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * s;
        const uint32_t st = sKV + s * C::kStageBytes;
        mbar_expect_tx(full, C::kStageBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) {
          const int col = kvh * D + c * kCW;
          tma_load_3d(st + c * C::kChunkK, &map_k_hi, col, t * kBN, b, full);
          tma_load_3d(st + C::kKBytes + c * C::kChunkK, &map_k_lo, col,
                      t * kBN, b, full);
        }
        tma_load_2d(st + 2 * C::kKBytes, &map_vt_hi, t * kBN, vt_row, full);
        tma_load_2d(st + 2 * C::kKBytes + C::kVBytes, &map_vt_lo, t * kBN,
                    vt_row, full);
      }
    }
    return;
  }

  // ---- the consumer warpgroup: 64 query rows ----
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int cq = lane % 4;
  const int row0 = q0 + warp * 16 + lane / 4;          // and row0 + 8

  // split Q in place into its tf32 hi part and, beside it, its lo part;
  // the split is elementwise, so the swizzle does not matter
  mbar_wait(bar_q, 0);
  {
    float4* q_hi = reinterpret_cast<float4*>(smem_raw + (sQ - raw));
    float4* q_lo = q_hi + C::kQBytes / 16;
    for (int e = tid; e < C::kQBytes / 16; e += 128) {
      const float4 x = q_hi[e];
      float4 hi, lo;
      split_tf32(x.x, hi.x, lo.x);
      split_tf32(x.y, hi.y, lo.y);
      split_tf32(x.z, hi.z, lo.z);
      split_tf32(x.w, hi.w, lo.w);
      q_hi[e] = hi;
      q_lo[e] = lo;
    }
  }
  fence_proxy_async();
  asm volatile("bar.sync 1, 128;\n" ::: "memory");

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const uint32_t q_hi = sQ, q_lo = sQ + C::kQBytes;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    mbar_wait(bar_full + 8 * s, (t / kStages) & 1);
    const uint32_t k_hi = sKV + s * C::kStageBytes;
    const uint32_t k_lo = k_hi + C::kKBytes;
    const uint32_t vt_hi = k_hi + 2 * C::kKBytes;
    const uint32_t vt_lo = vt_hi + C::kVBytes;

    // S = Q K^T: 64 x 32, d deep; the cross terms, then hi . hi
    float sc[16];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t qo = (kk / 4) * C::kChunkQ + (kk % 4) * 32;
      const uint32_t ko = (kk / 4) * C::kChunkK + (kk % 4) * 32;
      wgmma_ss_m64n32k8_tf32(sc, desc(q_lo + qo), desc(k_hi + ko), kk > 0);
      wgmma_ss_m64n32k8_tf32(sc, desc(q_hi + qo), desc(k_lo + ko), 1);
    }
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t qo = (kk / 4) * C::kChunkQ + (kk % 4) * 32;
      const uint32_t ko = (kk / 4) * C::kChunkK + (kk % 4) * 32;
      wgmma_ss_m64n32k8_tf32(sc, desc(q_hi + qo), desc(k_hi + ko), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(sc);

    // sc[4i + e]: row row0 (+8 for e >= 2), key k0 + 8i + 2cq + (e & 1)
    const int k0 = t * kBN;
    if (k0 + kBN > Skv || (causal && k0 + kBN - 1 > q0 + q_offset)) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * i + 2 * cq + (e & 1);
          const int row = row0 + (e >= 2 ? 8 : 0);
          if (key >= Skv || (causal && key > row + q_offset))
            sc[4 * i + e] = -INFINITY;
        }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
    }
    // the four lanes of a quad hold one row's 8 columns of each 32
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
    float rs0 = 0.f, rs1 = 0.f;
    uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p0 = exp2f(fmaf(sc[4 * i], scale_log2, -ms0));
      const float p1 = exp2f(fmaf(sc[4 * i + 1], scale_log2, -ms0));
      const float p2 = exp2f(fmaf(sc[4 * i + 2], scale_log2, -ms1));
      const float p3 = exp2f(fmaf(sc[4 * i + 3], scale_log2, -ms1));
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      // the A fragment of k-step i: (row, k cq) = key 2cq, (row + 8, k cq),
      // (row, k cq + 4) = key 2cq + 1, (row + 8, k cq + 4)
      const float ps[4] = {p0, p2, p1, p3};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float hi, lo;
        split_tf32(ps[r], hi, lo);
        p_hi[i][r] = __float_as_uint(hi);
        p_lo[i][r] = __float_as_uint(lo);
      }
    }
    l0 = l0 * al0 + rs0;   // a partial sum of this lane's columns
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= al0;
      acc[4 * j + 1] *= al0;
      acc[4 * j + 2] *= al1;
      acc[4 * j + 3] *= al1;
    }

    // O += P V: V^T [d][32 keys] K-major; the cross terms, then hi . hi
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 8; ++kk) {
      wgmma_pv<D>(acc, p_lo[kk], desc(vt_hi + kk * 32));
      wgmma_pv<D>(acc, p_hi[kk], desc(vt_lo + kk * 32));
    }
#pragma unroll
    for (int kk = 0; kk < kBN / 8; ++kk)
      wgmma_pv<D>(acc, p_hi[kk], desc(vt_hi + kk * 32));
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(acc);
    mbar_arrive(bar_empty + 8 * s);   // this thread is done with stage s
  }

#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
  const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
  const int64_t row_stride = static_cast<int64_t>(H) * D;
  float* ob = o + (static_cast<int64_t>(b) * Sq * H + h) * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * cq;
    if (row0 < Sq)
      *reinterpret_cast<float2*>(ob + row0 * row_stride + col) =
          make_float2(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    if (row0 + 8 < Sq)
      *reinterpret_cast<float2*>(ob + (row0 + 8) * row_stride + col) =
          make_float2(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
  }
}

int encode(CUtensorMap* map, const void* ptr, cuuint32_t rank,
           const cuuint64_t* dims, const cuuint64_t* strides,
           const cuuint32_t* box) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(ptr),
      dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

// a 3-D map of a [B, S, heads * D] fp32 tensor (columns, rows, batch)
// whose box is one 32-column chunk of `rows` rows
template <int D>
int make_map_rows(CUtensorMap* map, const void* ptr, int64_t B, int64_t S,
                  int64_t heads, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)(heads * D), (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)(heads * D * 4),
                                 (cuuint64_t)(S * heads * D * 4)};
  const cuuint32_t box[3] = {(cuuint32_t)kCW, (cuuint32_t)rows, 1};
  return encode(map, ptr, 3, dims, strides, box);
}

// a 2-D map of V^T [B * KV * D, Skv_pad] whose box is D rows of kBN keys
template <int D>
int make_map_vt(CUtensorMap* map, const void* ptr, int64_t rows,
                int64_t Skv_pad) {
  const cuuint64_t dims[2] = {(cuuint64_t)Skv_pad, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(Skv_pad * 4)};
  const cuuint32_t box[2] = {(cuuint32_t)kBN, (cuuint32_t)D};
  return encode(map, ptr, 2, dims, strides, box);
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o,
           float* k_hi, float* k_lo, float* vt_hi, float* vt_lo, int64_t B,
           int64_t H, int64_t KV, int64_t Sq, int64_t Skv, int causal,
           float scale, cudaStream_t stream) {
  const int64_t Skv_pad = (Skv + kBN - 1) / kBN * kBN;
  CUtensorMap mq, mkh, mkl, mvh, mvl;
  int err = make_map_rows<D>(&mq, q, B, Sq, H, kBM);
  if (!err) err = make_map_rows<D>(&mkh, k_hi, B, Skv, KV, kBN);
  if (!err) err = make_map_rows<D>(&mkl, k_lo, B, Skv, KV, kBN);
  if (!err) err = make_map_vt<D>(&mvh, vt_hi, B * KV * D, Skv_pad);
  if (!err) err = make_map_vt<D>(&mvl, vt_lo, B * KV * D, Skv_pad);
  if (err) return err;

  split_kv<D><<<dim3((unsigned)(Skv_pad / kBN), (unsigned)(B * KV)),
                kSplitThreads, 0, stream>>>(k, v, k_hi, k_lo, vt_hi, vt_lo,
                                            (int)KV, (int)Skv, (int)Skv_pad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  auto kernel = flash_forward_3xtf32<D>;
  const int smem = Cfg<D>::kSmem;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + kBM - 1) / kBM));
  kernel<<<grid, kThreads, smem, stream>>>(mq, mkh, mkl, mvh, mvl, o, (int)H,
                                           (int)KV, (int)Sq, (int)Skv, causal,
                                           scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// the queries of one CTA (the grid's y extent is ceil(Sq / this)) and the
// keys of one tile (V^T's rows hold Skv rounded up to a multiple of this)
int flash_attention_sm90_f32_query_tile() { return kBM; }
int flash_attention_sm90_f32_key_tile() { return kBN; }
// the queries of one CTA of the d = 16 kernel
int flash_attention_sm90_f32_d16_query_tile() { return d16::kRows; }

// q, o: [B, Sq, H, d]; k, v: [B, Skv, KV, d]; all contiguous float32,
// 16-byte aligned; d in {16, 32, 64, 128} (d = 16 on mma.sync,
// flash_d16.cuh, which needs no scratch: the four scratch pointers may
// then be null); H a multiple of KV; 1 <= Sq, Skv <
// 2^31; ceil(Sq / 64) <= 65535 (ceil(Sq / the d 16 query tile) at d =
// 16), B * KV <= 65535. Scratch from the caller:
// k_hi, k_lo like k; vt_hi, vt_lo [B, KV, d, Skv_pad] with Skv_pad = Skv
// rounded up to the key tile. scale multiplies q . k.
int flash_attention_sm90_f32_forward(const void* q, const void* k,
                                     const void* v, void* o, void* k_hi,
                                     void* k_lo, void* vt_hi, void* vt_lo,
                                     int64_t B, int64_t H, int64_t KV,
                                     int64_t Sq, int64_t Skv, int64_t d,
                                     int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* kh = static_cast<float*>(k_hi);
  float* kl = static_cast<float*>(k_lo);
  float* vh = static_cast<float*>(vt_hi);
  float* vl = static_cast<float*>(vt_lo);
  switch (d) {
    case 16:
      return d16::launch_d16(q, k, v, o, B, H, KV, Sq, Skv, causal, scale,
                             s);
    case 32:
      return launch<32>(qf, kf, vf, of, kh, kl, vh, vl, B, H, KV, Sq, Skv,
                        causal, scale, s);
    case 64:
      return launch<64>(qf, kf, vf, of, kh, kl, vh, vl, B, H, KV, Sq, Skv,
                        causal, scale, s);
    case 128:
      return launch<128>(qf, kf, vf, of, kh, kl, vh, vl, B, H, KV, Sq, Skv,
                         causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_sm90_f32_error_string(int err) {
  if (err >= kEncodeFailed) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
