// Flash attention at head dim 16 in float32, on the tensor cores in
// 3xTF32 through warp-level mma.sync: flash_attention_sm90_f32.cu launches
// it when d = 16 (bf16 d = 16 runs on flash_attention_sm90.cu's wgmma
// kernel, 32-column tiles whose 16 columns past d TMA fills with zeros).
//
// Replaces the TPU Pallas kernel flash_attention_bhsd / _flash_kernel of
// the JAX package (src/repro/kernels/flash_attention/kernel.py:87, its
// pallas_call at :109) at d = 16, the head dim of every configuration's
// reduced() form. It computes what the wgmma kernels compute, in the same
// layout (q [B, Sq, H, 16], k/v [B, Skv, KV, 16], o like q), with GQA by
// index, the right-aligned causal mask (query i sees key j <= i + Skv -
// Sq), keys past Skv masked and a row that sees no key giving 0.
//
// What bounds it: bytes. At the reduced train_loop's shape (q [8, 128, 4,
// 16], k/v [8, 128, 2, 16], causal) q, k, v and o are 786,432 bytes,
// 0.000235 ms at 3.35 TB/s; the kept (query, key) pairs cost 16.9 MFLOP,
// three times over in 3xTF32, 0.1 us at 495 TFLOP/s. At that shape the
// kernel is bound by latency and by its launch, far above either: a few
// CTAs an SM at most, each walking at most two key tiles, so the time is
// the serial chain of one warp's tiles.
//
// What the design does about it:
//  * Tensor cores, warp-level: mma.sync m16n8k8 tf32 takes 16-row tiles
//    and its operands from registers, so unlike the wgmma kernel (64-row
//    tiles, K-major tf32 operands in shared memory) it needs no pre-pass
//    and no scratch. Each fp32 operand is split in registers when its
//    fragment is loaded, hi = tf32_rna(a), lo = tf32_rna(a - hi), and a
//    product is the two cross terms, then hi . hi (3xTF32). The rounding
//    is done on the bits by integer operations: cvt.rna.tf32.f32 gives
//    the same bits, but its conversions made the kernel about a fifth
//    slower at a long shape ([8, 2048, 4, 2, 16]; scripts/d16_turns.py).
//  * Two warps share 16 query rows of one (b, h) (kKeySplit): each takes
//    half of every key tile (n-tiles 0-3 or 4-7) with its own running
//    max, sum and O, and at the end the second hands its three to the
//    first through shared memory, which rescales both to the rows' common
//    max and adds them, its own first. That halves the chain of a warp's
//    keys; a CTA of kWarps = 4 warps takes kRows = 32 queries. Q's
//    fragments are loaded and split once, into registers. Query tiles
//    launch heaviest first; key tiles past the CTA's causal frontier are
//    never loaded; only tiles on the diagonal, or past Skv, are masked.
//    With one warp per 16 rows (kKeySplit 1, 64 queries a CTA) the kernel
//    takes about a sixth longer at the reduced shape and about a tenth
//    less at the long one.
//  * K and V are staged by cp.async in tiles of kKeys keys (4 KB each in
//    fp32, 16-byte copies), double-buffered: the next tile lands while
//    every warp of the CTA reads this one from shared memory.
//  * No bank conflicts and no shuffles in the products. Q K^T sums over
//    d in any order, so the k-index t (and t + 4) of k-step kk stands for
//    column 4t + 2kk (and 4t + 2kk + 1): a lane reads its Q and K
//    fragments of both k-steps as one float4 of a row, and 8 lanes of a
//    quarter warp read two whole 64-byte K rows. S's C fragment holds keys
//    2t and 2t + 1 of each group of 8 where P's A fragment holds k-indices
//    t and t + 4, so with the keys of a group taken in the order
//    0 2 4 6 1 3 5 7 the C fragment is the A fragment as it lies. The
//    output column n of n-tile nd stands for column 2n + nd of V and O:
//    a lane reads V as a float2 of each of its two key rows (rows padded
//    to kVStride floats so that the lanes of a half warp hit 32 banks)
//    and writes its 4 output columns of a row as one float4.
//  * The online softmax (ex2.approx, log2 e folded into the scale) runs on
//    S's C fragments; a row's max and sum combine over the 4 lanes of a
//    quad by xor-shuffles in a fixed order. P . V keeps the three products
//    in three accumulators of a tile, summed as (lo hi + hi lo) + hi hi
//    and then added to O, so its chains of dependent mma.sync are kNT
//    long (S's, one per n-tile, 6).
//  * No atomics and a fixed order of every sum: reruns are bit-identical.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace d16 {

constexpr int kD = 16;
constexpr int kWarps = 4;               // warps a CTA
constexpr int kKeySplit = 2;            // warps that share 16 query rows
constexpr int kGroups = kWarps / kKeySplit;   // 16-row groups a CTA
constexpr int kRows = 16 * kGroups;     // queries a CTA
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 64;               // keys a staged tile
constexpr int kNT = 8 / kKeySplit;      // 8-key n-tiles a warp takes of one
constexpr int kVStride = kD + 4;        // floats a staged V row
static_assert(kWarps % kKeySplit == 0 && (kKeySplit == 1 || kKeySplit == 2),
              "a row group's warps: 1 or 2");

struct Split {
  uint32_t hi, lo;
};

// a = hi + lo to about 2^-22 of a, hi and lo tf32: each rounded to nearest
// with ties away from zero, the value of cvt.rna.tf32.f32 (sm90.cuh's
// split_tf32), but on the bits, half of the 13 low bits added to the
// magnitude and then the 13 cleared: two integer operations instead of a
// conversion (the same results bit for bit, faster)
__device__ __forceinline__ Split split(float a) {
  const uint32_t hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  const float lo = a - __uint_as_float(hi);
  return {hi, (__float_as_uint(lo) + 0x1000u) & 0xffffe000u};
}

// 2^x (ex2.approx.ftz: a subnormal result is 0, as is 2^-inf)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += a b on one m16n8k8 tile: a (row g, k t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4); b (k t, col g), (t + 4, g); d (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1), with g = lane / 4, t = lane % 4
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared memory; with ok false, zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// one staged tile for one warp: S = Q K^T over the warp's kNT n-tiles
// (from n-tile kJB of the tile), the online softmax and O += P V. m, l,
// acc are the running max, this lane's partial sum and O of rows row0
// (index 0) and row0 + 8 (index 1); acc[nd][e] holds O's columns
// 4t + nd (e 0, 2) and 4t + 2 + nd (e 1, 3), rows row0 (e < 2) and
// row0 + 8. ``masked``: the tile holds keys that some row must not see.
template <int kJB>
__device__ __forceinline__ void attend_tile(
    const Split (&qs)[2][4], const float* tk, const float* tv, int k0,
    bool masked, int row0, int Skv, int causal, int q_offset,
    float scale_log2, float (&m)[2], float (&l)[2], float (&acc)[2][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;

  // S, 16 x 8 kNT: n-tile j holds keys 8 (kJB + j) + 2t and
  // 8 (kJB + j) + 2t + 1; the cross terms of both k-steps, then hi . hi
  float s[kNT][4] = {};
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const float4 x = *reinterpret_cast<const float4*>(
        tk + (8 * (kJB + j) + g) * kD + 4 * t);
    const Split kx[4] = {split(x.x), split(x.y), split(x.z), split(x.w)};
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const Split &a0 = qs[0][2 * kk], &a1 = qs[1][2 * kk],
                  &a2 = qs[0][2 * kk + 1], &a3 = qs[1][2 * kk + 1];
      const Split &b0 = kx[2 * kk], &b1 = kx[2 * kk + 1];
      mma(s[j], a0.lo, a1.lo, a2.lo, a3.lo, b0.hi, b1.hi);
      mma(s[j], a0.hi, a1.hi, a2.hi, a3.hi, b0.lo, b1.lo);
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const Split &a0 = qs[0][2 * kk], &a1 = qs[1][2 * kk],
                  &a2 = qs[0][2 * kk + 1], &a3 = qs[1][2 * kk + 1];
      const Split &b0 = kx[2 * kk], &b1 = kx[2 * kk + 1];
      mma(s[j], a0.hi, a1.hi, a2.hi, a3.hi, b0.hi, b1.hi);
    }
  }
  if (masked) {
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * (kJB + j) + 2 * t + (e & 1);
        const int row = row0 + (e >= 2 ? 8 : 0);
        if (key >= Skv || (causal && key > row + q_offset))
          s[j][e] = -INFINITY;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
  // the four lanes of a quad hold one row's keys of this warp
  float ms[2], al[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int w = 1; w < 4; w <<= 1)
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], w));
    const float mn = fmaxf(m[r], mx[r]);
    // a row that has seen no key yet keeps p = 0 and alpha = 0
    ms[r] = mn == -INFINITY ? 0.f : mn * scale_log2;
    al[r] = ex2(m[r] * scale_log2 - ms[r]);
    m[r] = mn;
  }

  // P V, 16 x 16: k-step j takes keys 8 (kJB + j) + 2t (k-index t) and
  // 8 (kJB + j) + 2t + 1 (t + 4), so P's A fragment is S's C fragment
  // (0, 2, 1, 3); B of n-tile nd is V's column 2g + nd of those two keys
  float lohi[2][4] = {}, hilo[2][4] = {}, hihi[2][4] = {};
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const float p0 = ex2(fmaf(s[j][0], scale_log2, -ms[0]));
    const float p1 = ex2(fmaf(s[j][1], scale_log2, -ms[0]));
    const float p2 = ex2(fmaf(s[j][2], scale_log2, -ms[1]));
    const float p3 = ex2(fmaf(s[j][3], scale_log2, -ms[1]));
    rs[0] += p0 + p1;
    rs[1] += p2 + p3;
    const Split a0 = split(p0), a1 = split(p2), a2 = split(p1),
                a3 = split(p3);
    const float* vr = tv + (8 * (kJB + j) + 2 * t) * kVStride + 2 * g;
    const float2 v0 = *reinterpret_cast<const float2*>(vr);
    const float2 v1 = *reinterpret_cast<const float2*>(vr + kVStride);
    const Split b[2][2] = {{split(v0.x), split(v1.x)},
                           {split(v0.y), split(v1.y)}};
#pragma unroll
    for (int nd = 0; nd < 2; ++nd) {
      mma(lohi[nd], a0.lo, a1.lo, a2.lo, a3.lo, b[nd][0].hi, b[nd][1].hi);
      mma(hilo[nd], a0.hi, a1.hi, a2.hi, a3.hi, b[nd][0].lo, b[nd][1].lo);
      mma(hihi[nd], a0.hi, a1.hi, a2.hi, a3.hi, b[nd][0].hi, b[nd][1].hi);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * al[r] + rs[r];
#pragma unroll
  for (int nd = 0; nd < 2; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[nd][e] = fmaf(acc[nd][e], al[e / 2],
                        (lohi[nd][e] + hilo[nd][e]) + hihi[nd][e]);
}

// grid (B * H, ceil(Sq / kRows)), block kThreads
__global__ void __launch_bounds__(kThreads)
flash_forward_d16(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int H,
                  int KV, int Sq, int Skv, int causal, float scale_log2) {
  __shared__ __align__(16) float sk[2][kKeys * kD];
  __shared__ __align__(16) float sv[2][kKeys * kVStride];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;   // heaviest first
  const int q_offset = Skv - Sq;
  const int k_end = causal ? min(Skv, q0 + kRows + q_offset) : Skv;
  const int n_tiles = k_end > 0 ? (k_end + kKeys - 1) / kKeys : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // the warps of parts 0 .. kKeySplit - 1 of row group rg share its rows;
  // part p takes n-tiles p kNT .. (p + 1) kNT - 1 of every tile
  const int rg = warp % kGroups, part = warp / kGroups;
  const int row0 = q0 + 16 * rg + g;                      // and row0 + 8
  const int64_t q_stride = static_cast<int64_t>(H) * kD;
  const int64_t kv_stride = static_cast<int64_t>(KV) * kD;
  const float* kb = k + static_cast<int64_t>(b) * Skv * kv_stride + kvh * kD;
  const float* vb = v + static_cast<int64_t>(b) * Skv * kv_stride + kvh * kD;

  // tile i's keys into buffer i % 2, one cp.async group: kKeys rows of 4
  // 16-byte chunks each of K and of V, zeros past Skv
  auto stage = [&](int i) {
    float* dk = sk[i & 1];
    float* dv = sv[i & 1];
    for (int c = threadIdx.x; c < kKeys * 4; c += kThreads) {
      const int r = c / 4, col = 4 * (c % 4), key = i * kKeys + r;
      const bool ok = key < Skv;
      const int64_t off = (ok ? key : 0) * kv_stride + col;
      cp_async16(dk + r * kD + col, kb + off, ok);
      cp_async16(dv + r * kVStride + col, vb + off, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  if (n_tiles > 0) stage(0);

  // Q's columns 4t .. 4t + 3 of rows row0 and row0 + 8, split: k-step kk's
  // A fragment is (x, y) for kk 0 and (z, w) for kk 1 of each row
  Split qs[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < Sq)
      x = *reinterpret_cast<const float4*>(
          q + (static_cast<int64_t>(b) * Sq + row) * q_stride + h * kD +
          4 * t);
    qs[r][0] = split(x.x);
    qs[r][1] = split(x.y);
    qs[r][2] = split(x.z);
    qs[r][3] = split(x.w);
  }

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[2][4] = {};
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) {
      stage(i + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const int k0 = i * kKeys;
    const bool masked = k0 + kKeys > Skv ||
                        (causal && k0 + kKeys - 1 > q0 + q_offset);
    // the part's first n-tile a constant, so that every shared-memory
    // offset of the tile is one
    if (kKeySplit == 1 || part == 0)
      attend_tile<0>(qs, sk[i & 1], sv[i & 1], k0, masked, row0, Skv,
                     causal, q_offset, scale_log2, m, l, acc);
    else
      attend_tile<kNT>(qs, sk[i & 1], sv[i & 1], k0, masked, row0, Skv,
                       causal, q_offset, scale_log2, m, l, acc);
    __syncthreads();   // every warp is done with buffer i % 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int w = 1; w < 4; w <<= 1)
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], w);
  if (kKeySplit == 2) {
    // part 1 hands its (m, l, acc) of the group's rows to part 0, which
    // rescales both to the rows' common max and adds them, part 0 first
    __shared__ float xch[kGroups][12][32];
    float* x = &xch[rg][0][lane];
    if (part == 1) {
      x[0] = m[0];
      x[32] = m[1];
      x[64] = l[0];
      x[96] = l[1];
#pragma unroll
      for (int e = 0; e < 8; ++e) x[32 * (4 + e)] = acc[e / 4][e % 4];
    }
    __syncthreads();
    if (part == 1) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mx = fmaxf(m[r], x[32 * r]);
      const float ms = mx == -INFINITY ? 0.f : mx * scale_log2;
      const float f = ex2(m[r] * scale_log2 - ms);
      const float f1 = ex2(x[32 * r] * scale_log2 - ms);
      l[r] = fmaf(x[32 * (2 + r)], f1, l[r] * f);
#pragma unroll
      for (int nd = 0; nd < 2; ++nd)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * r + c;
          acc[nd][e] = fmaf(x[32 * (4 + 4 * nd + e)], f1, acc[nd][e] * f);
        }
    }
  }
  const float inv0 = 1.f / (l[0] == 0.f ? 1.f : l[0]);
  const float inv1 = 1.f / (l[1] == 0.f ? 1.f : l[1]);
  float* ob = o + static_cast<int64_t>(b) * Sq * q_stride + h * kD + 4 * t;
  if (row0 < Sq)
    *reinterpret_cast<float4*>(ob + row0 * q_stride) =
        make_float4(acc[0][0] * inv0, acc[1][0] * inv0, acc[0][1] * inv0,
                    acc[1][1] * inv0);
  if (row0 + 8 < Sq)
    *reinterpret_cast<float4*>(ob + (row0 + 8) * q_stride) =
        make_float4(acc[0][2] * inv1, acc[1][2] * inv1, acc[0][3] * inv1,
                    acc[1][3] * inv1);
}

inline int launch_d16(const void* q, const void* k, const void* v, void* o,
                      int64_t B, int64_t H, int64_t KV, int64_t Sq,
                      int64_t Skv, int causal, float scale,
                      cudaStream_t stream) {
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + kRows - 1) / kRows));
  flash_forward_d16<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), (int)H, (int)KV,
      (int)Sq, (int)Skv, causal, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace d16
