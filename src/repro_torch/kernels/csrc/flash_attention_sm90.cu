// Causal flash attention for Hopper (sm_90a), bf16 on the tensor cores:
// a FlashAttention-3-shaped kernel on wgmma, fed by TMA.
//
// Replaces the TPU Pallas kernel flash_attention_bhsd / _flash_kernel of
// the JAX package (src/repro/kernels/flash_attention/kernel.py:87, its
// pallas_call at :109) for bf16 inputs; float32 runs in 3xTF32 on the
// tensor cores in flash_attention_sm90_f32.cu. It computes
//   o[b, i, h, :] = sum_j softmax_j(q[b, i, h, :] . k[b, j, kv, :] / sqrt(d))
//                   v[b, j, kv, :]
// in the model layout q [B, Sq, H, d], k/v [B, Skv, KV, d], o like q, with
//  * GQA by index: kv = h / (H / KV); repeated K/V never exist in memory;
//  * a right-aligned causal mask: query i sees key j <= i + Skv - Sq (the
//    offset may be negative);
//  * key rows j >= Skv masked here, and rows past Sq or Skv read as zeros
//    through TMA's out-of-bounds fill, so the caller pads nothing;
//  * a row that sees no key giving 0, as the TPU kernel's safe_l does.
// The running (m, l) and the O accumulator are fp32; P is rounded to bf16
// for P . V, the output to bf16 once.
//
// What bounds it: operations. At qwen3-1.7b width (B 1, S 4,096, H 16,
// KV 8, d 128, causal) the kept (query, key) pairs cost 4 d flops each,
// 68.7 GFLOP, or 0.0695 ms at the card's 989 TFLOP/s of dense bf16. The
// bytes it must move are q, k, v and o once, 50.3 MB (0.015 ms at
// 3.35 TB/s). This kernel reads Q once and K/V once per 128-query tile
// up to the causal frontier: 553.6 MB of K/V reads for 16.8 MB of K and V
// at that width, most of them from the 50 MB L2.
//
// What the design does about it:
//  * One CTA per (b * H + h, tile of 128 queries): two consumer warpgroups
//    of 64 query rows each and one producer warpgroup, of which one thread
//    starts every TMA copy. setmaxnreg moves registers from the producer
//    (24) to the consumers (240), which hold their S tile (64 x 128 keys)
//    and their O accumulator (64 x d) in fp32 registers.
//  * The producer loads the Q tile once and K and V tiles of 128 keys into
//    a ring of 2 stages, each stage with an mbarrier pair (full: TMA bytes
//    landed; empty: both consumer warpgroups are done with it), so the next
//    tile's copy overlaps this tile's math. The tensor maps read
//    [B, S, heads, d] in place (4-D: columns, heads, rows, batch) with the
//    128-byte swizzle (64-byte at 32 columns) that wgmma reads without
//    conflicts.
//  * S = Q K^T is a chain of wgmma m64n128k16 with both operands in shared
//    memory, d the K-major dimension. The online softmax runs in
//    registers with exp2f and log2(e) folded into the scale. P goes to
//    bf16 in registers, where the accumulator layout of S is already the
//    register-A layout of O += P V (wgmma m64n{d}k16, V the MN-major
//    shared-memory B operand, trans-b set).
//  * Only tiles on the causal diagonal, or past Skv, are masked; tiles
//    past the causal frontier of the query tile are never loaded.
//    Query tiles launch heaviest first (reversed in blockIdx.y), so the
//    causal tail does not leave SMs idle.
//  * No atomics and a fixed order of every sum: reruns are bit-identical.
//
// At d = 16 (every reduced() configuration) the tiles are 32 columns wide
// and the kernel runs as at d = 32: each box of the 4-D maps is 32 columns
// over the tensor's 16, and TMA's out-of-bounds fill zeroes the other 16
// in shared memory (a 3-D map would read the next head's there). The zero
// columns add exact zeros to Q K^T, the scale stays the caller's
// 1 / sqrt(16), and the epilogue stores the 16 real columns of O.
//
// Plain C interface, loaded with ctypes. cuTensorMapEncodeTiled lives in
// libcuda; the library looks it up at run time through the runtime's
// entry-point query (cudaGetDriverEntryPoint, tma.cuh) and links no
// libcuda. The launch goes to the caller's stream; nothing here allocates
// or synchronises. The entry point returns 0 on success, a cudaError_t, or
// kEncodeFailed + the CUresult of a refused tensor map.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"
#include "tma.cuh"

namespace {

constexpr int kBM = 128;        // queries per CTA
constexpr int kBN = 128;        // keys per tile
constexpr int kStages = 2;      // K/V ring depth
constexpr int kConsumers = 2;   // consumer warpgroups of 64 query rows
constexpr int kThreads = (kConsumers + 1) * 128;

// the tiles of one head dim: kDT columns (d, or 32 at d = 16), each row
// split into chunks of one swizzle span (128 bytes, or 64 at 32 columns),
// stored one after another
template <int D>
struct Cfg {
  static constexpr int kDT = D < 32 ? 32 : D;
  static constexpr int kSwBytes = kDT * 2 >= 128 ? 128 : kDT * 2;
  static constexpr int kCW = kSwBytes / 2;          // columns per chunk
  static constexpr int kChunks = kDT / kCW;
  static constexpr int kChunkQ = kBM * kSwBytes;    // bytes of a Q chunk
  static constexpr int kChunkKV = kBN * kSwBytes;   // bytes of a K/V chunk
  static constexpr int kQBytes = kBM * kDT * 2;
  static constexpr int kKVBytes = kBN * kDT * 2;
  static constexpr uint32_t kLayout = kSwBytes == 128 ? 1 : 2;  // B128, B64
  // 1,024 bytes of slack to align the tiles, the tiles, 5 mbarriers
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes + 64;
};

// grid (B * H, ceil(Sq / kBM)), block kThreads
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_forward_sm90(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   __nv_bfloat16* __restrict__ o, int H, int KV, int Sq,
                   int Skv, int causal, float scale_log2) {
  using C = Cfg<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;          // [chunk][kBM rows]
  const uint32_t sK = sQ + C::kQBytes;                 // [stage][chunk][kBN]
  const uint32_t sV = sK + kStages * C::kKVBytes;      // [stage][chunk][kBN]
  const uint32_t bar_q = sV + kStages * C::kKVBytes;
  const uint32_t bar_full = bar_q + 8;                 // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * kStages;   // + 8 * stage

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
      mbar_init(bar_empty + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread starts every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(bar_q, C::kQBytes);
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c)
        tma_load_4d(sQ + c * C::kChunkQ, &map_q, c * C::kCW, h, q0, b,
                    bar_q);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages)   // the consumers released tile t - kStages
          mbar_wait(bar_empty + 8 * s, ((t / kStages) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, 2 * C::kKVBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load_4d(sK + s * C::kKVBytes + c * C::kChunkKV, &map_k,
                      c * C::kCW, kvh, t * kBN, b, full);
          tma_load_4d(sV + s * C::kKVBytes + c * C::kChunkKV, &map_v,
                      c * C::kCW, kvh, t * kBN, b, full);
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
    // the tiles with a key that some row of this warpgroup sees
    const int my_end = causal ? min(Skv, first_row + 64 + q_offset) : Skv;
    const int my_tiles = my_end > 0 ? (my_end + kBN - 1) / kBN : 0;

    float acc[C::kDT / 2];
#pragma unroll
    for (int i = 0; i < C::kDT / 2; ++i) acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    const uint32_t qa = sQ + wg * 64 * C::kSwBytes;

    mbar_wait(bar_q, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      mbar_wait(bar_full + 8 * s, (t / kStages) & 1);
      if (t < my_tiles) {
        // S = Q K^T: 64 x 128, kDT deep
        float sc[64];
        const uint32_t kb = sK + s * C::kKVBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C::kDT / 16; ++kk) {
          const int c = kk * 16 / C::kCW;
          const int off = (kk * 16 % C::kCW) * 2;
          wgmma_ss_m64n128(
              sc, make_desc(qa + c * C::kChunkQ + off, 16, 8 * C::kSwBytes,
                            C::kLayout),
              make_desc(kb + c * C::kChunkKV + off, 16, 8 * C::kSwBytes,
                        C::kLayout),
              kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_operands(sc);

        // sc[4i + e]: row row0 (+8 for e >= 2), key k0 + 8i + 2cq + (e & 1)
        const int k0 = t * kBN;
        if (k0 + kBN > Skv || (causal && k0 + kBN - 1 > first_row + q_offset)) {
#pragma unroll
          for (int i = 0; i < 16; ++i)
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
        for (int i = 0; i < 16; ++i) {
          mx0 = fmaxf(mx0, fmaxf(sc[4 * i], sc[4 * i + 1]));
          mx1 = fmaxf(mx1, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
        }
        // the four lanes of a quad hold one row's 32 columns of each 128
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
        uint32_t pa[8][4];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float p0 = exp2f(fmaf(sc[4 * i], scale_log2, -ms0));
          const float p1 = exp2f(fmaf(sc[4 * i + 1], scale_log2, -ms0));
          const float p2 = exp2f(fmaf(sc[4 * i + 2], scale_log2, -ms1));
          const float p3 = exp2f(fmaf(sc[4 * i + 3], scale_log2, -ms1));
          rs0 += p0 + p1;
          rs1 += p2 + p3;
          // the S accumulator of keys 16kk..16kk+15 is the A fragment of
          // k-step kk: (row, k 0-7), (row + 8, k 0-7), (row, k 8-15), ...
          pa[i / 2][(i % 2) * 2] = pack_bf16(p0, p1);
          pa[i / 2][(i % 2) * 2 + 1] = pack_bf16(p2, p3);
        }
        l0 = l0 * al0 + rs0;   // a partial sum of this lane's columns
        l1 = l1 * al1 + rs1;
#pragma unroll
        for (int j = 0; j < C::kDT / 8; ++j) {
          acc[4 * j] *= al0;
          acc[4 * j + 1] *= al0;
          acc[4 * j + 2] *= al1;
          acc[4 * j + 3] *= al1;
        }

        // O += P V: V [128 keys][d], d contiguous (MN-major, trans-b)
        const uint32_t vb = sV + s * C::kKVBytes;
        fence_operands(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
          wgmma_rs_tb<C::kDT>(acc, pa[kk],
                         make_desc(vb + kk * 16 * C::kSwBytes, C::kChunkKV,
                                   8 * C::kSwBytes, C::kLayout));
        wgmma_commit();
        wgmma_wait_all();
        fence_operands(acc);
      }
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
    __nv_bfloat16* ob = o + (static_cast<int64_t>(b) * Sq * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {   // the d real columns
      const int col = 8 * j + 2 * cq;
      if (row0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + row0 * row_stride + col) =
            __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      if (row0 + 8 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (row0 + 8) * row_stride +
                                           col) =
            __floats2bfloat162_rn(acc[4 * j + 2] * inv1,
                                  acc[4 * j + 3] * inv1);
    }
  }
}

// a 4-D map of a [B, S, heads, D] bf16 tensor (d, heads, rows, batch)
// whose box is one chunk of kBN (= kBM) rows of one head; at D = 16 the
// box is 32 columns wide and TMA fills the 16 past the tensor with zeros
template <int D>
int make_map(CUtensorMap* map, const void* ptr, int64_t B, int64_t S,
             int64_t heads) {
  using C = Cfg<D>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)(D * 2),
                                 (cuuint64_t)(heads * D * 2),
                                 (cuuint64_t)(S * heads * D * 2)};
  const cuuint32_t box[4] = {(cuuint32_t)C::kCW, 1, (cuuint32_t)kBN, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      C::kSwBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                         : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B,
           int64_t H, int64_t KV, int64_t Sq, int64_t Skv, int causal,
           float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = make_map<D>(&mq, q, B, Sq, H);
  if (!err) err = make_map<D>(&mk, k, B, Skv, KV);
  if (!err) err = make_map<D>(&mv, v, B, Skv, KV);
  if (err) return err;
  auto kernel = flash_forward_sm90<D>;
  const int smem = Cfg<D>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(B * H), (unsigned)((Sq + kBM - 1) / kBM));
  kernel<<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), (int)H, (int)KV, (int)Sq,
      (int)Skv, causal, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// the queries of one CTA: the grid's y extent is ceil(Sq / this)
int flash_attention_sm90_query_tile() { return kBM; }

// q, o: [B, Sq, H, d]; k, v: [B, Skv, KV, d]; all contiguous bf16, 16-byte
// aligned; d in {16, 32, 64, 128}; H a multiple of KV; 1 <= Sq, Skv <
// 2^31; ceil(Sq / 128) <= 65535. scale multiplies q . k.
int flash_attention_sm90_forward(const void* q, const void* k, const void* v,
                                 void* o, int64_t B, int64_t H, int64_t KV,
                                 int64_t Sq, int64_t Skv, int64_t d,
                                 int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return launch<16>(q, k, v, o, B, H, KV, Sq, Skv, causal, scale, s);
    case 32:
      return launch<32>(q, k, v, o, B, H, KV, Sq, Skv, causal, scale, s);
    case 64:
      return launch<64>(q, k, v, o, B, H, KV, Sq, Skv, causal, scale, s);
    case 128:
      return launch<128>(q, k, v, o, B, H, KV, Sq, Skv, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_sm90_error_string(int err) {
  if (err >= kEncodeFailed) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
