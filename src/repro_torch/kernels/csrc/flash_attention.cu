// Causal flash attention (online softmax, FlashAttention-2) for Hopper
// (sm_90a), float32 on the CUDA cores.
//
// Replaces the TPU Pallas kernel flash_attention_bhsd / _flash_kernel of
// the JAX package (repro/kernels/flash_attention/kernel.py) for float32
// inputs; bf16 runs on the tensor cores in flash_attention_sm90.cu. It
// computes
//   o[b, i, h, :] = sum_j softmax_j(q[b, i, h, :] . k[b, j, kv, :] / sqrt(d))
//                   v[b, j, kv, :]
// in the model layout q [B, Sq, H, d], k/v [B, Skv, KV, d], o like q, with
//  * GQA by index: kv = h / (H / KV); repeated K/V never exist in memory;
//  * a right-aligned causal mask: query i sees key j <= i + Skv - Sq;
//  * key rows j >= Skv masked here, so the caller pads nothing;
//  * a row that sees no key giving 0, as the TPU kernel's safe_l does.
// Inputs, the running (m, l, acc) state and the output are fp32.
//
// What bounds it: operations. Each kept (query, key) pair costs 4 d flops
// (two d-long dot products) against 2 d input values read once, so at the
// shapes of a model the work is far past the card's ridge point. It runs
// the products as fp32 FMA on the CUDA cores (67 TFLOP/s peak): the JAX
// package's fp32 tolerance of 2e-5 rules out TF32 on the tensor cores.
//
// What the design does about it:
//  * One block of 128 threads per (b * H + h, tile of kBQ = 64 queries).
//    The query tile stays in shared memory for the whole key loop; each
//    key tile (kBK = 64 keys) is staged once in shared memory and used by
//    all 64 queries, so device memory is read about Sq / 64 times per key
//    instead of Sq times.
//  * Each thread owns 4 query rows and 8 key columns of a score tile and
//    4 rows x d/8 columns of the accumulator, and reads shared memory in
//    16-byte vectors: about 10 FMAs per shared-memory load.
//  * K and V share one staging buffer (loaded one after the other), so at
//    d = 128 a block takes 85 KB and two blocks fit on an SM. That is
//    past the 48 KB default: the launch opts in to dynamic shared memory.
//  * Key tiles past the causal frontier of the query tile are skipped.
//  * No atomics and a fixed order of every sum: reruns are bit-identical.
//
// Plain C interface, loaded with ctypes. The launch goes to the caller's
// stream; nothing here allocates or synchronises. The entry point returns
// the cudaError_t of its launch (0 on success).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // queries per block
constexpr int kBK = 64;        // keys per staged tile
constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kPad = 4;        // floats of row padding (keeps 16 B alignment)
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// rows [0, n_rows) of a tile of `rows` rows x D values, from a tensor whose
// row r starts at base + r * row_stride, into smem [rows][D + kPad];
// rows past n_rows are zero
template <int D>
__device__ __forceinline__ void stage(float* smem, const float* base,
                                      int64_t row_stride, int rows,
                                      int n_rows) {
  constexpr int kVecs = D / 4;
  for (int e = threadIdx.x; e < rows * kVecs; e += kThreads) {
    const int r = e / kVecs;
    const int c = (e % kVecs) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_rows)
      v = *reinterpret_cast<const float4*>(base + r * row_stride + c);
    *reinterpret_cast<float4*>(smem + r * (D + kPad) + c) = v;
  }
}

// grid (ceil(Sq / kBQ), B * H), block kThreads
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_forward(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int64_t H,
              int64_t KV, int64_t Sq, int64_t Skv, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBQ][D + kPad]
  float* KVs = Qs + kBQ * (D + kPad);           // [kBK][D + kPad]
  float* Ps = KVs + kBK * (D + kPad);           // [kBQ][kBK + kPad]

  const int64_t bh = blockIdx.y;
  const int64_t b = bh / H;
  const int64_t h = bh % H;
  const int64_t kvh = h / (H / KV);
  const int64_t q0 = (int64_t)blockIdx.x * kBQ;
  const int tx = threadIdx.x % 8;   // column group
  const int ty = threadIdx.x / 8;   // row group: rows ty * 4 + i
  const int64_t q_offset = Skv - Sq;

  const int64_t q_stride = H * D, kv_stride = KV * D;
  const float* qb = q + (b * Sq + q0) * q_stride + h * D;
  const float* kb = k + b * Skv * kv_stride + kvh * D;
  const float* vb = v + b * Skv * kv_stride + kvh * D;
  const int q_rows = (int)imin(kBQ, Sq - q0);
  stage<D>(Qs, qb, q_stride, kBQ, q_rows);

  constexpr int kDC = D / 32;  // float4 groups of accumulator columns
  float acc[4][kDC][4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  // the last key any query of this tile may see
  int64_t k_end = Skv;
  if (causal) k_end = imin(Skv, q0 + kBQ + q_offset);
  for (int64_t k0 = 0; k0 < k_end; k0 += kBK) {
    const int k_rows = (int)imin(kBK, Skv - k0);
    __syncthreads();  // the previous tile's P . V is done with KVs and Ps
    stage<D>(KVs, kb + k0 * kv_stride, kv_stride, kBK, k_rows);
    __syncthreads();

    // s = q . k^T for rows ty*4+i, columns tx + 8j
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d0 = 0; d0 < D; d0 += 4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            Qs + (ty * 4 + i) * (D + kPad) + d0);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            KVs + (tx + 8 * j) * (D + kPad) + d0);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // online softmax: the 8 threads of a row group hold a row's columns
    // and sit in neighbouring lanes, so xor-shuffles over 1, 2, 4 reduce it
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t qpos = q0 + ty * 4 + i + q_offset;
      bool valid[8];
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int64_t kpos = k0 + tx + 8 * j;
        valid[j] = kpos < Skv && (!causal || kpos <= qpos);
        s[i][j] *= scale;
        if (valid[j]) mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, w));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        ls += p;
        Ps[(ty * 4 + i) * (kBK + kPad) + tx + 8 * j] = p;
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1)
        ls += __shfl_xor_sync(0xffffffffu, ls, w);
      l[i] = l[i] * alpha + ls;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha;
    }
    __syncthreads();  // every thread is done reading K from KVs
    stage<D>(KVs, vb + k0 * kv_stride, kv_stride, kBK, k_rows);
    __syncthreads();

    // acc += P . V for rows ty*4+i, columns tx*4 + 32c + e
#pragma unroll 2
    for (int j0 = 0; j0 < kBK; j0 += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(
            Ps + (ty * 4 + i) * (kBK + kPad) + j0);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < kDC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(
              KVs + (j0 + jj) * (D + kPad) + tx * 4 + 32 * c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = jj == 0 ? pv[i].x
                          : jj == 1 ? pv[i].y
                          : jj == 2 ? pv[i].z : pv[i].w;
            acc[i][c][0] = fmaf(p, vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(p, vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(p, vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(p, vv.w, acc[i][c][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= q_rows) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    float* orow = o + ((b * Sq + q0 + r) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kDC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        orow[tx * 4 + 32 * c + e] = acc[i][c][e] * inv;
  }
}

constexpr size_t smem_bytes(int d) {
  return sizeof(float) *
         ((size_t)(kBQ + kBK) * (d + kPad) + (size_t)kBQ * (kBK + kPad));
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int64_t B,
           int64_t H, int64_t KV, int64_t Sq, int64_t Skv, int causal,
           float scale, cudaStream_t stream) {
  auto kernel = flash_forward<D>;
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)(B * H));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, KV, Sq, Skv,
      causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: [B, Sq, H, d]; k, v: [B, Skv, KV, d]; all contiguous float32;
// d in {32, 64, 128}; H a multiple of KV; Sq, Skv >= 1; B * H <= 65535.
// scale multiplies q . k.
int flash_attention_forward(const void* q, const void* k, const void* v,
                            void* o, int64_t B, int64_t H, int64_t KV,
                            int64_t Sq, int64_t Skv, int64_t d, int causal,
                            float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
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

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
