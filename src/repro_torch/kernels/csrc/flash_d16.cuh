// Flash attention at head dim 16 on the CUDA cores, in float32:
// flash_attention_sm90_f32.cu launches it when d = 16 (bf16 d = 16 runs
// on flash_attention_sm90.cu's wgmma kernel, 32-column tiles whose 16
// columns past d TMA fills with zeros).
//
// Replaces the TPU Pallas kernel flash_attention_bhsd / _flash_kernel of
// the JAX package (src/repro/kernels/flash_attention/kernel.py:87, its
// pallas_call at :109) at d = 16, the head dim of every configuration's
// reduced() form. It computes what the wgmma kernels compute, in the same
// layout (q [B, Sq, H, 16], k/v [B, Skv, KV, 16], o like q), with GQA by
// index, the right-aligned causal mask (query i sees key j <= i + Skv -
// Sq), keys past Skv masked and a row that sees no key giving 0.
//
// Why not wgmma in fp32: the 3xTF32 kernel's pre-pass and split products
// cost more than this kernel at the reduced configs' shapes, where one
// query row per thread on the CUDA cores is simple and exact in fp32.
//
// What bounds it: operations, 4 * 16 flops per kept (query, key) pair on
// the CUDA cores (67 TFLOP/s fp32); at the reduced configs' shapes it is
// launch-bound.
//
// The design: a CTA of kD16Rows threads takes kD16Rows queries of one
// (b, h); thread t owns query q0 + t, its 16 q values (pre-scaled by
// scale * log2 e) and its 16 fp32 accumulators in registers. The CTA walks
// the keys in tiles of kD16Keys, staged in shared memory as fp32 by all
// threads (each key row is read once per CTA and broadcast to every
// thread), up to the CTA's causal frontier. Per tile a thread forms its
// kD16Keys scores, then updates its running max m, sum l and accumulators
// once (online softmax, exp2f). Every sum runs in a fixed order: reruns
// are bit-identical.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace d16 {

constexpr int kD = 16;
constexpr int kD16Rows = 128;   // queries (threads) per CTA
constexpr int kD16Keys = 64;    // keys per shared-memory tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }

// grid (B * H, ceil(Sq / kD16Rows)), block kD16Rows
template <typename T>
__global__ void __launch_bounds__(kD16Rows)
flash_forward_d16(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int H, int KV,
                  int Sq, int Skv, int causal, float scale_log2) {
  __shared__ float sk[kD16Keys][kD];
  __shared__ float sv[kD16Keys][kD];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.y * kD16Rows;
  const int row = q0 + threadIdx.x;
  const int q_offset = Skv - Sq;
  const int k_end = causal ? min(Skv, q0 + kD16Rows + q_offset) : Skv;
  const int64_t q_stride = static_cast<int64_t>(H) * kD;
  const int64_t kv_stride = static_cast<int64_t>(KV) * kD;

  float qr[kD], acc[kD];
  const T* qp = q + (static_cast<int64_t>(b) * Sq + row) * q_stride + h * kD;
#pragma unroll
  for (int c = 0; c < kD; ++c) {
    qr[c] = row < Sq ? to_f32(qp[c]) * scale_log2 : 0.f;
    acc[c] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  const T* kb = k + static_cast<int64_t>(b) * Skv * kv_stride + kvh * kD;
  const T* vb = v + static_cast<int64_t>(b) * Skv * kv_stride + kvh * kD;

  for (int k0 = 0; k0 < k_end; k0 += kD16Keys) {
    __syncthreads();   // the previous tile is consumed
    for (int i = threadIdx.x; i < kD16Keys * kD; i += kD16Rows) {
      const int j = k0 + i / kD, c = i % kD;
      const bool in = j < Skv;
      sk[i / kD][c] = in ? to_f32(kb[j * kv_stride + c]) : 0.f;
      sv[i / kD][c] = in ? to_f32(vb[j * kv_stride + c]) : 0.f;
    }
    __syncthreads();
    float s[kD16Keys];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kD16Keys; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < kD; ++c) dot = fmaf(qr[c], sk[j][c], dot);
      const int key = k0 + j;
      if (key >= Skv || (causal && key > row + q_offset)) dot = -INFINITY;
      s[j] = dot;
      mx = fmaxf(mx, dot);
    }
    const float mn = fmaxf(m, mx);
    // a row that has seen no key yet keeps p = 0 and alpha = 0
    const float ms = mn == -INFINITY ? 0.f : mn;
    const float alpha = exp2f(m - ms);
    m = mn;
    l *= alpha;
#pragma unroll
    for (int c = 0; c < kD; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < kD16Keys; ++j) {
      const float p = exp2f(s[j] - ms);
      l += p;
#pragma unroll
      for (int c = 0; c < kD; ++c) acc[c] = fmaf(p, sv[j][c], acc[c]);
    }
  }
  if (row >= Sq) return;
  const float inv = 1.f / (l == 0.f ? 1.f : l);
  T* op = o + (static_cast<int64_t>(b) * Sq + row) * q_stride + h * kD;
#pragma unroll
  for (int c = 0; c < kD; ++c) from_f32(op + c, acc[c] * inv);
}

template <typename T>
int launch_d16(const void* q, const void* k, const void* v, void* o,
               int64_t B, int64_t H, int64_t KV, int64_t Sq, int64_t Skv,
               int causal, float scale, cudaStream_t stream) {
  const dim3 grid((unsigned)(B * H),
                  (unsigned)((Sq + kD16Rows - 1) / kD16Rows));
  flash_forward_d16<T><<<grid, kD16Rows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), (int)H, (int)KV, (int)Sq,
      (int)Skv, causal, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace d16
