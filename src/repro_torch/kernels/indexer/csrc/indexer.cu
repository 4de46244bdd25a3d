// Lightning-indexer scores (DSA, DeepSeek-V3.2-Exp):
//   score[s] = sum_h w[h] * ReLU(q[h] . k[s])   in fp32, -2e38 where invalid.
//
// Replaces: src/repro/kernels/indexer/indexer.py:41 indexer_scores_kernel
// (Pallas; two MXU matmuls per 256-key block).  This is the general route
// (ops.general_scores): every shape and dtype that ops.tc_route does not
// send to the tensor-core kernel in indexer_tc.cu (fp32, small widths).
// The serve's bf16 calls at Di = 128 take that kernel.
//
// Bound.  The function reads the keys [S, Di] once per (b, q) and writes
// one fp32 score per key; it does Hi*(2*Di + 2) operations per valid key,
// about 64 per byte of a bf16 key at Hi = 64, Di = 128.  This kernel does
// them on fp32 CUDA cores, whose ridge on the H100 is about 20 operations
// per byte (67 TFLOP/s over 3.35 TB/s), so operations bound it at every
// shape, decode included; it cannot approach the function's bound (bytes
// at decode, operations at the bf16 tensor-core peak at prefill).
//
// Design: one CTA per (b*q, block of 128 keys), one thread per key.  The
// query heads and weights are staged once per CTA in shared memory as fp32
// (64 heads x 128 dims = 32 KB); a thread streams its key in 8-element
// chunks (one 16-byte load for bf16) and keeps the 64 per-head dot products
// in registers, so every shared-memory read is a broadcast float4 that
// feeds 4 FMAs.  More than 64 heads run in passes of 64.  Keys whose valid
// flag is false skip the arithmetic (half of a causal prefill chunk).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kHeadGroup = 64;
constexpr float kNegInf = -2.0e38f;

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
indexer_scores_kernel(const T* __restrict__ q, const T* __restrict__ w,
                      const T* __restrict__ keys,
                      const uint8_t* __restrict__ valid,
                      float* __restrict__ out, int nq, int S, int Hi, int Di,
                      int64_t valid_bstride, int64_t valid_qstride) {
  extern __shared__ float smem[];
  float* q_s = smem;                          // [kHeadGroup, Di]
  float* w_s = smem + kHeadGroup * Di;        // [kHeadGroup]

  const int bq = blockIdx.y;
  const int b = bq / nq;
  const int qi = bq % nq;
  const int s = blockIdx.x * kThreads + threadIdx.x;
  const T* qp = q + (int64_t)bq * Hi * Di;
  const T* wp = w + (int64_t)bq * Hi;
  const T* kp = keys + ((int64_t)b * S + (s < S ? s : 0)) * Di;
  bool ok = s < S;
  if (ok && valid != nullptr)
    ok = valid[b * valid_bstride + qi * valid_qstride + s] != 0;

  float score = 0.f;
  for (int h0 = 0; h0 < Hi; h0 += kHeadGroup) {
    const int hn = min(kHeadGroup, Hi - h0);
    __syncthreads();
    for (int i = threadIdx.x; i < kHeadGroup * Di; i += kThreads)
      q_s[i] = i < hn * Di ? to_f(qp[(int64_t)h0 * Di + i]) : 0.f;
    for (int i = threadIdx.x; i < kHeadGroup; i += kThreads)
      w_s[i] = i < hn ? to_f(wp[h0 + i]) : 0.f;
    __syncthreads();
    if (!ok) continue;
    float acc[kHeadGroup];
#pragma unroll
    for (int h = 0; h < kHeadGroup; ++h) acc[h] = 0.f;
    for (int d = 0; d < Di; d += 8) {
      float kv[8];
      load8(kp + d, kv);
#pragma unroll
      for (int h = 0; h < kHeadGroup; ++h) {
        const float4* qv = reinterpret_cast<const float4*>(q_s + h * Di + d);
        const float4 a = qv[0];
        const float4 c = qv[1];
        acc[h] += a.x * kv[0] + a.y * kv[1] + a.z * kv[2] + a.w * kv[3] +
                  c.x * kv[4] + c.y * kv[5] + c.z * kv[6] + c.w * kv[7];
      }
    }
#pragma unroll
    for (int h = 0; h < kHeadGroup; ++h)
      score += w_s[h] * fmaxf(acc[h], 0.f);
  }
  if (s < S) out[(int64_t)bq * S + s] = ok ? score : kNegInf;
}

template <typename T>
int launch(const void* q, const void* w, const void* keys,
           const uint8_t* valid, float* out, int B, int nq, int S, int Hi,
           int Di, int64_t vb, int64_t vq, cudaStream_t stream) {
  const dim3 grid((unsigned)((S + kThreads - 1) / kThreads),
                  (unsigned)(B * nq));
  const size_t smem = (size_t)(kHeadGroup * Di + kHeadGroup) * sizeof(float);
  indexer_scores_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)w, (const T*)keys, valid, out, nq, S, Hi, Di,
      vb, vq);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ess_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q [B,nq,Hi,Di], w [B,nq,Hi], keys [B,S,Di] (all of one dtype: 0 = fp32,
// 1 = bf16), valid uint8 at valid[b*vb + q*vq + s] or null -> out [B,nq,S].
// Di must be a multiple of 8 and at most 184 (48 KB of staged queries).
int ess_indexer_scores(const void* q, const void* w, const void* keys,
                       const void* valid, void* out, int B, int nq, int S,
                       int Hi, int Di, int64_t vb, int64_t vq, int dtype,
                       void* stream) {
  if (B * nq == 0 || S == 0) return 0;
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, w, keys, (const uint8_t*)valid,
                                 (float*)out, B, nq, S, Hi, Di, vb, vq,
                                 (cudaStream_t)stream);
  return launch<float>(q, w, keys, (const uint8_t*)valid, (float*)out, B,
                       nq, S, Hi, Di, vb, vq, (cudaStream_t)stream);
}

}  // extern "C"
