// Sparse-MLA flash partial (absorbed MLA decode = MQA over latent rows).
//
// Replaces: src/repro/kernels/sparse_mla/sparse_mla.py
// sparse_mla_partial_kernel (Pallas; online softmax over 128-row blocks on
// the MXU).  ESS calls it twice per layer and decode round (Attn0 over pool
// hits, Attn1 over fetched misses), once per layer in the warmup replay and
// once per layer and prefill chunk with per-query fp32 rows.  Per (b, q) it
// returns the UNNORMALIZED fp32 partial
//   s = scale * q[H,D] . rows[K,D]^T, masked by valid[K] (-2e38),
//   m = max_k s,  p = exp(s - m) (0 where invalid),  l = sum_k p,
//   o = p @ rows[:, :rank]
// so the two halves merge exactly (models/mla.merge_partials).
//
// Bound: bytes at decode.  Per (b, q) the K x 576 rows are read once and
// shared by all 128 heads: 2*H*K*(D+rank) flops against 2*K*D bytes, about
// 240 flops per byte in bf16, just under the H100's ~295 ridge, so a fast
// version is close to balanced; this first version runs its products on
// the CUDA cores in fp32 and is bound by them, far from either roofline.
//
// Design: one CTA per (b*q, block of 16 heads); 256 threads.  The 16 query
// rows are staged once in shared memory as fp32.  The loop over K stages
// 32-row tiles in shared memory (fp32, rows padded by 4 floats so the
// score loads are bank-conflict free) and runs three phases per tile:
//   scores:  thread (head pair, row) -> 2 dot products over D in float4s;
//   softmax: warp w owns heads 2w, 2w+1 with the row index on the lanes
//            (warp max / sum, running m and l in registers);
//   p @ V:   thread t owns output columns t and t+256 for all 16 heads
//            (32 fp32 accumulators), rescaled by exp(m_old - m_new).
// fp32 math and accumulation for bf16 and fp32 inputs, as the Pallas
// kernel.  At decode (b*q = 4) the grid is 32 CTAs, so most of the 132 SMs
// idle: split-K across CTAs, TMA-fed tiles and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHB = 16;          // heads per CTA (2 per warp)
constexpr int kKT = 32;          // rows per tile (one per lane)
constexpr int kColGroups = 2;    // rank <= kColGroups * kThreads
constexpr int kPad = 4;          // row padding (floats) in shared memory
constexpr float kNegInf = -2.0e38f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

size_t smem_bytes(int D) {
  return (size_t)(kHB * D + kKT * (D + kPad) + 2 * kHB * kKT + kHB + kKT) *
         sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sparse_mla_partial_kernel(const T* __restrict__ q, const T* __restrict__ rows,
                          const uint8_t* __restrict__ valid,
                          float* __restrict__ o, float* __restrict__ m_out,
                          float* __restrict__ l_out, int nq, int H, int K,
                          int D, int rank, float scale, int64_t rows_bstride,
                          int64_t rows_qstride, int64_t valid_bstride,
                          int64_t valid_qstride) {
  extern __shared__ float smem[];
  const int DP = D + kPad;
  float* q_s = smem;                    // [kHB][D]
  float* r_s = q_s + kHB * D;           // [kKT][DP]
  float* s_s = r_s + kKT * DP;          // [kHB][kKT] scaled, masked scores
  float* p_s = s_s + kHB * kKT;         // [kKT][kHB] probabilities
  float* c_s = p_s + kKT * kHB;         // [kHB] rescale factors
  float* v_s = c_s + kHB;               // [kKT] valid flags

  const int bq = blockIdx.x;
  const int b = bq / nq;
  const int qi = bq % nq;
  const int h0 = blockIdx.y * kHB;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* qp = q + ((int64_t)bq * H + h0) * D;
  const T* rp = rows + b * rows_bstride + qi * rows_qstride;
  const uint8_t* vp = valid + b * valid_bstride + qi * valid_qstride;

  for (int i = tid; i < kHB * D; i += kThreads)
    q_s[i] = (h0 + i / D < H) ? to_f(qp[i]) : 0.f;

  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};
  float acc[kHB][kColGroups];
#pragma unroll
  for (int h = 0; h < kHB; ++h)
#pragma unroll
    for (int j = 0; j < kColGroups; ++j) acc[h][j] = 0.f;

  const int D4 = D / 4;
  for (int k0 = 0; k0 < K; k0 += kKT) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kKT * D4; i += kThreads) {
      const int r = i / D4;
      const int c4 = i - r * D4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < K) v = load4(rp + (int64_t)(k0 + r) * D + c4 * 4);
      *reinterpret_cast<float4*>(r_s + r * DP + c4 * 4) = v;
    }
    if (tid < kKT)
      v_s[tid] = (k0 + tid < K && vp[k0 + tid] != 0) ? 1.f : 0.f;
    __syncthreads();

    {  // scores: heads 2*warp, 2*warp+1 against tile row `lane`
      const float4* r4 = reinterpret_cast<const float4*>(r_s + lane * DP);
      const float4* qa = reinterpret_cast<const float4*>(q_s + 2 * warp * D);
      const float4* qb = reinterpret_cast<const float4*>(q_s + (2 * warp + 1) * D);
      float sa = 0.f, sb = 0.f;
      for (int c = 0; c < D4; ++c) {
        const float4 r = r4[c];
        const float4 a = qa[c];
        const float4 e = qb[c];
        sa += a.x * r.x + a.y * r.y + a.z * r.z + a.w * r.w;
        sb += e.x * r.x + e.y * r.y + e.z * r.z + e.w * r.w;
      }
      const bool ok = v_s[lane] > 0.5f;
      s_s[(2 * warp) * kKT + lane] = ok ? sa * scale : kNegInf;
      s_s[(2 * warp + 1) * kKT + lane] = ok ? sb * scale : kNegInf;
    }
    __syncwarp();

    {  // online softmax for the same two heads (same warp: no block sync)
      const bool ok = v_s[lane] > 0.5f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int h = 2 * warp + j;
        const float s = s_s[h * kKT + lane];
        const float m_new = fmaxf(m_run[j], warp_max(s));
        const float p = ok ? expf(s - m_new) : 0.f;
        const float corr = expf(m_run[j] - m_new);
        l_run[j] = l_run[j] * corr + warp_sum(p);
        m_run[j] = m_new;
        p_s[lane * kHB + h] = p;
        if (lane == 0) c_s[h] = corr;
      }
    }
    __syncthreads();

    // p @ rows[:, :rank]
#pragma unroll
    for (int h = 0; h < kHB; ++h) {
      const float c = c_s[h];
#pragma unroll
      for (int j = 0; j < kColGroups; ++j) acc[h][j] *= c;
    }
    for (int k = 0; k < kKT; ++k) {
      const float4* p4 = reinterpret_cast<const float4*>(p_s + k * kHB);
      float pk[kHB];
#pragma unroll
      for (int u = 0; u < kHB / 4; ++u) {
        const float4 t = p4[u];
        pk[4 * u] = t.x; pk[4 * u + 1] = t.y;
        pk[4 * u + 2] = t.z; pk[4 * u + 3] = t.w;
      }
#pragma unroll
      for (int j = 0; j < kColGroups; ++j) {
        const int c = tid + j * kThreads;
        const float r = c < rank ? r_s[k * DP + c] : 0.f;
#pragma unroll
        for (int h = 0; h < kHB; ++h) acc[h][j] += pk[h] * r;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kColGroups; ++j) {
    const int c = tid + j * kThreads;
    if (c >= rank) continue;
#pragma unroll
    for (int h = 0; h < kHB; ++h)
      if (h0 + h < H) o[((int64_t)bq * H + h0 + h) * rank + c] = acc[h][j];
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int h = h0 + 2 * warp + j;
      if (h < H) {
        m_out[(int64_t)bq * H + h] = m_run[j];
        l_out[(int64_t)bq * H + h] = l_run[j];
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* rows, const uint8_t* valid, float* o,
           float* m, float* l, int B, int nq, int H, int K, int D, int rank,
           float scale, int64_t rb, int64_t rq, int64_t vb, int64_t vq,
           cudaStream_t stream) {
  static size_t configured = 0;
  const size_t smem = smem_bytes(D);
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        sparse_mla_partial_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  const dim3 grid((unsigned)(B * nq), (unsigned)((H + kHB - 1) / kHB));
  sparse_mla_partial_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)rows, valid, o, m, l, nq, H, K, D, rank, scale,
      rb, rq, vb, vq);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ess_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// q [B,nq,H,D]; rows at rows + b*rb + q*rq, K rows of D (rq = 0: shared
// over q); valid uint8 at valid + b*vb + q*vq.  q and rows share a dtype
// (0 = fp32, 1 = bf16).  Outputs fp32: o [B,nq,H,rank], m/l [B,nq,H].
// Requires D % 4 == 0, D <= 1024, rank <= 512.
int ess_sparse_mla_partial(const void* q, const void* rows, const void* valid,
                           void* o, void* m, void* l, int B, int nq, int H,
                           int K, int D, int rank, float scale, int64_t rb,
                           int64_t rq, int64_t vb, int64_t vq, int dtype,
                           void* stream) {
  if (B * nq == 0 || H == 0) return 0;
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, rows, (const uint8_t*)valid, (float*)o,
                                 (float*)m, (float*)l, B, nq, H, K, D, rank,
                                 scale, rb, rq, vb, vq, (cudaStream_t)stream);
  return launch<float>(q, rows, (const uint8_t*)valid, (float*)o, (float*)m,
                       (float*)l, B, nq, H, K, D, rank, scale, rb, rq, vb,
                       vq, (cudaStream_t)stream);
}

}  // extern "C"
