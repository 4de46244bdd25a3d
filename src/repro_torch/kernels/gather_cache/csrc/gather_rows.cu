// FlashTrans row and page gathers over UVA (paper section 3.1), their
// fused int8/fp8 dequant variants, and the write-back scatter.
//
// Replaces, in src/repro/kernels/gather_cache/gather_cache.py:
//   gather_rows_kernel               -> gather_rows_kernel (direct route),
//                                       mark/fetch/expand (staged route),
//                                       gather_rows_raw_kernel (the slab)
//   gather_rows_dequant_kernel       -> gather_rows_dequant_kernel (direct),
//                                       mark/fetch_dequant/expand (staged)
//   gather_row_blocks_kernel         -> gather_pages_kernel
//   gather_row_blocks_dequant_kernel -> gather_pages_dequant_kernel
// The Pallas kernels move one row (or page) per grid step.  On the H100
// the latent tier lives in pinned host memory; these kernels dereference
// the tier's UVA device pointer directly, so the scattered rows cross PCIe
// as the threads' own 16-byte loads and land packed in device memory: no
// host-side gather and no host staging copy.
//
// Bound: bytes, and the host link (about 55 GB/s) rather than HBM
// (3.35 TB/s) for every byte read from the tier.  Two routes for the row
// gathers, chosen by the wrapper from shapes alone (ops.staged_route):
// * direct (M ids <= S tier rows: the decode miss fetch, the warmup
//   replay): one warp per row; every load of the row -- its 16-byte
//   payload vectors and, for dequant, its f16 scale, read by every lane
//   from the same address -- is issued before any is consumed, so a row
//   costs one PCIe round trip, and the whole launch's rows are in flight
//   at once at M = 1024 and M = 8192.
// * staged (M > S, so ids must repeat: the prefill, where every query of
//   a slot picks among the same prior rows): each distinct row crosses
//   PCIe once per launch.  mark sets flags[clip(id)] for every live id
//   (a flag plane [S] cleared per launch; every writer stores the same 1,
//   so no winner is needed: the staging slot of a row is the row itself);
//   fetch reads each flagged row once over UVA into an HBM staging buffer
//   [S, row] (dequantized there for the fused variant); expand is the
//   direct kernel run from that buffer, out[i] = staging[clip(ids[i])],
//   with streaming stores so the output (M rows, GBs) does not evict the
//   staging rows from L2.  Nothing depends on an order of atomics, so the
//   result is deterministic.
// * pages: one 256-thread block per (layer, page), so one launch covers
//   every layer and a 64-row page (72 KB in bf16) is spread over 256
//   threads instead of one warp.  The dequant variant first stages the
//   page's scales in shared memory (one coalesced read of R x 2 bytes).
// The widening is exact (int8 and e4m3 both fit f16/fp32; e4m3 pairs go
// through the paired converter), the product is one fp32 multiply and the
// bf16 result is rounded to nearest even, so the output equals the plain
// PyTorch version (q.float() * s.float()) bit for bit.
//
// * raw (the pipelined round's staging slab): the direct route's warp per
//   id, copying the tier's stored bytes with no widening -- a bf16 row, or
//   a quantized row's int8/fp8 payload and, in the same launch, its 2-byte
//   f16 scale (lane 0 loads it beside the payload vectors), so the slab
//   holds the tier's own bytes and dequantizes later at miss width.
//
// A launch of a row gather may be given a counter (int32 on the device):
// it adds the number of tier rows the launch read over the link (the live
// ids on the direct route, the distinct flagged rows on the staged one).
//
// scatter_rows is the device-side write of new rows into the tier through
// the same mapping (it replaces the XLA host-compute scatter of
// offload.host_scatter_rows, not a Pallas kernel).  Rows that are 16-byte
// multiples go one warp per row; narrower rows (the 2-byte scale plane of
// a quantized tier) go one thread per 1/2/4/8-byte unit.  It runs on the
// caller's stream, so a later gather on that stream sees the rows.
//
// Index semantics follow the reference: gather ids below 0 give zero rows,
// ids past the end read the last row (jnp.clip); page ids are clipped to
// [0, pages-1] (the caller zeroes unmapped pages); scatter targets outside
// [0, n) are dropped (mode="drop").

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kUnroll = 4;

// Copies one row of vpr 16-byte vectors with the warp: every load is issued
// before the first store.
template <bool kStream>
__device__ __forceinline__ void copy_row_warp(const uint4* __restrict__ srow,
                                              uint4* __restrict__ dst,
                                              int vpr, int lane) {
  for (int base = 0; base < vpr; base += 32 * kUnroll) {
    uint4 buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * 32 + lane;
      if (j < vpr) buf[u] = srow[j];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * 32 + lane;
      if (j < vpr) {
        if constexpr (kStream) __stcs(dst + j, buf[u]);
        else dst[j] = buf[u];
      }
    }
  }
}

// out[i] = src[clip(ids[i], 0, s-1)], zero rows where ids[i] < 0; one warp
// per row.  kStream: evict-first stores (the staged route's expand).
template <bool kStream>
__global__ void gather_rows_kernel(const uint4* __restrict__ src,
                                   const int64_t* __restrict__ ids,
                                   uint4* __restrict__ out, int64_t m,
                                   int64_t s, int vpr, int* __restrict__ count) {
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= m) return;
  const int lane = threadIdx.x & 31;
  int64_t id = ids[row];
  uint4* dst = out + row * vpr;
  if (id < 0) {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int j = lane; j < vpr; j += 32) {
      if constexpr (kStream) __stcs(dst + j, z);
      else dst[j] = z;
    }
    return;
  }
  if (id >= s) id = s - 1;
  copy_row_warp<kStream>(src + id * vpr, dst, vpr, lane);
  if (count != nullptr && lane == 0) atomicAdd(count, 1);
}

// The raw gather: out[i] = src[clip(ids[i])] and, with kScales, out_s[i] =
// scales[clip(ids[i])] (the f16 scale as its 16 bits); zero rows and zero
// scales where ids[i] < 0, which read nothing from src.  One warp per row.
template <bool kScales>
__global__ void gather_rows_raw_kernel(const uint4* __restrict__ src,
                                       const uint16_t* __restrict__ scales,
                                       const int64_t* __restrict__ ids,
                                       uint4* __restrict__ out,
                                       uint16_t* __restrict__ out_s, int64_t m,
                                       int64_t s, int vpr,
                                       int* __restrict__ count) {
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= m) return;
  const int lane = threadIdx.x & 31;
  int64_t id = ids[row];
  uint4* dst = out + row * vpr;
  if (id < 0) {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int j = lane; j < vpr; j += 32) dst[j] = z;
    if (kScales && lane == 0) out_s[row] = 0;
    return;
  }
  if (id >= s) id = s - 1;
  uint16_t sv = 0;
  if (kScales && lane == 0) sv = scales[id];   // in flight with the payload
  copy_row_warp<false>(src + id * vpr, dst, vpr, lane);
  if (lane == 0) {
    if (kScales) out_s[row] = sv;
    if (count != nullptr) atomicAdd(count, 1);
  }
}

// ---- the staged route: mark, fetch, expand ------------------------------

// flags[clip(ids[i])] = 1 for every ids[i] >= 0 (flags cleared before).
__global__ void mark_rows_kernel(const int64_t* __restrict__ ids,
                                 int* __restrict__ flags, int64_t m,
                                 int64_t s) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += (int64_t)gridDim.x * blockDim.x) {
    int64_t id = ids[i];
    if (id < 0) continue;
    if (id >= s) id = s - 1;
    if (__ldcg(flags + id) == 0) flags[id] = 1;   // most ids are repeats
  }
}

// staging[r] = src[r] for every flagged row r: each read once over UVA.
__global__ void fetch_marked_rows_kernel(const uint4* __restrict__ src,
                                         const int* __restrict__ flags,
                                         uint4* __restrict__ staging,
                                         int64_t s, int vpr,
                                         int* __restrict__ count) {
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= s || flags[row] == 0) return;
  const int lane = threadIdx.x & 31;
  copy_row_warp<false>(src + row * vpr, staging + row * vpr, vpr, lane);
  if (count != nullptr && lane == 0) atomicAdd(count, 1);
}

__global__ void scatter_rows_kernel(uint4* __restrict__ dst,
                                    const int64_t* __restrict__ tgt,
                                    const uint4* __restrict__ rows,
                                    int64_t m, int64_t n, int vecs_per_row) {
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= m) return;
  const int64_t t = tgt[row];
  if (t < 0 || t >= n) return;
  copy_row_warp<false>(rows + row * vecs_per_row, dst + t * vecs_per_row,
                       vecs_per_row, threadIdx.x & 31);
}

template <typename U>
__global__ void scatter_units_kernel(U* __restrict__ dst,
                                     const int64_t* __restrict__ tgt,
                                     const U* __restrict__ rows, int64_t m,
                                     int64_t n, int64_t units_per_row) {
  const int64_t total = m * units_per_row;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = i / units_per_row;
    const int64_t t = tgt[r];
    if (t < 0 || t >= n) continue;
    dst[t * units_per_row + (i - r * units_per_row)] = rows[i];
  }
}

// ---- dequant helpers ---------------------------------------------------

struct Int8Q {};
struct Fp8Q {};

// 16 payload bytes -> 16 floats (exact: int8 and e4m3 fit fp32)
template <typename Q>
__device__ __forceinline__ void widen16(const uint4 in, float (&f)[16]) {
  if constexpr (std::is_same_v<Q, Fp8Q>) {
    // two e4m3 per conversion (cvt.rn.f16x2.e4m3x2); the low byte is .x
    const __nv_fp8x2_storage_t* p =
        reinterpret_cast<const __nv_fp8x2_storage_t*>(&in);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(p[k], __NV_E4M3);
      const float2 v = __half22float2(__half2(h));
      f[2 * k] = v.x;
      f[2 * k + 1] = v.y;
    }
  } else {
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&in);
#pragma unroll
    for (int k = 0; k < 16; ++k) f[k] = (float)(int8_t)b[k];
  }
}

// 16 payload bytes times one scale -> 16 outputs (64 B fp32 / 32 B bf16)
template <typename Q, typename O>
__device__ __forceinline__ void dequant16(const uint4 in, const float s,
                                          O* __restrict__ out) {
  float f[16];
  widen16<Q>(in, f);
  if constexpr (sizeof(O) == 4) {
    float4* o = reinterpret_cast<float4*>(out);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      o[k] = make_float4(f[4 * k] * s, f[4 * k + 1] * s, f[4 * k + 2] * s,
                         f[4 * k + 3] * s);
  } else {
    uint4 w[2];
    __nv_bfloat162* wb = reinterpret_cast<__nv_bfloat162*>(w);
#pragma unroll
    for (int k = 0; k < 8; ++k)     // round to nearest even, .x = low half
      wb[k] = __floats2bfloat162_rn(f[2 * k] * s, f[2 * k + 1] * s);
    uint4* o = reinterpret_cast<uint4*>(out);
    o[0] = w[0];
    o[1] = w[1];
  }
}

// One row of d payload bytes (vpr = d / 16 vectors) and its f16 scale ->
// d outputs, by the warp.  The scale (one address for every lane: one
// transaction) and every payload vector are loaded before any is used, so
// the row costs one round trip over the link.
template <typename Q, typename O>
__device__ __forceinline__ void dequant_row_warp(const uint4* __restrict__ srow,
                                                 const __half* __restrict__ sp,
                                                 O* __restrict__ dst, int vpr,
                                                 int lane) {
  const __half sh = *sp;
  for (int base = 0; base < vpr; base += 32 * kUnroll) {
    uint4 buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * 32 + lane;
      if (j < vpr) buf[u] = srow[j];
    }
    const float sc = __half2float(sh);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * 32 + lane;
      if (j < vpr) dequant16<Q, O>(buf[u], sc, dst + j * 16);
    }
  }
}

// out[i] = dequant(src[clip(ids[i])], scales[clip(ids[i])]); zero rows where
// ids[i] < 0.  d is a multiple of 16 (payload row = d bytes).
template <typename Q, typename O>
__global__ void gather_rows_dequant_kernel(const uint4* __restrict__ src,
                                           const __half* __restrict__ scales,
                                           const int64_t* __restrict__ ids,
                                           O* __restrict__ out, int64_t m,
                                           int64_t s, int d,
                                           int* __restrict__ count) {
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= m) return;
  const int lane = threadIdx.x & 31;
  int64_t id = ids[row];
  O* dst = out + row * d;
  if (id < 0) {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    const int n4 = d * (int)sizeof(O) / 16;
    for (int j = lane; j < n4; j += 32) d4[j] = z;
    return;
  }
  if (id >= s) id = s - 1;
  const int vpr = d / 16;
  dequant_row_warp<Q, O>(src + id * vpr, scales + id, dst, vpr, lane);
  if (count != nullptr && lane == 0) atomicAdd(count, 1);
}

// staging[r] = dequant(src[r], scales[r]) for every flagged row r: each
// payload row and scale read once over UVA, widened once.
template <typename Q, typename O>
__global__ void fetch_marked_rows_dequant_kernel(
    const uint4* __restrict__ src, const __half* __restrict__ scales,
    const int* __restrict__ flags, O* __restrict__ staging, int64_t s, int d,
    int* __restrict__ count) {
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= s || flags[row] == 0) return;
  const int lane = threadIdx.x & 31;
  const int vpr = d / 16;
  dequant_row_warp<Q, O>(src + row * vpr, scales + row, staging + row * d,
                         vpr, lane);
  if (count != nullptr && lane == 0) atomicAdd(count, 1);
}

constexpr int kPageThreads = 256;

// One block per (page i, layer l): out[l, i*R:(i+1)*R] = src[l, page*R:...]
// with page = clip(ids[l, i], 0, npages-1).  vpp = 16-byte vectors per page.
__global__ void gather_pages_kernel(const uint4* __restrict__ src,
                                    const int64_t* __restrict__ ids,
                                    uint4* __restrict__ out, int64_t nb,
                                    int64_t npages, int64_t vpp) {
  const int64_t i = blockIdx.x, l = blockIdx.y;
  int64_t page = ids[l * nb + i];
  page = page < 0 ? 0 : (page >= npages ? npages - 1 : page);
  const uint4* sp = src + (l * npages + page) * vpp;
  uint4* dp = out + (l * nb + i) * vpp;
  for (int64_t base = 0; base < vpp; base += kPageThreads * kUnroll) {
    uint4 buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = base + u * kPageThreads + threadIdx.x;
      if (j < vpp) buf[u] = sp[j];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = base + u * kPageThreads + threadIdx.x;
      if (j < vpp) dp[j] = buf[u];
    }
  }
}

// gather_pages_kernel with per-row dequant: rows of r payload bytes d, the
// page's scales staged in shared memory kScaleTile rows at a time.
constexpr int kScaleTile = 256;

template <typename Q, typename O>
__global__ void gather_pages_dequant_kernel(const uint4* __restrict__ src,
                                            const __half* __restrict__ scales,
                                            const int64_t* __restrict__ ids,
                                            O* __restrict__ out, int64_t nb,
                                            int64_t npages, int r, int d) {
  __shared__ float sc[kScaleTile];
  const int64_t i = blockIdx.x, l = blockIdx.y;
  int64_t page = ids[l * nb + i];
  page = page < 0 ? 0 : (page >= npages ? npages - 1 : page);
  const int64_t row0 = (l * npages + page) * r;      // first source row
  const int vpr = d / 16;
  const uint4* sp = src + row0 * vpr;
  const __half* ss = scales + row0;
  O* dp = out + (l * nb + i) * (int64_t)r * d;
  for (int t0 = 0; t0 < r; t0 += kScaleTile) {
    const int rows = min(kScaleTile, r - t0);
    __syncthreads();                   // the previous tile's readers are done
    if ((int)threadIdx.x < rows)
      sc[threadIdx.x] = __half2float(ss[t0 + threadIdx.x]);
    __syncthreads();
    const int nv = rows * vpr;
    const uint4* tp = sp + (int64_t)t0 * vpr;
    O* to = dp + (int64_t)t0 * d;
    for (int base = 0; base < nv; base += kPageThreads * kUnroll) {
      uint4 buf[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + u * kPageThreads + threadIdx.x;
        if (j < nv) buf[u] = tp[j];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + u * kPageThreads + threadIdx.x;
        if (j < nv) dequant16<Q, O>(buf[u], sc[j / vpr], to + (int64_t)j * 16);
      }
    }
  }
}

}  // namespace

extern "C" {

const char* ess_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Device address of a pinned (page-locked, mapped) host allocation.
int ess_uva_pointer(void* host, void** dev) {
  return (int)cudaHostGetDevicePointer(dev, host, 0);
}

static dim3 row_grid(int64_t rows) {
  return dim3((unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock));
}

// out[i] = src[clip(ids[i], 0, s-1)], zero rows where ids[i] < 0 (direct
// route).  src: device or UVA pointer to s rows of row_bytes (a multiple of
// 16).  count (may be null): += rows read from src.
int ess_gather_rows(const void* src, const int64_t* ids, void* out,
                    int64_t m, int64_t s, int64_t row_bytes, int* count,
                    void* stream) {
  if (m == 0) return 0;
  gather_rows_kernel<false><<<row_grid(m), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)src, ids, (uint4*)out, m, s, (int)(row_bytes / 16),
      count);
  return (int)cudaGetLastError();
}

// The raw gather (direct route, no widening): out[i] = src[c] and, when
// scales is not null, out_scales[i] = scales[c] (f16, one per row), c =
// clip(ids[i]); zero rows and scales where ids[i] < 0.  row_bytes is a
// multiple of 16.  count (may be null): += rows read from src.
int ess_gather_rows_raw(const void* src, const void* scales,
                        const int64_t* ids, void* out, void* out_scales,
                        int64_t m, int64_t s, int64_t row_bytes, int* count,
                        void* stream) {
  if (m == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int vpr = (int)(row_bytes / 16);
  if (scales != nullptr)
    gather_rows_raw_kernel<true><<<row_grid(m), kThreads, 0, st>>>(
        (const uint4*)src, (const uint16_t*)scales, ids, (uint4*)out,
        (uint16_t*)out_scales, m, s, vpr, count);
  else
    gather_rows_raw_kernel<false><<<row_grid(m), kThreads, 0, st>>>(
        (const uint4*)src, nullptr, ids, (uint4*)out, nullptr, m, s, vpr,
        count);
  return (int)cudaGetLastError();
}

// The grid of the mark pass: a grid-stride loop over the m ids.
static dim3 mark_grid(int64_t m) {
  int64_t blocks = (m + kThreads - 1) / kThreads;
  return dim3((unsigned)(blocks < 4096 ? blocks : 4096));
}

// The same result by the staged route: mark the distinct clipped live ids
// in flags [s] (int32, scratch), fetch each marked row once into staging
// [s, row_bytes] (device scratch), expand staging to out.
int ess_gather_rows_staged(const void* src, const int64_t* ids, void* out,
                           void* staging, int* flags, int64_t m, int64_t s,
                           int64_t row_bytes, int* count, void* stream) {
  if (m == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int vpr = (int)(row_bytes / 16);
  int rc = (int)cudaMemsetAsync(flags, 0, (size_t)s * sizeof(int), st);
  if (rc) return rc;
  mark_rows_kernel<<<mark_grid(m), kThreads, 0, st>>>(ids, flags, m, s);
  if ((rc = (int)cudaGetLastError())) return rc;
  fetch_marked_rows_kernel<<<row_grid(s), kThreads, 0, st>>>(
      (const uint4*)src, flags, (uint4*)staging, s, vpr, count);
  if ((rc = (int)cudaGetLastError())) return rc;
  gather_rows_kernel<true><<<row_grid(m), kThreads, 0, st>>>(
      (const uint4*)staging, ids, (uint4*)out, m, s, vpr, nullptr);
  return (int)cudaGetLastError();
}

// dst[tgt[i]] = rows[i] where 0 <= tgt[i] < n; other rows are dropped.
// Rows of any byte width: 16-byte multiples (with 16-byte aligned bases)
// go one warp per row, others one thread per 8/4/2/1-byte unit.
int ess_scatter_rows(void* dst, const int64_t* tgt, const void* rows,
                     int64_t m, int64_t n, int64_t row_bytes, void* stream) {
  if (m == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const uint64_t align = (uint64_t)(uintptr_t)dst | (uint64_t)(uintptr_t)rows |
                         (uint64_t)row_bytes;
  if (align % 16 == 0) {
    const int vpr = (int)(row_bytes / 16);
    scatter_rows_kernel<<<row_grid(m), kThreads, 0, st>>>(
        (uint4*)dst, tgt, (const uint4*)rows, m, n, vpr);
    return (int)cudaGetLastError();
  }
  const int unit = align % 8 == 0   ? 8
                   : align % 4 == 0 ? 4
                   : align % 2 == 0 ? 2
                                    : 1;
  const int64_t upr = row_bytes / unit;
  const int64_t total = m * upr;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;
  const dim3 grid((unsigned)blocks);
  switch (unit) {
    case 8:
      scatter_units_kernel<<<grid, kThreads, 0, st>>>(
          (uint2*)dst, tgt, (const uint2*)rows, m, n, upr);
      break;
    case 4:
      scatter_units_kernel<<<grid, kThreads, 0, st>>>(
          (uint32_t*)dst, tgt, (const uint32_t*)rows, m, n, upr);
      break;
    case 2:
      scatter_units_kernel<<<grid, kThreads, 0, st>>>(
          (uint16_t*)dst, tgt, (const uint16_t*)rows, m, n, upr);
      break;
    default:
      scatter_units_kernel<<<grid, kThreads, 0, st>>>(
          (uint8_t*)dst, tgt, (const uint8_t*)rows, m, n, upr);
  }
  return (int)cudaGetLastError();
}

// out[i] = bf16|f32(float(src[c]) * float(scales[c])), c = clip(ids[i]);
// zero rows where ids[i] < 0 (direct route).  qkind: 0 int8, 1 e4m3;
// okind: 0 f32, 1 bf16.  d (payload bytes per row) is a multiple of 16.
// count (may be null): += rows read from src.
int ess_gather_rows_dequant(const void* src, const void* scales,
                            const int64_t* ids, void* out, int64_t m,
                            int64_t s, int64_t d, int qkind, int okind,
                            int* count, void* stream) {
  if (m == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const uint4* sp = (const uint4*)src;
  const __half* sc = (const __half*)scales;
#define ESS_GRD(Q, O)                                              \
  gather_rows_dequant_kernel<Q, O><<<row_grid(m), kThreads, 0, st>>>( \
      sp, sc, ids, (O*)out, m, s, (int)d, count)
  if (qkind == 0 && okind == 0) ESS_GRD(Int8Q, float);
  else if (qkind == 0) ESS_GRD(Int8Q, __nv_bfloat16);
  else if (okind == 0) ESS_GRD(Fp8Q, float);
  else ESS_GRD(Fp8Q, __nv_bfloat16);
#undef ESS_GRD
  return (int)cudaGetLastError();
}

// The same result by the staged route: mark as ess_gather_rows_staged,
// fetch and dequantize each marked row once into staging [s, d] of the
// output dtype, expand staging to out.
int ess_gather_rows_dequant_staged(const void* src, const void* scales,
                                   const int64_t* ids, void* out,
                                   void* staging, int* flags, int64_t m,
                                   int64_t s, int64_t d, int qkind, int okind,
                                   int* count, void* stream) {
  if (m == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const uint4* sp = (const uint4*)src;
  const __half* sc = (const __half*)scales;
  int rc = (int)cudaMemsetAsync(flags, 0, (size_t)s * sizeof(int), st);
  if (rc) return rc;
  mark_rows_kernel<<<mark_grid(m), kThreads, 0, st>>>(ids, flags, m, s);
  if ((rc = (int)cudaGetLastError())) return rc;
#define ESS_FMD(Q, O)                                                    \
  fetch_marked_rows_dequant_kernel<Q, O><<<row_grid(s), kThreads, 0, st>>>( \
      sp, sc, flags, (O*)staging, s, (int)d, count)
  if (qkind == 0 && okind == 0) ESS_FMD(Int8Q, float);
  else if (qkind == 0) ESS_FMD(Int8Q, __nv_bfloat16);
  else if (okind == 0) ESS_FMD(Fp8Q, float);
  else ESS_FMD(Fp8Q, __nv_bfloat16);
#undef ESS_FMD
  if ((rc = (int)cudaGetLastError())) return rc;
  const int vpr = (int)(d * (okind == 0 ? 4 : 2) / 16);
  gather_rows_kernel<true><<<row_grid(m), kThreads, 0, st>>>(
      (const uint4*)staging, ids, (uint4*)out, m, s, vpr, nullptr);
  return (int)cudaGetLastError();
}

// out[l, i] = src[l, clip(ids[l, i])] page by page; src [L, npages, page]
// and out [L, nb, page], page_bytes a multiple of 16.
int ess_gather_pages(const void* src, const int64_t* ids, void* out,
                     int64_t layers, int64_t nb, int64_t npages,
                     int64_t page_bytes, void* stream) {
  if (layers == 0 || nb == 0) return 0;
  const dim3 grid((unsigned)nb, (unsigned)layers);
  gather_pages_kernel<<<grid, kPageThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)src, ids, (uint4*)out, nb, npages, page_bytes / 16);
  return (int)cudaGetLastError();
}

// ess_gather_pages with per-row dequant: src [L, npages*r, d] int8/e4m3,
// scales [L, npages*r] f16 -> out [L, nb*r, d] f32/bf16 (kinds as above).
int ess_gather_pages_dequant(const void* src, const void* scales,
                             const int64_t* ids, void* out, int64_t layers,
                             int64_t nb, int64_t npages, int64_t r, int64_t d,
                             int qkind, int okind, void* stream) {
  if (layers == 0 || nb == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)nb, (unsigned)layers);
  const uint4* sp = (const uint4*)src;
  const __half* sc = (const __half*)scales;
#define ESS_GPD(Q, O)                                                         \
  gather_pages_dequant_kernel<Q, O><<<grid, kPageThreads, 0, st>>>(           \
      sp, sc, ids, (O*)out, nb, npages, (int)r, (int)d)
  if (qkind == 0 && okind == 0) ESS_GPD(Int8Q, float);
  else if (qkind == 0) ESS_GPD(Int8Q, __nv_bfloat16);
  else if (okind == 0) ESS_GPD(Fp8Q, float);
  else ESS_GPD(Fp8Q, __nv_bfloat16);
#undef ESS_GPD
  return (int)cudaGetLastError();
}

}  // extern "C"
