// FlashTrans row gather over UVA (paper section 3.1) and its write-back twin.
//
// Replaces: src/repro/kernels/gather_cache/gather_cache.py gather_rows_kernel
// (the Pallas row gather, one row DMA per grid step), which the reference's
// serve path reaches through offload.host_gather_rows.  On the H100 the
// latent tier lives in pinned host memory; this kernel dereferences the
// tier's UVA device pointer directly, so the scattered 1152-byte rows cross
// PCIe as the warp's own 16-byte loads and land packed in device memory:
// no host-side gather and no staging copy.
//
// Bound: bytes.  Each row is read once from the tier and written once to
// device memory; no arithmetic.  Over PCIe the host link, not HBM, is the
// limit, so the design keeps as many independent 16-byte reads in flight
// as it can: one warp per row, each lane issues up to four loads before
// its first store, and a 256-thread block serves 8 rows.
//
// scatter_rows is the device-side write of new latent rows into the tier
// through the same mapping (it replaces the XLA host-compute scatter of
// offload.host_scatter_rows, not a Pallas kernel).  It runs on the
// caller's stream, so a later gather on that stream sees the rows.
//
// Index semantics follow the reference: gather ids below 0 give zero rows,
// ids past the end read the last row (jnp.clip); scatter targets outside
// [0, n) are dropped (mode="drop").

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kUnroll = 4;

__global__ void gather_rows_kernel(const uint4* __restrict__ src,
                                   const int64_t* __restrict__ ids,
                                   uint4* __restrict__ out, int64_t m,
                                   int64_t s, int vecs_per_row) {
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= m) return;
  const int lane = threadIdx.x & 31;
  int64_t id = ids[row];
  uint4* dst = out + row * vecs_per_row;
  if (id < 0) {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int j = lane; j < vecs_per_row; j += 32) dst[j] = z;
    return;
  }
  if (id >= s) id = s - 1;
  const uint4* srow = src + id * vecs_per_row;
  for (int base = 0; base < vecs_per_row; base += 32 * kUnroll) {
    uint4 buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * 32 + lane;
      if (j < vecs_per_row) buf[u] = srow[j];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * 32 + lane;
      if (j < vecs_per_row) dst[j] = buf[u];
    }
  }
}

__global__ void scatter_rows_kernel(uint4* __restrict__ dst,
                                    const int64_t* __restrict__ tgt,
                                    const uint4* __restrict__ rows,
                                    int64_t m, int64_t n, int vecs_per_row) {
  const int64_t row = (int64_t)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= m) return;
  const int64_t t = tgt[row];
  if (t < 0 || t >= n) return;
  const int lane = threadIdx.x & 31;
  const uint4* srow = rows + row * vecs_per_row;
  uint4* drow = dst + t * vecs_per_row;
  for (int base = 0; base < vecs_per_row; base += 32 * kUnroll) {
    uint4 buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * 32 + lane;
      if (j < vecs_per_row) buf[u] = srow[j];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * 32 + lane;
      if (j < vecs_per_row) drow[j] = buf[u];
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

// out[i] = src[clip(ids[i], 0, s-1)], zero rows where ids[i] < 0.
// src: device or UVA pointer to s rows of row_bytes (a multiple of 16).
int ess_gather_rows(const void* src, const int64_t* ids, void* out,
                    int64_t m, int64_t s, int64_t row_bytes, void* stream) {
  if (m == 0) return 0;
  const int vpr = (int)(row_bytes / 16);
  const dim3 grid((unsigned)((m + kRowsPerBlock - 1) / kRowsPerBlock));
  gather_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)src, ids, (uint4*)out, m, s, vpr);
  return (int)cudaGetLastError();
}

// dst[tgt[i]] = rows[i] where 0 <= tgt[i] < n; other rows are dropped.
int ess_scatter_rows(void* dst, const int64_t* tgt, const void* rows,
                     int64_t m, int64_t n, int64_t row_bytes, void* stream) {
  if (m == 0) return 0;
  const int vpr = (int)(row_bytes / 16);
  const dim3 grid((unsigned)((m + kRowsPerBlock - 1) / kRowsPerBlock));
  scatter_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (uint4*)dst, tgt, (const uint4*)rows, m, n, vpr);
  return (int)cudaGetLastError();
}

}  // extern "C"
