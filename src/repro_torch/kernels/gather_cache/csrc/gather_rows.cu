// FlashTrans row and page gathers over UVA (paper section 3.1), their
// fused int8/fp8 dequant variants, and the write-back scatter.
//
// Replaces, in src/repro/kernels/gather_cache/gather_cache.py:
//   gather_rows_kernel               -> gather_rows_kernel (direct route),
//                                       mark/fetch/expand (staged route),
//                                       gather_rows_raw_kernel (the slab)
//   gather_rows_dequant_kernel       -> gather_rows_dequant_kernel (direct),
//                                       mark/fetch_dequant/expand (staged)
//   gather_row_blocks_kernel         -> copy_pages_kernel (the page
//                                       gather; given destination ids,
//                                       also the migration's install)
//   gather_row_blocks_dequant_kernel -> gather_pages_dequant_kernel
// The Pallas kernels move one row (or page) per grid step.  On the H100
// the latent tier lives in pinned host memory; these kernels dereference
// the tier's UVA device pointer directly, so the scattered rows cross PCIe
// as the threads' own 16-byte loads and land packed in device memory: no
// host-side gather and no host staging copy.
//
// Bound: bytes, and the host link (about 55 GB/s) rather than HBM
// (3.35 TB/s) for every byte read from the tier.  Two routes for the row
// gathers, chosen by the wrapper from the shapes and the source's memory
// (ops.staged_route; a device-resident source always reads directly):
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
// * pages: a persistent grid (two CTAs an SM) walks a flat list of
//   (layer, page, chunk) units; one thread per CTA keeps four chunks of
//   up to 24 KB in flight, each brought into shared memory by a 1-D TMA
//   bulk copy (payload and, on a quantized tier, the rows' scales in the
//   same stage) and sent out by a bulk store, or widened by the CTA's
//   threads for the dequant variant: a whole page moves as 2-4 large
//   copies, with one thread per CTA issuing them.
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

// ---- whole pages: a persistent TMA ring ---------------------------------
//
// A unit is one chunk of `rpc` rows of one (layer, page): its payload
// (rpc * row_bytes) and, with a scale plane, its rpc 2-byte scales, both
// contiguous in the source and in the destination.  A persistent grid
// walks the flat list of units, each CTA a contiguous run of it.  One
// thread of each CTA keeps kStages units in flight: each unit arrives by
// 1-D bulk copies (cp.async.bulk, no tensor map: the chunk is contiguous)
// into a shared-memory stage whose mbarrier counts the bytes.  The copy
// leaves each arrived stage by a bulk store (cp.async.bulk.global.shared);
// the stage is refilled once that store has read it.  The dequant variant
// widens each arrived stage with all its threads instead, writing the
// output rows with ordinary 16-byte stores, then refills the stage.
// Source and destination may be device memory or pinned host memory
// through its UVA pointer (the pack writes the packet on the host, the
// install reads it there).

constexpr int kStages = 4;
constexpr int kDequantThreads = 256;
constexpr long long kWaitTimeoutNs = 4000000000LL;   // 4 s: a lost copy

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` has completed; a copy that never
// lands traps (an error the launch reports) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long t0 = 0;
  for (int spin = 0; !done; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && (spin & 1023) == 1023) {
      const long long t = global_ns();
      if (t0 == 0) t0 = t;
      else if (t - t0 > kWaitTimeoutNs) __trap();
    }
  }
}

// global (device or UVA) -> shared, completion counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// every committed store group but the newest N has read its shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

struct PageArgs {
  const uint8_t* src;        // [L, src_pages * r, row_bytes]
  const uint8_t* src_sc;     // [L, src_pages * r] f16 or null
  const int64_t* src_ids;    // [L, nb], clipped; null = page i
  uint8_t* dst;              // [L, dst_pages * r, out_row_bytes]
  uint8_t* dst_sc;           // [L, dst_pages * r] f16 or null (copy only)
  const int64_t* dst_ids;    // [L, nb], out of range dropped; null = i
  int64_t src_pages, dst_pages, nb;
  int r, rpc, nchunk, row_bytes;
  int64_t units;             // L * nb * nchunk
  int stage_bytes;           // payload + scales of one chunk, padded
  bool sc_bulk;              // the scales ride the ring (16-byte aligned)
};

// The unit's source and destination row offsets (rows of the flat planes);
// dst_row < 0 when its destination page is out of range (dropped).
struct Unit {
  int64_t src_row, dst_row;
};

__device__ __forceinline__ Unit unit_rows(const PageArgs& a, int64_t u) {
  const int64_t c = u % a.nchunk;
  const int64_t li = u / a.nchunk;          // l * nb + i
  const int64_t l = li / a.nb;
  int64_t sp = a.src_ids ? a.src_ids[li] : li - l * a.nb;
  sp = sp < 0 ? 0 : (sp >= a.src_pages ? a.src_pages - 1 : sp);
  const int64_t dp = a.dst_ids ? a.dst_ids[li] : li - l * a.nb;
  Unit w;
  w.src_row = (l * a.src_pages + sp) * a.r + c * a.rpc;
  w.dst_row = (dp < 0 || dp >= a.dst_pages)
                  ? -1
                  : (l * a.dst_pages + dp) * a.r + c * a.rpc;
  return w;
}

// The units of this CTA: a contiguous run of the flat list (CTA b takes
// [first, first + n)), so that a CTA's chunks in flight are neighbours in
// the source, as a page's rows are.
struct Share {
  int64_t first, n;
};

__device__ __forceinline__ Share my_share(int64_t units) {
  const int64_t base = units / gridDim.x, rem = units % gridDim.x;
  const int64_t b = blockIdx.x;
  return {b * base + (b < rem ? b : rem), base + (b < rem ? 1 : 0)};
}

template <bool kScales>
__device__ __forceinline__ void load_unit(const PageArgs& a, uint8_t* stage,
                                          uint64_t* bar, const Unit& w) {
  const uint32_t pay = (uint32_t)a.rpc * a.row_bytes;
  const bool sc = kScales && a.sc_bulk;
  const uint32_t scb = sc ? (uint32_t)a.rpc * 2u : 0u;
  mbar_expect_tx(bar, pay + scb);
  bulk_load(stage, a.src + w.src_row * a.row_bytes, pay, bar);
  if (sc) bulk_load(stage + pay, a.src_sc + w.src_row * 2, scb, bar);
}

// The copy: one thread of each CTA (the block is one warp) drives the ring
// over the CTA's share of the units.
template <bool kScales>
__global__ void __launch_bounds__(32) copy_pages_kernel(const PageArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  if (threadIdx.x != 0) return;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * a.stage_bytes);
  const Share sh = my_share(a.units);
  const int64_t n = sh.n;
  if (n <= 0) return;
  for (int s = 0; s < kStages; ++s) mbar_init(&full[s]);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  auto unit = [&](int64_t k) { return unit_rows(a, sh.first + k); };
  for (int64_t k = 0; k < n && k < kStages; ++k)
    load_unit<kScales>(a, smem + k * a.stage_bytes, &full[k], unit(k));
  const uint32_t pay = (uint32_t)a.rpc * a.row_bytes;
  for (int64_t k = 0; k < n; ++k) {
    const int s = (int)(k % kStages);
    uint8_t* stage = smem + s * a.stage_bytes;
    mbar_wait(&full[s], (uint32_t)((k / kStages) & 1));
    const Unit w = unit(k);
    if (w.dst_row >= 0) {
      bulk_store(a.dst + w.dst_row * a.row_bytes, stage, pay);
      if constexpr (kScales)
        bulk_store(a.dst_sc + w.dst_row * 2, stage + pay, (uint32_t)a.rpc * 2u);
    }
    bulk_commit();
    // refill the previous unit's stage once its store has read it, so one
    // store is always draining while the other stages load
    const int64_t nxt = k - 1 + kStages;
    if (k >= 1 && nxt < n) {
      bulk_wait_read<1>();
      const int ps = (int)((k - 1) % kStages);
      load_unit<kScales>(a, smem + ps * a.stage_bytes, &full[ps], unit(nxt));
    }
  }
  bulk_wait_all();
}

// The dequant gather: every thread widens the arrived stage into the
// output rows (out_row_bytes = rpc-row width of the output dtype).
template <typename Q, typename O>
__global__ void __launch_bounds__(kDequantThreads)
    gather_pages_dequant_kernel(const PageArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * a.stage_bytes);
  const Share sh = my_share(a.units);
  const int64_t n = sh.n;
  if (n <= 0) return;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto unit = [&](int64_t k) { return unit_rows(a, sh.first + k); };
  if (threadIdx.x == 0)
    for (int64_t k = 0; k < n && k < kStages; ++k)
      load_unit<true>(a, smem + k * a.stage_bytes, &full[k], unit(k));
  const int vpr = a.row_bytes / 16;           // payload vectors per row
  const int nv = a.rpc * vpr;
  const int d = a.row_bytes;                  // payload bytes = values
  for (int64_t k = 0; k < n; ++k) {
    const int s = (int)(k % kStages);
    const uint8_t* stage = smem + s * a.stage_bytes;
    mbar_wait(&full[s], (uint32_t)((k / kStages) & 1));
    const Unit w = unit(k);
    const uint4* pv = reinterpret_cast<const uint4*>(stage);
    const __half* ps = reinterpret_cast<const __half*>(stage + a.rpc * a.row_bytes);
    if (!a.sc_bulk) {
      // rows of a page not a multiple of 8: the scales are not 16-byte
      // aligned for a bulk copy, so the threads read them into the stage
      __half* sp = const_cast<__half*>(ps);
      const __half* src_sc = reinterpret_cast<const __half*>(a.src_sc);
      for (int t = threadIdx.x; t < a.rpc; t += kDequantThreads)
        sp[t] = src_sc[w.src_row + t];
      __syncthreads();
    }
    O* out = reinterpret_cast<O*>(a.dst) + w.dst_row * d;
    for (int j = threadIdx.x; w.dst_row >= 0 && j < nv;
         j += kDequantThreads) {
      const int row = j / vpr;
      dequant16<Q, O>(pv[j], __half2float(ps[row]),
                      out + (int64_t)row * d + (j - row * vpr) * 16);
    }
    __syncthreads();                 // every thread is done with the stage
    const int64_t nxt = k + kStages;
    if (threadIdx.x == 0 && nxt < n)
      load_unit<true>(a, smem + s * a.stage_bytes, &full[s], unit(nxt));
  }
}

int g_num_sms = 0;

int num_sms() {
  if (g_num_sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&g_num_sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return g_num_sms;
}

// Rows per unit: the page's rows halved while the chunk's payload exceeds
// kMaxChunk (a 64-row bf16 page of 576 -> 16 rows, 18 KB); with a scale
// plane the chunk keeps a multiple of 8 rows (16 scale bytes).
constexpr int kMaxChunk = 24 * 1024;

int chunk_rows(int r, int row_bytes, bool sc_bulk) {
  int rpc = r;
  while ((int64_t)rpc * row_bytes > kMaxChunk && rpc % 2 == 0 &&
         (!sc_bulk || (rpc / 2) % 8 == 0))
    rpc /= 2;
  return rpc;
}

// scales: a scale plane rides along (copy) or is read (dequant); it rides
// the ring when a page's rows are a multiple of 8, else (dequant only) the
// threads read it.
int page_args(PageArgs& a, int64_t layers, int r, bool scales) {
  a.r = r;
  a.sc_bulk = scales && r % 8 == 0;
  a.rpc = chunk_rows(r, a.row_bytes, a.sc_bulk);
  a.nchunk = r / a.rpc;
  a.units = layers * a.nb * a.nchunk;
  const int pay = a.rpc * a.row_bytes;
  a.stage_bytes = ((pay + (scales ? a.rpc * 2 : 0)) + 127) / 128 * 128;
  const int smem = kStages * a.stage_bytes + kStages * 8;
  if (a.row_bytes % 16 || smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename K>
int launch_pages(K kernel, const PageArgs& a, int threads, int ctas_per_sm,
                 cudaStream_t st) {
  const int smem = kStages * a.stage_bytes + kStages * 8;
  int rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc) return rc;
  int64_t grid = (int64_t)ctas_per_sm * num_sms();
  if (grid > a.units) grid = a.units;
  kernel<<<(unsigned)grid, threads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// ---- the link probe (measurement only; tests/test_torch_cuda.py) --------
//
// How fast can the SMs read pinned host memory over the link, by TMA bulk
// copies and by their own 16-byte loads?  Both kernels read nbytes of src
// once and fold one word of every 16-byte vector (bulk: of every chunk)
// into a per-CTA sink, so the reads cannot be dropped.

__global__ void __launch_bounds__(32)
    probe_bulk_read_kernel(const uint8_t* src, int64_t units, int chunk,
                           int64_t* sink) {
  extern __shared__ __align__(128) uint8_t smem[];
  if (threadIdx.x != 0) return;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * chunk);
  const int64_t n = (units - blockIdx.x + gridDim.x - 1) / gridDim.x;
  for (int s = 0; s < kStages; ++s) mbar_init(&full[s]);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  auto load = [&](int64_t k) {
    const int s = (int)(k % kStages);
    mbar_expect_tx(&full[s], (uint32_t)chunk);
    bulk_load(smem + s * chunk, src + (blockIdx.x + k * gridDim.x) * chunk,
              (uint32_t)chunk, &full[s]);
  };
  for (int64_t k = 0; k < n && k < kStages; ++k) load(k);
  int64_t acc = 0;
  for (int64_t k = 0; k < n; ++k) {
    const int s = (int)(k % kStages);
    mbar_wait(&full[s], (uint32_t)((k / kStages) & 1));
    acc ^= *reinterpret_cast<const int64_t*>(smem + s * chunk);
    if (k + kStages < n) load(k + kStages);
  }
  sink[blockIdx.x] = acc;
}

template <int kU>
__global__ void __launch_bounds__(256)
    probe_lsu_read_kernel(const uint4* __restrict__ src, int64_t nvec,
                          int64_t* sink) {
  const int64_t stride = (int64_t)gridDim.x * 256 * kU;
  uint32_t acc = 0;
  for (int64_t base = (int64_t)blockIdx.x * 256 * kU + threadIdx.x;
       base < nvec; base += stride) {
    uint4 buf[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int64_t j = base + u * 256;
      if (j < nvec) buf[u] = src[j];
      else buf[u] = make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) acc ^= buf[u].x;
  }
  if (acc == 0x9e3779b9u) sink[blockIdx.x] = acc;   // almost never taken
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

// Whole pages, all layers in one launch: for each layer l and i < nb, page
// clip(src_ids[l, i]) of src (src_pages pages of r rows of row_bytes) ->
// page dst_ids[l, i] of dst (dst_pages pages; out of range: dropped).
// A null src_ids / dst_ids is page i.  src_sc / dst_sc (both or neither):
// the f16 scale plane beside each row, moved in the same launch.  Any of
// the four planes may be device memory or a UVA pointer to pinned host
// memory.  row_bytes is a multiple of 16; with scales, r a multiple of 8.
int ess_copy_pages(const void* src, const void* src_sc, const int64_t* src_ids,
                   int64_t src_pages, void* dst, void* dst_sc,
                   const int64_t* dst_ids, int64_t dst_pages, int64_t layers,
                   int64_t nb, int64_t r, int64_t row_bytes, void* stream) {
  if (layers == 0 || nb == 0) return 0;
  if ((src_sc == nullptr) != (dst_sc == nullptr))
    return (int)cudaErrorInvalidValue;
  PageArgs a{};
  a.src = (const uint8_t*)src;
  a.src_sc = (const uint8_t*)src_sc;
  a.src_ids = src_ids;
  a.dst = (uint8_t*)dst;
  a.dst_sc = (uint8_t*)dst_sc;
  a.dst_ids = dst_ids;
  a.src_pages = src_pages;
  a.dst_pages = dst_pages;
  a.nb = nb;
  a.row_bytes = (int)row_bytes;
  const bool sc = src_sc != nullptr;
  int rc = page_args(a, layers, (int)r, sc);
  if (rc) return rc;
  if (sc && !a.sc_bulk) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return sc ? launch_pages(copy_pages_kernel<true>, a, 32, 2, st)
            : launch_pages(copy_pages_kernel<false>, a, 32, 2, st);
}

// Whole pages with per-row dequant: src [L, npages*r, d] int8/e4m3 and
// scales [L, npages*r] f16 -> out [L, nb*r, d] f32/bf16, page
// clip(ids[l, i]) -> page i (qkind: 0 int8, 1 e4m3; okind: 0 f32, 1 bf16).
int ess_gather_pages_dequant(const void* src, const void* scales,
                             const int64_t* ids, void* out, int64_t layers,
                             int64_t nb, int64_t npages, int64_t r, int64_t d,
                             int qkind, int okind, void* stream) {
  if (layers == 0 || nb == 0) return 0;
  PageArgs a{};
  a.src = (const uint8_t*)src;
  a.src_sc = (const uint8_t*)scales;
  a.src_ids = ids;
  a.dst = (uint8_t*)out;
  a.src_pages = npages;
  a.dst_pages = nb;
  a.nb = nb;
  a.row_bytes = (int)d;
  int rc = page_args(a, layers, (int)r, true);
  if (rc) return rc;
  cudaStream_t st = (cudaStream_t)stream;
#define ESS_GPD(Q, O)                                                     \
  launch_pages(gather_pages_dequant_kernel<Q, O>, a, kDequantThreads, 2, st)
  if (qkind == 0 && okind == 0) return ESS_GPD(Int8Q, float);
  if (qkind == 0) return ESS_GPD(Int8Q, __nv_bfloat16);
  if (okind == 0) return ESS_GPD(Fp8Q, float);
  return ESS_GPD(Fp8Q, __nv_bfloat16);
#undef ESS_GPD
}

// The link probe: read nbytes of src (device or UVA) in chunk-byte bulk
// copies, ctas_per_sm persistent CTAs an SM with four chunks in flight
// each; sink holds one int64 per CTA.  nbytes is a multiple of chunk.
int ess_probe_bulk_read(const void* src, int64_t nbytes, int chunk,
                        int ctas_per_sm, int64_t* sink, void* stream) {
  const int64_t units = nbytes / chunk;
  int64_t grid = (int64_t)ctas_per_sm * num_sms();
  if (grid > units) grid = units;
  const int smem = kStages * chunk + kStages * 8;
  int rc = (int)cudaFuncSetAttribute(
      probe_bulk_read_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (rc) return rc;
  probe_bulk_read_kernel<<<(unsigned)grid, 32, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)src, units, chunk, sink);
  return (int)cudaGetLastError();
}

// The same by 16-byte loads: one 256-thread CTA an SM, each thread with
// kb_in_flight KB / 4 KB vectors issued before any is used (16, 32 or 64
// KB in flight an SM); sink holds one int64 per CTA.
int ess_probe_lsu_read(const void* src, int64_t nbytes, int kb_in_flight,
                       int64_t* sink, void* stream) {
  const int grid = num_sms();
  cudaStream_t st = (cudaStream_t)stream;
  const uint4* p = (const uint4*)src;
  const int64_t nvec = nbytes / 16;
  switch (kb_in_flight) {
    case 16: probe_lsu_read_kernel<4><<<grid, 256, 0, st>>>(p, nvec, sink); break;
    case 32: probe_lsu_read_kernel<8><<<grid, 256, 0, st>>>(p, nvec, sink); break;
    case 64: probe_lsu_read_kernel<16><<<grid, 256, 0, st>>>(p, nvec, sink); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
