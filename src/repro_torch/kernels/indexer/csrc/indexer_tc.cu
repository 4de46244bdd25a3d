// Lightning-indexer scores on Hopper's tensor cores (bf16, Di = 128).
//
// Replaces: src/repro/kernels/indexer/indexer.py:41 indexer_scores_kernel
// (Pallas, pallas_call at :59; two MXU matmuls per 256-key block).  Same
// function as the general kernel in indexer.cu and as
// ref.indexer_scores_ref:
//   score[b,q,s] = sum_h w[b,q,h] * ReLU(q[b,q,h,:] . keys[b,s,:])  in fp32,
//   exactly -2e38 where valid[b,q,s] is false, every entry of [B,Q,S]
//   written (the top-k sorts all of it),
// for bf16 q, w and keys at Di = 128 and Hi a multiple of 64 up to 256.
//
// Bound.  The keys are read once (256 bytes a key) and each valid (q, s)
// pair costs Hi * (2 Di + 2) operations.  At decode (Q = 1) that is 64
// operations per key byte, under the bf16 ridge (~295): bytes bound it
// (8.4 MB of keys at B = 4, S = 8224).  A prefill chunk (Q = 256 per slot)
// reuses every key 256 times: operations bound it (137 G, 0.14 ms at the
// bf16 peak).  The general kernel runs on fp32 CUDA cores, whose ridge is
// ~20 operations per byte, so it is bound by operations at every shape.
//
// Design (one CTA = NQ queries of one b and one span of 64-key tiles; 256
// threads, two warpgroups):
// * wgmma with the keys on M: A is a 64-key tile [64, 128], B the NQ
//   queries' heads [N = NQ * Hi <= 256, 128], both K-major with the
//   128-byte swizzle; 8 k-steps of m64nNk16.  The accumulator holds every
//   (key, query head) dot in fp32.  bf16 x bf16 products are exact in
//   fp32, so the result differs from the fp32 plain version only in the
//   order of the sums.  No TF32, and ReLU(dots) is never rounded to bf16
//   for a second product: the epilogue weights it in fp32.
// * TMA loads B once (2 boxes of 64 columns x N rows) and the live key
//   tiles into a 4-stage ring (2 boxes of 64 columns, 16 KB a stage); a
//   full mbarrier per stage reports each load.  The keys are a 3-D tensor
//   map [B, S, 128], so TMA zero-fills the tail past S.
// * The two warpgroups take the live tiles in turn (tile i uses stage
//   i % 4), so one's epilogue overlaps the other's products.  Tiles i and
//   i + 4 belong to the same warpgroup: once its products on tile i are
//   done (wgmma wait, then a named barrier over its 4 warps), its first
//   thread loads tile i + 4 into the same stage.  No producer warp: at 9
//   warps or more the compiler's cap is 168 registers a thread (3 warps
//   share an SM sub-partition's 16 K registers), and the N = 256 variants
//   spilled, with a producer warpgroup and setmaxnreg 24 / 240 as with
//   one producer warp.  At 8 warps the cap is 255, which holds acc (128)
//   and w (64) at N = 256.
// * Each thread owns keys r0 and r0 + 8 of the tile and 2 of every 8
//   columns; it sums w * ReLU(dot) over its columns of each query, w held
//   in registers as fp32, and a reduce-scatter over the quad (3-6
//   shuffles) leaves each lane whole scores.  Its valid flags are read
//   while the tile lands.  Each store instruction writes whole 32-byte
//   sectors along the keys.
// * Tile skip: before the loop all 256 threads read the CTA's valid flags
//   (16 bytes a load) and mark the tiles where one of its queries has a
//   valid key.  Only those are loaded and multiplied; the warpgroups
//   write -2e38 over the others.  A causal prefill chunk thus stops at its
//   group's last position.
// * Grid (query group, key span, b).  The wrapper (ops.tc_plan) groups 4
//   queries at Hi = 64 (N = 256) and cuts S into spans of whole tiles when
//   the groups alone cannot fill the card (decode, B = 4, S = 8224: 33
//   spans of 4 tiles).
// * TMA tensor maps are encoded on the host per call by libcuda's
//   cuTensorMapEncodeTiled, looked up at run time (no link against it).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDi = 128;                     // index dim (wgmma K)
constexpr int kBK = 64;                      // keys per tile (wgmma M)
constexpr int kBoxCols = 64;                 // 128 bytes of bf16
constexpr int kStages = 4;
constexpr int kWGs = 2;
constexpr int kThreads = kWGs * 128;
constexpr int kKBoxBytes = kBK * 128;        // 8 KB
constexpr int kTileBytes = 2 * kKBoxBytes;   // 16 KB
constexpr int kMaxSpanTiles = 1024;          // tiles one CTA walks
constexpr float kNegInf = -2.0e38f;
constexpr long long kWaitCycles = 20000000000LL;   // ~10 s at 2 GHz
constexpr int kErrNoEncode = 10001;          // cuTensorMapEncodeTiled missing
constexpr int kErrEncode = 10002;            // tensor map refused

static_assert(kDi == 2 * kBoxCols, "a key row is two 128-byte boxes");

// B (2 boxes of N rows), the ring, 1 + kStages barriers, the live count
// and list, one flag per tile; 1024 bytes of slack to align the tiles.
constexpr int smem_bytes(int n) {
  return 1024 + 2 * n * 128 + kStages * kTileBytes + 8 * (1 + kStages) +
         16 + 4 * kMaxSpanTiles + kMaxSpanTiles;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` has completed.  A phase that
// never completes (a fault in the hand-over) traps after about 10 s of
// clock, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  const long long start = clock64();
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - start > kWaitCycles) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle, K-major operand:
// sbo = 1024 (8 rows of 128 bytes), lbo unused (16).  Offsets in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

// d[64 x N] (+)= A[64 x 16] . B[N x 16]^T, both K-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<192>(float (&d)[96], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<256>(float (&d)[128], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

struct Params {
  const __nv_bfloat16* w;  // [B, Q, Hi]
  const uint8_t* valid;    // flag of (b, q, s) at b*vb + q*vq + s, or null
  float* out;              // [B, Q, S]
  int Q, S, tiles_per_span;
  int64_t vb, vq;
};

// Load live tile i (absolute tile live[i]) into its stage.
__device__ __forceinline__ void load_tile(const CUtensorMap* kmap,
                                          uint8_t* k_s, uint64_t* full,
                                          const int* live, int i, int b) {
  const int s = i % kStages;
  uint8_t* dst = k_s + s * kTileBytes;
  const int kt = live[i] * kBK;
  mbar_expect_tx(&full[s], kTileBytes);
  tma_load_3d(dst, kmap, &full[s], 0, kt, b);
  tma_load_3d(dst + kKBoxBytes, kmap, &full[s], kBoxCols, kt, b);
}

// ---- warpgroup wg takes live tiles wg, wg + 2, ... ---------------------
template <int HI, int NQ>
__device__ __forceinline__ void consume(const Params& p, const CUtensorMap* kmap,
                                        const uint8_t* q_s, uint8_t* k_s,
                                        uint64_t* q_full, uint64_t* full,
                                        const uint8_t* flag, const int* live,
                                        int nlive, int b, int q0, int nq,
                                        int t0, int nt) {
  constexpr int N = HI * NQ;
  constexpr int NV = 2 * NQ;                // (row half, query) sums
  constexpr int NOWN = NV >= 4 ? NV / 4 : 1;  // of them stored by a lane
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2);   // this thread's keys: r0, r0+8
  const int c2 = 2 * (lane & 3);            // and columns c2, c2+1 of each 8
  const int64_t S = p.S;
  float* obase = p.out + (static_cast<int64_t>(b) * p.Q + q0) * S;
  const uint8_t* vbase =
      p.valid == nullptr ? nullptr
                         : p.valid + b * p.vb + static_cast<int64_t>(q0) * p.vq;

  // -2e38 over the tiles where none of the group's keys is valid
  for (int it = threadIdx.x; it < nt * nq * kBK; it += kThreads) {
    const int t = it / (nq * kBK);
    if (flag[t]) continue;
    const int r = it - t * nq * kBK;
    const int k = (t0 + t) * kBK + (r % kBK);
    if (k < p.S) obase[(r / kBK) * S + k] = kNegInf;
  }

  // w of this thread's columns: column 8j + c2 + e is head (8j) % HI + c2
  // + e of query (8j) / HI
  float wr[N / 4];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int qi = (8 * j) / HI;
    float2 f = make_float2(0.f, 0.f);
    if (qi < nq)
      f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          p.w + (static_cast<int64_t>(b) * p.Q + q0 + qi) * HI +
          (8 * j) % HI + c2));
    wr[2 * j] = f.x;
    wr[2 * j + 1] = f.y;
  }
  // the (row half, query) pairs this lane stores: after the reduce-scatter
  // below, lane l holds pair 4o + (l & 3) (NV >= 4) or l & 1 (NV == 2)
  int pr[NOWN];
  bool own[NOWN];
#pragma unroll
  for (int o = 0; o < NOWN; ++o) {
    pr[o] = NV >= 4 ? 4 * o + (lane & 3) : (lane & 1);
    own[o] = (NV >= 4 || (lane & 2) == 0) && pr[o] % NQ < nq;
  }

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const uint32_t q_addr = smem_u32(q_s);
  mbar_wait(q_full, 0);

  for (int i = wg; i < nlive; i += kWGs) {
    const int s = i % kStages;
    const int kt = live[i] * kBK;
    // this lane's flags, read while the tile lands
    bool st[NOWN], ok[NOWN];
#pragma unroll
    for (int o = 0; o < NOWN; ++o) {
      const int k = kt + r0 + 8 * (pr[o] / NQ);
      st[o] = own[o] && k < p.S;
      ok[o] = st[o] && (vbase == nullptr ||
                        vbase[(pr[o] % NQ) * p.vq + k] != 0);
    }
    mbar_wait(&full[s], (i / kStages) & 1);
    const uint32_t k_addr = smem_u32(k_s + s * kTileBytes);

    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kDi / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      wgmma_ss<N>(acc,
                  sw128_desc(k_addr + (kk >> 2) * kKBoxBytes + off, 16, 1024),
                  sw128_desc(q_addr + (kk >> 2) * (N * 128) + off, 16, 1024),
                  kk > 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    // every warp of the group is done with the stage: refill it with this
    // group's tile after next
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (tid == 0 && i + kStages < nlive)
      load_tile(kmap, k_s, full, live, i + kStages, b);

    // acc[4j + 2h + e] is key r0 + 8h, column 8j + c2 + e
    float v[NV];
#pragma unroll
    for (int x = 0; x < NV; ++x) v[x] = 0.f;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[h * NQ + (8 * j) / HI] +=
              wr[2 * j + e] * fmaxf(acc[4 * j + 2 * h + e], 0.f);
    // reduce-scatter over the quad: first keep the pairs of this lane's
    // parity (u[k] is pair 2k + (lane & 1)), then of its bit 1
    const bool odd = lane & 1;
    float u[NV / 2];
#pragma unroll
    for (int k = 0; k < NV / 2; ++k) {
      const float send = odd ? v[2 * k] : v[2 * k + 1];
      const float keep = odd ? v[2 * k + 1] : v[2 * k];
      u[k] = keep + __shfl_xor_sync(~0u, send, 1);
    }
    float r[NOWN];
    if constexpr (NV >= 4) {
      const bool hi = lane & 2;
#pragma unroll
      for (int k = 0; k < NV / 4; ++k) {
        const float send = hi ? u[2 * k] : u[2 * k + 1];
        const float keep = hi ? u[2 * k + 1] : u[2 * k];
        r[k] = keep + __shfl_xor_sync(~0u, send, 2);
      }
    } else {
      r[0] = u[0] + __shfl_xor_sync(~0u, u[0], 2);
    }
#pragma unroll
    for (int o = 0; o < NOWN; ++o)
      if (st[o])
        obase[(pr[o] % NQ) * S + kt + r0 + 8 * (pr[o] / NQ)] =
            ok[o] ? r[o] : kNegInf;
  }
}

template <int HI, int NQ>
__global__ void __launch_bounds__(kThreads, 1)
indexer_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap, const Params p) {
  constexpr int N = HI * NQ;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = base;                             // [2 boxes][N][64]
  uint8_t* k_s = base + 2 * N * 128;               // [stage][2][64][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(k_s + kStages * kTileBytes);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  int* nlive_s = reinterpret_cast<int*>(bars + 1 + kStages);
  int* live = nlive_s + 4;                         // [kMaxSpanTiles]
  uint8_t* flag = reinterpret_cast<uint8_t*>(live + kMaxSpanTiles);

  const int q0 = blockIdx.x * NQ;
  const int b = blockIdx.z;
  const int nq = min(NQ, p.Q - q0);
  const int t0 = blockIdx.y * p.tiles_per_span;
  const int nt = min(p.tiles_per_span, (p.S + kBK - 1) / kBK - t0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int t = threadIdx.x; t < nt; t += kThreads)
    flag[t] = p.valid == nullptr;
  __syncthreads();
  if (threadIdx.x == 0) {                   // B while the flags are read
    mbar_expect_tx(q_full, 2 * N * 128);
    const int qrow = (b * p.Q + q0) * HI;
    tma_load_2d(q_s, &qmap, q_full, 0, qrow);
    tma_load_2d(q_s + N * 128, &qmap, q_full, kBoxCols, qrow);
  }

  // tile skip: a tile is live when one of the group's keys in it is valid
  if (p.valid != nullptr) {
    const uint8_t* vbase =
        p.valid + b * p.vb + static_cast<int64_t>(q0) * p.vq;
    const bool vec = ((reinterpret_cast<uint64_t>(p.valid) |
                       static_cast<uint64_t>(p.vb) |
                       static_cast<uint64_t>(p.vq)) & 15) == 0;
    for (int it = threadIdx.x; it < nt * nq * 4; it += kThreads) {
      const int t = it / (nq * 4);
      const int r = it - t * nq * 4;
      const int k0 = (t0 + t) * kBK + (r & 3) * 16;
      if (k0 >= p.S) continue;
      const uint8_t* vp = vbase + (r >> 2) * p.vq + k0;
      uint32_t any = 0;
      if (vec && k0 + 16 <= p.S) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(vp));
        any = v.x | v.y | v.z | v.w;
      } else {
        for (int e = 0; e < 16 && k0 + e < p.S; ++e) any |= vp[e];
      }
      if (any) flag[t] = 1;
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {                   // warp 0 lists them in order
    const int lane = threadIdx.x;
    int n = 0;
    for (int c = 0; c < nt; c += 32) {
      const bool on = c + lane < nt && flag[c + lane];
      const uint32_t m = __ballot_sync(~0u, on);
      if (on) live[n + __popc(m & ((1u << lane) - 1))] = t0 + c + lane;
      n += __popc(m);
    }
    __syncwarp();
    if (lane == 0) {
      *nlive_s = n;
      for (int i = 0; i < min(kStages, n); ++i)   // the ring's first fill
        load_tile(&kmap, k_s, full, live, i, b);
    }
  }
  __syncthreads();
  consume<HI, NQ>(p, &kmap, q_s, k_s, q_full, full, flag, live, *nlive_s, b,
                  q0, nq, t0, nt);
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult qres;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &qres);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &qres);
#endif
    if (e == cudaSuccess && qres == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// bf16 tensor map, boxes of `box` elements, 128-byte swizzle, zero fill.
int encode_bf16(CUtensorMap* map, const void* ptr, cuuint32_t rank,
                const cuuint64_t* dims, const cuuint64_t* strides,
                const cuuint32_t* box) {
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return kErrNoEncode;
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                        const_cast<void*>(ptr), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <int HI, int NQ>
int launch(const void* q, const void* keys, const Params& p, int B,
           int nspans, cudaStream_t stream) {
  constexpr int N = HI * NQ;
  static_assert(N % 64 == 0 && N <= 256, "wgmma N is 64..256");
  constexpr int kSmem = smem_bytes(N);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        indexer_tc_kernel<HI, NQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  CUtensorMap qmap, kmap;
  const cuuint64_t qdims[2] = {kDi, static_cast<cuuint64_t>(B) * p.Q * HI};
  const cuuint64_t qstrides[1] = {kDi * 2};
  const cuuint32_t qbox[2] = {kBoxCols, N};
  int rc = encode_bf16(&qmap, q, 2, qdims, qstrides, qbox);
  if (rc) return rc;
  const cuuint64_t kdims[3] = {kDi, static_cast<cuuint64_t>(p.S),
                               static_cast<cuuint64_t>(B)};
  const cuuint64_t kstrides[2] = {kDi * 2,
                                  static_cast<cuuint64_t>(p.S) * kDi * 2};
  const cuuint32_t kbox[3] = {kBoxCols, kBK, 1};
  rc = encode_bf16(&kmap, keys, 3, kdims, kstrides, kbox);
  if (rc) return rc;
  const dim3 grid((unsigned)((p.Q + NQ - 1) / NQ), (unsigned)nspans,
                  (unsigned)B);
  indexer_tc_kernel<HI, NQ><<<grid, kThreads, kSmem, stream>>>(qmap, kmap,
                                                                p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* ess_error_string(int err) {
  if (err == kErrNoEncode)
    return "cuTensorMapEncodeTiled is not available from libcuda";
  if (err == kErrEncode) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString((cudaError_t)err);
}

// q [B,Q,Hi,128], w [B,Q,Hi], keys [B,S,128], all bf16 and contiguous,
// 16-byte aligned; valid uint8 at valid[b*vb + q*vq + s] or null (every
// key valid) -> out [B,Q,S] fp32.  Groups of nq queries (nq * Hi <= 256,
// nq in {1, 2, 4}); key span y covers tiles [y * tiles_per_span,
// min(ceil(S/64), (y+1) * tiles_per_span)), every span non-empty.
int ess_indexer_tc(const void* q, const void* w, const void* keys,
                   const void* valid, void* out, int B, int Q, int S, int Hi,
                   int64_t vb, int64_t vq, int nq, int tiles_per_span,
                   int nspans, void* stream) {
  if (B == 0 || Q == 0 || S == 0) return 0;
  const int ntiles = (S + kBK - 1) / kBK;
  if (B > 65535 || nspans <= 0 || nspans > 65535 || tiles_per_span <= 0 ||
      tiles_per_span > kMaxSpanTiles ||
      static_cast<int64_t>(nspans - 1) * tiles_per_span >= ntiles ||
      static_cast<int64_t>(nspans) * tiles_per_span < ntiles ||
      static_cast<int64_t>(B) * Q * Hi > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.valid = static_cast<const uint8_t*>(valid);
  p.out = static_cast<float*>(out);
  p.Q = Q;
  p.S = S;
  p.tiles_per_span = tiles_per_span;
  p.vb = vb;
  p.vq = vq;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (Hi * 8 + nq) {
    case 64 * 8 + 1: return launch<64, 1>(q, keys, p, B, nspans, st);
    case 64 * 8 + 2: return launch<64, 2>(q, keys, p, B, nspans, st);
    case 64 * 8 + 4: return launch<64, 4>(q, keys, p, B, nspans, st);
    case 128 * 8 + 1: return launch<128, 1>(q, keys, p, B, nspans, st);
    case 128 * 8 + 2: return launch<128, 2>(q, keys, p, B, nspans, st);
    case 192 * 8 + 1: return launch<192, 1>(q, keys, p, B, nspans, st);
    case 256 * 8 + 1: return launch<256, 1>(q, keys, p, B, nspans, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
