// Sparse-MLA flash partial on Hopper's tensor cores (bf16, MLA widths).
//
// Replaces: src/repro/kernels/sparse_mla/sparse_mla.py:74
// sparse_mla_partial_kernel (Pallas; online softmax over 128-row blocks on
// the MXU).  Same function as the general kernel in sparse_mla.cu and as
// ref.sparse_mla_partial_ref: per (b, q), the UNNORMALIZED fp32 partial
//   s = scale * q[H,576] . rows[K,576]^T, masked by valid[K] (-2e38),
//   m = max_k s,  p = exp(s - m) (0 where invalid),  l = sum_k p,
//   o = p @ rows[:, :512]
// for bf16 q and rows, D = 576, rank = 512, H a multiple of 64.  An
// all-invalid partial is m = -2e38, l = 0, o = 0.
//
// Bound.  Per (b, q) the function reads K x 576 bf16 rows once (2*K*D
// bytes), shared by all H heads, and does 2*H*K_valid*(D + rank)
// operations: at H = 128 about 240 per byte, under the H100's ~295 bf16
// ridge, so bytes bound it when the products run on the tensor cores at
// full rate.  The design keeps the function near that: every row tile is
// read from HBM once per (b, q), for both head halves (the grid puts the
// two halves side by side, so the second read is an L2 hit), and both
// products run on wgmma.  Its own extra work, not counted in the bound:
// each of the two consumer warpgroups computes the tile's scores for all
// 64 heads (so P never leaves registers), and P.V runs twice (hi and lo
// halves of P), so the tensor cores do about 2x the function's operations.
//
// Design (one CTA = 64 heads of one (b, q) and one K split; 384 threads):
// * Warpgroup 2 is the producer (setmaxnreg down to 24 registers, so the
//   consumers can hold 240: with 168 a thread, the compiler's share of a
//   3-warpgroup CTA, the accumulators spill and ptxas serializes the
//   wgmmas).  One lane issues TMA loads: the 64 x 576 Q tile once (9
//   boxes of 64 columns, 72 KB) and then 64-row x 576 tiles of rows into
//   a 2-stage ring (72 KB a stage), each as 9 boxes of 64 columns: a
//   TMA box is at most 256 elements wide and the 128-byte swizzle wants a
//   128-byte inner box.  Full / empty mbarriers hand the stages over.
//   Rows are a 3-D tensor map [Z, K, 576] (Z = b for rows shared over q,
//   b*Q + q for per-query rows), so TMA zero-fills the ragged tail of
//   each (b, q)'s K; those rows and valid == 0 rows are masked to -2e38
//   before the max.  Q + ring = 216 KB of shared memory.
// * Warpgroups 0 and 1 are consumers.  Each computes S = Q.K^T for all 64
//   heads x 64 rows (36 wgmma m64n64k16, both operands K-major with the
//   128-byte swizzle), the online softmax in registers (each thread owns
//   2 heads x 16 rows), then O[:, 256w:256w+256] += P.V with P as the A
//   operand from registers and V = the tile's first 512 columns read as a
//   transposed (N-major) B operand: 4 k-steps of m64n256k16 per half.
//   Each thread keeps 128 fp32 accumulators.
// * Precision: Q.K^T multiplies bf16 by bf16, exact in fp32, and sums in
//   fp32.  P is split into P_hi = bf16(P) and P_lo = bf16(P - P_hi); both
//   go through the same accumulators, so P keeps about 16 bits (rounding
//   P to bf16 alone costs about 1e-3 relative).
// * Split-K: at decode B*Q*H/64 is 8 CTAs for 132 SMs, so the wrapper
//   (ops.plan_splits) cuts K into splits of whole tiles; each writes an
//   (o, m, l) partial to fp32 scratch and ess_sparse_mla_merge combines
//   them (m = max m_i, l = sum l_i e^(m_i - m), o = sum o_i e^(m_i - m);
//   an all-invalid split has m_i = -2e38, l_i = 0 and adds nothing).
//   Prefill has B*Q = 1024 queries and runs one split, with no merge.
// * The mask: one row of valid flags per row set (Z), or, beside rows
//   shared over q, one per (b, q) (valid_per_query: the causal mask of a
//   prefill chunk over a whole prompt's latent rows, DeepSeek-V3's dense
//   MLA prefill).  Before the ring starts, the CTA's threads find the
//   last valid row of its split in that mask row, and tiles past it are
//   neither loaded nor multiplied: an all-invalid tile after the last
//   valid one leaves m, l and o exactly as they are (its exp terms are 0
//   and its correction exp(0) = 1), so a causal query reads only the rows
//   up to its own position, about half the prompt on average.
// * TMA tensor maps are encoded on the host per call by libcuda's
//   cuTensorMapEncodeTiled, looked up at run time (no link against it).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 576;                      // latent row width
constexpr int kRank = 512;                   // value width (rows[:, :512])
constexpr int kHB = 64;                      // heads per CTA (wgmma M)
constexpr int kBN = 64;                      // rows per tile
constexpr int kBoxCols = 64;                 // 128 bytes of bf16
constexpr int kBoxes = kD / kBoxCols;        // 9
constexpr int kStages = 2;
constexpr int kConsumerWGs = 2;              // each owns 256 output columns
constexpr int kThreads = (kConsumerWGs + 1) * 128;   // + producer WG
constexpr int kProducerRegs = 24;            // setmaxnreg: 24 + 2 x 240 per
constexpr int kConsumerRegs = 240;           // SM sub-partition fits 512
constexpr int kQBoxBytes = kHB * 128;        // 8 KB
constexpr int kKBoxBytes = kBN * 128;        // 8 KB
constexpr int kQBytes = kBoxes * kQBoxBytes;     // 72 KB
constexpr int kTileBytes = kBoxes * kKBoxBytes;  // 72 KB
constexpr int kSmemBytes =
    1024 + kQBytes + kStages * kTileBytes + 8 * (1 + 2 * kStages);
constexpr float kNegInf = -2.0e38f;
constexpr int kErrNoEncode = 10001;          // cuTensorMapEncodeTiled missing
constexpr int kErrEncode = 10002;            // tensor map refused

static_assert(kD % kBoxCols == 0, "row width must be whole boxes");
static_assert(kRank == kConsumerWGs * 256, "two n256 halves of the value");

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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
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

// Shared-memory matrix descriptor, 128-byte swizzle.  Offsets in bytes.
// K-major operand: sbo = 1024 (8 rows of 128 bytes), lbo unused (16).
// N-major operand: lbo = stride between 64-column chunks, sbo = 1024
// (8 rows of the reduction dimension).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
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

// d[64 x 256] += A[64 x 16] (registers, bf16 pairs) . B[16 x 256], B
// N-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_n256_tb(float (&d)[128],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
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
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

struct Params {
  const uint8_t* valid;  // [Z, K] flags, Z as the rows' leading dimension,
                         // or [B*Q, K] when valid_per_query
  float* o;              // [nsplit][B*Q][H][kRank]
  float* m;              // [nsplit][B*Q][H]
  float* l;              // [nsplit][B*Q][H]
  int nq, H, K, rows_per_split, shared_rows, valid_per_query;
  float scale;
  int64_t split_rows;    // B*Q*H: stride of one split's (m, l) partials
};

// ---- consumers: warpgroup wg owns output columns [256 wg, 256 wg + 256)
__device__ __forceinline__ void consume(const Params& p, uint8_t* q_s,
                                        uint8_t* k_s, uint64_t* q_full,
                                        uint64_t* full, uint64_t* empty,
                                        int wg, int bq, int hb, int split,
                                        int vz, int k0, int k1, int ntiles) {
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = warp * 16 + (lane >> 2);   // this thread's heads: r0, r0+8
  const int c2 = 2 * (lane & 3);            // and columns c2, c2+1 of each 8
  const uint8_t* vrow = p.valid + static_cast<int64_t>(vz) * p.K;

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};   // per-thread partial sums, reduced at the end
  const uint32_t q_addr = smem_u32(q_s);
  mbar_wait(q_full, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % kStages;
    const int kt = k0 + t * kBN;
    // this thread's 16 flags (rows 8j + c2 + e), read while the tile lands
    uint32_t ok = 0;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = kt + 8 * j + c2 + e;
        if (k < k1 && vrow[k]) ok |= 1u << (2 * j + e);
      }
    mbar_wait(&full[s], (t / kStages) & 1);
    const uint32_t k_addr = smem_u32(k_s + s * kTileBytes);

    // S = Q . K^T over 36 k-steps of 16 (4 per 64-column box)
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kQBoxBytes + (kk & 3) * 32;
      wgmma_ss_n64(sc, sw128_desc(q_addr + off, 16, 1024),
                   sw128_desc(k_addr + off, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(sc);

    // online softmax; sc[4j + 2h + e] is head r0 + 8h, row 8j + c2 + e
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * h + e];
          x = ((ok >> (2 * j + e)) & 1u) ? x * p.scale : kNegInf;
          mx[h] = fmaxf(mx[h], x);
        }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(~0u, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(~0u, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      corr[h] = expf(m_run[h] - m_new);
      m_run[h] = m_new;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * h + e];
          x = ((ok >> (2 * j + e)) & 1u) ? expf(x - m_run[h]) : 0.f;
          ls[h] += x;
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * corr[h] + ls[h];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc[4 * i] *= corr[0];
      acc[4 * i + 1] *= corr[0];
      acc[4 * i + 2] *= corr[1];
      acc[4 * i + 3] *= corr[1];
    }

    // P as wgmma A fragments: k-step kk covers rows 16kk..16kk+15, and its
    // register i is the pair sc[8kk + 2i], sc[8kk + 2i + 1]; hi and lo
    uint32_t ph[kBN / 16][4], pl[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x0 = sc[8 * kk + 2 * i];
        const float x1 = sc[8 * kk + 2 * i + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(hi);
        ph[kk][i] = bf16x2_bits(hi);
        pl[kk][i] = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
      }

    // O[:, 256 wg : 256 wg + 256] += P . V, V = boxes 4wg..4wg+3 of the tile
    const uint32_t v_addr = k_addr + wg * 4 * kKBoxBytes;
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t dv = sw128_desc(v_addr + kk * 16 * 128, kKBoxBytes, 1024);
      wgmma_rs_n256_tb(acc, ph[kk], dv);
      wgmma_rs_n256_tb(acc, pl[kk], dv);
    }
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(~0u, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(~0u, l_run[h], 2);
  }
  const int64_t row0 = static_cast<int64_t>(split) * p.split_rows +
                       static_cast<int64_t>(bq) * p.H + hb * kHB;
  float* ob = p.o + row0 * kRank + wg * 256 + c2;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    *reinterpret_cast<float2*>(ob + static_cast<int64_t>(r0) * kRank + 8 * i) =
        make_float2(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<float2*>(ob + static_cast<int64_t>(r0 + 8) * kRank +
                               8 * i) = make_float2(acc[4 * i + 2],
                                                    acc[4 * i + 3]);
  }
  if (wg == 0 && (lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      p.m[row0 + r0 + 8 * h] = m_run[h];
      p.l[row0 + r0 + 8 * h] = l_run[h];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
sparse_mla_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap rmap,
                     const Params p) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = base;                             // [9 boxes][64][64]
  uint8_t* k_s = base + kQBytes;                   // [stage][9][64][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(k_s + kStages * kTileBytes);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;
  __shared__ int last_valid;

  const int hb = blockIdx.x;       // head block: the two halves run together
  const int split = blockIdx.y;
  const int bq = blockIdx.z;
  const int z = p.shared_rows ? bq / p.nq : bq;
  const int vz = p.valid_per_query ? bq : z;
  const int k0 = split * p.rows_per_split;
  int k1 = min(p.K, k0 + p.rows_per_split);

  if (threadIdx.x == 0) {
    last_valid = k0 - 1;
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWGs * 4);   // lane 0 of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  {  // the split's last valid row: each thread's highest of its stride
    const uint8_t* vrow = p.valid + static_cast<int64_t>(vz) * p.K;
    for (int k = k1 - 1 - static_cast<int>(threadIdx.x); k >= k0;
         k -= kThreads)
      if (vrow[k]) {
        atomicMax(&last_valid, k);
        break;
      }
  }
  __syncthreads();
  k1 = last_valid + 1;
  const int ntiles = k1 > k0 ? (k1 - k0 + kBN - 1) / kBN : 0;

  const int wg = threadIdx.x >> 7;
  if (wg == kConsumerWGs) {
    // ---- producer: one lane keeps the ring full ----------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumerWGs * 128) {
      mbar_expect_tx(q_full, kQBytes);
      const int qrow = bq * p.H + hb * kHB;
#pragma unroll
      for (int j = 0; j < kBoxes; ++j)
        tma_load_2d(q_s + j * kQBoxBytes, &qmap, q_full, j * kBoxCols, qrow);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
        uint8_t* dst = k_s + s * kTileBytes;
        mbar_expect_tx(&full[s], kTileBytes);
#pragma unroll
        for (int j = 0; j < kBoxes; ++j)
          tma_load_3d(dst + j * kKBoxBytes, &rmap, &full[s], j * kBoxCols,
                      k0 + t * kBN, z);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    consume(p, q_s, k_s, q_full, full, empty, wg, bq, hb, split, vz, k0, k1,
            ntiles);
  }
}

// Combine nsplit partials of `rows` (b, q, h) rows: one CTA per row.
__global__ void sparse_mla_merge_kernel(const float* __restrict__ op,
                                        const float* __restrict__ mp,
                                        const float* __restrict__ lp,
                                        float* __restrict__ o,
                                        float* __restrict__ m,
                                        float* __restrict__ l, int nsplit,
                                        int64_t rows, int rank) {
  const int64_t row = blockIdx.x;
  float mx = kNegInf;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, mp[s * rows + row]);
  for (int c = 4 * threadIdx.x; c < rank; c += 4 * blockDim.x) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < nsplit; ++s) {
      const float w = expf(mp[s * rows + row] - mx);
      const float4 v =
          *reinterpret_cast<const float4*>(op + (s * rows + row) * rank + c);
      a.x += w * v.x;
      a.y += w * v.y;
      a.z += w * v.z;
      a.w += w * v.w;
    }
    *reinterpret_cast<float4*>(o + row * rank + c) = a;
  }
  if (threadIdx.x == 0) {
    float ls = 0.f;
    for (int s = 0; s < nsplit; ++s)
      ls += expf(mp[s * rows + row] - mx) * lp[s * rows + row];
    m[row] = mx;
    l[row] = ls;
  }
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

}  // namespace

extern "C" {

const char* ess_error_string(int err) {
  if (err == kErrNoEncode)
    return "cuTensorMapEncodeTiled is not available from libcuda";
  if (err == kErrEncode) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString((cudaError_t)err);
}

// q [B,nq,H,576] bf16; rows [Z,K,576] bf16 with Z = B (shared_rows: one
// row set per b, shared over q) or B*nq (per query); valid uint8 [Z,K], or
// [B*nq,K] with valid_per_query (shared rows, a mask per query).
// K split s covers rows [s*rows_per_split, min(K, (s+1)*rows_per_split)).
// Writes fp32 o at ((s*B*nq + bq)*H + h)*512 and m, l at (s*B*nq + bq)*H
// + h.  Requires H % 64 == 0, K >= 1, rows_per_split % 64 == 0, every
// split non-empty, 16-byte aligned q and rows.
int ess_sparse_mla_tc(const void* q, const void* rows, const void* valid,
                      void* o, void* m, void* l, int B, int nq, int H, int K,
                      int shared_rows, int valid_per_query, int nsplit,
                      int rows_per_split, float scale, void* stream) {
  if (B * nq == 0 || H == 0) return 0;
  const int bq = B * nq;
  if (H % kHB || K <= 0 || nsplit <= 0 || nsplit > 65535 || bq > 65535 ||
      rows_per_split <= 0 || rows_per_split % kBN ||
      static_cast<int64_t>(nsplit - 1) * rows_per_split >= K ||
      static_cast<int64_t>(nsplit) * rows_per_split < K)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        sparse_mla_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  CUtensorMap qmap, rmap;
  const cuuint64_t qdims[2] = {kD, static_cast<cuuint64_t>(bq) * H};
  const cuuint64_t qstrides[1] = {kD * 2};
  const cuuint32_t qbox[2] = {kBoxCols, kHB};
  int rc = encode_bf16(&qmap, q, 2, qdims, qstrides, qbox);
  if (rc) return rc;
  const int Z = shared_rows ? B : bq;
  const cuuint64_t rdims[3] = {kD, static_cast<cuuint64_t>(K),
                               static_cast<cuuint64_t>(Z)};
  const cuuint64_t rstrides[2] = {kD * 2, static_cast<cuuint64_t>(K) * kD * 2};
  const cuuint32_t rbox[3] = {kBoxCols, kBN, 1};
  rc = encode_bf16(&rmap, rows, 3, rdims, rstrides, rbox);
  if (rc) return rc;
  Params p;
  p.valid = static_cast<const uint8_t*>(valid);
  p.o = static_cast<float*>(o);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.nq = nq;
  p.H = H;
  p.K = K;
  p.rows_per_split = rows_per_split;
  p.shared_rows = shared_rows;
  p.valid_per_query = valid_per_query;
  p.scale = scale;
  p.split_rows = static_cast<int64_t>(bq) * H;
  const dim3 grid(H / kHB, nsplit, bq);
  sparse_mla_tc_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      qmap, rmap, p);
  return (int)cudaGetLastError();
}

// op [nsplit, rows, rank], mp / lp [nsplit, rows] -> o [rows, rank], m, l.
int ess_sparse_mla_merge(const void* op, const void* mp, const void* lp,
                         void* o, void* m, void* l, int nsplit, int64_t rows,
                         int rank, void* stream) {
  if (rows == 0) return 0;
  if (nsplit <= 0 || rank <= 0 || rank % 4 || rows > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  sparse_mla_merge_kernel<<<(unsigned)rows, 128, 0, (cudaStream_t)stream>>>(
      (const float*)op, (const float*)mp, (const float*)lp, (float*)o,
      (float*)m, (float*)l, nsplit, rows, rank);
  return (int)cudaGetLastError();
}

}  // extern "C"
