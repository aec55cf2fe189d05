// Fused pre-LayerNorm -> QKV projection -> QK-LayerNorm for Hopper
// (sm_90a), bf16 in/out.
//
// Replaces the Pallas TPU kernel esmdiff_tpu/ops/fused_qkv.py::_kernel
// (:41, launched at :119).  Same function, per token row x (D values):
//   xn = (x - mean) * 1/sqrt(var + 1e-5) * ln_scale in fp32 (population
//        variance, no bias), rounded to bf16;
//   y_j = xn . W_j for j in {q, k, v}, W_j the D x D column block j of the
//        (D, 3D) weight, accumulated in fp32;
//   q and k: a second fp32 LayerNorm over the D outputs of the FP32 product
//        (the TPU kernel's rounding: the unfused path rounds y to bf16
//        first), two-pass statistics, scaled by q_ln_scale / k_ln_scale;
//        v as is;
//   out = [q | k | v], (T, 3D) bf16.
//
// Bound on an H100: at the trunk's shape (T 4096, D 1536) the products are
// 58.0 GFLOP, 0.059 ms at the bf16 tensor-core peak, while x, W and the
// output are 64 MB, 0.019 ms: the operations bound it, and only wgmma
// reaches the tensor cores' full rate.
//
// Design: the q/k LayerNorm needs the statistics of a whole row of D fp32
// outputs, which one block's registers cannot hold for many rows.  So the D
// output columns of a 192-row tile are split over a thread block cluster of
// 8 blocks (BN = D/8 = 64, 128 or 192 columns each), which exchange per-row
// partial sums through distributed shared memory: first the sums of y
// (-> mean), then of (y - mean)^2 (-> variance), the TPU kernel's two
// passes.  The x LayerNorm statistics are made once per row (24 rows by
// each block of the cluster, shared the same way).
//
// Main loop: three warpgroups of 64 rows each run wgmma.mma_async m64nBNk16
// (bf16 in, fp32 accumulators in registers: BN/2 a thread) over a ring of
// STAGES shared-memory stages, each a 64-deep slice of A = LN(x) (192 rows)
// and of W_j (BN columns) in the 128-byte-swizzled layout wgmma reads.  W
// arrives by TMA (cp.async.bulk.tensor, one descriptor encoded on the host
// per call), issued by one thread STAGES - 1 slices ahead, each stage's
// completion signalled on an mbarrier; a stage is refilled only after every
// warpgroup's wgmma.wait_group and a barrier show it consumed.  One wgmma
// group stays in flight across that barrier.  A is formed by the consumer
// threads: each loads its 16-byte chunks of x one slice ahead into
// registers, normalises them in fp32 (ln_scale from shared memory), rounds
// to bf16 and writes them swizzled (chunk ^ row % 8) while the previous
// slice's wgmma runs; fence.proxy.async and the barrier publish them to the
// tensor cores.  The q/k LayerNorm is taken from the accumulator registers
// (a row lives in one quad of one warp: two shuffles reduce it); the bf16
// tile is staged in shared memory and stored 16 bytes a thread.  The port's
// weight is qkv.weight.t(), a (D, 3D) view whose K dimension is contiguous:
// K-major, wgmma's native B.  A row-major (D, 3D) W is read as MN-major
// 64 x 64 TMA boxes with wgmma's transpose bit for B: no copy either way.
//
// This replaces a main loop of warp-synchronous 16x16x16 tensor-core
// products over 64-row tiles, fed by a two-buffer cp.async pipeline that
// ended every 32-deep step in a full barrier: 0.489 ms at the trunk's
// shape, 12% of the tensor-core peak, where this loop reads 0.190 ms (both
// on an NVIDIA H100 80GB HBM3 at 700.00 W, chip_smoke.py).  It is bound by
// traffic from L2 into the SMs (every block of a cluster reads the same x
// rows, every row tile the same W_j columns), so the tiles are 192 rows
// rather than 128, which cuts W's share of that traffic by a third, and
// the output is staged for 16-byte stores: both read faster on the card.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int CLUSTER = 8;       // blocks sharing one row tile's D columns
constexpr int WGS = 3;           // consumer warpgroups, 64 rows each
constexpr int BM = 64 * WGS;     // token rows per block
constexpr int BK = 64;           // depth of a stage: one 128-byte swizzle row
constexpr int STAGES = 4;        // depth of the ring
constexpr int THREADS = 128 * WGS;  // every warpgroup is a consumer
constexpr int STAT_ROWS = BM / CLUSTER;  // x rows whose statistics a block makes
constexpr int A_STAGE = BM * BK * 2;     // bytes of LN(x) per stage
constexpr int MN_BOX = 64;       // N width of an MN-major TMA box (128 bytes)
constexpr float EPS = 1e-5f;

template <int BN>
struct Cfg {
  static constexpr int D = 8 * BN;
  static constexpr int NK = D / BK;                  // 64-deep slices of D
  static constexpr int B_STAGE = BN * BK * 2;        // bytes of W_j per stage
  static constexpr int RING = STAGES * (A_STAGE + B_STAGE);
  // ring (1024-byte aligned), ln_scale, mbarriers, x statistics, row sums
  static constexpr int SMEM = 1024 + RING + STAGES * 8 + D * 4 +
                              (BM + STAT_ROWS) * 8 + 4 * BM * 4;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits for phase `parity` of `bar` to complete; traps (the launch fails)
// rather than hang if it never does.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t tries = 0;
  do {
    if (++tries == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 2D TMA load of one box at (c0, c1) (innermost coordinate first), its
// bytes counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the wgmma fence/wait instructions.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D += A B, m64n64k16: A and B from shared memory (descriptors),
// D = 32 fp32 registers a thread; TB = 1 when B is MN-major.
template <int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

// D += A B, m64n128k16: A and B from shared memory (descriptors),
// D = 64 fp32 registers a thread; TB = 1 when B is MN-major.
template <int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                          uint64_t db) {
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
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

// D += A B, m64n192k16: A and B from shared memory (descriptors),
// D = 96 fp32 registers a thread; TB = 1 when B is MN-major.
template <int TB>
__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t da,
                                          uint64_t db) {
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
      "}, %96, %97, p, 1, 1, 0, %99;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int BN, int TB>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da,
                                      uint64_t db) {
  if constexpr (BN == 64) wgmma_n64<TB>(d, da, db);
  else if constexpr (BN == 128) wgmma_n128<TB>(d, da, db);
  else wgmma_n192<TB>(d, da, db);
}

// The consumer warpgroups' barrier (every thread of the block).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

// The two halves of a cluster barrier, so that a block can go on working
// between its arrival and its wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int BN, bool kKMajor>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
fused_ln_qkv_kernel(const __grid_constant__ CUtensorMap w_map,
                    const __nv_bfloat16* __restrict__ x, long long ldx,
                    const float* __restrict__ ln_scale,
                    const float* __restrict__ q_scale,
                    const float* __restrict__ k_scale,
                    __nv_bfloat16* __restrict__ out, long long ldo, int T) {
  using C = Cfg<BN>;
  constexpr int D = C::D;
  constexpr int NK = C::NK;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle pattern is a function of the address: 1024-byte alignment
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sA = smem_u32(smem);              // [STAGES][BM x 128 B]
  const uint32_t sB = sA + STAGES * A_STAGE;       // [STAGES][BN x 128 B]
  float* s_ln = reinterpret_cast<float*>(smem + C::RING);        // [D]
  uint64_t* full = reinterpret_cast<uint64_t*>(s_ln + D);        // [STAGES]
  float2* xstat = reinterpret_cast<float2*>(full + STAGES);      // [BM]
  float2* own_stat = xstat + BM;                                 // [STAT_ROWS]
  float* psum = reinterpret_cast<float*>(own_stat + STAT_ROWS);  // [BM]
  float* psq = psum + BM;                                        // [BM]
  float* row_mean = psq + BM;                                    // [BM]
  float* row_rstd = row_mean + BM;                               // [BM]

  const int rank = (int)cluster.block_rank();
  const int row0 = blockIdx.y * BM;
  const int j = blockIdx.z;  // 0 = q, 1 = k, 2 = v
  const int col0 = rank * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // W_j's 64-deep slice t into ring stage t % STAGES
  const CUtensorMap* wmap = &w_map;
  auto load_w = [&](int t) {
    const int s = t % STAGES;
    const uint32_t bar = smem_u32(full + s);
    const uint32_t dst = sB + s * C::B_STAGE;
    mbar_expect_tx(bar, C::B_STAGE);
    if constexpr (kKMajor) {
      tma_load(dst, wmap, bar, t * BK, j * D + col0);
    } else {
#pragma unroll
      for (int b = 0; b < BN / MN_BOX; ++b)
        tma_load(dst + b * MN_BOX * BK * 2, wmap, bar,
                 j * D + col0 + b * MN_BOX, t * BK);
    }
  };

  // A = LN(x): each thread owns 16-byte chunk ac of rows ar + THREADS/8 u
  // and holds the raw chunks of the next slice in registers
  const int ac = tid % 8;
  const int ar = tid / 8;
  const __nv_bfloat16* x_src[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = ar + (THREADS / 8) * u;
    x_src[u] = row0 + r < T ? x + (long long)(row0 + r) * ldx + ac * 8
                            : nullptr;
  }
  uint4 xv[4];
  auto load_x = [&](int t) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      xv[u] = x_src[u] ? *reinterpret_cast<const uint4*>(x_src[u] + t * BK)
                       : make_uint4(0u, 0u, 0u, 0u);
  };

  // 0. the ring's barriers and its first W slices; every load of the
  // prologue (x slice 0, ln_scale, the x rows of the statistics) is issued
  // before any of them is used
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(full + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#pragma unroll
    for (int t = 0; t < STAGES && t < NK; ++t) load_w(t);
  }
  load_x(0);
  {
    constexpr int LN_PER = (D + THREADS - 1) / THREADS;
    float g[LN_PER];
#pragma unroll
    for (int k = 0; k < LN_PER; ++k)
      if (tid + k * THREADS < D) g[k] = ln_scale[tid + k * THREADS];
#pragma unroll
    for (int k = 0; k < LN_PER; ++k)
      if (tid + k * THREADS < D) s_ln[tid + k * THREADS] = g[k];
  }

  // 1. LayerNorm statistics of x, two rows per warp, shared with the cluster
  {
    constexpr int CH = D / 8 / 32;                  // 16-byte chunks per lane
    constexpr int HR = STAT_ROWS / (THREADS / 32);  // rows per warp
    uint4 v[HR][CH];
#pragma unroll
    for (int h = 0; h < HR; ++h) {
      const int row = row0 + rank * STAT_ROWS + warp * HR + h;
      const __nv_bfloat16* src = x + (long long)row * ldx + lane * 8;
#pragma unroll
      for (int u = 0; u < CH; ++u)
        v[h][u] = row < T ? *reinterpret_cast<const uint4*>(src + 256 * u)
                          : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int h = 0; h < HR; ++h) {
      float s = 0.0f;
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v[h][u]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(p[e]);
          s += f.x;
          s += f.y;
        }
      }
      const float mean = esmdiff::warp_sum(s) / (float)D;
      float q = 0.0f;
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v[h][u]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(p[e]);
          q += (f.x - mean) * (f.x - mean);
          q += (f.y - mean) * (f.y - mean);
        }
      }
      const float var = esmdiff::warp_sum(q) / (float)D;
      const bool ok = row0 + rank * STAT_ROWS + warp * HR + h < T;
      if (lane == 0)
        own_stat[warp * HR + h] = ok ? make_float2(mean, 1.0f / sqrtf(var + EPS))
                                     : make_float2(0.0f, 0.0f);
    }
  }
  cluster.sync();  // also publishes the initialised mbarriers
  if (tid < BM)
    xstat[tid] = *cluster.map_shared_rank(own_stat + tid % STAT_ROWS,
                                          tid / STAT_ROWS);
  // own_stat must outlive every remote read of it: the matching wait
  // follows the main loop
  cluster_arrive();
  consumer_sync();  // xstat complete

  // 2. normalise the raw chunks of slice t in fp32 and write them, rounded
  // to bf16 and swizzled (chunk ^ row % 8), into ring stage s
  float2 st[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) st[u] = xstat[ar + (THREADS / 8) * u];
  auto store_xn = [&](int t, int s) {
    const float4* g = reinterpret_cast<const float4*>(s_ln + t * BK + ac * 8);
    const float4 g0 = g[0], g1 = g[1];
    const float sc[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = ar + (THREADS / 8) * u;
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&xv[u]);
      uint4 o;
      __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p[e]);
        q[e] = __floats2bfloat162_rn((f.x - st[u].x) * st[u].y * sc[2 * e],
                                     (f.y - st[u].x) * st[u].y * sc[2 * e + 1]);
      }
      // rows past T come out 0: their x and statistics are 0
      *reinterpret_cast<uint4*>(smem + s * A_STAGE + r * 128 +
                                ((ac ^ (r & 7)) << 4)) = o;
    }
  };

  // 3. y = A . W_j[:, col0:col0+BN] in fp32 registers: warpgroup wg owns
  // rows wg*64 .. +64 of the tile
  const int wg = tid / 128;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

  store_xn(0, 0);
  load_x(1);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumer_sync();
  // One wgmma group stays in flight across the barrier.  Iteration kt
  //   issues the products of slice kt and waits for those of slice kt - 1;
  //   writes A(kt + 1) into its stage (last read by slice kt + 1 - STAGES,
  //   finished in every warpgroup before the previous barrier) and loads
  //   x for slice kt + 2;
  //   after the barrier, refills the stage of slice kt - 1, which every
  //   warpgroup has finished reading, with W slice kt - 1 + STAGES.
#pragma unroll 1
  for (int kt = 0; kt < NK; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(smem_u32(full + s), (kt / STAGES) & 1);
    const uint32_t a0 = sA + s * A_STAGE + wg * 64 * 128;
    const uint32_t b0 = sB + s * C::B_STAGE;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      // K-major: 16 deeper is 32 bytes along the swizzled row; MN-major:
      // 16 rows of 128 bytes, N boxes MN_BOX * BK * 2 bytes apart
      const uint64_t da = sw128_desc(a0 + ks * 32, 16, 1024);
      const uint64_t db =
          kKMajor ? sw128_desc(b0 + ks * 32, 16, 1024)
                  : sw128_desc(b0 + ks * 16 * 128, MN_BOX * BK * 2, 1024);
      wgmma<BN, kKMajor ? 0 : 1>(acc, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(acc);
    if (kt + 1 < NK) {
      store_xn(kt + 1, (kt + 1) % STAGES);
      if (kt + 2 < NK) load_x(kt + 2);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    consumer_sync();
    if (tid == 0 && kt >= 1 && kt - 1 + STAGES < NK) load_w(kt - 1 + STAGES);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
  cluster_wait();  // every block of the cluster has read its xstat

  // 4. q, k: LayerNorm over all D columns of each row from the registers.
  // Accumulator layout: register 4n + 2h + c holds row rl + 8h, column
  // 8n + 2 (lane % 4) + c; a row lives in the four lanes of one quad.
  const int rl = wg * 64 + (warp % 4) * 16 + lane / 4;
  if (j < 2) {  // the same for every block of a cluster
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      s0 += acc[4 * n] + acc[4 * n + 1];
      s1 += acc[4 * n + 2] + acc[4 * n + 3];
    }
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, m);
      s1 += __shfl_xor_sync(0xffffffffu, s1, m);
    }
    if (lane % 4 == 0) {
      psum[rl] = s0;
      psum[rl + 8] = s1;
    }
    cluster.sync();
    if (tid < BM) {
      float total = 0.0f;
#pragma unroll
      for (int b = 0; b < CLUSTER; ++b)
        total += *cluster.map_shared_rank(psum + tid, b);
      row_mean[tid] = total / (float)D;
    }
    consumer_sync();
    const float m0 = row_mean[rl], m1 = row_mean[rl + 8];
    float q0 = 0.0f, q1 = 0.0f;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float d0 = acc[4 * n + c] - m0;
        const float d1 = acc[4 * n + 2 + c] - m1;
        q0 += d0 * d0;
        q1 += d1 * d1;
      }
    }
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1) {
      q0 += __shfl_xor_sync(0xffffffffu, q0, m);
      q1 += __shfl_xor_sync(0xffffffffu, q1, m);
    }
    if (lane % 4 == 0) {
      psq[rl] = q0;
      psq[rl + 8] = q1;
    }
    cluster.sync();
    if (tid < BM) {
      float sq = 0.0f;
#pragma unroll
      for (int b = 0; b < CLUSTER; ++b)
        sq += *cluster.map_shared_rank(psq + tid, b);
      row_rstd[tid] = 1.0f / sqrtf(sq / (float)D + EPS);
    }
    cluster.sync();  // every remote read is done: blocks may finish
    const float r0 = row_rstd[rl], r1 = row_rstd[rl + 8];
    const float* post = (j == 0 ? q_scale : k_scale) + col0 + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float g = post[8 * n + c];
        acc[4 * n + c] = (acc[4 * n + c] - m0) * r0 * g;
        acc[4 * n + 2 + c] = (acc[4 * n + 2 + c] - m1) * r1 * g;
      }
    }
  }

  // 5. bf16 tile staged in shared memory over the ring (every warpgroup's
  // products are done after the barrier), then 16-byte row-contiguous
  // stores; rows past T are not written
  consumer_sync();
  {
    constexpr int PITCH = BN * 2 + 16;  // bytes a staged row: no bank conflicts
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(smem + (rl + 8 * h) * PITCH +
                                           (8 * n + 2 * (lane % 4)) * 2) =
            __floats2bfloat162_rn(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
    consumer_sync();
    constexpr int CPR = BN / 8;  // 16-byte chunks a row
    for (int e = tid; e < BM * CPR; e += THREADS) {
      const int r = e / CPR, c = e % CPR;
      if (row0 + r < T)
        *reinterpret_cast<uint4*>(out + (long long)(row0 + r) * ldo +
                                  (long long)j * D + col0 + c * 8) =
            *reinterpret_cast<const uint4*>(smem + r * PITCH + c * 16);
    }
  }
}

// cuTensorMapEncodeTiled, a CUDA driver API function, fetched through the
// runtime (cudaGetDriverEntryPoint*; no link against libcuda); null if the
// installed CUDA driver does not have it.
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// The TMA descriptor of W (D, 3D) bf16 with leading stride ldw (elements):
// K-major (stride 1 along D) boxes of BK x BN, or MN-major boxes of
// MN_BOX x BK; 128-byte swizzle, as the ring stage expects.
template <int BN, bool kKMajor>
cudaError_t encode_w_map(CUtensorMap* map, const void* w, long long ldw) {
  constexpr int D = Cfg<BN>::D;
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {kKMajor ? (cuuint64_t)D : (cuuint64_t)3 * D,
                              kKMajor ? (cuuint64_t)3 * D : (cuuint64_t)D};
  const cuuint64_t strides[1] = {(cuuint64_t)ldw * 2};
  const cuuint32_t box[2] = {kKMajor ? (cuuint32_t)BK : (cuuint32_t)MN_BOX,
                             kKMajor ? (cuuint32_t)BN : (cuuint32_t)BK};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BN, bool kKMajor>
int launch_one(const void* x, long long ldx, const float* ln_scale,
               const void* w, long long ldw, const float* q_scale,
               const float* k_scale, void* out, long long ldo, int T,
               cudaStream_t stream) {
  CUtensorMap w_map;
  cudaError_t err = encode_w_map<BN, kKMajor>(&w_map, w, ldw);
  if (err != cudaSuccess) return (int)err;
  auto kernel = &fused_ln_qkv_kernel<BN, kKMajor>;
  const int smem = Cfg<BN>::SMEM;
  err = esmdiff::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(CLUSTER, (T + BM - 1) / BM, 3);
  kernel<<<grid, THREADS, smem, stream>>>(
      w_map, static_cast<const __nv_bfloat16*>(x), ldx, ln_scale, q_scale,
      k_scale, static_cast<__nv_bfloat16*>(out), ldo, T);
  return (int)cudaGetLastError();
}

template <int BN>
int launch(bool k_major, const void* x, long long ldx, const float* ln_scale,
           const void* w, long long ldw, const float* q_scale,
           const float* k_scale, void* out, long long ldo, int T,
           cudaStream_t stream) {
  return k_major ? launch_one<BN, true>(x, ldx, ln_scale, w, ldw, q_scale,
                                        k_scale, out, ldo, T, stream)
                 : launch_one<BN, false>(x, ldx, ln_scale, w, ldw, q_scale,
                                         k_scale, out, ldo, T, stream);
}

}  // namespace

// Plain C interface, loaded with ctypes.  x: (T, D) bf16 with row stride
// ldx (a multiple of 8, 16-byte aligned); w: (D, 3D) bf16 with element
// strides (w_s0, w_s1), one of them 1 and the other a multiple of 8,
// 16-byte aligned (TMA's rules); scales fp32 (D,); out: (T, 3D) bf16 with
// row stride ldo.  D is 512, 1024 or 1536 (the Python wrapper checks all of
// it).  Launches on `stream`, does not synchronise, and returns a CUDA
// error code: cudaErrorSymbolNotFound if the CUDA driver has no
// cuTensorMapEncodeTiled, cudaErrorInvalidValue if it refuses W's
// descriptor, else cudaGetLastError() after the launch.
extern "C" int esmdiff_fused_ln_qkv_fwd(
    const void* x, long long ldx, const float* ln_scale, const void* w,
    long long w_s0, long long w_s1, const float* q_scale,
    const float* k_scale, void* out, long long ldo, int T, int D,
    void* stream) {
  const bool k_major = w_s0 == 1;
  const long long ldw = k_major ? w_s1 : w_s0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 512:
      return launch<64>(k_major, x, ldx, ln_scale, w, ldw, q_scale, k_scale,
                        out, ldo, T, s);
    case 1024:
      return launch<128>(k_major, x, ldx, ln_scale, w, ldw, q_scale, k_scale,
                         out, ldo, T, s);
    case 1536:
      return launch<192>(k_major, x, ldx, ln_scale, w, ldw, q_scale, k_scale,
                         out, ldo, T, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
