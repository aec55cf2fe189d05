// Fused pre-norm SwiGLU FFN for Hopper (sm_90a), bf16 in/out.
//
// Replaces the Pallas TPU kernel esmdiff_tpu/ops/fused_ffn.py::_kernel
// (:34, launched at :91).  Same function, per row x (D values):
//   xn = (x - mean) * 1/sqrt(var + 1e-5) * ln_scale in fp32 (population
//        variance), rounded to bf16;
//   [a | b] = xn . W_up, W_up (D, 2H), accumulated in fp32;
//   hid = silu(a) * b in fp32, rounded to bf16;
//   y = hid . W_down, W_down (H, D), accumulated in fp32 over all of H,
//       stored bf16.
//
// Bound on an H100: at the trunk's shape (M 4096, D 1536, H 4096) the
// products are 154.6 GFLOP, 0.156 ms at the bf16 tensor-core peak, while x,
// the weights and y are 63 MB, 0.019 ms: the operations bound it, and only
// wgmma reaches the tensor cores' full rate.
//
// Design: on the TPU a sequential H grid axis carries the fp32 sum in VMEM
// scratch.  Here a 128-row tile is owned by a thread block cluster of 8
// blocks, and block `rank` owns output columns [rank BN, (rank + 1) BN),
// BN = D/8 = 64, 128 or 192: its y accumulators (m64nBN, BN/2 fp32
// registers a thread, two warpgroups of 64 rows) stay in registers over the
// whole H loop.  First each block normalises 16 of the tile's rows, once,
// into xn, an (M, D) bf16 scratch of the caller's, from which all 8 load
// LN(x) by TMA.  Then H is walked in chunks of BH = 512 hidden columns, of
// which each block makes one 64-column slice:
//   up:   [a | b] slice = LN(x) . W_up[:, its 64 a and 64 b columns], one
//         m64n128 product over K = D, so a and b of a hidden column land in
//         the same thread's registers; silu(a) b is taken there, rounded to
//         bf16 and written once into the block's own shared memory, in the
//         128-byte-swizzled layout wgmma reads as A;
//   swap: one cluster barrier makes the 8 slices readable: its arrival
//         follows the slice's writing, its wait the first down products,
//         which read the block's own slice in place; the slices are
//         double-buffered, and the barrier of chunk c + 1 also shows every
//         block done reading chunk c's buffer, which chunk c + 2 rewrites;
//   down: y += hid[:, slice p] . W_down[slice p rows, its BN columns] for
//         p over the 8 blocks: each other block's slice is read over
//         distributed shared memory 16 bytes a thread, one slice ahead into
//         registers, and written verbatim (already swizzled) into the ring.
// Both phases run on one ring of STAGES shared-memory stages, each a
// 64-deep A slice (LN(x), or a hid slice) and a B slice (64 a + 64 b
// columns of W_up, or BN columns of W_down), read by wgmma.mma_async (the
// helpers of hopper.cuh).  LN(x) and B arrive by TMA
// (cp.async.bulk.tensor, three descriptors encoded on the host per call),
// issued by one thread STAGES - 1 slices ahead on an mbarrier per stage; a
// stage is refilled only after every warpgroup's wgmma.wait_group and a
// barrier show it consumed, and one wgmma group stays in flight across that
// barrier.  The (M, 2H) up-projection and the (M, H) hidden never reach
// device memory, the kernel's point.  Weights are read in place: the
// port's up.weight.t() and down.weight.t() are K-major, wgmma's native B;
// contiguous (D, 2H) and (H, D) matrices are MN-major 64 x 64 TMA boxes
// read through wgmma's transpose bit.  Rows past M are not written to xn
// (TMA reads them as zeros) and are not stored; y is staged through the
// freed ring for 16-byte stores.
//
// What bounds it, measured on an H100 (esmdiff_tpu_torch/tools/
// ffn_anatomy.py; numbers in PERF.md): at most 15 clusters of this size run
// at once, and a tile takes the same time however many share the card, so
// the trunk's 32 row tiles take three waves.  Within a tile the loop, not
// the tensor cores, sets the pace: each 64-deep slice spends about as long
// again as its products on the wait for its stage, the wgmma issue, the
// barrier and the refill, a down slice more for its copy over distributed
// shared memory, and each chunk boundary (the gate, the cluster barrier)
// several slices' worth.  LN(x) goes through the scratch because forming
// it in the ring by the threads, as fused_qkv.cu does, was redone for each
// of the H/512 chunks and took a large share of every up slice.

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace esmdiff;

constexpr int CLUSTER = 8;       // blocks sharing one row tile
constexpr int WGS = 2;           // consumer warpgroups, 64 rows each
constexpr int BM = 64 * WGS;     // token rows per block
constexpr int BK = 64;           // depth of a stage: one 128-byte swizzle row
constexpr int HS = 64;           // hidden columns a block makes per chunk
constexpr int BH = HS * CLUSTER;  // hidden columns per chunk
constexpr int STAGES = 4;        // depth of the ring
constexpr int THREADS = 128 * WGS;  // every warpgroup is a consumer
constexpr int LN_ROWS = BM / CLUSTER;    // x rows a block normalises
constexpr int A_STAGE = BM * BK * 2;     // bytes of an A slice (and of hid)
constexpr int UP_B = 2 * HS * BK * 2;    // bytes of W_up per up slice
constexpr int MN_BOX = 64;       // N width of an MN-major TMA box (128 bytes)
constexpr float EPS = 1e-5f;

template <int BN>
struct Cfg {
  static constexpr int D = 8 * BN;
  static constexpr int NK = D / BK;            // up slices per chunk
  static constexpr int SPC = NK + CLUSTER;     // slices per chunk: up, down
  static constexpr int DOWN_B = BN * BK * 2;   // bytes of W_down per slice
  static constexpr int B_STAGE = DOWN_B > UP_B ? DOWN_B : UP_B;
  static constexpr int RING = STAGES * (A_STAGE + B_STAGE);
  // ring (1024-byte aligned), two hid slices, mbarriers
  static constexpr int SMEM = 1024 + RING + 2 * A_STAGE + STAGES * 8;
};

// The consumer warpgroups' barrier (every thread of the block).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

template <int BN, bool kUpK, bool kDownK>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
fused_swiglu_ffn_kernel(const __grid_constant__ CUtensorMap xn_map,
                        const __grid_constant__ CUtensorMap up_map,
                        const __grid_constant__ CUtensorMap down_map,
                        const __nv_bfloat16* __restrict__ x, long long ldx,
                        const float* __restrict__ ln_scale,
                        __nv_bfloat16* __restrict__ xn,
                        __nv_bfloat16* __restrict__ out, long long ldo, int M,
                        int H) {
  using C = Cfg<BN>;
  constexpr int D = C::D;
  constexpr int NK = C::NK;
  constexpr int SPC = C::SPC;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle pattern is a function of the address: 1024-byte alignment
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sA = smem_u32(smem);              // [STAGES][BM x 128 B]
  const uint32_t sB = sA + STAGES * A_STAGE;       // [STAGES][B_STAGE]
  unsigned char* hid = smem + C::RING;             // [2][BM x 128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(hid + 2 * A_STAGE);  // [STAGES]

  const int rank = (int)cluster.block_rank();
  const int row0 = blockIdx.y * BM;
  const int col0 = rank * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wg = tid / 128;
  const int nc = H / BH;           // chunks of H
  const int total = nc * SPC;      // slices of the whole H loop

  // Slice g into ring stage g % STAGES.  Slice i of a chunk is, for i < NK,
  // LN(x)'s columns i*BK.. and W_up's rows i*BK.. at this block's a columns
  // h0 + HS*rank and b columns H + h0 + HS*rank; else W_down's rows of the
  // hid slice of block (rank + i - NK) % CLUSTER at this block's BN columns
  // (its A, that hid slice, is copied by the threads).
  const CUtensorMap* amap = &xn_map;
  const CUtensorMap* umap = &up_map;
  const CUtensorMap* dmap = &down_map;
  auto load_stage = [&](int g) {
    const int s = g % STAGES;
    const uint32_t bar = smem_u32(full + s);
    const uint32_t dst = sB + s * C::B_STAGE;
    const int h0 = g / SPC * BH;
    const int i = g % SPC;
    if (i < NK) {
      const int n0 = h0 + HS * rank;
      mbar_expect_tx(bar, A_STAGE + UP_B);
      tma_load(sA + s * A_STAGE, amap, bar, i * BK, row0);
      if constexpr (kUpK) {
        tma_load(dst, umap, bar, i * BK, n0);
        tma_load(dst + HS * BK * 2, umap, bar, i * BK, H + n0);
      } else {
        tma_load(dst, umap, bar, n0, i * BK);
        tma_load(dst + HS * BK * 2, umap, bar, H + n0, i * BK);
      }
    } else {
      const int k0 = h0 + HS * ((rank + i - NK) % CLUSTER);
      mbar_expect_tx(bar, C::DOWN_B);
      if constexpr (kDownK) {
        tma_load(dst, dmap, bar, k0, col0);
      } else {
#pragma unroll
        for (int b = 0; b < BN / MN_BOX; ++b)
          tma_load(dst + b * MN_BOX * BK * 2, dmap, bar, col0 + b * MN_BOX,
                   k0);
      }
    }
  };

  // 0. the ring's barriers; LN(x) of this block's LN_ROWS rows of the tile
  // (two a warp) in fp32, rounded to bf16 into xn, from which every block
  // of the cluster loads its A slices by TMA (rows past M are not written:
  // TMA fills them with zeros)
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(full + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  {
    constexpr int CH = D / 8 / 32;                // 16-byte chunks per lane
    constexpr int HR = LN_ROWS / (THREADS / 32);  // rows per warp
    uint4 v[HR][CH];
#pragma unroll
    for (int h = 0; h < HR; ++h) {
      const int row = row0 + rank * LN_ROWS + warp * HR + h;
      const __nv_bfloat16* src = x + (long long)row * ldx + lane * 8;
#pragma unroll
      for (int u = 0; u < CH; ++u)
        v[h][u] = row < M ? *reinterpret_cast<const uint4*>(src + 256 * u)
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
      const float mean = warp_sum(s) / (float)D;
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
      const float rstd = 1.0f / sqrtf(warp_sum(q) / (float)D + EPS);
      const int row = row0 + rank * LN_ROWS + warp * HR + h;
      if (row < M) {
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          const float* sc = ln_scale + lane * 8 + 256 * u;
          const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v[h][u]);
          uint4 o;
          __nv_bfloat162* r = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(p[e]);
            r[e] = __floats2bfloat162_rn((f.x - mean) * rstd * sc[2 * e],
                                         (f.y - mean) * rstd * sc[2 * e + 1]);
          }
          *reinterpret_cast<uint4*>(xn + (long long)row * D + lane * 8 +
                                    256 * u) = o;
        }
      }
    }
  }
  // the generic proxy's writes of xn before the TMA (async proxy) reads of
  // every block of the cluster; the barrier also publishes the mbarriers
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  cluster.sync();
  if (tid == 0) {
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
#pragma unroll
    for (int g = 0; g < STAGES; ++g) load_stage(g);  // total >= SPC > STAGES
  }

  // The swap: this warpgroup's 64 rows of block (rank + p)'s hid slice in
  // buffer buf, read 16 bytes a thread into registers one slice ahead
  // (fetch_hid), then written as they lie (already swizzled) into a ring
  // stage (put_hid).
  constexpr int PER = A_STAGE / WGS / 16 / 128;  // 16-byte chunks a thread
  const int hoff = wg * (A_STAGE / WGS) + (tid % 128) * 16;
  uint4 hv[PER];
  auto fetch_hid = [&](int p, int buf) {
    const unsigned char* src = cluster.map_shared_rank(
        hid + buf * A_STAGE + hoff, (rank + p) % CLUSTER);
#pragma unroll
    for (int u = 0; u < PER; ++u)
      hv[u] = *reinterpret_cast<const uint4*>(src + 128 * 16 * u);
  };
  auto put_hid = [&](int s) {
    unsigned char* dst = smem + s * A_STAGE + hoff;
#pragma unroll
    for (int u = 0; u < PER; ++u)
      *reinterpret_cast<uint4*>(dst + 128 * 16 * u) = hv[u];
  };

  // Accumulator layout (m64nN): register 4n + 2h + c holds row rl + 8h of
  // the tile, column 8n + 2 (lane % 4) + c.  In acc_h columns 0..63 are a,
  // 64..127 the b of the same hidden columns.
  const int rl = wg * 64 + (warp % 4) * 16 + lane / 4;
  float acc_y[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc_y[i] = 0.0f;
  float acc_h[2 * HS / 2];

  // hid = silu(a) b in fp32, rounded to bf16, into hid buffer buf as the A
  // operand of the down products (128-byte rows, chunk ^ row % 8).  The
  // fast exp and division are a few fp32 ulps off, far below the bf16
  // rounding that follows; a correctly rounded division is a long software
  // sequence, and it showed in the kernel's time.
  auto store_hid = [&](int buf) {
    unsigned char* dst = hid + buf * A_STAGE;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rl + 8 * h;
#pragma unroll
      for (int n = 0; n < HS / 8; ++n) {
        const float a0 = acc_h[4 * n + 2 * h], a1 = acc_h[4 * n + 2 * h + 1];
        const float b0 = acc_h[4 * (n + HS / 8) + 2 * h];
        const float b1 = acc_h[4 * (n + HS / 8) + 2 * h + 1];
        *reinterpret_cast<__nv_bfloat162*>(
            dst + r * 128 + ((n ^ (r & 7)) << 4) + (lane % 4) * 4) =
            __floats2bfloat162_rn(__fdividef(a0, 1.0f + __expf(-a0)) * b0,
                                  __fdividef(a1, 1.0f + __expf(-a1)) * b1);
      }
    }
  };

  // wgmma descriptors of stage 0, this warpgroup's rows; a stage's or a K
  // step's offset is added to the start address field (bytes / 16)
  const uint64_t dA0 = sw128_desc(sA + wg * 64 * 128, 16, 1024);
  const uint64_t dH0 = sw128_desc(smem_u32(hid) + wg * 64 * 128, 16, 1024);
  const uint64_t dU0 =
      kUpK ? sw128_desc(sB, 16, 1024) : sw128_desc(sB, HS * BK * 2, 1024);
  const uint64_t dD0 = kDownK ? sw128_desc(sB, 16, 1024)
                              : sw128_desc(sB, MN_BOX * BK * 2, 1024);
  // K-major: 16 deeper is 32 bytes along the swizzled row; MN-major: 16
  // rows of 128 bytes
  constexpr int KSTEP_U = kUpK ? 32 : 16 * 128;
  constexpr int KSTEP_D = kDownK ? 32 : 16 * 128;

  // Slice g: wait for its stage, issue its products and wait for those of
  // slice g - 1 (one group stays in flight); after the barrier, refill the
  // stage of slice g - 1, which every warpgroup has finished reading, with
  // slice g - 1 + STAGES.  A down slice's A is written into its stage one
  // slice ahead (that stage was last read by slice g + 1 - STAGES, finished
  // in every warpgroup before the previous barrier).
  auto refill = [&](int g) {
    if (tid == 0 && g >= 1 && g - 1 + STAGES < total)
      load_stage(g - 1 + STAGES);
  };
  int g = 0;
  int c = 0;
  // a do-while: with a zero-trip path the compiler writes the accumulators
  // outside the wgmma pipeline, and ptxas then serialises every wgmma
  // (warning C7515)
#pragma unroll 1
  do {
    const int buf = c & 1;
    // up: [a | b] = LN(x) . W_up, K = D
#pragma unroll
    for (int i = 0; i < 2 * HS / 2; ++i) acc_h[i] = 0.0f;
#pragma unroll 1
    for (int kt = 0; kt < NK; ++kt, ++g) {
      const int s = g % STAGES;
      mbar_wait(smem_u32(full + s), (g / STAGES) & 1);
      fence_acc(acc_h);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        wgmma_n128<kUpK ? 0 : 1>(
            acc_h, dA0 + ((s * A_STAGE + ks * 32) >> 4),
            dU0 + ((s * C::B_STAGE + ks * KSTEP_U) >> 4));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (kt + 1 < NK) {
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_acc(acc_h);
      } else {
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(acc_h);
        store_hid(buf);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        // this block's slice is written (the first down slice reads it in
        // place); the wait follows that slice's products
        cluster_arrive();
      }
      consumer_sync();
      refill(g);
    }
    // down: y += hid . W_down, K = BH, one 64-deep slice per block, this
    // block's own first
#pragma unroll 1
    for (int p = 0; p < CLUSTER; ++p, ++g) {
      const int s = g % STAGES;
      mbar_wait(smem_u32(full + s), (g / STAGES) & 1);
      const uint64_t da =
          p == 0 ? dH0 + ((buf * A_STAGE) >> 4) : dA0 + ((s * A_STAGE) >> 4);
      fence_acc(acc_y);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        wgmma<BN, kDownK ? 0 : 1>(
            acc_y, da + ((ks * 32) >> 4),
            dD0 + ((s * C::B_STAGE + ks * KSTEP_D) >> 4));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (p == 0) {
        // every slice of this chunk is written, and every block is done
        // reading the buffer written two chunks ago
        cluster_wait();
        fetch_hid(1, buf);
      }
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(acc_y);
      if (p + 1 < CLUSTER) {
        put_hid((g + 1) % STAGES);
        if (p + 2 < CLUSTER) fetch_hid(p + 2, buf);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }
      consumer_sync();
      refill(g);
    }
  } while (++c < nc);
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc_y);
  cluster_arrive();  // this block's reads of other blocks' hid are done

  // bf16 tile staged in shared memory over the ring (every warpgroup's
  // products are done after the barrier), then 16-byte row-contiguous
  // stores; rows past M are not written
  consumer_sync();
  {
    constexpr int PITCH = BN * 2 + 16;  // bytes a staged row: no bank conflicts
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(smem + (rl + 8 * h) * PITCH +
                                           (8 * n + 2 * (lane % 4)) * 2) =
            __floats2bfloat162_rn(acc_y[4 * n + 2 * h],
                                  acc_y[4 * n + 2 * h + 1]);
    consumer_sync();
    constexpr int CPR = BN / 8;  // 16-byte chunks a row
    for (int e = tid; e < BM * CPR; e += THREADS) {
      const int r = e / CPR, ch = e % CPR;
      if (row0 + r < M)
        *reinterpret_cast<uint4*>(out + (long long)(row0 + r) * ldo + col0 +
                                  ch * 8) =
            *reinterpret_cast<const uint4*>(smem + r * PITCH + ch * 16);
    }
  }
  cluster_wait();  // no block reads this block's hid any more: it may exit
}

// A call's arguments, as the C entry point takes them.
struct Args {
  const void* x;
  long long ldx;
  const float* ln_scale;
  const void* w_up;
  long long ld_up;
  const void* w_down;
  long long ld_down;
  void* xn;
  void* out;
  long long ldo;
  int M, H;
};

// The TMA descriptors of LN(x) (M, D) in xn and of W_up (D, 2H) and W_down
// (H, D), bf16, leading strides in elements: the weights K-major (stride 1
// along the first dimension) or MN-major; 128-byte swizzle, as the ring
// stage expects.
template <int BN, bool kUpK, bool kDownK>
cudaError_t encode_maps(const Args& a, CUtensorMap* xn_map,
                        CUtensorMap* up_map, CUtensorMap* down_map) {
  constexpr int D = Cfg<BN>::D;
  const long long H = a.H;
  cudaError_t err = encode_sw128_map(xn_map, a.xn, D, a.M, D, BK, BM);
  if (err != cudaSuccess) return err;
  err = kUpK ? encode_sw128_map(up_map, a.w_up, D, 2 * H, a.ld_up, BK, HS)
             : encode_sw128_map(up_map, a.w_up, 2 * H, D, a.ld_up, HS, BK);
  if (err != cudaSuccess) return err;
  return kDownK
             ? encode_sw128_map(down_map, a.w_down, H, D, a.ld_down, BK, BN)
             : encode_sw128_map(down_map, a.w_down, D, H, a.ld_down, MN_BOX,
                                BK);
}

template <int BN, bool kUpK, bool kDownK>
int launch_one(const Args& a, cudaStream_t stream) {
  CUtensorMap xn_map, up_map, down_map;
  cudaError_t err =
      encode_maps<BN, kUpK, kDownK>(a, &xn_map, &up_map, &down_map);
  if (err != cudaSuccess) return (int)err;
  auto kernel = &fused_swiglu_ffn_kernel<BN, kUpK, kDownK>;
  const int smem = Cfg<BN>::SMEM;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(CLUSTER, (a.M + BM - 1) / BM);
  kernel<<<grid, THREADS, smem, stream>>>(
      xn_map, up_map, down_map, static_cast<const __nv_bfloat16*>(a.x),
      a.ldx, a.ln_scale, static_cast<__nv_bfloat16*>(a.xn),
      static_cast<__nv_bfloat16*>(a.out), a.ldo, a.M, a.H);
  return (int)cudaGetLastError();
}

template <int BN>
int launch(bool up_k, bool down_k, const Args& a, cudaStream_t s) {
  if (up_k)
    return down_k ? launch_one<BN, true, true>(a, s)
                  : launch_one<BN, true, false>(a, s);
  return down_k ? launch_one<BN, false, true>(a, s)
                : launch_one<BN, false, false>(a, s);
}

}  // namespace

// Plain C interface, loaded with ctypes.  x: (M, D) bf16 with row stride
// ldx (a multiple of 8, 16-byte aligned); w_up: (D, 2H) and w_down: (H, D)
// bf16 with element strides (s0, s1), one of them 1 and the other a
// multiple of 8, 16-byte aligned (TMA's rules); ln_scale fp32 (D,); xn: a
// contiguous (M, D) bf16 scratch, 16-byte aligned, for LN(x); out: (M, D)
// bf16 with row stride ldo.  D is 512, 1024 or 1536 and H a multiple of
// 512 (the Python wrapper checks all of it).  Launches on `stream`, does
// not synchronise, and returns a CUDA error code: cudaErrorSymbolNotFound
// if the CUDA driver has no cuTensorMapEncodeTiled, cudaErrorInvalidValue
// if it refuses a descriptor or the shape is not taken, else
// cudaGetLastError() after the launch.
extern "C" int esmdiff_fused_swiglu_ffn_fwd(
    const void* x, long long ldx, const float* ln_scale, const void* w_up,
    long long up_s0, long long up_s1, const void* w_down, long long down_s0,
    long long down_s1, void* xn, void* out, long long ldo, int M, int D,
    int H, void* stream) {
  const bool up_k = up_s0 == 1;
  const bool down_k = down_s0 == 1;
  const Args a{x,      ldx, ln_scale, w_up, up_k ? up_s1 : up_s0,
               w_down, down_k ? down_s1 : down_s0, xn, out, ldo, M, H};
  cudaStream_t s = (cudaStream_t)stream;
  if (H <= 0 || H % BH) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 512:
      return launch<64>(up_k, down_k, a, s);
    case 1024:
      return launch<128>(up_k, down_k, a, s);
    case 1536:
      return launch<192>(up_k, down_k, a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
