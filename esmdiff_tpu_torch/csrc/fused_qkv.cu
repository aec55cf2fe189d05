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
//        first), scaled by q_ln_scale / k_ln_scale; v as is;
//   out = [q | k | v], (T, 3D) bf16.
//
// Bound on an H100: at the trunk's shape (T 4096, D 1536) the products are
// 58.0 GFLOP, 0.059 ms at the bf16 tensor-core peak, while x, W and the
// output are 64 MB, 0.019 ms: the operations bound it.
//
// Design: the q/k LayerNorm needs the statistics of a whole row of D fp32
// outputs, and a block's registers cannot hold many such rows.  So the D
// outputs of a 64-row tile are split over a thread block cluster of 8
// blocks (D/8 = 192 columns each at D = 1536), which exchange per-row
// partial sums through distributed shared memory: first the sums of y
// (-> mean), then of (y - mean)^2 (-> variance), the same two passes as
// the TPU kernel.  The fp32 product lives in registers (WMMA accumulators,
// 32 x 48 per warp) and then in shared memory for the LayerNorm; it never
// reaches device memory.  The x LayerNorm statistics are computed once per
// row (8 rows by each block of the cluster, shared the same way), and the
// LN(x) tile is formed as each 64 x 32 slice of x is staged into shared
// memory.  W_j is streamed in 32 x 192 tiles with cp.async, double
// buffered, read through its strides (row- or column-major), so the port's
// (3D, D) weight is passed as its transpose view with no copy.  Each block
// reads its 192 columns of W_j once per 64 rows: W traffic from L2 is a
// quarter of a 16-row tile's.  The TPU kernel keeps W_j resident in VMEM
// across row tiles instead, which a 227 KB block cannot.

#include <cooperative_groups.h>
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace nvcuda;

constexpr int CLUSTER = 8;      // blocks sharing one row tile's D columns
constexpr int BM = 64;          // token rows per block
constexpr int BK = 32;          // depth of one pipeline step
constexpr int WARPS = 8;        // 2 x 4: 32 rows x BN/4 columns each
constexpr int THREADS = WARPS * 32;
constexpr int LDA = BK + 8;     // LN(x) tile pitch (elements)
constexpr int STAT_ROWS = BM / CLUSTER;  // x rows whose statistics a block makes
constexpr float EPS = 1e-5f;

// NF = 16-column fragments per warp column: D = 512 * NF.
template <int NF, bool kWColMajor>
struct Cfg {
  static constexpr int D = 512 * NF;
  static constexpr int BN = 64 * NF;                   // columns per block
  static constexpr int LDB = kWColMajor ? BK + 8 : BN + 8;
  static constexpr int B_TILE = kWColMajor ? BN * LDB : BK * LDB;  // elements
  static constexpr int LDY = BN + 4;
  static constexpr int PIPE_BYTES = 2 * (BM * LDA + B_TILE) * 2;
  static constexpr int Y_BYTES = BM * LDY * 4;
  // the fp32 tile overlays the pipeline buffers once the products are done
  static constexpr int MAIN_BYTES = PIPE_BYTES > Y_BYTES ? PIPE_BYTES : Y_BYTES;
  static constexpr int SMEM = MAIN_BYTES + (BM + STAT_ROWS) * 8 + 2 * BM * 4;
};

template <int NF, bool kWColMajor>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
fused_ln_qkv_kernel(const __nv_bfloat16* __restrict__ x, long long ldx,
                    const float* __restrict__ ln_scale,
                    const __nv_bfloat16* __restrict__ w, long long ldw,
                    const float* __restrict__ q_scale,
                    const float* __restrict__ k_scale,
                    __nv_bfloat16* __restrict__ out, long long ldo, int T) {
  using C = Cfg<NF, kWColMajor>;
  using BLayout = typename std::conditional<kWColMajor, wmma::col_major,
                                            wmma::row_major>::type;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][BM*LDA]
  __nv_bfloat16* sB = sA + 2 * BM * LDA;                       // [2][B_TILE]
  float* sY = reinterpret_cast<float*>(smem);                  // [BM*LDY]
  float2* xstat = reinterpret_cast<float2*>(smem + C::MAIN_BYTES);  // [BM]
  float2* own_stat = xstat + BM;                               // [STAT_ROWS]
  float* psum = reinterpret_cast<float*>(own_stat + STAT_ROWS);  // [BM]
  float* psq = psum + BM;                                        // [BM]

  const int rank = (int)cluster.block_rank();
  const int row0 = blockIdx.y * BM;
  const int j = blockIdx.z;  // 0 = q, 1 = k, 2 = v
  const int col0 = rank * C::BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // 1. LayerNorm statistics of x, one row per warp, shared with the cluster
  {
    constexpr int CH = C::D / 8 / 32;  // 16-byte chunks per lane
    const int row = row0 + rank * STAT_ROWS + warp;
    float2 st = make_float2(0.0f, 0.0f);
    if (row < T) {
      const __nv_bfloat16* src = x + (long long)row * ldx;
      uint4 v[CH];
      float s = 0.0f;
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        v[u] = *reinterpret_cast<const uint4*>(src + (lane + 32 * u) * 8);
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v[u]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(p[e]);
          s += f.x;
          s += f.y;
        }
      }
      const float mean = esmdiff::warp_sum(s) / (float)C::D;
      float q = 0.0f;
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v[u]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(p[e]);
          q += (f.x - mean) * (f.x - mean);
          q += (f.y - mean) * (f.y - mean);
        }
      }
      const float var = esmdiff::warp_sum(q) / (float)C::D;
      st = make_float2(mean, 1.0f / sqrtf(var + EPS));
    }
    if (lane == 0) own_stat[warp] = st;
  }
  cluster.sync();
  if (tid < BM)
    xstat[tid] = *cluster.map_shared_rank(own_stat + tid % STAT_ROWS,
                                          tid / STAT_ROWS);
  cluster.sync();  // no block reads another's own_stat after this

  // 2. y = LN(x) . W_j[:, col0:col0+BN] in fp32, W_j tiles double buffered
  const __nv_bfloat16* wj =
      kWColMajor ? w + (long long)j * C::D * ldw : w + (long long)j * C::D;
  auto load_w = [&](int k0, __nv_bfloat16* dst) {
    for (int i = tid; i < C::BN * BK / 8; i += THREADS) {
      if constexpr (kWColMajor) {
        const int n = i / (BK / 8), c = i % (BK / 8);
        esmdiff::cp_async16(dst + n * C::LDB + c * 8,
                            wj + (long long)(col0 + n) * ldw + k0 + c * 8);
      } else {
        const int k = i / (C::BN / 8), c = i % (C::BN / 8);
        esmdiff::cp_async16(dst + k * C::LDB + c * 8,
                            wj + (long long)(k0 + k) * ldw + col0 + c * 8);
      }
    }
    esmdiff::cp_async_commit();
  };
  // one 8-value chunk of the 64 x 32 x slice per thread
  const int ar = tid / (BK / 8);
  const int ac = (tid % (BK / 8)) * 8;
  const bool a_row = row0 + ar < T;
  const __nv_bfloat16* x_src = x + (long long)(row0 + ar) * ldx + ac;
  auto load_x = [&](int k0) {
    return a_row ? *reinterpret_cast<const uint4*>(x_src + k0)
                 : make_uint4(0u, 0u, 0u, 0u);
  };
  auto store_xn = [&](uint4 v, int k0, __nv_bfloat16* dst) {
    const float2 st = xstat[ar];
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
    uint4 o;
    __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(p[e]);
      const int k = k0 + ac + 2 * e;
      q[e] = a_row ? __floats2bfloat162_rn((f.x - st.x) * st.y * ln_scale[k],
                                           (f.y - st.x) * st.y * ln_scale[k + 1])
                   : __floats2bfloat162_rn(0.0f, 0.0f);
    }
    *reinterpret_cast<uint4*>(dst + ar * LDA + ac) = o;
  };

  const int wr = warp / 4;  // rows wr*32 .. +32
  const int wc = warp % 4;  // columns wc*16*NF .. +16*NF
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NF];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[i][f], 0.0f);

  constexpr int NK = C::D / BK;
  load_w(0, sB);
  store_xn(load_x(0), 0, sA);
  esmdiff::cp_async_wait_all();
  __syncthreads();
  for (int kt = 0; kt < NK; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < NK;
    uint4 xv = make_uint4(0u, 0u, 0u, 0u);
    if (more) {
      load_w((kt + 1) * BK, sB + (cur ^ 1) * C::B_TILE);
      xv = load_x((kt + 1) * BK);
    }
    const __nv_bfloat16* a_s = sA + cur * BM * LDA;
    const __nv_bfloat16* b_s = sB + cur * C::B_TILE;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], a_s + (wr * 32 + 16 * i) * LDA + ks, LDA);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        const int n = wc * 16 * NF + 16 * f;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> b;
        wmma::load_matrix_sync(
            b, kWColMajor ? b_s + n * C::LDB + ks : b_s + ks * C::LDB + n,
            C::LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][f], a[i], b, acc[i][f]);
      }
    }
    if (more) store_xn(xv, (kt + 1) * BK, sA + (cur ^ 1) * BM * LDA);
    esmdiff::cp_async_wait_all();
    __syncthreads();
  }

  // 3. the fp32 tile to shared memory (over the pipeline buffers)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int f = 0; f < NF; ++f)
      wmma::store_matrix_sync(sY + (wr * 32 + 16 * i) * C::LDY + wc * 16 * NF +
                                  16 * f,
                              acc[i][f], C::LDY, wmma::mem_row_major);
  __syncthreads();

  // 4. q, k: LayerNorm over all D columns of each row, statistics summed
  // over the cluster (four threads per row, a quarter of the columns each)
  if (j < 2) {  // the same for every block of a cluster
    const int er = tid / 4;
    const int part = tid % 4;
    float* yrow = sY + er * C::LDY;
    float s = 0.0f;
    for (int c = part; c < C::BN; c += 4) s += yrow[c];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (part == 0) psum[er] = s;
    cluster.sync();
    float total = 0.0f;
#pragma unroll
    for (int b = 0; b < CLUSTER; ++b)
      total += *cluster.map_shared_rank(psum + er, b);
    const float mean = total / (float)C::D;
    float q = 0.0f;
    for (int c = part; c < C::BN; c += 4) {
      const float d = yrow[c] - mean;
      q += d * d;
    }
    q += __shfl_xor_sync(0xffffffffu, q, 1);
    q += __shfl_xor_sync(0xffffffffu, q, 2);
    if (part == 0) psq[er] = q;
    cluster.sync();
    float sq = 0.0f;
#pragma unroll
    for (int b = 0; b < CLUSTER; ++b)
      sq += *cluster.map_shared_rank(psq + er, b);
    const float rstd = 1.0f / sqrtf(sq / (float)C::D + EPS);
    cluster.sync();  // every remote read is done: blocks may finish
    const float* post = (j == 0 ? q_scale : k_scale) + col0;
    for (int c = part; c < C::BN; c += 4)
      yrow[c] = (yrow[c] - mean) * rstd * post[c];
    __syncthreads();
  }

  // 5. bf16 store, two columns per thread and step; rows past T skipped
  for (int e = tid; e < BM * C::BN / 2; e += THREADS) {
    const int r = e / (C::BN / 2);
    const int c = 2 * (e % (C::BN / 2));
    if (row0 + r < T)
      *reinterpret_cast<__nv_bfloat162*>(
          out + (long long)(row0 + r) * ldo + (long long)j * C::D + col0 + c) =
          __floats2bfloat162_rn(sY[r * C::LDY + c], sY[r * C::LDY + c + 1]);
  }
}

template <int NF, bool kWColMajor>
int launch_one(const void* x, long long ldx, const float* ln_scale,
               const void* w, long long ldw, const float* q_scale,
               const float* k_scale, void* out, long long ldo, int T,
               cudaStream_t stream) {
  auto kernel = &fused_ln_qkv_kernel<NF, kWColMajor>;
  const int smem = Cfg<NF, kWColMajor>::SMEM;
  cudaError_t err = esmdiff::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(CLUSTER, (T + BM - 1) / BM, 3);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), ldx, ln_scale,
      static_cast<const __nv_bfloat16*>(w), ldw, q_scale, k_scale,
      static_cast<__nv_bfloat16*>(out), ldo, T);
  return (int)cudaGetLastError();
}

template <int NF>
int launch(bool col_major, const void* x, long long ldx,
           const float* ln_scale, const void* w, long long ldw,
           const float* q_scale, const float* k_scale, void* out,
           long long ldo, int T, cudaStream_t stream) {
  return col_major
             ? launch_one<NF, true>(x, ldx, ln_scale, w, ldw, q_scale,
                                    k_scale, out, ldo, T, stream)
             : launch_one<NF, false>(x, ldx, ln_scale, w, ldw, q_scale,
                                     k_scale, out, ldo, T, stream);
}

}  // namespace

// Plain C interface, loaded with ctypes.  x: (T, D) bf16 with row stride
// ldx (a multiple of 8, 16-byte aligned); w: (D, 3D) bf16 with element
// strides (w_s0, w_s1), one of them 1 and the other a multiple of 16,
// 32-byte aligned; scales fp32 (D,); out: (T, 3D) bf16 with row stride ldo.
// D is 512, 1024 or 1536 (the Python wrapper checks all of it).  Launches
// on `stream`, does not synchronise, and returns cudaGetLastError() after
// the launch.
extern "C" int esmdiff_fused_ln_qkv_fwd(
    const void* x, long long ldx, const float* ln_scale, const void* w,
    long long w_s0, long long w_s1, const float* q_scale,
    const float* k_scale, void* out, long long ldo, int T, int D,
    void* stream) {
  const bool col_major = w_s0 == 1;
  const long long ldw = col_major ? w_s1 : w_s0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 512:
      return launch<1>(col_major, x, ldx, ln_scale, w, ldw, q_scale, k_scale,
                       out, ldo, T, s);
    case 1024:
      return launch<2>(col_major, x, ldx, ln_scale, w, ldw, q_scale, k_scale,
                       out, ldo, T, s);
    case 1536:
      return launch<3>(col_major, x, ldx, ln_scale, w, ldw, q_scale, k_scale,
                       out, ldo, T, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
