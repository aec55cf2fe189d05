// Fused pre-norm SwiGLU FFN for Hopper (sm_90a), bf16 in/out.
//
// Replaces the Pallas TPU kernel esmdiff_tpu/ops/fused_ffn.py::_kernel
// (:34, launched at :91).  Same function, per row x (D values):
//   xn = (x - mean) * rsqrt(var + 1e-5) * ln_scale in fp32 (population
//        variance), rounded to bf16;
//   [a | b] = xn . W_up, W_up (D, 2H), accumulated in fp32;
//   hid = silu(a) * b in fp32, rounded to bf16;
//   y = hid . W_down, W_down (H, D), accumulated in fp32 over all of H,
//       stored bf16.
//
// Bound on an H100: at the trunk's shape (M 4096, D 1536, H 4096) the
// products are 154.6 GFLOP, 0.156 ms at the bf16 tensor-core peak, while x,
// the weights and y are 63 MB, 0.019 ms: the operations bound it.
//
// Design: on the TPU a sequential H grid axis carries the fp32 sum in VMEM
// scratch.  Blocks on Hopper carry nothing between them, so one block owns
// 16 rows and loops over H in 128-wide chunks itself.  LN(x) is computed
// once into shared memory (16 x D bf16, 48 KB at D=1536).  Per chunk each of
// the eight warps computes one 16 x 16 tile of a and of b (WMMA, fp32),
// gates it into a shared 16 x 128 bf16 hid tile, and then every warp adds
// hid . W_down[chunk, its D/128 column tiles] into fp32 accumulators that
// stay in registers for the whole H loop.  The (M, 2H) up-projection and
// the (M, H) hidden never reach device memory, the kernel's point.  Rows
// past M are zeros in shared memory and are not stored: no padded copy.
// Both weights are read through their strides from device memory (L2);
// known cost of this simple form: every block re-reads them (M/16 times in
// all), which larger row tiles over a thread block cluster can cut later.

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 16;                // rows per block
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BH = 16 * WARPS;        // hidden columns per chunk
constexpr int LDHID = BH + 8;         // hid row pitch (elements)
constexpr int MAX_TILES = 12;         // 16-column output tiles per warp: D <= 1536
constexpr int SCRATCH = 2 * 16 * 16;  // fp32 per warp: its a and b tiles
constexpr float EPS = 1e-5f;

// Element (k, n) of a (K, N) matrix with the given leading dimension.
template <bool kColMajor>
__device__ __forceinline__ const __nv_bfloat16* at(const __nv_bfloat16* m,
                                                   long long ld, int k,
                                                   int n) {
  return kColMajor ? m + (long long)n * ld + k : m + (long long)k * ld + n;
}

template <bool kUpCol, bool kDownCol>
__global__ void __launch_bounds__(THREADS)
fused_swiglu_ffn_kernel(const __nv_bfloat16* __restrict__ x, long long ldx,
                        const float* __restrict__ ln_scale,
                        const __nv_bfloat16* __restrict__ w_up, long long ld_up,
                        const __nv_bfloat16* __restrict__ w_down,
                        long long ld_down, __nv_bfloat16* __restrict__ out,
                        long long ldo, int M, int D, int H) {
  using UpLayout = typename std::conditional<kUpCol, wmma::col_major,
                                             wmma::row_major>::type;
  using DownLayout = typename std::conditional<kDownCol, wmma::col_major,
                                               wmma::row_major>::type;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int ldxn = D + 8;
  __nv_bfloat16* xn = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* hid = xn + BM * ldxn;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* scr = reinterpret_cast<float*>(hid + BM * LDHID) + warp * SCRATCH;
  const int row0 = blockIdx.x * BM;

  // 1. xn = LN(x) * ln_scale, rounded to bf16; rows past M are zeros
  for (int r = warp; r < BM; r += WARPS) {
    __nv_bfloat16* dst = xn + r * ldxn;
    const int row = row0 + r;
    if (row >= M) {
      for (int c = lane; c < D; c += 32) dst[c] = __float2bfloat16(0.0f);
      continue;
    }
    const __nv_bfloat16* src = x + (long long)row * ldx;
    float s = 0.0f;
    for (int c = lane; c < D; c += 32) s += __bfloat162float(src[c]);
    const float mean = esmdiff::warp_sum(s) / (float)D;
    float v = 0.0f;
    for (int c = lane; c < D; c += 32) {
      const float d = __bfloat162float(src[c]) - mean;
      v += d * d;
    }
    const float rstd = rsqrtf(esmdiff::warp_sum(v) / (float)D + EPS);
    for (int c = lane; c < D; c += 32)
      dst[c] = __float2bfloat16((__bfloat162float(src[c]) - mean) * rstd *
                                ln_scale[c]);
  }
  __syncthreads();

  const int nt = D / (16 * WARPS);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAX_TILES];
#pragma unroll
  for (int f = 0; f < MAX_TILES; ++f) wmma::fill_fragment(acc[f], 0.0f);

  for (int h0 = 0; h0 < H; h0 += BH) {
    // 2. this warp's 16 hidden columns: a = xn . W_up[:, ha], b at H + ha
    const int ha = h0 + 16 * warp;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_a, acc_b;
    wmma::fill_fragment(acc_a, 0.0f);
    wmma::fill_fragment(acc_b, 0.0f);
#pragma unroll 4
    for (int kk = 0; kk < D; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, xn + kk, ldxn);
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, UpLayout> ba, bb;
      wmma::load_matrix_sync(ba, at<kUpCol>(w_up, ld_up, kk, ha), (unsigned)ld_up);
      wmma::load_matrix_sync(bb, at<kUpCol>(w_up, ld_up, kk, H + ha),
                             (unsigned)ld_up);
      wmma::mma_sync(acc_a, a, ba, acc_a);
      wmma::mma_sync(acc_b, a, bb, acc_b);
    }
    wmma::store_matrix_sync(scr, acc_a, 16, wmma::mem_row_major);
    wmma::store_matrix_sync(scr + 256, acc_b, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const float av = scr[e];
      const float gate = av / (1.0f + expf(-av));  // silu(a), fp32
      hid[(e / 16) * LDHID + 16 * warp + e % 16] =
          __float2bfloat16(gate * scr[256 + e]);
    }
    __syncthreads();  // the whole 16 x BH hid tile is written

    // 3. acc += hid . W_down[h0:h0+BH, this warp's column tiles]
#pragma unroll
    for (int kk = 0; kk < BH; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, hid + kk, LDHID);
#pragma unroll
      for (int f = 0; f < MAX_TILES; ++f) {
        if (f < nt) {
          const int n = (warp * nt + f) * 16;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, DownLayout> bf;
          wmma::load_matrix_sync(bf, at<kDownCol>(w_down, ld_down, h0 + kk, n),
                                 (unsigned)ld_down);
          wmma::mma_sync(acc[f], a, bf, acc[f]);
        }
      }
    }
    __syncthreads();  // hid consumed before the next chunk rewrites it
  }

  // 4. y tiles staged through this warp's scratch, stored bf16
#pragma unroll
  for (int f = 0; f < MAX_TILES; ++f) {
    if (f < nt) {
      const int n = (warp * nt + f) * 16;
      wmma::store_matrix_sync(scr, acc[f], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = row0 + e / 16;
        if (row < M)
          out[(long long)row * ldo + n + e % 16] = __float2bfloat16(scr[e]);
      }
      __syncwarp();
    }
  }
}

template <bool kUpCol, bool kDownCol>
int launch(const void* x, long long ldx, const float* ln_scale,
           const void* w_up, long long ld_up, const void* w_down,
           long long ld_down, void* out, long long ldo, int M, int D, int H,
           cudaStream_t stream) {
  auto kernel = &fused_swiglu_ffn_kernel<kUpCol, kDownCol>;
  const int smem = (BM * (D + 8) + BM * LDHID) * (int)sizeof(__nv_bfloat16) +
                   WARPS * SCRATCH * (int)sizeof(float);
  cudaError_t err = esmdiff::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(M + BM - 1) / BM, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), ldx, ln_scale,
      static_cast<const __nv_bfloat16*>(w_up), ld_up,
      static_cast<const __nv_bfloat16*>(w_down), ld_down,
      static_cast<__nv_bfloat16*>(out), ldo, M, D, H);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  x: (M, D) bf16 with row stride
// ldx; w_up: (D, 2H) and w_down: (H, D) bf16 with element strides
// (s0, s1), one of them 1 and the other a multiple of 16; ln_scale fp32
// (D,); out: (M, D) bf16 with row stride ldo.  D is a multiple of 128 up to
// 1536 and H a multiple of 128 (the Python wrapper checks all of it).
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch.
extern "C" int esmdiff_fused_swiglu_ffn_fwd(
    const void* x, long long ldx, const float* ln_scale, const void* w_up,
    long long up_s0, long long up_s1, const void* w_down, long long down_s0,
    long long down_s1, void* out, long long ldo, int M, int D, int H,
    void* stream) {
  const bool up_col = up_s0 == 1;
  const bool down_col = down_s0 == 1;
  const long long ld_up = up_col ? up_s1 : up_s0;
  const long long ld_down = down_col ? down_s1 : down_s0;
  cudaStream_t s = (cudaStream_t)stream;
  if (up_col && down_col)
    return launch<true, true>(x, ldx, ln_scale, w_up, ld_up, w_down, ld_down,
                              out, ldo, M, D, H, s);
  if (up_col)
    return launch<true, false>(x, ldx, ln_scale, w_up, ld_up, w_down, ld_down,
                               out, ldo, M, D, H, s);
  if (down_col)
    return launch<false, true>(x, ldx, ln_scale, w_up, ld_up, w_down, ld_down,
                               out, ldo, M, D, H, s);
  return launch<false, false>(x, ldx, ln_scale, w_up, ld_up, w_down, ld_down,
                              out, ldo, M, D, H, s);
}
