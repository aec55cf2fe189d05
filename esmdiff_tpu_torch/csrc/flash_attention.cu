// Prefix-length masked softmax attention for Hopper (sm_90a), bf16 in/out.
//
// Replaces the Pallas TPU kernel esmdiff_tpu/ops/flash_attention.py::_attn_kernel
// (launched at :204).  Same function, per (b, h):
//   logits = (q . k^T) in fp32, times 1/sqrt(Dh)
//   keys at positions >= lengths[b] are set to -1e9 (not -inf: a row with
//   lengths[b] == 0 then gets exp(0) = 1 on every key, i.e. the mean of V
//   over all L rows, exactly as the JAX kernel does)
//   m = rowmax, p = exp(logits - m), p cast to bf16 before p . v, which
//   accumulates in fp32; the output is multiplied by 1/sum(p) and stored bf16.
//
// Bound on an H100: at the main path's shapes (L = 64..1024, Dh = 64) the
// kernel moves 4 * B*L*H*Dh bf16 values and does 4 * L * keys * Dh flops per
// (b, h); below L ~ 600 the bytes bound it, above that the tensor cores.
//
// Design (a simple, correct first kernel; wgmma/TMA are later work):
//   - The TPU kernel keeps the whole K/V of one (b, h) resident in VMEM.  On
//     Hopper K+V at L=1024 are 256 KB, more than a block's 227 KB of shared
//     memory, so this kernel streams K/V through shared memory in 64-key
//     tiles instead: one block per (query tile of 64 rows, h, b), four warps,
//     each warp owning 16 query rows.
//   - Two passes over the K tiles.  Pass 1 computes the row max m and the
//     row sum l (online rescaling of l).  Pass 2 recomputes the logits and
//     forms p = exp(logit - m) with the FINAL m, so p is rounded to bf16 at
//     exactly the point the JAX kernel rounds it; p . v accumulates in fp32
//     tensor-core fragments (WMMA 16x16x16 bf16 -> fp32).
//   - Reads and writes the native (B, L, H, Dh) layout through strides: no
//     (B*H, L, Dh) transposes and no row-group padding as on the TPU.
//   - Keys past lengths[b] contribute exp(-1e9 - m) == 0 exactly, so they
//     are skipped when lengths[b] >= 1.  With lengths[b] == 0 all L keys are
//     visited.  Keys past L (the ragged last tile) are -inf: not keys at all.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int DH = 64;          // head dim (every full-width configuration)
constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per K/V tile
constexpr int WARPS = 4;        // 16 query rows per warp
constexpr int THREADS = WARPS * 32;
constexpr int LDH = DH + 8;     // bf16 row pitch in shared memory (elements)
constexpr int LDS = BK + 4;     // fp32 row pitch in shared memory (elements)
constexpr float MASKED = -1e9f;

// Every member offset is a multiple of 32 bytes (WMMA pointer alignment).
struct Smem {
  __nv_bfloat16 q[BQ * LDH];
  __nv_bfloat16 k[BK * LDH];
  __nv_bfloat16 v[BK * LDH];
  __nv_bfloat16 p[BQ * LDH];
  float s[BQ * LDS];
};

struct Strides {
  long long b, l, h;
};

// Copies rows [row0, row0 + 64) of one (b, h) slice into shared memory, 16
// bytes per thread per step; rows at or past `rows` are zero-filled.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int rows) {
  for (int c = threadIdx.x; c < 64 * (DH / 8); c += THREADS) {
    const int r = c / (DH / 8);
    const int ch = c % (DH / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) {
      val = *reinterpret_cast<const uint4*>(
          src + (long long)(row0 + r) * row_stride + ch * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * LDH + ch * 8) = val;
  }
}

// s_w (16 x 64 fp32) = this warp's 16 query rows . the K tile^T.
__device__ __forceinline__ void qk_tile(const Smem& sm, float* s_w, int warp) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
  for (int nn = 0; nn < BK / 16; ++nn) wmma::fill_fragment(acc[nn], 0.0f);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::load_matrix_sync(a, sm.q + 16 * warp * LDH + 16 * kk, LDH);
#pragma unroll
    for (int nn = 0; nn < BK / 16; ++nn) {
      // K^T as a column-major B operand: element (d, key) = k[key][d]
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
      wmma::load_matrix_sync(bf, sm.k + 16 * nn * LDH + 16 * kk, LDH);
      wmma::mma_sync(acc[nn], a, bf, acc[nn]);
    }
  }
#pragma unroll
  for (int nn = 0; nn < BK / 16; ++nn)
    wmma::store_matrix_sync(s_w + 16 * nn, acc[nn], LDS, wmma::mem_row_major);
}

// Scaled and masked logit of key `key` (absolute position).
__device__ __forceinline__ float masked_logit(float dot, int key, int len,
                                              int L, float scale) {
  if (key >= L) return -INFINITY;  // past the sequence: not a key
  return key < len ? dot * scale : MASKED;
}

__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o,
                       const int* __restrict__ lengths, int L,
                       Strides qs, Strides ks, Strides vs, Strides os) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float scale = rsqrtf((float)DH);  // 0.125, exact

  int len = lengths[b];
  len = len < 0 ? 0 : (len > L ? L : len);
  const int n_keys = len >= 1 ? len : L;

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;

  load_tile(sm.q, qb, qs.l, q0, L);

  float* s_w = sm.s + 16 * warp * LDS;
  __nv_bfloat16* p_w = sm.p + 16 * warp * LDH;
  const int r = lane / 2;           // this lane's row within the warp's 16
  const int c0 = (lane % 2) * 32;   // and its half of the tile's 64 columns

  // ---- pass 1: row max m and row sum l ----
  float m = -INFINITY, l = 0.0f;
  for (int kt = 0; kt < n_keys; kt += BK) {
    __syncthreads();  // previous tile fully consumed (and Q loaded)
    load_tile(sm.k, kb, ks.l, kt, L);
    __syncthreads();
    qk_tile(sm, s_w, warp);
    __syncwarp();
    const float* srow = s_w + r * LDS;
    float tmax = -INFINITY;
    for (int j = 0; j < 32; ++j)
      tmax = fmaxf(tmax, masked_logit(srow[c0 + j], kt + c0 + j, len, L, scale));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    float tsum = 0.0f;
    for (int j = 0; j < 32; ++j)
      tsum += expf(masked_logit(srow[c0 + j], kt + c0 + j, len, L, scale) - m_new);
    tsum += __shfl_xor_sync(0xffffffffu, tsum, 1);
    l = l * expf(m - m_new) + tsum;
    m = m_new;
    __syncwarp();
  }

  // ---- pass 2: p = exp(logit - m) in bf16, o = p . v in fp32 ----
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_o[DH / 16];
#pragma unroll
  for (int nn = 0; nn < DH / 16; ++nn) wmma::fill_fragment(acc_o[nn], 0.0f);
  for (int kt = 0; kt < n_keys; kt += BK) {
    __syncthreads();
    load_tile(sm.k, kb, ks.l, kt, L);
    load_tile(sm.v, vb, vs.l, kt, L);
    __syncthreads();
    qk_tile(sm, s_w, warp);
    __syncwarp();
    const float* srow = s_w + r * LDS;
    for (int j = 0; j < 32; ++j) {
      const float x = masked_logit(srow[c0 + j], kt + c0 + j, len, L, scale);
      p_w[r * LDH + c0 + j] = __float2bfloat16(expf(x - m));
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, p_w + 16 * kk, LDH);
#pragma unroll
      for (int nn = 0; nn < DH / 16; ++nn) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, sm.v + 16 * kk * LDH + 16 * nn, LDH);
        wmma::mma_sync(acc_o[nn], a, bf, acc_o[nn]);
      }
    }
    __syncwarp();
  }

  // ---- epilogue: o = acc * (1 / l), stored bf16 ----
#pragma unroll
  for (int nn = 0; nn < DH / 16; ++nn)
    wmma::store_matrix_sync(s_w + 16 * nn, acc_o[nn], LDS, wmma::mem_row_major);
  __syncwarp();
  const int row = q0 + 16 * warp + r;
  if (row < L) {
    const float inv = 1.0f / l;
    const float* arow = s_w + r * LDS + c0;
    __nv_bfloat16* orow = o + b * os.b + h * os.h + (long long)row * os.l + c0;
#pragma unroll
    for (int c = 0; c < 32; c += 8) {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        __nv_bfloat162 pr = __floats2bfloat162_rn(arow[c + 2 * e] * inv,
                                                  arow[c + 2 * e + 1] * inv);
        w[e] = *reinterpret_cast<uint32_t*>(&pr);
      }
      *reinterpret_cast<uint4*>(orow + c) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  Pointers are device pointers; the
// strides are in elements (the last dim must be contiguous, the rest
// multiples of 8 elements, and every base 16-byte aligned — the Python
// wrapper checks all of it).  Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() after the launch.
extern "C" int esmdiff_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const int* lengths,
    int B, int L, int H,
    long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh,
    long long o_sb, long long o_sl, long long o_sh,
    void* stream) {
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + BQ - 1) / BQ, H, B);
  flash_attention_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lengths, L, Strides{q_sb, q_sl, q_sh}, Strides{k_sb, k_sl, k_sh},
      Strides{v_sb, v_sl, v_sh}, Strides{o_sb, o_sl, o_sh});
  return (int)cudaGetLastError();
}

extern "C" const char* esmdiff_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
