// Prefix-length masked softmax attention over 64-query x 64-key tiles, for
// Hopper (sm_90a), bf16 in/out: the body shared by flash_attention.cu and
// small_attention.cu (which rotates q and k as it loads them).
//
// Function, per (b, h):
//   logits = (q . k^T) in fp32, times 1/sqrt(Dh)
//   keys at positions >= lengths[b] are set to -1e9 (not -inf: a row with
//   lengths[b] == 0 then gets exp(0) = 1 on every key, i.e. the mean of V
//   over all L rows, exactly as the JAX kernels do)
//   m = rowmax, p = exp(logits - m), p cast to bf16 before p . v, which
//   accumulates in fp32; the output is multiplied by 1/sum(p) and stored bf16.
//
// Design (a simple, correct kernel; wgmma/TMA are later work):
//   - One block per (query tile of 64 rows, h, b), four warps, each warp
//     owning 16 query rows.  K/V stream through shared memory in 64-key
//     tiles, so any L runs (a whole (b, h) K/V at L=1024 is 256 KB, more
//     than a block's 227 KB).
//   - Two passes over the K tiles.  Pass 1 computes the row max m and the
//     row sum l (online rescaling of l).  Pass 2 recomputes the logits and
//     forms p = exp(logit - m) with the FINAL m, so p is rounded to bf16 at
//     exactly the point the JAX kernels round it; p . v accumulates in fp32
//     tensor-core fragments (WMMA 16x16x16 bf16 -> fp32).
//   - Reads and writes the native (B, L, H, Dh) layout through strides: no
//     (B*H, L, Dh) transposes.
//   - Keys past lengths[b] contribute exp(-1e9 - m) == 0 exactly, so they
//     are skipped when lengths[b] >= 1.  With lengths[b] == 0 all L keys are
//     visited.  Keys past L (the ragged last tile) are -inf: not keys at all.
//   - kRotary: q and k arrive before rotary.  Each row is rotated (GPT-NeoX
//     half rotation, out = x cos + [-x2, x1] sin in fp32, no FMA
//     contraction, as the plain version rounds) while it is copied into
//     shared memory, and rounded to bf16 before q . k^T.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace esmdiff_attn {

using namespace nvcuda;

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

// Rotary tables, (L, DH) fp32 row-major; null when the kernel does not rotate.
struct Rotary {
  const float* cos;
  const float* sin;
};

// Eight values x[d..d+8) rotated: x cos + sign * partner sin, where partner
// holds x[d +- DH/2] and sign is -1 for the first half of the head.
__device__ __forceinline__ uint4 rotate_chunk(uint4 x, uint4 partner,
                                              float sign, const float* c,
                                              const float* s) {
  const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* pp = reinterpret_cast<const __nv_bfloat162*>(&partner);
  uint4 out;
  __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 xv = __bfloat1622float2(xp[e]);
    const float2 pv = __bfloat1622float2(pp[e]);
    const float lo = __fadd_rn(__fmul_rn(xv.x, c[2 * e]),
                               __fmul_rn(sign * pv.x, s[2 * e]));
    const float hi = __fadd_rn(__fmul_rn(xv.y, c[2 * e + 1]),
                               __fmul_rn(sign * pv.y, s[2 * e + 1]));
    op[e] = __floats2bfloat162_rn(lo, hi);
  }
  return out;
}

// Copies rows [row0, row0 + 64) of one (b, h) slice into shared memory, 16
// bytes per thread per step; rows at or past `rows` are zero-filled.  With
// kRotary each row is rotated by its position's cos/sin row on the way.
template <bool kRotary>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int rows, Rotary rot) {
  for (int c = threadIdx.x; c < 64 * (DH / 8); c += THREADS) {
    const int r = c / (DH / 8);
    const int ch = c % (DH / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) {
      const __nv_bfloat16* row = src + (long long)(row0 + r) * row_stride;
      val = *reinterpret_cast<const uint4*>(row + ch * 8);
      if constexpr (kRotary) {
        const int partner = (ch + DH / 16) % (DH / 8);  // the other half
        const long long t = (long long)(row0 + r) * DH + ch * 8;
        val = rotate_chunk(
            val, *reinterpret_cast<const uint4*>(row + partner * 8),
            ch < DH / 16 ? -1.0f : 1.0f, rot.cos + t, rot.sin + t);
      }
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

template <bool kRotary>
__global__ void __launch_bounds__(THREADS)
attention_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o,
                 const int* __restrict__ lengths, int L,
                 Strides qs, Strides ks, Strides vs, Strides os, Rotary rot) {
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

  load_tile<kRotary>(sm.q, qb, qs.l, q0, L, rot);

  float* s_w = sm.s + 16 * warp * LDS;
  __nv_bfloat16* p_w = sm.p + 16 * warp * LDH;
  const int r = lane / 2;           // this lane's row within the warp's 16
  const int c0 = (lane % 2) * 32;   // and its half of the tile's 64 columns

  // ---- pass 1: row max m and row sum l ----
  float m = -INFINITY, l = 0.0f;
  for (int kt = 0; kt < n_keys; kt += BK) {
    __syncthreads();  // previous tile fully consumed (and Q loaded)
    load_tile<kRotary>(sm.k, kb, ks.l, kt, L, rot);
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
    load_tile<kRotary>(sm.k, kb, ks.l, kt, L, rot);
    load_tile<false>(sm.v, vb, vs.l, kt, L, rot);
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

// Launches attention_kernel<kRotary> on `stream`; returns cudaGetLastError().
// Strides are in elements (the last dim must be contiguous, the rest
// multiples of 8 elements, and every base 16-byte aligned — the Python
// wrappers check all of it).
template <bool kRotary>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* lengths, int B, int L, int H, Strides qs, Strides ks,
           Strides vs, Strides os, Rotary rot, void* stream) {
  const int smem = (int)sizeof(Smem);
  cudaError_t err = esmdiff::allow_smem(attention_kernel<kRotary>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + BQ - 1) / BQ, H, B);
  attention_kernel<kRotary><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lengths, L, qs, ks, vs, os, rot);
  return (int)cudaGetLastError();
}

}  // namespace esmdiff_attn
