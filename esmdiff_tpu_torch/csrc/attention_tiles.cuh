// Prefix-length masked softmax attention for Hopper (sm_90a), bf16 in/out,
// Dh = 64: the core shared by flash_attention.cu and small_attention.cu
// (kRotary: q and k arrive before rotary and are rotated here).
//
// Function, per (b, h):
//   kRotary: q and k rotated in fp32 (GPT-NeoX half rotation,
//   out = x cos + [-x2, x1] sin with __fmul_rn/__fadd_rn, no FMA
//   contraction, as the plain version rounds), then rounded to bf16;
//   logits = (q . k^T) in fp32, times 1/sqrt(Dh);
//   keys at positions >= lengths[b] are set to -1e9 (not -inf: a row with
//   lengths[b] == 0 then gets exp(0) = 1 on every key, i.e. the mean of V
//   over all L rows, exactly as the JAX kernels do); keys past L are none;
//   m = the row's FINAL max, p = exp(logits - m), p cast to bf16 before
//   p . v, which accumulates in fp32; the output times 1/sum(p) (the sum of
//   the fp32 p), stored bf16.  An online softmax, which casts p against a
//   running max, would round differently, so p is only ever formed against
//   the final max.
//
// Bound on an H100: at every main-path shape (L = 64; B 64, H 24 in the
// trunk, B 32, H 20 in the decoder) one (b, h) is 1 MFLOP on 32 KB of q, k,
// v and o, about 32 FLOP a byte against the ~295 at which the card stops
// being bound by memory: the bytes bound it (0.0115 ms at the trunk's
// shape), and the tensor cores are not the limit.  So the design moves
// each byte once and keeps the loads in flight:
//   - Tensor cores through mma.sync.m16n8k16 (bf16 -> fp32) fed by
//     ldmatrix (ldmatrix.trans for V).  Each of the block's 4 warps owns 16
//     query rows; its 16 x 64 scores live in registers (32 fp32 a lane), the
//     row max and sum come from quad shuffles, and the score fragment is
//     packed to bf16 in place as the A operand of p . v.  Scores and p never
//     touch shared memory.  (wgmma would buy tensor-core rate this kernel
//     does not lack.)
//   - A block takes one 64-query tile of one batch row for G heads
//     (ops/flash_attention.py pick_group: the most blocks that still fit in
//     one wave).  At L <= 64 the next head's q, k and v are in flight
//     (cp.async, two stages) while one is computed, with one block barrier
//     a head.  The native (B, L, H, Dh) strides are read in place, the
//     fused path's qkv.split views included: no layout copies.
//   - kRotary: the cos and sin rows (fp32) are staged in shared memory once
//     per block and serve q and k of all G heads.  q and k land unrotated;
//     each thread copies one 16-byte chunk of a row together with its
//     partner 32 dims on, and the table entries of both, so after its own
//     cp.async wait it rotates them in registers and writes them back in
//     place with no barrier (a thread rotates head g + 1 while other warps
//     still compute head g).  The rotated q and k never exist in device
//     memory.
//   - L <= 64 is one pass: one K/V tile, m and l final after it.
//   - 64 < L <= MAX_L keeps the (b, h)'s whole K in shared memory (144 KB
//     at L 1024), read and rotated once; sweep 1 over it gives the row max,
//     sweep 2 recomputes the scores, forms p against that max and sums it,
//     with V streamed in 64-key tiles through two stages.  G is 1 there,
//     and the table is staged one 64-row tile at a time.
//   - L > MAX_L: K no longer fits in shared memory, so both sweeps stream
//     it (sweep 2 with V) in 64-key tiles through two stages, each tile
//     with its table rows: K is read and rotated twice, the price of
//     forming p against the final max without a resident K.
//   - Keys at or past lengths[b] >= 1 are neither loaded nor visited past
//     their 64-key tile (zero-filled in it); lengths[b] == 0 visits all L.
//   - The output, scaled by 1/l, is staged in the warp's own q rows and
//     stored with 16-byte stores.
//   - exp is exp2f on logits pre-scaled by log2(e): a few fp32 ulps from
//     expf, far below the bf16 rounding of p.
#pragma once

#include "common.cuh"

namespace esmdiff_attn {

using bf16 = __nv_bfloat16;
using esmdiff::cp_async16_zfill;
using esmdiff::cp_async_commit;
using esmdiff::cp_async_wait;

constexpr int DH = 64;            // head dim (every full-width configuration)
constexpr int TILE = 64;          // query rows a block; keys a K/V tile
constexpr int WARPS = 4;          // 16 query rows a warp
constexpr int THREADS = WARPS * 32;
constexpr int MAX_L = 1024;       // the longest L whose K stays resident
constexpr int LDH = DH + 8;       // bf16 row pitch (144 B: ldmatrix's eight
                                  // 16-byte rows fall in distinct banks)
constexpr int LDT = DH + 4;       // fp32 rotary-table row pitch (272 B)
constexpr int TILE_ELEMS = TILE * LDH;          // one 64-row bf16 tile
constexpr int TABLE_FLOATS = 2 * TILE * LDT;    // cos, then sin, 64 rows
// logits in log2 units: dot / sqrt(64) * log2(e), so p = exp2(s - m)
constexpr float SCALE_LOG2 = 0.125f * 1.4426950408889634f;
// a masked key (any value far below every logit gives p = 0 beside a real
// key and p = 1 when every key is masked, as -1e9 does in the plain version)
constexpr float MASKED = -1e9f;

struct Strides {
  long long b, l, h;
};

// Rotary tables, (L, DH) fp32 row-major; null when the kernel does not rotate.
struct Rotary {
  const float* cos;
  const float* sin;
};

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  const int* lengths;
  int L, H, G;  // G: heads a block
  Strides qs, ks, vs, os;
  Rotary rot;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d (16 x 8 fp32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A thread's share of a 64-row tile, the same for every tile it loads:
// rows own_row(0) and own_row(1), and in each the 16-byte chunks
// own_pair() and own_pair() + 4, i.e. dims [8p, 8p + 8) and their rotary
// partners 32 dims on.  A warp's eight lanes of one pair take eight
// consecutive rows, so every shared-memory access below is free of bank
// conflicts, and the warp's 32 lanes read 64 contiguous bytes of each of
// 8 rows per copy.  Because a thread copies exactly the chunks it later
// rotates (and the table entries it rotates them by), its own
// cp.async.wait_group makes them visible to it: rotation needs no barrier.
__device__ __forceinline__ int own_row(int j) {
  return 8 * (threadIdx.x / 32) + threadIdx.x % 8 + 32 * j;
}
__device__ __forceinline__ int own_pair() { return threadIdx.x % 32 / 8; }

// Starts copying this thread's share of rows [row0, row0 + 64) of one
// (b, h) slice into a tile; rows at or past `valid` are zero-filled, not
// read.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int row0,
                                          int valid) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = own_row(j);
    const bool ok = row0 + r < valid;
    const bf16* row = ok ? src + (long long)(row0 + r) * row_stride : src;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ch = own_pair() + 4 * half;
      cp_async16_zfill(dst + r * LDH + ch * 8, row + (ok ? ch * 8 : 0), ok);
    }
  }
}

// Starts copying the cos and sin entries this thread rotates by, of table
// rows [row0, row0 + 64) (zero past L), into the table buffer: cos rows,
// then sin rows, pitch LDT.
__device__ __forceinline__ void load_table(float* dst, Rotary rot, int row0,
                                           int L) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = own_row(j);
    const bool ok = row0 + r < L;
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const float* src = which ? rot.sin : rot.cos;
      const float* row = ok ? src + (long long)(row0 + r) * DH : src;
#pragma unroll
      for (int part = 0; part < 4; ++part) {  // dims 8p.., 32 + 8p.., 4 each
        const int d = 8 * own_pair() + DH / 2 * (part / 2) + 4 * (part % 2);
        cp_async16_zfill(dst + which * TILE * LDT + r * LDT + d,
                         row + (ok ? d : 0), ok);
      }
    }
  }
}

// Rotates 8 dims of a row and their partners 32 dims on, in place:
// lo' = lo cos - hi sin, hi' = hi cos + lo sin (each half by its own table
// columns), in fp32 with no FMA contraction, rounded to bf16.
__device__ __forceinline__ void rotate_chunk(bf16* x, const float (&c_lo)[8],
                                             const float (&s_lo)[8],
                                             const float (&c_hi)[8],
                                             const float (&s_hi)[8]) {
  uint4* lo_p = reinterpret_cast<uint4*>(x);
  uint4* hi_p = reinterpret_cast<uint4*>(x + DH / 2);
  const uint4 lo = *lo_p, hi = *hi_p;
  const __nv_bfloat162* lp = reinterpret_cast<const __nv_bfloat162*>(&lo);
  const __nv_bfloat162* hp = reinterpret_cast<const __nv_bfloat162*>(&hi);
  uint4 lo_out, hi_out;
  uint32_t* lo_w = reinterpret_cast<uint32_t*>(&lo_out);
  uint32_t* hi_w = reinterpret_cast<uint32_t*>(&hi_out);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 a = __bfloat1622float2(lp[e]);   // x[8p + 2e], +1
    const float2 b = __bfloat1622float2(hp[e]);   // x[32 + 8p + 2e], +1
    const int i = 2 * e, j = 2 * e + 1;
    lo_w[e] = pack_bf16(
        __fadd_rn(__fmul_rn(a.x, c_lo[i]), __fmul_rn(-b.x, s_lo[i])),
        __fadd_rn(__fmul_rn(a.y, c_lo[j]), __fmul_rn(-b.y, s_lo[j])));
    hi_w[e] = pack_bf16(
        __fadd_rn(__fmul_rn(b.x, c_hi[i]), __fmul_rn(a.x, s_hi[i])),
        __fadd_rn(__fmul_rn(b.y, c_hi[j]), __fmul_rn(a.y, s_hi[j])));
  }
  *lo_p = lo_out;
  *hi_p = hi_out;
}

// Rotates this thread's share of tile `a` and, if not null, of tile `b`
// (rows of the same positions) by its entries of the table buffer, which
// are read once for both.  Zero-filled rows stay zero.
__device__ __forceinline__ void rotate_own(bf16* a, bf16* b, const float* tab) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = own_row(j);
    const float* cr = tab + r * LDT + 8 * own_pair();
    const float* sr = cr + TILE * LDT;
    float t[4][8];  // cos lo, sin lo, cos hi, sin hi
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float* base = (k % 2 ? sr : cr) + DH / 2 * (k / 2);
      const float4 u = *reinterpret_cast<const float4*>(base);
      const float4 w = *reinterpret_cast<const float4*>(base + 4);
      t[k][0] = u.x, t[k][1] = u.y, t[k][2] = u.z, t[k][3] = u.w;
      t[k][4] = w.x, t[k][5] = w.y, t[k][6] = w.z, t[k][7] = w.w;
    }
    const int at = r * LDH + 8 * own_pair();
    rotate_chunk(a + at, t[0], t[1], t[2], t[3]);
    if (b != nullptr) rotate_chunk(b + at, t[0], t[1], t[2], t[3]);
  }
}

// A fragments of this warp's 16 query rows (all 64 dims, 4 k-steps).
__device__ __forceinline__ void load_q(uint32_t (&qf)[4][4], const bf16* q_w) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldsm_x4(qf[kk], q_w + (lane % 16) * LDH + kk * 16 + (lane / 16) * 8);
}

// s = this warp's q rows . the K tile^T (16 x 64 fp32, mma C layout: lane
// holds rows lane/4 and lane/4 + 8, columns 8n + 2(lane%4) + {0, 1}),
// scaled to log2 units and masked; `key0` is the tile's first key.
__device__ __forceinline__ void scores(float (&s)[8][4],
                                       const uint32_t (&qf)[4][4],
                                       const bf16* kt, int key0, int len,
                                       int L) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int n = 0; n < 8; ++n)
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
  for (int np = 0; np < 4; ++np) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t b[4];  // keys 16np.. (b0, b1), keys 16np + 8.. (b0, b1)
      ldsm_x4(b, kt + (np * 16 + (lane / 16) * 8 + lane % 8) * LDH + kk * 16 +
                     (lane / 8 % 2) * 8);
      mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
      mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = key0 + 8 * n + 2 * (lane % 4) + (j & 1);
      s[n][j] = key >= L ? -INFINITY
                         : (key < len ? s[n][j] * SCALE_LOG2 : MASKED);
    }
  }
}

// m[r] = max(m[r], this lane's part of row r of s); rows lane/4, lane/4 + 8.
__device__ __forceinline__ void max_into(float (&m)[2], const float (&s)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    m[0] = fmaxf(m[0], fmaxf(s[n][0], s[n][1]));
    m[1] = fmaxf(m[1], fmaxf(s[n][2], s[n][3]));
  }
}

// The sum (or max) over the quad of lanes that hold one row.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// p = 2^(s - m) in place (fp32), l += this lane's part of the row sums.
__device__ __forceinline__ void exp_into(float (&s)[8][4], const float (&m)[2],
                                         float (&l)[2]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[n][j] = exp2f(s[n][j] - m[j / 2]);
      l[j / 2] += s[n][j];
    }
  }
}

// o (16 x 64 fp32) += bf16(p) . the V tile: p's C fragments packed in
// place as A fragments (keys 16kk.. of the tile are n-tiles 2kk, 2kk + 1).
__device__ __forceinline__ void pv(float (&o)[8][4], const float (&p)[8][4],
                                   const bf16* vt) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];  // dims 16np.. (b0, b1), dims 16np + 8.. (b0, b1)
      ldsm_x4_trans(b, vt + (kk * 16 + (lane / 8 % 2) * 8 + lane % 8) * LDH +
                           np * 16 + (lane / 16) * 8);
      mma_bf16(o[2 * np], a, b[0], b[1]);
      mma_bf16(o[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// o times 1/l, rounded to bf16, staged in the warp's 16 rows `stage_w` (its
// own q rows, which it has read), then stored 16 bytes a lane to rows
// [row0, row0 + 16) of `out` below L.
__device__ __forceinline__ void store_o(const float (&o)[8][4], const float (&l)[2],
                                       bf16* stage_w, bf16* out,
                                       long long row_stride, int row0, int L) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const float inv0 = 1.0f / l[0], inv1 = 1.0f / l[1];
  __syncwarp();
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    *reinterpret_cast<uint32_t*>(stage_w + g * LDH + 8 * n + 2 * t) =
        pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(stage_w + (g + 8) * LDH + 8 * n + 2 * t) =
        pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
  __syncwarp();
#pragma unroll
  for (int it = lane; it < 16 * (DH / 8); it += 32) {
    const int r = it / (DH / 8), ch = it % (DH / 8);
    if (row0 + r < L)
      *reinterpret_cast<uint4*>(out + (long long)(row0 + r) * row_stride + ch * 8) =
          *reinterpret_cast<const uint4*>(stage_w + r * LDH + ch * 8);
  }
}

__device__ __forceinline__ int keys_of(const Params& p, int b, int* len) {
  int n = p.lengths[b];
  n = n < 0 ? 0 : (n > p.L ? p.L : n);
  *len = n;
  return n >= 1 ? n : p.L;  // lengths[b] == 0 visits every key
}

// L <= 64: one pass.  Shared memory: two stages of (q, k, v) tiles, then
// (kRotary) the cos/sin rows [0, L).
template <bool kRotary>
__global__ void __launch_bounds__(THREADS, kRotary ? 2 : 4)
attention_short(Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* stages = reinterpret_cast<bf16*>(smem_raw);
  float* tab = reinterpret_cast<float*>(smem_raw + 6 * TILE_ELEMS * sizeof(bf16));
  const int b = blockIdx.z;
  const int h0 = blockIdx.y * p.G;
  const int nh = min(p.G, p.H - h0);
  const int warp = threadIdx.x / 32;
  const int L = p.L;
  int len;
  const int n_keys = keys_of(p, b, &len);

  auto issue = [&](int i) {
    const int h = h0 + i;
    bf16* st = stages + (i % 2) * 3 * TILE_ELEMS;
    load_tile(st, p.q + b * p.qs.b + h * p.qs.h, p.qs.l, 0, L);
    load_tile(st + TILE_ELEMS, p.k + b * p.ks.b + h * p.ks.h, p.ks.l, 0, n_keys);
    load_tile(st + 2 * TILE_ELEMS, p.v + b * p.vs.b + h * p.vs.h, p.vs.l, 0,
              n_keys);
    cp_async_commit();
  };
  if constexpr (kRotary) load_table(tab, p.rot, 0, L);  // joins head 0's group
  issue(0);
  cp_async_wait<0>();
  if constexpr (kRotary) rotate_own(stages, stages + TILE_ELEMS, tab);
  for (int i = 0; i < nh; ++i) {
    // head i's q, k (rotated) and v are visible to every warp, and the
    // other stage (head i - 1's) is free: refill it with head i + 1
    __syncthreads();
    if (i + 1 < nh) issue(i + 1);
    bf16* sq = stages + (i % 2) * 3 * TILE_ELEMS;
    uint32_t qf[4][4];
    load_q(qf, sq + 16 * warp * LDH);
    float s[8][4];
    scores(s, qf, sq + TILE_ELEMS, 0, len, L);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    max_into(m, s);
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);
    exp_into(s, m, l);
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    float o[8][4] = {};
    pv(o, s, sq + 2 * TILE_ELEMS);
    const int h = h0 + i;
    store_o(o, l, sq + 16 * warp * LDH, p.o + b * p.os.b + h * p.os.h, p.os.l,
            16 * warp, L);
    if (i + 1 < nh) {
      // this thread's own chunks of head i + 1 have landed: rotate them
      // while other warps may still be on head i
      cp_async_wait<0>();
      if constexpr (kRotary) {
        bf16* nq = stages + ((i + 1) % 2) * 3 * TILE_ELEMS;
        rotate_own(nq, nq + TILE_ELEMS, tab);
      }
    }
  }
}

// 64 < L <= MAX_L: resident K, two sweeps.  Shared memory: the q tile, two
// V stages, (kRotary) one 64-row table tile, then K's ceil(L/64) tiles.
template <bool kRotary>
__global__ void __launch_bounds__(THREADS)
attention_long(Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sv = sq + TILE_ELEMS;  // two stages
  float* tab = reinterpret_cast<float*>(sv + 2 * TILE_ELEMS);
  bf16* sk = reinterpret_cast<bf16*>(tab + (kRotary ? TABLE_FLOATS : 0));
  const int qt = blockIdx.x, q0 = qt * TILE;
  const int b = blockIdx.z;
  const int h0 = blockIdx.y * p.G;
  const int nh = min(p.G, p.H - h0);
  const int warp = threadIdx.x / 32;
  const int L = p.L;
  int len;
  const int n_keys = keys_of(p, b, &len);
  const int nkt = (n_keys + TILE - 1) / TILE;

  for (int i = 0; i < nh; ++i) {
    const int h = h0 + i;
    const bf16* vb = p.v + b * p.vs.b + h * p.vs.h;
    load_tile(sq, p.q + b * p.qs.b + h * p.qs.h, p.qs.l, q0, L);
    for (int t = 0; t < nkt; ++t)
      load_tile(sk + t * TILE_ELEMS, p.k + b * p.ks.b + h * p.ks.h, p.ks.l,
                t * TILE, n_keys);
    load_tile(sv, vb, p.vs.l, 0, n_keys);
    cp_async_commit();
    if constexpr (kRotary) {
      // each table tile once: K's, then q's if no K tile covers it; a
      // thread rotates only what it copied, so no barrier until the end
      for (int j = 0; j < (qt < nkt ? nkt : nkt + 1); ++j) {
        const int t = j < nkt ? j : qt;
        load_table(tab, p.rot, t * TILE, L);
        cp_async_commit();
        cp_async_wait<0>();
        rotate_own(t == qt ? sq : sk + t * TILE_ELEMS,
                   t == qt && j < nkt ? sk + t * TILE_ELEMS : nullptr, tab);
      }
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    uint32_t qf[4][4];
    load_q(qf, sq + 16 * warp * LDH);
    float s[8][4];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    // sweep 1: the row max over every key tile
    for (int t = 0; t < nkt; ++t) {
      scores(s, qf, sk + t * TILE_ELEMS, t * TILE, len, L);
      max_into(m, s);
    }
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);
    // sweep 2: p against the final max, V streamed through two stages
    float o[8][4] = {};
    for (int t = 0; t < nkt; ++t) {
      if (t + 1 < nkt) {
        load_tile(sv + (t + 1) % 2 * TILE_ELEMS, vb, p.vs.l, (t + 1) * TILE,
                  n_keys);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      scores(s, qf, sk + t * TILE_ELEMS, t * TILE, len, L);
      exp_into(s, m, l);
      pv(o, s, sv + t % 2 * TILE_ELEMS);
      __syncthreads();  // this V stage is refilled two tiles on
    }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    store_o(o, l, sq + 16 * warp * LDH, p.o + b * p.os.b + h * p.os.h, p.os.l,
            q0 + 16 * warp, L);
    __syncthreads();  // q, K and V buffers are refilled for the next head
  }
}

// L > MAX_L: K streamed in both sweeps.  Shared memory: the q tile, two K
// stages, two V stages, then (kRotary) two table stages; q's table rows go
// to stage 1 before the K stream starts in stage 0.
template <bool kRotary>
__global__ void __launch_bounds__(THREADS)
attention_stream(Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sk = sq + TILE_ELEMS;      // two stages
  bf16* sv = sk + 2 * TILE_ELEMS;  // two stages
  float* tab = reinterpret_cast<float*>(sv + 2 * TILE_ELEMS);  // two stages
  const int q0 = blockIdx.x * TILE;
  const int b = blockIdx.z;
  const int h0 = blockIdx.y * p.G;
  const int nh = min(p.G, p.H - h0);
  const int warp = threadIdx.x / 32;
  const int L = p.L;
  int len;
  const int n_keys = keys_of(p, b, &len);
  const int nkt = (n_keys + TILE - 1) / TILE;

  for (int i = 0; i < nh; ++i) {
    const int h = h0 + i;
    const bf16* kb = p.k + b * p.ks.b + h * p.ks.h;
    const bf16* vb = p.v + b * p.vs.b + h * p.vs.h;
    // K tile t (with V in sweep 2) and its table rows into stage t % 2
    auto issue = [&](int t, bool with_v) {
      load_tile(sk + t % 2 * TILE_ELEMS, kb, p.ks.l, t * TILE, n_keys);
      if (with_v)
        load_tile(sv + t % 2 * TILE_ELEMS, vb, p.vs.l, t * TILE, n_keys);
      if constexpr (kRotary)
        load_table(tab + t % 2 * TABLE_FLOATS, p.rot, t * TILE, L);
      cp_async_commit();
    };
    // tile t has landed and is rotated, visible to every warp
    auto ready = [&](int t, bool with_v) {
      if (t + 1 < nkt) {
        issue(t + 1, with_v);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      if constexpr (kRotary)
        rotate_own(sk + t % 2 * TILE_ELEMS, nullptr,
                   tab + t % 2 * TABLE_FLOATS);
      __syncthreads();
    };
    load_tile(sq, p.q + b * p.qs.b + h * p.qs.h, p.qs.l, q0, L);
    if constexpr (kRotary) load_table(tab + TABLE_FLOATS, p.rot, q0, L);
    cp_async_commit();
    issue(0, false);
    cp_async_wait<1>();
    // a thread rotates what it copied: stage 1's table is refilled by this
    // same thread only after its reads here
    if constexpr (kRotary) rotate_own(sq, nullptr, tab + TABLE_FLOATS);
    uint32_t qf[4][4];
    float s[8][4];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    // sweep 1: the row max
    for (int t = 0; t < nkt; ++t) {
      ready(t, false);
      if (t == 0) load_q(qf, sq + 16 * warp * LDH);
      scores(s, qf, sk + t % 2 * TILE_ELEMS, t * TILE, len, L);
      max_into(m, s);
      __syncthreads();  // this stage is refilled two tiles on
    }
    m[0] = quad_max(m[0]);
    m[1] = quad_max(m[1]);
    // sweep 2: p against the final max
    float o[8][4] = {};
    issue(0, true);
    for (int t = 0; t < nkt; ++t) {
      ready(t, true);
      scores(s, qf, sk + t % 2 * TILE_ELEMS, t * TILE, len, L);
      exp_into(s, m, l);
      pv(o, s, sv + t % 2 * TILE_ELEMS);
      __syncthreads();
    }
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    store_o(o, l, sq + 16 * warp * LDH, p.o + b * p.os.b + h * p.os.h, p.os.l,
            q0 + 16 * warp, L);
    __syncthreads();  // q is refilled for the next head
  }
}

template <bool kRotary>
constexpr int short_smem() {
  return 6 * TILE_ELEMS * (int)sizeof(bf16) +
         (kRotary ? TABLE_FLOATS * (int)sizeof(float) : 0);
}

template <bool kRotary>
int long_smem(int L) {
  return (3 + (L + TILE - 1) / TILE) * TILE_ELEMS * (int)sizeof(bf16) +
         (kRotary ? TABLE_FLOATS * (int)sizeof(float) : 0);
}

template <bool kRotary>
constexpr int stream_smem() {
  return 5 * TILE_ELEMS * (int)sizeof(bf16) +
         (kRotary ? 2 * TABLE_FLOATS * (int)sizeof(float) : 0);
}

template <typename Kernel>
int launch_with(Kernel kernel, int smem, dim3 grid, cudaStream_t st,
                const Params& p) {
  cudaError_t err = esmdiff::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}

// Launches the kernel for p.L on `stream` over the grid (query tiles, head
// groups of p.G, B); returns cudaGetLastError().  Strides are in elements
// (the last dim must be contiguous, the rest multiples of 8 elements, and
// every base 16-byte aligned — the Python wrappers check all of it).
template <bool kRotary>
int launch(Params p, int B, void* stream) {
  if (p.L < 1 || p.G < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((p.L + TILE - 1) / TILE, (p.H + p.G - 1) / p.G, B);
  const cudaStream_t st = (cudaStream_t)stream;
  if (p.L <= TILE)
    return launch_with(attention_short<kRotary>, short_smem<kRotary>(), grid,
                       st, p);
  if (p.L <= MAX_L)
    return launch_with(attention_long<kRotary>, long_smem<kRotary>(p.L), grid,
                       st, p);
  return launch_with(attention_stream<kRotary>, stream_smem<kRotary>(), grid,
                     st, p);
}

}  // namespace esmdiff_attn
