// q/k LayerNorm + rotary for Hopper (sm_90a), bf16 in/out, inference only.
//
// Replaces no TPU kernel: on the TPU, XLA fuses the q/k LayerNorm and the
// rotary of nn/layers.py into the neighbouring ops by itself.  In PyTorch's
// eager mode the same chain, between the QKV product and attention, is 20
// launches a layer (for q and for k: a cast of the strided slice to fp32,
// the LayerNorm, a cast back to bf16; then a cast to fp32, a multiply by
// the broadcast cos table, a negation, the concatenation of rotate_half, a
// multiply by sin, an add and a cast back to bf16), and moves about 1.8 GB
// a layer at the trunk's T 8192 x D 1536.  This kernel computes it in one
// pass, per token row x of q or of k (D values, H = D / 64 heads):
//   y = (x - mean) * 1/sqrt(var + 1e-5) * scale in fp32 (population
//       variance, two-pass statistics), rounded to bf16;
//   per head, o = y * cos + rotate_half(y) * sin in fp32 on those bf16
//       values, rotate_half(y) = [-y[32:64], y[0:32]], each product and the
//       sum rounded as the plain chain rounds them (no fma), then rounded
//       to bf16;
//   out (T, H, 64) contiguous, as the attention reads it.
// The two roundings to bf16 are where the plain chain rounds.
//
// Bound on an H100: it reads q and k (4 T D bytes) and writes them (4 T D
// bytes), 101 MB at T 8192, D 1536: about 0.030 ms at 3.35 TB/s.  Its
// arithmetic is a handful of operations a byte, far below the ~295 at
// which the tensor cores would bound it, so the bytes bound it.
//
// Design: one warp takes one (token, q|k) row; every lane loads its 16-byte
// chunks (chunk c = lane + 32 j: D / 256 of them, 6 at D 1536, 5 at D 1280)
// before any arithmetic, so a warp has the whole row in flight at once,
// and keeps them as loaded (bf16, 4 registers a chunk), widened in each
// pass: up to D 1536 a thread then fits 80 registers (ptxas spills 4 bytes
// at D 1536), so an SM holds 3 blocks of 8 warps (the launch bound), not
// the 2 that fp32 copies of the row allowed: 0.0405 against 0.0419 ms at
// T 8192, D 1536 on an NVIDIA H100 80GB HBM3 at 700 W.  Mean and variance are two passes over those registers,
// each summed with warp shuffles.  A lane's chunks all sit at the same offset in their heads
// (32 j chunks = 4 j heads), so its 8 cos and 8 sin values are loaded once
// a row, through the read-only path as the scales are; the rotary partner
// (i, i + 32) of a value lies in the chunk 4 lanes away, taken with one
// shuffle.  The grid covers the 2 T rows with 8 warps a block, the tail
// masked.  Nothing is staged in shared memory.

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kHeadDim = 64;
constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const bf16* q;
  const bf16* k;
  const float* q_scale;
  const float* k_scale;
  const float* cos;   // (L, 64) or (B, L, 64) fp32, rows contiguous
  const float* sin;
  bf16* q_out;        // (B * L, D) contiguous
  bf16* k_out;
  int B, L, D;
  long long q_sb, q_sl, k_sb, k_sl;   // element strides of batch and row
  long long t_sb;                     // tables' batch stride: 0 or L * 64
};

__device__ __forceinline__ void unpack8(const uint4& raw, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 v = __bfloat1622float2(p[e]);
    f[2 * e] = v.x;
    f[2 * e + 1] = v.y;
  }
}

__device__ __forceinline__ void load8(const float* src, float* f) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// NJ: 16-byte chunks a lane holds, ceil(D / 256).  Above 6 (D > 1536,
// which no model here has) the row takes more registers than 3 blocks an
// SM leave, so those keep the compiler's own count.
template <int NJ>
__global__ void __launch_bounds__(kWarps * 32, NJ <= 6 ? 3 : 1)
    qk_norm_rotary_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps +
                        (threadIdx.x >> 5);
  const long long tokens = static_cast<long long>(a.B) * a.L;
  if (row >= 2 * tokens) return;  // the whole warp: row is warp-uniform
  const bool is_k = row & 1;
  const long long t = row >> 1;
  const int b = static_cast<int>(t / a.L), l = static_cast<int>(t % a.L);
  const bf16* x = is_k ? a.k + b * a.k_sb + l * a.k_sl
                       : a.q + b * a.q_sb + l * a.q_sl;
  const float* scale = is_k ? a.k_scale : a.q_scale;
  bf16* out = (is_k ? a.k_out : a.q_out) + t * a.D;
  const int chunks = a.D >> 3;

  // the row stays in registers as loaded (bf16: 4 registers a chunk),
  // widened to fp32 in each of the three passes
  uint4 raw[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = lane + 32 * j;
    raw[j] = c < chunks ? *reinterpret_cast<const uint4*>(x + 8 * c)
                        : make_uint4(0u, 0u, 0u, 0u);
  }
  // this lane's 8 values of every head it holds start at `off`
  const int off = (lane & 7) * 8;
  const long long trow = b * a.t_sb + static_cast<long long>(l) * kHeadDim;
  float cs[8], sn[8];
  load8(a.cos + trow + off, cs);
  load8(a.sin + trow + off, sn);
  const bool first_half = off < kHeadDim / 2;

  float v[8], sum = 0.0f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    unpack8(raw[j], v);
#pragma unroll
    for (int e = 0; e < 8; ++e) sum += v[e];
  }
  const float mean = esmdiff::warp_sum(sum) / a.D;
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    if (lane + 32 * j < chunks) {
      unpack8(raw[j], v);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = v[e] - mean;
        sq += d * d;
      }
    }
  const float rstd = 1.0f / sqrtf(esmdiff::warp_sum(sq) / a.D + 1e-5f);

#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = lane + 32 * j;
    const bool valid = c < chunks;   // the same for the lane 4 away
    float g[8] = {};
    if (valid) load8(scale + 8 * c, g);
    unpack8(raw[j], v);
    float y[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      y[e] = valid ? __bfloat162float(__float2bfloat16_rn(
                         (v[e] - mean) * rstd * g[e]))
                   : 0.0f;
    uint4 o;
    __nv_bfloat162* r = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      float p0 = __shfl_xor_sync(kFull, y[e], 4);
      float p1 = __shfl_xor_sync(kFull, y[e + 1], 4);
      if (first_half) p0 = -p0, p1 = -p1;
      r[e / 2] = __floats2bfloat162_rn(
          __fadd_rn(__fmul_rn(y[e], cs[e]), __fmul_rn(p0, sn[e])),
          __fadd_rn(__fmul_rn(y[e + 1], cs[e + 1]),
                    __fmul_rn(p1, sn[e + 1])));
    }
    if (valid) *reinterpret_cast<uint4*>(out + 8 * c) = o;
  }
}

template <int NJ>
void launch(const Args& a, cudaStream_t stream) {
  const long long rows = 2LL * a.B * a.L;
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  qk_norm_rotary_kernel<NJ><<<blocks, kWarps * 32, 0, stream>>>(a);
}

}  // namespace

// Plain C interface, loaded with ctypes.  q, k: bf16 rows of D values at
// q + b * q_sb + l * q_sl (likewise k), 16-byte aligned; scales (D,) fp32;
// cos/sin fp32 rows of 64 at b * t_sb + l * 64; q_out, k_out (B * L, D)
// bf16.  D a multiple of 64, at most 2048.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch.
extern "C" int esmdiff_qk_norm_rotary_fwd(
    const void* q, const void* k, const float* q_scale, const float* k_scale,
    const float* cos, const float* sin, void* q_out, void* k_out, int B,
    int L, int D, long long q_sb, long long q_sl, long long k_sb,
    long long k_sl, long long t_sb, void* stream) {
  const Args a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
               q_scale, k_scale, cos, sin,
               static_cast<bf16*>(q_out), static_cast<bf16*>(k_out),
               B, L, D, q_sb, q_sl, k_sb, k_sl, t_sb};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D % kHeadDim != 0) return cudaErrorInvalidValue;
  switch ((D + 255) / 256) {
    case 1: launch<1>(a, s); break;
    case 2: launch<2>(a, s); break;
    case 3: launch<3>(a, s); break;
    case 4: launch<4>(a, s); break;
    case 5: launch<5>(a, s); break;
    case 6: launch<6>(a, s); break;
    case 7: launch<7>(a, s); break;
    case 8: launch<8>(a, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
