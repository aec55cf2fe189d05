// Rotary + prefix-length masked softmax attention for Hopper (sm_90a),
// bf16 in/out, q and k given BEFORE rotary.
//
// Replaces the Pallas TPU kernel esmdiff_tpu/ops/small_attention.py::_kernel
// (:55, launched at :155).  Same function, per (b, h): q and k rotated in
// fp32 by the (L, Dh) cos/sin tables (GPT-NeoX half rotation) and rounded
// to bf16, then the attention of attention_tiles.cuh (fp32 logits times
// 1/sqrt(Dh), -1e9 past lengths[b], unnormalised p cast to bf16 before
// p . v, output times 1/sum(p)).
//
// Bound on an H100: at the trunk's shape (B 64, L 64, H 24, Dh 64) the
// bytes of q, k, v and o (50 MB, K/V only for the keys the lengths need)
// bound it, about 0.0115 ms; the tensor-core work is a quarter of that.
//
// Design: the TPU program holds one whole batch row, 3 x (L, H, Dh) plus an
// (H, L, L) fp32 score block (384 KB at L=64, H=24), more than a Hopper
// block's 227 KB.  This kernel is the flash kernel's (attention_tiles.cuh:
// a 64-query tile of one batch row for G heads, scores in registers, one
// pass at L <= 64) with the block's cos/sin rows staged in shared memory
// once for all G heads, and each q and k row rotated there in place, once
// per block (twice above L 1024, where K streams through both sweeps),
// before the products; the rotated q and k never exist in device memory,
// which is what fusing rotary into the TPU kernel saved.

#include "attention_tiles.cuh"

// Plain C interface, loaded with ctypes.  cos/sin are (L, 64) fp32
// row-major; the other arguments as for flash_attention.cu.  Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() after the
// launch.
extern "C" int esmdiff_small_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const int* lengths,
    const float* cos, const float* sin, int B, int L, int H, int G,
    long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh,
    long long o_sb, long long o_sl, long long o_sh,
    void* stream) {
  using namespace esmdiff_attn;
  const Params p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), static_cast<bf16*>(o), lengths,
                 L, H, G,
                 Strides{q_sb, q_sl, q_sh}, Strides{k_sb, k_sl, k_sh},
                 Strides{v_sb, v_sl, v_sh}, Strides{o_sb, o_sl, o_sh},
                 Rotary{cos, sin}};
  return launch<true>(p, B, stream);
}
