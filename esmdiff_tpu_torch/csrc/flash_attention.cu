// Prefix-length masked softmax attention for Hopper (sm_90a), bf16 in/out.
//
// Replaces the Pallas TPU kernel esmdiff_tpu/ops/flash_attention.py::_attn_kernel
// (launched at :204).  The function and the design are in
// attention_tiles.cuh, shared with small_attention.cu; this file
// instantiates it without rotary.
//
// Bound on an H100: at the main path's shapes (L = 64..1024, Dh = 64) the
// kernel moves 4 * B*L*H*Dh bf16 values and does 4 * L * keys * Dh flops per
// (b, h); below L ~ 600 the bytes bound it, above that the tensor cores.
// The TPU kernel keeps the whole K/V of one (b, h) resident in VMEM; here
// K/V stream through shared memory in 64-key tiles, and the native
// (B, L, H, Dh) strides are read directly, so no layout copy is made.

#include "attention_tiles.cuh"

// Plain C interface, loaded with ctypes.  Pointers are device pointers;
// launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch.
extern "C" int esmdiff_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const int* lengths,
    int B, int L, int H,
    long long q_sb, long long q_sl, long long q_sh,
    long long k_sb, long long k_sl, long long k_sh,
    long long v_sb, long long v_sl, long long v_sh,
    long long o_sb, long long o_sl, long long o_sh,
    void* stream) {
  using namespace esmdiff_attn;
  return launch<false>(q, k, v, o, lengths, B, L, H,
                       Strides{q_sb, q_sl, q_sh}, Strides{k_sb, k_sl, k_sh},
                       Strides{v_sb, v_sl, v_sh}, Strides{o_sb, o_sl, o_sh},
                       Rotary{nullptr, nullptr}, stream);
}
