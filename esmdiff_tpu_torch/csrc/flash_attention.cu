// Prefix-length masked softmax attention for Hopper (sm_90a), bf16 in/out.
//
// Replaces the Pallas TPU kernel esmdiff_tpu/ops/flash_attention.py::_attn_kernel
// (launched at :204).  The function, its bound and the design are in
// attention_tiles.cuh, shared with small_attention.cu; this file
// instantiates it without rotary.  Where the TPU kernel holds one (b, h)'s
// whole K/V in VMEM in a (B*H, L, Dh) layout that XLA transposes into,
// this kernel reads the native (B, L, H, Dh) strides in place: one pass
// with the scores in registers at L <= 64 (every main-path shape), K
// resident in shared memory and swept twice at 64 < L <= 1024, K streamed
// in both sweeps above.

#include "attention_tiles.cuh"

// Plain C interface, loaded with ctypes.  Pointers are device pointers; G
// is the heads a block takes (ops/flash_attention.py pick_group).
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch.
extern "C" int esmdiff_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const int* lengths,
    int B, int L, int H, int G,
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
                 Rotary{nullptr, nullptr}};
  return launch<false>(p, B, stream);
}
