"""esmdiff_tpu_torch — the PyTorch/CUDA port of esmdiff_tpu for NVIDIA Hopper.

A second package beside ``esmdiff_tpu`` (the JAX reference, which it never
imports).  It runs the ESMDiff ``ddpm`` sampling path end to end:
sequence -> ESM3 trunk (25-step masked-diffusion sampler) -> VQ-VAE decoder
-> multi-MODEL PDB.  Each Pallas kernel of the JAX package has a
hand-written CUDA counterpart (``ops/*.py`` over ``csrc/*.cu``, built by
``ops/_build.py``): flash attention on the default path, fused LN + QKV +
QK-LN and rotary-fused attention in the trunk's ``qkv_backend="fused"``,
``attn_backend="small"`` configuration, and the fused SwiGLU FFN as a
public function.

Numerics: float32 matmuls run in full float32, never TF32, so a float32 run
on the card is comparable with the JAX reference.  Both switches are set here,
on import, and nowhere else.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
