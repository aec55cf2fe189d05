"""The port's CUDA kernels against their plain versions on the card, in the
bf16 working type, at the tolerances ``chip_smoke.py`` holds them to.

Needs a CUDA card and nvcc; skips without one.  Imports neither JAX nor the
JAX package, so on a machine with a card and no JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_cuda.py -q
"""

import pytest
import torch

from esmdiff_tpu_torch.nn.rotary import rotary_tables
from esmdiff_tpu_torch.ops import flash_attention as fa
from esmdiff_tpu_torch.ops import fused_ffn as ff
from esmdiff_tpu_torch.ops import fused_qkv as fq
from esmdiff_tpu_torch.ops import small_attention as sa

pytestmark = pytest.mark.cuda
TOL_MAX, TOL_MEAN = 2e-2, 2e-3


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc; runs via chip_smoke.py")
    return torch.Generator(device="cuda").manual_seed(0)


def _launch_and_compare(op, kernel, plain, relative=False):
    """One kernel launch (counted) against the plain version: max |d|
    (relative to max(1, |plain|) for the D=1536 reductions) and mean |d|."""
    before = op.launches
    out = kernel()
    torch.cuda.synchronize()
    assert op.launches == before + 1
    ref = plain().float()
    diff = (out.float() - ref).abs()
    scaled = diff / ref.abs().clamp_min(1.0) if relative else diff
    assert torch.isfinite(out).all()
    assert scaled.max().item() <= TOL_MAX and diff.mean().item() <= TOL_MEAN


def _attention_inputs(B, L, H, gen):
    q, k, v = (torch.randn(B, L, H, 64, device="cuda", generator=gen,
                           dtype=torch.bfloat16) for _ in range(3))
    lengths = torch.randint(1, L + 1, (B,), device="cuda", generator=gen,
                            dtype=torch.int32)
    lengths[0] = 0
    return q, k, v, lengths


@pytest.mark.parametrize("B,L,H", [(64, 64, 24), (32, 64, 20), (4, 200, 24)])
def test_flash_attention_on_card(gen, B, L, H):
    q, k, v, lengths = _attention_inputs(B, L, H, gen)
    _launch_and_compare(fa, lambda: fa.flash_attention(q, k, v, lengths),
                        lambda: fa.flash_attention_reference(q, k, v, lengths))


@pytest.mark.parametrize("B,L,H", [(64, 64, 24), (8, 128, 24), (2, 200, 24)])
def test_small_attention_on_card(gen, B, L, H):
    q, k, v, lengths = _attention_inputs(B, L, H, gen)
    cos, sin = rotary_tables(L, 64, device="cuda")
    _launch_and_compare(
        sa, lambda: sa.small_attention(q, k, v, cos, sin, lengths),
        lambda: sa.small_attention_reference(q, k, v, cos, sin, lengths))


@pytest.mark.parametrize("D", [512, 1024, 1536])
@pytest.mark.parametrize("T", [4096, 1000, 64])
@pytest.mark.parametrize("layout", ["transpose_view", "contiguous",
                                    "padded_view"])
def test_fused_qkv_on_card(gen, T, layout, D):
    x = torch.randn(1, T, D, device="cuda", generator=gen,
                    dtype=torch.bfloat16)
    w = (torch.randn(3 * D, D, device="cuda", generator=gen)
         * D ** -0.5).to(torch.bfloat16).t()
    if layout == "contiguous":
        w = w.contiguous()
    elif layout == "padded_view":   # leading stride D + 8: 16 bytes, not 32
        padded = torch.zeros(3 * D, D + 8, device="cuda", dtype=torch.bfloat16)
        padded[:, :D] = w.t()
        w = padded[:, :D].t()
    ln, qs, ks = (1 + 0.1 * torch.randn(D, device="cuda", generator=gen)
                  for _ in range(3))
    _launch_and_compare(fq, lambda: fq.fused_ln_qkv(x, ln, w, qs, ks),
                        lambda: fq.fused_ln_qkv_reference(x, ln, w, qs, ks),
                        relative=True)


def _padded_t(w):
    """w.t() of a view whose leading stride is w's width + 8: 16 bytes
    wider, not 32."""
    n, k = w.shape
    padded = torch.zeros(n, k + 8, device=w.device, dtype=w.dtype)
    padded[:, :k] = w
    return padded[:, :k].t()


@pytest.mark.parametrize("D,H", [(512, 1536), (1024, 3072), (1536, 4096)])
@pytest.mark.parametrize("M", [4096, 1000, 64])
@pytest.mark.parametrize("layout", ["transpose_view", "contiguous",
                                    "padded_view"])
def test_fused_ffn_on_card(gen, M, layout, D, H):
    x = torch.randn(M, D, device="cuda", generator=gen, dtype=torch.bfloat16)
    up_w = (torch.randn(2 * H, D, device="cuda", generator=gen)
            * D ** -0.5).to(torch.bfloat16)
    down_w = (torch.randn(D, H, device="cuda", generator=gen)
              * H ** -0.5).to(torch.bfloat16)
    up, down = up_w.t(), down_w.t()
    if layout == "contiguous":
        up, down = up.contiguous(), down.contiguous()
    elif layout == "padded_view":
        up, down = _padded_t(up_w), _padded_t(down_w)
    scale = 1 + 0.1 * torch.randn(D, device="cuda", generator=gen)
    _launch_and_compare(
        ff, lambda: ff.fused_swiglu_ffn(x, scale, up, down),
        lambda: ff.fused_swiglu_ffn_reference(x, scale, up, down),
        relative=True)


def test_kernels_reject_what_they_do_not_take(gen):
    x = torch.randn(2, 8, 64, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(64, 192, device="cuda", dtype=torch.bfloat16)
    s = torch.ones(64, device="cuda")
    with pytest.raises(ValueError, match="D in"):
        fq.fused_ln_qkv(x, s, w, s, s)         # D = 64: no kernel, no fallback
    with pytest.raises(ValueError, match="D in"):
        ff.fused_swiglu_ffn(x[0], s, w[:, :128], w[:, :64].t())
    x2 = torch.randn(8, 512, device="cuda", dtype=torch.bfloat16)
    w2 = torch.randn(512, 256, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 512"):
        ff.fused_swiglu_ffn(x2, torch.ones(512, device="cuda"), w2,
                            w2[:, :128].t())    # H = 128: no kernel
    q = torch.randn(1, 8, 2, 32, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Dh=64"):
        fa.flash_attention(q, q, q)
