"""The port's CUDA kernels against their plain versions on the card, in the
bf16 working type, at the tolerances ``chip_smoke.py`` holds them to.

Needs a CUDA card and nvcc; skips without one.  Imports neither JAX nor the
JAX package, so on a machine with a card and no JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_cuda.py -q
"""

import pytest
import torch

from esmdiff_tpu_torch.nn.rotary import apply_rotary, rotary_tables
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


def _attention_inputs(B, L, H, gen, layout):
    """bf16 q, k, v (B, L, H, 64): separate tensors, or strided views of one
    (B, L, 3 * H * 64) tensor as the trunk passes them; lengths 0, 1 and L
    in the first rows (as far as B goes), random in the rest."""
    if layout == "qkv_views":
        qkv = torch.randn(B, L, 3 * H * 64, device="cuda", generator=gen,
                          dtype=torch.bfloat16)
        q, k, v = (t.view(B, L, H, 64) for t in qkv.split(H * 64, dim=-1))
    else:
        q, k, v = (torch.randn(B, L, H, 64, device="cuda", generator=gen,
                               dtype=torch.bfloat16) for _ in range(3))
    lengths = torch.randint(1, L + 1, (B,), device="cuda", generator=gen,
                            dtype=torch.int32)
    special = torch.tensor([0, 1, L], dtype=torch.int32)[:B]
    lengths[:len(special)] = special.cuda()
    return q, k, v, lengths


LAYOUTS = ["contiguous", "qkv_views"]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("B,L,H", [(64, 64, 24), (32, 64, 20), (4, 200, 24),
                                   (16, 512, 24), (4, 1024, 24),
                                   (3, 2048, 24)])
def test_flash_attention_on_card(gen, B, L, H, layout):
    q, k, v, lengths = _attention_inputs(B, L, H, gen, layout)
    _launch_and_compare(fa, lambda: fa.flash_attention(q, k, v, lengths),
                        lambda: fa.flash_attention_reference(q, k, v, lengths))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("B,L,H", [(64, 64, 24), (32, 64, 20), (8, 128, 24),
                                   (2, 200, 24), (16, 512, 24),
                                   (3, 2048, 24)])
def test_small_attention_on_card(gen, B, L, H, layout):
    q, k, v, lengths = _attention_inputs(B, L, H, gen, layout)
    cos, sin = rotary_tables(L, 64, device="cuda")
    _launch_and_compare(
        sa, lambda: sa.small_attention(q, k, v, cos, sin, lengths),
        lambda: sa.small_attention_reference(q, k, v, cos, sin, lengths))


@pytest.mark.parametrize("qkv_backend,attn_backend", [
    ("xla", "auto"), ("fused", "small"), ("xla", "small")])
def test_trunk_gradients_on_card(gen, monkeypatch, qkv_backend, attn_backend):
    """A 2-layer trunk at D 512 (8 heads of 64) in bf16: its parameter
    gradients with the kernels against those with the plain versions (the
    backward is the same plain recompute; only the forward rounds
    differently), per parameter in relative L2, within twice the spread
    between the plain versions and the plain path's other roundings (p
    normalised before its cast, the QKV product rounded before the q/k
    LayerNorm), or 1e-2.  A kernel output that carried no gradient would
    miss the attention parameters' gradient terms entirely."""
    from esmdiff_tpu_torch.models.esm3 import ESM3, esm3_tiny
    from esmdiff_tpu_torch.nn.attention import plain_attention_with_lengths
    from esmdiff_tpu_torch.nn.layers import init_params

    cfg = esm3_tiny(d_model=512, n_heads=8, n_layers=2, head_type="structure",
                    qkv_backend=qkv_backend, attn_backend=attn_backend)
    with torch.device("cuda"):
        trunk = ESM3(cfg)
    init_params(trunk, torch.Generator(device="cuda").manual_seed(0))
    B, L = 4, 64
    seq = torch.randint(4, 24, (B, L), device="cuda", generator=gen)
    lengths = torch.tensor([L, 50, 13, 1], dtype=torch.int32, device="cuda")
    weight = torch.randn(B, L, cfg.n_structure_heads, device="cuda",
                         generator=gen)

    def grads(flash, small, qkv):
        monkeypatch.setattr(fa, "flash_attention", flash)
        monkeypatch.setattr(sa, "small_attention", small)
        monkeypatch.setattr(fq, "fused_ln_qkv", qkv)
        trunk.zero_grad(set_to_none=True)
        out = trunk(sequence_tokens=seq, lengths=lengths)
        (out.structure_logits.float() * weight).sum().backward()
        torch.cuda.synchronize()
        return {n: p.grad.float() for n, p in trunk.named_parameters()
                if p.grad is not None}

    def small_normalised_first(q, k, v, cos, sin, lens):
        return plain_attention_with_lengths(
            apply_rotary(q, cos, sin), apply_rotary(k, cos, sin), v, lens)

    before = fa.launches + sa.launches + fq.launches
    kernel = grads(fa.flash_attention, sa.small_attention, fq.fused_ln_qkv)
    assert fa.launches + sa.launches + fq.launches > before
    plain = grads(fa.flash_attention_reference, sa.small_attention_reference,
                  fq.fused_ln_qkv_reference)
    other = grads(plain_attention_with_lengths, small_normalised_first,
                  fq.ln_qkv_unfused)
    assert kernel.keys() == plain.keys() == other.keys()
    assert any("attn.qkv" in n for n in plain)

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    for n, g in plain.items():
        assert torch.isfinite(kernel[n]).all()
        assert rel(kernel[n], g) <= max(2 * rel(other[n], g), 1e-2), (
            n, rel(kernel[n], g), rel(other[n], g))


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
