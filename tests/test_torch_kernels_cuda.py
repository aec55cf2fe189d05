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
from esmdiff_tpu_torch.ops import qk_norm_rotary as qkr
from esmdiff_tpu_torch.ops import quant
from esmdiff_tpu_torch.ops import small_attention as sa
from esmdiff_tpu_torch.utils import tracing

# each kernel module's launch counter
LAUNCHES = {fa: "flash.launches", sa: "small_attention.launches",
            fq: "fused_qkv.launches", ff: "fused_ffn.launches",
            quant: "int8_mm.launches", qkr: "qk_norm_rotary.launches"}

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
    before = tracing.counter(LAUNCHES[op])
    out = kernel()
    torch.cuda.synchronize()
    assert tracing.counter(LAUNCHES[op]) == before + 1
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

    launched = lambda: sum(tracing.counter(LAUNCHES[m]) for m in (fa, sa, fq))
    before = launched()
    kernel = grads(fa.flash_attention, sa.small_attention, fq.fused_ln_qkv)
    assert launched() > before
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


def _bf16_ulp(x):
    """One bf16 ulp at each element of ``x``: 2^(exponent - 7), normals."""
    _, e = torch.frexp(x.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


@pytest.mark.parametrize("B,L,D,tables", [
    (64, 128, 1536, "shared"),     # the trunk's forward at L 128
    (32, 128, 1280, "shared"),     # the VQ decoder: 20 heads
    (8, 128, 1536, "per_row"),     # mixed packed rows' (B, L, 64) tables
    (3, 7, 1536, "shared"),        # 42 rows: a ragged last block of 8
    (5, 12, 1280, "per_row"),
    (64, 128, 1536, "int8")])      # int8 serving: a QuantDense's output
def test_qk_norm_rotary_on_card(gen, B, L, D, tables):
    """The kernel against its plain version, q and k strided views of one
    (B, L, 3D) bf16 product as the trunk passes them ("int8": the product
    of a QuantDense, as the int8 trunk passes them; (L, 64) tables).  Both
    round to bf16 at the same two points, so each element is within one
    bf16 ulp at each: the kernel sums the LayerNorm statistics in another
    order than PyTorch's kernel, so a normalised value y may round to its
    neighbour (1 ulp of y, carried into the output through cos and sin),
    and the output may round to its neighbour (1 ulp of the output)."""
    if tables == "int8":
        dense = quant.QuantDense(D, 3 * D).cuda()
        w = torch.randn(3 * D, D, device="cuda", generator=gen) * D ** -0.5
        dense.kernel_q, dense.scale = quant.quantize_weight(w)
        qkv = dense(torch.randn(B, L, D, device="cuda", generator=gen).to(
            torch.bfloat16))
        assert qkv.dtype == torch.bfloat16 and qkv.shape == (B, L, 3 * D)
    else:
        qkv = torch.randn(B, L, 3 * D, device="cuda", generator=gen,
                          dtype=torch.bfloat16) * 2 + 0.25
    q, k, _ = qkv.split(D, dim=-1)
    qs, ks = (1 + 0.2 * torch.randn(D, device="cuda", generator=gen)
              for _ in range(2))
    if tables == "per_row":
        from esmdiff_tpu_torch.ops.packing import packed_positions
        # rows of 1, 2 and 4 packed segments
        pos = torch.stack([packed_positions(L // n, n, device="cuda")
                           for n in ((1, 2, 4)[b % 3] for b in range(B))])
        cos, sin = rotary_tables(L, 64, device="cuda", positions=pos)
    else:
        cos, sin = rotary_tables(L, 64, device="cuda")
    before = tracing.counter("qk_norm_rotary.launches")
    got = qkr.qk_norm_rotary(q, k, qs, ks, cos, sin)
    torch.cuda.synchronize()
    assert tracing.counter("qk_norm_rotary.launches") == before + 1
    want = qkr.qk_norm_rotary_reference(q, k, qs, ks, cos, sin)
    c = (cos if cos.dim() == 3 else cos[None]).float()[:, :, None, :]
    s = (sin if sin.dim() == 3 else sin[None]).float()[:, :, None, :]
    for x, scale, o, r in ((q, qs, got[0], want[0]), (k, ks, got[1], want[1])):
        assert o.shape == r.shape == (B, L, D // 64, 64) and o.is_contiguous()
        assert o.dtype == torch.bfloat16 and torch.isfinite(o).all()
        y = torch.nn.functional.layer_norm(x.float(), (D,), scale, None,
                                           1e-5).to(torch.bfloat16)
        y = y.reshape(B, L, D // 64, 64)
        partner = torch.cat([y[..., 32:], y[..., :32]], dim=-1)
        tol = (_bf16_ulp(r) + c.abs() * _bf16_ulp(y)
               + s.abs() * _bf16_ulp(partner))
        diff = (o.float() - r.float()).abs()
        assert (diff <= tol).all(), (diff - tol).max().item()


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
    # rows 129 elements apart: not 16-byte loads
    x3 = torch.randn(2, 8, 129, device="cuda", dtype=torch.bfloat16)[..., 1:]
    s128 = torch.ones(128, device="cuda")
    with pytest.raises(ValueError, match="16-byte"):
        qkr.qk_norm_rotary(x3, x3, s128, s128,
                           *rotary_tables(8, 64, device="cuda"))


# the trunk's four int8 products (D -> 3D, D -> D, D -> 2H, H -> D) at its
# width, and at a narrow one; rows at, below and above the card product's
# limit (it takes > 16 rows: fewer are zero-padded, never sent to the CPU)
@pytest.mark.parametrize("D,F", [(1536, 4608), (1536, 1536), (1536, 8192),
                                 (4096, 1536), (256, 768)])
@pytest.mark.parametrize("T", [4096, 100, 16, 1])
def test_int8_dot_on_card(gen, T, D, F):
    """The card's int8 product (torch._int_mm on the (F, D) weight's .t()
    view) against the exact plain product: int8_dot bit for bit."""
    x = torch.randn(T, D, device="cuda", generator=gen).to(torch.bfloat16)
    w = torch.randn(F, D, device="cuda", generator=gen) * D ** -0.5
    kq, scale = quant.quantize_weight(w)
    assert kq.is_contiguous() and kq.shape == (F, D)
    before = tracing.counter("int8_mm.launches")
    out = quant.int8_dot(x, kq, scale)
    torch.cuda.synchronize()
    assert tracing.counter("int8_mm.launches") == before + 1
    xq, sa_ = quant.quantize_activations(x)
    o = quant.int8_mm_reference(xq, kq)
    ref = (o.float() * sa_ * scale).to(torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (T, F)
    assert torch.equal(out, ref)


def test_packed_int8_trunk_on_card(gen):
    """A 2-layer int8 trunk at D 256 (4 heads of 64), bf16: its logits with
    two rows packed to a device row (segment mask, the plain path) against
    the unpacked rows (prefix lengths, the flash kernel), on valid
    positions, within twice the spread of the kernel's two plain roundings
    (p cast before / after normalising), or 1e-2."""
    from esmdiff_tpu_torch.models.esm3 import ESM3, esm3_tiny
    from esmdiff_tpu_torch.nn.attention import plain_attention_with_lengths
    from esmdiff_tpu_torch.nn.layers import cast_matmul_weights, init_params
    from esmdiff_tpu_torch.ops.packing import (packed_positions,
                                               packed_segment_ids)
    from esmdiff_tpu_torch.ops.quant import quantize_trunk_params

    cfg = esm3_tiny(d_model=256, n_heads=4, n_layers=2, head_type="structure")
    with torch.device("cuda"):
        fp = ESM3(cfg)
        trunk = ESM3(esm3_tiny(d_model=256, n_heads=4, n_layers=2,
                               head_type="structure", quant="int8"))
    init_params(fp, torch.Generator(device="cuda").manual_seed(0))
    trunk.load_state_dict(quantize_trunk_params(fp.state_dict()))
    cast_matmul_weights(trunk)
    B, L = 8, 64
    seq = torch.randint(4, 24, (B, L), device="cuda", generator=gen)
    lengths = torch.tensor([64, 60, 50, 64, 13, 1, 40, 64],
                           dtype=torch.int32, device="cuda")

    def unpacked(flash):
        saved = fa.flash_attention
        fa.flash_attention = flash
        try:
            return trunk(sequence_tokens=seq, lengths=lengths).structure_logits
        finally:
            fa.flash_attention = saved

    with torch.no_grad():
        before = (tracing.counter("flash.launches"),
                  tracing.counter("int8_mm.launches"))
        packed = trunk(sequence_tokens=seq.reshape(B // 2, 2 * L),
                       sequence_id=packed_segment_ids(lengths, L, 2),
                       positions=packed_positions(L, 2, device="cuda"))
        packed = packed.structure_logits.reshape(B, L, -1)
        torch.cuda.synchronize()
        # the plain path only
        assert tracing.counter("flash.launches") == before[0]
        assert tracing.counter("int8_mm.launches") == \
            before[1] + 4 * cfg.n_layers
        kernel = unpacked(fa.flash_attention)
        plain = unpacked(fa.flash_attention_reference)
        other = unpacked(plain_attention_with_lengths)
    valid = torch.arange(L, device="cuda")[None, :] < lengths[:, None]

    def rel(a, b):
        a, b = a[valid].float(), b[valid].float()
        return ((a - b).norm() / b.norm()).item()

    assert torch.isfinite(packed[valid]).all()
    assert rel(packed, kernel) <= max(2 * rel(other, plain), 1e-2), (
        rel(packed, kernel), rel(other, plain))


def test_unmask_primitives_on_card(gen):
    """The gibbs/eb primitives on the card against the same function on the
    CPU for the same fp32 inputs: ``select_top_by_confidence``'s commit
    masks identical (ties, an empty eligible row, n_new 0 included);
    ``top_p_filter``'s kept sets apart in at most 1e-4 of positions, since
    the card sums the probabilities in another order."""
    from esmdiff_tpu_torch.diffusion import gibbs

    B, L, V = 64, 128, 4096
    logits = torch.randn(B, L, V, device="cuda", generator=gen) * 3
    for top_p in (0.5, 0.9):
        for exact in (False, True):
            kept = gibbs.top_p_filter(logits, top_p, exact=exact) > -1e8
            kept_cpu = gibbs.top_p_filter(logits.cpu(), top_p,
                                          exact=exact) > -1e8
            differ = (kept.cpu() != kept_cpu).sum().item()
            assert differ <= 1e-4 * kept_cpu.numel(), (top_p, exact, differ)
    conf = torch.round(torch.randn(B, L, device="cuda", generator=gen) * 10)
    conf = conf / 10                                    # ties
    eligible = torch.rand(B, L, device="cuda", generator=gen) < 0.6
    eligible[0] = False
    n_new = torch.randint(0, 40, (B,), device="cuda", generator=gen)
    n_new[1] = 0
    commit = gibbs.select_top_by_confidence(conf, eligible, n_new)
    assert torch.equal(commit.cpu(), gibbs.select_top_by_confidence(
        conf.cpu(), eligible.cpu(), n_new.cpu()))


def test_row_generator_uniform_on_card(gen):
    from esmdiff_tpu_torch.diffusion.gibbs import RowGeneratorUniform

    u = RowGeneratorUniform([5, 6], 64, 4096, "cuda")(0)
    assert u.device.type == "cuda" and u.shape == (2, 64, 4096)
    assert ((u >= 0) & (u < 1)).all()
    assert torch.equal(RowGeneratorUniform([6], 64, 4096, "cuda")(0)[0], u[1])


@pytest.mark.parametrize("mode", ["gibbs", "eb"])
def test_unmask_samplers_on_card(gen, mode):
    """A 2-layer bf16 stock-head trunk at D 512 (8 heads of 64) on the
    card, 5 samples of 100 residues (bucket 128, one batch of 8, pack 1):
    every decode position committed to a code, the flash kernel launched by
    each layer in every step, and the same tokens on a rerun."""
    from esmdiff_tpu_torch.api.generation import (EnsembleSampler,
                                                  GenerationConfig)
    from esmdiff_tpu_torch.api.protein_api import ESM3Runtime
    from esmdiff_tpu_torch.models.esm3 import esm3_tiny
    from esmdiff_tpu_torch.models.vqvae import DecoderConfig

    runtime = ESM3Runtime.random_init(
        seed=0, trunk_cfg=esm3_tiny(d_model=512, n_heads=8, n_layers=2,
                                    head_type="esm3"),
        decoder_cfg=DecoderConfig(d_model=64, n_heads=2, n_layers=2),
        device="cuda")
    sampler = EnsembleSampler(runtime)
    seq = ("ACDEFGHIKLMNPQRSTVWY" * 5)[:100]

    def run():
        if mode == "gibbs":
            return sampler.gibbs_ensemble(
                seq, 5, config=GenerationConfig(num_steps=4), seed=1), 4
        toks = sampler.eb_ensemble(seq, 5, entropy_budget=1.0,
                                   max_steps=200, seed=1)
        assert len(sampler.eb_steps) == 1
        return toks, sampler.eb_steps[0]

    before = tracing.counter("flash.launches")
    toks, steps = run()
    torch.cuda.synchronize()
    assert toks.shape == (5, 100) and (toks < 4096).all()
    assert 1 <= steps <= 100
    assert tracing.counter("flash.launches") - before == 2 * steps
    again, _ = run()
    assert (again == toks).all()


def test_encoder_card_matches_cpu(gen):
    """The full-width structure encoder (float32; its attention takes the
    plain path by its config) on the card against its CPU copy on BPTI:
    no flash launch, z within 1e-4 relative L2, tokens equal except where
    the two nearest codes lie within 1e-5 relative distance."""
    import copy
    from pathlib import Path

    from esmdiff_tpu_torch.api.protein_api import ESMProtein
    from esmdiff_tpu_torch.models.vqvae import (EncoderConfig,
                                                StructureTokenEncoder)
    from esmdiff_tpu_torch.nn.layers import init_params

    with torch.device("cuda"):
        enc = StructureTokenEncoder(EncoderConfig())
    init_params(enc, gen)
    with torch.no_grad():
        enc.codebook.normal_(0.0, 1.0, generator=gen)
    cpu = copy.deepcopy(enc).cpu()
    bb = torch.as_tensor(ESMProtein.from_pdb(
        Path(__file__).resolve().parents[1] / "data/targets/bpti/bpti.pdb"
    ).backbone()[None], dtype=torch.float32)
    before = tracing.counter("flash.launches")
    with torch.no_grad():
        tokens, z, valid = enc(bb.cuda())
        ref_tokens, ref_z, ref_valid = cpu(bb)
    torch.cuda.synchronize()
    assert tracing.counter("flash.launches") == before
    assert torch.equal(valid.cpu(), ref_valid) and ref_valid.all()
    rel = ((z.cpu() - ref_z).norm() / ref_z.norm()).item()
    assert rel <= 1e-4, rel
    d = torch.cdist(ref_z[0].double(), cpu.codebook.double())
    two = d.topk(2, dim=-1, largest=False).values
    near_tie = (two[:, 1] - two[:, 0]) <= 1e-5 * two[:, 0]
    differ = tokens.cpu()[0] != ref_tokens[0]
    assert not (differ & ~near_tie).any()


def test_train_step_card_matches_cpu(gen):
    """One MDLM train step (loss, backward, AdamW) of a 2-layer trunk at
    D 512 (8 heads of 64; float32 master weights, bf16 compute, remat on)
    on the card against the same weights, batch and draws on the CPU: the
    card runs flash 2 x 2 - 1 = 3 times (forward, then block 1's
    recompute); loss and grad norm within 1e-2 relative; every
    parameter's gradient within twice the spread between the card's
    plain path (attn_backend="xla") and the CPU, or 1e-2, in relative
    L2; every parameter moved."""
    import copy

    from esmdiff_tpu_torch.diffusion.mdlm import MDLM
    from esmdiff_tpu_torch.models.esm3 import ESM3, esm3_tiny
    from esmdiff_tpu_torch.nn.layers import TimestepEmbedder, init_params
    from esmdiff_tpu_torch.train import state as tstate
    from esmdiff_tpu_torch.train.loop import mdlm_modules

    cfg = esm3_tiny(d_model=512, n_heads=8, n_layers=2, head_type="structure")
    with torch.device("cuda"):
        mdlm = MDLM(ESM3(cfg), TimestepEmbedder(512))
    modules = mdlm_modules(mdlm)
    init_params(modules, gen)
    cpu_modules = copy.deepcopy(modules).cpu()
    cpu_mdlm = MDLM(cpu_modules["net"], cpu_modules["sigma_embedder"])
    B, L = 4, 64
    g = torch.Generator().manual_seed(1)
    lengths = torch.tensor([L, 50, 13, 33])
    mask = (torch.arange(L)[None] < lengths[:, None]).float()
    batch = {"structure_tokens": torch.randint(0, 4096, (B, L), generator=g),
             "sequence_tokens": torch.randint(4, 24, (B, L), generator=g),
             "mask": mask}
    batch["structure_tokens"][mask == 0] = 4099   # STRUCTURE_PAD_TOKEN
    batch["sequence_tokens"][mask == 0] = 1       # SEQUENCE_PAD_TOKEN
    draws = {"times": torch.rand(B, generator=g),
             "move": torch.rand(B, L, generator=g)}

    class Draws:
        def __init__(self, device):
            self.device = device

        def times(self, n):
            return draws["times"][:n].to(self.device)

        def move(self, shape):
            return draws["move"].to(self.device)

    def grads(mdl, mods, device):
        mods.zero_grad(set_to_none=True)
        b = {k: v.to(device) for k, v in batch.items()}
        loss, _ = mdl.loss(b, Draws(device))
        loss.backward()
        return loss.item(), {n: p.grad.float().cpu()
                             for n, p in mods.named_parameters()
                             if p.grad is not None}

    cpu_loss, cpu_grads = grads(cpu_mdlm, cpu_modules, "cpu")
    for block in mdlm.net.transformer.blocks:
        block.attn.attn_backend = "xla"
    _, xla_grads = grads(mdlm, modules, "cuda")
    for block in mdlm.net.transformer.blocks:
        block.attn.attn_backend = "auto"
    before = {n: p.detach().clone() for n, p in modules.named_parameters()}
    state = tstate.create_train_state(
        modules, tstate.make_optimizer(modules.parameters(), lr=1e-4))
    launches = tracing.counter("flash.launches")
    metrics = tstate.train_step(state, lambda b, d: mdlm.loss(b, d),
                                {k: v.cuda() for k, v in batch.items()},
                                Draws("cuda"))
    torch.cuda.synchronize()
    assert tracing.counter("flash.launches") - launches == \
        2 * cfg.n_layers - cfg.n_layers_geom
    card_grads = {n: p.grad.float().cpu()
                  for n, p in modules.named_parameters()}

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    cpu_norm = tstate.global_norm(list(cpu_grads.values())).item()
    assert abs(metrics["loss"].item() - cpu_loss) <= 1e-2 * abs(cpu_loss)
    assert abs(metrics["grad_norm"].item() - cpu_norm) <= 1e-2 * cpu_norm
    for n, g_cpu in cpu_grads.items():
        assert torch.isfinite(card_grads[n]).all()
        assert rel(card_grads[n], g_cpu) <= max(
            2 * rel(xla_grads[n], g_cpu), 1e-2), n
    assert state.step == 1
    assert all(not torch.equal(p.detach(), before[n])
               for n, p in modules.named_parameters() if before[n].any())


def test_flash_attention_vq_shape_autograd_on_card(gen):
    """The flash kernel at the VQ-VAE decoder's training shape (B 2, L 514,
    H 20, no lengths) through ``FlashAttentionFunction``: one launch, the
    output against the plain version at the bf16 tolerances, and dq, dk,
    dv equal to autograd through ``plain_attention_with_lengths`` (the
    backward recomputes there)."""
    from esmdiff_tpu_torch.nn.attention import plain_attention_with_lengths

    q, k, v = (torch.randn(2, 514, 20, 64, device="cuda",
                           dtype=torch.bfloat16, generator=gen)
               .requires_grad_() for _ in range(3))
    grad = torch.randn(2, 514, 20, 64, device="cuda", dtype=torch.bfloat16,
                       generator=gen)
    before = tracing.counter("flash.launches")
    out = fa.FlashAttentionFunction.apply(q, k, v, None)
    torch.cuda.synchronize()
    assert tracing.counter("flash.launches") == before + 1
    ref = fa.flash_attention_reference(q.detach(), k.detach(), v.detach())
    diff = (out.detach().float() - ref.float()).abs()
    assert torch.isfinite(out).all()
    assert diff.max().item() <= TOL_MAX and diff.mean().item() <= TOL_MEAN
    got = torch.autograd.grad(out, (q, k, v), grad)
    want = torch.autograd.grad(plain_attention_with_lengths(q, k, v),
                               (q, k, v), grad)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_vq_step_card_matches_cpu(gen):
    """One VQ-VAE train step (forward, backward, AdamW) at a small
    geometry whose decoder takes the kernel (d 128, 2 heads of 64, bf16,
    remat; encoder d 64, float32) on the card against the same weights
    and batch on the CPU: flash 2 x 2 launches (forward + recompute);
    loss and grad norm within 1e-2 relative; every parameter's gradient
    within twice the spread between the card's plain path
    (attn_backend="xla") and the CPU, or 1e-2, in relative L2."""
    import copy

    import numpy as np

    from esmdiff_tpu_torch.models.vqvae import DecoderConfig, EncoderConfig
    from esmdiff_tpu_torch.train import state as tstate
    from esmdiff_tpu_torch.train import vqvae as tvq

    enc = EncoderConfig(d_model=64, n_heads=2, v_heads=8, n_layers=2,
                        d_out=16, n_codes=64, knn=8)
    dec = DecoderConfig(d_model=128, n_heads=2, n_layers=2,
                        dtype="bfloat16", predict_ptm=False, remat=True)
    with torch.device("cuda"):
        model = tvq.init_vqvae(tvq.VQVAE(enc, dec), 0)
    cpu_model = copy.deepcopy(model).cpu()
    rs = np.random.RandomState(0)
    t = np.arange(62)
    coords = []
    for _ in range(4):
        ca = np.stack([2.3 * np.cos(0.6 * t + rs.rand() * 6),
                       2.3 * np.sin(0.6 * t + rs.rand() * 6), 1.5 * t], -1)
        coords.append(np.stack([ca + [1.2, 0.3, -0.4], ca,
                                ca + [-0.8, 1.0, 0.5]], 1)
                      + rs.randn(62, 3, 3) * 0.1)
    coords = np.asarray(coords, np.float32)
    lengths = np.asarray([62, 50, 40, 13], np.int32)
    for i, L in enumerate(lengths):
        coords[i, L:] = np.nan
    idx = np.arange(4)
    loss_cfg = tvq.VQLossConfig()

    def grads(m, device):
        m.zero_grad(set_to_none=True)
        loss, _ = tvq.batch_loss(
            m, tvq.gather_batch(coords, lengths, idx, device), loss_cfg)
        loss.backward()
        return loss.item(), {n: p.grad.float().cpu()
                             for n, p in m.named_parameters()
                             if p.grad is not None}

    cpu_loss, cpu_grads = grads(cpu_model, "cpu")
    blocks = model.decoder.decoder_stack.blocks
    for block in blocks:
        block.attn.attn_backend = "xla"
    _, xla_grads = grads(model, "cuda")
    for block in blocks:
        block.attn.attn_backend = "auto"
    state = tstate.create_train_state(model, tstate.make_optimizer(
        model.parameters(), lr=1e-4))
    launches = tracing.counter("flash.launches")
    metrics = tstate.train_step(
        state, lambda b, d: tvq.batch_loss(model, b, loss_cfg),
        tvq.gather_batch(coords, lengths, idx, "cuda"), None)
    torch.cuda.synchronize()
    assert tracing.counter("flash.launches") - launches == 2 * dec.n_layers
    card_grads = {n: p.grad.float().cpu() for n, p in model.named_parameters()}

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    cpu_norm = tstate.global_norm(list(cpu_grads.values())).item()
    assert abs(metrics["loss"].item() - cpu_loss) <= 1e-2 * abs(cpu_loss)
    assert abs(metrics["grad_norm"].item() - cpu_norm) <= 1e-2 * cpu_norm
    for n, g_cpu in cpu_grads.items():
        assert torch.isfinite(card_grads[n]).all()
        assert rel(card_grads[n], g_cpu) <= max(
            2 * rel(xla_grads[n], g_cpu), 1e-2), n
    assert state.step == 1


def _ar_pair(model_type):
    """A tiny float32 AR net (random weights, seed 0) on the CPU and its
    copy on the card."""
    from esmdiff_tpu_torch.models import clm as tclm
    from esmdiff_tpu_torch.models import jlm as tjlm

    if model_type == "clm":
        cpu = tclm.CLM(tclm.CLMConfig(d_model=64, d_ff=128, n_layers=2,
                                      n_heads=4, cond_dim=96,
                                      dec_add_input_emb=True,
                                      dtype="float32"))
        tclm.init_params(cpu, torch.Generator().manual_seed(0))
    else:
        cpu = tjlm.JLM(tjlm.JLMConfig(n_embd=64, n_layers=2, n_heads=4,
                                      cond_dim=96, struct_embed_dim=32,
                                      sep_strategy="position",
                                      dtype="float32"))
        tjlm.init_params(cpu, torch.Generator().manual_seed(0))
    card = type(cpu)(cpu.cfg).cuda()
    card.load_state_dict(cpu.state_dict())
    return cpu, card


@pytest.mark.parametrize("model_type", ["clm", "jlm"])
def test_ar_decode_card_matches_cpu(gen, model_type):
    """A tiny CLM and JLM in float32: the generate functions on the card
    against their CPU copies with the same uniforms, token for token, and
    no structure special sampled."""
    from esmdiff_tpu_torch.api import ar_generation as tar

    cpu, card = _ar_pair(model_type)
    B, L = 4, 24
    emb = torch.randn(B, L, 96, generator=gen, device="cuda")
    u = torch.rand(B, L, 4101, generator=gen, device="cuda")
    generate = tar.clm_generate if model_type == "clm" else tar.jlm_generate
    got = generate(card, emb, L, 1.0, 0.95, draws=lambda s: u[:, s])
    ref = generate(cpu, emb.cpu(), L, 1.0, 0.95,
                   draws=lambda s: u[:, s].cpu())
    assert torch.equal(got.cpu(), ref)
    assert (got < 4096).all()


def test_ar_path_flash_launches(gen, tmp_path):
    """cli.sample_ar on the card with a small bf16 trunk (D 512, 8 heads
    of 64, 2 layers) and VQ decoder (D 128, 2 heads of 64, 2 layers): the
    flash kernel launches once a trunk layer for the target's forward and
    once a decoder layer for each chunk of 32 decoded rows."""
    from pathlib import Path

    from esmdiff_tpu_torch.api.protein_api import ESM3Runtime
    from esmdiff_tpu_torch.cli import sample_ar
    from esmdiff_tpu_torch.models.esm3 import esm3_tiny
    from esmdiff_tpu_torch.models.vqvae import DecoderConfig

    runtime = ESM3Runtime.random_init(
        seed=0, trunk_cfg=esm3_tiny(d_model=512, n_heads=8, n_layers=2),
        decoder_cfg=DecoderConfig(d_model=128, n_heads=2, n_layers=2),
        device="cuda")
    bpti = Path(__file__).resolve().parents[1] / "data/targets/bpti"
    for model_type in ("clm", "jlm"):
        before = tracing.counter("flash.launches")
        sample_ar.main(["--input", str(bpti), "--output",
                        str(tmp_path / model_type), "--model_type",
                        model_type, "--model_scale", "tiny", "--n_samples",
                        "40", "--batch_size", "16"], runtime=runtime)
        torch.cuda.synchronize()
        assert tracing.counter("flash.launches") - before == 2 + 2 * 2
        assert (tmp_path / model_type / "bpti.pdb").exists()
