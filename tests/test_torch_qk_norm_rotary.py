"""``ops/qk_norm_rotary.py`` on the CPU: its plain version is the chain it
replaces in ``MultiHeadAttention`` (``q_ln``/``k_ln`` then
``apply_rotary``) bit for bit, its wrapper's argument checks, and where
the attention takes it.  The kernel itself is held to the plain version
on the card (``test_torch_kernels_cuda.py``)."""

import pytest
import torch
import torch.nn.functional as F

from esmdiff_tpu_torch.models.esm3 import ESM3, TransformerBlock, esm3_tiny
from esmdiff_tpu_torch.models.vqvae import DecoderConfig, StructureTokenDecoder
from esmdiff_tpu_torch.nn import layers as tl
from esmdiff_tpu_torch.nn.rotary import apply_rotary, rotary_tables
from esmdiff_tpu_torch.ops import qk_norm_rotary as qkr
from esmdiff_tpu_torch.ops.packing import packed_positions, packed_segment_ids
from esmdiff_tpu_torch.ops.quant import quantize_trunk_params

torch.set_num_threads(2)

BF16 = torch.bfloat16


def _inputs(B, L, D, tables, layout, seed=0):
    """bf16 q, k (B, L, D) (strided views of one (B, L, 3D) product as the
    trunk passes them, or separate tensors), scales near 1 and the tables
    of ``rotary_tables``: shared (L, 64), or per row (B, L, 64) from packed
    layouts of 1, 2 and 4 segments."""
    g = torch.Generator().manual_seed(seed)
    if layout == "qkv_views":
        qkv = torch.randn(B, L, 3 * D, generator=g).to(BF16) * 3 + 0.5
        q, k, _ = qkv.split(D, dim=-1)
    else:
        q, k = (torch.randn(B, L, D, generator=g).to(BF16) for _ in range(2))
    qs, ks = (1 + 0.1 * torch.randn(D, generator=g) for _ in range(2))
    if tables == "per_row":
        pos = torch.stack([packed_positions(L // (1 << (b % 3)), 1 << (b % 3))
                           for b in range(B)])
        cos, sin = rotary_tables(L, 64, positions=pos)
    else:
        cos, sin = rotary_tables(L, 64)
    return q, k, qs, ks, cos, sin


def _module_chain(q, k, qs, ks, cos, sin):
    """What ``MultiHeadAttention`` computes without the op: its own
    ``LayerNorm`` modules, a reshape to heads, ``apply_rotary``."""
    B, L, D = q.shape
    out = []
    for x, s in ((q, qs), (k, ks)):
        ln = tl.LayerNorm(D)
        ln.scale.data.copy_(s)
        out.append(apply_rotary(ln(x).reshape(B, L, D // 64, 64), cos, sin))
    return out


@pytest.mark.parametrize("tables", ["shared", "per_row"])
@pytest.mark.parametrize("layout", ["qkv_views", "contiguous"])
@pytest.mark.parametrize("B,L,D", [(3, 16, 128), (2, 12, 320)])
def test_reference_is_the_module_chain(B, L, D, tables, layout):
    args = _inputs(B, L, D, tables, layout)
    want = _module_chain(*args)
    with torch.no_grad():
        ref = qkr.qk_norm_rotary_reference(*args)
        wrapped = qkr.qk_norm_rotary(*args)      # the CPU runs the plain one
    for w, r, o in zip(want, ref, wrapped):
        assert r.dtype == BF16 and r.shape == (B, L, D // 64, 64)
        assert torch.equal(r, w) and torch.equal(o, w)


def _bad(case):
    q, k, qs, ks, cos, sin = _inputs(2, 8, 128, "shared", "qkv_views")
    if case == "float32":
        return (q.float(), k.float(), qs, ks, cos, sin), "bfloat16"
    if case == "head_dim":
        return (q, k, qs, ks, *rotary_tables(8, 32)), "Dh=64"
    if case == "k_shape":
        return (q, k[:, :4], qs, ks, cos, sin), "share one"
    if case == "table_length":
        return (q, k, qs, ks, *rotary_tables(4, 64)), "cos/sin must be"
    if case == "table_rows":
        c, s = rotary_tables(8, 64, positions=torch.zeros(3, 8))
        return (q, k, qs, ks, c, s), "cos/sin must be"
    if case == "scale":
        return (q, k, qs[:64], ks, cos, sin), "scales"
    if case == "width":
        x = torch.zeros(2, 8, 96, dtype=BF16)
        return (x, x, qs[:96], ks[:96], cos, sin), "multiple of 64"
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["float32", "head_dim", "k_shape",
                                  "table_length", "table_rows", "scale",
                                  "width"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    args, match = _bad(case)
    with pytest.raises(ValueError, match=match):
        qkr.qk_norm_rotary(*args)


@pytest.fixture
def calls(monkeypatch):
    """Patch the op to record each call and run the plain version."""
    seen = []

    def record(q, *rest):
        seen.append(tuple(q.shape))
        return qkr.qk_norm_rotary_reference(q, *rest)

    monkeypatch.setattr(qkr, "qk_norm_rotary", record)
    return seen


def _trunk(**kw):
    cfg = esm3_tiny(d_model=128, n_heads=2, n_layers=3,
                    head_type="structure", **kw)
    trunk = ESM3(cfg)
    tl.init_params(trunk, torch.Generator().manual_seed(0))
    return trunk


def test_trunk_calls_it_once_a_layer(calls):
    trunk = _trunk()
    B, L = 4, 16
    seq = torch.randint(4, 24, (B, L), generator=torch.Generator().manual_seed(1))
    lengths = torch.tensor([16, 9, 1, 12], dtype=torch.int32)
    with torch.no_grad():
        trunk(sequence_tokens=seq, lengths=lengths)          # prefix lengths
        assert calls == [(B, L, 128)] * 3
        calls.clear()
        trunk(sequence_tokens=seq.reshape(B // 2, 2 * L),    # packed rows
              sequence_id=packed_segment_ids(lengths, L, 2),
              positions=packed_positions(L, 2))
        assert calls == [(B // 2, 2 * L, 128)] * 3


def test_decoder_calls_it_once_a_layer(calls):
    dec = StructureTokenDecoder(DecoderConfig(d_model=128, n_heads=2,
                                              n_layers=2))
    tl.init_params(dec, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, 4096, (2, 10),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        dec(tokens, lengths=torch.tensor([10, 7]))
    assert calls == [(2, 10, 128)] * 2


class _OneRankTp:
    """What ``parallel.tp`` gives the attention, for one rank without a
    process group."""
    size = 1

    def copy(self, x):
        return x

    def reduce(self, x):
        return x

    def layer_norm(self, x, scale=None, eps=1e-5):
        return F.layer_norm(x.float(), (x.shape[-1],), scale.float(), None,
                            eps).to(x.dtype)


def _attention(attn_backend="auto", qkv_backend="xla", dtype=BF16):
    mha = tl.MultiHeadAttention(128, 2, dtype=dtype, attn_backend=attn_backend,
                                qkv_backend=qkv_backend)
    tl.init_params(mha, torch.Generator().manual_seed(0))
    x = torch.randn(2, 8, 128, generator=torch.Generator().manual_seed(1))
    return mha, x.to(dtype), *rotary_tables(8, 64)


@pytest.mark.parametrize("case", ["enable_grad", "tp", "fused", "small",
                                  "float32", "head_dim_16"])
def test_attention_keeps_the_chain_elsewhere(calls, case):
    """Autograd (training has no backward for the kernel), tensor-parallel
    q/k LayerNorm (statistics over ranks), the fused QKV kernel (which
    normalises), the small-attention kernel (which rotates), float32 and
    heads other than 64 keep today's code."""
    mha, x, cos, sin = _attention(
        attn_backend="small" if case == "small" else "auto",
        qkv_backend="fused" if case == "fused" else "xla",
        dtype=torch.float32 if case == "float32" else BF16)
    if case == "tp":
        mha.tp = _OneRankTp()
    if case == "head_dim_16":
        mha = tl.MultiHeadAttention(128, 8, dtype=BF16)
        tl.init_params(mha, torch.Generator().manual_seed(0))
        cos, sin = rotary_tables(8, 16)
    with torch.set_grad_enabled(case == "enable_grad"):
        out = mha(x, cos, sin)
    assert out.shape == x.shape and calls == []


@pytest.mark.parametrize("mask", ["none", "lengths", "packed"])
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_block_output_is_unchanged(calls, mask, quant):
    """A bf16 block under no_grad (through the op) equals the same block
    with grad mode on (today's chain) bit for bit on the CPU."""
    cfg = esm3_tiny(d_model=128, n_heads=2, n_layers=2)
    block = TransformerBlock(cfg)
    tl.init_params(block, torch.Generator().manual_seed(0))
    if quant == "int8":    # QuantDense returns bf16: the op takes it too
        state = quantize_trunk_params(block.state_dict())
        block = TransformerBlock(esm3_tiny(d_model=128, n_heads=2,
                                           n_layers=2, quant=quant))
        block.load_state_dict(state)
    tl.cast_matmul_weights(block)
    B, L = 4, 12
    x = torch.randn(B, L, 128, generator=torch.Generator().manual_seed(2))
    x = x.to(BF16)
    kw, cos, sin = {}, *rotary_tables(L, 64)
    if mask == "lengths":
        kw["lengths"] = torch.tensor([12, 5, 1, 9], dtype=torch.int32)
    elif mask == "packed":
        ids = packed_segment_ids(torch.tensor([6, 5, 1, 6, 3, 6, 6, 2]),
                                 L // 2, 2)
        kw["mask"] = (ids[:, None, :] == ids[:, :, None])[:, None]
        pos = torch.stack([packed_positions(L // 2, 2),
                           packed_positions(L, 1)] * 2)
        cos, sin = rotary_tables(L, 64, positions=pos)
    with torch.no_grad():
        fused = block(x, cos, sin, skip_geom=True, **kw)
    assert len(calls) == 1
    block.requires_grad_(False)   # int8's dequant refuses a recorded graph
    with torch.enable_grad():
        chain = block(x, cos, sin, skip_geom=True, **kw)
    assert len(calls) == 1
    assert torch.equal(fused, chain)
