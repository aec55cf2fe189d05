"""SDAR on the port (``models/sdar.py``, ``nn/moe.py``, ``convert/sdar.py``,
``diffusion/block.py``, ``EnsembleSampler.block_ensemble``, ``--mode
block``) against the plain float32 reference ``tests/sdar_reference.py``,
at the tiny widths (d 64, 4 query and 2 KV heads of 16, 8 experts top 2,
2 layers, vocabulary 4,200) on seeded weights in the published layout.

Tolerances: the port in float32 against the reference differs only in the
order of its float32 sums (the grouped products, SDPA, the cache's
concatenation), so 1e-5 relative.  In bf16 the port rounds every
product's inputs and outputs (8 bits: 0.4% a rounding), so each stage,
computed from the port's own input to it, is held to 2e-2; whole bf16
forwards are not compared, because a token whose 2nd and 3rd router
probabilities lie within the rounding takes another expert and moves its
logits by far more than the rounding.
"""

import dataclasses

import numpy as np
import pytest
import torch

import sdar_reference as ref
from esmdiff_tpu_torch.api.generation import EnsembleSampler, plan_batches
from esmdiff_tpu_torch.api.protein_api import ESM3Runtime
from esmdiff_tpu_torch.cli import sample as cli
from esmdiff_tpu_torch.convert import sdar as conv
from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.diffusion import block as blk
from esmdiff_tpu_torch.diffusion.gibbs import RowGeneratorUniform
from esmdiff_tpu_torch.models.sdar import (SDAR, SEQUENCE_OFFSET, Pass,
                                           SDARConfig, block_causal_mask)
from esmdiff_tpu_torch.models.vqvae import (DecoderConfig,
                                            StructureTokenDecoder)
from esmdiff_tpu_torch.nn import moe as moe_mod
from esmdiff_tpu_torch.nn.layers import init_params
from esmdiff_tpu_torch.nn.rotary import rotary_tables
from esmdiff_tpu_torch.utils import tracing

torch.set_num_threads(2)
F32 = 1e-5      # float32 against float32: summation order only
BF16 = 2e-2     # a bf16 stage from its own input: a few 8-bit roundings


def published(cfg: SDARConfig, seed: int = 0) -> dict:
    """Seeded float32 weights under the published names: products
    N(0, 1/fan_in), embeddings N(0, 1), norms 1 + 0.1 N(0, 1)."""
    g = torch.Generator().manual_seed(seed)
    d, dh, i = cfg.hidden_size, cfg.head_dim, cfg.moe_intermediate_size
    h, kv = cfg.num_attention_heads, cfg.num_key_value_heads
    shape = {"q_proj": (h * dh, d), "k_proj": (kv * dh, d),
             "v_proj": (kv * dh, d), "o_proj": (d, h * dh),
             "q_norm": (dh,), "k_norm": (dh,), "mlp.gate.": (cfg.num_experts,
                                                            d),
             "down_proj": (d, i), "gate_proj": (i, d), "up_proj": (i, d),
             "layernorm": (d,), "model.norm": (d,),
             "embed_tokens": (cfg.vocab_size, d),
             "lm_head": (cfg.vocab_size, d)}
    out = {}
    for k in conv.published_keys(cfg):
        s = next(v for part, v in shape.items() if part in k)
        x = torch.randn(s, generator=g)
        if len(s) == 1:
            x = 1.0 + 0.1 * x
        elif "embed_tokens" not in k:
            x = x * s[1] ** -0.5
        out[k] = x
    return out


def model(cfg: SDARConfig, W: dict) -> SDAR:
    m = SDAR(cfg).eval()
    conv.load(m, W)
    return m


def rows(B=3, P=7, n=10, seed=1):
    g = torch.Generator().manual_seed(seed)
    prompt = SEQUENCE_OFFSET + torch.randint(0, 33, (B, P), generator=g)
    struct = torch.randint(0, 4096, (B, n), generator=g)
    block_ids = torch.cat([torch.zeros(P, dtype=torch.long),
                           1 + torch.arange(n) // 4])
    return prompt, struct, block_ids


def rel(a, b):
    return float((a.float() - b).norm() / b.norm())


def test_full_forward_matches_reference():
    cfg = SDARConfig.tiny(dtype="float32")
    W = published(cfg)
    prompt, struct, block_ids = rows()
    tokens = torch.cat([prompt, struct], dim=1)
    with torch.no_grad():
        got = model(cfg, W).forward_full(tokens, block_ids)
    want = ref.forward(W, dataclasses.asdict(cfg), tokens, block_ids)
    assert rel(got, want) < F32


def test_bf16_stages_match_reference():
    """The bf16 port layer by layer: the embedding, each attention and
    MoE output and the head, each from the port's own input to it."""
    cfg = SDARConfig.tiny()
    W = published(cfg)
    m = model(cfg, W)
    c = dataclasses.asdict(cfg)
    prompt, struct, block_ids = rows()
    tokens = torch.cat([prompt, struct], dim=1)
    n = tokens.shape[1]
    cos, sin = rotary_tables(n, 16, base=cfg.rope_theta,
                             positions=torch.arange(n))
    rc, rs = ref.rope(torch.arange(n), 16, cfg.rope_theta)
    mask = block_causal_mask(block_ids)
    fw = Pass(cos, sin, torch.arange(n), mask=mask)
    with torch.no_grad():
        x = m.embed_tokens(tokens)
        assert rel(x, W["model.embed_tokens.weight"][tokens]) < BF16
        for i, layer in enumerate(m.layers):
            p = f"model.layers.{i}."
            a = layer.self_attn(layer.input_layernorm(x), fw, i)
            assert rel(a, ref.attention(W, p, ref.rms_norm(
                x.float(), W[p + "input_layernorm.weight"], 1e-6), rc, rs,
                mask, c)) < BF16
            h = x + a
            y = layer.mlp(layer.post_attention_layernorm(h))
            assert rel(y, ref.moe(W, p, ref.rms_norm(
                h.float(), W[p + "post_attention_layernorm.weight"], 1e-6),
                c)) < BF16
            x = h + y
        assert rel(m.lm_head(m.norm(x)), ref.rms_norm(
            x.float(), W["model.norm.weight"], 1e-6)
            @ W["lm_head.weight"].T) < BF16


def test_cache_path_matches_cacheless_forward():
    """Prefill, then for each block a step against the cache (logits) and
    a commit that writes it: each block's logits equal the reference's
    full block-causal forward over the same tokens."""
    tol = F32
    cfg = SDARConfig.tiny(dtype="float32")
    W = published(cfg)
    m = model(cfg, W)
    prompt, struct, block_ids = rows()
    P, n = prompt.shape[1], struct.shape[1]
    want = ref.forward(W, dataclasses.asdict(cfg),
                       torch.cat([prompt, struct], dim=1), block_ids)
    cache = m.new_cache(prompt.shape[0], 32)
    with torch.no_grad():
        m.prefill(prompt, cache)
        for b0 in range(0, n, 4):
            x = struct[:, b0:b0 + 4]
            got = m.block(x, P + b0, cache)
            assert rel(got, want[:, P + b0:P + b0 + x.shape[1]]) < tol
            # a short block padded to the full width, its pad masked out
            pad = torch.cat([x, torch.full((3, 4 - x.shape[1]), 4096)], 1)
            got = m.block(pad, P + b0, cache, valid=x.shape[1])
            assert rel(got[:, :x.shape[1]],
                       want[:, P + b0:P + b0 + x.shape[1]]) < tol
            m.block(pad, P + b0, cache, write=True, head=False,
                    valid=x.shape[1])


def test_a_step_leaves_the_cache_alone():
    cfg = SDARConfig.tiny(dtype="float32")
    m = model(cfg, published(cfg))
    prompt, struct, _ = rows()
    cache = m.new_cache(3, 17)
    with torch.no_grad():
        m.prefill(prompt, cache)
        before = (cache.k.clone(), cache.v.clone())
        m.block(struct[:, :4], 7, cache)
        assert torch.equal(cache.k, before[0])
        assert torch.equal(cache.v, before[1])
        m.block(struct[:, :4], 7, cache, write=True, head=False)
    assert torch.equal(cache.k[:, :, :, :7], before[0][:, :, :, :7])
    assert not torch.equal(cache.k[:, :, :, 7:11], before[0][:, :, :, 7:11])


def test_block_causal_mask():
    ids = torch.tensor([0, 0, 1, 1, 2])
    mask = block_causal_mask(ids)
    assert mask[0, 1] and not mask[0, 2] and mask[2, 1] and mask[3, 2]
    assert mask[4].all() and not mask[2, 4]


@pytest.mark.parametrize("top_k,renorm", [(2, True), (2, False), (8, True)])
def test_moe_layer_matches_reference(top_k, renorm):
    """The MoE block alone; top 8 of 8 routes every token to every
    expert, and without renormalisation the weights are the raw p."""
    cfg = SDARConfig.tiny(dtype="float32", num_experts_per_tok=top_k,
                          norm_topk_prob=renorm)
    W = published(cfg)
    m = model(cfg, W)
    x = torch.randn(5, 6, cfg.hidden_size, generator=torch.Generator()
                    .manual_seed(3))
    with torch.no_grad():
        got = m.layers[1].mlp(x)
    want = ref.moe(W, "model.layers.1.", x, dataclasses.asdict(cfg))
    assert rel(got, want) < F32
    w, ids = m.layers[1].mlp.gate(x.reshape(-1, cfg.hidden_size))
    assert ids.unique().numel() == cfg.num_experts or top_k < 8
    if renorm:
        torch.testing.assert_close(w.sum(-1), torch.ones(30))


def test_grouped_product_handles_empty_experts():
    """Experts with no token are skipped: the CPU loop over the offsets."""
    x = torch.randn(5, 4)
    w = torch.randn(3, 6, 4)
    counts = [2, 0, 3]
    offs = torch.tensor([2, 2, 5], dtype=torch.int32)
    got = moe_mod.grouped_mm(x, w, offs, counts)
    want = torch.cat([x[:2] @ w[0].T, x[2:] @ w[2].T])
    torch.testing.assert_close(got, want)


@torch.no_grad()
def test_forwards_keep_their_logits_and_routes():
    """A step leaves its logits over the codes and every layer's expert
    ids in ``BlockForwards``' buffers, and a commit its ids: what a
    caller reads after a replay."""
    cfg = SDARConfig.tiny(dtype="float32")
    m = model(cfg, published(cfg))
    prompt, _, _ = rows(B=2, P=5)
    fw = blk.BlockForwards(m, 2, 16, 4, 1.0)
    m.prefill(prompt, fw.cache)
    fw.start.fill_(5)
    fw.u.uniform_(generator=torch.Generator().manual_seed(3))
    seen = {}
    hooks = [layer.mlp.gate.register_forward_hook(
        lambda mod, a, o, i=i: seen.__setitem__(i, o[1].view(2, 4, -1)))
        for i, layer in enumerate(m.layers)]
    x = fw.x.clone()
    fw.run("step")
    for i in range(cfg.num_hidden_layers):
        assert torch.equal(fw.routes[i].long(), seen[i])
    fw.run("commit")
    for i in range(cfg.num_hidden_layers):
        assert torch.equal(fw.routes[i].long(), seen[i])
    for h in hooks:
        h.remove()
    want = m.block(x, 5, fw.cache)[..., :4096]
    torch.testing.assert_close(fw.logits, want, rtol=0, atol=0)
    assert (fw.x != x).sum() == 2           # one position a row


def test_converter_is_strict():
    cfg = SDARConfig.tiny(dtype="float32")
    W = published(cfg)
    m = model(cfg, W)
    e = m.layers[0].mlp.experts
    assert torch.equal(e.w_gate_up[3, :32],
                       W["model.layers.0.mlp.experts.3.gate_proj.weight"])
    assert torch.equal(e.w_gate_up[3, 32:],
                       W["model.layers.0.mlp.experts.3.up_proj.weight"])
    assert torch.equal(e.w_down[5],
                       W["model.layers.0.mlp.experts.5.down_proj.weight"])
    assert torch.equal(m.layers[1].self_attn.k_norm.weight,
                       W["model.layers.1.self_attn.k_norm.weight"])
    qkv = m.layers[1].self_attn.qkv_proj.weight
    assert torch.equal(qkv[64:96], W["model.layers.1.self_attn.k_proj.weight"])
    assert torch.equal(qkv[96:], W["model.layers.1.self_attn.v_proj.weight"])
    missing = dict(W)
    missing.pop("model.layers.1.mlp.experts.7.up_proj.weight")
    with pytest.raises(KeyError):
        conv.load(SDAR(cfg), missing)
    with pytest.raises(KeyError):
        conv.load(SDAR(cfg), {**W, "model.layers.2.mlp.gate.weight":
                              W["model.layers.1.mlp.gate.weight"]})
    with pytest.raises(ValueError):
        conv.load(SDAR(cfg), {**W, "lm_head.weight": W["lm_head.weight"][:9]})
    # one layer at a time, as the benchmark fills the full model
    part = SDAR(cfg)
    conv.load(part, {k: v for k, v in W.items()
                     if not k.startswith("model.layers.")}, layers=[])
    for i in range(2):
        conv.load(part, {k: v for k, v in W.items()
                         if k.startswith(f"model.layers.{i}.")},
                  layers=[i], top=False)
    for (name, a), b in zip(m.state_dict().items(),
                            part.state_dict().values()):
        assert torch.equal(a, b), name


def test_step_quotas():
    assert blk.step_quotas(4, 4) == [1, 1, 1, 1]
    assert blk.step_quotas(3, 4) == [1, 1, 1]
    assert blk.step_quotas(4, 2) == [2, 2]
    assert blk.step_quotas(5, 3) == [2, 2, 1]


class Recorder:
    """Each step forward's input block and logits (module hooks), and the
    draws each step took."""

    def __init__(self, m, uniforms):
        self.uniforms, self.steps, self.draws = uniforms, [], []
        self.x = None
        m.embed_tokens.register_forward_pre_hook(self._tokens)
        m.lm_head.register_forward_hook(self._logits)

    def _tokens(self, module, args):
        self.x = args[0].clone()

    def _logits(self, module, args, out):
        self.steps.append((self.x, out.float().clone()))

    def draw(self, step):
        u = self.uniforms(step)
        self.draws.append(u.clone())
        return u


def test_block_sampler_follows_the_reference_rule():
    """Every step's committed tokens equal the reference's update given
    the same logits and uniforms; each step commits one position; the
    returned tokens are the blocks as committed (a short last block runs
    padded to the block width, its pad never committed)."""
    cfg = SDARConfig.tiny(dtype="float32")
    m = model(cfg, published(cfg))
    prompt, _, _ = rows()
    n = 10
    rec = Recorder(m, RowGeneratorUniform([5, 6, 7], 4, 4096, "cpu"))
    out = blk.block_sample(m, prompt, n, rec.draw, temperature=1.0)
    steps = rec.steps
    assert len(steps) == 10 == len(rec.draws)
    ones = torch.ones(3, dtype=torch.long)
    i, finals = 0, []
    for b0 in range(0, n, 4):
        width = min(4, n - b0)
        for s in range(width):
            x, z = steps[i]
            x, z = x[:, :width], z[:, :width]
            nxt = ref.block_update(x, z, rec.draws[i][:, :width], ones)
            masked = (x == C.STRUCTURE_MASK_TOKEN).sum(-1)
            assert ((nxt == C.STRUCTURE_MASK_TOKEN).sum(-1)
                    == masked - 1).all()
            if s + 1 < width:
                assert torch.equal(nxt, steps[i + 1][0][:, :width])
            else:
                finals.append(nxt)
            i += 1
    assert torch.equal(torch.cat(finals, dim=1), out)
    assert not (out == C.STRUCTURE_MASK_TOKEN).any()


def tiny_runtime(dtype="float32"):
    cfg = SDARConfig.tiny(dtype=dtype)
    m = model(cfg, published(cfg))
    dec = StructureTokenDecoder(DecoderConfig(d_model=64, n_heads=2,
                                              n_layers=2, dtype="float32"))
    init_params(dec, torch.Generator().manual_seed(0))
    return ESM3Runtime(m, dec, None, device="cpu")


def test_block_ensemble_through_the_planner_and_decode(traced):
    """``block_ensemble`` plans its rows (``plan_batches``), gives each
    row its own draws (so a row samples alike in any batch), returns
    interior tokens that the VQ decode takes; the spans and counters."""
    rt = tiny_runtime()
    seq = "MKTAYIAKQ"
    whole = EnsembleSampler(rt, plan_policy="even").block_ensemble(
        seq, 5, seed=3)
    split = EnsembleSampler(rt, plan_policy="single").block_ensemble(
        seq, 5, seed=3, max_batch=2)
    assert whole.shape == (5, 9) and whole.dtype == np.int32
    np.testing.assert_array_equal(whole, split)
    assert whole.max() < 4096
    prots = EnsembleSampler(rt).decode_ensemble(seq, whole)
    assert len(prots) == 5 and np.isfinite(
        prots[0].coordinates[:, :3]).all()
    rec = tracing.records(traced)
    names = {s["name"] for s in rec["spans"]}
    assert {"sample.request", "block.prefill", "block.step", "block.commit",
            "block.draws", "moe.route", "moe.experts",
            "sdar.attend"} <= names
    c = rec["counters"]
    # 9 positions: blocks of 4, 4, 1 -> 1 prefill + (4+1) + (4+1) + (1+1)
    forwards = 1 + 5 + 5 + 2
    assert c["block.forwards"] == forwards + 3 * forwards   # [5]; [2, 2, 2]
    assert c["moe.tokens_routed"] > 0 and c["moe.experts_hit"] > 0
    assert c["kv.positions_read"] > 0


@pytest.fixture
def traced():
    tracing.enable(True)
    try:
        yield tracing.mark()
    finally:
        tracing.enable(False)


def test_counts_of_one_batch(traced):
    cfg = SDARConfig.tiny(dtype="float32")
    m = model(cfg, published(cfg))
    prompt, _, _ = rows(B=2, P=5)
    blk.block_sample(m, prompt, 4, RowGeneratorUniform([1, 2], 4, 4096,
                                                       "cpu"))
    c = tracing.records(traced)["counters"]
    assert c["block.forwards"] == 1 + 4 + 1
    # (prefill 5 + 5 forwards x 4 positions) x rows x k, each layer
    assert c["moe.tokens_routed"] == (5 + 5 * 4) * 2 * 2 * 2
    # steps and the commit read the 5 prompt positions, each layer and row
    assert c["kv.positions_read"] == 5 * 5 * 2 * 2
    assert 1 <= c["moe.experts_hit"] <= 6 * 2 * 8


def test_even_plan():
    assert plan_batches(128, 100, max_batch=128, policy="even") == [100]
    assert plan_batches(128, 200, max_batch=128, policy="even") == [100, 100]
    assert plan_batches(128, 100, max_batch=64, policy="even") == [50, 50]
    assert plan_batches(128, 1, policy="even") == [1]


def test_cli_block_mode_writes_a_pdb(tmp_path):
    out = tmp_path / "out"
    cli.main(["--input", "data/targets/bpti", "--output", str(out),
              "--mode", "block", "--num_steps", "4", "--num_samples", "3",
              "--model_scale", "tiny", "--device", "cpu",
              "--temperature", "1.0", "--plan", "even"])
    text = (out / "bpti.pdb").read_text()
    assert text.count("MODEL ") == 3
    with pytest.raises(SystemExit):
        cli.main(["--input", "data/targets/bpti", "--output", str(out),
                  "--mode", "block", "--ckpt", str(tmp_path),
                  "--model_scale", "tiny", "--device", "cpu"])


@pytest.mark.cuda
def test_grouped_product_on_the_card_matches_the_loop():
    """``torch._grouped_mm`` (the card's path) against the CPU loop, at
    the published widths of one layer's gate and up."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(0)
    counts = [int(c) for c in torch.randint(0, 40, (128,))]
    counts[5] = 0
    x = torch.randn(sum(counts), 2048, device="cuda", generator=g,
                    dtype=torch.bfloat16)
    w = torch.randn(128, 1536, 2048, device="cuda", generator=g,
                    dtype=torch.bfloat16) * 2048 ** -0.5
    offs = torch.tensor(np.cumsum(counts), dtype=torch.int32, device="cuda")
    got = moe_mod.grouped_mm(x, w, offs).float()
    want = moe_mod.grouped_mm(x.cpu().float(), w.cpu().float(), None,
                              counts).cuda()
    assert rel(got, want) < 5e-3


@pytest.mark.cuda
def test_graphed_block_sampler_equals_eager_on_the_card():
    """The step and commit replayed as CUDA graphs give the tokens the
    same forwards give run eagerly (the same kernels on the same
    buffers), a short last block included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = SDARConfig.tiny()
    with torch.device("cuda"):
        m = SDAR(cfg).eval()
    conv.load(m, {k: v.cuda() for k, v in published(cfg).items()})
    prompt, _, _ = rows(B=8, P=9)
    prompt = prompt.cuda()
    out, held = {}, {}
    for graphs in (True, False, True):
        draws = RowGeneratorUniform(list(range(8)), 4, 4096, "cuda")
        out.setdefault(graphs, []).append(blk.block_sample(
            m, prompt, 14, draws, graphs=graphs, held=held).cpu())
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][0])
    assert next(iter(held.values())).graphs is not None


@pytest.mark.cuda
def test_cached_attention_on_the_card_matches_float32():
    """The card's bf16 block attention (float32 scores from bf16 inputs)
    against the same arithmetic on float32 copies: within bf16's
    rounding of the weighted sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from esmdiff_tpu_torch.models.sdar import cached_attention

    g = torch.Generator(device="cuda").manual_seed(1)

    def r(*shape):
        return torch.randn(*shape, device="cuda", generator=g,
                           dtype=torch.bfloat16)

    q, k, v = r(16, 4, 32, 128), r(16, 4, 4, 128), r(16, 4, 4, 128)
    kc, vc = r(16, 4, 256, 128), r(16, 4, 256, 128)
    start = torch.tensor(200, device="cuda")
    valid = torch.tensor(3, device="cuda")
    got = cached_attention(q, k, v, kc, vc, start, valid).float()
    want = cached_attention(*(t.float() for t in (q, k, v, kc, vc)),
                            start, valid)
    assert rel(got, want) < 1e-2
