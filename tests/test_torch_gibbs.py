"""The port's gibbs and eb samplers (``esmdiff_tpu_torch/diffusion/gibbs.py``)
and the stock multi-track head against the JAX package, on the CPU in
float32: the primitives on the same inputs, both samplers on a tiny trunk
with JAX's uniforms injected, and ``tests/golden/tiny_mdlm.npz``'s
trajectories reproduced exactly."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esmdiff_tpu.core import constants as C
from esmdiff_tpu.diffusion import gibbs as jg
from esmdiff_tpu.models import esm3 as jesm3
from esmdiff_tpu_torch.diffusion import gibbs as tg
from esmdiff_tpu_torch.models import esm3 as tesm3
from test_torch_support import carry, jax_unmask_uniforms, perturb, to_np

torch.set_num_threads(2)

GOLDEN = Path(__file__).parent / "golden" / "tiny_mdlm.npz"


def _jax_trunk_params(cfg, seed=0, L=8):
    """flax params of a JAX ESM3 (geometric attention's too, as
    ``MDLM.init`` makes them), moved off their init values."""
    seq = jnp.full((1, L), C.SEQUENCE_MASK_TOKEN, jnp.int32)
    coords = jnp.zeros((1, L, 3, 3), jnp.float32)
    params = jesm3.ESM3(cfg).init(jax.random.PRNGKey(seed),
                                  sequence_tokens=seq,
                                  structure_coords=coords)["params"]
    return perturb(params, seed + 1, 0.05)


def _rows(B, L, lengths, rng, prefill=0.0):
    """Sequence rows (BOS, residues, EOS, PAD), initial structure tokens
    (MASK on valid positions, a ``prefill`` share of interior positions
    already holding a code, PAD past the length) and the decode mask (the
    interior of each row)."""
    seq = np.full((B, L), C.SEQUENCE_PAD_TOKEN, np.int32)
    init = np.full((B, L), C.STRUCTURE_PAD_TOKEN, np.int32)
    dmask = np.zeros((B, L), bool)
    for b, n in enumerate(lengths):
        seq[b, 0], seq[b, n - 1] = C.SEQUENCE_BOS_TOKEN, C.SEQUENCE_EOS_TOKEN
        seq[b, 1:n - 1] = rng.integers(4, 24, n - 2)
        init[b, :n] = C.STRUCTURE_MASK_TOKEN
        known = rng.random(n - 2) < prefill
        init[b, 1:n - 1][known] = rng.integers(0, 4096, known.sum())
        dmask[b, 1:n - 1] = True
    return seq, init, dmask


# -- the stock head -----------------------------------------------------------

def test_stock_heads_match_flax():
    """``head_type="esm3"``: every ``OutputHeads`` output (and the
    embeddings) against flax at 1e-4 after a strict carry-over of the
    stock heads' flax names."""
    jcfg = jesm3.esm3_tiny(dtype="float32", head_type="esm3")
    params = _jax_trunk_params(jcfg)
    assert {"function_head", "sequence_head", "structure_head", "ss8_head",
            "sasa_head", "residue_head"} <= set(params["output_heads"])
    trunk = carry(tesm3.ESM3(tesm3.esm3_tiny(dtype="float32",
                                             head_type="esm3")), params)
    rng = np.random.default_rng(0)
    B, L = 3, 20
    lengths = np.array([20, 13, 7], np.int32)
    seq, _, _ = _rows(B, L, lengths, rng)
    st = rng.integers(0, 4096, (B, L)).astype(np.int32)
    st[:, ::4] = C.STRUCTURE_MASK_TOKEN
    ref = jesm3.ESM3(jcfg).apply(
        {"params": params}, structure_tokens=jnp.asarray(st),
        sequence_tokens=jnp.asarray(seq), lengths=jnp.asarray(lengths))
    with torch.no_grad():
        out = trunk(structure_tokens=torch.from_numpy(st).long(),
                    sequence_tokens=torch.from_numpy(seq).long(),
                    lengths=torch.from_numpy(lengths))
    assert out.structure_logits.shape[-1] == C.VQVAE_CODEBOOK_SIZE
    assert out.function_logits.shape == (B, L, C.FUNCTION_TOKEN_DEPTH,
                                         C.FUNCTION_VOCAB_SIZE)
    for name in out._fields:
        got, want = to_np(getattr(out, name)), np.asarray(getattr(ref, name))
        assert got.shape == want.shape, name
        for b, n in enumerate(lengths):
            np.testing.assert_allclose(got[b, :n], want[b, :n], atol=1e-4,
                                       rtol=1e-4, err_msg=name)


# -- the primitives -----------------------------------------------------------

def _tied_logits(seed, shape=(4, 16, 300)):
    """Logits on a 0.1 grid, with a run of equal values in every row."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal(shape) * 3.0, 1).astype(np.float32)
    x[..., 10:20] = x[..., 5:6]
    return x


@pytest.mark.parametrize("exact", [False, True], ids=["bisection", "sort"])
@pytest.mark.parametrize("top_p", [0.5, 0.9])
def test_top_p_filter_matches_jax(top_p, exact):
    for seed in range(4):
        x = _tied_logits(seed)
        ref = np.asarray(jg.top_p_filter(jnp.asarray(x), top_p, exact=exact))
        got = to_np(tg.top_p_filter(torch.from_numpy(x), top_p, exact=exact))
        np.testing.assert_array_equal(got > -1e8, ref > -1e8)
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("exact", [False, True], ids=["bisection", "sort"])
def test_top_p_one_matches_jax_up_to_rounding(exact):
    """At top_p 1.0 the nucleus is the whole vocabulary, and what either
    implementation drops is decided by float32 rounding alone: in some
    rows the (cumulative) sum of the probabilities rounds past 1.0, in an
    order that XLA's reductions and torch's do not share.  Held here: the
    kept sets differ only in such a rounding tail, a row's disagreeing
    tokens holding at most 1e-5 of its probability, and where they agree,
    the values are JAX's."""
    for seed in range(4):
        x = _tied_logits(seed)
        ref = np.asarray(jg.top_p_filter(jnp.asarray(x), 1.0, exact=exact))
        got = to_np(tg.top_p_filter(torch.from_numpy(x), 1.0, exact=exact))
        probs = np.asarray(jax.nn.softmax(jnp.asarray(x), axis=-1))
        differ = (got > -1e8) != (ref > -1e8)
        assert (probs * differ).sum(-1).max() <= 1e-5
        same = ~differ
        np.testing.assert_allclose(got[same], ref[same], atol=1e-6, rtol=0)


def test_select_top_by_confidence_matches_jax():
    rng = np.random.default_rng(0)
    B, L = 6, 40
    conf = np.round(rng.standard_normal((B, L)), 1).astype(np.float32)
    conf[1, :] = -0.5                      # a row of ties
    conf[2, 3:9] = conf[2, 2]              # a tied run
    eligible = rng.random((B, L)) < 0.6
    eligible[3] = False                    # an empty eligible row
    n_new = np.array([5, 7, 3, 4, 0, 40], np.int32)   # row 4: nothing
    ref = np.asarray(jg.select_top_by_confidence(
        jnp.asarray(conf), jnp.asarray(eligible), jnp.asarray(n_new)))
    got = to_np(tg.select_top_by_confidence(
        torch.from_numpy(conf), torch.from_numpy(eligible),
        torch.from_numpy(n_new)))
    np.testing.assert_array_equal(got, ref)
    assert not got[3].any() and not got[4].any() and got[1].sum() > 0


@pytest.mark.parametrize("num_steps", [4, 8, 16, 25])
def test_unmask_quotas_match_jax(num_steps):
    """ceil(schedule * n) for every n <= 1100, in float32 as JAX computes
    it (a 1-ulp difference of cos could move a quota)."""
    n = np.arange(1101, dtype=np.int32)
    ref = np.asarray(jnp.ceil(
        jg.cosine_unmask_schedule(num_steps)[None, :]
        * jnp.asarray(n)[:, None]).astype(jnp.int32))
    got = torch.ceil(tg.cosine_unmask_schedule(num_steps)[None, :]
                     * torch.from_numpy(n)[:, None].float()).long()
    np.testing.assert_array_equal(to_np(got), ref)


# -- both samplers on a tiny trunk --------------------------------------------

@pytest.fixture(scope="module")
def stock_trunks():
    jcfg = jesm3.esm3_tiny(dtype="float32", head_type="esm3")
    params = _jax_trunk_params(jcfg, seed=4)
    trunk = carry(tesm3.ESM3(tesm3.esm3_tiny(dtype="float32",
                                             head_type="esm3")), params)
    return jesm3.ESM3(jcfg), params, trunk


def _forwards(stock_trunks, seq, lengths):
    jnet, params, trunk = stock_trunks
    s, n = jnp.asarray(seq), jnp.asarray(lengths)
    ts, tn = torch.from_numpy(seq).long(), torch.from_numpy(lengths)

    def jfwd(tokens):
        return jnet.apply({"params": params}, structure_tokens=tokens,
                          sequence_tokens=s, lengths=n).structure_logits

    def tfwd(tokens):
        return trunk(structure_tokens=tokens, sequence_tokens=ts,
                     lengths=tn).structure_logits

    return jfwd, tfwd


@pytest.mark.parametrize("prefill", [0.0, 0.3])
def test_gibbs_sampler_matches_jax(stock_trunks, prefill):
    B, L = 3, 24
    lengths = np.array([24, 17, 9], np.int32)
    seq, init, dmask = _rows(B, L, lengths, np.random.default_rng(1), prefill)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(21), B))
    jfwd, tfwd = _forwards(stock_trunks, seq, lengths)
    ref = jg.iterative_unmask_sample(
        jfwd, None, jnp.asarray(init), jnp.asarray(dmask), num_steps=5,
        temperature=1.4, top_p=0.9, row_keys=jnp.asarray(keys))
    got = tg.iterative_unmask_sample(
        tfwd, jax_unmask_uniforms(keys, L, C.VQVAE_CODEBOOK_SIZE),
        torch.from_numpy(init), torch.from_numpy(dmask), num_steps=5,
        temperature=1.4, top_p=0.9)
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))
    # every decode position is committed; the rest is untouched
    assert (to_np(got)[dmask] < C.VQVAE_CODEBOOK_SIZE).all()
    np.testing.assert_array_equal(to_np(got)[~dmask], init[~dmask])


def _eb_pair(jfwd, tfwd, init, dmask, keys, L, V, **kw):
    ref, ref_steps = jg.entropy_bounded_unmask_sample(
        jfwd, None, jnp.asarray(init), jnp.asarray(dmask),
        row_keys=jnp.asarray(keys), **kw)
    got, steps = tg.entropy_bounded_unmask_sample(
        tfwd, jax_unmask_uniforms(keys, L, V), torch.from_numpy(init),
        torch.from_numpy(dmask), **kw)
    return np.asarray(ref), int(ref_steps), to_np(got), steps


def test_eb_sampler_matches_jax(stock_trunks):
    """A budget that commits several positions a step, with the top-p
    filter: tokens and the step count equal JAX's."""
    B, L = 3, 24
    lengths = np.array([24, 17, 9], np.int32)
    seq, init, dmask = _rows(B, L, lengths, np.random.default_rng(2), 0.2)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(23), B))
    ref, ref_steps, got, steps = _eb_pair(
        *_forwards(stock_trunks, seq, lengths), init, dmask, keys, L,
        C.VQVAE_CODEBOOK_SIZE, entropy_budget=40.0, temperature=1.2,
        top_p=0.9, max_steps=64)
    np.testing.assert_array_equal(got, ref)
    assert steps == ref_steps
    assert (got[dmask] < C.VQVAE_CODEBOOK_SIZE).all()


@pytest.mark.parametrize("max_steps", [64, 5])
def test_eb_one_commit_a_step_matches_jax(stock_trunks, max_steps):
    """A budget under every entropy (random weights: all near ln 4096):
    each step commits exactly one position a row, the lowest-entropy one,
    so the step count is the largest masked count (or ``max_steps``) and
    the committed count per row equals JAX's.  Which position that is can
    turn on a 1-ulp tie: two entropies of 7.774842 and 7.774841 in JAX
    swap their order in the port, so tokens are held exactly in
    ``test_eb_sampler_matches_jax_on_table_logits``, where the entropies
    are apart."""
    B, L = 3, 24
    lengths = np.array([24, 17, 9], np.int32)
    seq, init, dmask = _rows(B, L, lengths, np.random.default_rng(2), 0.2)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(23), B))
    ref, ref_steps, got, steps = _eb_pair(
        *_forwards(stock_trunks, seq, lengths), init, dmask, keys, L,
        C.VQVAE_CODEBOOK_SIZE, entropy_budget=1.0, temperature=1.2,
        top_p=1.0, max_steps=max_steps)
    masked = (dmask & (init == C.STRUCTURE_MASK_TOKEN)).sum(-1)
    assert steps == ref_steps == min(max_steps, int(masked.max()))
    committed = ((got != C.STRUCTURE_MASK_TOKEN) & dmask).sum(-1)
    ref_committed = ((ref != C.STRUCTURE_MASK_TOKEN) & dmask).sum(-1)
    np.testing.assert_array_equal(committed, ref_committed)
    np.testing.assert_array_equal(
        committed - (dmask & (init != C.STRUCTURE_MASK_TOKEN)).sum(-1),
        np.minimum(masked, steps))
    np.testing.assert_array_equal(got[~dmask], init[~dmask])


@pytest.mark.parametrize("budget,top_p,max_steps", [
    (1.0, 1.0, 64), (3.0, 0.9, 64), (1.0, 1.0, 4)])
def test_eb_sampler_matches_jax_on_table_logits(budget, top_p, max_steps):
    """Logits that both sides compute bit for bit from the state (a fixed
    table plus the row's committed count times another), with per-position
    sharpness from 0.3 to 20, so entropies lie apart: several positions
    commit in some steps, one in others, and the tokens and the step count
    equal JAX's exactly."""
    B, L, V = 3, 24, 64
    rng = np.random.default_rng(3)
    sharp = rng.uniform(0.3, 20.0, (B, L, 1)).astype(np.float32)
    base = (rng.standard_normal((B, L, V)) * sharp).astype(np.float32)
    drift = (0.3 * rng.standard_normal((B, L, V))).astype(np.float32)
    lengths = np.array([24, 17, 9], np.int32)
    _, init, dmask = _rows(B, L, lengths, rng, 0.2)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(29), B))
    jb, jd, tb, td = (jnp.asarray(base), jnp.asarray(drift),
                      torch.from_numpy(base), torch.from_numpy(drift))

    def jfwd(x):
        n = jnp.sum(x != C.STRUCTURE_MASK_TOKEN, axis=-1)
        return jb + n[:, None, None].astype(jnp.float32) * jd

    def tfwd(x):
        n = (x != C.STRUCTURE_MASK_TOKEN).sum(dim=-1)
        return tb + n[:, None, None].float() * td

    ref, ref_steps, got, steps = _eb_pair(
        jfwd, tfwd, init, dmask, keys, L, V, entropy_budget=budget,
        temperature=1.2, top_p=top_p, max_steps=max_steps)
    np.testing.assert_array_equal(got, ref)
    assert steps == ref_steps
    masked = (dmask & (init == C.STRUCTURE_MASK_TOKEN)).sum(-1)
    if max_steps == 64:
        assert steps < masked.max()      # some step committed several


# -- the golden file ----------------------------------------------------------

@pytest.fixture(scope="module")
def golden_model():
    """``tests/test_golden.py::_build``'s model (params from JAX's
    ``mdlm.init(PRNGKey(1234))``), carried over to the port, and its
    inputs."""
    from esmdiff_tpu.diffusion.mdlm import MDLM as JMDLM
    from esmdiff_tpu.diffusion.mdlm import MDLMConfig as JMDLMConfig
    from esmdiff_tpu.diffusion.noise import LogLinearNoise as JNoise
    from esmdiff_tpu.nn.layers import TimestepEmbedder as JTimestep
    from esmdiff_tpu_torch.diffusion.mdlm import MDLM
    from esmdiff_tpu_torch.nn.layers import TimestepEmbedder

    cfg = dict(dtype="float32", head_type="structure",
               n_structure_heads=C.STRUCTURE_VOCAB_SIZE)
    jcfg = jesm3.esm3_tiny(**cfg)
    jm = JMDLM(jesm3.ESM3(jcfg), JTimestep(hidden_size=jcfg.d_model,
                                           dtype=jnp.float32),
               noise=JNoise(), cfg=JMDLMConfig())
    params = jm.init(jax.random.PRNGKey(1234))
    mdlm = MDLM(carry(tesm3.ESM3(tesm3.esm3_tiny(**cfg)), params["net"]),
                carry(TimestepEmbedder(64, dtype=torch.float32),
                      params["sigma_embedder"]))
    B, L = 2, 12
    seq = torch.arange(B * L).reshape(B, L) % 20 + 4
    return mdlm, seq, np.load(GOLDEN)


def test_golden_logits_slice(golden_model):
    mdlm, seq, ref = golden_model
    B, L = seq.shape
    xt = (torch.arange(B * L).reshape(B, L) * 37) % 4096
    xt[:, ::3] = C.STRUCTURE_MASK_TOKEN
    with torch.no_grad():
        logits, _ = mdlm.forward_logits(
            xt, seq, torch.tensor([[0.3], [0.9]]), shield_specials=True,
            parameterize=True)
    np.testing.assert_allclose(to_np(logits[:, :4, :8]), ref["logits_slice"],
                               atol=1e-4, rtol=1e-4)


def _golden_forward(mdlm, seq):
    def fwd(tokens):
        return mdlm.forward_logits(tokens, seq, None, shield_specials=True,
                                   parameterize=True)[0]
    return fwd


def _golden_start(seq):
    B, L = seq.shape
    init = torch.full((B, L), C.STRUCTURE_MASK_TOKEN)
    dmask = torch.ones((B, L), dtype=torch.bool)
    dmask[:, 0] = dmask[:, -1] = False
    return init, dmask


def test_golden_gibbs_sample(golden_model):
    mdlm, seq, ref = golden_model
    B, L = seq.shape
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(11), B))
    got = tg.iterative_unmask_sample(
        _golden_forward(mdlm, seq),
        jax_unmask_uniforms(keys, L, C.STRUCTURE_VOCAB_SIZE),
        *_golden_start(seq), num_steps=4, temperature=1.4, top_p=0.9)
    np.testing.assert_array_equal(to_np(got), ref["gibbs_sample"])


def test_golden_eb_sample(golden_model):
    mdlm, seq, ref = golden_model
    B, L = seq.shape
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(13), B))
    got, steps = tg.entropy_bounded_unmask_sample(
        _golden_forward(mdlm, seq),
        jax_unmask_uniforms(keys, L, C.STRUCTURE_VOCAB_SIZE),
        *_golden_start(seq), entropy_budget=3.0, max_steps=16)
    np.testing.assert_array_equal(to_np(got), ref["eb_sample"])
    assert steps == int(ref["eb_steps"])


def test_row_generator_uniform():
    """The default source: (B, L, V) float32 in [0, 1), a row's draws a
    function of its seed alone (not of its batch neighbours)."""
    a = tg.RowGeneratorUniform([5, 6], 4, 10, "cpu")
    b = tg.RowGeneratorUniform([6], 4, 10, "cpu")
    u0, u1 = a(0), a(1)
    assert u0.shape == (2, 4, 10) and u0.dtype == torch.float32
    assert ((u0 >= 0) & (u0 < 1)).all() and not torch.equal(u0, u1)
    torch.testing.assert_close(b(0)[0], u0[1], rtol=0, atol=0)
