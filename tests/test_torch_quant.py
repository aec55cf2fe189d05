"""The port's W8A8 int8 path (``esmdiff_tpu_torch/ops/quant.py`` and the
``quant="int8"`` modules) against the JAX package's ``ops/quant.py``.

Counterpart of ``tests/test_quant.py``: the same numpy inputs (seeded) go
through both; weights travel from the JAX trees through
``esmdiff_tpu_torch.convert``.  Quantized weights and activations must be
equal bit for bit (both round half to even, both divide by the scale)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esmdiff_tpu.models import esm3 as jesm3
from esmdiff_tpu.ops import quant as jquant
from esmdiff_tpu_torch.api.protein_api import ESM3Runtime
from esmdiff_tpu_torch.cli import sample as cli
from esmdiff_tpu_torch.convert import load_flax_params
from esmdiff_tpu_torch.models import esm3 as tesm3
from esmdiff_tpu_torch.models.vqvae import DecoderConfig, EncoderConfig
from esmdiff_tpu_torch.nn.layers import MultiHeadAttention
from esmdiff_tpu_torch.ops import quant
from test_torch_support import carry, perturb, to_np

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("shape", [(32, 48), (4, 16, 24), (64, 1)])
def test_quantize_weight_matches_jax(shape):
    """JAX's (…, D, F) kernel and the port's (…, F, D) weight: equal int8
    values and scales (a leading layer axis quantizes per layer)."""
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    jq, js = jquant.quantize_weight(jnp.asarray(w))
    tq, ts = quant.quantize_weight(torch.from_numpy(np.swapaxes(w, -1, -2)))
    assert tq.dtype == torch.int8 and tuple(ts.shape) == js.shape
    np.testing.assert_array_equal(np.swapaxes(to_np(tq), -1, -2),
                                  np.asarray(jq))
    np.testing.assert_array_equal(to_np(ts), np.asarray(js))


@pytest.mark.parametrize("x_dtype,out_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"),
    ("float32", "bfloat16")])
def test_int8_dot_matches_jax(x_dtype, out_dtype):
    """int8 activations equal; outputs within 1 ulp of ``out_dtype``."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32) * 2.0
    w = (rng.standard_normal((64, 48)) * 0.05).astype(np.float32)
    jx = jnp.asarray(x, x_dtype)
    tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
    jq, js = jquant.quantize_weight(jnp.asarray(w))
    tq, ts = quant.quantize_weight(torch.from_numpy(w.T.copy()))

    x32 = jx.astype(jnp.float32)     # int8_dot's activation quantization
    sa = jnp.maximum(jnp.max(jnp.abs(x32), axis=-1, keepdims=True) / 127.0,
                     1e-12)
    j_xq = jnp.clip(jnp.round(x32 / sa), -127, 127).astype(jnp.int8)
    t_xq, t_sa = quant.quantize_activations(tx)
    np.testing.assert_array_equal(to_np(t_xq), np.asarray(j_xq))
    np.testing.assert_array_equal(to_np(t_sa), np.asarray(sa))

    ref = np.asarray(jquant.int8_dot(jx, jq, js,
                                     out_dtype=jnp.dtype(out_dtype)),
                     np.float32)
    out = to_np(quant.int8_dot(tx, tq, ts,
                               out_dtype=getattr(torch, out_dtype)).float())
    ulp = 2.0 ** (-7 if out_dtype == "bfloat16" else -23)
    np.testing.assert_array_less(np.abs(out - ref),
                                 np.abs(ref) * ulp + 1e-30)


def test_int8_product_is_exact():
    """The plain product is the exact int32 product, at the largest
    magnitude the trunk's widest contraction (H 4096) can reach."""
    kq = torch.full((8, 4096), -127, dtype=torch.int8)
    xq = torch.full((3, 4096), 127, dtype=torch.int8)
    xq[1, ::2] = -127
    o = quant.int8_mm(xq, kq)
    assert o.dtype == torch.int32
    exact = xq.long() @ kq.long().t()
    assert torch.equal(o.long(), exact) and exact.abs().max() == 127 ** 2 * 4096


@pytest.mark.parametrize("use_bias", [False, True])
def test_quant_dense_matches_jax(use_bias):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    mod = jquant.QuantDense(24, dtype=jnp.float32, use_bias=use_bias)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    q, s = jquant.quantize_weight(
        jnp.asarray(rng.standard_normal((16, 24)), jnp.float32))
    params = {"kernel_q": q, "scale": s}
    if use_bias:
        params["bias"] = jnp.asarray(rng.standard_normal(24), jnp.float32)
    ref = mod.apply({"params": params}, jnp.asarray(x))
    tmod = load_flax_params(
        quant.QuantDense(16, 24, use_bias=use_bias, dtype=torch.float32),
        jax.device_get(params))
    np.testing.assert_allclose(to_np(tmod(torch.from_numpy(x))),
                               np.asarray(ref), rtol=1e-6, atol=1e-6)


def _tiny_cfgs(**kw):
    kw = dict(dtype="float32", head_type="structure", **kw)
    return jesm3.esm3_tiny(**kw), tesm3.esm3_tiny(**kw)


@pytest.fixture(scope="module")
def jax_trunk():
    """A tiny float32 JAX trunk with perturbed params (every LN gamma off
    1, so the fold is exercised) and its int8 tree."""
    jcfg, _ = _tiny_cfgs()
    net = jesm3.ESM3(jcfg)
    seq = jnp.full((1, 8), 5, jnp.int32)
    params = jax.jit(lambda k: net.init(
        k, sequence_tokens=seq,
        structure_coords=jnp.zeros((1, 8, 3, 3))))(
            jax.random.PRNGKey(0))["params"]
    params = perturb(params, 1, 0.05)
    return params, jax.device_get(jquant.quantize_trunk_params(params))


def test_quantized_tree_carries_over(jax_trunk):
    """JAX's quantize_trunk_params tree loads strictly into the port's int8
    trunk, and the port's own quantizer over the carried float32 weights
    gives the same leaves, bit for bit."""
    params, q_tree = jax_trunk
    _, tcfg = _tiny_cfgs()
    _, tcfg8 = _tiny_cfgs(quant="int8")
    carried = load_flax_params(tesm3.ESM3(tcfg8).float(), q_tree)
    fp = carry(tesm3.ESM3(tcfg), params)
    own = quant.quantize_trunk_params(fp.state_dict())
    ref = carried.state_dict()
    assert own.keys() == ref.keys()
    assert not any(k.endswith((".attn.ln.scale", ".ffn.ln.scale"))
                   for k in ref)
    assert any(k.endswith("attn.qkv.kernel_q") for k in ref)
    for k, v in ref.items():
        assert own[k].dtype == v.dtype, k
        assert torch.equal(own[k], v), k


def test_int8_trunk_logits_match_jax(jax_trunk):
    params, q_tree = jax_trunk
    jcfg8, tcfg8 = _tiny_cfgs(quant="int8")
    rng = np.random.default_rng(4)
    seq = rng.integers(4, 24, (2, 20)).astype(np.int32)
    lengths = np.array([20, 13], np.int32)
    ref = jax.jit(jesm3.ESM3(jcfg8).apply)(
        {"params": q_tree}, sequence_tokens=jnp.asarray(seq),
        lengths=jnp.asarray(lengths))
    trunk = load_flax_params(tesm3.ESM3(tcfg8).float(), q_tree)
    with torch.no_grad():
        out = trunk(sequence_tokens=torch.from_numpy(seq).long(),
                    lengths=torch.from_numpy(lengths))
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(to_np(out.structure_logits)[b, :n],
                                   np.asarray(ref.structure_logits)[b, :n],
                                   atol=1e-4)


def test_quant_rejects_fused_backend():
    with pytest.raises(ValueError, match="incompatible"):
        MultiHeadAttention(64, 4, quant="int8", qkv_backend="fused")
    with pytest.raises(ValueError, match="quant must be"):
        MultiHeadAttention(64, 4, quant="int4")


def _tiny_runtime(**kw):
    return ESM3Runtime.random_init(
        seed=0, trunk_cfg=tesm3.esm3_tiny(head_type="structure",
                                          dtype="float32"),
        decoder_cfg=DecoderConfig(d_model=64, n_heads=2, n_layers=2,
                                  dtype="float32"),
        encoder_cfg=EncoderConfig(d_model=64, n_heads=2, v_heads=8,
                                  n_layers=2, d_out=16, knn=8),
        device="cpu", **kw)


def test_runtime_quantize():
    """quantize() swaps the trunk (trunk only by default, the decoder with
    include_decoder) and shares the rest, the float32 encoder too;
    random_init(quant="int8") quantizes the same float32 weights."""
    rt = _tiny_runtime()
    q = rt.quantize("int8")
    assert q.trunk.cfg.quant == "int8" and q.trunk.cfg.qkv_backend == "xla"
    assert q.decoder is rt.decoder and q.sigma_embedder is rt.sigma_embedder
    assert q.encoder is rt.encoder
    assert {p.dtype for p in q.encoder.parameters()} == {torch.float32}
    assert isinstance(q.trunk.transformer.blocks[0].ffn.up, quant.QuantDense)
    assert q.trunk.transformer.blocks[0].attn.ln.scale is None
    direct = _tiny_runtime(quant="int8").trunk.state_dict()
    for k, v in q.trunk.state_dict().items():
        assert torch.equal(v, direct[k]), k
    qd = rt.quantize("int8", include_decoder=True)
    assert qd.decoder.cfg.quant == "int8"
    blk = qd.decoder.decoder_stack.blocks[0]
    assert isinstance(blk.attn.qkv, quant.QuantDense)
    with pytest.raises(ValueError, match="unknown quantization"):
        rt.quantize("int4")


def test_decoder_quant_matches_jax():
    """DecoderConfig.quant reaches the decoder's stack as in JAX (the
    decoder's int8 tree carries over strictly)."""
    from esmdiff_tpu.models.vqvae import DecoderConfig as JDec
    from esmdiff_tpu.models.vqvae import StructureTokenDecoder as JDecoder
    from esmdiff_tpu_torch.models.vqvae import StructureTokenDecoder

    kw = dict(d_model=64, n_heads=2, n_layers=2, dtype="float32")
    toks = jnp.full((1, 8), 7, jnp.int32)
    params = jax.jit(JDecoder(JDec(scan_layers=False, **kw)).init)(
        jax.random.PRNGKey(0), toks)["params"]
    q_tree = jax.device_get(jquant.quantize_trunk_params(params))
    jdec = JDecoder(JDec(scan_layers=False, quant="int8", **kw))
    ref = jax.jit(lambda p, t: jdec.apply({"params": p}, t,
                                          compute_ptm=False))(q_tree, toks)
    dec = load_flax_params(
        StructureTokenDecoder(DecoderConfig(quant="int8", **kw)).float(),
        q_tree)
    with torch.no_grad():
        out = dec(torch.from_numpy(np.array(toks)).long(),
                  compute_ptm=False)
    np.testing.assert_allclose(to_np(out["bb_pred"]),
                               np.asarray(ref["bb_pred"]), atol=1e-4)


def test_cli_quant_int8(tmp_path, capsys):
    report = cli.main(["--input", str(ROOT / "data/targets/bpti"),
                       "--output", str(tmp_path), "--mode", "ddpm",
                       "--num_steps", "2", "--num_samples", "2",
                       "--model_scale", "tiny", "--device", "cpu",
                       "--quant", "int8"])
    assert "W8A8 int8" in capsys.readouterr().out
    text = (tmp_path / "bpti.pdb").read_text()
    assert text.count("MODEL") == 2 and report[0]["num_samples"] == 2


def test_sample_cli_quantizes_a_given_runtime(tmp_path, monkeypatch):
    rt = _tiny_runtime()
    seen = []
    real = ESM3Runtime.quantize

    def spy(self, *args, **kwargs):
        seen.append(self)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(ESM3Runtime, "quantize", spy)
    cli.main(["--input", str(ROOT / "data/targets/bpti"),
              "--output", str(tmp_path), "--mode", "ddpm", "--num_steps",
              "1", "--num_samples", "1", "--device", "cpu", "--quant",
              "int8"], runtime=rt)
    assert seen == [rt]


@pytest.mark.parametrize("route", ["quantize", "cli"])
def test_quantize_refuses_bf16_matmul_weights(route, tmp_path):
    """A bf16 runtime's matmul weights are cast from float32, so their
    int8 weights would not be JAX's: quantize (and the CLI's --quant int8
    on a given runtime) raise."""
    rt = ESM3Runtime.random_init(
        seed=0, trunk_cfg=tesm3.esm3_tiny(head_type="structure"),
        decoder_cfg=DecoderConfig(d_model=64, n_heads=2, n_layers=2),
        device="cpu")
    with pytest.raises(ValueError, match="differ from those the JAX"):
        if route == "quantize":
            rt.quantize("int8")
        else:
            cli.main(["--input", str(ROOT / "data/targets/bpti"),
                      "--output", str(tmp_path), "--mode", "ddpm",
                      "--num_steps", "1", "--num_samples", "1",
                      "--device", "cpu", "--quant", "int8"], runtime=rt)
