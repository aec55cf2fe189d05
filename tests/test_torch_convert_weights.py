"""The port's reference-checkpoint path against the JAX package's, on the
CPU at tiny width: the seeded fixtures bit for bit, the conversion of
every component in four file layouts bit for bit against JAX's conversion
carried over (``load_flax_params``), the export and its round trip,
strictness and the hooks, the oracles, ``verify_*`` (<= 1e-5 relative in
float32) and planted faults, the function decoder's forward (1e-5),
``load_runtime`` of a release (its sigma embedder) and of a stock file
(its head type), the CLI, ``model.pretrained_ckpt`` (the MDLM loss at
step 0 against JAX's, 1e-5) and the runbook's ``--fixture`` chain."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esmdiff_tpu.convert import torch_to_jax as t2j
from esmdiff_tpu.convert import verify as jverify
from esmdiff_tpu.models import esm3 as jesm3
from esmdiff_tpu.models import function_decoder as jfd
from esmdiff_tpu.models import vqvae as jvq
from esmdiff_tpu_torch.convert import checkpoints, load_flax_params
from esmdiff_tpu_torch.convert import torch_ckpt as tc
from esmdiff_tpu_torch.convert import verify as tv
from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.models import esm3 as tesm3
from esmdiff_tpu_torch.models import function_decoder as tfd
from esmdiff_tpu_torch.models import vqvae as tvq

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(0)
ENC_KW = dict(d_model=64, n_heads=2, v_heads=8, n_layers=2, d_out=16, knn=8)
DEC_KW = dict(d_model=64, n_heads=4, n_layers=3, dtype="float32")
FD_KW = dict(d_model=64, n_heads=4, n_layers=2, interpro_classes=37,
             keyword_vocab=53)


def _jax_trunk_template(head_type):
    cfg = jesm3.esm3_tiny(dtype="float32", head_type=head_type)
    params = jax.jit(lambda k: jesm3.ESM3(cfg).init(
        k, sequence_tokens=jnp.zeros((1, 8), jnp.int32),
        structure_coords=jnp.zeros((1, 8, 3, 3))))(KEY)["params"]
    return cfg, jax.device_get(params)


# one JAX init a model (module scope): the templates the JAX converters
# fill, and the port's twin config and module constructor
@pytest.fixture(scope="module")
def models():
    out = {}
    for head in ("esm3", "structure"):
        jcfg, tmpl = _jax_trunk_template(head)
        tcfg = tesm3.esm3_tiny(dtype="float32", head_type=head)
        out[f"trunk_{head}"] = dict(
            jcfg=jcfg, tcfg=tcfg, template=tmpl,
            build=lambda c=tcfg: tesm3.ESM3(c),
            make=tv.make_reference_trunk_state_dict,
            jmake=jverify.make_reference_trunk_state_dict,
            jconvert=lambda t, sd, c=jcfg: t2j.convert_trunk(
                t, sd, c, strict=True),
            convert=tc.convert_trunk,
            rules=tc.trunk_rules(tcfg.n_layers, tcfg.n_layers_geom, head),
            jrules=(t2j.trunk_rules(jcfg.n_layers, jcfg.n_layers_geom, head),
                    dict(n_scan_layers=jcfg.n_layers - jcfg.n_layers_geom,
                         scan_layer_offset=jcfg.n_layers_geom)))
    jcfg = jvq.DecoderConfig(**DEC_KW)
    out["vqvae_decoder"] = dict(
        jcfg=jcfg, tcfg=tvq.DecoderConfig(**DEC_KW),
        template=jax.device_get(jax.jit(lambda k: jvq.StructureTokenDecoder(
            jcfg).init(k, jnp.zeros((1, 8), jnp.int32)))(KEY)["params"]),
        build=lambda: tvq.StructureTokenDecoder(tvq.DecoderConfig(**DEC_KW)),
        make=tv.make_reference_decoder_state_dict,
        jmake=jverify.make_reference_decoder_state_dict,
        jconvert=lambda t, sd: t2j.convert_vqvae_decoder(t, sd, n_layers=3),
        convert=tc.convert_vqvae_decoder, rules=tc.vqvae_decoder_rules(3),
        jrules=(t2j.vqvae_decoder_rules(3),
                dict(n_scan_layers=3, scan_layer_offset=0)))
    jcfg = jvq.EncoderConfig(**ENC_KW)
    out["vqvae_encoder"] = dict(
        jcfg=jcfg, tcfg=tvq.EncoderConfig(**ENC_KW),
        template=jax.device_get(jax.jit(lambda k: jvq.StructureTokenEncoder(
            jcfg).init(k, jnp.zeros((1, 8, 3, 3))))(KEY)["params"]),
        build=lambda: tvq.StructureTokenEncoder(tvq.EncoderConfig(**ENC_KW)),
        make=tv.make_reference_encoder_state_dict,
        jmake=jverify.make_reference_encoder_state_dict,
        jconvert=lambda t, sd: t2j.convert_vqvae_encoder(t, sd, strict=True),
        convert=tc.convert_vqvae_encoder, rules=tc.vqvae_encoder_rules(2),
        jrules=(t2j.vqvae_encoder_rules(2), {}))
    jcfg = jfd.FunctionDecoderConfig(**FD_KW)
    out["function_decoder"] = dict(
        jcfg=jcfg, tcfg=tfd.FunctionDecoderConfig(**FD_KW),
        template=jax.device_get(jax.jit(lambda k: jfd.FunctionTokenDecoder(
            jcfg).init(k, jnp.zeros((1, 8), jnp.int32)))(KEY)["params"]),
        build=lambda: tfd.FunctionTokenDecoder(
            tfd.FunctionDecoderConfig(**FD_KW)),
        make=tv.make_reference_function_decoder_state_dict,
        jmake=jverify.make_reference_function_decoder_state_dict,
        jconvert=lambda t, sd: t2j.convert_function_decoder(
            t, sd, n_layers=2, strict=True),
        convert=tc.convert_function_decoder,
        rules=tc.function_decoder_rules(2),
        jrules=(t2j.function_decoder_rules(2), {}))
    return out


COMPONENTS = ["trunk_esm3", "trunk_structure", "vqvae_decoder",
              "vqvae_encoder", "function_decoder"]


@pytest.mark.parametrize("name", COMPONENTS)
def test_fixtures_equal_jax_bit_for_bit(models, name):
    """The port's generators give JAX's keys, in JAX's order, and its
    arrays bit for bit."""
    m = models[name]
    for seed in (0, 3):
        got = m["make"](m["tcfg"], seed=seed)
        want = m["jmake"](m["jcfg"], seed=seed)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("kind", ["clm", "jlm"])
def test_ar_fixtures_equal_jax(kind):
    """The AR fixtures (random HF T5 / GPT-2 + the adapters) equal JAX's
    key for key and bit for bit; the config inferred from them matches."""
    cfg = tv.fixture_configs("tiny")[kind]
    from esmdiff_tpu.models import clm as jclm
    from esmdiff_tpu.models import jlm as jjlm

    if kind == "clm":
        jcfg = jclm.CLMConfig(d_model=32, d_ff=64, n_layers=2, n_heads=4,
                              cond_dim=48, dtype="float32")
        got, want = (tv.make_reference_clm_state_dict(cfg, seed=1),
                     jverify.make_reference_clm_state_dict(jcfg, seed=1))
        inferred = tv.infer_clm_config(got)
        assert dataclasses.asdict(inferred) == dataclasses.asdict(
            dataclasses.replace(cfg, dtype="float32"))
    else:
        jcfg = jjlm.JLMConfig(n_embd=32, n_layers=2, n_heads=4,
                              n_positions=64, cond_dim=48,
                              struct_embed_dim=24, seq_vocab=33,
                              sep_strategy="position", dtype="float32")
        cfg = dataclasses.replace(cfg, sep_strategy="position")
        got, want = (tv.make_reference_jlm_state_dict(cfg, seed=2),
                     jverify.make_reference_jlm_state_dict(jcfg, seed=2))
        assert tv.infer_jlm_config(got, n_heads=4) == cfg
    assert list(got) == list(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_trunk_fixtures_share_their_body():
    """``make_reference_trunk_state_dicts`` draws the body once: each
    config's dict equals its own ``make_reference_trunk_state_dict`` and
    the two share the body's tensors."""
    cfgs = [tesm3.esm3_tiny(), tesm3.esm3_tiny(head_type="structure")]
    both = tv.make_reference_trunk_state_dicts(cfgs, seed=5)
    for cfg, got in zip(cfgs, both):
        want = tv.make_reference_trunk_state_dict(cfg, seed=5)
        assert list(got) == list(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    body = "transformer.blocks.3.ffn.1.weight"
    assert both[0][body] is both[1][body]


def _layout(sd, layout):
    if layout == "plain":
        return dict(sd)
    if layout == "net":
        return {"net." + k: v for k, v in sd.items()}
    if layout == "lightning":
        return {"state_dict": {"_forward_module.net." + k: v
                               for k, v in sd.items()}, "epoch": 3}
    return {"module": {"module.net." + k: v for k, v in sd.items()}}


@pytest.mark.parametrize("layout", ["plain", "net", "lightning", "deepspeed"])
@pytest.mark.parametrize("name", COMPONENTS)
def test_conversion_equals_jax_bit_for_bit(models, name, layout, tmp_path):
    """A fixture saved in ``layout``, read by each package's loader and
    converted: the port's module equals JAX's converted params carried
    over by ``load_flax_params``, bit for bit (the decoder's no-source
    pae_q/pae_k apart: listed in the report)."""
    m = models[name]
    path = tmp_path / "ckpt.pt"
    torch.save(_layout(m["make"](m["tcfg"], seed=1), layout), path)
    jsd = t2j.load_torch_state_dict(str(path))
    if any(k.startswith("net.") for k in jsd):
        jsd = t2j.strip_prefix(jsd, "net.")
    jparams, _ = m["jconvert"](m["template"], jsd)
    want = load_flax_params(m["build"]().float(), jax.device_get(jparams))
    got = m["build"]().float()
    report = m["convert"](got, tc.load_torch_state_dict(str(path)))
    no_source = set(report["no_source"])
    assert no_source == ({"pae_q.weight", "pae_q.bias", "pae_k.weight",
                          "pae_k.bias"} if name == "vqvae_decoder" else set())
    assert report["converted"] == len(got.state_dict()) - len(no_source)
    for k, v in want.state_dict().items():
        if k not in no_source:
            assert torch.equal(got.state_dict()[k], v), k


@pytest.mark.parametrize("name", COMPONENTS)
def test_export_equals_jax_and_round_trips(models, name):
    """``export_reference_state_dict`` of a module carrying JAX's init
    equals JAX's ``export_torch_state_dict`` bit for bit, and converting
    it back gives the module's tensors."""
    m = models[name]
    module = load_flax_params(m["build"]().float(), m["template"])
    got = tc.export_reference_state_dict(module, m["rules"])
    jrules, kw = m["jrules"]
    want = t2j.export_torch_state_dict(m["template"], jrules, **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    back = m["build"]().float()
    report = m["convert"](back, got)
    for k, v in module.state_dict().items():
        if k not in report["no_source"]:
            assert torch.equal(back.state_dict()[k], v), k


def test_strictness_and_hooks(models, monkeypatch):
    """A missing key raises naming it; ``key_overrides`` (or the
    module-wide ``KEY_OVERRIDES``) patches a renamed one; a shape that
    differs, a parameter with no rule and a file deeper than the module
    raise."""
    cfg = tesm3.esm3_tiny(dtype="float32")
    sd = tv.make_reference_trunk_state_dict(cfg)
    key = "transformer.blocks.2.attn.out_proj.weight"
    drifted = dict(sd)
    drifted["transformer.blocks.2.attn.o_proj.weight"] = drifted.pop(key)
    with pytest.raises(KeyError, match=r"1 missing \['" + key):
        tc.convert_trunk(tesm3.ESM3(cfg), drifted)
    patched = tesm3.ESM3(cfg)
    tc.convert_trunk(patched, drifted, key_overrides={
        key: "transformer.blocks.2.attn.o_proj.weight"})
    assert torch.equal(patched.transformer.blocks[2].attn.out.weight, sd[key])
    monkeypatch.setitem(tc.KEY_OVERRIDES, key,
                        "transformer.blocks.2.attn.o_proj.weight")
    tc.convert_trunk(tesm3.ESM3(cfg), drifted)
    monkeypatch.delitem(tc.KEY_OVERRIDES, key)

    bad = dict(sd)
    bad["transformer.norm.weight"] = torch.ones(65)
    with pytest.raises(ValueError, match="transformer.norm.scale"):
        tc.convert_trunk(tesm3.ESM3(cfg), bad)
    with pytest.raises(KeyError, match="lacks.*transformer.blocks.4"):
        tc.convert_trunk(tesm3.ESM3(cfg),
                         tv.make_reference_trunk_state_dict(
                             dataclasses.replace(cfg, n_layers=5)))
    rules = tc.trunk_rules(4)
    rules.pop("transformer.norm.scale")
    with pytest.raises(KeyError, match=r"1 unmapped \['transformer.norm"):
        tc.fill_module(tesm3.ESM3(cfg), sd, rules)
    with pytest.raises(ValueError, match="structure_head"):
        tc.convert_trunk(tesm3.ESM3(dataclasses.replace(
            cfg, head_type="structure")), sd)


def test_oracles_equal_jax():
    """The port's copies of the oracles give JAX's outputs on the same
    state dict and probe."""
    cfg = tesm3.esm3_tiny()
    sd = tv.make_reference_trunk_state_dict(cfg)
    dsd = tv.make_reference_decoder_state_dict(tvq.DecoderConfig(**DEC_KW))
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.randn(2, 16, 64).astype(np.float32))
    bb = torch.as_tensor(rng.randn(2, 16, 3, 3).astype(np.float32)) * 3.0
    from esmdiff_tpu_torch.nn.geometric import build_affine3d_from_coordinates

    aff, mask = build_affine3d_from_coordinates(bb)
    pairs = [
        (tv.oracle_block(sd, "transformer.blocks.1", x, 4, 1.5),
         jverify.oracle_block(sd, "transformer.blocks.1", x, 4, 1.5)),
        (tv.oracle_geom_attn(sd, "transformer.blocks.0", x, aff.rot,
                             aff.trans, mask, 8),
         jverify.oracle_geom_attn(sd, "transformer.blocks.0", x, aff.rot,
                                  aff.trans, mask, 8)),
        (tv.oracle_regression_head(sd, "output_heads.structure_head", x),
         jverify.oracle_regression_head(sd, "output_heads.structure_head",
                                        x)),
        (tv.oracle_dim6rot_head(dsd, "affine_output_projection", x, 10.0),
         jverify._oracle_dim6rot_head(dsd, "affine_output_projection", x,
                                      10.0))]
    for got, want in pairs:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def _worst(rows):
    return max(r["rel_diff"] for r in rows)


@pytest.mark.parametrize("component", list(tv.MAKERS))
def test_verify_is_clean(component):
    """Every component's fixture verifies within 1e-5 in float32 on the
    CPU (the CLI's path, config read from the file where it can be)."""
    cfg = tv.fixture_configs("tiny")[component]
    rows = tv.run(component, tv.MAKERS[component](cfg), cfg, device="cpu")
    assert len(rows) >= 2
    assert _worst(rows) <= 1e-5


def test_verify_cli_gate(tmp_path):
    """``esmdiff-torch-verify`` on a file: the head type read from it, a
    release's sigma embedder verified too; a file that does not fill the
    trunk raises, and a diff above ``--tol`` exits with an error."""
    path = tmp_path / "release.pt"
    cfg = tesm3.esm3_tiny(head_type="structure")
    torch.save(tv.release_checkpoint(
        tv.make_reference_trunk_state_dict(cfg),
        tv.make_reference_sigma_embedder_state_dict(64)), path)
    rows = tv.check([str(path), "--scale", "tiny", "--device", "cpu"])
    assert rows[-1]["layer"] == "sigma_embedder"
    assert _worst(rows) <= 1e-5
    sd = tv.make_reference_trunk_state_dict(cfg)
    sd.pop("transformer.blocks.1.ffn.3.weight")
    torch.save(sd, path)
    with pytest.raises(KeyError, match="blocks.1.ffn.3.weight"):
        tv.main([str(path), "--scale", "tiny", "--device", "cpu"])
    torch.save(tv.make_reference_trunk_state_dict(cfg), path)
    with pytest.raises(SystemExit, match="worst rel diff"):
        tv.main([str(path), "--scale", "tiny", "--device", "cpu",
                 "--tol", "1e-9"])


def test_layout_bug_and_swapped_layers_explode(monkeypatch):
    """A rule pointing block 1's output projection at block 2's tensor
    explodes block 1's diff and leaves block 0 clean; two layers swapped
    through key_overrides explode exactly those two layers."""
    cfg = tesm3.esm3_tiny()
    sd = tv.make_reference_trunk_state_dict(cfg)
    real = tc.trunk_rules

    def broken(*a, **kw):
        rules = real(*a, **kw)
        rules["transformer.blocks.1.attn.out.weight"] = \
            "transformer.blocks.2.attn.out_proj.weight"
        return rules

    monkeypatch.setattr(tc, "trunk_rules", broken)
    rows = {r["layer"]: r["rel_diff"]
            for r in tv.verify_trunk(sd, cfg, device="cpu")}
    assert rows["block1"] > 1e-3 and rows["block0(geom)"] < 1e-5
    monkeypatch.setattr(tc, "trunk_rules", real)
    swap = {}
    for name in tv._block_specs("x", 1, 1):
        a, b = (name.replace("x", f"transformer.blocks.{i}", 1)
                for i in (1, 2))
        swap.update({a: b, b: a})
    rows = {r["layer"]: r["rel_diff"]
            for r in tv.verify_trunk(sd, cfg, key_overrides=swap,
                                     device="cpu")}
    assert rows["block1"] > 1e-3 and rows["block2"] > 1e-3
    assert rows["block0(geom)"] < 1e-5 and rows["block3"] < 1e-5


def test_value_transforms_unpermute_geom_packing():
    """A file whose geometric projection packs each head [kr|qr|...] is
    un-permuted by value_transforms: the converted tensor equals the
    canonical file's and verify stays clean; without the hook it differs."""
    cfg = tesm3.esm3_tiny()
    sd = tv.make_reference_trunk_state_dict(cfg)
    key = "transformer.blocks.0.geom_attn.proj.weight"
    perm = [3, 4, 5, 0, 1, 2] + list(range(6, 15))
    swapped = dict(sd)
    swapped[key] = sd[key].reshape(8, 15, -1)[:, perm].reshape(120, -1)

    def unswap(w):
        return w.reshape(8, 15, -1)[:, perm].reshape(120, -1)

    ref, fixed, bad = (tesm3.ESM3(cfg) for _ in range(3))
    tc.convert_trunk(ref, sd)
    tc.convert_trunk(fixed, swapped, value_transforms={key: unswap})
    tc.convert_trunk(bad, swapped)
    proj = [m.transformer.blocks[0].geom_attn.proj.weight
            for m in (ref, fixed, bad)]
    assert torch.equal(proj[0], proj[1]) and not torch.equal(proj[0], proj[2])
    assert _worst(tv.verify_trunk(swapped, cfg, value_transforms={
        key: unswap}, device="cpu")) <= 1e-5


def test_function_decoder_matches_jax(models):
    """FunctionTokenDecoder's forward on JAX's params, at 1e-5."""
    m = models["function_decoder"]
    port = load_flax_params(m["build"]().float(), m["template"])
    toks = np.random.RandomState(0).randint(0, 260, (5, 8)).astype(np.int32)
    want = jfd.FunctionTokenDecoder(m["jcfg"]).apply(
        {"params": m["template"]}, jnp.asarray(toks))
    with torch.no_grad():
        got = port(torch.as_tensor(toks).long())
    for k in ("interpro_logits", "keyword_logits"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5)
    assert all(not m.attn_backend != "xla" for m in port.modules()
               if hasattr(m, "attn_backend"))


def _trunk_files(tmp_path):
    """A stock-layout trunk file and a release (Lightning, net.* and
    sigma_embedder.*) at tiny width."""
    cfgs = [tesm3.esm3_tiny(), tesm3.esm3_tiny(head_type="structure")]
    stock, release = tv.make_reference_trunk_state_dicts(cfgs)
    sigma = tv.make_reference_sigma_embedder_state_dict(64, seed=1)
    paths = {"stock": tmp_path / "stock.pt", "release": tmp_path / "rel.ckpt"}
    torch.save(stock, paths["stock"])
    torch.save(tv.release_checkpoint(release, sigma), paths["release"])
    return paths, stock, release, sigma


def test_load_runtime_release_keeps_its_sigma_embedder(tmp_path):
    """The port's runtime of a release holds the file's trunk (float32 at
    tiny width: bit for bit) and its sigma embedder; JAX's load_runtime
    drops the sigma embedder and keeps its seed-0 init."""
    paths, _, release, sigma = _trunk_files(tmp_path)
    rt = checkpoints.load_runtime(paths["release"], device="cpu")
    assert rt.trunk.cfg.head_type == "structure"
    rules = tc.trunk_rules(4, 1, "structure")
    for name, value in rt.trunk.state_dict().items():
        assert torch.equal(value, release[rules[name]]), name
    assert torch.equal(rt.sigma_embedder.fc1.weight, sigma["mlp.0.weight"])
    assert torch.equal(rt.sigma_embedder.fc2.bias, sigma["mlp.2.bias"])

    from esmdiff_tpu.api.protein_api import ESM3Runtime as JRuntime
    from esmdiff_tpu.convert.checkpoints import load_runtime as jload

    kw = dict(encoder_cfg=jvq.EncoderConfig(**ENC_KW),
              decoder_cfg=jvq.DecoderConfig(d_model=64, n_heads=2,
                                            n_layers=2, dtype="float32"))
    jcfg = jesm3.esm3_tiny(head_type="structure", dtype="float32")
    jrt = jload(str(paths["release"]), trunk_cfg=jcfg, **kw)
    seed0 = JRuntime.random_init(trunk_cfg=jcfg, **kw)
    jfc1 = np.asarray(jrt.sigma_params["fc1"]["kernel"])
    np.testing.assert_array_equal(
        jfc1, np.asarray(seed0.sigma_params["fc1"]["kernel"]))
    assert not np.allclose(jfc1, sigma["mlp.0.weight"].numpy().T)


def test_stock_file_head_type_and_cli(tmp_path):
    """The head type comes from the file: a stock file (4096 structure
    rows) gives the multi-track heads and samples gibbs through
    ``--ckpt``; a release samples ddpm, a multi-MODEL PDB each.  JAX's
    load_runtime builds the fine-tune head for any file, so a stock file
    raises there on the structure head's shape."""
    from esmdiff_tpu.convert.checkpoints import load_runtime as jload
    from esmdiff_tpu_torch.cli import sample as cli

    paths, stock, _, _ = _trunk_files(tmp_path)
    rt = checkpoints.load_runtime(paths["stock"], device="cpu")
    assert rt.trunk.cfg.head_type == "esm3"
    assert torch.equal(rt.trunk.output_heads.structure_head.out.weight,
                       stock["output_heads.structure_head.3.weight"])
    for mode, path in (("gibbs", paths["stock"]), ("ddpm", paths["release"])):
        out = tmp_path / mode
        report = cli.main(["--input", "data/targets/bpti", "--output",
                           str(out), "--ckpt", str(path), "--mode", mode,
                           "--num_steps", "2", "--num_samples", "3",
                           "--device", "cpu"])
        text = (out / "bpti.pdb").read_text().splitlines()
        assert sum(line.startswith("MODEL") for line in text) == 3
        atoms = [line for line in text if line.startswith("ATOM")]
        assert len(atoms) == 3 * (report[0]["L"] * 4 - 1)
    with pytest.raises(ValueError, match="shape mismatch.*structure_head"):
        jload(str(paths["stock"]), trunk_cfg=jesm3.esm3_tiny(
            head_type="structure", dtype="float32"),
            encoder_cfg=jvq.EncoderConfig(**ENC_KW),
            decoder_cfg=jvq.DecoderConfig(d_model=64, n_heads=2, n_layers=2,
                                          dtype="float32"))


@pytest.mark.parametrize("scale", ["full", "tiny"])
def test_trunk_geometry_is_read_from_the_file(scale):
    """``load_runtime``'s trunk config is the file's: width, depth,
    geometric blocks, v_heads and head from its shapes (meta tensors: the
    full geometry without its values), the head count, which no shape
    gives, from the geometry of that width.  A tiny-width file of another
    depth keeps its depth; a width neither geometry has raises."""
    base = checkpoints.scale_configs(scale)["trunk_cfg"]
    if scale == "tiny":
        base = dataclasses.replace(base, n_layers=3, n_layers_geom=2,
                                   v_heads=4)
    for want in (dataclasses.replace(base, head_type="esm3"),
                 dataclasses.replace(base, head_type="structure",
                                     n_sequence_heads=C.SEQUENCE_EMBED_SIZE)):
        sd = {f"net.{k}": torch.empty(shape, device="meta")
              for k, shape in tv._trunk_tensor_specs(want).items()}
        assert checkpoints.file_configs(sd)["trunk_cfg"] == want
    odd = tesm3.esm3_tiny(d_model=32, n_heads=2)
    sd = {k: torch.empty(shape, device="meta")
          for k, shape in tv._trunk_tensor_specs(odd).items()}
    with pytest.raises(ValueError, match="width 32"):
        checkpoints.file_configs(sd)


def test_server_int8_runtime_from_file(tmp_path):
    """The server's ``--ckpt <file> --quant int8``: the trunk holds the
    int8 layout quantized from the file's float32 values, bit for bit."""
    from esmdiff_tpu_torch.cli import sample as cli
    from esmdiff_tpu_torch.cli import serve as serve_cli
    from esmdiff_tpu_torch.ops.quant import quantize_trunk_params

    paths, _, release, _ = _trunk_files(tmp_path)
    args = serve_cli.get_argparser().parse_args(
        ["--ckpt", str(paths["release"]), "--quant", "int8", "--mode",
         "ddpm", "--device", "cpu"])
    rt = cli.build_runtime(args)
    assert rt.trunk.cfg.quant == "int8"
    fp32 = tesm3.ESM3(tesm3.esm3_tiny(head_type="structure"))
    tc.convert_trunk(fp32, release)
    want = quantize_trunk_params(fp32.state_dict())
    got = rt.trunk.state_dict()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def _mdlm_cfgs(path, tmp_path):
    from esmdiff_tpu.train import config as jconfig
    from esmdiff_tpu_torch.train import config as tconfig

    over = ["model.size=tiny", "model.dtype=float32",
            f"model.pretrained_ckpt={path}", f"trainer.ckpt_dir={tmp_path}"]
    return jconfig.load_config(None, over), tconfig.load_config(None, over)


def test_pretrained_ckpt_loss_matches_jax(tmp_path):
    """``model.pretrained_ckpt`` of a release: the port's MDLM holds the
    file's trunk and sigma embedder; JAX's holds the trunk (its sigma
    embedder set to the file's here); the loss at step 0 with JAX's draws
    injected agrees at 1e-5."""
    from esmdiff_tpu.train import loop as jloop
    from esmdiff_tpu_torch.train import data as tdata
    from esmdiff_tpu_torch.train import loop as tloop
    from test_torch_support import JaxLossDraws

    paths, _, release, sigma = _trunk_files(tmp_path)
    jcfg, tcfg = _mdlm_cfgs(paths["release"], tmp_path)
    jm = jloop.build_mdlm(jcfg)
    jparams = jax.device_get(jloop.init_params(jm, jcfg))
    assert not np.allclose(np.asarray(jparams["sigma_embedder"]["fc2"]
                                      ["bias"]), sigma["mlp.2.bias"].numpy())
    jparams["sigma_embedder"] = {
        "fc1": {"kernel": sigma["mlp.0.weight"].numpy().T,
                "bias": sigma["mlp.0.bias"].numpy()},
        "fc2": {"kernel": sigma["mlp.2.weight"].numpy().T,
                "bias": sigma["mlp.2.bias"].numpy()}}
    tm = tloop.build_mdlm(tcfg, "cpu")
    tloop.init_params(tm, tcfg)
    rules = tc.trunk_rules(4, 1, "structure")
    for name, value in tm.net.state_dict().items():
        assert torch.equal(value, release[rules[name]]), name
    assert torch.equal(tm.sigma_embedder.fc2.weight, sigma["mlp.2.weight"])
    rng = np.random.default_rng(0)
    batch = tdata.pad_collate(
        [{"sequence_tokens": rng.integers(4, 24, n).astype(np.int32),
          "structure_tokens": rng.integers(0, 4096, n).astype(np.int32)}
         for n in (30, 21)], 16)
    key = jax.random.PRNGKey(3)
    want, _ = jax.jit(lambda p, b, k: jm.loss(p, b, k))(jparams, batch, key)
    got, _ = tm.loss(tloop.to_device(batch, "cpu"), JaxLossDraws(key))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_pretrained_ckpt_from_stock_keeps_new_heads(tmp_path):
    """A stock ESM3 file fills the MDLM's trunk but its output heads, which
    keep their seeded init (the fine-tune's new 4101-way head); JAX raises
    on the stock head's shape."""
    from esmdiff_tpu.train import loop as jloop
    from esmdiff_tpu_torch.train import loop as tloop

    paths, stock, _, _ = _trunk_files(tmp_path)
    jcfg, tcfg = _mdlm_cfgs(paths["stock"], tmp_path)
    with pytest.raises(ValueError, match="shape mismatch"):
        jloop.init_params(jloop.build_mdlm(jcfg), jcfg)
    seeded = tloop.build_mdlm(dataclasses.replace(
        tcfg, model=dataclasses.replace(tcfg.model, pretrained_ckpt=None)),
        "cpu")
    tloop.init_params(seeded, dataclasses.replace(
        tcfg, model=dataclasses.replace(tcfg.model, pretrained_ckpt=None)))
    tm = tloop.build_mdlm(tcfg, "cpu")
    tloop.init_params(tm, tcfg)
    own, init = tm.net.state_dict(), seeded.net.state_dict()
    rules = tc.trunk_rules(4, 1, "esm3")
    for name, value in own.items():
        want = (init[name] if name.startswith("output_heads.")
                else stock[rules[name]])
        assert torch.equal(value, want), name
    assert torch.equal(tm.sigma_embedder.fc1.weight,
                       seeded.sigma_embedder.fc1.weight)


def test_real_weight_day_fixture(tmp_path):
    """The runbook's --fixture chain at tiny width passes every stage."""
    from esmdiff_tpu_torch.tools import real_weight_day

    out = real_weight_day.main(["--fixture", "--device", "cpu",
                                "--workdir", str(tmp_path)])
    assert set(out["verify"]) == {"trunk", "release", "vq_encoder",
                                  "vq_decoder"}
    assert max(out["verify"].values()) <= 1e-5
    assert min(r["argmax_agree"] for r in out["quant_parity"]) >= 0.95
    enc_cfg, dec_cfg = checkpoints.read_vqvae_json(tmp_path / "vqvae" /
                                                   "vqvae.json")
    assert dec_cfg.n_layers == 3 and enc_cfg.d_model == 64
