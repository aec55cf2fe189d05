"""The port's gibbs and eb engines (``EnsembleSampler.gibbs_ensemble``,
``gibbs_ensemble_multi``, ``gibbs_ensemble_mixed``, ``eb_ensemble``) and
the CLI's ``--mode gibbs|eb`` against the JAX package, on a tiny stock-head
runtime carried over from JAX's, with JAX's uniforms injected."""

import argparse

import numpy as np
import pytest
import torch

from esmdiff_tpu.api.generation import EnsembleSampler as JSampler
from esmdiff_tpu.api.generation import GenerationConfig as JConfig
from esmdiff_tpu.api.protein_api import ESM3Runtime as JRuntime
from esmdiff_tpu.models.esm3 import esm3_tiny as jesm3_tiny
from esmdiff_tpu.models.vqvae import DecoderConfig as JDecoderConfig
from esmdiff_tpu.models.vqvae import EncoderConfig as JEncoderConfig
from esmdiff_tpu_torch.api.generation import (EnsembleSampler,
                                              GenerationConfig, plan_batches)
from esmdiff_tpu_torch.api.protein_api import ESM3Runtime, ESMProtein
from esmdiff_tpu_torch.cli import sample as cli
from esmdiff_tpu_torch.models.esm3 import ESM3, esm3_tiny
from esmdiff_tpu_torch.models.vqvae import DecoderConfig, StructureTokenDecoder
from esmdiff_tpu_torch.nn.layers import TimestepEmbedder
from esmdiff_tpu_torch.ops.packing import pack_factor
from test_torch_support import (carry, carry_encoder,
                                jax_request_uniform_factory)

torch.set_num_threads(2)

SEQ_SHORT = "MKTAYIAKQR"                                   # bucket 32
SEQ_LONG = "MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQAPILSRVG"     # bucket 64
BPTI = "data/targets/bpti"


@pytest.fixture(scope="module")
def samplers():
    """JAX's stock-head tiny runtime and the port's, carried over from it;
    the port's sampler on JAX's uniforms."""
    dec_kw = dict(d_model=64, n_heads=2, n_layers=2, dtype="float32")
    trunk_kw = dict(head_type="esm3", dtype="float32")
    jrt = JRuntime.random_init(
        seed=5, trunk_cfg=jesm3_tiny(**trunk_kw),
        encoder_cfg=JEncoderConfig(d_model=64, n_heads=2, v_heads=8,
                                   n_layers=2, d_out=16, knn=8),
        decoder_cfg=JDecoderConfig(scan_layers=False, **dec_kw))
    rt = ESM3Runtime(
        carry(ESM3(esm3_tiny(**trunk_kw)), jrt.trunk_params),
        carry(StructureTokenDecoder(DecoderConfig(**dec_kw)),
              jrt.decoder_params),
        carry(TimestepEmbedder(64, dtype=torch.float32), jrt.sigma_params),
        device="cpu", encoder=carry_encoder(jrt))
    return (JSampler(jrt),
            EnsembleSampler(rt, uniform_factory=jax_request_uniform_factory))


def test_gibbs_ensemble_matches_jax(samplers):
    """5 samples plan one batch of 8 (3 surplus rows), packed 2 to a row
    at L 64."""
    js, ts = samplers
    lw = len(SEQ_LONG) + 2
    assert plan_batches(lw, 5) == [8] and pack_factor(8, 64) == 2
    cfg = dict(num_steps=4, temperature=1.4, top_p=0.9)
    ref = js.gibbs_ensemble(SEQ_LONG, 5, config=JConfig(**cfg), seed=7)
    got = ts.gibbs_ensemble(SEQ_LONG, 5, config=GenerationConfig(**cfg),
                            seed=7)
    assert got.shape == (5, len(SEQ_LONG)) and got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert (got < 4096).all()


def test_gibbs_multi_and_mixed_match_jax(samplers):
    """Same-bucket coalescing (pack 4 at B 8, L 32) and a group across
    two buckets: JAX's tokens, and each request its solo tokens."""
    js, ts = samplers
    cfg = dict(num_steps=3, temperature=1.0, top_p=0.8)
    seqs, counts, seeds = [SEQ_SHORT, "GSHMEAGITG"], [2, 3], [1, 2]
    ref = js.gibbs_ensemble_multi(seqs, counts, config=JConfig(**cfg),
                                  seeds=seeds)
    got = ts.gibbs_ensemble_multi(seqs, counts,
                                  config=GenerationConfig(**cfg), seeds=seeds)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)

    seqs, counts, seeds = [SEQ_LONG, SEQ_SHORT], [2, 3], [9, 5]
    ref = js.gibbs_ensemble_mixed(seqs, counts, config=JConfig(**cfg),
                                  seeds=seeds)
    got = ts.gibbs_ensemble_mixed(seqs, counts,
                                  config=GenerationConfig(**cfg), seeds=seeds)
    assert [g.shape for g in got] == [(2, 41), (3, 10)]
    for s, c, seed, g, r in zip(seqs, counts, seeds, got, ref):
        np.testing.assert_array_equal(g, r)
        solo = ts.gibbs_ensemble(s, c, config=GenerationConfig(**cfg),
                                 seed=seed)
        np.testing.assert_array_equal(solo, g)


def test_eb_ensemble_matches_jax(samplers):
    """A budget that commits several positions a step, with top-p: JAX's
    tokens; each batch's step count kept (one batch of 8, pack 2)."""
    js, ts = samplers
    kw = dict(entropy_budget=20.0, temperature=1.1, top_p=0.9,
              max_steps=32, seed=4)
    ref = js.eb_ensemble(SEQ_LONG, 3, **kw)
    got = ts.eb_ensemble(SEQ_LONG, 3, **kw)
    np.testing.assert_array_equal(got, ref)
    assert len(ts.eb_steps) == 1 and 1 <= ts.eb_steps[0] < len(SEQ_LONG)
    assert (got < 4096).all()


def test_gibbs_prior_is_not_ported(samplers):
    """The gibbs coordinate prior is ported: mask_ids without coordinates
    raises (JAX asserts), and a prior with two residues to inpaint gives
    JAX's tokens, the other eight fixed at their encoded codes."""
    js, ts = samplers
    with pytest.raises(ValueError, match="needs coordinates"):
        ts.gibbs_ensemble(SEQ_SHORT, 2, mask_ids=[1, 2])
    rng = np.random.default_rng(0)
    coords = np.full((10, 37, 3), np.nan, np.float32)
    coords[:, :3] = np.cumsum(rng.standard_normal((10, 3, 3)) * 2.0, axis=0)
    cfg = dict(num_steps=4, temperature=1.4, top_p=0.9)
    ref = js.gibbs_ensemble(SEQ_SHORT, 2, config=JConfig(**cfg), seed=1,
                            coordinates=coords, mask_ids=[1, 2])
    got = ts.gibbs_ensemble(SEQ_SHORT, 2, config=GenerationConfig(**cfg),
                            seed=1, coordinates=coords, mask_ids=[1, 2])
    np.testing.assert_array_equal(got, ref)
    keep = [i for i in range(10) if i not in (1, 2)]
    prior = coords.copy()
    prior[[1, 2]] = np.inf
    enc = ts.runtime.encode(ESMProtein("M__AYIAKQR", prior)).structure[1:-1]
    np.testing.assert_array_equal(got[:, keep], np.tile(enc[keep], (2, 1)))


def _pdb_counts(path):
    lines = path.read_text().splitlines()
    atoms = [line for line in lines if line.startswith("ATOM")]
    xyz = np.array([[float(a[c:c + 8]) for c in (30, 38, 46)]
                    for a in atoms])
    assert np.isfinite(xyz).all()
    return sum(line.startswith("MODEL") for line in lines), len(atoms)


@pytest.mark.parametrize("mode,refine", [("gibbs", False), ("eb", False),
                                         ("gibbs", True)])
def test_cli_modes_write_ensemble_pdb(tmp_path, mode, refine):
    """``--mode gibbs|eb`` (gibbs the default) on the CPU: a 2-MODEL PDB
    of BPTI's 58 residues, backbone and O but the last residue's."""
    argv = ["--input", BPTI, "--output", str(tmp_path), "--num_steps", "2",
            "--num_samples", "2", "--model_scale", "tiny", "--device", "cpu"]
    if mode != "gibbs":
        argv += ["--mode", mode]
    if refine:
        argv += ["--refine"]
    report = cli.main(argv)
    assert _pdb_counts(tmp_path / "bpti.pdb") == (2, 2 * (58 * 4 - 1))
    assert report[0]["mode"] == mode
    if mode == "eb":
        assert report[0]["eb_steps"] == [16]       # max_steps = 8 x 2


def test_cli_refine_moves_bonds_into_band(tmp_path):
    """``--refine`` shifts the decoded CA traces into the bond band."""
    from esmdiff_tpu_torch.api.protein_api import ESMProtein
    from esmdiff_tpu_torch.core import protein as protein_io
    from esmdiff_tpu_torch.ops.refine import BOND_HI, BOND_LO

    cli.main(["--input", BPTI, "--output", str(tmp_path), "--num_steps", "2",
              "--num_samples", "2", "--model_scale", "tiny", "--device",
              "cpu", "--refine"])
    models = protein_io.from_pdb_file(tmp_path / "bpti.pdb")
    assert len(models) == 2
    for m in models:
        ca = ESMProtein._from_parsed(m).coordinates[:, 1]
        bond = np.linalg.norm(np.diff(ca, axis=0), axis=-1)
        assert (bond > BOND_LO - 2e-3).all() and (bond < BOND_HI + 2e-3).all()


def test_build_runtime_picks_head_by_mode():
    """As JAX's: the structure head for ddpm, the stock head otherwise."""
    args = cli.get_argparser().parse_args(
        ["--model_scale", "tiny", "--device", "cpu"])
    assert args.mode == "gibbs"
    heads = {}
    for mode in ("gibbs", "eb", "ddpm"):
        rt = cli.build_runtime(argparse.Namespace(**{**vars(args),
                                                     "mode": mode}))
        heads[mode] = rt.trunk.cfg.head_type
    assert heads == {"gibbs": "esm3", "eb": "esm3", "ddpm": "structure"}
