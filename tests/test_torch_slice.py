"""The port's ddpm slice end to end on the CPU, against the JAX package:
BPTI, tiny trunk and decoder carried over from a JAX ``ESM3Runtime``,
injected JAX noise -> equal tokens, coordinates within 1e-3 A; and the
port's CLI writes a well-formed multi-MODEL PDB."""

import numpy as np
import torch

from esmdiff_tpu.api.generation import EnsembleSampler as JSampler
from esmdiff_tpu.api.protein_api import ESM3Runtime as JRuntime
from esmdiff_tpu.models.esm3 import esm3_tiny as jesm3_tiny
from esmdiff_tpu.models.vqvae import DecoderConfig as JDecoderConfig
from esmdiff_tpu.models.vqvae import EncoderConfig as JEncoderConfig
from esmdiff_tpu_torch.api.generation import EnsembleSampler, plan_batches
from esmdiff_tpu_torch.api.protein_api import ESM3Runtime, ESMProtein
from esmdiff_tpu_torch.cli import sample as cli
from esmdiff_tpu_torch.models.esm3 import ESM3, esm3_tiny
from esmdiff_tpu_torch.models.vqvae import DecoderConfig, StructureTokenDecoder
from esmdiff_tpu_torch.nn.layers import TimestepEmbedder
from test_torch_support import carry, jax_request_noise_factory

torch.set_num_threads(2)

BPTI = "data/targets/bpti"
BPTI_PDB = f"{BPTI}/bpti.pdb"


def test_bpti_slice_matches_jax():
    dec_kw = dict(d_model=64, n_heads=2, n_layers=2, dtype="float32")
    jrt = JRuntime.random_init(
        seed=3, trunk_cfg=jesm3_tiny(head_type="structure", dtype="float32"),
        encoder_cfg=JEncoderConfig(d_model=64, n_heads=2, v_heads=8,
                                   n_layers=2, d_out=16, knn=8),
        decoder_cfg=JDecoderConfig(scan_layers=False, **dec_kw))
    trunk = carry(ESM3(esm3_tiny(head_type="structure", dtype="float32")),
                  jrt.trunk_params)
    decoder = carry(StructureTokenDecoder(DecoderConfig(**dec_kw)),
                    jrt.decoder_params)
    sig = carry(TimestepEmbedder(64, dtype=torch.float32), jrt.sigma_params)
    rt = ESM3Runtime(trunk, decoder, sig, device="cpu")

    seq = ESMProtein.from_pdb(BPTI_PDB).sequence
    assert len(seq) == 58
    ref_tokens = JSampler(jrt).ddpm_ensemble(seq, 4, num_steps=4, seed=5)
    sampler = EnsembleSampler(rt, noise_factory=jax_request_noise_factory)
    tokens = sampler.ddpm_ensemble(seq, 4, num_steps=4, seed=5)
    assert tokens.shape == (4, 58)
    np.testing.assert_array_equal(tokens, ref_tokens)

    ref_prots = JSampler(jrt).decode_ensemble(seq, ref_tokens)
    prots = sampler.decode_ensemble(seq, tokens)
    for p, r in zip(prots, ref_prots):
        assert p.sequence == r.sequence
        np.testing.assert_array_equal(np.isnan(p.coordinates),
                                      np.isnan(r.coordinates))
        np.testing.assert_allclose(p.coordinates, r.coordinates, atol=1e-3,
                                   equal_nan=True)


def test_plan_matches_jax():
    from esmdiff_tpu.api.generation import plan_batches as jplan

    for L, n in ((60, 100), (60, 4), (250, 100), (1026, 7)):
        for policy in ("ladder", "single"):
            assert plan_batches(L, n, policy=policy) == jplan(
                L, n, policy=policy)


def test_cli_writes_ensemble_pdb(tmp_path):
    report = cli.main(["--input", BPTI, "--output", str(tmp_path),
                       "--mode", "ddpm", "--num_steps", "2",
                       "--num_samples", "2", "--model_scale", "tiny",
                       "--device", "cpu"])
    text = (tmp_path / "bpti.pdb").read_text()
    lines = text.splitlines()
    assert sum(line.startswith("MODEL") for line in lines) == 2
    atoms = [line for line in lines if line.startswith("ATOM")]
    assert len(atoms) == 2 * (58 * 4 - 1)
    xyz = np.array([[float(a[30:38]), float(a[38:46]), float(a[46:54])]
                    for a in atoms])
    assert np.isfinite(xyz).all()
    assert report[0]["num_samples"] == 2
    assert (tmp_path / "timings.json").exists()
