"""Inpainting and the encode path on the port against the JAX package, on a
tiny structure-head runtime carried over from JAX's (trunk, decoder, sigma
embedder and encoder), in fp32 on the CPU: ``encode`` (also multi-chain
``from_npz``) and ``encode_decode``; ddpm with ``mask_ids``, with
``filled_ids`` and with ``ref_compat``, and gibbs with a coordinate prior,
token for token with JAX's draws injected; the CLI's inpainting flags; the
server's ``mask_ids`` requests (and eb's 400); ``cli/dump`` against JAX's
arrays."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from esmdiff_tpu.api.generation import EnsembleSampler as JSampler
from esmdiff_tpu.api.generation import GenerationConfig as JConfig
from esmdiff_tpu.api.protein_api import ESM3Runtime as JRuntime
from esmdiff_tpu.api.protein_api import ESMProtein as JProtein
from esmdiff_tpu.cli import dump as jdump
from esmdiff_tpu.cli.serve import SamplerService as JService
from esmdiff_tpu.models.esm3 import esm3_tiny as jesm3_tiny
from esmdiff_tpu.models.vqvae import DecoderConfig as JDecoderConfig
from esmdiff_tpu.models.vqvae import EncoderConfig as JEncoderConfig
from esmdiff_tpu_torch.api.generation import EnsembleSampler, GenerationConfig
from esmdiff_tpu_torch.api.protein_api import ESM3Runtime, ESMProtein
from esmdiff_tpu_torch.cli import dump as tdump
from esmdiff_tpu_torch.cli import sample as cli
from esmdiff_tpu_torch.cli.serve import SamplerService, serve
from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.core import protein as protein_io
from esmdiff_tpu_torch.models.esm3 import ESM3, esm3_tiny
from esmdiff_tpu_torch.models.vqvae import DecoderConfig, StructureTokenDecoder
from esmdiff_tpu_torch.nn.layers import TimestepEmbedder
from test_torch_support import (carry, carry_encoder,
                                jax_request_noise_factory,
                                jax_request_uniform_factory)

torch.set_num_threads(2)

BPTI = "data/targets/bpti"
BPTI_PDB = f"{BPTI}/bpti.pdb"
SPAN = list(range(10, 25))      # one contiguous span of 15 residues
CFG = dict(num_steps=4, temperature=1.4, top_p=0.9)


@pytest.fixture(scope="module")
def runtimes():
    """A tiny JAX structure-head runtime and the port's, carried over from
    it (the encoder too)."""
    dec_kw = dict(d_model=64, n_heads=2, n_layers=2, dtype="float32")
    trunk_kw = dict(head_type="structure", dtype="float32")
    jrt = JRuntime.random_init(
        seed=11, trunk_cfg=jesm3_tiny(**trunk_kw),
        encoder_cfg=JEncoderConfig(d_model=64, n_heads=2, v_heads=8,
                                   n_layers=2, d_out=16, knn=8),
        decoder_cfg=JDecoderConfig(scan_layers=False, **dec_kw))
    rt = ESM3Runtime(
        carry(ESM3(esm3_tiny(**trunk_kw)), jrt.trunk_params),
        carry(StructureTokenDecoder(DecoderConfig(**dec_kw)),
              jrt.decoder_params),
        carry(TimestepEmbedder(64, dtype=torch.float32), jrt.sigma_params),
        device="cpu", encoder=carry_encoder(jrt))
    return jrt, rt


@pytest.fixture(scope="module")
def samplers(runtimes):
    jrt, rt = runtimes
    return JSampler(jrt), EnsembleSampler(
        rt, noise_factory=jax_request_noise_factory,
        uniform_factory=jax_request_uniform_factory)


def _two_chain_npz(path):
    """BPTI written as a preprocess-layout example of two chains (a break
    after residue 29) with residue 40's backbone missing."""
    prot = protein_io.from_pdb_file(BPTI_PDB)
    prot = prot[0] if isinstance(prot, list) else prot
    mask = prot.atom_mask.copy()
    mask[40, :3] = 0
    chain = np.zeros(len(prot.sequence), np.int32)
    chain[30:] = 1
    np.savez(path, sequence=prot.sequence, atom_positions=prot.atom_positions,
             atom_mask=mask, chain_index=chain)


def test_encode_matches_jax(runtimes, tmp_path):
    jrt, rt = runtimes
    prot = ESMProtein.from_pdb(BPTI_PDB)
    jprot = JProtein.from_pdb(BPTI_PDB)
    got, ref = rt.encode(prot), jrt.encode(jprot)
    np.testing.assert_array_equal(got.sequence, ref.sequence)
    np.testing.assert_array_equal(got.structure, ref.structure)
    assert got.structure[0] == C.STRUCTURE_BOS_TOKEN
    assert got.structure[-1] == C.STRUCTURE_EOS_TOKEN
    # residues set to inf are unknown
    prot.coordinates[SPAN] = np.inf
    jprot.coordinates[SPAN] = np.inf
    got, ref = rt.encode(prot), jrt.encode(jprot)
    np.testing.assert_array_equal(got.structure, ref.structure)
    assert (got.structure[[i + 1 for i in SPAN]]
            == C.STRUCTURE_MASK_TOKEN).all()
    # two chains: a chainbreak on both tracks, the missing residue masked
    _two_chain_npz(tmp_path / "two.npz")
    tp, jp = (ESMProtein.from_npz(tmp_path / "two.npz"),
              JProtein.from_npz(tmp_path / "two.npz"))
    assert tp.sequence == jp.sequence and tp.sequence[30] == "|"
    np.testing.assert_array_equal(tp.coordinates, jp.coordinates)
    got, ref = rt.encode(tp), jrt.encode(jp)
    np.testing.assert_array_equal(got.structure, ref.structure)
    assert got.structure[31] == C.STRUCTURE_CHAINBREAK_TOKEN
    assert got.structure[42] == C.STRUCTURE_MASK_TOKEN


def test_encode_decode_matches_jax(runtimes):
    jrt, rt = runtimes
    coords, pred = rt.encode_decode(BPTI_PDB)
    jcoords, jpred = jrt.encode_decode(BPTI_PDB)
    np.testing.assert_array_equal(coords, jcoords)
    np.testing.assert_allclose(pred, jpred, atol=1e-3, equal_nan=True)


def _known_positions_kept(tokens, prior):
    """Every position whose prior token is a code keeps it in every
    sample."""
    known = prior != C.STRUCTURE_MASK_TOKEN
    assert known.any() and (~known).any()
    kept = tokens[:, known]
    np.testing.assert_array_equal(kept,
                                  np.broadcast_to(prior[known], kept.shape))


@pytest.mark.parametrize("how", ["mask_ids", "filled_ids", "ref_compat"])
def test_ddpm_inpainting_matches_jax(samplers, runtimes, how):
    """BPTI, 5 samples: one batch of 8 at bucket 64, packed 2 to a row."""
    js, ts = samplers
    jrt, rt = runtimes
    prot = ESMProtein.from_pdb(BPTI_PDB)
    structure = rt.encode(prot).structure
    np.testing.assert_array_equal(
        structure, jrt.encode(JProtein.from_pdb(BPTI_PDB)).structure)
    keep = [i for i in range(len(prot.sequence)) if i not in SPAN]
    kw = {"mask_ids": dict(mask_ids=SPAN),
          "filled_ids": dict(filled_ids=keep),
          "ref_compat": dict(mask_ids=SPAN, ref_compat=True)}[how]
    ref = js.ddpm_ensemble(prot.sequence, 5, num_steps=3, seed=4,
                           structure_tokens=structure, **kw)
    got = ts.ddpm_ensemble(prot.sequence, 5, num_steps=3, seed=4,
                           structure_tokens=structure, **kw)
    assert got.shape == (5, 58)
    np.testing.assert_array_equal(got, ref)
    off = 0 if how == "ref_compat" else 1
    prior = structure[1:-1].copy()
    prior[[i + off - 1 for i in SPAN]] = C.STRUCTURE_MASK_TOKEN
    _known_positions_kept(got, prior)
    with pytest.raises(ValueError, match="structure_tokens"):
        ts.ddpm_ensemble(prot.sequence, 2, mask_ids=SPAN)


@pytest.mark.parametrize("how", ["mask_ids", "coordinates"])
def test_gibbs_inpainting_matches_jax(samplers, runtimes, how):
    """gibbs with a coordinate prior: ``mask_ids`` (the span becomes '_'
    and inf), or coordinates alone with a NaN span; the known residues
    start at their encoded codes and are not decoded."""
    js, ts = samplers
    _, rt = runtimes
    prot = ESMProtein.from_pdb(BPTI_PDB)
    coords = prot.coordinates.copy()
    kw = dict(mask_ids=SPAN)
    if how == "coordinates":
        coords[SPAN] = np.nan
        kw = {}
    ref = js.gibbs_ensemble(prot.sequence, 5, config=JConfig(**CFG), seed=2,
                            coordinates=coords, **kw)
    got = ts.gibbs_ensemble(prot.sequence, 5, config=GenerationConfig(**CFG),
                            seed=2, coordinates=coords, **kw)
    np.testing.assert_array_equal(got, ref)
    prior_coords = coords.copy()
    prior_coords[SPAN] = np.inf
    seq = "".join("_" if i in SPAN and how == "mask_ids" else ch
                  for i, ch in enumerate(prot.sequence))
    prior = rt.encode(ESMProtein(seq, prior_coords)).structure[1:-1]
    _known_positions_kept(got, prior)


def _pdb_xyz(text):
    atoms = [line for line in text.splitlines() if line.startswith("ATOM")]
    return np.array([[float(a[c:c + 8]) for c in (30, 38, 46)]
                     for a in atoms])


@pytest.mark.parametrize("mode,flag", [("ddpm", "--mask_ids"),
                                       ("ddpm", "--filled_ids"),
                                       ("gibbs", "--mask_ids")])
def test_cli_inpainting_flags(runtimes, tmp_path, mode, flag):
    """The CLI's flags reach the engines: its PDB is the engine's ensemble
    (default draws, plan 'single'), decoded."""
    _, rt = runtimes
    prot = ESMProtein.from_pdb(BPTI_PDB)
    ids = SPAN if flag == "--mask_ids" else [
        i for i in range(len(prot.sequence)) if i not in SPAN]
    cli.main(["--input", BPTI, "--output", str(tmp_path), "--mode", mode,
              "--num_steps", "3", "--num_samples", "3", "--seed", "6",
              "--device", "cpu", flag, ",".join(map(str, ids))],
             runtime=rt)
    sampler = EnsembleSampler(rt, plan_policy="single")
    if mode == "ddpm":
        key = "mask_ids" if flag == "--mask_ids" else "filled_ids"
        tokens = sampler.ddpm_ensemble(
            prot.sequence, 3, num_steps=3, seed=6,
            structure_tokens=rt.encode(prot).structure, **{key: ids})
    else:
        tokens = sampler.gibbs_ensemble(
            prot.sequence, 3, config=GenerationConfig(num_steps=3), seed=6,
            coordinates=prot.coordinates, mask_ids=ids)
    want = protein_io.ensemble_to_pdb(
        [p.to_protein() for p in sampler.decode_ensemble(prot.sequence,
                                                         tokens)])
    text = (tmp_path / "bpti.pdb").read_text()
    assert text.count("MODEL") == 3
    np.testing.assert_allclose(_pdb_xyz(text), _pdb_xyz(want), atol=1e-3)


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_server_inpainting(runtimes):
    """``mask_ids`` with a 'pdb' prior over HTTP, in ddpm and gibbs: the
    engine's tokens for the same request; eb with ``mask_ids`` is JAX's
    400; the parsed request equals JAX's (``ref_compat`` included)."""
    jrt, rt = runtimes
    service = SamplerService(EnsembleSampler(rt), max_samples=16)
    pdb = open(BPTI_PDB).read()
    prot = ESMProtein.from_pdb_string(pdb)
    req = {"pdb": pdb, "mode": "ddpm", "mask_ids": SPAN, "ref_compat": True,
           "num_samples": 3, "num_steps": 3, "seed": 2}
    got, ref = service._parse(req), JService(JSampler(jrt))._parse(req)
    for key in ("seq", "mode", "n", "steps", "seed", "mask_ids",
                "ref_compat"):
        assert got[key] == ref[key], key
    httpd = serve(service, host="127.0.0.1", port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_port}/sample"
    try:
        sampler = EnsembleSampler(rt)
        for mode in ("ddpm", "gibbs"):
            status, body = _post(url, {"pdb": pdb, "mode": mode,
                                       "mask_ids": SPAN, "num_samples": 3,
                                       "num_steps": 3, "seed": 2,
                                       "format": "tokens"})
            assert status == 200, body
            if mode == "ddpm":
                want = sampler.ddpm_ensemble(
                    prot.sequence, 3, num_steps=3, seed=2, mask_ids=SPAN,
                    structure_tokens=rt.encode(prot).structure)
            else:
                want = sampler.gibbs_ensemble(
                    prot.sequence, 3, config=GenerationConfig(num_steps=3),
                    seed=2, coordinates=prot.coordinates, mask_ids=SPAN)
            np.testing.assert_array_equal(np.asarray(body["tokens"]), want)
        status, body = _post(url, {"pdb": pdb, "mode": "ddpm",
                                   "mask_ids": SPAN[:3], "num_samples": 2,
                                   "num_steps": 2})
        assert status == 200 and body["pdb"].count("MODEL") == 2
        status, body = _post(url, {"pdb": pdb, "mode": "eb", "mask_ids": [1]})
        assert status == 400 and "eb mode does not support" in body["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_dump_matches_jax(runtimes, tmp_path, monkeypatch):
    """The port's dump writes JAX's arrays under JAX's names, for a PDB
    and a two-chain preprocess example, embeddings to 1e-4."""
    jrt, rt = runtimes
    src = tmp_path / "in"
    src.mkdir()
    (src / "bpti.pdb").write_text(open(BPTI_PDB).read())
    _two_chain_npz(src / "two.npz")
    (src / "broken.pdb").write_text("not a structure\n")
    monkeypatch.setattr(JRuntime, "random_init",
                        classmethod(lambda cls, **kw: jrt))
    jdump.main([str(src), str(tmp_path / "jax"), "--with_embeddings",
                "--model_scale", "tiny"])
    n = tdump.main([str(src), str(tmp_path / "port"), "--with_embeddings",
                    "--device", "cpu"], runtime=rt)
    assert n == 2
    for stem in ("bpti", "two"):
        with np.load(tmp_path / "jax" / f"{stem}.npz") as ref, \
                np.load(tmp_path / "port" / f"{stem}.npz") as got:
            assert sorted(got.files) == sorted(ref.files) == [
                "coordinates", "embeddings", "sequence_tokens",
                "structure_tokens"]
            for key in ("sequence_tokens", "structure_tokens",
                        "coordinates"):
                assert got[key].dtype == ref[key].dtype, key
                np.testing.assert_array_equal(got[key], ref[key])
            np.testing.assert_allclose(got["embeddings"], ref["embeddings"],
                                       atol=1e-4)
    with pytest.raises(FileNotFoundError, match="trunk.pt"):
        tdump.main([str(src), str(tmp_path / "x"), "--ckpt", "trunk.pt"])
