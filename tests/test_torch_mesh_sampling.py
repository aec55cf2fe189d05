"""The port's data-parallel sampling (``EnsembleSampler(devices=...)``:
one replica of the trunk a device in one process, each batch's rows split
across them) on the CPU with two replicas: ddpm and gibbs equal the
unsplit sampler and the JAX package's mesh sampler on 8 virtual devices
(tokens, JAX's draws injected); eb (its step counts a part) and the
cross-length packed engine (chunks round robin) equal the unsplit ones;
``esmdiff-torch-sample --data_parallel`` and ``--profile``; the server's
``--data_parallel``."""

import functools

import numpy as np
import pytest
import torch

from esmdiff_tpu.api.generation import EnsembleSampler as JSampler
from esmdiff_tpu.api.generation import GenerationConfig as JConfig
from esmdiff_tpu.api.protein_api import ESM3Runtime as JRuntime
from esmdiff_tpu.models.esm3 import esm3_tiny as jesm3_tiny
from esmdiff_tpu.models.vqvae import DecoderConfig as JDecoderConfig
from esmdiff_tpu.parallel import mesh as jmesh
from esmdiff_tpu_torch.api.generation import EnsembleSampler, GenerationConfig
from esmdiff_tpu_torch.api.protein_api import ESM3Runtime, ESMProtein
from esmdiff_tpu_torch.cli import sample as sample_cli
from esmdiff_tpu_torch.cli import serve as serve_cli
from esmdiff_tpu_torch.models.esm3 import ESM3, esm3_tiny
from esmdiff_tpu_torch.models.vqvae import DecoderConfig, StructureTokenDecoder
from esmdiff_tpu_torch.nn.layers import TimestepEmbedder
from test_torch_support import (carry, jax_request_noise_factory,
                                jax_request_uniform_factory)

torch.set_num_threads(2)

BPTI = "data/targets/bpti"
SPLIT = ["cpu", "cpu"]


@functools.lru_cache(maxsize=None)
def _runtimes(head):
    """JAX's tiny runtime (seed 3) and the port's carried over from it
    (samplers copy, never write, them: tests share them)."""
    dec_kw = dict(d_model=32, n_heads=2, n_layers=2, dtype="float32")
    trunk_kw = dict(head_type=head, dtype="float32")
    jrt = JRuntime.random_init(
        seed=3, trunk_cfg=jesm3_tiny(**trunk_kw),
        decoder_cfg=JDecoderConfig(scan_layers=False, **dec_kw))
    rt = ESM3Runtime(
        carry(ESM3(esm3_tiny(**trunk_kw)), jrt.trunk_params),
        carry(StructureTokenDecoder(DecoderConfig(**dec_kw)),
              jrt.decoder_params),
        carry(TimestepEmbedder(64, dtype=torch.float32), jrt.sigma_params),
        device="cpu")
    return jrt, rt


@pytest.fixture(scope="module")
def bpti():
    return ESMProtein.from_pdb(f"{BPTI}/bpti.pdb").sequence


@pytest.mark.parametrize("mode", ["ddpm", "gibbs"])
def test_split_equals_unsplit_and_jax_mesh(mode, bpti):
    """10 ddpm / 9 gibbs samples (one batch of 16, 8 rows a replica;
    JAX's plan on 8 devices, 2 rows a device): the same tokens."""
    jrt, rt = _runtimes("structure" if mode == "ddpm" else "esm3")
    kw = ({"noise_factory": jax_request_noise_factory} if mode == "ddpm"
          else {"uniform_factory": jax_request_uniform_factory})
    mesh = jmesh.make_mesh(8)
    js = JSampler(jrt, mesh=mesh)
    one, split = EnsembleSampler(rt, **kw), EnsembleSampler(rt, devices=SPLIT,
                                                            **kw)
    assert len(split.replicas) == 2 and split.replicas[0].trunk is rt.trunk
    assert split.replicas[1].trunk is not rt.trunk
    with mesh:
        if mode == "ddpm":
            want = js.ddpm_ensemble(bpti, 10, num_steps=3, seed=4)
            got = [s.ddpm_ensemble(bpti, 10, num_steps=3, seed=4)
                   for s in (one, split)]
        else:
            want = js.gibbs_ensemble(bpti, 9, config=JConfig(num_steps=3),
                                     seed=4)
            got = [s.gibbs_ensemble(bpti, 9, seed=4,
                                    config=GenerationConfig(num_steps=3))
                   for s in (one, split)]
    for g in got:
        np.testing.assert_array_equal(g, np.asarray(want))
    assert len({tuple(r) for r in got[1]}) > 1


def test_split_eb_and_packed_equal_unsplit(bpti):
    """eb: the same tokens, a step count a part of each split batch;
    the packed engine at a budget of 2 rows a chunk (3 rows: chunks on
    both replicas): the same tokens."""
    _, rt = _runtimes("esm3")
    one, split = EnsembleSampler(rt), EnsembleSampler(rt, devices=SPLIT)
    np.testing.assert_array_equal(
        one.eb_ensemble(bpti, 9, max_steps=8, seed=2),
        split.eb_ensemble(bpti, 9, max_steps=8, seed=2))
    assert len(split.eb_steps) == 2 * len(one.eb_steps)
    _, rt = _runtimes("structure")
    one, split = EnsembleSampler(rt), EnsembleSampler(rt, devices=SPLIT)
    seqs, counts = ["MKTAYIAKQR", "GSHMEAGITGAW", bpti[:30]], [8, 8, 5]
    kw = dict(num_steps=2, seeds=[1, 2, 3], budget=2 * 128 * 128)
    for a, b in zip(one.ddpm_ensemble_packed(seqs, counts, **kw),
                    split.ddpm_ensemble_packed(seqs, counts, **kw)):
        np.testing.assert_array_equal(a, b)


def test_sample_cli_data_parallel_and_profile(tmp_path):
    """--data_parallel (on the CPU: the one device) writes the PDB of the
    run without it; --profile writes a torch.profiler trace of the
    sampling phase."""
    args = ["--input", BPTI, "--model_scale", "tiny", "--mode", "ddpm",
            "--num_samples", "3", "--num_steps", "2", "--device", "cpu"]
    sample_cli.main([*args, "--output", str(tmp_path / "a")])
    sample_cli.main([*args, "--output", str(tmp_path / "b"),
                     "--data_parallel", "--profile", str(tmp_path / "prof")])
    assert (tmp_path / "a" / "bpti.pdb").read_text() == \
        (tmp_path / "b" / "bpti.pdb").read_text()
    trace = (tmp_path / "prof" / "trace.json").read_text()
    assert '"traceEvents"' in trace and "aten::" in trace


def test_serve_data_parallel(monkeypatch, bpti):
    """A SamplerService over two replicas answers a ddpm request with the
    tokens of one; ``esmdiff-torch-serve --data_parallel`` builds its
    service over the visible devices (on the CPU, the one)."""
    _, rt = _runtimes("structure")
    req = {"sequence": bpti, "mode": "ddpm", "num_samples": 5,
           "num_steps": 2, "format": "tokens", "seed": 3}
    answers = [serve_cli.SamplerService(
        EnsembleSampler(rt, devices=d)).sample(dict(req))["tokens"]
        for d in (None, SPLIT)]
    assert answers[0] == answers[1]

    built = {}

    class Stop:
        server_port = 0

        def serve_forever(self):
            pass

        def server_close(self):
            pass

    def fake_serve(service, host, port):
        built["service"] = service
        return Stop()

    monkeypatch.setattr(serve_cli, "serve", fake_serve)
    serve_cli.main(["--model_scale", "tiny", "--device", "cpu", "--port",
                    "0", "--mode", "ddpm", "--data_parallel"])
    reps = built["service"].sampler.replicas
    assert [r.device.type for r in reps] == ["cpu"]
