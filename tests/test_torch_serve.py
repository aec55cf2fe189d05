"""The port's serving path against the JAX package: the ddpm multi, packed
and mixed engines and the gibbs engines on carried-over weights (int8
trunk, JAX's draws injected), the mixed router, the coalesced decode, and
the server (``esmdiff_tpu_torch/cli/serve.py``) over HTTP on 127.0.0.1, in
all three modes.

Counterpart of ``tests/test_packed_multi.py`` and ``tests/test_serve.py``."""

import json
import threading
import types
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from esmdiff_tpu.api.generation import EnsembleSampler as JSampler
from esmdiff_tpu.api.generation import GenerationConfig as JConfig
from esmdiff_tpu.api.protein_api import ESM3Runtime as JRuntime
from esmdiff_tpu.cli.serve import RequestError as JRequestError
from esmdiff_tpu.cli.serve import SamplerService as JService
from esmdiff_tpu.models.esm3 import esm3_tiny as jesm3_tiny
from esmdiff_tpu.models.vqvae import DecoderConfig as JDecoderConfig
from esmdiff_tpu.models.vqvae import EncoderConfig as JEncoderConfig
from esmdiff_tpu_torch.api.generation import (EnsembleSampler,
                                              GenerationConfig)
from esmdiff_tpu_torch.api.protein_api import ESM3Runtime
from esmdiff_tpu_torch.cli import serve as serve_cli
from esmdiff_tpu_torch.cli.serve import RequestError, SamplerService, serve
from esmdiff_tpu_torch.models.esm3 import ESM3, esm3_tiny
from esmdiff_tpu_torch.models.vqvae import (DecoderConfig, EncoderConfig,
                                            StructureTokenDecoder)
from esmdiff_tpu_torch.nn.layers import TimestepEmbedder
from test_torch_support import (carry, jax_request_noise_factory,
                                jax_request_uniform_factory)

torch.set_num_threads(2)

SEQ_SHORT = "MKTAYIAKQR"                                   # bucket 32
SEQ_LONG = "MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQAPILSRVG"     # bucket 64
BPTI_PDB = "data/targets/bpti/bpti.pdb"


@pytest.fixture(scope="module")
def samplers():
    """A tiny JAX runtime quantized to int8, and the port's int8 runtime
    carried over from it; both samplers, the port's on JAX's draws."""
    dec_kw = dict(d_model=64, n_heads=2, n_layers=2, dtype="float32")
    trunk_kw = dict(head_type="structure", dtype="float32")
    jrt = JRuntime.random_init(
        seed=3, trunk_cfg=jesm3_tiny(**trunk_kw),
        encoder_cfg=JEncoderConfig(d_model=64, n_heads=2, v_heads=8,
                                   n_layers=2, d_out=16, knn=8),
        decoder_cfg=JDecoderConfig(scan_layers=False, **dec_kw)
    ).quantize("int8")
    rt = ESM3Runtime(
        carry(ESM3(esm3_tiny(quant="int8", **trunk_kw)), jrt.trunk_params),
        carry(StructureTokenDecoder(DecoderConfig(**dec_kw)),
              jrt.decoder_params),
        carry(TimestepEmbedder(64, dtype=torch.float32), jrt.sigma_params),
        device="cpu")
    return (JSampler(jrt),
            EnsembleSampler(rt, noise_factory=jax_request_noise_factory,
                            uniform_factory=jax_request_uniform_factory))


def test_engines_match_jax(samplers):
    """Cross-length packed (the mixed router's pick for this mix), solo and
    same-bucket engines: the port's tokens equal JAX's, and the packed
    engine gives each request its solo tokens."""
    js, ts = samplers
    seqs, counts, seeds = [SEQ_SHORT, SEQ_LONG], [3, 2], [7, 11]
    ref = js.ddpm_ensemble_packed(seqs, counts, num_steps=3, seeds=seeds)
    packed = ts.ddpm_ensemble_packed(seqs, counts, num_steps=3, seeds=seeds)
    assert [p.shape for p in packed] == [(3, 10), (2, 41)]
    mixed = ts.ddpm_ensemble_mixed(seqs, counts, num_steps=3, seeds=seeds)
    for i, (s, c) in enumerate(zip(seqs, counts)):
        np.testing.assert_array_equal(packed[i], ref[i])
        np.testing.assert_array_equal(mixed[i], ref[i])
        solo = ts.ddpm_ensemble(s, c, num_steps=3, seed=seeds[i])
        np.testing.assert_array_equal(solo, packed[i])
        np.testing.assert_array_equal(
            solo, js.ddpm_ensemble_multi([s], [c], num_steps=3,
                                         seeds=[seeds[i]])[0])


def test_same_bucket_multi_matches_jax(samplers):
    """Two requests of one bucket coalesced (pack 4 at B 8, L 32)."""
    js, ts = samplers
    seqs, counts, seeds = [SEQ_SHORT, "GSHMEAGITG"], [2, 3], [1, 2]
    ref = js.ddpm_ensemble_multi(seqs, counts, num_steps=3, seeds=seeds)
    out = ts.ddpm_ensemble_multi(seqs, counts, num_steps=3, seeds=seeds)
    assert ts._pack(8, 32) == 4
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)


def test_gibbs_engines_match_jax_on_structure_head(samplers):
    """gibbs on the int8 fine-tune head (specials shielded, as JAX does
    off the stock head): the mixed engine's per-bucket sub-groups, and
    eb, equal JAX's tokens."""
    js, ts = samplers
    cfg = dict(num_steps=3, temperature=1.4, top_p=0.9)
    seqs, counts, seeds = [SEQ_LONG, SEQ_SHORT], [3, 2], [4, 6]
    ref = js.gibbs_ensemble_mixed(seqs, counts, config=JConfig(**cfg),
                                  seeds=seeds)
    got = ts.gibbs_ensemble_mixed(seqs, counts,
                                  config=GenerationConfig(**cfg), seeds=seeds)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
        assert (g < 4096).all()
    kw = dict(entropy_budget=20.0, top_p=0.9, max_steps=24, seed=3)
    np.testing.assert_array_equal(ts.eb_ensemble(SEQ_SHORT, 2, **kw),
                                  js.eb_ensemble(SEQ_SHORT, 2, **kw))


@pytest.mark.parametrize("lws,counts,T", [
    ([62, 124, 252], [100, 100, 100], 256), ([12, 43], [3, 2], 128),
    ([60, 122, 252], [8, 8, 8], 256), ([60, 122, 252], [1, 1, 1], 256),
    ([30, 500], [4, 1], 512), ([100, 100], [64, 64], 128)])
def test_mixed_route_matches_jax(samplers, lws, counts, T):
    js, ts = samplers
    route, packed, split = ts._mixed_route(lws, counts, T)
    j_route, j_packed, j_split = js._mixed_route(lws, counts, T)
    assert route == j_route
    assert packed == pytest.approx(j_packed) and split == pytest.approx(
        j_split)


def test_decode_multi_matches_solo_decodes(samplers):
    _, ts = samplers
    rng = np.random.default_rng(0)
    toks = [rng.integers(0, 4096, (3, 10)), rng.integers(0, 4096, (2, 41))]
    multi = ts.decode_ensemble_multi([SEQ_SHORT, SEQ_LONG], toks)
    for seq, t, prots in zip([SEQ_SHORT, SEQ_LONG], toks, multi):
        solo = ts.decode_ensemble(seq, t)
        for p, s in zip(prots, solo):
            np.testing.assert_allclose(p.coordinates, s.coordinates,
                                       atol=1e-5, equal_nan=True)


# -- the server ---------------------------------------------------------------

@pytest.fixture(scope="module")
def server():
    runtime = ESM3Runtime.random_init(
        seed=1, trunk_cfg=esm3_tiny(head_type="structure", dtype="float32"),
        decoder_cfg=DecoderConfig(d_model=64, n_heads=2, n_layers=2,
                                  dtype="float32"),
        encoder_cfg=EncoderConfig(d_model=64, n_heads=2, v_heads=8,
                                  n_layers=2, d_out=16, knn=8),
        device="cpu", quant="int8")
    service = SamplerService(EnsembleSampler(runtime), max_samples=16)
    httpd = serve(service, host="127.0.0.1", port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_port}", service
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def _get(url):
    with urllib.request.urlopen(url, timeout=300) as r:
        return r.status, json.loads(r.read())


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def jax_service(samplers):
    return JService(samplers[0], max_samples=16)


_BAD = [
    {},
    {"sequence": "MKT", "mode": "nope"},
    {"sequence": "MKT", "mode": "ddpm", "num_samples": 99},
    {"sequence": "MKT", "mode": "ddpm", "num_samples": 0},
    {"sequence": "MKT", "mode": "ddpm", "format": "xml"},
    {"sequence": "MKT1!z", "mode": "ddpm"},
    {"sequence": "X1", "mode": "ddpm"},
    {"sequence": "MK|T", "mode": "ddpm"},
    {"sequence": "M" * 2049, "mode": "ddpm"},
    {"sequence": "MKT", "mode": "ddpm", "mask_ids": [99]},
    {"sequence": "MKT", "mode": "ddpm", "mask_ids": [1]},
    {"sequence": "M" * 60, "mode": "ddpm", "pdb": "<bpti>"},
    {"sequence": "MKT", "num_samples": 99},
    {"sequence": "MKT", "mode": "eb", "mask_ids": [1]},
    {"sequence": "MKT", "mode": "eb", "format": "xml"},
    {"sequence": "MKT", "mode": "gibbs", "mask_ids": [1]},
    {"sequence": "M" * 60, "mode": "gibbs", "pdb": "<bpti>"},
    {"sequence": "MKZ1", "mode": "eb"},
]


@pytest.mark.parametrize("payload", _BAD, ids=range(len(_BAD)))
def test_request_errors_match_jax(server, jax_service, payload):
    _, service = server
    if payload.get("pdb"):
        payload = {**payload, "pdb": open(BPTI_PDB).read()}
    with pytest.raises(JRequestError) as ref:
        jax_service._parse(payload)
    with pytest.raises(RequestError) as got:
        service._parse(payload)
    assert str(got.value) == str(ref.value)


def test_request_parse_matches_jax(server, jax_service):
    _, service = server
    req = {"sequence": SEQ_LONG, "mode": "ddpm", "num_samples": 3,
           "num_steps": 4, "seed": 5, "format": "tokens"}
    got, ref = service._parse(req), jax_service._parse(req)
    for key in ("seq", "mode", "n", "steps", "seed", "fmt"):
        assert got[key] == ref[key], key
    # the defaults by mode: gibbs, 16 steps outside ddpm, 25 in it
    for req in ({"sequence": SEQ_LONG}, {"sequence": SEQ_LONG, "mode": "eb",
                                         "entropy_budget": 2.5,
                                         "temperature": 0.7}):
        got, ref = service._parse(req), jax_service._parse(req)
        for key in ("mode", "n", "steps", "seed", "temperature", "top_p",
                    "entropy_budget", "fmt"):
            assert got[key] == ref[key], key
    got = service._parse({"pdb": open(BPTI_PDB).read(), "mode": "ddpm"})
    assert len(got["seq"]) == 58 and got["prior_prot"] is not None


def test_http_errors_and_unported(server):
    """Errors over HTTP, and what stays unported: a bad residue, eb with
    ``mask_ids`` and ``mask_ids`` without a 'pdb' prior are 400s (as in
    JAX), inpainting with a 'pdb' prior runs in gibbs and ddpm (200)
    (``--data_parallel`` is ported: tests/test_torch_mesh_sampling.py)."""
    base, _ = server
    pdb = open(BPTI_PDB).read()
    for payload, frag in [
            ({"sequence": "X1"}, "invalid residue"),
            ({"sequence": "MKT", "mask_ids": [1]}, "needs a 'pdb' prior"),
            ({"pdb": pdb, "mode": "eb", "mask_ids": [1]},
             "eb mode does not support inpainting")]:
        status, body = _post(base + "/sample", payload)
        assert status == 400 and frag in body["error"], (payload, body)
    for mode in ("gibbs", "ddpm"):
        status, body = _post(base + "/sample", {
            "pdb": pdb, "mode": mode, "mask_ids": [1, 2], "num_samples": 2,
            "num_steps": 2, "format": "tokens"})
        assert status == 200, body
        assert np.asarray(body["tokens"]).shape == (2, 58)
    status, body = _post(base + "/sample", [1, 2, 3])
    assert status == 400 and "JSON object" in body["error"]
    assert _post(base + "/nope", {})[0] == 404


def test_ddpm_on_a_stock_head_server_matches_jax():
    """A server built for gibbs (stock head) answers ddpm with JAX's 400;
    gibbs and eb parse."""
    def service(cls, head):
        runtime = types.SimpleNamespace(
            trunk=types.SimpleNamespace(
                cfg=types.SimpleNamespace(head_type=head)),
            sigma_embedder=object(), sigma_params={})
        return cls(types.SimpleNamespace(runtime=runtime), max_samples=16)

    port, ref = service(SamplerService, "esm3"), service(JService, "esm3")
    req = {"sequence": "MKT", "mode": "ddpm"}
    with pytest.raises(JRequestError) as want:
        ref._parse(req)
    with pytest.raises(RequestError) as got:
        port._parse(req)
    assert str(got.value) == str(want.value)
    for mode in ("gibbs", "eb"):
        assert port._parse({"sequence": "MKT", "mode": mode})["mode"] == mode


def test_healthz_and_pdb_sample(server):
    """A request with no mode runs gibbs, JAX's default."""
    base, _ = server
    status, body = _post(base + "/sample", {
        "sequence": SEQ_LONG, "num_samples": 2, "num_steps": 2})
    assert status == 200, body
    assert body["pdb"].count("MODEL") == 2 and body["mode"] == "gibbs"
    status, health = _get(base + "/healthz")
    assert status == 200 and health["ok"]
    assert health["device"] == "cpu" and health["card"] is None
    assert health["model"]["quant"] == "int8"
    assert health["latency"]["gibbs"]["count"] >= 1


def _coalesced(base, service, payloads):
    """POST ``payloads`` together while the sample lock is held, so they
    queue into one group; the replies in order."""
    ex = ThreadPoolExecutor(max_workers=len(payloads))
    service._sample_lock.acquire()
    try:
        futs = [ex.submit(_post, base + "/sample", p) for p in payloads]
        deadline = time.time() + 60
        n = 0
        while time.time() < deadline:
            with service._pending_lock:
                n = sum(len(v) for v in service._pending.values())
            if n == len(payloads):
                break
            time.sleep(0.02)
        assert n == len(payloads), f"only {n} requests queued"
    finally:
        service._sample_lock.release()
    res = [f.result(timeout=300) for f in futs]
    ex.shutdown()
    return res


def test_coalesced_requests_are_seed_deterministic(server):
    base, service = server
    req = {"sequence": SEQ_LONG, "num_samples": 3, "num_steps": 2,
           "seed": 123, "format": "tokens", "mode": "ddpm"}
    status, solo = _post(base + "/sample", req)
    assert status == 200, solo
    res = _coalesced(base, service, [
        req,
        {"sequence": "GSHMEAGITGTWYNQLGSTFIVTAGADGALTGTYE", "num_samples": 2,
         "num_steps": 2, "seed": 9, "format": "tokens", "mode": "ddpm"},
        {**req, "num_samples": 1, "seed": 77}])
    for status, body in res:
        assert status == 200 and body["coalesced"] == 3, body
    assert res[0][1]["tokens"] == solo["tokens"]
    _, health = _get(base + "/healthz")
    assert health["coalesce"]["max_group"] >= 3


def test_cross_length_requests_coalesce(server):
    """Requests from different length buckets coalesce into one group
    (the mixed router), each with its solo tokens."""
    base, service = server
    reqs = [{"sequence": SEQ_SHORT, "num_samples": 3, "num_steps": 2,
             "seed": 5, "format": "tokens", "mode": "ddpm"},
            {"sequence": SEQ_LONG, "num_samples": 2, "num_steps": 2,
             "seed": 17, "format": "pdb", "mode": "ddpm"}]
    solos = [_post(base + "/sample", r)[1] for r in reqs]
    res = _coalesced(base, service, reqs)
    assert [b["coalesced"] for _, b in res] == [2, 2]
    assert res[0][1]["tokens"] == solos[0]["tokens"]
    assert res[1][1]["pdb"] == solos[1]["pdb"]


def test_warmup_with_packed_lengths(server):
    base, _ = server
    status, body = _post(base + "/warmup", {
        "lengths": [20], "num_samples": 2, "num_steps": 2,
        "packed_lengths": [10, 41]})
    assert status == 200, body
    assert set(body["warmed"]) == {"20", "packed:10,41"}
    status, body = _post(base + "/warmup", {"lengths": [1]})
    assert status == 400 and "out of range" in body["error"]


def test_gibbs_requests_coalesce_with_solo_tokens(server):
    """Concurrent gibbs requests across two buckets coalesce into one group
    (per-bucket sub-groups), each with its solo tokens; a concurrent ddpm
    request keys a group of its own."""
    base, service = server
    reqs = [{"sequence": SEQ_SHORT, "num_samples": 3, "num_steps": 3,
             "seed": 5, "format": "tokens"},
            {"sequence": SEQ_LONG, "num_samples": 2, "num_steps": 3,
             "seed": 17, "format": "pdb", "mode": "gibbs"},
            {"sequence": "GSHMEAGITG", "num_samples": 2, "num_steps": 3,
             "seed": 8, "format": "tokens"}]
    solos = [_post(base + "/sample", r)[1] for r in reqs]
    res = _coalesced(base, service, reqs + [
        {**reqs[0], "mode": "ddpm", "num_steps": 2}])
    assert [b.get("coalesced") for _, b in res] == [3, 3, 3, None]
    assert all(b["mode"] == "gibbs" for _, b in res[:3])
    assert res[0][1]["tokens"] == solos[0]["tokens"]
    assert res[1][1]["pdb"] == solos[1]["pdb"]
    assert res[2][1]["tokens"] == solos[2]["tokens"]
    assert res[3][1]["mode"] == "ddpm"


def test_eb_requests_run_alone(server):
    """eb never coalesces; it answers with tokens of the request's shape,
    every position committed within its 8 x num_steps steps."""
    base, service = server
    req = {"sequence": SEQ_SHORT, "num_samples": 2, "num_steps": 2,
           "mode": "eb", "entropy_budget": 30.0, "format": "tokens",
           "seed": 3}
    status, solo = _post(base + "/sample", req)
    assert status == 200 and solo["mode"] == "eb", solo
    assert np.asarray(solo["tokens"]).shape == (2, len(SEQ_SHORT))
    assert service.sampler.eb_steps and max(service.sampler.eb_steps) <= 16
    with ThreadPoolExecutor(max_workers=2) as ex:
        res = list(ex.map(lambda r: _post(base + "/sample", r), [req, req]))
    for status, body in res:
        assert status == 200 and "coalesced" not in body
        assert body["tokens"] == solo["tokens"]


def test_warmup_gibbs_and_eb(server):
    base, _ = server
    for mode in ("gibbs", "eb"):
        status, body = _post(base + "/warmup", {
            "lengths": [12, 40], "num_samples": 2, "num_steps": 2,
            "mode": mode, "format": "tokens"})
        assert status == 200 and set(body["warmed"]) == {"12", "40"}, body
