"""The SDAR cell (``sdar.block4.L128``) as data and as runs at the tiny
widths on the CPU: the block traffic's requests, the benchmark's SDAR
reference against the repository's plain one, the new readers on an
empty run, the expert bytes by hand, a sound run correct and broken ones
not."""

import importlib.util
import math
import time

import numpy as np
import pytest
import torch

from benchmark import counts, counts_sdar, generator, harness, run
from benchmark.reference import sdar as RS

MAN = harness.manifest()
TRAFFIC = harness.traffic("block4.L128")
CFG = harness.config(MAN, "sdar-30b-a3b")
TINY = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16,
        "moe_intermediate_size": 32, "num_experts": 8,
        "num_experts_per_tok": 2, "vocab_size": 4200, "dtype": "float32"}
TINY_CFG = {**CFG, **TINY}
TINY_D = {"d_model": 64, "n_heads": 4, "n_layers": 2, "ffn_hidden": 256,
          "plddt_bins": 50, "trans_scale": 10.0, "dtype": "float32"}


def plain_reference():
    path = harness.ROOT / "tests" / "sdar_reference.py"
    spec = importlib.util.spec_from_file_location("plain_sdar", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_block_traffic_is_deterministic_with_one_shape():
    def draw(seed):
        return [(r["name"], r["seed"])
                for r in generator.requests(TRAFFIC, seed, 40)]
    assert draw(2 ** 31 + 5) == draw(2 ** 31 + 5)
    assert draw(2 ** 31 + 5) != draw(7)
    buckets = {math.ceil((len(r["sequence"]) + 2) / 32)
               for s in (1, 2 ** 31 + 5, 99)
               for r in generator.requests(TRAFFIC, s, 40)}
    assert len(buckets) == 1
    means = [np.mean([len(r["sequence"]) for r in
                      generator.requests(TRAFFIC, s, TRAFFIC["strata"])])
             for s in range(20)]
    assert np.ptp(means) < 0.1 * np.mean(means)
    # one batch holds every sample
    assert TRAFFIC["max_batch"] >= TRAFFIC["samples"]


def test_config_keeps_the_published_keys():
    published = {"hidden_size": 2048, "num_hidden_layers": 48,
                 "num_attention_heads": 32, "num_key_value_heads": 4,
                 "head_dim": 128, "moe_intermediate_size": 768,
                 "num_experts": 128, "num_experts_per_tok": 8,
                 "vocab_size": 151936, "rope_theta": 1000000,
                 "rms_norm_eps": 1e-06, "norm_topk_prob": True}
    assert {k: CFG[k] for k in published} == published
    assert CFG["reduced"] == []


def test_benchmark_reference_equals_the_plain_one():
    plain = plain_reference()
    g = torch.Generator().manual_seed(4)
    from benchmark import weights_sdar

    W = weights_sdar.make_top(TINY_CFG, 11, "cpu")
    for i in range(2):
        W.update(weights_sdar.make_layer(TINY_CFG, i, 11, "cpu"))
    tokens = torch.randint(0, 4134, (2, 13), generator=g)
    block_ids = torch.cat([torch.zeros(5, dtype=torch.long),
                           1 + torch.arange(8) // 4])
    want = plain.forward(W, TINY_CFG, tokens, block_ids)
    got, = RS.forward(lambda i: W, W, TINY_CFG, [(tokens, block_ids, None)])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    x = torch.tensor([[4096, 4096, 7, 4096]])
    z = torch.randn(1, 4, 4200, generator=g)
    u = torch.rand(1, 4, 4096, generator=g)
    n = torch.tensor([2])
    assert torch.equal(RS.block_update(x, z, u, n),
                       plain.block_update(x, z, u, n))


def test_routing_ties_and_mismatches():
    """A program set that swaps the k-th expert for one within the margin
    is a tie and is taken; one far below it is a mismatch."""
    cfg = dict(TINY_CFG, num_experts=4, num_experts_per_tok=2)
    W = {"l.mlp.gate.weight": torch.eye(4, 4)}
    x = torch.tensor([[3.0, 2.0, 1.99, 0.0]])
    _, ids, bad, ties = RS.route(W, "l.", x, cfg, torch.tensor([[0, 2]]),
                                 margin=0.05)
    assert (bad, ties) == (0, 1) and sorted(ids[0].tolist()) == [0, 2]
    _, ids, bad, ties = RS.route(W, "l.", x, cfg, torch.tensor([[0, 3]]),
                                 margin=0.05)
    assert (bad, ties) == (1, 0) and sorted(ids[0].tolist()) == [0, 1]


@pytest.mark.parametrize("name", ["moe_share.sample", "moe_roofline.sample",
                                  "block_forward_ms.sample"])
def test_new_reader_finds_nothing_in_an_empty_run(name):
    mod = harness.load_file(harness.HERE / "metrics" / f"{name}.py",
                            "t_" + name.replace(".", "_"))
    assert mod.read({"spans": {}, "window_s": 1.0, "trace": None}) is None
    assert mod.read({"spans": {}, "window_s": 1.0, "trace": None,
                     "config": CFG}) is None
    assert mod.read({"spans": {}, "window_s": 1.0, "trace": None,
                     "config": CFG, "eager": None}) is None


def test_expert_bytes_by_hand():
    # 2 experts hit, 3 pairs, d 2048, I 768: weights 2 x 3 x 2048 x 768 x 2
    # bytes; each pair 2048 in, 2 x 1536 gate/up out and in, 2 x 768
    # activation out and in, 2048 out, 2 bytes each
    assert counts_sdar.expert_bytes(CFG, 2, 3) == \
        2 * 3 * 2048 * 768 * 2 + 3 * (2048 + 3072 + 1536 + 2048) * 2
    assert counts_sdar.expert_flops(CFG, 3) == 6 * 2048 * 768 * 3
    bound = counts_sdar.expert_bound_s(CFG, 128, 3200)
    assert bound == pytest.approx(counts_sdar.expert_bytes(CFG, 128, 3200)
                                  / counts.PEAK_HBM_BYTES_PER_S)


def tiny_job(control="none"):
    job = run.job_for(run.parse(["--workload", "sdar.block4.L128", "--seed",
                                 "2147483659", "--seconds", "0"]))
    job["config"] = dict(job["config"], decoder=TINY_D, **TINY)
    job["traffic"] = dict(job["traffic"], samples=12, max_batch=16,
                          capture=dict(job["traffic"]["capture"],
                                       requests=1, forwards=3, deep=1,
                                       rows=4, rows_rmsd=12))
    job["device"], job["t_start"] = "cpu", time.monotonic()
    job["control"] = control
    return job


def tiny_run(control="none"):
    job = tiny_job(control)
    result = harness.runner("sample_block").run(job)
    return harness.result_line(job, result, {"platform": "cpu"})


def test_sound_run_is_correct():
    line = tiny_run()
    assert line["correct"], line["checks"]
    assert line["checks"]["stage_err"]["value"] < 1e-5
    assert line["checks"]["logits_rel_err"]["value"] < 1e-5


def test_top7_routing_is_not_correct():
    line = tiny_run("top7")
    assert not line["correct"]
    assert line["checks"]["route_mismatch"]["value"] > 0


def test_controls_are_read_beside_the_program():
    """Asked for, each reference-side control is read in the same run as
    the program, on its own number: W8A8 experts on ``stage_err``, the
    reference in float8 on ``logits_rel_err``, its router in float8 on
    ``route_mismatch``."""
    job = tiny_job()
    job["controls"] = ["int8", "fp8", "fp8_router"]
    numbers = harness.runner("sample_block").run(job)["numbers"]
    assert numbers["int8.stage_err"] > 100 * numbers["stage_err"]
    assert numbers["fp8.logits_rel_err"] > \
        job["limits"]["logits_rel_err"] > numbers["logits_rel_err"]
    assert numbers["fp8_router.route_mismatch"] >= 0
    assert numbers["route_mismatch"] == numbers["replay_eager_routes"] == 0


def test_moe_readers_read_the_eager_request():
    eager = {"experts_s": 0.5, "busy_s": 2.0, "experts_hit": 128 * 48,
             "tokens_routed": 400 * 8 * 48}
    ctx = {"config": CFG, "eager": eager}
    share = harness.load_file(harness.HERE / "metrics"
                              / "moe_share.sample.py", "t_moe_share")
    roof = harness.load_file(harness.HERE / "metrics"
                             / "moe_roofline.sample.py", "t_moe_roof")
    assert share.read(ctx) == 25.0
    assert roof.read(ctx) == pytest.approx(100.0 * counts_sdar.expert_bound_s(
        CFG, 128 * 48, 400 * 8 * 48) / 0.5)


def test_float8_reference_control_is_not_correct():
    line = tiny_run("fp8")
    assert not line["correct"]
    checks = line["checks"]
    assert checks["logits_rel_err"]["value"] > \
        checks["logits_rel_err"]["limit"]


def test_altered_token_is_not_correct(monkeypatch):
    from esmdiff_tpu_torch.diffusion import block

    update = block.block_update

    def wrong(*args, **kwargs):
        x = update(*args, **kwargs)
        return torch.where(x == 4096, x, (x + 1) % 4096)

    monkeypatch.setattr(block, "block_update", wrong)
    line = tiny_run()
    assert not line["correct"]
    assert line["checks"]["update_mismatch"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("control", ["int8", "top7", "fp8", "fp8_router"])
def test_sdar_controls_are_not_correct_on_the_card(control):
    """At the published widths: W8A8 expert products, routing at 7
    experts a token, the reference in float8 and its router in float8,
    each in the program's place, read not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    job = run.job_for(run.parse(["--workload", "sdar.block4.L128", "--seed",
                                 str(2 ** 31 + 23), "--seconds", "0"]))
    job["device"], job["t_start"] = torch.device("cuda", 0), time.monotonic()
    job["per_layer"], job["control"] = [], control
    job["traffic"]["capture"]["requests"] = 1
    result = harness.runner("sample_block").run(job)
    line = harness.result_line(job, result, harness.card())
    assert not line["correct"], line["checks"]
