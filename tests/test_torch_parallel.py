"""The port's data-parallel strategies on 2 gloo ranks (CPU), against the
JAX package's run of the same strategy on 2 virtual devices and against
the port on one process: ``ddp``, ``zero2`` and ``fsdp`` (3 steps of the
tiny MDLM, JAX's init and JAX's draws carried over: losses and grad norms
1e-5 relative and every parameter 1e-5 against JAX, 1e-6 relative and
1e-5 against one rank), packed training under ``ddp``, ``fsdp`` with
bfloat16 parameters (2e-2 against one rank), resume from a
checkpoint written across the ranks (equal, bit for bit, to the
uninterrupted run), ``esmdiff-torch-train`` under ``fsdp`` and
``dp1xtp2`` at 2 ranks (its checkpoints in the one-device layout: equal
to the one-process run's at 1e-5, and loaded by ``--ckpt`` unchanged), the
VQ-VAE trainer's ``data_parallel`` (2 ranks = 1 rank), and what raises.

The ranks are processes of ``tests/torch_ranks.py`` (``run_ranks``); one
launch runs every 2-rank job of this file."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from esmdiff_tpu_torch.cli import sample as sample_cli
from esmdiff_tpu_torch.cli import train as train_cli
from esmdiff_tpu_torch.convert import checkpoints, flax_to_state_dict
from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.models.vqvae import DecoderConfig, EncoderConfig
from esmdiff_tpu_torch.parallel import mesh as pmesh
from esmdiff_tpu_torch.parallel import pp as ppp
from esmdiff_tpu_torch.train import data as tdata
from esmdiff_tpu_torch.train import state as tstate
from esmdiff_tpu_torch.train import vqvae as tvq
from esmdiff_tpu_torch.utils.checkpoint import load_params
from test_torch_support import (STEP_OPTIM, assert_state_close,
                                jax_strategy_run, jax_tiny_mdlm,
                                one_rank_steps, record_step_draws)
from torch_ranks import run_ranks

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
STRATEGIES = ("ddp", "zero2", "fsdp")
PACK_S = 4
VQ_ENC = dict(d_model=32, n_heads=2, v_heads=4, n_layers=2, d_out=8,
              n_codes=64, knn=8)
VQ_DEC = dict(d_model=32, n_heads=2, n_layers=2, dtype="float32",
              predict_ptm=False)
TRAIN_ARGV = ["--config", str(ROOT / "configs/mdlm_smoke.yaml"), "--device",
              "cpu", "trainer.max_epochs=1", "trainer.print_config=false"]


def _padded_batch():
    """4 rows of 32, 25, 12 and 30 residues: the ranks' rows hold different
    token counts, so a rank's mean is not its part of the global one."""
    rng = np.random.default_rng(0)
    return tdata.pad_collate(
        [{"sequence_tokens": rng.integers(4, 24, n).astype(np.int32),
          "structure_tokens": rng.integers(0, 4096, n).astype(np.int32)}
         for n in (32, 25, 12, 30)], 16)


def _packed_batch():
    rng = np.random.default_rng(1)
    rows = [[{"sequence_tokens": rng.integers(4, 24, n).astype(np.int32),
              "structure_tokens": rng.integers(0, 4096, n).astype(np.int32)}
             for n in lens] for lens in ([20, 30, 10], [40], [25, 25], [60])]
    return tdata.pack_collate(rows, 64)


def _corpus(root: Path):
    rng = np.random.RandomState(0)
    for i in range(8):
        L = rng.randint(20, 70)
        np.savez(root / f"chain{i}.npz",
                 sequence_tokens=np.concatenate(
                     [[C.SEQUENCE_BOS_TOKEN], rng.randint(4, 24, L),
                      [C.SEQUENCE_EOS_TOKEN]]).astype(np.int32),
                 structure_tokens=np.concatenate(
                     [[C.STRUCTURE_BOS_TOKEN], rng.randint(0, 4096, L),
                      [C.STRUCTURE_EOS_TOKEN]]).astype(np.int32))


def _vq_corpus(path: Path):
    from test_torch_vqvae_train import toy_corpus

    coords, lengths = toy_corpus()
    np.savez(path, coords=coords, lengths=lengths, val_idx=np.arange(2))
    return coords, lengths


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's runs, the one-process runs and every 2-rank job."""
    tmp = tmp_path_factory.mktemp("parallel")
    jm, params = jax_tiny_mdlm()
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in flax_to_state_dict(params).items()},
               tmp / "params.pt")
    out = {"jax": {}, "one": {}}
    for name, batch, S in (("padded", _padded_batch(), 0),
                           ("packed", _packed_batch(), PACK_S)):
        np.savez(tmp / f"{name}.npz", **batch)
        records = record_step_draws(batch, packed_segments=S)
        torch.save(records, tmp / f"{name}_records.pt")
        out["one"][name] = one_rank_steps(tmp / "params.pt", batch, records,
                                          packed_segments=S)
        for strategy in (STRATEGIES if name == "padded" else ("ddp",)):
            out["jax"][(name, strategy)] = jax_strategy_run(
                jm, params, batch, strategy, packed_segments=S)

    def steps(name, strategy, batch="padded", **kw):
        return dict(name=name, kind="steps", strategy=strategy,
                    params=str(tmp / "params.pt"),
                    batch=str(tmp / f"{batch}.npz"),
                    records=str(tmp / f"{batch}_records.pt"), steps=3,
                    optim=STEP_OPTIM,
                    max_segments=PACK_S if batch == "packed" else 0, **kw)

    (tmp / "corpus").mkdir()
    _corpus(tmp / "corpus")
    coords, lengths = _vq_corpus(tmp / "vq.npz")
    enc, dec = EncoderConfig(**VQ_ENC), DecoderConfig(**VQ_DEC)
    vq = tvq.VQVAE(enc, dec)
    tvq.init_vqvae(vq, 0)
    torch.save(vq.state_dict(), tmp / "vq_params.pt")
    vq_kw = dict(steps=4, batch=4, restart_every=2, augment=True)
    jobs = [steps(s, s) for s in STRATEGIES]
    jobs.append(steps("packed_ddp", "ddp", batch="packed"))
    for s in ("zero2", "fsdp"):
        jobs.append(steps(f"{s}_first2", s, ckpt=str(tmp / f"ck_{s}")))
        jobs[-1]["steps"] = 2
        jobs.append(steps(f"{s}_resumed", s, resume=str(tmp / f"ck_{s}"),
                          resume_step=str(tmp / f"ck_{s}" / "step_2")))
    jobs.append(steps("fsdp_bf16", "fsdp", param_dtype="bfloat16"))
    out["one_bf16"] = one_rank_steps(tmp / "params.pt", _padded_batch(),
                                     torch.load(tmp / "padded_records.pt"),
                                     param_dtype=torch.bfloat16)
    jobs.append(dict(name="vqvae", kind="vqvae", corpus=str(tmp / "vq.npz"),
                     params=str(tmp / "vq_params.pt"), enc=VQ_ENC,
                     dec=VQ_DEC, **vq_kw))
    for s in ("fsdp", "dp1xtp2"):
        jobs.append(dict(name=f"cli_{s}", kind="train_cli", argv=[
            *TRAIN_ARGV, f"data.path={tmp / 'corpus'}",
            f"trainer.ckpt_dir={tmp / ('run_' + s)}",
            f"trainer.strategy={s}"]))
    out["ranks"] = run_ranks(tmp, 2, jobs, timeout=300)
    out["cli_one"] = train_cli.main([
        *TRAIN_ARGV, f"data.path={tmp / 'corpus'}",
        f"trainer.ckpt_dir={tmp / 'run_one'}"])
    out["vq_one"] = tvq.train_vqvae(
        enc, dec, coords, lengths, val_idx=np.arange(2), seed=0, log=None,
        device="cpu", params=torch.load(tmp / "vq_params.pt"),
        augment=tvq.VQAugmentConfig(), steps=4, batch=4, restart_every=2)
    out["tmp"] = tmp
    return out


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategy_matches_jax_and_one_rank(runs, strategy):
    """Both ranks report the global batch's loss and grad norm; the rows
    split 2 + 2; rank 0's gathered parameters equal JAX's and the one-rank
    run's (the first update has lr 0: a schedule that did not reach
    ZeRO's partitioned AdamW would show there)."""
    r0, r1 = (r[strategy] for r in runs["ranks"])
    assert (r0["rows"], r1["rows"]) == ((0, 2), (2, 4))
    assert r0["loss"] == r1["loss"] and r0["grad_norm"] == r1["grad_norm"]
    j_loss, j_norm, j_params = runs["jax"][("padded", strategy)]
    o_loss, o_norm, o_params = runs["one"]["padded"]
    _close(r0["loss"], j_loss, 1e-5)
    _close(r0["grad_norm"], j_norm, 1e-5)
    assert j_norm[0] > STEP_OPTIM["grad_clip"]  # clipped
    assert_state_close(r0["params"], j_params)
    _close(r0["loss"], o_loss, 1e-6)
    _close(r0["grad_norm"], o_norm, 1e-6)
    assert_state_close(r0["params"], {k: v.numpy()
                                      for k, v in o_params.items()})


def test_packed_training_under_ddp(runs):
    """Packed rows (3, 1, 2 and 1 segments) split over 2 ranks: the
    permuted segment times are the global batch's."""
    r0 = runs["ranks"][0]["packed_ddp"]
    j_loss, j_norm, j_params = runs["jax"][("packed", "ddp")]
    o_loss, o_norm, o_params = runs["one"]["packed"]
    _close(r0["loss"], j_loss, 1e-5)
    _close(r0["grad_norm"], j_norm, 1e-5)
    assert_state_close(r0["params"], j_params)
    _close(r0["loss"], o_loss, 1e-6)
    assert_state_close(r0["params"], {k: v.numpy()
                                      for k, v in o_params.items()})


def test_fsdp_with_bfloat16_parameters(runs):
    """model.param_dtype=bfloat16 under fsdp: the float32 LayerNorms are
    units of their own (FSDP2 needs one dtype a unit), every parameter
    keeps its dtype, and the losses and grad norms are the one-process
    bf16 run's within 2e-2 relative (bf16 gradients summed over 2 ranks
    round otherwise than one backward's)."""
    got = runs["ranks"][0]["fsdp_bf16"]
    o_loss, o_norm, o_params = runs["one_bf16"]
    assert {k: v.dtype for k, v in got["params"].items()} == \
        {k: v.dtype for k, v in o_params.items()}
    assert {v.dtype for v in o_params.values()} == {torch.float32,
                                                    torch.bfloat16}
    _close(got["loss"], o_loss, 2e-2)
    _close(got["grad_norm"], o_norm, 2e-2)


@pytest.mark.parametrize("strategy", ("zero2", "fsdp"))
def test_resume_equals_uninterrupted(runs, strategy):
    """2 steps, a checkpoint written across the ranks (ZeRO's consolidated
    moments, FSDP's gathered shards: the one-device layout), a fresh state
    restored from it, 1 more step: the parameters equal the uninterrupted
    3 steps' bit for bit."""
    r0 = runs["ranks"][0]
    first, resumed, whole = (r0[f"{strategy}_first2"],
                             r0[f"{strategy}_resumed"], r0[strategy])
    assert first["loss"] + resumed["loss"] == whole["loss"]
    for k, v in whole["params"].items():
        assert torch.equal(resumed["params"][k], v), k
    step = runs["tmp"] / f"ck_{strategy}" / "step_2"
    opt = torch.load(step / "optimizer.pt", weights_only=False)
    n = len(whole["params"])
    assert sorted(opt["state"]) == list(range(n))
    assert all(s["exp_avg"].shape == whole["params"][k].shape for s, k in
               zip((opt["state"][i] for i in range(n)), whole["params"]))


@pytest.mark.parametrize("strategy", ("fsdp", "dp1xtp2"))
def test_train_cli_checkpoints_load_into_sampling(runs, strategy, tmp_path):
    """esmdiff-torch-train at 2 ranks: the same steps and val loss as one
    process, a checkpoint in the one-device layout equal to the
    one-process run's (1e-5), which --ckpt samples from unchanged."""
    tmp = runs["tmp"]
    got = runs["ranks"][0][f"cli_{strategy}"]
    want = runs["cli_one"]
    assert runs["ranks"][1][f"cli_{strategy}"]["steps"] == got["steps"]
    assert got["steps"] == want["steps"]
    _close(got["best_val_loss"], want["best_val_loss"], 1e-5)
    run = tmp / f"run_{strategy}"
    index = json.loads((run / "ckpt" / "index.json").read_text())
    saved = load_params(index[0]["path"])
    one = load_params(json.loads(
        (tmp / "run_one" / "ckpt" / "index.json").read_text())[0]["path"])
    assert_state_close(saved, {k: v.numpy() for k, v in one.items()})
    rt = checkpoints.load_runtime(run / "ckpt", device="cpu")
    for k, v in rt.trunk.state_dict().items():
        assert torch.equal(v, saved[f"net.{k}"]), k
    report = sample_cli.main([
        "--ckpt", str(run / "ckpt"), "--mode", "ddpm", "--input",
        str(ROOT / "data/targets/bpti"), "--output", str(tmp_path),
        "--num_samples", "2", "--num_steps", "2", "--device", "cpu"])
    text = (tmp_path / "bpti.pdb").read_text()
    assert text.count("MODEL") >= 2 and report[0]["L"] == 58


def test_vqvae_data_parallel_equals_one_rank(runs):
    """train_vqvae(data_parallel=True) at 2 ranks (augmented batches of 4,
    a restart every 2 steps from the global pool) against one process:
    losses 1e-5 relative, live codes equal, every parameter 1e-4 relative
    L2 but the translation entries of the frame head's bias, which drmsd
    leaves at rounding-noise gradients that Adam turns into steps of up
    to ~lr either way (``test_torch_vqvae_train.py``): held to that
    bound."""
    got = runs["ranks"][0]["vqvae"]
    want = runs["vq_one"]
    assert runs["ranks"][1]["vqvae"]["losses"] == got["losses"]
    _close(got["losses"], want.losses, 1e-5)
    assert got["n_live_codes"] == want.n_live_codes
    head = "decoder.affine_output_projection.proj.bias"
    sched = tstate.warmup_cosine_decay_schedule(0.0, 3e-4, 1, 4, 3e-4 / 30)
    step_sum = sum(sched(i) for i in range(4))
    for params in (got["params"], want.params):
        assert params[head][6:].abs().max() <= 2 * step_sum
    for k, v in want.params.items():
        a, b = got["params"][k].double(), v.double()
        if k == head:
            a, b = a[:6], b[:6]
        assert (a - b).norm() <= 1e-4 * max(b.norm(), 1e-12), k


def test_indivisible_batch_and_missing_ranks_raise():
    """A global batch that does not divide by the data world raises (JAX
    drops devices instead); a tensor-parallel strategy without its ranks
    raises; one rank and no group run as one device."""
    with pytest.raises(ValueError, match="does not divide"):
        pmesh.data_shard(5, 0, 2)
    assert pmesh.data_shard(6, 1, 2) == pmesh.RowShard(3, 6, 6, None)
    model = torch.nn.Linear(2, 2)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        tstate.distribute(model, None, "dp2xtp2", 4, "cpu")
    for s in ("ddp", "zero2", "fsdp", "dp1xtp1", "tp1"):
        _, layout = tstate.distribute(model, None, s, 4, "cpu")
        assert layout.shard is None and layout.data_world == 1


@pytest.mark.parametrize("strategy", ["pp2", "dp2xpp2"])
def test_pipeline_strategies_raise(strategy):
    """The pipeline strategies are known (they run: tests/test_torch_pp.py)
    but raise without their ranks, for a task other than mdlm (as JAX's)
    and for a batch that does not divide by data x M; an unknown strategy
    raises."""
    tstate.check_strategy(strategy)
    n = 2 if strategy == "pp2" else 4
    with pytest.raises(ValueError, match=f"needs {n} ranks"):
        tstate.distribute(torch.nn.Linear(2, 2), None, strategy, 4, "cpu")
    with pytest.raises(ValueError, match="task_name=mdlm only"):
        ppp.check_training("clm", 0, 4, strategy)
    with pytest.raises(ValueError, match="pp_microbatches=3"):
        ppp.check_training("mdlm", 0, 4 * n, strategy, microbatches=3)
    with pytest.raises(ValueError, match="unknown strategy"):
        tstate.check_strategy("zero3")
