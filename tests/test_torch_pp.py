"""The port's pipeline parallelism (``parallel/pp.py``) on 4 gloo ranks
(CPU), against the JAX package's GPipe (``esmdiff_tpu/parallel/pp.py``)
on 4 virtual devices and against the port on one process:

  * the tiny trunk's forward under ``pp2`` (2 data rows) and ``pp4`` (its
    last stage holds no block) and a trunk with ``n_layers_geom=2``:
    logits against JAX's ``esm3_pp_forward`` (2e-4, JAX's own bound) and
    the one-process trunk (1e-5), and every gradient against the
    one-process trunk's (within 1e-5 of its largest |value|);
  * ``pp4`` and ``dp2xpp2`` for 3 steps of the tiny MDLM, JAX's init and
    draws carried over and ``grad_clip`` binding: losses and grad norms
    1e-5 against JAX's same strategy and 1e-6 against one process, every
    parameter ``assert_state_close``;
  * resume under ``pp4`` (bit for bit the uninterrupted run), a ``ddp``
    checkpoint resumed under ``pp4``;
  * ``esmdiff-torch-train`` under ``pp4`` and ``dp2xpp2``: checkpoints in
    the one-device layout (the one-process run's at 1e-5), loaded by
    ``load_runtime`` and sampled by ``--ckpt``;
  * ``parse_pp_strategy``, ``auto_microbatches`` and the stage partition
    against JAX's, and what raises.

One launch of ``tests/torch_ranks.py`` runs every 4-rank job."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from esmdiff_tpu.models import esm3 as jesm3
from esmdiff_tpu.parallel import pp as jpp
from esmdiff_tpu_torch.cli import sample as sample_cli
from esmdiff_tpu_torch.cli import train as train_cli
from esmdiff_tpu_torch.convert import checkpoints, flax_to_state_dict
from esmdiff_tpu_torch.models.esm3 import ESM3, esm3_tiny
from esmdiff_tpu_torch.parallel import pp as ppp
from esmdiff_tpu_torch.train import data as tdata
from esmdiff_tpu_torch.train import state as tstate
from esmdiff_tpu_torch.utils.checkpoint import load_params
from test_torch_support import (STEP_OPTIM, assert_state_close,
                                jax_strategy_run, jax_tiny_mdlm,
                                one_rank_steps, perturb, record_step_draws,
                                to_np)
from torch_ranks import run_ranks

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
STRATEGIES = ("pp4", "dp2xpp2")
TRUNKS = {"geom1": dict(n_layers=4, n_layers_geom=1),
          "geom2": dict(n_layers=6, n_layers_geom=2)}
FORWARDS = (("geom1", "pp2"), ("geom1", "pp4"), ("geom2", "pp4"))
TRAIN_ARGV = ["--config", str(ROOT / "configs/mdlm_smoke.yaml"), "--device",
              "cpu", "trainer.max_epochs=1", "trainer.print_config=false",
              "data.batch_size=4"]


def _batch():
    """4 rows of 30, 17, 26 and 9 residues."""
    rng = np.random.default_rng(5)
    return tdata.pad_collate(
        [{"sequence_tokens": rng.integers(4, 24, n).astype(np.int32),
          "structure_tokens": rng.integers(0, 4096, n).astype(np.int32)}
         for n in (30, 17, 26, 9)], 16)


def _corpus(root: Path):
    from esmdiff_tpu_torch.core import constants as C

    rng = np.random.RandomState(3)
    for i in range(10):
        L = rng.randint(20, 60)
        np.savez(root / f"chain{i}.npz",
                 sequence_tokens=np.concatenate(
                     [[C.SEQUENCE_BOS_TOKEN], rng.randint(4, 24, L),
                      [C.SEQUENCE_EOS_TOKEN]]).astype(np.int32),
                 structure_tokens=np.concatenate(
                     [[C.STRUCTURE_BOS_TOKEN], rng.randint(0, 4096, L),
                      [C.STRUCTURE_EOS_TOKEN]]).astype(np.int32))


def _trunk_kw(name):
    return dict(dtype="float32", head_type="structure", **TRUNKS[name])


def _forward_inputs(tmp: Path, name: str):
    """A perturbed JAX tiny trunk carried into the port, tokens, lengths
    and labels (``tests/test_pp.py``'s batch); JAX's pp forward at 2 and
    4 stages and the one-process port trunk's logits and gradients."""
    net = jesm3.ESM3(jesm3.esm3_tiny(**_trunk_kw(name)))
    rng = np.random.RandomState(1)
    B, L = 4, 12
    seq = rng.randint(4, 24, (B, L)).astype(np.int32)
    st = rng.randint(0, 4096, (B, L)).astype(np.int32)
    lengths = np.asarray([L, L - 2, L - 5, L], np.int32)
    labels = np.random.RandomState(2).randint(0, 4096, (B, L))
    params = perturb(net.init(  # coordinates: geometric attention's too
        jax.random.PRNGKey(0), sequence_tokens=jnp.asarray(seq),
        structure_coords=jnp.zeros((B, L, 3, 3)))["params"],
        seed=7, scale=0.05)
    jax_logits = {}
    for S in (2, 4):
        mesh = Mesh(np.asarray(jax.devices()[:S]), (jpp.STAGE_AXIS,))
        out = jpp.esm3_pp_forward(net, params, mesh, n_microbatches=2,
                                  structure_tokens=st, sequence_tokens=seq,
                                  lengths=lengths)
        jax_logits[S] = np.asarray(out.structure_logits)
    trunk = ESM3(esm3_tiny(**_trunk_kw(name)))
    trunk.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           flax_to_state_dict(params).items()})
    x = {"params": trunk.state_dict(),
         "structure_tokens": torch.from_numpy(st).long(),
         "sequence_tokens": torch.from_numpy(seq).long(),
         "lengths": torch.from_numpy(lengths),
         "labels": torch.from_numpy(labels).long()}
    torch.save(x, tmp / f"fwd_{name}.pt")
    out = trunk(structure_tokens=x["structure_tokens"],
                sequence_tokens=x["sequence_tokens"], lengths=x["lengths"])
    torch.nn.functional.cross_entropy(
        out.structure_logits.flatten(0, 1), x["labels"].flatten()).backward()
    return {"jax": jax_logits, "logits": out.structure_logits.detach(),
            "grads": {n: torch.zeros_like(p) if p.grad is None else
                      p.grad.clone() for n, p in trunk.named_parameters()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's runs, the one-process runs and every 4-rank job."""
    tmp = tmp_path_factory.mktemp("pp")
    jm, params = jax_tiny_mdlm()
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in flax_to_state_dict(params).items()},
               tmp / "params.pt")
    batch = _batch()
    np.savez(tmp / "batch.npz", **batch)
    records = record_step_draws(batch)
    torch.save(records, tmp / "records.pt")
    out = {"tmp": tmp, "one": one_rank_steps(tmp / "params.pt", batch,
                                             records),
           "jax": {s: jax_strategy_run(jm, params, batch, s)
                   for s in STRATEGIES},
           "fwd": {n: _forward_inputs(tmp, n) for n in TRUNKS}}

    def steps(name, strategy, **kw):
        return dict(name=name, kind="steps", strategy=strategy,
                    params=str(tmp / "params.pt"),
                    batch=str(tmp / "batch.npz"),
                    records=str(tmp / "records.pt"), steps=3,
                    optim=STEP_OPTIM, max_segments=0, **kw)

    jobs = [dict(name=f"fwd_{t}_{s}", kind="pp_forward", strategy=s,
                 inputs=str(tmp / f"fwd_{t}.pt"), trunk=_trunk_kw(t),
                 microbatches=2) for t, s in FORWARDS]
    jobs += [steps(s, s) for s in STRATEGIES]
    for first, s in (("pp4", "pp4"), ("ddp", "ddp")):
        jobs.append(steps(f"{first}_first2", s,
                          ckpt=str(tmp / f"ck_{first}")))
        jobs[-1]["steps"] = 2
        jobs.append(steps(f"pp4_from_{first}", "pp4",
                          resume=str(tmp / f"ck_{first}"),
                          resume_step=str(tmp / f"ck_{first}" / "step_2")))
    (tmp / "corpus").mkdir()
    _corpus(tmp / "corpus")
    for s in STRATEGIES:
        jobs.append(dict(name=f"cli_{s}", kind="train_cli", argv=[
            *TRAIN_ARGV, f"data.path={tmp / 'corpus'}",
            f"trainer.ckpt_dir={tmp / ('run_' + s)}",
            f"trainer.strategy={s}"]))
    out["ranks"] = run_ranks(tmp, 4, jobs, timeout=300)
    out["cli_one"] = train_cli.main([
        *TRAIN_ARGV, f"data.path={tmp / 'corpus'}",
        f"trainer.ckpt_dir={tmp / 'run_one'}"])
    return out


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol)


@pytest.mark.parametrize("trunk,strategy", FORWARDS)
def test_trunk_forward_and_gradients(runs, trunk, strategy):
    """The stages hold JAX's partition (pp4 of the 4-layer trunk: one
    block each on stages 0-2, none on stage 3, which runs the norm and the
    heads); the last stage's logits are JAX's pipelined forward's and the
    one-process trunk's; the joined gradients are the one-process
    trunk's, every parameter's."""
    S = ppp.parse_pp_strategy(strategy)[1]
    ranks = [r[f"fwd_{trunk}_{strategy}"] for r in runs["ranks"]]
    n = TRUNKS[trunk]
    want_blocks = [[*range(n["n_layers_geom"])] * (s == 0) + [
        n["n_layers_geom"] + i for i in jpp_rows(
            n["n_layers"] - n["n_layers_geom"], S, s)] for s in range(S)]
    assert [r["blocks"] for r in ranks[:S]] == want_blocks
    if trunk == "geom1" and S == 4:
        assert ranks[3]["blocks"] == []
    ref = runs["fwd"][trunk]
    got = ranks[S - 1]["logits"]
    assert all(r["logits"] is None for r in ranks[:S - 1])
    np.testing.assert_allclose(to_np(got), ref["jax"][S], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(to_np(got), to_np(ref["logits"]), rtol=1e-5,
                               atol=1e-5)
    grads = ranks[0]["grads"]
    assert set(grads) == {f"net.{k}" for k in ref["grads"]}
    for k, g in ref["grads"].items():
        bound = 1e-5 * max(g.abs().max().item(), 1e-12)
        assert (grads[f"net.{k}"] - g).abs().max().item() <= bound, k


def jpp_rows(n_rows: int, n_stage: int, stage: int) -> range:
    """JAX's rows of stage ``stage``: ``pad_stack`` to a multiple of the
    stage count, ``n_rows / S`` a stage, less the pad rows."""
    n_loc = -(-n_rows // n_stage)
    padded, n_valid = jpp.pad_stack(np.zeros((n_rows, 1), np.float32),
                                    n_stage)
    assert padded.shape[0] == n_loc * n_stage and n_valid == n_rows
    return range(stage * n_loc, min((stage + 1) * n_loc, n_valid))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategy_matches_jax_and_one_process(runs, strategy):
    """Every rank reports the global batch's loss and grad norm; the data
    rows hold 2 + 2 rows (dp2xpp2) or all 4 (pp4); rank 0's joined
    parameters equal JAX's and the one-process run's, with the clip
    binding (a clip that saw one stage's norm would show)."""
    ranks = [r[strategy] for r in runs["ranks"]]
    n_data = ppp.parse_pp_strategy(strategy)[0]
    assert [r["rows"] for r in ranks] == (
        [(0, 2), (0, 2), (2, 4), (2, 4)] if n_data == 2 else [(0, 4)] * 4)
    assert all(r["loss"] == ranks[0]["loss"] and
               r["grad_norm"] == ranks[0]["grad_norm"] for r in ranks)
    r0 = ranks[0]
    j_loss, j_norm, j_params = runs["jax"][strategy]
    o_loss, o_norm, o_params = runs["one"]
    _close(r0["loss"], j_loss, 1e-5)
    _close(r0["grad_norm"], j_norm, 1e-5)
    assert min(j_norm) > STEP_OPTIM["grad_clip"]  # clipped at every step
    assert_state_close(r0["params"], j_params)
    _close(r0["loss"], o_loss, 1e-6)
    _close(r0["grad_norm"], o_norm, 1e-6)
    assert_state_close(r0["params"], {k: v.numpy()
                                      for k, v in o_params.items()})


@pytest.mark.parametrize("first", ["pp4", "ddp"])
def test_resume_under_pp(runs, first):
    """2 steps under ``first``, a checkpoint of the one-device layout
    (the stages joined on rank 0, each stage's moments numbered as the
    one-device optimizer's), 1 step under pp4 from it: from pp4, bit for
    bit the uninterrupted pp4 run; from ddp, the one-process run's
    parameters (1e-5)."""
    r0 = runs["ranks"][0]
    resumed = r0[f"pp4_from_{first}"]
    step = runs["tmp"] / f"ck_{first}" / "step_2"
    opt = torch.load(step / "optimizer.pt", weights_only=False)
    names = list(load_params(step))
    assert sorted(opt["state"]) == list(range(len(names)))
    if first == "pp4":
        whole = r0["pp4"]
        assert r0["pp4_first2"]["loss"] + resumed["loss"] == whole["loss"]
        for k, v in whole["params"].items():
            assert torch.equal(resumed["params"][k], v), k
    else:
        assert_state_close(resumed["params"], {
            k: v.numpy() for k, v in runs["one"][2].items()})


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_train_cli_checkpoints_load_into_sampling(runs, strategy, tmp_path):
    """esmdiff-torch-train at 4 ranks: the steps and val loss of one
    process, a checkpoint in the one-device layout equal to the
    one-process run's (1e-5), which load_runtime and --ckpt take
    unchanged."""
    tmp = runs["tmp"]
    got = runs["ranks"][0][f"cli_{strategy}"]
    want = runs["cli_one"]
    assert all(r[f"cli_{strategy}"]["steps"] == want["steps"]
               for r in runs["ranks"])
    _close(got["best_val_loss"], want["best_val_loss"], 1e-5)
    run = tmp / f"run_{strategy}"
    index = json.loads((run / "ckpt" / "index.json").read_text())
    saved = load_params(index[0]["path"])
    one = load_params(json.loads(
        (tmp / "run_one" / "ckpt" / "index.json").read_text())[0]["path"])
    assert list(saved) == list(one)
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


@pytest.mark.parametrize("strategy", ["pp1", "pp3", "dp2xpp4", "dp12xpp5",
                                      "tp2", "ddp", "ppx", "dp2pp2"])
def test_parse_and_microbatches_match_jax(strategy):
    """``parse_pp_strategy`` on strategies of every form, and
    ``auto_microbatches`` and the stage partition over a range of batches,
    stage counts and depths, against JAX's."""
    assert ppp.parse_pp_strategy(strategy) == jpp.parse_pp_strategy(strategy)
    shape = ppp.parse_pp_strategy(strategy)
    S = shape[1] if shape else 2
    for b in range(1, 25):
        assert ppp.auto_microbatches(b, S) == jpp.auto_microbatches(b, S)
    for n in range(S, 48):
        rows = [ppp.stage_rows(n, S, s) for s in range(S)]
        assert rows == [jpp_rows(n, S, s) for s in range(S)]


@pytest.mark.parametrize("case", ["task", "pack_len", "batch", "micro"])
def test_pp_checks_raise_as_jax(case):
    """A task other than mdlm, packed rows, a batch that does not divide
    by the data axis or by data x M: JAX's ValueErrors."""
    kw = dict(task_name="mdlm", pack_len=0, batch_size=8,
              strategy="dp2xpp2", microbatches=0)
    kw.update({"task": dict(task_name="clm"), "pack_len": dict(pack_len=64),
               "batch": dict(batch_size=7),
               "micro": dict(microbatches=3)}[case])
    match = {"task": "mdlm only", "pack_len": "pack_len",
             "batch": "not divisible by dp=2",
             "micro": "not divisible by pp_microbatches=3"}[case]
    with pytest.raises(ValueError, match=match):
        ppp.check_training(**kw)
    assert ppp.check_training("mdlm", 0, 8, "dp2xpp2") == 2
    with pytest.raises(ValueError, match="nothing to hold"):
        ppp.Pipeline(esm3_tiny(n_layers=3), 4, 2, 1)   # an empty middle
    with pytest.raises(ValueError, match="needs 4 ranks"):
        tstate.distribute(torch.nn.Linear(2, 2), None, "dp2xpp2", 4, "cpu")
