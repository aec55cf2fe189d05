"""The port's tensor parallelism (``parallel/tp.py``) on 4 gloo ranks
(CPU): ``dp2xtp2`` (2 data x 2 model ranks) for 3 steps of the tiny MDLM
against the JAX package's ``dp2xtp2`` on a 2 x 2 virtual mesh and against
one process (JAX's init and draws carried over; losses and grad norms
1e-5 relative and parameters 1e-5 against JAX, 1e-6 relative and 1e-5
against one process); ``tp4``; ``dp1xtp1`` on one rank (the split
modules over a model group of one, against one process); resume from a checkpoint of the joined
shards (bit for bit the uninterrupted run); the trunk split 4 ways with
coordinates
(geometric attention's heads split too) against the unsplit trunk
(logits and every gradient within 1e-5 of their largest |value|); the
split rules against JAX's."""

from pathlib import Path

import numpy as np
import pytest
import torch

from esmdiff_tpu.parallel import tp as jtp
from esmdiff_tpu_torch.convert import flax_to_state_dict
from esmdiff_tpu_torch.models.esm3 import ESM3, esm3_tiny
from esmdiff_tpu_torch.nn.layers import init_params
from esmdiff_tpu_torch.parallel import tp as ptp
from esmdiff_tpu_torch.train import data as tdata
from test_torch_geometric import _backbone
from test_torch_support import (STEP_OPTIM, assert_state_close,
                                jax_strategy_run, jax_tiny_mdlm,
                                one_rank_steps, record_step_draws)
from torch_ranks import run_ranks

torch.set_num_threads(2)


def _batch():
    rng = np.random.default_rng(2)
    return tdata.pad_collate(
        [{"sequence_tokens": rng.integers(4, 24, n).astype(np.int32),
          "structure_tokens": rng.integers(0, 4096, n).astype(np.int32)}
         for n in (20, 32, 9, 27)], 16)


def _trunk_inputs(path: Path):
    """A perturbed tiny trunk, tokens, coordinates (row 0 with a NaN and an
    inf residue, row 1 padded past 21) and a probe of the logits."""
    torch.manual_seed(0)
    trunk = ESM3(esm3_tiny(dtype="float32", head_type="structure",
                           remat=False))
    init_params(trunk, torch.Generator().manual_seed(1))
    with torch.no_grad():
        for p in trunk.parameters():
            p.add_(0.1 * torch.randn_like(p))
    rng = np.random.default_rng(3)
    B, L = 2, 24
    coords = _backbone(B, L, seed=4)
    coords[1, 21:] = np.nan
    x = {"params": trunk.state_dict(),
         "structure_tokens": torch.from_numpy(rng.integers(0, 4096, (B, L))),
         "sequence_tokens": torch.from_numpy(rng.integers(4, 24, (B, L))),
         "coords": torch.from_numpy(coords),
         "lengths": torch.tensor([L, 21], dtype=torch.int32),
         "probe": torch.randn(B, L, 4101)}
    torch.save(x, path)
    out = trunk(structure_tokens=x["structure_tokens"],
                sequence_tokens=x["sequence_tokens"],
                structure_coords=x["coords"], lengths=x["lengths"])
    (out.structure_logits * x["probe"]).sum().backward()
    return out.structure_logits.detach(), {
        n: p.grad.clone() for n, p in trunk.named_parameters()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    jm, params = jax_tiny_mdlm()
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in flax_to_state_dict(params).items()},
               tmp / "params.pt")
    batch = _batch()
    np.savez(tmp / "batch.npz", **batch)
    records = record_step_draws(batch)
    torch.save(records, tmp / "records.pt")
    out = {"one": one_rank_steps(tmp / "params.pt", batch, records),
           "jax": jax_strategy_run(jm, params, batch, "dp2xtp2"),
           "trunk": _trunk_inputs(tmp / "trunk.pt")}
    jobs = [dict(name=s, kind="steps", strategy=s,
                 params=str(tmp / "params.pt"), batch=str(tmp / "batch.npz"),
                 records=str(tmp / "records.pt"), steps=3, optim=STEP_OPTIM)
            for s in ("dp2xtp2", "tp4")]
    jobs.append({**jobs[0], "name": "first2", "steps": 2,
                 "ckpt": str(tmp / "ck")})
    jobs.append({**jobs[0], "name": "resumed", "resume": str(tmp / "ck"),
                 "resume_step": str(tmp / "ck" / "step_2")})
    jobs.append(dict(name="forward", kind="tp_forward",
                     inputs=str(tmp / "trunk.pt")))
    out["ranks"] = run_ranks(tmp, 4, jobs, timeout=300)
    out["tp1"] = run_ranks(tmp, 1, [{**jobs[0], "name": "dp1xtp1",
                                     "strategy": "dp1xtp1"}],
                           timeout=300, tag="one_rank")[0]["dp1xtp1"]
    return out


def test_dp2xtp2_matches_jax_and_one_process(runs):
    """Ranks 0, 1 hold rows 0-1 and ranks 2, 3 rows 2-3; every rank
    reports the global loss; rank 0's joined parameters equal JAX's."""
    r = [x["dp2xtp2"] for x in runs["ranks"]]
    assert [x["rows"] for x in r] == [(0, 2), (0, 2), (2, 4), (2, 4)]
    assert all(x["loss"] == r[0]["loss"] for x in r)
    j_loss, j_norm, j_params = runs["jax"]
    o_loss, o_norm, o_params = runs["one"]
    np.testing.assert_allclose(r[0]["loss"], j_loss, rtol=1e-5)
    np.testing.assert_allclose(r[0]["grad_norm"], j_norm, rtol=1e-5)
    assert_state_close(r[0]["params"], j_params)
    np.testing.assert_allclose(r[0]["loss"], o_loss, rtol=1e-6)
    np.testing.assert_allclose(r[0]["grad_norm"], o_norm, rtol=1e-6)
    assert_state_close(r[0]["params"], {k: v.numpy()
                                        for k, v in o_params.items()})


def test_tp4_matches_one_process(runs):
    r0 = runs["ranks"][0]["tp4"]
    assert r0["rows"] == (0, 4)
    o_loss, o_norm, o_params = runs["one"]
    np.testing.assert_allclose(r0["loss"], o_loss, rtol=1e-6)
    np.testing.assert_allclose(r0["grad_norm"], o_norm, rtol=1e-6)
    assert_state_close(r0["params"], {k: v.numpy()
                                      for k, v in o_params.items()})


def test_dp1xtp1_runs_the_split_modules(runs):
    """dp1xtp1 on a group of one rank builds the (data, model) mesh and
    runs every attention, SwiGLU and geometric attention module through
    its model group of one; it equals the run with no group."""
    r = runs["tp1"]
    assert r["rows"] == (0, 4) and r["tp_modules"] == 4 + 4 + 1
    assert runs["ranks"][0]["dp2xtp2"]["tp_modules"] == 4 + 4 + 1
    o_loss, o_norm, o_params = runs["one"]
    np.testing.assert_allclose(r["loss"], o_loss, rtol=1e-6)
    np.testing.assert_allclose(r["grad_norm"], o_norm, rtol=1e-6)
    assert_state_close(r["params"], {k: v.numpy()
                                     for k, v in o_params.items()})


def test_resume_equals_uninterrupted(runs):
    """dp2xtp2: 2 steps, a checkpoint of the joined shards (the one-device
    layout, moments too), a fresh split state restored from it, 1 more
    step: bit for bit the uninterrupted run."""
    r0 = runs["ranks"][0]
    assert r0["first2"]["loss"] + r0["resumed"]["loss"] == \
        r0["dp2xtp2"]["loss"]
    for k, v in r0["dp2xtp2"]["params"].items():
        assert torch.equal(r0["resumed"]["params"][k], v), k


def test_split_trunk_with_coordinates(runs):
    """Every attention, SwiGLU and geometric attention module of the tiny
    trunk split 4 ways (4 heads, hidden 256, 8 geometric heads): the
    logits and every parameter's gradient equal the unsplit trunk's."""
    logits, grads = runs["trunk"]
    got = runs["ranks"][0]["forward"]
    assert got["n_split"] == 4 + 4 + 1
    np.testing.assert_allclose(got["logits"].numpy(), logits.numpy(),
                               rtol=0, atol=1e-5 * logits.abs().max().item())
    assert got["grads"].keys() == grads.keys()
    for k, g in grads.items():
        scale = max(g.abs().max().item(), 1e-6)
        np.testing.assert_allclose(got["grads"][k].numpy(), g.numpy(),
                                   rtol=0, atol=1e-5 * scale, err_msg=k)


def test_rules_and_strategy_parse_match_jax():
    """The six rules are JAX's (column parallel: the output features, dim
    0 of torch's (out, in); row parallel: the input features); the
    strategy strings parse alike; split and join invert each other."""
    want = {(path[-3], path[-2]): axis for path, axis in jtp._TP_RULES}
    got = {prefix: {0: -1, 1: -2}[dim]
           for prefix, _, dim, _ in ptp.TP_RULES}
    assert got == want
    for s in ("dp2xtp4", "tp2", "dp4xtp1", "zero2", "dp2xpp2"):
        assert ptp.parse_tp_strategy(s) == jtp.parse_tp_strategy(s)
    w = torch.arange(24 * 5).reshape(24, 5)
    for dim, blocks in ((0, 3), (0, 2), (1, 1)):
        t = w if dim == 0 else w.t()
        parts = [ptp.shard_tensor(t, dim, blocks, r, 4) for r in range(4)]
        assert torch.equal(ptp.unshard_tensor(parts, dim, blocks), t)
    q, k, v = w.chunk(3)
    assert torch.equal(ptp.shard_tensor(w, 0, 3, 1, 2),
                       torch.cat([q[4:], k[4:], v[4:]]))
