"""CLM and JLM training across data ranks: ``ddp``, ``zero2`` and ``fsdp``
(the AR nets' blocks its units) at 2 gloo ranks (CPU), three AdamW steps
with the clip binding, against one process (losses and metrics 1e-6
relative at every step, the grad norm 1e-6 at the first) and against the
JAX package's same strategy on 2 virtual devices (1e-5).  The parameters
are held as ``test_torch_train_ar.py`` holds them (1e-5, but the
elements at rounding-level gradients, which Adam moves by up to an lr a
step either way, within 2 x lr a step), and so is the grad norm after
the first step (1e-5): those moves shift it by ~2e-6, as much as one
process and JAX on one device differ there.  ``dp1xtp2``: JAX's tensor-parallel
rules split no leaf of a CLM or JLM tree, and the port's split no module
of them, so the model axis replicates the work and the run is the one
process's (as closely as the strategies above).  The ranks are
processes of ``tests/torch_ranks.py``; one launch runs every job."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from esmdiff_tpu.parallel import mesh as jmesh
from esmdiff_tpu.parallel import tp as jtp
from esmdiff_tpu.train import config as jconfig
from esmdiff_tpu.train import data as jdata
from esmdiff_tpu.train import loop as jloop
from esmdiff_tpu.train import state as jstate
from esmdiff_tpu_torch.convert import flax_to_state_dict
from esmdiff_tpu_torch.train import config as tconfig
from esmdiff_tpu_torch.train import loop as tloop
from test_torch_support import carry, perturb, to_np
from test_torch_train_ar import COND, _overrides, corpus  # noqa: F401
from torch_ranks import ar_steps_job, run_ranks

torch.set_num_threads(2)

TASKS = ("clm", "jlm")
STRATEGIES = ("ddp", "zero2", "fsdp")
OPTIM = dict(lr=1e-3, weight_decay=0.01, grad_clip=1.0)
EXTRA = ["data.batch_size=4", "optim.grad_clip=1.0"]


def _jax_run(task, jloss, params, batches, strategy):
    """JAX's sharded step under ``strategy``, one step a batch: (metrics
    of each step, final params and, per leaf, the elements whose
    one-device gradient was at rounding level at some step; both as the
    port's state dict)."""
    opt = jstate.make_optimizer(**OPTIM)
    shape = jtp.parse_tp_strategy(strategy)
    mesh = jtp.make_2d_mesh(*shape) if shape else jmesh.make_mesh(2)
    grad = jax.jit(jax.grad(lambda p, b: jloss(p, b, None)[0]))
    noise = jax.tree.map(lambda x: np.zeros(x.shape, bool), params)
    metrics = []
    with mesh:
        state = jstate.create_sharded_train_state(params, opt, mesh,
                                                  strategy=strategy)
        step = jstate.make_train_step(lambda p, b, k: jloss(p, b, k), opt,
                                      mesh=mesh, donate=False)
        for i, b in enumerate(batches):
            noise = jax.tree.map(
                lambda n, g: n | (np.abs(g) <= 1e-5 * np.abs(g).max()),
                noise, jax.device_get(grad(jax.device_get(state.params),
                                           b)))
            sb = (jtp.shard_batch_2d(b, mesh) if shape
                  else jmesh.shard_batch(b, mesh))
            state, m = step(state, sb, jax.random.PRNGKey(i))
            metrics.append({k: float(v) for k, v in m.items()})
    return (metrics, flax_to_state_dict(jax.device_get(state.params)),
            flax_to_state_dict(noise))


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):  # noqa: F811
    tmp = tmp_path_factory.mktemp("ar_ranks")
    out = {"jax": {}, "one": {}}
    jobs = []
    for task in TASKS:
        ov = _overrides(task, corpus, extra=EXTRA)
        jcfg = jconfig.load_config(None, ov)
        split, _ = jdata.train_val_split(jdata.EncodingDataset(jcfg.data),
                                         jcfg.data)
        batches = [b for epoch in range(2) for b in jdata.batches(
            split, jcfg.data, shuffle=True, seed=jcfg.seed + epoch)][:3]
        paths = []
        for i, b in enumerate(batches):
            paths.append(str(tmp / f"{task}_batch{i}.npz"))
            np.savez(paths[-1], **b)
        jloss, init_fn = jloop.build_task(jcfg, emb_dim=COND)
        params = perturb(init_fn(), 3, 0.05)
        model, _ = tloop.build_task(tconfig.load_config(None, ov), "cpu",
                                    emb_dim=COND)
        carry(model, params)
        torch.save(model.state_dict(), tmp / f"{task}_params.pt")
        out["jax"][task] = {s: _jax_run(task, jloss, params, batches, s)
                            for s in STRATEGIES}
        out["tp_specs"] = out.get("tp_specs", set()) | {
            s.spec for s in jax.tree.leaves(jtp.tp_shardings_for_tree(
                params, jtp.make_2d_mesh(1, 2)))}

        def job(strategy, task=task, ov=ov, paths=paths):
            return dict(name=f"{task}_{strategy}", kind="ar_steps",
                        strategy=strategy, overrides=ov, emb_dim=COND,
                        params=str(tmp / f"{task}_params.pt"),
                        batches=paths, optim=OPTIM)

        out["one"][task] = ar_steps_job(job("ddp"))   # no group: one process
        jobs += [job(s) for s in (*STRATEGIES, "dp1xtp2")]
    out["ranks"] = run_ranks(tmp, 2, jobs, timeout=300)
    return out


def _metrics_close(got, want, rtol):
    """Every metric of every step within ``rtol``, but the grad norm
    after the first step within 1e-5 (see the module docstring)."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys()
        for k in w:
            tol = 1e-5 if k == "grad_norm" and i else rtol
            np.testing.assert_allclose(g[k], w[k], rtol=tol,
                                       err_msg=f"step {i} {k}")


def _params_close(got, want, noise, lr=OPTIM["lr"]):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g, w, n = to_np(got[k]), to_np(w), noise[k]
        np.testing.assert_allclose(g[~n], w[~n], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
        assert (np.abs(g[n] - w[n]) <= 2 * lr * 3).all(), k


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_ar_strategy_matches_jax_and_one_process(runs, task, strategy):
    """Both ranks report the global batch's metrics; rank 0's gathered
    parameters equal the one-process run's and JAX's."""
    r0, r1 = (r[f"{task}_{strategy}"] for r in runs["ranks"])
    assert r0["metrics"] == r1["metrics"]
    one = runs["one"][task]
    j_metrics, j_params, noise = runs["jax"][task][strategy]
    _metrics_close(r0["metrics"], one["metrics"], 1e-6)
    _params_close(r0["params"], one["params"], noise)
    _metrics_close(r0["metrics"], j_metrics, 1e-5)
    assert all(m["grad_norm"] > OPTIM["grad_clip"] for m in j_metrics)
    _params_close(r0["params"], j_params, noise)


@pytest.mark.parametrize("task", TASKS)
def test_ar_tensor_parallel_splits_nothing(runs, task):
    """JAX's tensor-parallel rules leave every leaf of the CLM and JLM
    trees replicated, and the port's split none of their modules: under
    dp1xtp2 both ranks compute the one process's steps (to rounding)."""
    assert runs["tp_specs"] == {P()}
    r0, r1 = (r[f"{task}_dp1xtp2"] for r in runs["ranks"])
    assert r0["tp_modules"] == 0 and r0["metrics"] == r1["metrics"]
    one = runs["one"][task]
    _metrics_close(r0["metrics"], one["metrics"], 1e-6)
    _params_close(r0["params"], one["params"], runs["jax"][task]["ddp"][2])
