"""The port's multi-process dryrun (``parallel/multihost.py``): the JAX
package's ``run_workload`` (2 ``zero2`` steps of the tiny MDLM on a seeded
global batch of 16, a checkpoint written and restored across the process
boundary, 1 more step) as 2 gloo processes and as 1 process, JAX's init
and JAX's draws (keys 1, 2, 3) carried over: 2 processes equal 1 process
(1e-6 relative), and both equal the losses of JAX's ``run_workload`` on
8 virtual devices (1e-5 relative)."""

import json

import jax
import numpy as np
import torch

from esmdiff_tpu.parallel import multihost as jmultihost
from esmdiff_tpu_torch.convert import flax_to_state_dict
from esmdiff_tpu_torch.parallel import multihost
from test_torch_support import jax_tiny_mdlm, record_step_draws
from torch_ranks import run_ranks

torch.set_num_threads(2)


def test_two_processes_equal_one_and_jax(tmp_path):
    jax_out = tmp_path / "jax.json"
    jmultihost.run_workload(str(jax_out), str(tmp_path / "jax_ckpt"))
    want = json.loads(jax_out.read_text())
    assert want["n_devices"] == len(jax.devices()) == 8

    _, params = jax_tiny_mdlm()
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in flax_to_state_dict(params).items()},
               tmp_path / "params.pt")
    torch.save(record_step_draws(multihost.workload_batch(), keys=(1, 2, 3)),
               tmp_path / "draws.pt")
    carried = dict(params=str(tmp_path / "params.pt"),
                   draws=str(tmp_path / "draws.pt"))
    got = {}
    for n in (1, 2):
        out, ckpt_dir = tmp_path / f"port{n}.json", tmp_path / f"ck{n}"
        if n == 1:  # this process, no group
            multihost.run_workload(str(out), str(ckpt_dir), "cpu", **carried)
        else:
            run_ranks(tmp_path, n, [dict(
                name="workload", kind="multihost", out=str(out),
                ckpt_dir=str(ckpt_dir), **carried)], timeout=240)
        got[n] = json.loads(out.read_text())
        assert got[n]["n_processes"] == n
        # the checkpoint: the one-device layout, the step after 2 updates
        assert (ckpt_dir / "step_2" / "optimizer.pt").exists()
    np.testing.assert_allclose(got[2]["losses"], got[1]["losses"], rtol=1e-6)
    np.testing.assert_allclose(got[1]["losses"], want["losses"], rtol=1e-5)


def test_main_as_one_process(tmp_path):
    """The worker's command line without torchrun's environment: one
    process, no group, the seeded workload's three losses written."""
    out = tmp_path / "one.json"
    losses = multihost.main(["--out", str(out), "--ckpt_dir",
                             str(tmp_path / "ck"), "--device", "cpu"])
    got = json.loads(out.read_text())
    assert got == {"losses": losses, "n_processes": 1}
    assert len(losses) == 3 and np.isfinite(losses).all()
