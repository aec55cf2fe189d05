"""A run with the timed path broken underneath reads ``correct`` false.

Each case drives the rest of a run at the tiny widths on the CPU (the
look for a card skipped), with the cell's own limits, in float32 so that
the sound run reads near nought: once sound, and once for each fault the
cell can have: a token altered where the sampler produces it; one
sample's decoded coordinates altered where the decoder produces them; a
training step that returns its state unchanged; half of every batch left
out, the mean taken over the rest.  (One card: no exchange between cards
to leave out.)
"""

import time

import pytest
import torch

from benchmark import calibrate, harness, run

TINY_T = {"d_model": 64, "n_heads": 4, "n_layers": 2, "n_layers_geom": 1,
          "v_heads": 8, "ffn_hidden": 256, "n_structure_heads": 4101,
          "sigma_frequency_size": 256, "dtype": "float32"}
TINY_D = {"d_model": 64, "n_heads": 4, "n_layers": 2, "ffn_hidden": 256,
          "plddt_bins": 50, "trans_scale": 10.0, "dtype": "float32"}
SMALL = {"sample": {"samples": 16, "steps": 6,
                    "capture": {"requests": 1, "forwards": 3, "deep": 1,
                                "rows": 16, "row_rmsd_A": 1.2}},
         "train": {"chains": 120, "batch_size": 4, "pack_len": 128,
                   "max_len": 128}}


def tiny_run(cell: str) -> dict:
    job = run.job_for(run.parse(["--workload", cell, "--seed", "2147483659",
                                 "--seconds", "0"]))
    job["config"] = dict(job["config"], decoder=TINY_D, trunk=dict(
        TINY_T, head=job["config"]["trunk"]["head"]))
    job["traffic"] = dict(job["traffic"], **SMALL[job["traffic"]["runner"]])
    job["device"], job["t_start"] = "cpu", time.monotonic()
    result = harness.runner(job["traffic"]["runner"]).run(job)
    return harness.result_line(job, result, {"platform": "cpu"})


def altered(fn):
    """``fn`` with one token of its output changed."""
    def wrong(*args, **kwargs):
        out = fn(*args, **kwargs)
        x = out[0] if isinstance(out, tuple) else out
        x[:, 1] = (x[:, 1] + 1) % 4096
        return out
    return wrong


SAMPLING = ["esmdiff.ddpm.L128", "esm3.gibbs.L128", "esmdiff.ddpm.L64"]


@pytest.mark.parametrize("cell", SAMPLING + ["esmdiff.train.pack512"])
def test_sound_run_is_correct(cell):
    line = tiny_run(cell)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("cell", SAMPLING)
def test_altered_token_is_not_correct(cell, monkeypatch):
    from esmdiff_tpu_torch.api import generation
    from esmdiff_tpu_torch.diffusion.mdlm import MDLM

    monkeypatch.setattr(MDLM, "ddpm_sample", altered(MDLM.ddpm_sample))
    monkeypatch.setattr(generation, "iterative_unmask_sample",
                        altered(generation.iterative_unmask_sample))
    line = tiny_run(cell)
    assert not line["correct"]
    assert line["checks"]["update_mismatch"]["value"] > 0


@pytest.mark.parametrize("cell", SAMPLING)
def test_one_altered_sample_is_not_correct(cell, monkeypatch):
    """One slot of sixteen decoded 3 A off: the mean RMSD dilutes it under
    its limit, the count of samples off by more than 1.2 A does not."""
    from esmdiff_tpu_torch.api.generation import EnsembleSampler

    decode = EnsembleSampler.decode_ensemble

    def wrong(self, *args, **kwargs):
        prots = decode(self, *args, **kwargs)
        prots[0].coordinates = prots[0].coordinates + 3.0 / 3 ** 0.5
        return prots

    monkeypatch.setattr(EnsembleSampler, "decode_ensemble", wrong)
    line = tiny_run(cell)
    assert not line["correct"]
    checks = line["checks"]
    assert checks["coord_rmsd_A"]["value"] <= checks["coord_rmsd_A"]["limit"]
    assert checks["coord_rows_over"]["value"] == 1


def test_unchanged_state_is_not_correct(monkeypatch):
    from esmdiff_tpu_torch.train import state as tstate

    def no_update(state, loss_fn, batch, draws):
        with torch.no_grad():
            loss, _ = loss_fn(batch, draws)
        state.step += 1
        return {"loss": loss}

    monkeypatch.setattr(tstate, "train_step", no_update)
    line = tiny_run("esmdiff.train.pack512")
    assert not line["correct"]
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_batch_is_not_correct():
    undo = calibrate.half_batches()
    try:
        line = tiny_run("esmdiff.train.pack512")
    finally:
        undo()
    assert not line["correct"]
