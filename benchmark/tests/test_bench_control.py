"""The controls read not correct on the card, at the cells' own sizes:
the sampling cells' program on its own int8 path (trunk and decoder), the
training cell's reference computed in float8 in the program's place.
Needs an H100: ``python3 -m pytest -m cuda benchmark/tests``."""

import time

import pytest
import torch

from benchmark import calibrate, harness, run


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def cell_job(cell, seed, device):
    job = run.job_for(run.parse(["--workload", cell, "--seed", str(seed),
                                 "--seconds", "0"]))
    job["device"], job["t_start"], job["per_layer"] = device, \
        time.monotonic(), []
    return job


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["esmdiff.ddpm.L128", "esm3.gibbs.L128",
                                  "esmdiff.ddpm.L64"])
def test_int8_control_is_not_correct(cell, card):
    job = cell_job(cell, 2 ** 31 + 17, card)
    job["quant"] = "int8"
    result = harness.runner("sample").run(job)
    line = harness.result_line(job, result, harness.card())
    assert not line["correct"], line["checks"]


@pytest.mark.cuda
def test_float8_training_control_is_not_correct(card):
    job = cell_job("esmdiff.train.pack512", 2 ** 31 + 17, card)
    numbers = calibrate.train_control(job, job["seed"])
    correct, checks = harness.judge(numbers, job["limits"])
    assert not correct, checks
