"""The port's evaluation geometry on the card against the same functions on
the CPU, float64: histogram counts and validity equal, distances and
fits within 1e-9 A, JS values within 1e-4 (their 4-decimal rounding),
``idp_metrics`` within 1e-9 relative, TICA's projections up to a sign per
column.

Needs a CUDA card; skips without one.  Imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_eval_cuda.py -q
"""

import numpy as np
import pytest
import torch

from esmdiff_tpu_torch.eval import align, geo, metrics

pytestmark = pytest.mark.cuda


@pytest.fixture
def ens():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; runs via chip_smoke.py")
    rng = np.random.RandomState(0)
    base = np.cumsum(rng.randn(40, 3) * 2.2, axis=0)
    slow = np.cumsum(rng.randn(3000)) * 0.03
    traj = base[None] + rng.randn(3000, 40, 3) * 0.3
    traj[:, :10, 0] += slow[:, None]
    return {"target": traj,
            "a": base[None] + rng.randn(100, 40, 3) * 0.4,
            "b": base[None] * 1.05 + rng.randn(100, 40, 3) * 1.2}


def _js_close(card, cpu):
    assert list(card) == list(cpu)
    for k in cpu:
        assert abs(float(card[k]) - float(cpu[k])) <= 1e-4 + 1e-12, (k, card,
                                                                     cpu)


def test_js_suite_card_vs_cpu(ens):
    for fn in (metrics.js_pwd, metrics.js_rg):
        _js_close(fn(ens, device="cuda"), fn(ens, device="cpu"))
    card, card_dr = metrics.js_tica(ens, lagtime=50, device="cuda")
    cpu, cpu_dr = metrics.js_tica(ens, lagtime=50, device="cpu")
    _js_close(card, cpu)
    for k in ens:
        a, b = card_dr[k].cpu().numpy(), cpu_dr[k].numpy()
        np.testing.assert_allclose(a * np.sign((a * b).sum(0)), b,
                                   rtol=1e-6, atol=1e-7)
    assert metrics.validity(ens, device="cuda") == \
        metrics.validity(ens, device="cpu")
    assert metrics.bonding_validity(ens, device="cuda") == \
        metrics.bonding_validity(ens, device="cpu")
    for card_v, cpu_v in zip(metrics.idp_metrics(ens, device="cuda"),
                             metrics.idp_metrics(ens, device="cpu")):
        for k in cpu_v:
            assert card_v[k] == pytest.approx(cpu_v[k], rel=1e-9, abs=1e-15)


def test_binned_counts_card_vs_cpu(ens):
    pwd = metrics.pairwise_distance_ca(ens["target"], k=3, device="cpu")
    lo, hi = pwd.min(0).values, pwd.max(0).values
    cpu = metrics._binned(pwd, lo, hi, 50)
    card = metrics._binned(pwd.cuda(), lo.cuda(), hi.cuda(), 50)
    assert torch.equal(card.cpu(), cpu)


def test_fits_card_vs_cpu(ens):
    x = torch.from_numpy(ens["a"][:30])
    gapped = x.clone()
    gapped[::3, 5:9] = float("nan")
    for fn, args in ((align.pair_deviations, (gapped,)),
                     (geo.pairwise_rmsd_matrix, (x,)),
                     (geo.rmsd_batched, (x, x[0])),
                     (metrics.pairwise_distance_ca, (x,))):
        cpu = fn(*args)
        card = fn(*[a.cuda() for a in args]).cpu()
        assert torch.equal(torch.isnan(card), torch.isnan(cpu))
        torch.testing.assert_close(card, cpu, rtol=0, atol=1e-9,
                                   equal_nan=True)
