"""The port's post-decode geometry projection
(``esmdiff_tpu_torch/ops/refine.py``) against the JAX package's on the
CPU: refined CA traces within 1e-5 A, NaN-masked residues included, and the
backbone variant's rigid per-residue shift."""

import numpy as np
import pytest
import torch

from esmdiff_tpu.ops import refine as jrefine
from esmdiff_tpu_torch.api.protein_api import ESMProtein
from esmdiff_tpu_torch.ops import refine as trefine

torch.set_num_threads(2)

BPTI_PDB = "data/targets/bpti/bpti.pdb"


def _decode_floor_ensemble(M=3, scale=1.4, noise=2.0, seed=0):
    """BPTI's CA trace stretched and jittered, as the scratch decoder's
    outputs are: bonds far out of band and clashes."""
    ca = ESMProtein.from_pdb(BPTI_PDB).coordinates[:, 1]        # (L, 3)
    rs = np.random.RandomState(seed)
    bad = ca[None] * scale + rs.randn(M, ca.shape[0], 3) * noise
    return bad.astype(np.float32)


@pytest.mark.parametrize("nan_rows", [False, True])
def test_refine_ca_matches_jax(nan_rows):
    bad = _decode_floor_ensemble()
    if nan_rows:
        bad[0, 10:13] = np.nan       # a chain break inside the trace
        bad[1, 0] = np.nan           # the first residue
        bad[2, -1] = np.nan          # the last
    ref = jrefine.refine_ca_ensemble(bad)
    got = trefine.refine_ca_ensemble(bad, device="cpu")
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0, equal_nan=True)
    adj = np.linalg.norm(np.diff(got, axis=1), axis=-1)
    ok = np.isfinite(adj)
    assert ok.any() and (adj[ok] > trefine.BOND_LO - 1e-3).all()
    assert (adj[ok] < trefine.BOND_HI + 1e-3).all()


def test_refine_options_and_single_trace_match_jax():
    bad = _decode_floor_ensemble(M=1, seed=1)[0]                # (L, 3)
    kw = dict(iters=30, bond_lo=3.7, bond_hi=3.9, clash_min=3.5, min_sep=3,
              damping=0.4)
    ref = jrefine.refine_ca_ensemble(bad, **kw)
    got = trefine.refine_ca_ensemble(bad, device="cpu", **kw)
    assert got.shape == ref.shape == (1,) + bad.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_refine_backbone_matches_jax():
    ca = _decode_floor_ensemble(M=2, seed=2)
    off_n = np.array([-1.46, 0.0, 0.0], np.float32)
    off_c = np.array([1.52, 0.0, 0.0], np.float32)
    bb = np.stack([ca + off_n, ca, ca + off_c], axis=2)         # (M, L, 3, 3)
    bb[1, 5] = np.nan
    ref = jrefine.refine_backbone_ensemble(bb)
    got = trefine.refine_backbone_ensemble(bb, device="cpu")
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0, equal_nan=True)
    one = trefine.refine_backbone_ensemble(bb[0], device="cpu")
    np.testing.assert_allclose(one, got[0], atol=1e-6, rtol=0)


def test_refine_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trefine.refine_ca_ensemble(_decode_floor_ensemble(M=1))
