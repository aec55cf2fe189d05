"""The port's ENM conformers (``train/conformers.py``) against the JAX
package's on the CPU: the ANM modes within 1e-10 (the same float64
numpy), the decoys and the expanded corpus under the same seed within
1e-4 Å (the bond-band projection is XLA there and torch here); NaN
residues stay NaN, and decoys come from the train chains only."""

import numpy as np
import pytest
import torch

from esmdiff_tpu.train import conformers as jconf
from esmdiff_tpu_torch.core import protein as protein_io
from esmdiff_tpu_torch.train import conformers as tconf

torch.set_num_threads(2)

CHAINS = ("data/targets/bpti/bpti.pdb", "data/targets/apo/1bv2.A.pdb",
          "data/targets/apo/2cg7.A.pdb")


@pytest.fixture(scope="module")
def backbones():
    """Three chains' N/CA/C (``Protein.backbone_coords``), BPTI with
    residues 20-22 missing."""
    out = []
    for path in CHAINS:
        got = protein_io.from_pdb_file(path)
        out.append((got[0] if isinstance(got, list) else got)
                   .backbone_coords())
    out[0][20:23] = np.nan
    return out


def test_backbone_coords_match_jax(backbones):
    from esmdiff_tpu.core import protein as jprotein

    for path in CHAINS:
        want = jprotein.from_pdb_file(path)
        got = protein_io.from_pdb_file(path)
        np.testing.assert_array_equal(got.backbone_coords(),
                                      want.backbone_coords())
        np.testing.assert_array_equal(got.ca_coords(), want.ca_coords())


@pytest.mark.parametrize("n_modes,cutoff", [(20, 15.0), (6, 10.0)])
def test_anm_modes_equal_jax(backbones, n_modes, cutoff):
    for bb in backbones:
        ca = bb[np.isfinite(bb).all(axis=(-1, -2)), 1]
        modes, lam = tconf.anm_modes(ca, n_modes=n_modes, cutoff=cutoff)
        jmodes, jlam = jconf.anm_modes(ca, n_modes=n_modes, cutoff=cutoff)
        np.testing.assert_allclose(lam, jlam, rtol=0, atol=1e-10)
        np.testing.assert_allclose(modes, jmodes, rtol=0, atol=1e-10)


@pytest.mark.parametrize("refine", [True, False])
def test_enm_conformers_equal_jax(backbones, refine):
    bb = backbones[0]
    got = tconf.enm_conformers(bb, 3, rs=np.random.RandomState(7),
                               refine=refine, device="cpu")
    want = jconf.enm_conformers(bb, 3, rs=np.random.RandomState(7),
                                refine=refine)
    assert got.shape == (3,) + bb.shape and got.dtype == np.float32
    assert np.isnan(got[:, 20:23]).all()
    assert np.isfinite(np.delete(got, [20, 21, 22], axis=1)).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the decoys moved, and differ from each other
    ca0, ca = np.delete(bb[:, 1], [20, 21, 22], 0), np.delete(
        got[:, :, 1], [20, 21, 22], 1)
    assert (np.sqrt(((ca - ca0) ** 2).sum(-1).mean(-1)) > 0.3).all()


def test_synthesize_corpus_equals_jax(backbones):
    """Three chains NaN-padded to one length, chains 0 and 2 the train
    split, two decoys a chain: the same corpus, lengths and origins, the
    held-out chain 1 never the origin of a decoy."""
    lp = max(len(b) for b in backbones)
    bbs = np.full((3, lp, 3, 3), np.nan, np.float32)
    lengths = np.zeros(3, np.int32)
    for i, b in enumerate(backbones):
        bbs[i, :len(b)], lengths[i] = b, len(b)
    train_idx = np.asarray([0, 2])
    got = tconf.synthesize_corpus(bbs, lengths, train_idx, 2, seed=3,
                                  log=None, device="cpu")
    want = jconf.synthesize_corpus(bbs, lengths, train_idx, 2, seed=3,
                                   log=None)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    assert got[0].shape == (7, lp, 3, 3)
    np.testing.assert_array_equal(got[0][:3], bbs)
    assert list(got[2]) == [0, 1, 2, 0, 0, 2, 2]
    for row, origin in zip(got[0][3:], got[2][3:]):
        L = lengths[origin]
        assert np.isnan(row[L:]).all()
        np.testing.assert_array_equal(np.isnan(row[:L]),
                                      np.isnan(bbs[origin, :L]))
