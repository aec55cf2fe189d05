"""The port's Kabsch-Sander assigner (float64 torch, batched over chains)
against the JAX package's numpy one, on the CPU: H-bond energies within
1e-9 kcal/mol, the bond matrices, the 3-state strings and the fractions
equal, on BPTI and twenty chains of data/targets; ``--with_dssp`` through
``esmdiff-torch-preprocess`` with two workers, against JAX's CLI."""

from pathlib import Path

import numpy as np
import pytest
import torch

from esmdiff_tpu.cli import preprocess as jpre
from esmdiff_tpu.core import protein as jprotein
from esmdiff_tpu.core import secondary_structure as jss
from esmdiff_tpu_torch.cli import preprocess as tpre
from esmdiff_tpu_torch.core import protein as tprotein
from esmdiff_tpu_torch.core import secondary_structure as tss
from test_mmcif import proteins_to_mmcif

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TARGETS = ROOT / "data" / "targets"
# BPTI and twenty chains: every 14th file of the 282
FILES = [TARGETS / "bpti" / "bpti.pdb",
         *sorted(TARGETS.glob("*/*.pdb"))[::14][:20]]
CPU = "cpu"


def _pair(path):
    j = jprotein.from_pdb_file(path)
    t = tprotein.from_pdb_file(path)
    return (j[0] if isinstance(j, list) else j,
            t[0] if isinstance(t, list) else t)


@pytest.fixture(scope="module")
def chains():
    return [_pair(f) for f in FILES]


def _jax_energy(prot):
    """JAX's energy matrix, from its own backbone and amide-H helpers and
    the formula of its ``hbond_matrix``."""
    (n, n_ok), _, (c, c_ok), (o, o_ok) = jss._backbone(prot)
    h, _ = jss._amide_h(n, c, o, n_ok, c_ok & o_ok)

    def dist(a, b):
        return np.maximum(
            np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1), 1e-3)

    return jss._Q1Q2_F * (1.0 / dist(n, o) + 1.0 / dist(h, c)
                          - 1.0 / dist(h, o) - 1.0 / dist(n, c))


def test_hbond_energy_and_matrix_equal_jax(chains):
    for (j, t), f in zip(chains, FILES):
        want = _jax_energy(j)
        got = tss.hbond_energy(t, device=CPU)
        finite = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), finite, err_msg=f)
        np.testing.assert_allclose(got[finite], want[finite], rtol=0,
                                   atol=1e-9, err_msg=str(f))
        np.testing.assert_array_equal(tss.hbond_matrix(t, device=CPU),
                                      jss.hbond_matrix(j), err_msg=str(f))


def test_strings_and_fractions_equal_jax(chains):
    """One chain at a time and all twenty-one in one batched call (padded
    to the longest): the same strings; helices and strands both occur."""
    want = [jss.assign_secondary_structure(j) for j, _ in chains]
    batched = tss.assign_secondary_structure_batch([t for _, t in chains],
                                                   device=CPU)
    assert batched == want
    for (_, t), w in zip(chains[:5], want):
        assert tss.assign_secondary_structure(t, device=CPU) == w
    for w in want:
        assert tss.ss_fractions(w) == jss.ss_fractions(w)
    joined = "".join(want)
    assert "H" in joined and "E" in joined


def test_batches_split_by_size(chains, monkeypatch):
    """Groups of a bounded padded size give the strings of one batch."""
    want = tss.assign_secondary_structure_batch([t for _, t in chains],
                                                device=CPU)
    monkeypatch.setattr(tss, "BATCH_ELEMENTS", 100 * 100)
    prots = [t for _, t in chains]
    assert len(list(tss._batches(prots))) > 3
    assert tss.assign_secondary_structure_batch(prots, device=CPU) == want


def test_short_and_gapped_chains_equal_jax(chains):
    """Chains of 1 to 6 residues and a chain with missing backbone atoms:
    the edges of the helix and bridge ranges."""
    j, t = chains[0]
    cases = []
    for L in (1, 2, 3, 5, 6):
        cases.append((jprotein.Protein(*(np.array(getattr(j, f)[:L]) for f in
                                         ("atom_positions", "atom_mask",
                                          "aatype", "residue_index",
                                          "b_factors"))), L))
    mask = np.array(j.atom_mask)
    mask[10:13, :4] = 0.0
    cases.append((jprotein.Protein(j.atom_positions, mask, j.aatype,
                                   j.residue_index, j.b_factors), None))
    for jp, L in cases:
        tp = tprotein.Protein(np.array(jp.atom_positions),
                              np.array(jp.atom_mask), np.array(jp.aatype),
                              np.array(jp.residue_index),
                              np.array(jp.b_factors))
        assert tss.assign_secondary_structure(tp, device=CPU) == \
            jss.assign_secondary_structure(jp), L


def test_cli_with_dssp_two_workers_equals_jax(chains, tmp_path):
    """--with_dssp --num_workers 2 (a spawn pool parses, this process
    assigns on --device cpu): the same .npz arrays, strings and
    metadata.csv as JAX's CLI."""
    src = tmp_path / "cif"
    src.mkdir()
    for (j, _), f in zip(chains[:8], FILES):
        name = f.stem.replace(".", "_").lower()
        (src / f"{name}.cif").write_text(proteins_to_mmcif([("A", j)]))
    jpre.main([str(src), str(tmp_path / "jax"), "--with_dssp"])
    out = tpre.main([str(src), str(tmp_path / "port"), "--with_dssp",
                     "--num_workers", "2", "--device", "cpu"])
    assert out["ok"] == 8
    for name in sorted(p.name for p in (tmp_path / "jax").glob("*.npz")):
        with np.load(tmp_path / "jax" / name) as x, \
                np.load(tmp_path / "port" / name) as y:
            assert list(x.keys()) == list(y.keys())
            for k in x.keys():
                np.testing.assert_array_equal(x[k], y[k], err_msg=name)
    assert (tmp_path / "port" / "metadata.csv").read_text() == \
        (tmp_path / "jax" / "metadata.csv").read_text()


def test_assigner_refuses_cuda_without_card(chains, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tss.assign_secondary_structure(chains[0][1])
