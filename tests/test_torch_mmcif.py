"""The port's mmCIF parser and ``esmdiff-torch-preprocess`` against the
JAX package's, on the CPU, on mmCIF files written from PDB chains under
data/targets: every parsed field equal, the ``.npz`` files key for key and
bit for bit, ``metadata.csv`` byte for byte, in chain and complex modes."""

import dataclasses
import gzip
from pathlib import Path

import numpy as np
import pytest
import torch

from esmdiff_tpu.cli import preprocess as jpre
from esmdiff_tpu.core import mmcif as jmmcif
from esmdiff_tpu.core import protein as jprotein
from esmdiff_tpu_torch.cli import dump as dump_cli
from esmdiff_tpu_torch.cli import preprocess as tpre
from esmdiff_tpu_torch.core import mmcif as tmmcif
from esmdiff_tpu_torch.core import protein as tprotein
from test_mmcif import proteins_to_mmcif

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TARGETS = ROOT / "data" / "targets"
BPTI = TARGETS / "bpti" / "bpti.pdb"
# ten chains of the staged targets: every 28th file of the 282
TEN = sorted(TARGETS.glob("*/*.pdb"))[::28][:10]


def _chain(path):
    prot = jprotein.from_pdb_file(path)
    return prot[0] if isinstance(prot, list) else prot


def _write(path, text):
    if path.suffix == ".gz":
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        path.write_text(text)
    return path


@pytest.fixture(scope="module")
def cif_dir(tmp_path_factory):
    """BPTI, ten chains (every third gzipped), a dimer with an oligomeric
    loop, a complex whose chains carry UNK termini, a file at 9 A and a
    short chain: the cases both packages' filters and modes meet."""
    d = tmp_path_factory.mktemp("cif")
    bpti = _chain(BPTI)
    _write(d / "bpti.cif", proteins_to_mmcif([("A", bpti)]))
    for i, path in enumerate(TEN):
        name = path.stem.replace(".", "_").lower()
        suffix = ".cif.gz" if i % 3 == 0 else ".cif"
        _write(d / f"{name}{suffix}", proteins_to_mmcif(
            [("B", _chain(path))], entry_id=name, resolution=1.0 + 0.3 * i))
    _write(d / "dimer.cif", proteins_to_mmcif(
        [("A", bpti), ("B", bpti)], oligomeric="dimeric",
        oligomeric_loop=True))
    bb = bpti.backbone_coords()
    a = jprotein.from_backbone(bb[:20], sequence="X" + bpti.sequence[1:20])
    b = jprotein.from_backbone(bb[20:40],
                               sequence=bpti.sequence[20:39] + "X")
    _write(d / "cplx.cif.gz", proteins_to_mmcif([("A", a), ("BA", b)]))
    _write(d / "lowres.cif", proteins_to_mmcif([("A", bpti)],
                                               resolution=9.0))
    short = jprotein.from_backbone(bb[:5], sequence=bpti.sequence[:5])
    _write(d / "short.cif", proteins_to_mmcif([("A", short)]))
    (d / "broken.cif").write_text("data_broken\n#\n")
    return d


def test_parse_equals_jax(cif_dir):
    files = sorted(cif_dir.glob("*.cif*"))
    assert len(files) == 16
    for path in files:
        if path.name == "broken.cif":
            for parse in (jmmcif.parse_mmcif, tmmcif.parse_mmcif):
                with pytest.raises(Exception, match="no polymer atoms"):
                    parse(path)
            continue
        want, got = jmmcif.parse_mmcif(path), tmmcif.parse_mmcif(path)
        assert dataclasses.asdict(got.header) == \
            dataclasses.asdict(want.header), path
        assert list(got.chains) == list(want.chains), path
        for cid, w in want.chains.items():
            g = got.chains[cid]
            assert isinstance(g, tprotein.Protein)
            for f in dataclasses.fields(w):
                x, y = getattr(g, f.name), getattr(w, f.name)
                assert x.dtype == y.dtype, (path, cid, f.name)
                np.testing.assert_array_equal(x, y, err_msg=f"{path} {cid}")
    dimer = tmmcif.parse_mmcif(cif_dir / "dimer.cif")
    assert dimer.header.oligomeric_detail == "dimeric,dimeric"
    assert tmmcif.parse_mmcif(cif_dir / "bpti.cif").header.resolution == 1.8


def _assert_same_outputs(a: Path, b: Path):
    names = sorted(p.name for p in a.glob("*.npz"))
    assert names and names == sorted(p.name for p in b.glob("*.npz"))
    for name in names:
        with np.load(a / name) as x, np.load(b / name) as y:
            assert list(x.keys()) == list(y.keys()), name
            for k in x.keys():
                assert x[k].dtype == y[k].dtype, (name, k)
                np.testing.assert_array_equal(x[k], y[k], err_msg=name)
    assert (a / "metadata.csv").read_text() == \
        (b / "metadata.csv").read_text()


@pytest.mark.parametrize("mode", ["chain", "complex"])
def test_preprocess_equals_jax(cif_dir, tmp_path, mode):
    """Chain and complex modes: the same files, arrays and metadata rows
    (the parse error, the resolution and length filters, the homomer and
    heteromer categories, chain_index with 'BA' and UNK termini)."""
    args = ["--mode", mode, "--min_len", "10"]
    jpre.main([str(cif_dir), str(tmp_path / "jax"), *args])
    out = tpre.main([str(cif_dir), str(tmp_path / "port"), *args])
    _assert_same_outputs(tmp_path / "jax", tmp_path / "port")
    statuses = " ".join(r["status"] for r in out["rows"])
    for s in ("parse_error", "resolution_filtered", "length_filtered"):
        assert s in statuses
    if mode == "complex":
        with np.load(tmp_path / "port" / "cplx.npz") as z:
            assert len(z["aatype"]) == 38 and "X" not in str(z["sequence"])
            assert sorted(set(z["chain_index"].tolist())) == [
                tpre.chain_str_to_int("A"), tpre.chain_str_to_int("BA")]


def test_chain_ids_fall_back_to_sequential_on_collision(tmp_path):
    """'AB' and 'BA' map to one integer under the reference's additive
    map: complex mode then numbers the chains 0, 1, as JAX does."""
    assert tpre.chain_str_to_int("AB") == tpre.chain_str_to_int("BA")
    bpti = _chain(BPTI)
    (tmp_path / "in").mkdir()
    (tmp_path / "in" / "pair.cif").write_text(proteins_to_mmcif(
        [("AB", bpti), ("BA", bpti)]))
    for pkg, out in ((jpre, "jax"), (tpre, "port")):
        pkg.main([str(tmp_path / "in"), str(tmp_path / out), "--mode",
                  "complex"])
    _assert_same_outputs(tmp_path / "jax", tmp_path / "port")
    with np.load(tmp_path / "port" / "pair.npz") as z:
        assert sorted(set(z["chain_index"].tolist())) == [0, 1]


def test_filter_metadata_equals_jax(cif_dir, tmp_path):
    """The curation stage (--filter_only / filter_metadata) keeps the same
    rows, with and without the oligomeric filter."""
    tpre.main([str(cif_dir), str(tmp_path / "pre")])
    meta = tmp_path / "pre" / "metadata.csv"
    for olig in ("monomeric", "dimeric", ""):
        want = jpre.filter_metadata(meta, None, oligomeric=olig)
        got = tpre.filter_metadata(meta, None, oligomeric=olig)
        assert got == want and (olig != "monomeric" or len(got) >= 11)
    jpre.main([str(meta), str(tmp_path / "jf"), "--filter_only"])
    out = tpre.main([str(meta), str(tmp_path / "tf"), "--filter_only"])
    assert (tmp_path / "tf" / "filtered.csv").read_text() == \
        (tmp_path / "jf" / "filtered.csv").read_text()
    assert out["ok"] == len(out["rows"]) >= 11


def test_dump_of_a_complex_inserts_its_chainbreak(cif_dir, tmp_path):
    """The dump reads a complex .npz: one chainbreak token where
    chain_index changes, the chains' residues either side."""
    from esmdiff_tpu_torch.core import constants as C

    tpre.main([str(cif_dir), str(tmp_path / "pre"), "--mode", "complex"])
    (tmp_path / "one").mkdir()
    (tmp_path / "pre" / "cplx.npz").rename(tmp_path / "one" / "cplx.npz")
    dump_cli.main([str(tmp_path / "one"), str(tmp_path / "enc"),
                   "--model_scale", "tiny", "--device", "cpu"])
    with np.load(tmp_path / "enc" / "cplx.npz") as z:
        seq = z["sequence_tokens"]
    assert len(seq) == 38 + 1 + 2
    assert (seq == C.SEQUENCE_CHAINBREAK_TOKEN).sum() == 1
    assert int(np.nonzero(seq == C.SEQUENCE_CHAINBREAK_TOKEN)[0][0]) == 20


def test_preprocess_without_card_raises_with_dssp(cif_dir, tmp_path,
                                                  monkeypatch):
    """--with_dssp runs on the card unless --device cpu: without one it
    raises before writing; the parse alone needs no device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpre.main([str(cif_dir), str(tmp_path / "o"), "--with_dssp"])
    assert not (tmp_path / "o").exists()
    assert tpre.main([str(cif_dir), str(tmp_path / "p")])["ok"] > 0
