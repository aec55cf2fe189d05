"""The port's PDB writers, merge/split helpers, CA loader, native PDB
parser and ``decode_structure_tokens`` against the JAX package's, on the
CPU: text byte-equal, arrays equal, every field of ``Protein`` equal
between the native and the Python parser, decoder outputs 1e-4 with the
weights carried across."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esmdiff_tpu.api import protein_api as japi
from esmdiff_tpu.core import constants as C
from esmdiff_tpu.core import protein as jprotein
from esmdiff_tpu.models import vqvae as jvq
from esmdiff_tpu_torch.api import protein_api as tapi
from esmdiff_tpu_torch.core import protein as tprotein
from esmdiff_tpu_torch.models import vqvae as tvq
from esmdiff_tpu_torch.utils import native
from test_torch_support import carry, perturb, to_np

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TARGETS = ROOT / "data" / "targets"
BPTI = TARGETS / "bpti" / "bpti.pdb"
# a fixed subset of the staged targets: every 14th file of the 282
PARSE_FILES = sorted(TARGETS.glob("*/*.pdb"))[::14]


def _fields(p):
    return [f.name for f in dataclasses.fields(p)]


def _assert_same_protein(a, b, where=""):
    assert _fields(a) == _fields(b)
    for name in _fields(a):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, (where, name)
        np.testing.assert_array_equal(x, y, err_msg=f"{where} {name}")


@pytest.fixture(scope="module")
def bpti():
    return tprotein.from_pdb_file(BPTI)


@pytest.fixture(scope="module")
def ensemble_file(tmp_path_factory, bpti):
    """A 5-MODEL file of jittered BPTI backbones."""
    rng = np.random.RandomState(0)
    prots = [tprotein.from_backbone(
        bpti.backbone_coords() + rng.randn(len(bpti.aatype), 3, 3) * 0.3,
        sequence=bpti.sequence) for _ in range(5)]
    path = tmp_path_factory.mktemp("ens") / "ens.pdb"
    tprotein.ensemble_to_pdb_file(prots, path)
    return path


# -- writers -----------------------------------------------------------------

@pytest.mark.parametrize("path", [BPTI, TARGETS / "apo" / "1jm4.B.pdb",
                                  sorted((TARGETS / "ped").glob("*.pdb"))[0]])
def test_to_pdb_byte_equal(path, tmp_path):
    got = tprotein.from_pdb_file(path)
    prot = got[0] if isinstance(got, list) else got
    assert tprotein.to_pdb(prot) == jprotein.to_pdb(prot)
    assert tprotein.to_pdb(prot, "B") == jprotein.to_pdb(prot, "B")
    tprotein.to_pdb_file(prot, tmp_path / "port.pdb")
    jprotein.to_pdb_file(prot, tmp_path / "jax.pdb")
    assert (tmp_path / "port.pdb").read_bytes() == \
        (tmp_path / "jax.pdb").read_bytes()


def test_esmprotein_to_pdb_byte_equal(tmp_path):
    tapi.ESMProtein.from_pdb(BPTI).to_pdb(tmp_path / "port.pdb")
    japi.ESMProtein.from_pdb(BPTI).to_pdb(tmp_path / "jax.pdb")
    assert (tmp_path / "port.pdb").read_bytes() == \
        (tmp_path / "jax.pdb").read_bytes()


def test_split_and_merge_byte_equal(ensemble_file, tmp_path):
    port = tprotein.split_pdb_file(ensemble_file, tmp_path / "port")
    ref = jprotein.split_pdb_file(ensemble_file, tmp_path / "jax")
    assert [p.name for p in port] == [p.name for p in ref] == [
        f"ens.{i}.pdb" for i in range(5)]
    for a, b in zip(port, ref):
        assert a.read_bytes() == b.read_bytes()
    tprotein.merge_pdb_files(port, tmp_path / "merged_port.pdb")
    jprotein.merge_pdb_files(ref, tmp_path / "merged_jax.pdb")
    merged = (tmp_path / "merged_port.pdb").read_bytes()
    assert merged == (tmp_path / "merged_jax.pdb").read_bytes()
    assert merged == ensemble_file.read_bytes()


# -- load_ca_ensemble --------------------------------------------------------

def test_load_ca_ensemble_pdb_and_directory(ensemble_file, tmp_path):
    d = tmp_path / "dir"
    d.mkdir()
    (d / "b.pdb").write_bytes(ensemble_file.read_bytes())
    (d / "a.pdb").write_bytes(BPTI.read_bytes())
    (d / "notes.txt").write_text("not a structure")
    for path, kw in ((ensemble_file, {}), (BPTI, {}), (d, {}),
                     (d, {"max_n_model": 4}), (ensemble_file,
                                               {"max_n_model": 2})):
        out = tprotein.load_ca_ensemble(path, **kw)
        ref = jprotein.load_ca_ensemble(path, **kw)
        assert out.dtype == ref.dtype
        np.testing.assert_array_equal(out, ref)
    assert len(tprotein.load_ca_ensemble(d)) == 6   # a.pdb first, then b.pdb


@pytest.mark.parametrize("shape", [(23, 7, 3), (23, 7, 4, 3)])
def test_load_ca_ensemble_npy(shape, tmp_path):
    """.npy in nm (x10 to angstrom), CA at atom 1 of a 4-D array, and
    max_n_model's stride."""
    arr = np.random.RandomState(1).randn(*shape).astype(np.float32)
    np.save(tmp_path / "traj.npy", arr)
    for kw in ({}, {"max_n_model": 5}, {"max_n_model": 0},
               {"max_n_model": 50}):
        out = tprotein.load_ca_ensemble(tmp_path / "traj.npy", **kw)
        ref = jprotein.load_ca_ensemble(tmp_path / "traj.npy", **kw)
        assert out.dtype == ref.dtype and out.shape == ref.shape
        np.testing.assert_array_equal(out, ref)
    ca = arr[:, :, 1] if arr.ndim == 4 else arr
    np.testing.assert_array_equal(
        tprotein.load_ca_ensemble(tmp_path / "traj.npy", max_n_model=5),
        (ca * 10.0)[::4][:5])


# -- the native parser -------------------------------------------------------

@pytest.mark.parametrize("path", PARSE_FILES, ids=lambda p: p.name)
def test_native_parser_equals_python_parser(path):
    text = path.read_text()
    nat = tprotein._native_parse_models(text, None)
    py = tprotein._python_parse_models(text, None)
    assert nat is not None and len(nat) == len(py) >= 1
    for a, b in zip(nat, py):
        _assert_same_protein(a, b, path.name)


def test_native_parser_multi_model_and_selection(ensemble_file):
    text = ensemble_file.read_text()
    nat = tprotein._native_parse_models(text, None)
    py = tprotein._python_parse_models(text, None)
    assert len(nat) == len(py) == 5
    for a, b in zip(nat, py):
        _assert_same_protein(a, b)
    sel = tprotein.from_pdb_string(text, chain_id="A", model=2)
    _assert_same_protein(sel, py[2])
    jax_models = jprotein.from_pdb_string(text)
    for a, b in zip(tprotein.from_pdb_string(text), jax_models):
        _assert_same_protein(a, b)


def test_native_parser_odd_records():
    """altloc B dropped, HETATM MSE kept and HOH dropped, insertion codes,
    the first of a duplicate atom, an unknown residue name as X, chain
    selection; a malformed coordinate defers to Python, which raises."""
    pdb = "\n".join([
        "ATOM      1  N   ALA A   1      11.000  12.000  13.000  1.00 10.00",
        "ATOM      2  CA  ALA A   1      12.000  12.500  13.500  1.00 11.00",
        "ATOM      3  CA BALA A   1      99.000  99.000  99.000  1.00 12.00",
        "ATOM      4  CA  ALA A   1      88.000  88.000  88.000  1.00 13.00",
        "HETATM    5  CA  MSE A   2      14.000  14.500  15.000  1.00 14.00",
        "HETATM    6  CA  HOH A   3      50.000  50.000  50.000  1.00  0.00",
        "ATOM      7  CA  XYZ A   4      16.000  16.500  17.000  1.00 15.00",
        "ATOM      8  CA  GLY A   4A     18.000  18.500  19.000  1.00 16.00",
        "ATOM      9  CA  SER B   9      20.000  20.500  21.000  1.00 17.00",
    ])
    for chain in (None, "B"):
        nat = tprotein._native_parse_models(pdb, chain)
        py = tprotein._python_parse_models(pdb, chain)
        assert len(nat) == len(py) == 1
        _assert_same_protein(nat[0], py[0])
    bad = pdb.replace("12.000  12.500", "12.0x0  12.500")
    assert tprotein._native_parse_models(bad, None) is None
    with pytest.raises(ValueError):
        tprotein.from_pdb_string(bad)


def test_native_parser_switch_and_non_ascii(monkeypatch):
    """ESMDIFF_NO_NATIVE_PDB selects the Python parser; non-ASCII text goes
    to it too (its character columns), with the same result."""
    text = BPTI.read_text()
    native_prot = tprotein.from_pdb_string(text)
    monkeypatch.setenv("ESMDIFF_NO_NATIVE_PDB", "1")
    assert tprotein._load_pdbio() is None
    assert tprotein._native_parse_models(text, None) is None
    _assert_same_protein(tprotein.from_pdb_string(text), native_prot)
    monkeypatch.delenv("ESMDIFF_NO_NATIVE_PDB")
    remark = "REMARK   1 café\n" + text
    assert tprotein._native_parse_models(remark, None) is None
    _assert_same_protein(tprotein.from_pdb_string(remark), native_prot)


# -- the native build --------------------------------------------------------

def test_native_libraries_land_in_the_port_build_dir():
    for name in ("pdbio", "tmscore"):
        native.load(name)
        so = native.library_path(name)
        assert so.exists() and so.parent == ROOT / "build" / "torch_ext"
        assert so.name.startswith(f"lib{name}_")


def test_native_library_keyed_by_host(monkeypatch):
    here = native.library_path("tmscore")
    monkeypatch.setattr(native, "_host", lambda: "aarch64 another cpu")
    assert native.library_path("tmscore") != here


def test_native_build_failures_raise(monkeypatch, tmp_path):
    """A failed compile raises with the compiler's output; a missing g++
    raises; nothing falls back."""
    (tmp_path / "broken").mkdir()
    (tmp_path / "broken" / "broken.cpp").write_text(
        "int f() { return undeclared_name; }\n")
    monkeypatch.setattr(native, "NATIVE", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="undeclared_name"):
        native.load("broken")
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.load("broken")
    assert not list((tmp_path / "build").glob("*.so"))


# -- decode_structure_tokens -------------------------------------------------

def test_decode_structure_tokens_matches_jax():
    cfg = jvq.DecoderConfig(d_model=64, n_heads=2, n_layers=2,
                            dtype="float32")
    toks = np.random.default_rng(3).integers(
        0, C.VQVAE_CODEBOOK_SIZE, (2, 12)).astype(np.int32)
    toks[:, 0], toks[:, -1] = C.STRUCTURE_BOS_TOKEN, C.STRUCTURE_EOS_TOKEN
    jd = jvq.StructureTokenDecoder(cfg)
    params = perturb(jd.init(jax.random.PRNGKey(0), jnp.asarray(toks))
                     ["params"], scale=0.05)
    ref = jvq.decode_structure_tokens(jd, params, jnp.asarray(toks))
    td = carry(tvq.StructureTokenDecoder(tvq.DecoderConfig(
        d_model=64, n_heads=2, n_layers=2, dtype="float32")), params)
    with torch.no_grad():
        out = tvq.decode_structure_tokens(td, torch.from_numpy(toks).long())
    assert out["bb_pred"].shape == (2, 10, 3, 3)
    assert out["plddt"].shape == (2, 10)
    for key in ("bb_pred", "plddt", "ptm"):
        np.testing.assert_allclose(to_np(out[key]), np.asarray(ref[key]),
                                   atol=1e-4)
