"""The port's benchmark suites (esmdiff_tpu_torch.eval.analysis) and its
``esmdiff-torch-analyze`` against the JAX package's on the same files, on
the CPU (``device="cpu"``, ``--device cpu``): every JSON and CSV value.

JAX's numpy computes in its input's dtype, and its CA loader returns
float32 for PDB files; the port computes in float64.  So that both sides
compute the same function, the JAX suites get their loader's arrays as
float64 here (the ``jax_float64`` fixture): the same CA values, widened.
Tolerances as tests/test_torch_eval.py: JS equal after JAX's rounding or
within 1e-4 on a rounding boundary, validity exact, TM bit-equal, the rest
1e-9 relative.  The JAX suites score TM through the port's TM library
(``tm_library`` fixture): its rotation is repaired where the shared one
stops short far from native, and tests/test_torch_eval.py holds it
against the optimal (SVD) fit and against JAX's own library; here the
suites around it are compared.
"""

import csv
import dataclasses
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from esmdiff_tpu.cli import analyze as janalyze_cli
from esmdiff_tpu.eval import analysis as janalysis
from esmdiff_tpu.eval import tmscore as jtmscore
from esmdiff_tpu_torch.cli import analyze as analyze_cli
from esmdiff_tpu_torch.core import protein as tprotein
from esmdiff_tpu_torch.eval import analysis
from esmdiff_tpu_torch.eval import tmscore

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TARGETS = ROOT / "data" / "targets"
BPTI = TARGETS / "bpti" / "bpti.pdb"
APO = [TARGETS / "apo" / n for n in ("1a6d.A.pdb", "1ael.A.pdb",
                                     "1akz.A.pdb")]
PED = sorted((TARGETS / "ped").glob("*.pdb"))[:3]
CPU = "cpu"


@pytest.fixture(autouse=True)
def tm_library(monkeypatch):
    """JAX's suites on the port's TM library (the same C entry points)."""
    monkeypatch.setattr(jtmscore, "_load_library", tmscore._library)


@pytest.fixture
def jax_float64(monkeypatch):
    load = janalysis.load_ca_ensemble

    def widened(*args, **kwargs):
        return load(*args, **kwargs).astype(np.float64)

    monkeypatch.setattr(janalysis, "load_ca_ensemble", widened)


def _jitter(prot, n, scale, seed, gap=None):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        bb = prot.backbone_coords() + rng.randn(len(prot.aatype), 3, 3) * scale
        out.append(tprotein.from_backbone(bb, sequence=prot.sequence))
    if gap is not None:       # one model loses a stretch of residues
        keep = np.ones(len(prot.aatype), bool)
        keep[gap] = False
        p = out[0]
        out[0] = dataclasses.replace(
            p, atom_positions=p.atom_positions[keep],
            atom_mask=p.atom_mask[keep], aatype=p.aatype[keep],
            residue_index=p.residue_index[keep],
            b_factors=p.b_factors[keep])
    return out


@pytest.fixture(scope="module")
def ensembles(tmp_path_factory):
    root = tmp_path_factory.mktemp("ens")
    prot = tprotein.from_pdb_file(BPTI)
    for name, scale, n, seed in (("target", 0.4, 30, 1), ("close", 0.4, 12, 2),
                                 ("far", 4.0, 12, 3)):
        tprotein.ensemble_to_pdb_file(_jitter(prot, n, scale, seed),
                                      root / f"{name}.pdb")
    clusters = root / "clusters"
    clusters.mkdir()
    shutil.copy(BPTI, clusters / "bpti.pdb")
    tprotein.to_pdb_file(_jitter(prot, 1, 1.0, 4)[0], clusters / "c2.pdb")
    return root


def _gapped(prot, start, n, first_index, seed):
    """The same chain minus an internal stretch, renumbered, its atoms moved
    by 0.5 A (so that the pair's per-residue deviations are a signal, not
    rounding noise, when correlated with the samples' fluctuation)."""
    keep = np.ones(len(prot.aatype), bool)
    keep[start:start + n] = False
    moved = prot.atom_positions + np.random.RandomState(seed).randn(
        *prot.atom_positions.shape).astype(np.float32) * 0.5
    return dataclasses.replace(
        prot, atom_positions=moved[keep],
        atom_mask=prot.atom_mask[keep], aatype=prot.aatype[keep],
        residue_index=np.arange(first_index, first_index + keep.sum(),
                                dtype=np.int32),
        b_factors=prot.b_factors[keep])


@pytest.fixture(scope="module")
def apo_set(tmp_path_factory):
    """Three real apo targets in the splits layout (<dir>/<name[:2]>/<name>),
    each with a gapped, renumbered, moved holo partner and 6 jittered
    samples (one with a gap of its own), and the splits CSV."""
    root = tmp_path_factory.mktemp("apo")
    structures, samples = root / "structures", root / "samples"
    samples.mkdir()
    rows = []
    for i, t in enumerate(APO):
        prot = tprotein.from_pdb_file(t)
        L = len(prot.aatype)
        name1, name2 = t.name, f"{t.stem}_holo.pdb"
        holo = _gapped(prot, L // 2, 4, 200, seed=i)
        for name, p in ((name1, prot), (name2, holo)):
            (structures / name[:2]).mkdir(parents=True, exist_ok=True)
            tprotein.to_pdb_file(p, structures / name[:2] / name)
        tprotein.ensemble_to_pdb_file(
            _jitter(prot, 6, 0.3 + 0.3 * i, 10 + i, gap=slice(5, 9)),
            samples / f"{t.stem}.pdb")
        rows.append({"name": name1, "holo": name2, "seqres": prot.sequence})
    pairs_csv = root / "apo.csv"
    with open(pairs_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["name", "holo", "seqres"])
        w.writeheader()
        w.writerows(reversed(rows))        # the readers sort by name
    return root, pairs_csv, structures, samples


def _close(a, b, path="", js=False):
    """Every value of two JSON-like trees: strings, ints and None equal;
    floats within 1e-9 relative (JS: the rounding-boundary rule)."""
    assert type(a) is type(b) or (isinstance(a, float)
                                   and isinstance(b, float)), (path, a, b)
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}", js or k.startswith("js_"))
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]", js)
    elif isinstance(a, float):
        if js:
            assert abs(a - b) <= 1e-4 + 1e-12, (path, a, b)
        else:
            assert a == pytest.approx(b, rel=1e-9, abs=1e-12), (path, a, b)
    else:
        assert a == b, (path, a, b)


def _csv_rows(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return [rows[0]] + [[c if i == 0 else float(c) for i, c in enumerate(r)]
                        for r in rows[1:]]


# -- the suites --------------------------------------------------------------

def test_bpti_evaluation_matches_jax(ensembles, tmp_path, jax_float64):
    preds = {"close": ensembles / "close.pdb", "far": ensembles / "far.pdb"}
    out = analysis.bpti_evaluation(preds, ensembles / "target.pdb",
                                   output_dir=tmp_path / "port", lagtime=2,
                                   device=CPU)
    ref = janalysis.bpti_evaluation(preds, ensembles / "target.pdb",
                                    output_dir=tmp_path / "jax", lagtime=2)
    _close(out, ref)
    assert out["val_clash"] == ref["val_clash"]
    assert out["val_bond"] == ref["val_bond"]
    assert out["js_pwd"][0] < out["js_pwd"][1]
    port_csv = _csv_rows(tmp_path / "port" / "js_metrics.csv")
    jax_csv = _csv_rows(tmp_path / "jax" / "js_metrics.csv")
    assert port_csv[0] == jax_csv[0]
    for a, b in zip(port_csv[1:], jax_csv[1:]):
        _close(dict(zip(port_csv[0], a)), dict(zip(jax_csv[0], b)))


def test_bpti_rmsd_clusters_equal_jax(ensembles, tmp_path):
    preds = {"close": ensembles / "close.pdb", "far": ensembles / "far.pdb"}
    out = analysis.bpti_rmsd_clusters(preds, ensembles / "clusters",
                                      output_dir=tmp_path / "port")
    ref = janalysis.bpti_rmsd_clusters(preds, ensembles / "clusters",
                                       output_dir=tmp_path / "jax")
    assert out == ref
    assert (tmp_path / "port" / "bpti_tm_rmsd_div.json").read_bytes() == \
        (tmp_path / "jax" / "bpti_tm_rmsd_div.json").read_bytes()
    assert out["close"]["TM-ens"] > out["far"]["TM-ens"]


def test_apo_analyze_matches_jax(apo_set, tmp_path):
    root, pairs_csv, structures, samples = apo_set
    pairs = analysis.load_pairs_csv(pairs_csv, structures)
    out = analysis.apo_analyze(samples, pairs, output_dir=tmp_path / "port",
                               device=CPU)
    ref = janalysis.apo_analyze(samples, pairs, output_dir=tmp_path / "jax")
    _close(out, ref)
    assert len(out["per_target"]) == 3
    for row in out["per_target"]:
        assert row["gaps"][1] - row["gaps"][0] == 4   # the holo's stretch
        assert row["tm_pair"] > 0.9
    _close(json.loads((tmp_path / "port" / "apo_metrics.json").read_text()),
           json.loads((tmp_path / "jax" / "apo_metrics.json").read_text()))


def test_apo_analyze_skips_missing_samples(apo_set, tmp_path):
    root, pairs_csv, structures, _ = apo_set
    pairs = analysis.load_pairs_csv(pairs_csv, structures)
    (tmp_path / "empty").mkdir()
    assert analysis.apo_analyze(tmp_path / "empty", pairs, device=CPU) == \
        janalysis.apo_analyze(tmp_path / "empty", pairs) == \
        {"error": "no targets evaluated"}


def test_ped_evaluation_matches_jax(ensembles, jax_float64):
    preds = {"close": ensembles / "close.pdb", "far": ensembles / "far.pdb"}
    out = analysis.ped_evaluation(preds, PED, device=CPU)
    ref = janalysis.ped_evaluation(preds, PED)
    _close(out, ref)
    assert all(np.isfinite(v) for k in out if k != "name" for v in out[k])


@pytest.mark.parametrize("case", ["holo", "other_column", "fallback"])
def test_load_pairs_csv_matches_pandas(case, tmp_path):
    """The csv-module reader against JAX's pandas reader: the sort by name,
    the holo column and its fallback to 'other', seqres."""
    col = "holo" if case == "holo" else "other"
    rows = [{"name": "2xyz.A.pdb", col: "9abc.B.pdb", "seqres": "ACDE"},
            {"name": "1abc.A.pdb", col: "1abd.A.pdb", "seqres": "MKV"},
            {"name": "1aaa.C.pdb", col: "3qqq.A.pdb", "seqres": "GGS"}]
    path = tmp_path / "pairs.csv"
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["name", col, "seqres"])
        w.writeheader()
        w.writerows(rows)
    holo_col = {"holo": "holo", "other_column": "other",
                "fallback": "holo"}[case]
    out = analysis.load_pairs_csv(path, tmp_path / "s", holo_col=holo_col)
    ref = janalysis.load_pairs_csv(path, tmp_path / "s", holo_col=holo_col)
    assert out == ref
    assert [p["name"] for p in out] == ["1aaa.C", "1abc.A", "2xyz.A"]


def test_empty_seqres_aligns_to_the_first_chain(apo_set, tmp_path):
    """An empty seqres cell is None in the port (the suite aligns to
    path1's sequence, as with no seqres column); pandas reads it as NaN,
    on which JAX's suite fails."""
    root, pairs_csv, structures, samples = apo_set
    with open(pairs_csv, newline="") as f:
        rows = list(csv.DictReader(f))
    rows[0]["seqres"] = ""
    path = tmp_path / "pairs.csv"
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["name", "holo", "seqres"])
        w.writeheader()
        w.writerows(rows)
    pairs = analysis.load_pairs_csv(path, structures)
    blank = [p for p in pairs if p["seqres"] is None]
    assert len(blank) == 1
    full = analysis.apo_analyze(samples, analysis.load_pairs_csv(
        pairs_csv, structures), device=CPU)
    assert analysis.apo_analyze(samples, pairs, device=CPU) == full
    with pytest.raises(TypeError):
        janalysis.apo_analyze(samples, janalysis.load_pairs_csv(
            path, structures))


# -- the CLI -----------------------------------------------------------------

def _cli_outputs(out_dir: Path) -> dict:
    got = {}
    for f in sorted(out_dir.iterdir()):
        got[f.name] = (json.loads(f.read_text()) if f.suffix == ".json"
                       else _csv_rows(f))
    return got


@pytest.mark.parametrize("task", ["bpti", "apo", "ped"])
def test_cli_matches_jax(task, ensembles, apo_set, tmp_path, capsys,
                         jax_float64):
    """Each subcommand with --device cpu against esmdiff_tpu.cli.analyze on
    the same files: every output file's values and the printed JSON."""
    _, pairs_csv, structures, samples = apo_set
    ped_dir = tmp_path / "ped_targets"
    ped_dir.mkdir()
    for p in PED:
        shutil.copy(p, ped_dir / p.name)
    args = {
        "bpti": ["bpti", "--preds", str(ensembles / "close.pdb"),
                 str(ensembles / "far.pdb"), "--target",
                 str(ensembles / "target.pdb"), "--clusters",
                 str(ensembles / "clusters"), "--lagtime", "3"],
        "apo": ["apo", "--samples", str(samples), "--pairs-csv",
                str(pairs_csv), "--structures", str(structures)],
        "ped": ["ped", "--preds", str(ensembles / "close.pdb"),
                str(ensembles / "far.pdb"), "--targets", str(ped_dir)],
    }[task]
    capsys.readouterr()
    analyze_cli.main([*args, "--output", str(tmp_path / "port"),
                      "--device", "cpu"])
    port_out = capsys.readouterr().out
    janalyze_cli.main([*args, "--output", str(tmp_path / "jax")])
    jax_out = capsys.readouterr().out
    port, ref = _cli_outputs(tmp_path / "port"), _cli_outputs(tmp_path / "jax")
    assert list(port) == list(ref) and port
    for name in ref:
        if name.endswith(".csv"):
            header = ref[name][0]
            assert port[name][0] == header
            for a, b in zip(port[name][1:], ref[name][1:]):
                _close(dict(zip(header, a)), dict(zip(header, b)))
        else:
            _close(port[name], ref[name])
    decoder = json.JSONDecoder()

    def printed(text):
        objs, i = [], 0
        while i < len(text):
            if text[i] == "{" and (i == 0 or text[i - 1] == "\n"):
                obj, i = decoder.raw_decode(text, i)
                objs.append(obj)
            else:
                i += 1
        return objs

    assert printed(jax_out)
    _close(printed(port_out), printed(jax_out))


def test_cli_prediction_stems(tmp_path):
    """Two predictions of one stem are told apart by their parents."""
    assert analyze_cli._pred_dict(["a/x.pdb", "b/x.pdb", "y.pdb"]) == \
        {"x": "a/x.pdb", "b/x": "b/x.pdb", "y": "y.pdb"}
