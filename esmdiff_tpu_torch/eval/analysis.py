"""Benchmark analysis suites: BPTI, apo/holo and CoDNaS pairs, PED IDPs
(port of ``esmdiff_tpu/eval/analysis.py``, with the same JSON and CSV
outputs).

The ensemble geometry (the JS suite, TICA, validity, the IDP metrics, the
apo suite's masked Kabsch fit of every sample pair) runs in torch, float64,
on ``device`` (``cuda`` unless the caller asks for the CPU); the TM-score
search (C++), the sequence alignment and scipy's correlations run on the
host.
"""

from __future__ import annotations

import csv
import json
from pathlib import Path

import numpy as np
import torch

from esmdiff_tpu_torch.core import protein as protein_io
from esmdiff_tpu_torch.core import residue_constants as rc
from esmdiff_tpu_torch.core.protein import load_ca_ensemble
from esmdiff_tpu_torch.device import resolve_device

from . import metrics
from .align import map_to_reference, nan_pair_deviation, pair_deviations
from .tmscore import tm_diversity, tm_score, tm_score_many


# ---------------------------------------------------------------------------
# BPTI
# ---------------------------------------------------------------------------

def bpti_evaluation(preds: dict[str, str | Path], target: str | Path,
                    output_dir: str | Path | None = None,
                    lagtime: int = 500, save_plot: bool = False,
                    device=None) -> dict:
    """JS suite (pairwise distances, TICA, Rg) and validity of each
    prediction ensemble (its first 100 models) against the reference
    trajectory; ``js_metrics.csv`` in ``output_dir``."""
    device = resolve_device(device)
    d_coords = {}
    for name, path in preds.items():
        arr = load_ca_ensemble(path)
        d_coords[name] = arr[:100] if len(arr) > 100 else arr
    d_coords["target"] = load_ca_ensemble(target)
    d_coords = metrics.on_device(d_coords, device)

    js_t, d_tica = metrics.js_tica(d_coords, ref_key="target",
                                   lagtime=lagtime, return_tic=True,
                                   device=device)
    js_p = metrics.js_pwd(d_coords, ref_key="target", device=device)
    js_r = metrics.js_rg(d_coords, ref_key="target", device=device)
    val_clash = metrics.validity(d_coords, device=device)
    val_bond = metrics.bonding_validity(d_coords, device=device)

    names = list(preds)
    results = {
        "name": names,
        "js_pwd": [js_p[k] for k in names],
        "js_tica": [js_t[k] for k in names],
        "js_rg": [js_r[k] for k in names],
        "val_clash": [val_clash[k] for k in names],
        "val_bond": [val_bond[k] for k in names],
    }
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        with open(output_dir / "js_metrics.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(results.keys())
            w.writerows(zip(*results.values()))
        if save_plot:
            from .plots import scatterplot_2d

            scatterplot_2d(d_tica, output_dir / "tica2d_all.png")
    return results


def bpti_rmsd_clusters(preds: dict[str, str | Path],
                       clusters_dir: str | Path,
                       output_dir: str | Path | None = None) -> dict:
    """Best TM and best RMSD against each kinetic cluster, and TM
    diversity (host C++); ``bpti_tm_rmsd_div.json`` in ``output_dir``."""
    cluster_files = sorted(Path(clusters_dir).glob("*.pdb"))
    out = {}
    for name, path in preds.items():
        ens = load_ca_ensemble(path, max_n_model=100)
        best_tms, best_rmsds = [], []
        for cf in cluster_files:
            target = load_ca_ensemble(cf)[0]
            L = min(ens.shape[1], target.shape[0])
            tms, rmsds = tm_score_many(ens[:, :L], target[:L])
            best_tms.append(float(tms.max()))
            best_rmsds.append(float(rmsds.min()))
        out[name] = {
            "TM-ens": float(np.mean(best_tms)),
            "RMSD-ens": float(np.mean(best_rmsds)),
            "TM-div": tm_diversity(ens),
            "per_cluster_tm": best_tms,
            "per_cluster_rmsd": best_rmsds,
        }
    if output_dir is not None:
        Path(output_dir).mkdir(parents=True, exist_ok=True)
        (Path(output_dir) / "bpti_tm_rmsd_div.json").write_text(
            json.dumps(out, indent=2))
    return out


# ---------------------------------------------------------------------------
# apo/holo & CoDNaS
# ---------------------------------------------------------------------------

def _ca_with_nan(prot) -> np.ndarray:
    ca_i = rc.atom_order["CA"]
    ca = prot.atom_positions[:, ca_i].astype(np.float64).copy()
    ca[prot.atom_mask[:, ca_i] < 0.5] = np.nan
    return ca


def _load_chain_with_seq(path, model: int = 0):
    """(CA coordinates with NaN where unresolved, one-letter sequence)."""
    got = protein_io.from_pdb_file(path)
    prot = got[model] if isinstance(got, list) else got
    return _ca_with_nan(prot), prot.sequence


def _tm_many(ens, target):
    """TM-score of each model against the target on their finite
    intersection."""
    ok_t = np.isfinite(target).all(-1)
    tms = []
    for e in ens:
        m = ok_t & np.isfinite(e).all(-1)
        tms.append(tm_score(e[m], target[m])[0])
    return np.asarray(tms)


def apo_analyze(samples_dir: str | Path, pairs: list[dict],
                output_dir: str | Path | None = None,
                save_plot: bool = False, device=None) -> dict:
    """apo/holo (or CoDNaS) conformation-pair benchmark.

    pairs: [{"name": sample/target stem, "path1": apo PDB, "path2": holo
    PDB, "seqres": reference sequence (optional: path1's parsed sequence
    otherwise)}]; ``samples_dir`` holds ``<name>.pdb`` multi-MODEL sample
    files.  Every chain is aligned to the reference sequence and its CAs
    scattered into a NaN-masked reference-length frame.  TM-ens,
    TM-diversity against TM-pair, and RMSD-against-RMSF correlations, where
    the RMSF comes from the masked Kabsch fit of every sample pair, all
    pairs at once on the device; ``apo_metrics.json`` in ``output_dir``."""
    from scipy.stats import kendalltau, pearsonr, spearmanr

    device = resolve_device(device)
    samples_dir = Path(samples_dir)
    rows = []
    rmsd_dict, rmsf_dict = {}, {}
    for pair in pairs:
        name = pair["name"]
        sample_path = samples_dir / f"{name}.pdb"
        if not sample_path.exists():
            print(f"[apo] missing samples for {name}, skip")
            continue
        ca1_raw, seq1 = _load_chain_with_seq(pair["path1"])
        ca2_raw, seq2 = _load_chain_with_seq(pair["path2"])
        seqres = pair.get("seqres") or seq1
        struct1 = map_to_reference(seqres, seq1, ca1_raw)
        struct2 = map_to_reference(seqres, seq2, ca2_raw)
        gaps1 = int(np.isnan(struct1[:, 0]).sum())
        gaps2 = int(np.isnan(struct2[:, 0]).sum())
        if gaps1 or gaps2:
            print(f"[apo] {name}: {gaps1}/{gaps2} gap positions "
                  f"(of {len(seqres)}) NaN-masked in pair structures")
        rmsd_dict[name] = nan_pair_deviation(
            torch.from_numpy(struct1).to(device),
            torch.from_numpy(struct2).to(device)).cpu().numpy()

        got = protein_io.from_pdb_file(sample_path)
        models = got if isinstance(got, list) else [got]
        ens = np.stack([map_to_reference(seqres, m.sequence, _ca_with_nan(m))
                        for m in models])
        # per-residue fluctuation over every sample pair
        devs = pair_deviations(torch.from_numpy(ens).to(device))
        rmsf_dict[name] = (torch.sqrt(torch.nanmean(devs ** 2, dim=0))
                           .cpu().numpy() if len(devs)
                           else np.zeros(len(seqres)))

        tm1 = _tm_many(ens, struct1)
        tm2 = _tm_many(ens, struct2)
        m12 = np.isfinite(struct1).all(-1) & np.isfinite(struct2).all(-1)
        tm_fwd, _ = tm_score(struct1[m12], struct2[m12])
        tm_bwd, _ = tm_score(struct2[m12], struct1[m12])
        ok_all = np.isfinite(ens).all(axis=(0, 2))
        rows.append({
            "name": name,
            "tm1max": float(tm1.max()),
            "tm2max": float(tm2.max()),
            "tm_ens": float((tm1.max() + tm2.max()) / 2),
            "tm_pair": float((tm_fwd + tm_bwd) / 2),
            "tm_div": tm_diversity(np.ascontiguousarray(ens[:, ok_all])),
            "gaps": [gaps1, gaps2],
        })

    if not rows:
        return {"error": "no targets evaluated"}

    tm_ens = np.array([r["tm_ens"] for r in rows])
    tm_pair = np.array([r["tm_pair"] for r in rows])
    tm_div = np.array([r["tm_div"] for r in rows])

    per_target = {}
    for name in rmsd_dict:
        m = ~np.isnan(rmsd_dict[name]) & ~np.isnan(rmsf_dict[name])
        if m.sum() < 3 or np.std(rmsf_dict[name][m]) < 1e-9:
            continue
        per_target[name] = {
            "pearson": pearsonr(rmsd_dict[name][m], rmsf_dict[name][m])[0],
            "spearman": spearmanr(rmsd_dict[name][m],
                                  rmsf_dict[name][m]).correlation,
            "kendall": kendalltau(rmsd_dict[name][m],
                                  rmsf_dict[name][m]).correlation,
        }
    g_rmsd = np.concatenate(list(rmsd_dict.values()))
    g_rmsf = np.concatenate(list(rmsf_dict.values()))
    m = ~np.isnan(g_rmsd) & ~np.isnan(g_rmsf)

    pearsons = [v["pearson"] for v in per_target.values()]
    summary = {
        "tm_correlation": (
            float(pearsonr(tm_div, tm_pair)[0]) if len(rows) > 2 else None),
        "tm_ens_mean": float(np.mean(tm_ens)),
        "tm_ens_median": float(np.median(tm_ens)),
        "rmsd_global_correlation": (
            float(pearsonr(g_rmsd[m], g_rmsf[m])[0]) if m.sum() > 2 else None),
        "rmsd_per_target_pearson_mean": (
            float(np.mean(pearsons)) if pearsons else None),
        "rmsd_per_target_pearson_median": (
            float(np.median(pearsons)) if pearsons else None),
        "per_target": rows,
    }
    if output_dir is not None:
        Path(output_dir).mkdir(parents=True, exist_ok=True)
        (Path(output_dir) / "apo_metrics.json").write_text(
            json.dumps(summary, indent=2, default=float))
        if save_plot:
            from .plots import scatterplot_apo

            scatterplot_apo(tm_pair, tm_ens,
                            Path(output_dir) / "ens_scatter.png")
            scatterplot_apo(tm_pair, tm_div,
                            Path(output_dir) / "var_scatter.png",
                            ylabel="TM diversity", regplot=True)
    return summary


def load_pairs_csv(csv_path: str | Path, structures_dir: str | Path,
                   holo_col: str = "holo") -> list[dict]:
    """The splits CSV ('name', 'holo' or 'other', 'seqres' columns;
    structures under ``<dir>/<name[:2]>/<name>``), rows sorted by name, read
    with the ``csv`` module.  ``holo_col`` falls back to 'other' when the
    file has no such column; an empty or missing seqres is None."""
    with open(csv_path, newline="") as f:
        reader = csv.DictReader(f)
        table = list(reader)
    col = holo_col if holo_col in (reader.fieldnames or ()) else "other"
    structures_dir = Path(structures_dir)
    pairs = []
    for row in sorted(table, key=lambda r: r["name"]):
        name, other = row["name"], row[col]
        pairs.append({
            "name": Path(name).stem,
            "path1": structures_dir / name[:2] / name,
            "path2": structures_dir / other[:2] / other,
            "seqres": row.get("seqres") or None,
        })
    return pairs


# ---------------------------------------------------------------------------
# PED / IDP
# ---------------------------------------------------------------------------

def ped_evaluation(preds: dict[str, str | Path],
                   target_ensembles: list[str | Path], device=None) -> dict:
    """IDP MAE/MSE metrics against the concatenation of the PED target
    ensembles; targets and predictions are truncated to the shortest chain
    before they are concatenated."""
    targets = [load_ca_ensemble(t) for t in target_ensembles]
    pred_arrs = {name: load_ca_ensemble(path)
                 for name, path in preds.items()}
    L = min(min(t.shape[1] for t in targets),
            min(v.shape[1] for v in pred_arrs.values()))
    d_coords = {
        "target": np.concatenate([t[:, :L] for t in targets], axis=0)
    }
    d_coords.update({k: v[:, :L] for k, v in pred_arrs.items()})
    (mse_pwd, mse_rg, mse_contact,
     mae_pwd, mae_rg, mae_contact) = metrics.idp_metrics(d_coords,
                                                         device=device)
    names = list(preds)
    return {
        "name": names,
        "mae_pwd": [float(mae_pwd[k]) for k in names],
        "mae_rg": [float(mae_rg[k]) for k in names],
        "mae_contact": [float(mae_contact[k]) for k in names],
        "mse_pwd": [float(mse_pwd[k]) for k in names],
        "mse_rg": [float(mse_rg[k]) for k in names],
        "mse_contact": [float(mse_contact[k]) for k in names],
    }
