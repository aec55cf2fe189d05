"""esmdiff-torch-analyze: the bpti, apo (or CoDNaS) and ped benchmark
suites (port of ``esmdiff_tpu/cli/analyze.py``: the same subcommands,
flags, outputs and naming of prediction stems), plus ``--device``
(default ``cuda``; without a card it raises unless ``--device cpu`` is
given):

  esmdiff-torch-analyze bpti --preds out1.pdb out2.pdb --target traj.npy \\
      --clusters data/clusters --output out/
  esmdiff-torch-analyze apo --samples out/apo --pairs-csv splits/apo.csv \\
      --structures structures/ --output out/
  esmdiff-torch-analyze ped --preds out/ped1.pdb --targets ped_dir/ \\
      --output out/

``--plot`` draws with matplotlib, which must be installed.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from esmdiff_tpu_torch.device import resolve_device


def _pred_dict(paths) -> dict:
    """{stem: path}; a repeated stem is qualified by its parent directory."""
    d = {}
    for x in paths:
        key = Path(x).stem
        if key in d:
            key = f"{Path(x).parent.name}/{key}"
        d[key] = x
    return d


def main(argv=None):
    p = argparse.ArgumentParser(description="Ensemble benchmark analysis.")
    sub = p.add_subparsers(dest="task", required=True)

    b = sub.add_parser("bpti", help="JS suite + kinetic-cluster TM/RMSD")
    b.add_argument("--preds", nargs="+", required=True,
                   help="Prediction ensemble PDBs (multi-MODEL).")
    b.add_argument("--target", required=True,
                   help="Reference trajectory/ensemble (pdb/npy/dir).")
    b.add_argument("--clusters", default=None,
                   help="Directory of kinetic-cluster PDBs (optional).")
    b.add_argument("--lagtime", type=int, default=500)
    b.add_argument("--output", default="output/analysis_bpti")
    b.add_argument("--plot", action="store_true")

    a = sub.add_parser("apo", help="apo/holo pair benchmark")
    a.add_argument("--samples", required=True,
                   help="Dir of per-target multi-MODEL sample PDBs.")
    a.add_argument("--pairs-csv", required=True)
    a.add_argument("--structures", required=True)
    a.add_argument("--holo-col", default="holo",
                   help="'holo' for apo task, 'other' for codnas.")
    a.add_argument("--output", default="output/analysis_apo")
    a.add_argument("--plot", action="store_true")

    d = sub.add_parser("ped", help="IDP ensemble MAE metrics")
    d.add_argument("--preds", nargs="+", required=True)
    d.add_argument("--targets", required=True,
                   help="Dir of PED target ensemble PDBs.")
    d.add_argument("--output", default="output/analysis_ped")

    for sp in (b, a, d):
        sp.add_argument("--device", default="cuda",
                        help="torch device of the ensemble geometry; 'cpu' "
                             "runs it on the host")

    args = p.parse_args(argv)
    device = resolve_device(args.device)
    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)

    from esmdiff_tpu_torch.eval import analysis

    if args.task == "bpti":
        preds = _pred_dict(args.preds)
        results = analysis.bpti_evaluation(
            preds, args.target, output_dir=out_dir, lagtime=args.lagtime,
            save_plot=args.plot, device=device)
        print(json.dumps(results, indent=2, default=float))
        if args.clusters:
            cl = analysis.bpti_rmsd_clusters(preds, args.clusters,
                                             output_dir=out_dir)
            print(json.dumps(cl, indent=2, default=float))
    elif args.task == "apo":
        pairs = analysis.load_pairs_csv(args.pairs_csv, args.structures,
                                        holo_col=args.holo_col)
        summary = analysis.apo_analyze(args.samples, pairs,
                                       output_dir=out_dir,
                                       save_plot=args.plot, device=device)
        print(json.dumps(
            {k: v for k, v in summary.items() if k != "per_target"},
            indent=2, default=float))
    else:
        preds = _pred_dict(args.preds)
        targets = sorted(Path(args.targets).glob("*.pdb"))
        results = analysis.ped_evaluation(preds, targets, device=device)
        (out_dir / "ped_metrics.json").write_text(
            json.dumps(results, indent=2))
        print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
