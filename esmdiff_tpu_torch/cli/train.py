"""Training CLI on the port (MDLM fine-tuning).

Port of ``esmdiff_tpu/cli/train.py``, plus ``--device`` (default ``cuda``;
without a card it raises unless ``--device cpu`` is given):

    esmdiff-torch-train --config configs/mdlm.yaml data.path=... \\
        trainer.max_epochs=5

Under torchrun each rank trains on the card ``LOCAL_RANK`` (gloo ranks on
the CPU with ``--device cpu``) and ``trainer.strategy`` lays the model out
over them:

    torchrun --nproc_per_node 8 -m esmdiff_tpu_torch.cli.train \\
        --config configs/mdlm.yaml trainer.strategy=fsdp data.path=...
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import yaml

from esmdiff_tpu_torch.device import resolve_device
from esmdiff_tpu_torch.parallel.mesh import local_device, rank
from esmdiff_tpu_torch.train.config import load_config
from esmdiff_tpu_torch.train.loop import train


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Fine-tune ESMDiff (MDLM) with the PyTorch port.")
    p.add_argument("--config", type=str, default=None,
                   help="Experiment yaml (e.g. configs/mdlm.yaml).")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions.")
    p.add_argument("overrides", nargs="*",
                   help="Dotted overrides, e.g. optim.lr=1e-4")
    args = p.parse_args(argv)

    device = resolve_device(local_device(args.device))
    cfg = load_config(args.config, args.overrides)
    if cfg.trainer.print_config and rank() == 0:
        print("── config ──────────────────────────────")
        print(yaml.safe_dump(dataclasses.asdict(cfg), sort_keys=False), end="")
        print("────────────────────────────────────────")
    result = train(cfg, device=device)
    if rank() == 0:
        print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
