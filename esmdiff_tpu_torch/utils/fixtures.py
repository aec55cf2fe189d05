"""In-repo benchmark fixture paths.

Port of ``esmdiff_tpu/utils/fixtures.py``.  The benchmark target
structures (bpti / apo / codnas / ped, the reference's data/targets/) are
staged in the repo at ``data/targets/``; ``ESMDIFF_TARGETS`` overrides the
root for custom corpora.  Unlike JAX's, there is no path outside the repo
to fall back on: with neither it raises.
"""

from __future__ import annotations

import os
from pathlib import Path

_REPO_ROOT = Path(__file__).resolve().parents[2]
ENV = "ESMDIFF_TARGETS"


def targets_root() -> Path:
    """Directory holding the benchmark target families
    (bpti/apo/codnas/ped): ``$ESMDIFF_TARGETS``, else the repo's
    ``data/targets``.  Raises FileNotFoundError when there is neither."""
    env = os.environ.get(ENV)
    if env:
        return Path(env)
    staged = _REPO_ROOT / "data" / "targets"
    if staged.is_dir():
        return staged
    raise FileNotFoundError(f"no benchmark targets: {staged} is missing "
                            f"and {ENV} is not set")


def bpti_pdb() -> Path:
    """The canonical BPTI target (the reference's README.md:64
    workload)."""
    return targets_root() / "bpti" / "bpti.pdb"
