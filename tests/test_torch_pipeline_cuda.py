"""The data pipeline and the AR trainer on the card against the same code
on the CPU: the Kabsch-Sander assigner (float64; the H-bond energies
within 1e-9, the bonds and 3-state strings equal) on twenty chains of
data/targets, and one CLM training step (float32 compute: loss, grad
norm and the updated parameters within 1e-4 relative).

Needs a CUDA card; skips without one.  Imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_pipeline_cuda.py -q
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.core import protein as protein_io
from esmdiff_tpu_torch.core import secondary_structure as ss
from esmdiff_tpu_torch.train import config as tconfig
from esmdiff_tpu_torch.train import loop as tloop
from esmdiff_tpu_torch.train import state as tstate

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; runs via chip_smoke.py")


def _chains():
    files = sorted((ROOT / "data" / "targets").glob("*/*.pdb"))[::14][:20]
    out = []
    for f in files:
        prot = protein_io.from_pdb_file(f)
        out.append(prot[0] if isinstance(prot, list) else prot)
    return out


def test_dssp_card_vs_cpu(card):
    chains = _chains()
    assert ss.assign_secondary_structure_batch(chains, "cuda") == \
        ss.assign_secondary_structure_batch(chains, "cpu")
    for prot in chains[:5]:
        card_e = ss.hbond_energy(prot, "cuda")
        cpu_e = ss.hbond_energy(prot, "cpu")
        finite = np.isfinite(cpu_e)
        np.testing.assert_array_equal(np.isfinite(card_e), finite)
        np.testing.assert_allclose(card_e[finite], cpu_e[finite], rtol=0,
                                   atol=1e-9)
        np.testing.assert_array_equal(ss.hbond_matrix(prot, "cuda"),
                                      ss.hbond_matrix(prot, "cpu"))


def test_clm_step_card_vs_cpu(card):
    """One AdamW step of a small float32 CLM on the same batch and init
    (the CPU's seeded init carried to the card).  An element whose CPU
    gradient is at rounding level (within 1e-5 of its leaf's largest) is
    held to 2 x lr: Adam's first step moves every element by about lr
    whatever its gradient's size."""
    rng = np.random.RandomState(0)
    B, L, D = 4, 40, 48
    batch = {"embeddings": rng.randn(B, L, D).astype(np.float32),
             "structure_tokens": rng.randint(0, 4096, (B, L)),
             "mask": np.ones((B, L), np.float32)}
    batch["structure_tokens"][:, 0] = C.STRUCTURE_BOS_TOKEN
    batch["mask"][1, 30:] = 0.0
    cfg = tconfig.load_config(None, [
        "task_name=clm", "model.clm.d_model=64", "model.clm.d_ff=128",
        "model.clm.n_layers=2", "model.clm.n_heads=4",
        "model.clm.dtype=float32", "optim.lr=1e-3"])
    init = None
    out = {}
    for dev in ("cpu", "cuda"):
        model, loss_fn = tloop.build_task(cfg, dev, emb_dim=D)
        if init is None:
            tloop.init_task(model, cfg)
            init = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(init)
        state = tstate.create_train_state(
            model, tstate.make_optimizer(model.parameters(), lr=1e-3))
        m = tstate.train_step(state, loss_fn, tloop.to_device(batch, dev),
                              None)
        out[dev] = ({k: v.item() for k, v in m.items()},
                    {k: v.cpu() for k, v in model.state_dict().items()},
                    {k: p.grad.cpu() for k, p in model.named_parameters()})
    for k, v in out["cpu"][0].items():
        assert out["cuda"][0][k] == pytest.approx(v, rel=1e-4), k
    for k, v in out["cpu"][1].items():
        g = out["cpu"][2][k]
        noise = g.abs() <= 1e-5 * g.abs().max()
        torch.testing.assert_close(out["cuda"][1][k][~noise], v[~noise],
                                   rtol=1e-4, atol=1e-5)
        assert ((out["cuda"][1][k] - v)[noise].abs() <= 2e-3).all(), k
