"""The port's VQ-VAE structure encoder against the JAX package, in fp32 on
carried-over weights: the k-nearest graph (indices equal, also on planted
equal distances and invalid residues), the nearest code (exact, also on a
planted tie), the encoder on BPTI (tokens and ``valid`` equal, z to 1e-5
relative L2 and z_q equal, with and without a masked residue), rigid
invariance, and the strict carry-over of the encoder's flax tree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esmdiff_tpu.core import constants as JC
from esmdiff_tpu.models import vqvae as jvq
from esmdiff_tpu_torch.api.protein_api import ESMProtein
from esmdiff_tpu_torch.convert import flax_to_state_dict, load_flax_params
from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.models import vqvae as tvq
from test_torch_support import carry, perturb, to_np

torch.set_num_threads(2)

BPTI_PDB = "data/targets/bpti/bpti.pdb"
TINY = dict(d_model=64, n_heads=2, v_heads=8, n_layers=2, d_out=16, knn=8)


def _bpti_backbone():
    return ESMProtein.from_pdb(BPTI_PDB).backbone().astype(np.float32)


def _knn_both(ca, valid, k):
    ref_idx, ref_ok = jvq.knn_graph(jnp.asarray(ca), jnp.asarray(valid), k)
    idx, ok = tvq.knn_graph(torch.from_numpy(ca), torch.from_numpy(valid), k)
    np.testing.assert_array_equal(to_np(idx), np.asarray(ref_idx))
    np.testing.assert_array_equal(to_np(ok), np.asarray(ref_ok))
    return to_np(idx), to_np(ok)


def test_knn_graph_matches_jax_on_bpti():
    ca = _bpti_backbone()[None, :, 1]
    idx, ok = _knn_both(ca, np.ones(ca.shape[:2], bool), 16)
    np.testing.assert_array_equal(idx[0, :, 0], np.arange(ca.shape[1]))
    assert ok.all()


def test_knn_graph_breaks_ties_toward_the_lower_index():
    """CAs on an integer lattice: many neighbours lie at equal distances,
    and their order is JAX's (lower index first)."""
    grid = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"),
                    axis=-1).reshape(1, 27, 3).astype(np.float32) * 3.8
    perm = np.random.default_rng(0).permutation(27)
    idx, _ = _knn_both(grid[:, perm], np.ones((1, 27), bool), 16)
    d = np.linalg.norm(grid[0, perm][:, None] - grid[0, perm][None], axis=-1)
    assert (np.diff(d[0, idx[0, 0, 1:]]) == 0).any()  # ties were planted


def test_knn_graph_invalid_residues():
    ca = np.random.default_rng(1).standard_normal((2, 12, 3)).astype(
        np.float32) * 10
    valid = np.ones((2, 12), bool)
    valid[0, [3, 7]] = False
    valid[1, 5:] = False                 # fewer valid residues than k
    idx, ok = _knn_both(ca, valid, 8)
    # invalid neighbours map to self
    self_idx = np.broadcast_to(np.arange(12)[None, :, None], idx.shape)
    np.testing.assert_array_equal(idx[~ok], self_idx[~ok])
    # an invalid residue is no valid neighbour of another residue
    others = [i for i in range(12) if valid[0, i]]
    assert not np.isin(idx[0, others][ok[0, others]], [3, 7]).any()


def test_nearest_code_matches_jax_and_ties_take_the_first():
    rng = np.random.default_rng(2)
    cb = rng.standard_normal((64, 16)).astype(np.float32)
    cb[40] = cb[9]                       # a planted tie: codes 9 and 40
    z = np.concatenate([cb[[9, 3, 63]],
                        rng.standard_normal((20, 16)).astype(np.float32)])
    ref = np.asarray(jvq.nearest_code(jnp.asarray(z), jnp.asarray(cb)))
    got = to_np(tvq.nearest_code(torch.from_numpy(z), torch.from_numpy(cb)))
    np.testing.assert_array_equal(got, ref)
    assert list(got[:3]) == [9, 3, 63]


def _encoders(seed=0):
    bb = _bpti_backbone()[None]
    jm = jvq.StructureTokenEncoder(jvq.EncoderConfig(**TINY))
    params = perturb(jm.init(jax.random.PRNGKey(seed), jnp.asarray(bb))
                     ["params"], seed=seed)
    tm = carry(tvq.StructureTokenEncoder(tvq.EncoderConfig(**TINY)), params)
    return jm, params, tm


@pytest.mark.parametrize("masked", [False, True])
def test_encoder_matches_flax_on_bpti(masked):
    jm, params, tm = _encoders()
    bb = _bpti_backbone()
    if masked:
        bb[5] = np.nan
        bb[20, 1, 0] = np.inf
    ref = jm.apply({"params": params}, jnp.asarray(bb)[None], return_zq=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(bb)[None], return_zq=True)
    tokens, z, valid, z_q = (to_np(t) for t in got)
    np.testing.assert_array_equal(tokens, np.asarray(ref[0]))
    np.testing.assert_array_equal(valid, np.asarray(ref[2]))
    # z to 1e-5 in relative L2: on BPTI's raw coordinates (|CA| up to 20 A)
    # the distance term's Gram expansion cancels in fp32, and single
    # elements of z (|z| up to ~5) land up to 4e-5 apart in the two
    # summation orders; z_q is the same codebook rows
    rel = np.linalg.norm(z - np.asarray(ref[1])) / np.linalg.norm(ref[1])
    assert rel <= 1e-5, rel
    np.testing.assert_allclose(z, np.asarray(ref[1]), atol=1e-4)
    np.testing.assert_array_equal(z_q, np.asarray(ref[3]))
    assert C.STRUCTURE_MASK_TOKEN == JC.STRUCTURE_MASK_TOKEN
    if masked:
        assert (tokens[0, [5, 20]] == C.STRUCTURE_MASK_TOKEN).all()
        assert not valid[0, [5, 20]].any()
    else:
        assert valid.all() and (tokens < 4096).all()


def test_encoder_is_rigid_invariant():
    _, _, tm = _encoders(seed=1)
    bb = _bpti_backbone()
    q, _ = np.linalg.qr(np.random.default_rng(1).standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    bb2 = (bb @ q.T + np.asarray([5.0, -3.0, 11.0])).astype(np.float32)
    with torch.no_grad():
        t1, z1, _ = tm(torch.from_numpy(bb)[None])
        t2, z2, _ = tm(torch.from_numpy(bb2)[None])
    assert (t1 == t2).float().mean().item() > 0.95
    np.testing.assert_allclose(to_np(z2), to_np(z1), atol=1e-3)


def test_encoder_carry_over_is_strict():
    """The encoder's flax tree (relative_position_embed, transformer/block0
    and block1, the stack's norm, pre_vq_proj, codebook) maps onto the
    port's state dict key for key; a missing or extra leaf raises."""
    _, params, _ = _encoders()
    tree = jax.device_get(params)
    assert set(tree) == {"relative_position_embed", "transformer",
                         "pre_vq_proj", "codebook"}
    assert {"block0", "block1", "norm"} <= set(tree["transformer"])
    tm = tvq.StructureTokenEncoder(tvq.EncoderConfig(**TINY))
    assert set(flax_to_state_dict(tree)) == set(tm.state_dict())
    assert tm.transformer.blocks[0].geom_attn is not None
    assert tm.transformer.blocks[1].geom_attn is None
    short = {k: v for k, v in tree.items() if k != "codebook"}
    with pytest.raises(KeyError, match="codebook"):
        load_flax_params(tm, short)
    with pytest.raises(KeyError, match="unexpected"):
        load_flax_params(tm, {**tree, "extra": np.zeros(3, np.float32)})


def test_encoder_config_takes_the_plain_attention():
    cfg = tvq.EncoderConfig()
    assert cfg.stack_config().attn_backend == "xla"
    assert (cfg.d_model, cfg.n_heads, cfg.v_heads, cfg.n_layers, cfg.d_out,
            cfg.n_codes, cfg.knn, cfg.dtype) == (1024, 1, 128, 2, 128, 4096,
                                                 16, "float32")
