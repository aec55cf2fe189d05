"""Backbone frames, geometric attention and the trunk with coordinates on
the port, against the JAX package on carried-over weights, in fp32:
frames to 1e-6 (with NaN and inf rows), geometric attention to 1e-5 (with
sequence_id, chain_id and frameless rows), trunk logits with
``structure_coords`` to 1e-4 (with and without ``lengths``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esmdiff_tpu.models import esm3 as jesm3
from esmdiff_tpu.nn import geometric as jgeo
from esmdiff_tpu_torch.models import esm3 as tesm3
from esmdiff_tpu_torch.nn import geometric as tgeo
from test_torch_esm3 import _tokens
from test_torch_support import carry, perturb, to_np

torch.set_num_threads(2)


def _backbone(B, L, seed=0):
    """(B, L, 3, 3) N/CA/C of a random walk of CAs (3.8 A steps), N and C
    placed around each CA; row 0 gets a NaN residue and an inf residue."""
    rng = np.random.default_rng(seed)
    steps = rng.standard_normal((B, L, 3))
    ca = np.cumsum(3.8 * steps / np.linalg.norm(steps, axis=-1,
                                                keepdims=True), axis=1)
    n = ca + rng.standard_normal((B, L, 3))
    c = ca + rng.standard_normal((B, L, 3))
    bb = np.stack([n, ca, c], axis=2).astype(np.float32)
    bb[0, 3, 1, 2] = np.nan
    bb[0, 5] = np.inf
    return bb


def test_affine_from_coordinates_matches_jax():
    bb = _backbone(3, 12)
    bb[2] = np.nan                         # a row with no frame at all
    ref, ref_mask = jgeo.build_affine3d_from_coordinates(jnp.asarray(bb))
    got, mask = tgeo.build_affine3d_from_coordinates(torch.from_numpy(bb))
    np.testing.assert_array_equal(to_np(mask), np.asarray(ref_mask))
    assert not to_np(mask)[0, [3, 5]].any() and not to_np(mask)[2].any()
    np.testing.assert_allclose(to_np(got.rot), np.asarray(ref.rot),
                               atol=1e-6)
    np.testing.assert_allclose(to_np(got.trans), np.asarray(ref.trans),
                               atol=1e-6)
    # Affine3D's methods against JAX's on the same frames
    pts = np.random.default_rng(1).standard_normal((3, 12, 3)).astype(
        np.float32)
    jaff = jgeo.Affine3D(rot=ref.rot, trans=ref.trans)
    for name in ("apply", "rotate", "rotate_inv"):
        np.testing.assert_allclose(
            to_np(getattr(got, name)(torch.from_numpy(pts))),
            np.asarray(getattr(jaff, name)(jnp.asarray(pts))), atol=1e-5)
    np.testing.assert_allclose(
        to_np(got.compose_rotation(got.rot).rot),
        np.asarray(jaff.compose_rotation(ref.rot).rot), atol=1e-6)


@pytest.mark.parametrize("ids", ["none", "sequence_id", "chain_id", "both"])
def test_geometric_attention_matches_flax(ids):
    B, L, D, H = 2, 12, 64, 8
    rng = np.random.default_rng(3)
    s = rng.standard_normal((B, L, D)).astype(np.float32)
    affine, mask = jgeo.build_affine3d_from_coordinates(
        jnp.asarray(_backbone(B, L)))
    seq_id = np.array([[0] * 8 + [1] * 4, [0] * 12], np.int32)
    chain = np.array([[0] * 6 + [1] * 6, [0] * 4 + [1] * 8], np.int32)
    kw = {"sequence_id": seq_id if ids in ("sequence_id", "both") else None,
          "chain_id": chain if ids in ("chain_id", "both") else None}
    jm = jgeo.GeometricAttention(d_model=D, v_heads=H, dtype=jnp.float32)
    params = perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(s), affine,
                             mask)["params"], seed=4)
    ref = jm.apply({"params": params}, jnp.asarray(s), affine, mask,
                   *(None if v is None else jnp.asarray(v)
                     for v in kw.values()))
    tm = carry(tgeo.GeometricAttention(D, H, dtype=torch.float32), params)
    taff = tgeo.Affine3D(rot=torch.from_numpy(np.array(affine.rot)),
                         trans=torch.from_numpy(np.array(affine.trans)))
    with torch.no_grad():
        got = tm(torch.from_numpy(s), taff, torch.from_numpy(np.array(mask)),
                 *(None if v is None else torch.from_numpy(v)
                   for v in kw.values()))
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=1e-5)
    # frameless rows are zeroed
    assert (to_np(got)[0, [3, 5]] == 0).all()


@pytest.mark.parametrize("with_lengths", [False, True])
def test_trunk_with_coordinates_matches_flax(with_lengths):
    B, L, lengths = 2, 32, [32, 21]
    cfg = jesm3.esm3_tiny(dtype="float32", head_type="structure")
    seq, st = _tokens(B, L, lengths, seed=5)
    coords = _backbone(B, L, seed=6)
    coords[1, lengths[1]:] = np.nan        # padding has no frame
    jm = jesm3.ESM3(cfg)
    params = perturb(jm.init(
        jax.random.PRNGKey(0), sequence_tokens=jnp.asarray(seq),
        structure_coords=jnp.asarray(coords))["params"], scale=0.05)
    lens = np.asarray(lengths, np.int32) if with_lengths else None
    t_lens = None if lens is None else torch.from_numpy(lens)
    ref = jm.apply({"params": params}, structure_tokens=jnp.asarray(st),
                   sequence_tokens=jnp.asarray(seq),
                   structure_coords=jnp.asarray(coords),
                   lengths=None if lens is None else jnp.asarray(lens))
    tm = carry(tesm3.ESM3(tesm3.esm3_tiny(dtype="float32",
                                          head_type="structure")), params)
    with torch.no_grad():
        out = tm(structure_tokens=torch.from_numpy(st),
                 sequence_tokens=torch.from_numpy(seq),
                 structure_coords=torch.from_numpy(coords), lengths=t_lens)
        no_coords = tm(structure_tokens=torch.from_numpy(st),
                       sequence_tokens=torch.from_numpy(seq), lengths=t_lens)
    np.testing.assert_allclose(to_np(out.structure_logits),
                               np.asarray(ref.structure_logits), atol=1e-4)
    np.testing.assert_allclose(to_np(out.embeddings),
                               np.asarray(ref.embeddings), atol=1e-4)
    # the coordinates reach the output: geometric attention ran
    assert np.abs(to_np(out.embeddings) - to_np(no_coords.embeddings)).max() \
        > 1e-3


def test_block_without_frames_raises():
    tm = tesm3.ESM3(tesm3.esm3_tiny(dtype="float32"))
    x = torch.zeros(1, 4, 64)
    cos, sin = torch.ones(4, 16), torch.zeros(4, 16)
    with pytest.raises(ValueError, match="needs affine"):
        tm.transformer.blocks[0](x, cos, sin)
