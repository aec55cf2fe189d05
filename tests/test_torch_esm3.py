"""Port trunk and VQ decoder against the JAX package on carried-over
weights, fp32, at atol 1e-4 (48 and 30 layers at full width; here 4 and 2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esmdiff_tpu.core import constants as C
from esmdiff_tpu.models import esm3 as jesm3
from esmdiff_tpu.models import vqvae as jvq
from esmdiff_tpu_torch.models import esm3 as tesm3
from esmdiff_tpu_torch.models import vqvae as tvq
from test_torch_support import carry, perturb, to_np

torch.set_num_threads(2)

ATOL = 1e-4


def _tokens(B, L, lengths, seed=0):
    """BOS + residues + EOS + PAD rows, half the structure track masked."""
    rng = np.random.default_rng(seed)
    seq = np.full((B, L), C.SEQUENCE_PAD_TOKEN, np.int32)
    st = np.full((B, L), C.STRUCTURE_PAD_TOKEN, np.int32)
    for b, n in enumerate(lengths):
        seq[b, 0], seq[b, n - 1] = C.SEQUENCE_BOS_TOKEN, C.SEQUENCE_EOS_TOKEN
        seq[b, 1:n - 1] = rng.integers(4, 24, n - 2)
        st[b, :n] = np.where(rng.random(n) < 0.5, C.STRUCTURE_MASK_TOKEN,
                             rng.integers(0, C.VQVAE_CODEBOOK_SIZE, n))
    return seq, st


def test_trunk_structure_logits():
    B, L, lengths = 2, 32, [32, 21]
    cfg = jesm3.esm3_tiny(dtype="float32", head_type="structure")
    seq, st = _tokens(B, L, lengths)
    aux = np.random.default_rng(1).standard_normal(
        (B, L, cfg.d_model)).astype(np.float32)
    jm = jesm3.ESM3(cfg)
    # dummy coordinates create block 0's geometric-attention params, as
    # ESM3Runtime.random_init does
    params = perturb(jm.init(
        jax.random.PRNGKey(0), sequence_tokens=jnp.asarray(seq),
        structure_coords=jnp.zeros((B, L, 3, 3)))["params"], scale=0.05)
    ref = jm.apply({"params": params}, structure_tokens=jnp.asarray(st),
                   sequence_tokens=jnp.asarray(seq),
                   lengths=jnp.asarray(lengths, jnp.int32),
                   auxiliary_embeddings=jnp.asarray(aux))
    tm = carry(tesm3.ESM3(tesm3.esm3_tiny(dtype="float32",
                                          head_type="structure")), params)
    assert tm.transformer.blocks[0].geom_attn is not None
    with torch.no_grad():
        out = tm(structure_tokens=torch.from_numpy(st),
                 sequence_tokens=torch.from_numpy(seq),
                 lengths=torch.tensor(lengths, dtype=torch.int32),
                 auxiliary_embeddings=torch.from_numpy(aux))
    np.testing.assert_allclose(to_np(out.structure_logits),
                               np.asarray(ref.structure_logits), atol=ATOL)
    np.testing.assert_allclose(to_np(out.embeddings),
                               np.asarray(ref.embeddings), atol=ATOL)
    # coordinates reach block 0's geometric attention, as in JAX (the
    # frames of all-zero coordinates are degenerate but finite)
    zeros = np.zeros((B, L, 3, 3), np.float32)
    ref = jm.apply({"params": params}, sequence_tokens=jnp.asarray(seq),
                   structure_coords=jnp.asarray(zeros))
    with torch.no_grad():
        out = tm(sequence_tokens=torch.from_numpy(seq),
                 structure_coords=torch.from_numpy(zeros))
    np.testing.assert_allclose(to_np(out.structure_logits),
                               np.asarray(ref.structure_logits), atol=ATOL)


@pytest.mark.parametrize("with_lengths", [False, True])
def test_decoder(with_lengths):
    B, L = 3, 32
    lengths = [32, 20, 9]
    cfg = jvq.DecoderConfig(d_model=64, n_heads=2, n_layers=2,
                            dtype="float32")  # scanned: exercises unstacking
    toks = np.random.default_rng(2).integers(
        0, C.VQVAE_CODEBOOK_SIZE, (B, L)).astype(np.int32)
    jd = jvq.StructureTokenDecoder(cfg)
    params = perturb(jd.init(jax.random.PRNGKey(0), jnp.asarray(toks))
                     ["params"], scale=0.05)
    lens_j = jnp.asarray(lengths, jnp.int32) if with_lengths else None
    ref = jd.apply({"params": params}, jnp.asarray(toks),
                   compute_ptm=not with_lengths, lengths=lens_j)
    td = carry(tvq.StructureTokenDecoder(tvq.DecoderConfig(
        d_model=64, n_heads=2, n_layers=2, dtype="float32")), params)
    with torch.no_grad():
        out = td(torch.from_numpy(toks), compute_ptm=not with_lengths,
                 lengths=(torch.tensor(lengths, dtype=torch.int32)
                          if with_lengths else None))
    if with_lengths:
        # pad positions differ by design (JAX: pads attend pads; port: pads
        # attend the valid keys) and are stripped by every caller
        for b, n in enumerate(lengths):
            np.testing.assert_allclose(to_np(out["bb_pred"])[b, :n],
                                       np.asarray(ref["bb_pred"])[b, :n],
                                       atol=ATOL)
            np.testing.assert_allclose(to_np(out["plddt"])[b, :n],
                                       np.asarray(ref["plddt"])[b, :n],
                                       atol=ATOL)
        assert "ptm" not in out
    else:
        for key in ("bb_pred", "plddt", "ptm"):
            np.testing.assert_allclose(to_np(out[key]), np.asarray(ref[key]),
                                       atol=ATOL)
