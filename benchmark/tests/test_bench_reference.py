"""The plain reference against the port, at the tiny widths, on the CPU.

Both sides take the same seeded published-layout weights
(``benchmark/weights.py``; the port through its own converters) and run in
float32, so they compute the same function in different code: the
tolerances are float32 rounding over a few layers (1e-5 relative on
logits and the loss, 1e-4 on gradients, whose sums run in other orders,
and 1e-4 A on coordinates of ~10 A).
"""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import model as R
from benchmark.reference import train as RT

TINY = {"d_model": 64, "n_heads": 4, "n_layers": 3, "n_layers_geom": 1,
        "v_heads": 8, "ffn_hidden": 256, "n_structure_heads": 4101,
        "sigma_frequency_size": 256, "dtype": "float32"}
TINY_DEC = {"d_model": 64, "n_heads": 4, "n_layers": 2, "ffn_hidden": 256,
            "plddt_bins": 50, "trans_scale": 10.0, "dtype": "float32"}


def port_trunk(head: str, W: dict):
    from esmdiff_tpu_torch.convert import torch_ckpt
    from esmdiff_tpu_torch.models.esm3 import ESM3
    from esmdiff_tpu_torch.models.esm3 import esm3_tiny

    t = dict(TINY, head=head)
    trunk = ESM3(esm3_tiny(n_layers=t["n_layers"], head_type=head,
                           dtype="float32"))
    torch_ckpt.convert_trunk(trunk, {k: v for k, v in W.items()
                                     if not k.startswith("sigma_")})
    return trunk.eval()


def rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("head", ["esm3", "structure"])
def test_trunk_logits(head):
    t = dict(TINY, head=head)
    W = weights.make({**weights.trunk_shapes(t), **weights.sigma_shapes(t)},
                     1, "cpu")
    trunk = port_trunk(head, W)
    gen = torch.Generator().manual_seed(0)
    B, L = 3, 20
    lengths = torch.tensor([20, 13, 7])
    seq = torch.randint(4, 24, (B, L), generator=gen)
    seq[:, 0] = R.SEQ_BOS
    for b, n in enumerate(lengths.tolist()):
        seq[b, n - 1] = R.SEQ_EOS
        seq[b, n:] = R.SEQ_PAD
    st = torch.randint(0, 4097, (B, L), generator=gen)
    aux = torch.randn(B, L, t["d_model"], generator=gen)
    with torch.no_grad():
        got = trunk(structure_tokens=st, sequence_tokens=seq,
                    lengths=lengths.int(),
                    auxiliary_embeddings=aux).structure_logits
        want = R.trunk_logits(W, t, seq, st, R.key_mask(lengths, L),
                              torch.arange(L).expand(B, L), aux)
    for b, n in enumerate(lengths.tolist()):
        assert rel(got[b, :n], want[b, :n]) < 1e-5


def test_sigma_embedder():
    from esmdiff_tpu_torch.convert import torch_ckpt
    from esmdiff_tpu_torch.nn.layers import TimestepEmbedder

    W = weights.make(weights.sigma_shapes(TINY), 2, "cpu")
    se = TimestepEmbedder(TINY["d_model"], dtype=torch.float32)
    torch_ckpt.convert_sigma_embedder(se, W)
    sigma = torch.tensor([0.01, 0.7, 6.9])
    with torch.no_grad():
        assert rel(se(sigma), R.sigma_embed(W, sigma, R.Precision())) < 1e-6


def test_decoder_coordinates():
    from esmdiff_tpu_torch.convert import torch_ckpt
    from esmdiff_tpu_torch.models.vqvae import (DecoderConfig,
                                                StructureTokenDecoder)

    W = weights.make(weights.decoder_shapes(TINY_DEC), 3, "cpu")
    dec = StructureTokenDecoder(DecoderConfig(
        d_model=64, n_heads=4, n_layers=2, dtype="float32"))
    torch_ckpt.convert_vqvae_decoder(dec, W)
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, 4096, (4, 17), generator=gen)
    toks[:, 0], toks[:, -1] = R.STRUCT_BOS, R.STRUCT_EOS
    with torch.no_grad():
        got = dec.eval()(toks, compute_ptm=False)["bb_pred"]
        want = R.decode_backbone(W, TINY_DEC, toks)
    assert float((got - want).abs().max()) < 1e-4


def test_packed_loss_and_gradients():
    """MDLM.loss_packed with the trainer's draws against the reference's
    loss on the reference's own packing of the same chains."""
    from esmdiff_tpu_torch.convert import torch_ckpt
    from esmdiff_tpu_torch.diffusion.mdlm import GeneratorDraws
    from esmdiff_tpu_torch.train import loop

    t = dict(TINY, head="structure")
    tc = loop.TrainConfig()
    tc.model.size, tc.model.dtype = "custom", "float32"
    tc.model.d_model, tc.model.n_heads = 64, 4
    tc.model.n_layers, tc.model.v_heads = 3, 8
    tc.data.batch_size, tc.data.pack_len, tc.data.max_len = 4, 64, 64
    mdlm, loss_fn = loop.build_task(tc, "cpu")
    W = weights.make({**weights.trunk_shapes(t), **weights.sigma_shapes(t)},
                     4, "cpu")
    torch_ckpt.convert_mdlm(mdlm.net, mdlm.sigma_embedder, {
        (k if k.startswith("sigma_") else "net." + k): v
        for k, v in W.items()})
    rng = np.random.default_rng(0)
    chains = [(rng.integers(4, 24, n), rng.integers(0, 4096, n))
              for n in rng.integers(5, 40, 30)]
    # the port's batch from its own packer, the reference's from its own
    items = [{"sequence_tokens": s.astype(np.int32),
              "structure_tokens": x.astype(np.int32)} for s, x in chains]
    rows = next(iter(_port_pack(items, tc.data)))
    ref_batch = next(RT.packed_batches(chains, 4, 64, seed=7))
    for k in ("structure_tokens", "segment_ids", "positions", "mask"):
        np.testing.assert_array_equal(rows[k], ref_batch[k])
    batch = loop.to_device(rows, "cpu")
    loss, _ = loss_fn(batch, GeneratorDraws("cpu", seed=11))
    loss.backward()
    params = {k: v.clone().requires_grad_() for k, v in W.items()}
    gen = torch.Generator().manual_seed(11)
    ref = RT.loss(params, t, {k: torch.as_tensor(v) for k, v in
                              ref_batch.items()}, gen)
    ref.backward()
    assert abs(float(loss.detach()) - float(ref.detach())) \
        / abs(float(ref.detach())) < 1e-5
    names = weights.port_names(t)
    for name, p in loop.mdlm_modules(mdlm).named_parameters():
        g_ref = params[names[name]].grad
        if g_ref is None or float(g_ref.norm()) == 0.0:
            assert p.grad is None or float(p.grad.norm()) == 0.0, name
            continue
        assert rel(p.grad, g_ref) < 1e-4, name


def _port_pack(items, data_cfg):
    from esmdiff_tpu_torch.train import data as data_mod

    class Dataset:
        def load(self, i, rng):
            return items[i]

    split = data_mod.Split(Dataset(), np.arange(len(items)))
    cfg = dataclasses.replace(data_cfg)
    return data_mod.packed_batches(split, cfg, shuffle=True, seed=7)
