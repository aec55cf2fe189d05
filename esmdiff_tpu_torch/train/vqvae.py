"""Joint VQ-VAE training: encoder + codebook + decoder, end to end.

Port of ``esmdiff_tpu/train/vqvae.py``.  No pretrained tokenizer weights
are available, so the structure tokenizer is trained here (van den Oord et
al., 2017):

  * straight-through estimator: the decoder consumes
    ``z + (z_q - z).detach()`` bridged to d_model, so reconstruction
    gradients reach the encoder through the quantization;
  * VQ objective: codebook loss ``||sg(z) - z_q||^2`` and commitment
    ``beta * ||z - sg(z_q)||^2``;
  * dead-code restart: codes unused over a window are re-seeded from live
    encoder outputs on the host, in place (the Adam moments are kept);
  * standard-layout export: the decoder's 4101-row ``embed`` table is
    materialized as ``[codebook @ W_bridge^T + b; special rows]``, so the
    trained pair loads through ``load_vqvae`` / ``--vqvae_ckpt`` and the
    standalone ``StructureTokenDecoder`` computes the training-time
    function.

The corpus stays on the host; each batch is gathered (and augmented) with
numpy and copied to the device.  One ``np.random.RandomState(seed)``
draws in JAX's order: the batch, its augmentation, the restart pool's
permutation (``it % 50 == 0``), then the restarts.  ``data_parallel``
trains one process per card (``DistributedDataParallel`` under
torchrun, ``parallel/mesh.py``): every rank draws the same global batch
and keeps its rows, the losses divide by the global batch's counts, and
the code usage and the restart pool are the global batch's, so N ranks
give the numbers of one.  The batch must divide by the world size.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from esmdiff_tpu_torch.core import constants as C
from esmdiff_tpu_torch.device import resolve_device
from esmdiff_tpu_torch.models.vqvae import (DecoderConfig, EncoderConfig,
                                            StructureTokenDecoder,
                                            StructureTokenEncoder)
from esmdiff_tpu_torch.nn.layers import Dense, init_params
from esmdiff_tpu_torch.parallel import mesh as pmesh
from esmdiff_tpu_torch.utils.logging import is_main_process

from . import state as tstate


# ---------------------------------------------------------------------------
# training-time module: encoder -> straight-through -> bridge -> decoder
# ---------------------------------------------------------------------------

class VQVAE(nn.Module):
    """Trainable encoder + decoder pair, named as the JAX params tree:
    ``encoder.*``, ``bridge.{weight, bias}``, ``special_embed``,
    ``decoder.*`` (the decoder has no ``embed`` table: it is materialized
    from ``codebook``/``bridge``/``special_embed`` at export, see
    ``materialize_decoder_params``)."""

    def __init__(self, enc_cfg: EncoderConfig, dec_cfg: DecoderConfig):
        super().__init__()
        self.enc_cfg, self.dec_cfg = enc_cfg, dec_cfg
        self.encoder = StructureTokenEncoder(enc_cfg)
        self.bridge = Dense(enc_cfg.d_out, dec_cfg.d_model,
                            dtype=torch.float32)
        self.special_embed = nn.Parameter(torch.empty(
            C.STRUCTURE_NUM_SPECIAL_TOKENS, dec_cfg.d_model))
        self.decoder = StructureTokenDecoder(dec_cfg, embed=False)

    def forward(self, coords, lengths, residue_index=None):
        """coords (B, Lp, 3, 3) NaN-padded N/CA/C; lengths (B,) int.

        Returns (decoder_out, aux): aux holds z, z_q, valid, tokens,
        full_tokens (B, Lp + 2) and the per-code usage counts."""
        B, Lp = coords.shape[:2]
        dev = coords.device
        lengths = lengths.long()
        in_chain = torch.arange(Lp, device=dev)[None, :] < lengths[:, None]

        tokens, z, valid, z_q = self.encoder(
            coords, residue_index=residue_index, return_zq=True)
        valid = valid & in_chain
        z = z.float()

        # straight-through: forward z_q, gradient to z
        bridged = self.bridge(z + (z_q - z).detach())      # (B, Lp, d_model)

        # interior ids: the code where valid, MASK in the chain but not
        # modelled, PAD past it (the inference-time token layout)
        interior = torch.where(
            valid, tokens, torch.where(in_chain, C.STRUCTURE_MASK_TOKEN,
                                       C.STRUCTURE_PAD_TOKEN))
        full = torch.cat([
            torch.full((B, 1), C.STRUCTURE_BOS_TOKEN, device=dev),
            interior,
            torch.full((B, 1), C.STRUCTURE_PAD_TOKEN, device=dev)], dim=1)
        full[torch.arange(B, device=dev), lengths + 1] = C.STRUCTURE_EOS_TOKEN

        is_code = full < C.VQVAE_CODEBOOK_SIZE
        special_rows = self.special_embed[
            (full - C.VQVAE_CODEBOOK_SIZE).clamp(
                0, C.STRUCTURE_NUM_SPECIAL_TOKENS - 1)]
        zero = bridged.new_zeros(B, 1, bridged.shape[-1])
        embeds = torch.where(is_code[:, :, None],
                             torch.cat([zero, bridged, zero], dim=1),
                             special_rows)
        out = self.decoder(full, compute_ptm=False, inputs_embeds=embeds)

        usage = torch.zeros(self.enc_cfg.n_codes, dtype=torch.int64,
                            device=dev).index_add_(
            0, torch.where(valid, tokens, 0).reshape(-1),
            valid.reshape(-1).long())
        aux = {"z": z, "z_q": z_q, "valid": valid, "tokens": tokens,
               "full_tokens": full, "usage": usage}
        return out, aux


@torch.no_grad()
def init_vqvae(model: VQVAE, seed: int) -> VQVAE:
    """Random weights from ``seed`` on the model's device, at flax's
    initialisers' scales (not JAX's bits): the codebook N(0, 1), the
    special rows N(0, 0.02)."""
    gen = torch.Generator(device=model.special_embed.device)
    gen.manual_seed(int(seed))
    init_params(model, gen)
    model.encoder.codebook.normal_(0.0, 1.0, generator=gen)
    model.special_embed.normal_(0.0, 0.02, generator=gen)
    return model


# ---------------------------------------------------------------------------
# reconstruction losses
# ---------------------------------------------------------------------------

def _count(x, shard):
    """A loss's denominator: of the global batch under a data shard."""
    return x if shard is None else shard.sum(x)


def drmsd_loss(pred, true, mask, shard=None):
    """Rotation/translation-invariant reconstruction: CA pairwise-distance
    MSE + intra-residue bond terms + chirality (signed volume) tie-break.
    pred/true (B, L, 3, 3) float32, mask (B, L) float32.  shard: the rows
    are a data shard's (``parallel.mesh.RowShard``): each mean divides by
    the global batch's count."""
    ca_p, ca_t = pred[:, :, 1], true[:, :, 1]
    dp = (ca_p[:, :, None] - ca_p[:, None] + 1e-8).norm(dim=-1)
    dt = (ca_t[:, :, None] - ca_t[:, None] + 1e-8).norm(dim=-1)
    m2 = mask[:, :, None] * mask[:, None]
    l_pwd = (((dp - dt) * m2) ** 2).sum() / (_count(m2.sum(), shard) + 1e-8)

    def local(x):
        n, ca, c = x[:, :, 0], x[:, :, 1], x[:, :, 2]
        return torch.stack([(ca - n + 1e-8).norm(dim=-1),
                            (c - ca + 1e-8).norm(dim=-1),
                            (c - n + 1e-8).norm(dim=-1)], -1)

    l_loc = (((local(pred) - local(true)) * mask[..., None]) ** 2).sum() \
        / (_count(mask.sum(), shard) * 3 + 1e-8)

    def chir(x):
        n, ca, c = x[:, :, 0], x[:, :, 1], x[:, :, 2]
        w = ca[:, 1:] - ca[:, :-1]
        return (torch.linalg.cross(ca - n, c - ca, dim=-1)[:, :-1]
                * w).sum(dim=-1)

    mc = mask[:, 1:] * mask[:, :-1]
    l_chi = (((chir(pred) - chir(true)) * mc) ** 2).sum() \
        / (_count(mc.sum(), shard) + 1e-8)
    return l_pwd + l_loc + 0.1 * l_chi


def kabsch_huber_loss(pred, true, mask, delta: float = 4.0, shard=None):
    """Per-sample Kabsch-align TRUE onto PRED (rotation and means
    detached) and take the masked Huber over all backbone atoms (shard: as
    ``drmsd_loss``'s)."""
    ca_p, ca_t = pred[:, :, 1], true[:, :, 1]
    w = mask[:, :, None]
    n = mask.sum(dim=1)[:, None] + 1e-6
    mu_p = (ca_p * w).sum(dim=1) / n
    mu_t = (ca_t * w).sum(dim=1) / n
    H = torch.einsum("bld,ble->bde", (ca_t - mu_t[:, None]) * w,
                     (ca_p - mu_p[:, None]) * w).detach()
    U, _, Vt = torch.linalg.svd(H)
    det = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    R = torch.einsum("bde,be,bef->bdf", U, D, Vt)
    mu_p, mu_t = mu_p.detach(), mu_t.detach()
    true_al = torch.einsum("blad,bde->blae", true - mu_t[:, None, None], R) \
        + mu_p[:, None, None]
    dist = torch.sqrt(((pred - true_al) ** 2).sum(dim=-1) + 1e-8)
    hub = torch.where(dist <= delta, 0.5 * dist ** 2,
                      delta * (dist - 0.5 * delta))
    return (hub * mask[:, :, None]).sum() \
        / (_count(mask.sum(), shard) * 3 + 1e-8)


# ---------------------------------------------------------------------------
# full objective
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VQLossConfig:
    beta: float = 0.25          # commitment weight (van den Oord 2017 §3.2)
    vq_weight: float = 1.0      # (codebook + beta*commit) scale vs recon
    recon: str = "drmsd"        # drmsd | kabsch


@dataclasses.dataclass(frozen=True)
class VQAugmentConfig:
    """Train-batch augmentation for small corpora, on the host: random
    contiguous crops, Gaussian coordinate jitter (Å) and random global
    rotations.  Validation batches are never augmented."""

    crop: float = 0.5           # P(random contiguous crop) per structure
    crop_min: int = 32          # minimum crop length (residues)
    jitter: float = 0.05        # Gaussian coord noise, Å (0 = off)
    rotate: bool = True         # random global rotation per structure


def augment_batch(c: np.ndarray, lens: np.ndarray, aug: VQAugmentConfig,
                  rs: np.random.RandomState):
    """Host-side train-batch augmentation.  c: (B, Lp, 3, 3) NaN-padded;
    returns modified copies with static shapes preserved (crops re-pad with
    NaN, so the finite-coordinate mask and lengths stay consistent)."""
    c = np.array(c, np.float32, copy=True)
    lens = np.array(lens, np.int32, copy=True)
    for i in range(c.shape[0]):
        L = int(lens[i])
        if aug.crop > 0 and L > aug.crop_min and rs.rand() < aug.crop:
            cl = int(rs.randint(aug.crop_min, L + 1))
            off = int(rs.randint(0, L - cl + 1))
            seg = c[i, off:off + cl].copy()
            c[i] = np.nan
            c[i, :cl] = seg
            lens[i] = cl
        if aug.rotate:
            # uniform random rotation (normalized-quaternion method)
            q = rs.randn(4).astype(np.float32)
            q /= np.linalg.norm(q)
            w, x, y, z = q
            R = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x),
                 1 - 2 * (x * x + y * y)]], np.float32)
            c[i] = c[i] @ R.T
        if aug.jitter > 0:
            c[i] = c[i] + (rs.randn(*c[i].shape).astype(np.float32)
                           * aug.jitter)
    return c, lens


def vqvae_loss(out, aux, coords_clean, coord_mask, lengths,
               cfg: VQLossConfig, shard=None):
    """-> (total, metrics dict).  coords_clean: NaN->0 coords (B, Lp, 3, 3);
    coord_mask: (B, Lp) float32 finite-coordinate mask.  shard: the rows
    are a data shard's; the losses are its parts of the global batch's."""
    pred = out["bb_pred"][:, 1:-1].float()
    mask = coord_mask * aux["valid"].float()
    recon_impl = drmsd_loss if cfg.recon == "drmsd" else kabsch_huber_loss
    l_recon = recon_impl(pred, coords_clean, mask, shard=shard)

    z, z_q = aux["z"], aux["z_q"]
    vmask = aux["valid"].float()[:, :, None]
    denom = _count(vmask.sum(), shard) * z.shape[-1] + 1e-8
    l_codebook = ((z.detach() - z_q) ** 2 * vmask).sum() / denom
    l_commit = ((z - z_q.detach()) ** 2 * vmask).sum() / denom
    total = l_recon + cfg.vq_weight * (l_codebook + cfg.beta * l_commit)
    metrics = {"recon": l_recon, "codebook": l_codebook,
               "commit": l_commit, "usage": aux["usage"]}
    return total, metrics


# ---------------------------------------------------------------------------
# dead-code restart (host-side)
# ---------------------------------------------------------------------------

@torch.no_grad()
def restart_dead_codes(model: nn.Module, usage_counts, z_pool,
                       rng: np.random.RandomState,
                       noise: float = 0.01) -> int:
    """Re-seed codes with zero usage over the tracking window from live
    encoder outputs, in place.  model: a ``VQVAE`` (its
    ``encoder.codebook``) or an encoder (its ``codebook``); usage_counts
    (n_codes,) int; z_pool (M, d_out) recent encoder outputs (host numpy).

    Returns the number of codes restarted.  The rows are drawn with numpy
    as in JAX; nothing else changes (the Adam moments are kept)."""
    holder = model.encoder if hasattr(model, "encoder") else model
    param = holder.codebook
    codebook = param.detach().cpu().numpy()
    dead = np.where(np.asarray(usage_counts) == 0)[0]
    if dead.size == 0 or len(z_pool) == 0:
        return 0
    picks = z_pool[rng.randint(0, len(z_pool), size=dead.size)]
    rows = picks + noise * rng.randn(
        dead.size, codebook.shape[1]).astype(codebook.dtype)
    param[torch.as_tensor(dead, device=param.device)] = torch.as_tensor(
        rows, dtype=param.dtype, device=param.device)
    return int(dead.size)


# ---------------------------------------------------------------------------
# standard-layout export
# ---------------------------------------------------------------------------

def sub_state_dict(params: Mapping, prefix: str) -> dict:
    """The entries of ``params`` under ``prefix``, the prefix stripped."""
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


@torch.no_grad()
def materialize_decoder_params(vq_params: Mapping) -> dict:
    """Standalone ``StructureTokenDecoder`` params from a trained
    ``VQVAE`` state dict: rows 0..n_codes-1 of ``embed.weight`` are
    ``codebook @ W_bridge^T + b`` (float32, the training-time bridge on
    quantized codes), the rows up to 4096 zero (never indexed by a code),
    rows 4096..4100 the learned special embeddings (MASK, EOS, BOS, PAD,
    CHAINBREAK)."""
    codebook = vq_params["encoder.codebook"].float()
    code_rows = (codebook @ vq_params["bridge.weight"].float().t()
                 + vq_params["bridge.bias"].float())
    pad = code_rows.new_zeros(C.VQVAE_CODEBOOK_SIZE - code_rows.shape[0],
                              code_rows.shape[1])
    table = torch.cat([code_rows, pad,
                       vq_params["special_embed"].float()], dim=0)
    assert table.shape[0] == C.STRUCTURE_VOCAB_SIZE
    dec = sub_state_dict(vq_params, "decoder.")
    dec["embed.weight"] = table
    return dec


def export_vqvae(out_dir, enc_cfg: EncoderConfig, dec_cfg: DecoderConfig,
                 vq_params: Mapping) -> None:
    """Save the trained pair in the port's vqvae checkpoint layout
    (``convert/checkpoints.py::save_vqvae``): it loads back through
    ``--vqvae_ckpt`` with no special-casing."""
    # imported here: convert.checkpoints imports this module
    from esmdiff_tpu_torch.convert.checkpoints import save_vqvae

    save_vqvae(out_dir, enc_cfg, sub_state_dict(vq_params, "encoder."),
               dec_cfg, materialize_decoder_params(vq_params))


# ---------------------------------------------------------------------------
# one-call trainer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class VQVAETrainResult:
    params: dict        # the trained VQVAE's state dict
    losses: list
    n_live_codes: int


def gather_batch(coords: np.ndarray, lengths: np.ndarray, idx, device,
                 augment: Optional[VQAugmentConfig] = None,
                 rs: Optional[np.random.RandomState] = None) -> dict:
    """Rows ``idx`` of the host corpus (augmented when ``augment`` is
    given, drawing from ``rs``), copied to ``device``: the NaN-padded
    coords, their NaN->0 copy, the finite-coordinate mask and the
    lengths."""
    c, lens = coords[idx], lengths[idx]
    if augment is not None:
        c, lens = augment_batch(c, lens, augment, rs)
    host = {"coords": c, "coords_clean": np.nan_to_num(c, nan=0.0),
            "coord_mask": np.isfinite(c).all(-1).all(-1).astype(np.float32),
            "lengths": lens}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in host.items()}


def batch_loss(model: VQVAE, batch: dict, loss_cfg: VQLossConfig,
               shard=None):
    """(total, metrics + the step's z and valid mask) of one batch (a data
    shard's rows of a global batch with ``shard``)."""
    out, aux = model(batch["coords"], batch["lengths"])
    total, m = vqvae_loss(out, aux, batch["coords_clean"],
                          batch["coord_mask"], batch["lengths"], loss_cfg,
                          shard=shard)
    return total, {**m, "z": aux["z"], "valid": aux["valid"]}


@torch.no_grad()
def val_recon(model: VQVAE, batch: dict, loss_cfg: VQLossConfig):
    """The reconstruction loss of the fixed validation batch."""
    return batch_loss(model, batch, loss_cfg)[1]["recon"]


def train_vqvae(enc_cfg: EncoderConfig, dec_cfg: DecoderConfig,
                coords: np.ndarray, lengths: np.ndarray, *,
                steps: int, batch: int, lr: float = 3e-4,
                loss_cfg: VQLossConfig = VQLossConfig(),
                seed: int = 0, restart_every: int = 500,
                val_idx: Optional[np.ndarray] = None,
                data_parallel: bool = False,
                augment: Optional[VQAugmentConfig] = None,
                log_every: int = 500, log=print, device=None,
                params: Optional[Mapping] = None) -> VQVAETrainResult:
    """Joint VQ-VAE training on a coordinate corpus.

    coords: (N, Lp, 3, 3) NaN-padded; lengths: (N,) int32.  Returns the
    trained ``VQVAE``'s state dict (export with ``export_vqvae``).
    params: optional starting state dict (e.g. JAX's init carried over),
    else ``init_vqvae`` from ``seed``.  AdamW (decay 0.01) under optax's
    ``warmup_cosine_decay_schedule`` to lr/30, clipped at global norm 1.
    augment: train-batch augmentation (``VQAugmentConfig``).
    data_parallel: this process is one rank of the open process group
    (or, under torchrun, of the group it opens; with neither, the only
    one): DDP over it, ``batch`` the global batch, divisible by the world
    size."""
    dev = resolve_device(pmesh.local_device(device) if data_parallel
                         else device)
    opened = pmesh.init_from_env(dev) if data_parallel else False
    try:
        return _train_vqvae(enc_cfg, dec_cfg, coords, lengths, steps, batch,
                            lr, loss_cfg, seed, restart_every, val_idx,
                            data_parallel, augment, log_every, log, dev,
                            params)
    finally:
        pmesh.close(opened)


def _train_vqvae(enc_cfg, dec_cfg, coords, lengths, steps, batch, lr,
                 loss_cfg, seed, restart_every, val_idx, data_parallel,
                 augment, log_every, log, dev, params) -> VQVAETrainResult:
    if log and not is_main_process():
        log = None
    rs = np.random.RandomState(seed)
    N = coords.shape[0]
    coords = np.asarray(coords, np.float32)
    lengths = np.asarray(lengths, np.int32)

    with torch.device(dev):
        model = VQVAE(enc_cfg, dec_cfg)
    if params is None:
        init_vqvae(model, seed)
    else:
        model.load_state_dict({k: torch.as_tensor(np.array(v))
                               for k, v in params.items()}, strict=True)
    model.train()
    sched = tstate.warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps=min(200, max(1, steps // 20)),
        decay_steps=steps, end_value=lr / 30)

    def loss_fn(b, draws, training=True, shard=None):
        return batch_loss(model, b, loss_cfg, shard=shard)

    layout = None
    if data_parallel:
        loss_fn, layout = tstate.distribute(model, loss_fn, "ddp", batch,
                                            dev)
    state = tstate.create_train_state(model, tstate.make_optimizer(
        model.parameters(), lr=lr, weight_decay=0.01, grad_clip=1.0,
        schedule=sched), layout)
    shard = None if layout is None else layout.shard
    group = None if shard is None else shard.group

    val_batch = (gather_batch(coords, lengths, np.asarray(val_idx[:16]), dev)
                 if val_idx is not None and len(val_idx) else None)

    usage_window = np.zeros((enc_cfg.n_codes,), np.int64)
    z_pool = None
    losses = []
    tr_idx = np.arange(N) if val_idx is None else \
        np.setdiff1d(np.arange(N), val_idx)
    for it in range(steps):
        idx = rs.choice(tr_idx, batch)
        if shard is None:
            b = gather_batch(coords, lengths, idx, dev, augment, rs)
        else:
            # every rank draws (and augments) the global batch, keeps its
            # rows
            b = {k: shard.rows(v) for k, v in gather_batch(
                coords, lengths, idx, "cpu", augment, rs).items()}
            b = {k: v.to(dev) for k, v in b.items()}
        m = tstate.train_step(state, loss_fn, b, None)
        m["usage"] = pmesh.all_sum(m["usage"], group)
        usage_window += m["usage"].cpu().numpy()
        if it % 50 == 0:  # refresh the restart pool cheaply
            z = pmesh.gather_rows(m["z"], group)
            valid = pmesh.gather_rows(m["valid"].to(torch.uint8), group)
            pool = z.cpu().numpy()[valid.cpu().numpy().astype(bool)]
            if pool.size:
                z_pool = pool[rs.permutation(len(pool))[:4096]]
        if restart_every and (it + 1) % restart_every == 0 \
                and z_pool is not None:
            n_restart = restart_dead_codes(model, usage_window, z_pool, rs)
            if n_restart and log:
                log(f"[vqvae] step {it}: restarted {n_restart} dead codes "
                    f"({int((usage_window > 0).sum())} live)")
            usage_window[:] = 0
        if log and (it % log_every == 0 or it == steps - 1):
            msg = (f"[vqvae] step {it}: total {float(m['loss']):.4f} recon "
                   f"{float(m['recon']):.4f} codebook "
                   f"{float(m['codebook']):.4f} commit "
                   f"{float(m['commit']):.4f}")
            if val_batch is not None:
                msg += (f" val_recon "
                        f"{float(val_recon(model, val_batch, loss_cfg)):.4f}")
            log(msg, flush=True) if log is print else log(msg)
        losses.append(float(m["loss"]))
    n_live = int((m["usage"].cpu().numpy() + usage_window > 0).sum())
    return VQVAETrainResult(params=model.state_dict(), losses=losses,
                            n_live_codes=n_live)
