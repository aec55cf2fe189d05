"""Backbone frames (``Affine3D``) and geometric attention (port of
``esmdiff_tpu/nn/geometric.py``).

Frames are plain (rot, trans) tensor pairs built from N/CA/C coordinates;
geometric attention is ESM3 block 0's frame-aware attention.  It runs once
per forward, in plain PyTorch: the JAX package has no Pallas kernel for it
either.  With no coordinates every frame is masked, its output is exactly
zero, and the trunk skips it (``skip_geom``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, LayerNorm


class Affine3D(NamedTuple):
    rot: torch.Tensor    # (..., 3, 3) row-major rotation matrices
    trans: torch.Tensor  # (..., 3)

    def apply(self, points):
        """Rotate+translate local points (..., 3) into the global frame."""
        return torch.einsum("...ij,...j->...i", self.rot, points) + self.trans

    def rotate(self, vecs):
        return torch.einsum("...ij,...j->...i", self.rot, vecs)

    def rotate_inv(self, vecs):
        return torch.einsum("...ji,...j->...i", self.rot, vecs)

    def compose_rotation(self, other_rot):
        return Affine3D(rot=torch.einsum("...ij,...jk->...ik", self.rot,
                                         other_rot),
                        trans=self.trans)


def _normalize(v, eps: float):
    return v / v.norm(dim=-1, keepdim=True).clamp_min(eps)


def gram_schmidt_frames(n, ca, c, eps: float = 1e-8):
    """Rotation matrices from N/CA/C positions (x axis toward C, N in the
    xy plane): (..., 3, 3) with columns e1, e2, e3, so that
    R @ local + CA = global."""
    e1 = _normalize(c - ca, eps)
    v2 = n - ca
    e2 = _normalize(v2 - e1 * (e1 * v2).sum(dim=-1, keepdim=True), eps)
    e3 = torch.linalg.cross(e1, e2, dim=-1)
    return torch.stack([e1, e2, e3], dim=-1)


def build_affine3d_from_coordinates(coords):
    """coords: (B, L, 3, 3) N/CA/C positions, NaN/inf where unknown ->
    (Affine3D with (B, L, 3, 3) / (B, L, 3), affine_mask (B, L) bool).

    Frameless residues get the identity rotation, a translation at the mean
    of the valid CA positions (so distance terms stay finite) and mask
    False."""
    coords = coords.float()
    finite = torch.isfinite(coords).all(dim=-1).all(dim=-1)   # (B, L)
    safe = torch.where(finite[..., None, None], coords, 0.0)
    n, ca, c = safe[..., 0, :], safe[..., 1, :], safe[..., 2, :]
    rot = gram_schmidt_frames(n, ca, c)
    denom = finite.sum(dim=-1, keepdim=True).clamp_min(1)
    mean_ca = ((ca * finite[..., None]).sum(dim=-2, keepdim=True)
               / denom[..., None])
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device).expand(rot.shape)
    rot = torch.where(finite[..., None, None], rot, eye)
    trans = torch.where(finite[..., None], ca, mean_ca)
    return Affine3D(rot=rot, trans=trans), finite


class GeometricAttention(nn.Module):
    """Frame-aware attention over Affine3D backbone frames (ESM3 block 0).

    Per head: query/key rotation vectors (a direction-agreement term), a
    value vector message, and query/key distance points (a proximity term):
      logit[h,i,j] = softplus(w_rot[h]) * <qr_i, kr_j> / sqrt(3)
                   - softplus(w_dist[h]) * ||qd_i - kd_j||
    Values are exchanged in the global frame and rotated back into the
    local frame of the receiving residue.  ``proj`` runs in ``dtype`` and
    its output in float32; ``out`` takes its input cast back to ``dtype``.
    tp: set by ``parallel.tp.shard_modules`` when ``proj`` and ``out`` hold
    this rank's heads only (the per-head scales are sliced at use and the
    output is summed over the model axis).
    """

    tp = None

    def __init__(self, d_model: int, v_heads: int,
                 num_vector_messages: int = 1,
                 mask_and_zero_frameless: bool = True, dtype=torch.bfloat16):
        super().__init__()
        self.v_heads, self.num_vector_messages = v_heads, num_vector_messages
        self.mask_and_zero_frameless = mask_and_zero_frameless
        self.ln = LayerNorm(d_model)
        self.proj = Dense(d_model, v_heads * (12 + 3 * num_vector_messages),
                          use_bias=False, dtype=dtype)
        self.rotation_scale = nn.Parameter(torch.empty(v_heads))
        self.distance_scale = nn.Parameter(torch.empty(v_heads))
        self.out = Dense(v_heads * 3 * num_vector_messages, d_model,
                         use_bias=False, dtype=dtype)

    def forward(self, s, affine: Affine3D, affine_mask, sequence_id=None,
                chain_id=None):
        B, L, _ = s.shape
        tp = self.tp
        H, M = self.v_heads, self.num_vector_messages
        rot_scale, dist_scale = self.rotation_scale, self.distance_scale
        h = self.ln(s)
        if tp is not None:
            H //= tp.size
            h = tp.copy(h)
            rot_scale = tp.local(tp.copy(rot_scale))
            dist_scale = tp.local(tp.copy(dist_scale))
        proj = self.proj(h).float().reshape(B, L, H, 12 + 3 * M)
        # the channel order is JAX's split: qr kr qd kd value
        qr, kr, qd, kd, val = proj.split([3, 3, 3, 3, 3 * M], dim=-1)
        rot = affine.rot[:, :, None]      # (B, L, 1, 3, 3)
        trans = affine.trans[:, :, None]  # (B, L, 1, 3)

        def to_global(v):  # rotate local -> global, v: (B, L, H, 3 * m)
            v3 = v.reshape(B, L, H, -1, 3)
            return torch.einsum("blhij,blhmj->blhmi", rot, v3).reshape(
                v.shape)

        qr_g, kr_g, val_g = to_global(qr), to_global(kr), to_global(val)
        qd_g = to_global(qd) + trans
        kd_g = to_global(kd) + trans

        rot_term = torch.einsum("blhc,bmhc->bhlm", qr_g, kr_g) / math.sqrt(3.0)
        # ||qd_i - kd_j|| by the Gram expansion, as JAX computes it (no
        # (B, L, L, H, 3) difference tensor)
        qq = (qd_g * qd_g).sum(dim=-1).transpose(1, 2)       # (B, H, L)
        kk = (kd_g * kd_g).sum(dim=-1).transpose(1, 2)
        qk = torch.einsum("blhc,bmhc->bhlm", qd_g, kd_g)
        dist2 = qq[..., :, None] + kk[..., None, :] - 2.0 * qk
        dist_term = dist2.clamp_min(1e-8).sqrt()
        logits = (rot_term * F.softplus(rot_scale)[:, None, None]
                  - dist_term * F.softplus(dist_scale)[:, None, None])

        allow = affine_mask[:, None, None, :]  # a key must have a frame
        for ids in (sequence_id, chain_id):
            if ids is not None:
                allow = allow & (ids[:, None, :, None]
                                 == ids[:, None, None, :])
        probs = torch.softmax(logits.masked_fill(~allow, -1e9), dim=-1)

        o_g = torch.einsum("bhlm,bmhc->blhc", probs, val_g)   # global frame
        o_local = torch.einsum("blhji,blhmj->blhmi", rot,
                               o_g.reshape(B, L, H, M, 3))
        out = self.out(o_local.reshape(B, L, H * M * 3))
        if tp is not None:
            out = tp.reduce(out)
        if self.mask_and_zero_frameless:
            out = torch.where(affine_mask[..., None], out, 0.0)
        return out
