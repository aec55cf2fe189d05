"""Sequence-parallel exact attention: a K/V ring over a process group.

Port of ``esmdiff_tpu/parallel/ring.py``.  Each rank holds an L/N slice of
q, k and v on the length axis; the K/V blocks rotate one rank along the
ring (``batch_isend_irecv``: send to the next rank, receive from the
previous one) while the softmax accumulates online (the flash-style m/l
carry, in float32), so after N blocks every query has seen every key.
The result is exact against the one-device attention.

Masking follows the flash kernel's contract: prefix ``lengths`` of the
whole sequence (padding is a contiguous suffix), so a key's validity is
decided on its global position, tracked through the block's origin
``(my rank - round) mod N``.  The computation is plain PyTorch, as JAX's
is einsum; it is a forward only (nothing in either package trains
through it).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def _ring(group):
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def shard_sequence(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's contiguous slice of the length axis (dim 1) of a whole
    (B, L, ...) tensor.  L must divide by the ring, else it raises."""
    me, n = _ring(group)
    if x.shape[1] % n:
        raise ValueError(f"L={x.shape[1]} not divisible by the ring size "
                         f"{n}")
    return x.chunk(n, dim=1)[me].contiguous()


def _rotate(tensors, me: int, n: int, group):
    """Each tensor sent to the next rank of the ring, the previous rank's
    received in its place."""
    def peer(i):
        return i if group is None else dist.get_global_rank(group, i)

    out = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, o in zip(tensors, out):
        ops.append(dist.P2POp(dist.isend, t, peer((me + 1) % n), group))
        ops.append(dist.P2POp(dist.irecv, o, peer((me - 1) % n), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def ring_attention(q, k, v, lengths: Optional[torch.Tensor] = None,
                   group=None) -> torch.Tensor:
    """Exact attention with the length axis split over ``group``'s ring.

    q, k, v: (B, Lc, H, Dh), this rank's slice (``shard_sequence``) of a
    sequence of N * Lc positions.  lengths: (B,) valid-prefix lengths of
    the whole sequence (the same on every rank), or None for fully valid
    rows.  Returns this rank's (B, Lc, H, Dh) slice of the output, in q's
    dtype."""
    me, n = _ring(group)
    B, Lc, H, Dh = q.shape
    dev = q.device
    if lengths is None:
        lengths = torch.full((B,), Lc * n, dtype=torch.int32, device=dev)
    lengths = lengths.to(dev)
    scale = 1.0 / float(Dh) ** 0.5
    qf = q.float()
    m = torch.full((B, H, Lc, 1), float("-inf"), device=dev)
    lsum = torch.zeros((B, H, Lc, 1), device=dev)
    acc = torch.zeros((B, H, Lc, Dh), device=dev)
    k_c, v_c = k.contiguous(), v.contiguous()
    for i in range(n):
        src = (me - i) % n
        kpos = src * Lc + torch.arange(Lc, device=dev)
        s = torch.einsum("blhd,bmhd->bhlm", qf, k_c.float()) * scale
        valid = kpos[None, :] < lengths[:, None]             # (B, Lc)
        s = torch.where(valid[:, None, None, :], s, -1e9)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        lsum = lsum * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhlm,bmhd->bhld", p, v_c.float())
        m = m_new
        if i < n - 1:
            k_c, v_c = _rotate((k_c, v_c), me, n, group)
    o = acc / lsum                                          # (B, H, Lc, Dh)
    return o.permute(0, 2, 1, 3).to(q.dtype)
