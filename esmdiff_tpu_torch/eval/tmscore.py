"""TM-score through the repo's C++ library (port of
``esmdiff_tpu/eval/tmscore.py``), and the ensemble measures built on it:
best-of-ensemble TM and RMSD, and pairwise TM diversity.

The search (fragment-seeded iterative Kabsch) is scalar host work, C++ in
both packages.  The port builds its own copy of the source
(``csrc/host/tmscore.cpp``, by ``utils/native.py`` with the JAX build's
flags), whose superposition is repaired: the shared library's power
iteration stops short of the optimal rotation on poorly superposable
pairs (far from native); the copy finishes those by Jacobi sweeps.  So
the port's scores equal the optimal (SVD) fit's, and the JAX library's
bit for bit wherever its iteration converges (near-native pairs).
``_tm_score_np`` is the library's plain numpy version, held against it by
the tests; nothing falls back to it.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np

from esmdiff_tpu_torch.utils import native

_DOUBLE_P = ctypes.POINTER(ctypes.c_double)


@functools.cache
def _library():
    lib = native.load("tmscore")
    lib.tm_score.restype = ctypes.c_double
    lib.tm_score.argtypes = [_DOUBLE_P, _DOUBLE_P, ctypes.c_int, _DOUBLE_P]
    lib.tm_score_batch.restype = None
    lib.tm_score_batch.argtypes = [_DOUBLE_P, _DOUBLE_P, ctypes.c_int,
                                   ctypes.c_int, _DOUBLE_P, _DOUBLE_P]
    return lib


def _host(x) -> np.ndarray:
    """A C-contiguous float64 host copy (tensors come off their device)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x, dtype=np.float64)


def _d0(n: int) -> float:
    return max(1.24 * (n - 15.0) ** (1.0 / 3.0) - 1.8, 0.5) if n > 21 else 0.5


def _jacobi_top_eigenvector(S):
    """The eigenvector of the largest eigenvalue of the symmetric 4 x 4
    ``S`` by cyclic Jacobi sweeps, as the library's
    ``jacobi_top_eigenvector``."""
    A = [list(row) for row in S]
    V = [[1.0 if i == j else 0.0 for j in range(4)] for i in range(4)]
    fro = math.sqrt(sum(x * x for row in S for x in row))
    for _ in range(64):
        off = sum(2.0 * A[p][r] * A[p][r]
                  for p in range(4) for r in range(p + 1, 4))
        if math.sqrt(off) <= 1e-14 * fro:
            break
        for p in range(4):
            for r in range(p + 1, 4):
                if A[p][r] == 0.0:
                    continue
                theta = (A[r][r] - A[p][p]) / (2.0 * A[p][r])
                t = (1.0 if theta >= 0.0 else -1.0) / (
                    abs(theta) + math.sqrt(theta * theta + 1.0))
                c = 1.0 / math.sqrt(t * t + 1.0)
                s = t * c
                for M, rows in ((A, False), (A, True), (V, False)):
                    for k in range(4):
                        if rows:
                            x, y = M[p][k], M[r][k]
                            M[p][k], M[r][k] = c * x - s * y, s * x + c * y
                        else:
                            x, y = M[k][p], M[k][r]
                            M[k][p], M[k][r] = c * x - s * y, s * x + c * y
    top = max(range(4), key=lambda i: (A[i][i], -i))
    return [V[i][top] for i in range(4)]


def _kabsch_np(a, b):
    """Rotation and translation fitting a onto b as the library's
    ``kabsch`` finds them: Horn's quaternion, the top eigenvector of the
    4 x 4 key matrix by power iteration shifted by its largest absolute row
    sum, from q = (1, .02, .03, .04), stopping once a step moves q by less
    than 1e-14 (L1); where 200 steps do not get there (poorly superposable
    pairs), the eigenvector of Jacobi sweeps instead."""
    ca, cb = a.mean(0), b.mean(0)
    (h00, h01, h02), (h10, h11, h12), (h20, h21, h22) = (
        (a - ca).T @ (b - cb)).tolist()
    S = [[h00 + h11 + h22, h12 - h21, h20 - h02, h01 - h10],
         [h12 - h21, h00 - h11 - h22, h01 + h10, h20 + h02],
         [h20 - h02, h01 + h10, -h00 + h11 - h22, h12 + h21],
         [h01 - h10, h20 + h02, h12 + h21, -h00 - h11 + h22]]
    shift = max(sum(abs(x) for x in row) for row in S)
    q = [1.0, 0.02, 0.03, 0.04]
    for _ in range(200):
        nq = [shift * q[i] + S[i][0] * q[0] + S[i][1] * q[1]
              + S[i][2] * q[2] + S[i][3] * q[3] for i in range(4)]
        norm = math.sqrt(sum(x * x for x in nq))
        if norm < 1e-30:
            break
        nq = [x / norm for x in nq]
        diff = sum(abs(x - y) for x, y in zip(nq, q))
        q = nq
        if diff < 1e-14:
            break
    else:
        q = _jacobi_top_eigenvector(S)
    q0, q1, q2, q3 = q
    R = np.array([
        [q0 * q0 + q1 * q1 - q2 * q2 - q3 * q3, 2 * (q1 * q2 - q0 * q3),
         2 * (q1 * q3 + q0 * q2)],
        [2 * (q1 * q2 + q0 * q3), q0 * q0 - q1 * q1 + q2 * q2 - q3 * q3,
         2 * (q2 * q3 - q0 * q1)],
        [2 * (q1 * q3 - q0 * q2), 2 * (q2 * q3 + q0 * q1),
         q0 * q0 - q1 * q1 - q2 * q2 + q3 * q3]])
    return R, cb - R @ ca


def _tm_score_np(xa, xb):
    """Plain numpy version of csrc/host/tmscore.cpp, step for step (its
    superpositions by ``_kabsch_np``)."""
    n = len(xa)
    d0 = _d0(n)
    d0_search = min(max(d0, 4.5), 8.0)
    R, t = _kabsch_np(xa, xb)
    rmsd = float(np.sqrt(np.mean(np.sum((xa @ R.T + t - xb) ** 2, -1))))
    best = 0.0
    frag = n
    while frag >= 4:
        step = max(frag // 2, 1)
        for start in range(0, n - frag + 1, step):
            idx = np.arange(start, start + frag)
            for it in range(20):
                if len(idx) < 3:
                    break
                R, t = _kabsch_np(xa[idx], xb[idx])
                d = np.sqrt(np.sum((xa @ R.T + t - xb) ** 2, -1))
                s = float(np.mean(1.0 / (1.0 + (d / d0) ** 2)))
                best = max(best, s)
                cut = max(d0_search - it * 0.5, 3.0)
                nxt = np.nonzero(d < cut)[0]
                if len(nxt) < 3 or (len(nxt) == len(idx)
                                    and (nxt == idx).all()):
                    break
                idx = nxt
        frag //= 2
    return best, rmsd


def _check(xa, xb, ndim):
    """The C entry points read (..., L, 3) float64 pairs of one shape."""
    if xa.shape != xb.shape or xa.ndim != ndim or xa.shape[-1] != 3:
        raise ValueError(f"residue-aligned CA sets of one shape with "
                         f"{ndim} axes, the last 3, expected: {xa.shape} "
                         f"and {xb.shape}")


def tm_score(model_ca, native_ca):
    """TM-score and RMSD of residue-aligned CA sets (L, 3), normalised by
    L."""
    xa, xb = _host(model_ca), _host(native_ca)
    _check(xa, xb, 2)
    rmsd = ctypes.c_double()
    tm = _library().tm_score(xa.ctypes.data_as(_DOUBLE_P),
                             xb.ctypes.data_as(_DOUBLE_P), len(xa),
                             ctypes.byref(rmsd))
    return float(tm), float(rmsd.value)


def _batch(xa, xb):
    _check(xa, xb, 3)
    M, L, _ = xa.shape
    tm = np.empty(M, dtype=np.float64)
    rmsd = np.empty(M, dtype=np.float64)
    _library().tm_score_batch(
        xa.ctypes.data_as(_DOUBLE_P), xb.ctypes.data_as(_DOUBLE_P), M, L,
        tm.ctypes.data_as(_DOUBLE_P), rmsd.ctypes.data_as(_DOUBLE_P))
    return tm, rmsd


def tm_score_many(models_ca, native_ca):
    """(M, L, 3) vs (L, 3) -> (tm (M,), rmsd (M,)) in one native call."""
    xa = _host(models_ca)
    return _batch(xa, _host(np.broadcast_to(_host(native_ca), xa.shape)))


def tm_ensemble(ensemble_ca, target_ca):
    """Best TM and best (lowest) RMSD of an ensemble against a target."""
    tm, rmsd = tm_score_many(ensemble_ca, target_ca)
    return float(tm.max()), float(rmsd.min())


def tm_diversity(ensemble_ca, max_pairs: int = 1000, seed: int = 0):
    """Mean pairwise (1 - TM) across ensemble members, over at most
    ``max_pairs`` pairs drawn as the JAX package draws them
    (``RandomState(seed).choice(..., replace=False)``), so both packages
    score the same pairs."""
    ens = _host(ensemble_ca)
    M = len(ens)
    pairs = [(i, j) for i in range(M) for j in range(i + 1, M)]
    if len(pairs) > max_pairs:
        sel = np.random.RandomState(seed).choice(len(pairs), max_pairs,
                                                 replace=False)
        pairs = [pairs[i] for i in sel]
    if not pairs:
        return 0.0
    tms, _ = _batch(np.ascontiguousarray(ens[[i for i, _ in pairs]]),
                    np.ascontiguousarray(ens[[j for _, j in pairs]]))
    return float(1.0 - tms.mean())
