"""Ensemble quality metrics (port of ``esmdiff_tpu/eval/metrics.py``): JS
divergence of pairwise-distance, TICA and radius-of-gyration distributions,
steric-clash and bond validity, the IDP MSE/MAE metrics, RMSF and position
entropy.

The geometry runs in torch, float64, on ``device``: ``cuda`` unless the
caller asks for the CPU (without a card that raises); a tensor given with
no device stays on its own.  Condensed distances by frame blocks (the full
(frames, L, L, 3) difference tensor of 100,000 frames is 8 GB), histograms
by numpy's own binning rule written in torch ops (the counts equal
``np.histogram``'s, edges included), TICA's covariances and
eigenproblems.  The suites return what the JAX package's
return: scores rounded to 4 decimals with ``np.around``, on the host.
``correlations`` is scipy's, on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from esmdiff_tpu_torch.device import resolve_device

EPS = 1e-12
PSEUDO_C = 1e-6
# elements of one block's temporaries (frames x features): bounds memory
_BLOCK_ELEMENTS = 1 << 24


def _tensor(x, device=None) -> torch.Tensor:
    """float64 on ``device``; with no device a tensor stays where it is and
    anything else goes to ``resolve_device(None)`` (the card)."""
    if torch.is_tensor(x):
        return x.to(dtype=torch.float64, device=x.device if device is None
                    else resolve_device(device))
    return torch.as_tensor(np.asarray(x), dtype=torch.float64,
                           device=resolve_device(device))


def on_device(d: dict, device=None) -> dict:
    """Each array of ``d`` as float64 on the resolved device."""
    dev = resolve_device(device)
    return {k: _tensor(v, dev) for k, v in d.items()}


def _blocks(n_rows: int, row_elements: int):
    step = max(1, _BLOCK_ELEMENTS // max(1, row_elements))
    return [slice(i, i + step) for i in range(0, n_rows, step)]


# ---------------------------------------------------------------------------
# geometry features
# ---------------------------------------------------------------------------

def _norm3(d):
    """sqrt(x^2 + y^2 + z^2), summed in numpy's order."""
    return torch.sqrt((d[..., 0] ** 2 + d[..., 1] ** 2) + d[..., 2] ** 2)


def adjacent_ca_distance(coords, device=None):
    x = _tensor(coords, device)
    return _norm3(x[..., :-1, :] - x[..., 1:, :])


def distance_matrix_ca(coords, device=None):
    """(..., L, 3) -> (..., L, L), by blocks of frames."""
    x = _tensor(coords, device)
    lead, L = x.shape[:-2], x.shape[-2]
    flat = x.reshape(-1, L, 3)
    out = torch.cat([_norm3(flat[s, None, :, :] - flat[s, :, None, :])
                     for s in _blocks(len(flat), L * L * 3)]
                    or [flat.new_zeros(0, L, L)])
    return out.reshape(*lead, L, L)


def pairwise_distance_ca(coords, k: int = 1, device=None):
    """(..., L, 3) -> (..., D) upper-triangle (offset k) distances, each
    pair's difference formed directly, by blocks of frames."""
    x = _tensor(coords, device)
    lead, L = x.shape[:-2], x.shape[-2]
    row, col = torch.triu_indices(L, L, offset=k, device=x.device)
    flat = x.reshape(-1, L, 3)
    out = torch.cat([_norm3(flat[s][:, col] - flat[s][:, row])
                     for s in _blocks(len(flat), len(row) * 3)]
                    or [flat.new_zeros(0, len(row))])
    return out.reshape(*lead, len(row))


def radius_of_gyration(coords, masses=None, device=None):
    x = _tensor(coords, device)
    masses = (torch.ones(x.shape[-2], dtype=x.dtype, device=x.device)
              if masses is None else _tensor(masses, x.device))
    weights = masses / masses.sum()
    centered = x - x.mean(dim=-2, keepdim=True)
    return torch.sqrt(((centered ** 2).sum(dim=-1) * weights).sum(dim=-1))


def rmsf(coords, device=None):
    """(B, L, 3) -> (L,) root-mean-square fluctuation."""
    x = _tensor(coords, device)
    return torch.sqrt(torch.var(x, dim=0, correction=0).mean(dim=-1))


def position_specific_entropy(tokens, device=None):
    """(N, L) int tokens -> (L,) Shannon entropy in bits."""
    t = _tensor(tokens, device).long()
    N, L = t.shape
    V = int(t.max()) + 1 if t.numel() else 1
    counts = torch.zeros(L, V, dtype=torch.float64, device=t.device)
    counts.scatter_add_(1, t.T, torch.ones(L, N, dtype=torch.float64,
                                           device=t.device))
    freqs = counts / N
    return -torch.where(freqs > 0, freqs * torch.log2(freqs),
                        0.0).sum(dim=1)


def correlations(x, y):
    """(Spearman, Pearson) correlation statistics (scipy, on the host)."""
    from scipy import stats

    def host(v):
        return v.detach().cpu().numpy() if torch.is_tensor(v) else v

    x, y = host(x), host(y)
    return (stats.spearmanr(x, y).statistic, stats.pearsonr(x, y).statistic)


# ---------------------------------------------------------------------------
# validity
# ---------------------------------------------------------------------------

def steric_clash(coords, ca_vdw_radius=1.7, allowable_overlap=0.4,
                 k_exclusion=0, device=None):
    """Per-frame clash counts."""
    x = _tensor(coords, device)
    assert not torch.isnan(x).any(), "coords should not contain nan"
    bar = 2 * ca_vdw_radius - allowable_overlap
    pwd = pairwise_distance_ca(x, k=k_exclusion + 1, device=x.device)
    return (pwd < bar).sum(dim=-1)


def validity(ca_coords_dict, device=None, **clash_kwargs):
    """Fraction of clash-free conformations per ensemble."""
    d = on_device(ca_coords_dict, device)
    return {k: np.around(1.0 - (steric_clash(v, device=v.device,
                                             **clash_kwargs) > 0)
                         .double().mean().item(), 4)
            for k, v in d.items()}


def bonding_validity(ca_coords_dict, ref_key="target", device=None):
    """Fraction of frames with no dissociated CA-CA bond, the threshold set
    by the reference ensemble's longest adjacent distance."""
    adj = {k: adjacent_ca_distance(v, device=v.device)
           for k, v in on_device(ca_coords_dict, device).items()}
    thres = adj[ref_key].max() + 1e-6
    return {k: np.around((v < thres).all(dim=-1).sum().item() / len(v), 4)
            for k, v in adj.items()}


# ---------------------------------------------------------------------------
# JS-divergence suite
# ---------------------------------------------------------------------------

def _binned(values, lo, hi, n_bins, weights=None):
    """Per-feature histograms over [lo, hi] in ``n_bins`` equal bins plus a
    pseudocount: (n_bins, D) float64 on the values' device.

    ``np.histogram(range=(lo, hi))``'s rule, feature by feature: values
    outside the range are dropped, the last bin is closed, edges are
    ``linspace(lo, hi, n + 1)`` as numpy computes it, and each index
    ``(x - lo) / (hi - lo) * n`` is corrected against those edges."""
    v = values if values.ndim == 2 else values[:, None]
    dev = v.device
    lo = torch.as_tensor(lo, dtype=torch.float64, device=dev).reshape(-1)
    hi = torch.maximum(torch.as_tensor(hi, dtype=torch.float64,
                                       device=dev).reshape(-1), lo + 1e-6)
    if not bool(torch.isfinite(lo).all() & torch.isfinite(hi).all()):
        raise ValueError("supplied range of the histogram is not finite")
    same = lo == hi
    lo, hi = torch.where(same, lo - 0.5, lo), torch.where(same, hi + 0.5, hi)
    D = v.shape[1]
    edges = torch.arange(n_bins + 1, dtype=torch.float64,
                         device=dev)[:, None] * ((hi - lo) / n_bins) + lo
    edges[-1] = hi
    edges = edges.T.contiguous()                          # (D, n + 1)
    base = torch.arange(D, device=dev) * (n_bins + 1)
    counts = torch.zeros(D * n_bins + 1, dtype=torch.float64, device=dev)
    w = None if weights is None else _tensor(weights, dev)
    for s in _blocks(len(v), D):
        x = v[s]
        keep = (x >= lo) & (x <= hi)
        f = torch.where(keep, (x - lo) / (hi - lo) * n_bins, 0.0)
        idx = f.long()
        idx = idx - (idx == n_bins).long()
        idx = idx - ((x < edges.view(-1)[base + idx]) & keep).long()
        idx = idx + ((x >= edges.view(-1)[base + idx + 1])
                     & (idx != n_bins - 1)).long()
        flat = torch.where(keep, torch.arange(D, device=dev) * n_bins + idx,
                           D * n_bins)
        add = (torch.ones_like(x) if w is None
               else w[s, None].expand_as(x).contiguous())
        counts.index_add_(0, flat.reshape(-1), add.reshape(-1))
    return counts[:-1].reshape(D, n_bins).T + PSEUDO_C


def _rel_entr(x, y):
    both = (x > 0) & (y > 0)
    return torch.where(both, x * torch.log(torch.where(both, x / y, 1.0)),
                       torch.where((x == 0) & (y >= 0), 0.0, torch.inf))


def _kl_div(x, y):
    both = (x > 0) & (y > 0)
    return torch.where(
        both, x * torch.log(torch.where(both, x / y, 1.0)) - x + y,
        torch.where((x == 0) & (y >= 0), y, torch.inf))


def js_divergence_binned(p, q):
    """Mean over features of scipy's ``jensenshannon(p, q, axis=0)``:
    p and q normalised by their sums, base e, the square root."""
    p = p / p.sum(dim=0, keepdim=True)
    q = q / q.sum(dim=0, keepdim=True)
    m = (p + q) / 2.0
    js = _rel_entr(p, m).sum(dim=0) + _rel_entr(q, m).sum(dim=0)
    return torch.sqrt(js / 2.0).mean()


def _scores(binned, ref_key, kl=False):
    ref = binned[ref_key]
    results = {k: (_kl_div(v, ref).mean() if kl
                   else js_divergence_binned(v, ref)).item()
               for k, v in binned.items() if k != ref_key}
    results[ref_key] = 0.0
    return {k: np.around(v, 4) for k, v in results.items()}


def js_pwd(ca_coords_dict, ref_key="target", n_bins=50, pwd_offset=3,
           weights=None, kl=False, device=None):
    """JS of per-channel pairwise-distance histograms."""
    weights = weights or {}
    pwd = {k: pairwise_distance_ca(v, k=pwd_offset, device=v.device)
           for k, v in on_device(ca_coords_dict, device).items()}
    lo = pwd[ref_key].min(dim=0).values
    hi = pwd[ref_key].max(dim=0).values
    return _scores({k: _binned(v, lo, hi, n_bins, weights.get(k))
                    for k, v in pwd.items()}, ref_key, kl)


def js_rg(ca_coords_dict, ref_key="target", n_bins=50, weights=None,
          return_rg=False, kl=False, device=None):
    weights = weights or {}
    rg = {k: radius_of_gyration(v, device=v.device)
          for k, v in on_device(ca_coords_dict, device).items()}
    lo, hi = rg[ref_key].min(), rg[ref_key].max()
    results = _scores({k: _binned(v, lo, hi, n_bins, weights.get(k))
                       for k, v in rg.items()}, ref_key, kl)
    return (results, rg) if return_rg else results


# ---------------------------------------------------------------------------
# TICA
# ---------------------------------------------------------------------------

class TICA:
    """Time-lagged independent component analysis.

    Fits on a (T, D) trajectory: solves the generalised eigenproblem
    C_lag v = lambda C_0 v on mean-free, symmetrised lagged covariances and
    keeps the top ``dim`` components, in float64 on the trajectory's
    device.  The eigensolver's signs are its own (cuSOLVER's on the card,
    LAPACK's on the CPU): a component may come out negated against
    another solver's, which mirrors its histogram and leaves its JS as it
    is.
    """

    def __init__(self, dim: int = 2, lagtime: int = 20, reg: float = 1e-6):
        self.dim = dim
        self.lagtime = lagtime
        self.reg = reg
        self.mean_ = None
        self.components_ = None

    def fit(self, X):
        X = _tensor(X)
        if len(X) < 3:
            # a degenerate reference (a single structure): the identity
            # projection onto the first dims keeps everything finite
            self.mean_ = X.mean(dim=0)
            self.components_ = torch.eye(X.shape[1], self.dim,
                                         dtype=X.dtype, device=X.device)
            return self
        tau = min(self.lagtime, max(1, len(X) - 2))
        self.mean_ = X.mean(dim=0)
        Xc = X - self.mean_
        x0, xt = Xc[:-tau], Xc[tau:]
        n = len(x0)
        C0 = (x0.T @ x0 + xt.T @ xt) / (2 * n)
        Ct = (x0.T @ xt + xt.T @ x0) / (2 * n)   # symmetrised (reversible)
        C0 += self.reg * torch.eye(C0.shape[0], dtype=X.dtype,
                                   device=X.device)
        # whiten, then an ordinary symmetric eigenproblem
        w, V = torch.linalg.eigh(C0)
        keep = w > 1e-10
        Wm12 = V[:, keep] / torch.sqrt(w[keep])
        ev, U = torch.linalg.eigh(Wm12.T @ Ct @ Wm12)
        order = torch.argsort(ev, descending=True)[:self.dim]
        self.components_ = Wm12 @ U[:, order]
        return self

    def transform(self, X):
        X = _tensor(X, self.mean_.device)
        return (X - self.mean_) @ self.components_


def js_tica(ca_coords_dict, ref_key="target", n_bins=50, lagtime=20,
            return_tic=True, weights=None, device=None):
    """Pairwise distances -> 2-D TICA projection fitted on the reference ->
    per-dimension JS.  The projections (tensors on the device) come with
    the scores when ``return_tic``."""
    weights = weights or {}
    pwd = {k: pairwise_distance_ca(v, device=v.device)
           for k, v in on_device(ca_coords_dict, device).items()}
    tica = TICA(dim=2, lagtime=lagtime).fit(pwd[ref_key])
    dr = {k: tica.transform(v) for k, v in pwd.items()}
    del pwd
    lo = dr[ref_key].min(dim=0).values
    hi = dr[ref_key].max(dim=0).values
    results = _scores({k: _binned(v, lo, hi, n_bins, weights.get(k))
                       for k, v in dr.items()}, ref_key)
    return (results, dr) if return_tic else results


# ---------------------------------------------------------------------------
# IDP (PED) metrics
# ---------------------------------------------------------------------------

def idp_metrics(ca_coords_dict, ref_key="target", pwd_offset=3, device=None):
    """MSE/MAE of the mean pairwise distances, the mean Rg and the log
    contact probability against the reference: six {name: float}."""
    pseudo_c = 0.01
    d = on_device(ca_coords_dict, device)

    def features(coords):
        pwd = pairwise_distance_ca(coords, k=pwd_offset, device=coords.device)
        return (pwd.mean(dim=0),
                radius_of_gyration(coords, device=coords.device).mean(dim=0),
                torch.log((pwd < 8.0).double().mean(dim=0) + pseudo_c))

    ref = features(d[ref_key])
    out = tuple({} for _ in range(6))
    for name, coords in d.items():
        for i, (a, b) in enumerate(zip(features(coords), ref)):
            out[i][name] = torch.mean((a - b) ** 2).item()
            out[3 + i][name] = torch.mean(torch.abs(a - b)).item()
    return out
